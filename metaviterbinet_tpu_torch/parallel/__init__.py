from metaviterbinet_tpu_torch.parallel.mesh import make_mesh  # noqa: F401
from metaviterbinet_tpu_torch.parallel.decode import (  # noqa: F401
    shard_words_decode,
    sequence_parallel_decode,
)
from metaviterbinet_tpu_torch.parallel.training import make_dp_train_step  # noqa: F401
