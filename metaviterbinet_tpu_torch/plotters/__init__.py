from metaviterbinet_tpu_torch.plotters.cache import get_ser_curve  # noqa: F401
from metaviterbinet_tpu_torch.plotters.figures import plot_by_block, plot_ber_vs_snr  # noqa: F401
from metaviterbinet_tpu_torch.plotters.experiments import run_sweep, CURVES  # noqa: F401
