"""K6's (online_adapt_kernel) share of its roofline: the least time of
one launch of the self-supervised iterations on one word on an H100
(portbench/counts.py) over its mean kernel time by name under
torch.profiler, in percent."""
import numpy as np

from portbench import counts


def read(layer: dict):
    ds = [d for name, v in layer.get("kernel_ms", {}).items() if "online_adapt_kernel" in name
          for d in v]
    if not ds:
        return None
    c = layer["config"]
    bound, _ = counts.adapt_bound_ms(layer["T"], c["n_states"], c["self_supervised_iterations"])
    return 100.0 * bound / float(np.mean(ds))
