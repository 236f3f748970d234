"""K5's (viterbi_decode_kernel) share of its roofline: the least time one
word's decode can take on an H100 (portbench/counts.py) over its mean
kernel time by name under torch.profiler, in percent."""
import numpy as np

from portbench import counts


def read(layer: dict):
    ds = [d for name, v in layer.get("kernel_ms", {}).items() if "viterbi_decode_kernel" in name
          for d in v]
    if not ds:
        return None
    bound, _ = counts.decode_bound_ms(1, layer["T"], layer["config"]["n_states"])
    return 100.0 * bound / float(np.mean(ds))
