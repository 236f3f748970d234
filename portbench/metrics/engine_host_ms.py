"""Host milliseconds per block from a run's call to its "sync" span: the
engine loop's enqueue, against which the device's time per block shows
whether the host or the device sets the pace."""
import numpy as np


def read(layer: dict):
    ms = layer.get("host_ms_per_block")
    return float(np.mean(ms)) if ms else None
