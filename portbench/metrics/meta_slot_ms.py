"""Device milliseconds of a candidate meta slot's "meta" span (restore,
the MAML pairs of every round, save), mean over the window's slots."""
import numpy as np


def read(layer: dict):
    ms = layer.get("span_ms", {}).get("meta")
    return float(np.mean(ms)) if ms else None
