"""Device milliseconds of a block's "detect" span (the block graph: MLP,
K5, RS decode, SER, gate, buffer append), mean over the window's blocks."""
import numpy as np


def read(layer: dict):
    ms = layer.get("span_ms", {}).get("detect")
    return float(np.mean(ms)) if ms else None
