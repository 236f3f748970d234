"""The measured window's arithmetic, on times in milliseconds on the
device's timeline (CUDA events) measured from the window's start.

A run of work items (blocks, words) is a list of boundaries: the item i of
a run lies between boundary i and boundary i + 1, and consecutive runs
share a boundary, so the items of all runs partition the time from the
first boundary to the last. An item counts for the window where it ended
inside it.
"""
from __future__ import annotations

import numpy as np


def items(boundaries: list[list[float]]) -> list[tuple[float, float]]:
    """(end, latency) of every item of every run, in order."""
    out = []
    for b in boundaries:
        out.extend((b[i + 1], b[i + 1] - b[i]) for i in range(len(b) - 1))
    return out


def in_window(boundaries: list[list[float]], window_ms: float) -> list[float]:
    """The latencies of the items that ended within [0, window_ms]."""
    return [lat for end, lat in items(boundaries) if end <= window_ms]


def rate(boundaries: list[list[float]], window_ms: float, per_item: float = 1.0) -> float:
    """Items (times `per_item`) completed in the window, per second."""
    return per_item * len(in_window(boundaries, window_ms)) / (window_ms / 1e3)


def p95(latencies: list[float]) -> float:
    """The 95th percentile (linear between order statistics, numpy's
    default) of every latency given."""
    return float(np.percentile(np.asarray(latencies, dtype=np.float64), 95))
