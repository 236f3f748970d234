"""Profiling utilities (the JAX package's utils/profiling.py).

`trace` records a `torch.profiler` trace of a block and writes it as a
Chrome trace (open it in chrome://tracing or Perfetto); `Timer` is a
wall-clock timer that waits for the card before it reads the clock. Both run
on the card unless the caller passes device="cpu", and raise without CUDA.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

import torch

from metaviterbinet_tpu_torch.device import resolve_device


@contextlib.contextmanager
def trace(log_dir: str, device: str | torch.device = "cuda") -> Iterator[None]:
    """Record the enclosed block with torch.profiler (host activity, and the
    card's on CUDA) and write it to <log_dir>/trace.json."""
    from torch.profiler import ProfilerActivity, profile

    device = resolve_device(device)
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class Timer:
    """Wall-clock timer that forces device completion.

    >>> with Timer() as t:
    ...     out = step(...)
    ...     t.sync(out)     # fences on `out` before the clock stops
    >>> t.elapsed

    On the card, leaving the block also synchronises the timer's device.
    """

    def __init__(self, device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self.elapsed: Optional[float] = None
        self._t0 = 0.0

    def __enter__(self) -> "Timer":
        self._t0 = time.perf_counter()
        return self

    def sync(self, *tensors: torch.Tensor) -> None:
        """Wait for the devices of the CUDA tensors given."""
        for device in {t.device for t in tensors if t.device.type == "cuda"}:
            torch.cuda.synchronize(device)

    def __exit__(self, *exc) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.elapsed = time.perf_counter() - self._t0
