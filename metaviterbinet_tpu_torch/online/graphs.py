"""Training steps replayed as CUDA graphs: the card's counterpart of the JAX
engine's on-device scans (`sgd_steps` and `meta_adapt` in the JAX package's
online/engine.py), which run a loop of steps as one program with no host
work between them.

A step is `fn(params, opt_state, *inputs)`. It computes on its inputs and
updates the params and the optimizer's moments in place (`p.add_`,
`mu.copy_`), never rebinding them, and it changes no host state: the caller
advances the optimizer's count and passes the bias correction as an input
(train/optim.py::Optimizer.advance and `apply`).

`GraphedStep(fn, name)(params, opt_state, *inputs)`:
  - on the CPU, calls fn directly: the graph's plain version, which the CPU
    tests run;
  - on the card, per key (the inputs' shapes and dtypes, and the addresses
    of the params and moments), copies the inputs into static tensors
    (device to device) and then: the first WARMUP_STEPS calls run fn on
    them eagerly on a side stream, each a real step of the run with its own
    inputs, in stream order (torch.cuda.graph needs the warm-up); the next
    call captures fn into a CUDA graph, which executes nothing, and replays
    it; every later call replays it. A capture that fails raises with
    CUDA's error.

What fn returns (a tensor or None) is, on a replay, the graph's static
output, which the next call overwrites: a caller reads it in stream order
(an eager op on it) before the next call. `GraphedStep.counts[name]` counts
the calls of each kind over all steps of that name in the process, as the
kernel wrappers count their launches.
"""
from __future__ import annotations

from typing import Any, Callable, Optional

import numpy as np
import torch

WARMUP_STEPS = 2
KINDS = ("direct", "warmup", "capture", "replay")


def replays_on(device: torch.device) -> bool:
    """Whether a step whose params lie on `device` is captured and
    replayed: on the card, not on the CPU."""
    return device.type == "cuda"


def device_rows(rows: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host rows (the bias corrections of train/optim.py::Optimizer.advance)
    as a tensor on `device`, copied from pinned memory without a sync on
    the card."""
    t = torch.from_numpy(rows)
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


class _Entry:
    """One captured step: the addresses it was captured on, its static
    inputs and output, and its graph."""

    def __init__(self, state: tuple, inputs: tuple):
        self.state = state
        self.static = tuple(None if t is None else torch.empty_like(t) for t in inputs)
        self.warmed = 0
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.out: Any = None


class GraphedStep:
    counts: dict[str, dict[str, int]] = {}

    def __init__(self, fn: Callable, name: str):
        self.fn, self.name = fn, name
        self._entries: dict[tuple, _Entry] = {}
        self._stream: Optional[torch.cuda.Stream] = None

    def _count(self, kind: str) -> None:
        GraphedStep.counts.setdefault(self.name, dict.fromkeys(KINDS, 0))[kind] += 1

    def __call__(self, params: dict[str, torch.Tensor], opt_state, *inputs):
        device = next(iter(params.values())).device
        if not replays_on(device):
            self._count("direct")
            return self.fn(params, opt_state, *inputs)
        key = tuple(None if t is None else (tuple(t.shape), t.dtype) for t in inputs)
        state = tuple(t.data_ptr() for group in (params, opt_state.mu, opt_state.nu)
                      for t in group.values())
        entry = self._entries.get(key)
        if entry is None or entry.state != state:
            # new shapes, or other params or moments: capture anew (the old
            # graph would write to the old tensors)
            entry = self._entries[key] = _Entry(state, inputs)
        for static, t in zip(entry.static, inputs):
            if static is not None:
                static.copy_(t)
        if self._stream is None:
            self._stream = torch.cuda.Stream(device)
        if entry.graph is None and entry.warmed < WARMUP_STEPS:
            current = torch.cuda.current_stream(device)
            self._stream.wait_stream(current)
            with torch.cuda.stream(self._stream):
                out = self.fn(params, opt_state, *entry.static)
            current.wait_stream(self._stream)
            entry.warmed += 1
            self._count("warmup")
            return out
        if entry.graph is None:
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, stream=self._stream):
                entry.out = self.fn(params, opt_state, *entry.static)
            entry.graph = graph
            self._count("capture")
        entry.graph.replay()
        self._count("replay")
        return entry.out
