"""Calls replayed as CUDA graphs: the card's counterpart of the JAX
package's compiled loops, which run a loop of steps as one program with no
host work between them: the engine scan's `sgd_steps`, `meta_adapt` and
per-block `detect_decode_score` (its online/engine.py) and the offline word
sweep (its train/loop.py).

A call is `fn(*state, *inputs)`. `state` is what it reads or writes in
place: parameter dicts, an optimizer state (train/optim.py::OptState), or
none. It updates them in place (`p.add_`, `mu.copy_`), never rebinding
them, and it changes no host state: a training step's caller advances the
optimizer's count and passes the bias correction as an input
(train/optim.py::Optimizer.advance and `apply`).

`GraphedStep(fn, name, n_state)(*state, *inputs)`, the first `n_state`
arguments the state:
  - on the CPU, calls fn directly: the graph's plain version, which the CPU
    tests run;
  - on the card, per key (the inputs' shapes and dtypes, and the addresses
    of the state's tensors), copies the inputs into static tensors (device
    to device) and then: the first WARMUP_STEPS calls run fn on them
    eagerly on a side stream, each a real call of the run with its own
    inputs, in stream order (torch.cuda.graph needs the warm-up); the next
    call captures fn into a CUDA graph, which executes nothing, and replays
    it; every later call replays it. A capture that fails raises with
    CUDA's error.

What fn returns (tensors or None) is, on a replay, the graph's static
output, which the next call overwrites: a caller reads it in stream order
(an eager op on it) before the next call. `GraphedStep.counts[name]` counts
the calls of each kind over all steps of that name in the process, as the
kernel wrappers count their launches.

The kernel wrappers (LAUNCH_COUNTED) count a launch in Python when they
are called. A capture calls them and executes nothing, and a replay calls
none, so the capture takes back what the wrappers counted during it and
each replay adds it again: the counts stay kernel executions.
"""
from __future__ import annotations

from typing import Any, Callable, Optional

import numpy as np
import torch

from metaviterbinet_tpu_torch.kernels import acs, online_sgd
from metaviterbinet_tpu_torch.train.optim import OptState

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


# the kernel wrappers that count their launches (kernels/acs.py,
# kernels/online_sgd.py)
LAUNCH_COUNTED = (acs.fused_va_detect, acs.fused_viterbinet_detect,
                  acs.fused_viterbinet_detect_chunked, acs.viterbi_decode_kernel,
                  online_sgd.online_adapt_viterbinet)


def state_tensors(state: tuple) -> list[torch.Tensor]:
    """The tensors of a call's state, in order: the values of parameter
    dicts, an OptState's moments."""
    out = []
    for s in state:
        if isinstance(s, dict):
            out.extend(s.values())
        elif isinstance(s, OptState):
            out.extend(list(s.mu.values()) + list(s.nu.values()))
        else:
            raise TypeError(f"a graphed call's state holds a {type(s).__name__}")
    return out


class _Entry:
    """One captured call: the addresses it was captured on, its static
    inputs and output, its graph, and the launches one replay makes."""

    def __init__(self, state: tuple, inputs: tuple):
        self.state = state
        self.static = tuple(None if t is None else torch.empty_like(t) for t in inputs)
        self.warmed = 0
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.out: Any = None
        self.launches: dict[Callable, int] = {}


class GraphedStep:
    counts: dict[str, dict[str, int]] = {}

    def __init__(self, fn: Callable, name: str, n_state: int = 2):
        self.fn, self.name, self.n_state = fn, name, n_state
        self._entries: dict[tuple, _Entry] = {}
        self._stream: Optional[torch.cuda.Stream] = None

    def _count(self, kind: str) -> None:
        GraphedStep.counts.setdefault(self.name, dict.fromkeys(KINDS, 0))[kind] += 1

    def __call__(self, *args):
        state, inputs = args[:self.n_state], args[self.n_state:]
        tensors = state_tensors(state)
        device = (tensors or [t for t in inputs if t is not None])[0].device
        if not replays_on(device):
            self._count("direct")
            return self.fn(*args)
        key = tuple(None if t is None else (tuple(t.shape), t.dtype) for t in inputs)
        addresses = tuple(t.data_ptr() for t in tensors)
        entry = self._entries.get(key)
        if entry is None or entry.state != addresses:
            # new shapes, or other state tensors: capture anew (the old
            # graph would read and write the old tensors)
            entry = self._entries[key] = _Entry(addresses, inputs)
        for static, t in zip(entry.static, inputs):
            if static is not None:
                static.copy_(t)
        if self._stream is None:
            self._stream = torch.cuda.Stream(device)
        if entry.graph is None and entry.warmed < WARMUP_STEPS:
            current = torch.cuda.current_stream(device)
            self._stream.wait_stream(current)
            with torch.cuda.stream(self._stream):
                out = self.fn(*state, *entry.static)
            current.wait_stream(self._stream)
            entry.warmed += 1
            self._count("warmup")
            return out
        if entry.graph is None:
            graph = torch.cuda.CUDAGraph()
            before = [w.launches for w in LAUNCH_COUNTED]
            with torch.cuda.graph(graph, stream=self._stream):
                entry.out = self.fn(*state, *entry.static)
            for w, n in zip(LAUNCH_COUNTED, before):
                if w.launches != n:  # counted at the capture, which ran nothing
                    entry.launches[w] = w.launches - n
                    w.launches = n
            entry.graph = graph
            self._count("capture")
        entry.graph.replay()
        for w, n in entry.launches.items():
            w.launches += n
        self._count("replay")
        return entry.out
