"""Calls replayed as CUDA graphs: the card's counterpart of the JAX
package's compiled loops, which run a loop of steps as one program with no
host work between them: the engine scan's body (`detect_decode_score`, the
gate, the buffer append, `sgd_steps` and `meta_adapt`, its
online/engine.py) and the offline word sweep (its train/loop.py).

A call is `fn(*state, *inputs)`. `state` is what it reads or writes in
place: parameter dicts (the engine's run state is one too), an optimizer
state (train/optim.py::OptState, whose step count is a device tensor), or
none. It updates them in place (`p.add_`, `mu.copy_`), never rebinding
them, and it changes no host state and reads nothing back to the host, so
that a replay computes what the call computes.

`GraphedStep(fn, name, n_state)(*state, *inputs)`, the first `n_state`
arguments the state:
  - on the CPU, calls fn directly: the graph's plain version, which the CPU
    tests run;
  - on the card, per key (the inputs' shapes and dtypes, and the addresses
    of the state's tensors), copies the inputs into static tensors (device
    to device) and then: the first WARMUP_STEPS calls run fn on them
    eagerly on a side stream, each a real call of the run with its own
    inputs, in stream order (torch.cuda.graph needs the warm-up); the next
    call captures fn into a CUDA graph on the same stream, which executes
    nothing, and replays it; every later call replays it. A capture that
    fails raises with CUDA's error. Every GraphedStep of a device shares
    that side stream and the stream that captures `when` bodies: a warm-up
    waits on the current stream both ways and captures run one at a time,
    so one of each is enough, and cuBLAS keeps a 32 MiB workspace for every
    stream it runs on.

`when(pred, fn, *args)` is `lax.cond` without an else: fn(*args) runs where
the 0-d bool tensor `pred` holds. In a GraphedStep's capture it records fn
into a CUDA graph IF node (kernels/csrc/if_node.cu), whose body the device
runs or skips at each replay by the value `pred` then has, with no host
read: fn is captured on a second stream into the node's body, its
allocations in a memory pool of their own that lives as long as the graph;
everywhere else (the CPU, a warm-up, `chip_smoke.no_capture()`) it is
`if bool(pred)`.

A loop of steps is captured as one graph of `chunk_steps(n, nodes)` steps
back to back, replayed n / chunk times: a graph of the whole loop would
hold n times a step's nodes (an LSTM step is about 1,305, PERF.md), and
MAX_GRAPH_NODES bounds what one graph holds.

What fn returns (tensors or None) is, on a replay, the graph's static
output, which the next call overwrites: a caller reads it in stream order
(an eager op on it) before the next call. `GraphedStep.counts[name]` counts
the calls of each kind over all steps of that name in the process, as the
kernel wrappers count their launches. Where a tracer is active
(utils/profiling.py) a call is also a span named after the step, with a
"<name>.warmup" or "<name>.capture" span inside it, the spans that fn
opens in a capture are stamped at every replay, and the tracer counts
`when`'s host branches on a card ("host_syncs"); a graph captured with no
tracer active holds no stamp.

The kernel wrappers count a launch in Python when they are called
(LAUNCH_COUNTED, the registry of kernels/native.py). A capture calls them
and executes nothing, and a replay calls none, so the capture takes back
what the wrappers counted during it and each replay adds it again: the
counts stay kernel executions. A launch inside a `when` body runs only
where its predicate holds, which the host does not know: the capture
records it against a device count of the replays whose predicate held
(`GraphedStep.conditional`), and the caller adds it once, from that count
read with its results (`settle`).
"""
from __future__ import annotations

import weakref
from typing import Any, Callable, Optional

import torch

from metaviterbinet_tpu_torch.kernels.native import INT, LAUNCH_COUNTED, PTR, check_launch, load
from metaviterbinet_tpu_torch.train.optim import OptState
from metaviterbinet_tpu_torch.utils import profiling

WARMUP_STEPS = 2
KINDS = ("direct", "warmup", "capture", "replay")
# the most nodes one captured loop of steps may hold: a vnet self-supervised
# step is about 119 device activities and an LSTM one about 1,305 (one step
# under torch.profiler, chip_smoke.py phase 7c, NVIDIA H100 80GB HBM3). A
# chunk replays at about the single-step replay's time a step (0.249 against
# 0.260 ms for vnet), while its two warm-ups and its capture run its steps
# at eager speed (~10x); at 30,000 nodes (200 vnet steps) those took ~2.6 s
# of a 12 s vnet online run (PERF.md section 6), so the ceiling is small
MAX_GRAPH_NODES = 3_000


def replays_on(device: torch.device) -> bool:
    """Whether a step whose params lie on `device` is captured and
    replayed: on the card, not on the CPU."""
    return device.type == "cuda"


def chunk_steps(n: int, step_nodes: int) -> int:
    """The steps of a loop of n captured as one graph: the largest divisor
    of n whose steps of `step_nodes` nodes each stay within
    MAX_GRAPH_NODES (1 at least)."""
    return max(d for d in range(1, n + 1) if n % d == 0 and (d == 1 or d * step_nodes
                                                            <= MAX_GRAPH_NODES))


# the argument types of csrc/if_node.cu's C function
IF_NODE_ABI = (INT, PTR, PTR, PTR)

# the most `when` bodies with counted launches that one capture may hold:
# their device counts are slots of a buffer made before the capture
MAX_COUNTED_BODIES = 16

# the GraphedStep whose capture is running
_capturing: Optional["GraphedStep"] = None
# device -> (the side stream of warm-ups and captures, the stream that
# captures `when` bodies), shared by every GraphedStep
_streams: dict[torch.device, tuple[torch.cuda.Stream, torch.cuda.Stream]] = {}


def _side_streams(device: torch.device) -> tuple[torch.cuda.Stream, torch.cuda.Stream]:
    if device not in _streams:
        _streams[device] = (torch.cuda.Stream(device), torch.cuda.Stream(device))
    return _streams[device]


def _take_back(before: dict[Callable, int]) -> dict[Callable, int]:
    """Set each counted wrapper back to its count in `before` (0 for one
    registered since) and return what each counted since, where it did."""
    counted = {}
    for w in LAUNCH_COUNTED:
        n = before.get(w, 0)
        if w.launches != n:
            counted[w] = w.launches - n
            w.launches = n
    return counted


def when(pred: torch.Tensor, fn: Callable, *args) -> None:
    """fn(*args) where the 0-d bool tensor `pred` holds: an IF node of the
    graph a GraphedStep is capturing, else a host branch."""
    if not (pred.is_cuda and torch.cuda.is_current_stream_capturing()):
        if pred.is_cuda:  # bool() waits for the device
            profiling.count("host_syncs")
        if bool(pred):
            fn(*args)
        return
    if _capturing is None:
        raise RuntimeError("when: a conditional node is captured inside a GraphedStep only")
    body, pool = _capturing._body(pred.device)
    if_node = load("if_node", IF_NODE_ABI)
    check_launch("if_node", if_node(1, pred.data_ptr(), torch.cuda.current_stream().cuda_stream,
                                    body.cuda_stream))
    before = {w: w.launches for w in LAUNCH_COUNTED}
    with torch.cuda.stream(body):
        torch._C._cuda_beginAllocateCurrentStreamToPool(pred.device.index, pool)
        fn(*args)
        torch._C._cuda_endAllocateToPool(pred.device.index, pool)
    check_launch("if_node", if_node(0, None, None, body.cuda_stream))
    launches = _take_back(before)
    if launches:
        # a slot of the buffer made before the capture: a tensor allocated in
        # the capture would come from the graph's pool, where a replay may
        # write an earlier temporary of the graph over it
        slot = len(_capturing.conditional) - _capturing._counted_from
        if slot >= MAX_COUNTED_BODIES:
            raise RuntimeError(f"when: more than {MAX_COUNTED_BODIES} bodies with counted "
                               "launches in one capture")
        hits = _capturing._hits[slot]
        hits.add_(pred)
        _capturing.conditional.append((hits, launches))


def state_tensors(state: tuple) -> list[torch.Tensor]:
    """The tensors of a call's state, in order: the values of parameter
    dicts, an OptState's count and moments."""
    out = []
    for s in state:
        if isinstance(s, dict):
            out.extend(s.values())
        elif isinstance(s, OptState):
            out.extend([s.count, *s.mu.values(), *s.nu.values()])
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
        # the buffer of the tracer active at the capture, which the graph's
        # stamps write at every replay
        self.stamps: Optional[torch.Tensor] = None


class GraphedStep:
    counts: dict[str, dict[str, int]] = {}

    def __init__(self, fn: Callable, name: str, n_state: int = 2):
        self.fn, self.name, self.n_state = fn, name, n_state
        self._entries: dict[tuple, _Entry] = {}
        # per `when` body of a capture: a device count of the replays whose
        # predicate held, and the launches the body makes in one of them
        self.conditional: list[tuple[torch.Tensor, dict[Callable, int]]] = []
        # the running capture's counts, and its first entry in `conditional`
        self._hits: Optional[torch.Tensor] = None
        self._counted_from = 0

    def _body(self, device: torch.device) -> tuple[torch.cuda.Stream, tuple]:
        """The stream that captures `when` bodies, and a new memory pool for
        the allocations of the body being captured, released when the graph
        being captured is."""
        pool = torch.cuda.graph_pool_handle()
        weakref.finalize(self._graph, torch._C._cuda_releasePool, device.index, pool)
        return _side_streams(device)[1], pool

    def _count(self, kind: str) -> None:
        GraphedStep.counts.setdefault(self.name, dict.fromkeys(KINDS, 0))[kind] += 1

    def _span(self, tracer: Optional[profiling.Tracer], part: str):
        return profiling.NO_SPAN if tracer is None else tracer.span(f"{self.name}.{part}")

    def settle(self, hits: list[int]) -> None:
        """Add the launches of the `when` bodies, given `hits`, the values
        of the `conditional` counts read by the caller; and zero them."""
        for (count, launches), n in zip(self.conditional, hits):
            for w, k in launches.items():
                w.launches += k * n
            count.zero_()

    def __call__(self, *args):
        """The call, and where a tracer is active a span named after the
        step, its warm-ups and capture spans of their own within it."""
        tracer = profiling._active
        if tracer is None:
            return self._call(args, None)
        with tracer.span(self.name):
            return self._call(args, tracer)

    def _call(self, args: tuple, tracer: Optional[profiling.Tracer]):
        global _capturing
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
        side = _side_streams(device)[0]
        if entry.graph is None and entry.warmed < WARMUP_STEPS:
            current = torch.cuda.current_stream(device)
            side.wait_stream(current)
            with torch.cuda.stream(side), self._span(tracer, "warmup"):
                out = self.fn(*state, *entry.static)
            current.wait_stream(side)
            entry.warmed += 1
            self._count("warmup")
            return out
        if entry.graph is None:
            graph = self._graph = torch.cuda.CUDAGraph()
            before = {w: w.launches for w in LAUNCH_COUNTED}
            n_conditional = self._counted_from = len(self.conditional)
            self._hits = torch.zeros(MAX_COUNTED_BODIES, dtype=torch.int32, device=device)
            _capturing = self
            with self._span(tracer, "capture"), torch.cuda.graph(graph, stream=side):
                entry.out = self.fn(*state, *entry.static)
            _capturing = None
            entry.stamps = None if tracer is None else tracer.buffer
            entry.launches = _take_back(before)  # counted at the capture, which ran nothing
            for count, _ in self.conditional[n_conditional:]:
                count.zero_()
            entry.graph = graph
            self._count("capture")
        entry.graph.replay()
        for w, n in entry.launches.items():
            w.launches += n
        self._count("replay")
        return entry.out
