"""Profiling utilities (the JAX package's utils/profiling.py), and the port's
own tracer.

`trace` records a `torch.profiler` trace of a block and writes it as a
Chrome trace (open it in chrome://tracing or Perfetto); `Timer` is a
wall-clock timer that waits for the card before it reads the clock. Both run
on the card unless the caller passes device="cpu", and raise without CUDA.

`Tracer` records the program's own spans and counts, in memory, while a
caller holds it active (`with Tracer(device) as tracer:`), and is read once,
after the caller's window, by `tracer.summary()`. It is off by default: with
no tracer active, `span`, `count` and `host_read` cost one check of the
module's `_active` and take the path they would take without a tracer.

A span (`with span(name, hook):`, or a GraphedStep call, online/graphs.py)
records its name, its parent span, the run it belongs to (`Tracer.run`, one
a `run_online` call), its start and end on the host's clock, and its start
and end on the device: a stamp kernel (kernels/csrc/stamp.cu) enqueued at
its entry and its exit writes the device's clock into a preallocated buffer
at a slot taken from a device cursor, in the order the device runs them. A
span entered while a CUDA graph is being captured (inside a GraphedStep's
capture, or a `when` body's IF node) becomes two kernel nodes of the graph,
so every replay stamps again; its host times are the capture's. No stamp
reads anything back: the buffer is copied to the host once, by `summary`.
A full buffer drops the stamps that do not fit, and counts them.

One clock: the host's is the wall clock (time.time_ns, CLOCK_REALTIME), the
clock to which torch.profiler converts the device's activity, so a profiled
pass reads against the program's own spans. The device's stamps are mapped
onto it by a line through two calibrations, each a synchronise followed by
a stamp: one when the tracer starts and one when the summary is taken. On
the CPU the device's times are the host's clock.

`hook` is the caller's `spans(name)` of `run_online`, which the span enters
as it always has, whether a tracer is active or not.
"""
from __future__ import annotations

import bisect
import contextlib
import ctypes
import os
import time
from dataclasses import dataclass
from typing import Callable, Iterator, Optional

import numpy as np
import torch

from metaviterbinet_tpu_torch.device import resolve_device
from metaviterbinet_tpu_torch.kernels.native import INT, PTR, check_launch, load


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


# ------------------------------------------------------------------ tracer

# the active Tracer, or None: the one reference every span point checks
_active: Optional["Tracer"] = None
NO_SPAN = contextlib.nullcontext()

# kernels/csrc/stamp.cu's fixed rows: the start's calibrations, the
# window's end, the summary's calibrations
FIXED_ROWS = 16
CALIBRATIONS = 5
_START, _END, _SUMMARY = 0, CALIBRATIONS, CALIBRATIONS + 1
OUTSIDE = "outside spans"
# the argument types of kernels/csrc/stamp.cu's C function
STAMP_ABI = (PTR, ctypes.c_longlong, ctypes.c_longlong, INT, PTR)


def span(name: str, hook: Optional[Callable] = None):
    """The context of one span point: the caller's `hook(name)` (if any),
    and, where a tracer is active, the tracer's span around it."""
    tracer = _active
    if tracer is None:
        return NO_SPAN if hook is None else hook(name)
    return tracer.span(name, hook)


def count(name: str, n: int = 1) -> None:
    """Add n to the active tracer's counter `name` of the current run."""
    tracer = _active
    if tracer is not None:
        tracer.count(name, n)


def host_read(t: torch.Tensor) -> torch.Tensor:
    """t.cpu(): a blocking read of the device where t lies on one, which
    the active tracer counts as a host sync."""
    tracer = _active
    if tracer is not None and t.is_cuda:
        tracer.count("host_syncs")
    return t.cpu()


def upload(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """t.to(device), whose bytes the active tracer counts as uploaded where
    they go from the host to a card."""
    tracer = _active
    if tracer is not None and torch.device(device).type == "cuda" and not t.is_cuda:
        tracer.count("upload_bytes", t.numel() * t.element_size())
    return t.to(device)


@dataclass
class SpanTimes:
    """One span as it ran: on a replay of a graph it was captured into,
    host times None (its host times are the capture's, on the capture's
    record). Times in ms on the host's clock; parent an index into
    Summary.spans (-1: none)."""
    name: str
    run: Optional[int]
    parent: int
    host: Optional[tuple[float, float]]
    device: tuple[float, float]


@dataclass
class NameTotals:
    count: int = 0          # the spans that ran on the device
    host_ms: float = 0.0    # host time of the spans the host entered (a capture's once)
    device_ms: float = 0.0
    self_ms: float = 0.0    # device ms less the part its child spans cover


@dataclass
class Summary:
    """The tracer's window, read once. `window` is the device's time from
    the tracer's start to its end on the host's clock (ms); `covered_ms` the
    part some span's device interval covers; `idle_ms` the rest, by the
    name of the innermost host span open when each gap began (OUTSIDE where
    none was). `counters` by run (None: outside any run)."""
    window: tuple[float, float]
    covered_ms: float
    idle_ms: dict[str, float]
    by_name: dict[str, NameTotals]
    spans: list[SpanTimes]
    counters: dict[Optional[int], dict[str, int]]
    dropped: int

    @property
    def window_ms(self) -> float:
        return self.window[1] - self.window[0]

    @property
    def idle_share(self) -> float:
        return sum(self.idle_ms.values()) / self.window_ms if self.window_ms > 0 else 0.0


def union(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    """The union of [start, end] intervals as disjoint sorted intervals."""
    out: list[list[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def gaps(window: tuple[float, float], intervals: list[tuple[float, float]]
         ) -> list[tuple[float, float]]:
    """The stretches of `window` that no interval covers."""
    out, reach = [], window[0]
    for a, b in union(intervals):
        a, b = max(a, window[0]), min(b, window[1])
        if a > reach:
            out.append((reach, a))
        reach = max(reach, b)
    if reach < window[1]:
        out.append((reach, window[1]))
    return out


def name_gaps(idle: list[tuple[float, float]], host: list[tuple[float, float, str, int]]
              ) -> dict[str, float]:
    """Idle time summed by the innermost host span open at each gap's
    start: `host` holds (start, end, name, parent) of spans that nest on the
    host, parent an index into `host` (-1: none)."""
    order = sorted(range(len(host)), key=lambda i: host[i][0])
    starts = [host[i][0] for i in order]
    out: dict[str, float] = {}
    for a, b in idle:
        k = bisect.bisect_right(starts, a) - 1
        i = order[k] if k >= 0 else -1
        while i >= 0 and host[i][1] < a:  # closed before the gap: its parent may be open
            i = host[i][3]
        name = host[i][2] if i >= 0 else OUTSIDE
        out[name] = out.get(name, 0.0) + (b - a)
    return out


def self_ms(spans: list[SpanTimes]) -> list[float]:
    """Each span's device ms less the part of its interval its children cover."""
    children: dict[int, list[tuple[float, float]]] = {}
    for s in spans:
        if s.parent >= 0:
            children.setdefault(s.parent, []).append(s.device)
    out = []
    for i, s in enumerate(spans):
        a, b = s.device
        inside = sum(min(y, b) - max(x, a) for x, y in union(children.get(i, []))
                     if min(y, b) > max(x, a))
        out.append(b - a - inside)
    return out


class Tracer:
    """The program's spans and counts over a caller's window (module
    docstring). `capacity` bounds the stamps kept on the card (16 bytes
    each); the tracer is active from `__enter__` to `__exit__`, and read by
    one `summary()` after."""

    def __init__(self, device: str | torch.device = "cuda", capacity: int = 1 << 19):
        self.device = resolve_device(device)
        self.cuda = self.device.type == "cuda"
        self.capacity = capacity
        # host records: [name, parent record, run, captured, host start, host end] (ns)
        self.records: list[list] = []
        self._stack: list[int] = []
        self._run: Optional[int] = None
        self._runs = 0
        self.counters: dict[Optional[int], dict[str, int]] = {}
        self._cpu_stamps: list[tuple[int, int]] = []
        self._cpu_dropped = 0
        self._fixed = [0] * FIXED_ROWS  # the CPU's fixed rows
        self._hosts: dict[int, tuple[int, int]] = {}  # fixed row -> host ns around its stamp
        self._summary: Optional[Summary] = None
        self.buffer: Optional[torch.Tensor] = None
        if self.cuda:
            # row 0 the cursor, FIXED_ROWS fixed rows, then the stamps
            self.buffer = torch.zeros((1 + FIXED_ROWS + capacity, 2), dtype=torch.int64,
                                      device=self.device)
            self._stamp_fn = load("stamp", STAMP_ABI)

    # ------------------------------------------------------------ stamps

    def _stamp(self, code: int, fixed: int = -1) -> None:
        if not self.cuda:
            if fixed >= 0:
                self._fixed[fixed] = time.time_ns()
            elif len(self._cpu_stamps) < self.capacity:
                self._cpu_stamps.append((time.time_ns(), code))
            else:
                self._cpu_dropped += 1
            return
        check_launch("stamp", self._stamp_fn(
            self.buffer.data_ptr(), self.capacity, code, fixed,
            torch.cuda.current_stream(self.device).cuda_stream))

    def _calibrate(self, first: int) -> None:
        """CALIBRATIONS fixed stamps, each after a synchronise, with the
        host's clock read before its launch and after the next synchronise."""
        for k in range(CALIBRATIONS):
            if self.cuda:
                torch.cuda.synchronize(self.device)
            t0 = time.time_ns()
            self._stamp(0, first + k)
            if self.cuda:
                torch.cuda.synchronize(self.device)
            self._hosts[first + k] = (t0, time.time_ns())

    # ------------------------------------------------------------ activity

    def __enter__(self) -> "Tracer":
        global _active
        if _active is not None:
            raise RuntimeError("a tracer is already active")
        if self._summary is not None or self._hosts:
            raise RuntimeError("a tracer records one window")
        self._calibrate(_START)
        _active = self
        return self

    def __exit__(self, *exc) -> None:
        global _active
        _active = None
        self._stamp(0, _END)

    @contextlib.contextmanager
    def span(self, name: str, hook: Optional[Callable] = None):
        rec = len(self.records)
        parent = self._stack[-1] if self._stack else -1
        captured = self.cuda and torch.cuda.is_current_stream_capturing()
        record = [name, parent, self._run, captured, 0, None]
        self.records.append(record)
        # the host's interval lies inside the stamps': on the CPU, where the
        # stamps are the host's clock, a gap that starts at a span's exit
        # stamp is then named by the span that holds it
        self._stamp(2 * rec)
        record[4] = time.time_ns()
        self._stack.append(rec)
        try:
            if hook is None:
                yield
            else:
                with hook(name):
                    yield
        except BaseException:
            # no exit stamp: a failed capture has invalidated the stream
            self._stack.pop()
            record[5] = time.time_ns()
            raise
        self._stack.pop()
        record[5] = time.time_ns()
        self._stamp(2 * rec + 1)

    @contextlib.contextmanager
    def run(self):
        """One run (a `run_online` call): a "run" span whose spans and
        counts carry its id."""
        outer = self._run
        self._run = self._runs = self._runs + 1
        try:
            with self.span("run"):
                yield self._run
        finally:
            self._run = outer

    def count(self, name: str, n: int = 1) -> None:
        counters = self.counters.setdefault(self._run, {})
        counters[name] = counters.get(name, 0) + n

    # ------------------------------------------------------------ reading

    def _read(self) -> tuple[np.ndarray, np.ndarray, int]:
        """(fixed rows' device ns, stamps [n, 2] of (device ns, code) in
        the device's order, stamps dropped), in one copy from the card."""
        if not self.cuda:
            return (np.asarray(self._fixed, dtype=np.int64),
                    np.asarray(self._cpu_stamps, dtype=np.int64).reshape(-1, 2), self._cpu_dropped)
        rows = self.buffer.cpu().numpy()
        n = int(rows[0, 0])
        kept = min(n, self.capacity)
        return (rows[1:1 + FIXED_ROWS, 0], rows[1 + FIXED_ROWS:1 + FIXED_ROWS + kept],
                n - kept)

    def _clock(self, fixed: np.ndarray) -> Callable[[np.ndarray], np.ndarray]:
        """Device ns -> host ms: identity on the CPU; on the card the line
        through the two calibrations, each the stamp with the shortest round
        trip placed at the middle of it."""
        if not self.cuda:
            return lambda d: np.asarray(d, dtype=np.float64) / 1e6

        def point(first: int) -> tuple[float, float]:
            k = min(range(first, first + CALIBRATIONS),
                    key=lambda j: self._hosts[j][1] - self._hosts[j][0])
            return float(fixed[k]), sum(self._hosts[k]) / 2

        (d0, h0), (d1, h1) = point(_START), point(_SUMMARY)
        slope = (h1 - h0) / (d1 - d0) if d1 > d0 else 1.0
        return lambda d: (h0 + (np.asarray(d, dtype=np.float64) - d0) * slope) / 1e6

    def summary(self) -> Summary:
        """The window's spans, totals by name, idle time and counters
        (computed once; the tracer is no longer active)."""
        if self._summary is not None:
            return self._summary
        if _active is self:
            raise RuntimeError("summary: leave the tracer's window first")
        self._calibrate(_SUMMARY)
        fixed, stamps, dropped = self._read()
        to_ms = self._clock(fixed)
        window = tuple(float(v) for v in to_ms(np.array([fixed[_START + CALIBRATIONS - 1],
                                                          fixed[_END]])))
        times = to_ms(stamps[:, 0]) if len(stamps) else np.zeros(0)
        # the device's order nests the spans: each entry opens one below the
        # innermost span still open
        spans: list[SpanTimes] = []
        stack: list[tuple[int, int]] = []  # (record, span)
        for t, code in zip(times.tolist(), stamps[:, 1].tolist()):
            rec = code >> 1
            name, _, run, captured, h0, h1 = self.records[rec]
            if not code & 1:
                parent = stack[-1][1] if stack else -1
                if captured and parent >= 0:  # a replay runs in its caller's run
                    run = spans[parent].run
                spans.append(SpanTimes(name=name, run=run, parent=parent,
                                       host=None if captured else (h0 / 1e6, h1 / 1e6),
                                       device=(t, float("nan"))))
                stack.append((rec, len(spans) - 1))
                continue
            while stack and stack[-1][0] != rec:  # an entry whose exit never ran
                stack.pop()
            if stack:
                i = stack.pop()[1]
                spans[i].device = (spans[i].device[0], t)
        spans = self._in_window(spans, window)
        by_name: dict[str, NameTotals] = {}
        for s, own in zip(spans, self_ms(spans)):
            totals = by_name.setdefault(s.name, NameTotals())
            totals.count += 1
            totals.device_ms += s.device[1] - s.device[0]
            totals.self_ms += own
        for name, _, _, _, h0, h1 in self.records:
            by_name.setdefault(name, NameTotals()).host_ms += ((h1 or h0) - h0) / 1e6
        intervals = [s.device for s in spans]
        covered = sum(max(0.0, min(b, window[1]) - max(a, window[0]))
                      for a, b in union(intervals))
        host = [(h0 / 1e6, (h1 or h0) / 1e6, name, parent)
                for name, parent, _, _, h0, h1 in self.records]
        idle = name_gaps(gaps(window, intervals), host)
        self._summary = Summary(window=window, covered_ms=covered, idle_ms=idle,
                                by_name=by_name, spans=spans,
                                counters=self.counters, dropped=int(dropped))
        return self._summary

    @staticmethod
    def _in_window(spans: list[SpanTimes], window: tuple[float, float]) -> list[SpanTimes]:
        """The spans that closed and started within the window, their
        parents re-indexed (-1 where the parent is left out)."""
        keep = [i for i, s in enumerate(spans)
                if window[0] <= s.device[0] <= window[1] and s.device[1] == s.device[1]]
        index = {old: new for new, old in enumerate(keep)}
        return [SpanTimes(spans[i].name, spans[i].run, index.get(spans[i].parent, -1),
                          spans[i].host, spans[i].device) for i in keep]
