"""Reading a pass of the program under torch.profiler, device activity
only: the device's busy time (the union of its activity intervals), each
kernel's durations by name, the operations that took most time, and the
device's idle gaps named by the host span in which each gap began, that
is by what the host was doing while the device waited. The host spans are
the driver's, stamped with the wall clock (time.time_ns), the clock the
profiler converts the device's timestamps to.

Tracing the host as well more than doubles the device's busy time of a
by-word pass (1,903 against 811 ms for 50 blocks, PERF.md), so it stays
off. The profiler's own cost lengthens a replayed pass several times over
on the host: its wall says little of the unprofiled pass's."""
from __future__ import annotations

import bisect
import time
from dataclasses import dataclass, field
from typing import Callable

TOP = 10


def union_ms(intervals: list[tuple[float, float]]) -> float:
    """Length of the union of [start, end] intervals."""
    total, reach = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > reach:
            total += b - max(a, reach)
            reach = b
    return total


def gaps(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    """The uncovered stretches between the first start and the last end."""
    out, reach = [], None
    for a, b in sorted(intervals):
        if reach is not None and a > reach:
            out.append((reach, a))
        reach = b if reach is None else max(reach, b)
    return out


def name_gaps(idle: list[tuple[float, float]], spans: list[tuple[float, float, str]]) -> dict:
    """Idle time summed by the host span open at each gap's start, the
    spans one after another ("outside spans" where none was open)."""
    out: dict[str, float] = {}
    spans = sorted(spans)
    starts = [s for s, _, _ in spans]
    for a, b in idle:
        i = bisect.bisect_right(starts, a) - 1
        name = spans[i][2] if i >= 0 and spans[i][1] >= a else "outside spans"
        out[name] = out.get(name, 0.0) + (b - a)
    return out


def top(by_name: dict[str, float], scale: float = 1.0) -> list[list]:
    return [[name[:160], value * scale]
            for name, value in sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]]


@dataclass
class Pass:
    wall_ms: float
    busy_ms: float
    activities: int
    kernel_ms: dict[str, list[float]] = field(default_factory=dict)
    device_ops: list = field(default_factory=list)
    idle_gaps: list = field(default_factory=list)


def profiled(fn: Callable[[], None], host: list[tuple[float, float, str]]) -> Pass:
    """Run fn() once under torch.profiler and read it; `host` holds the
    spans (start and end in wall-clock ms, name) fn opened."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        fn()
        return Pass(wall_ms=0.0, busy_ms=0.0, activities=0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    device, kernel_ms, by_name = [], {}, {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        start, dur = e.start_ns() / 1e6, e.duration_ns() / 1e6
        device.append((start, start + dur))
        kernel_ms.setdefault(e.name(), []).append(dur)
        by_name[e.name()] = by_name.get(e.name(), 0.0) + dur
    return Pass(wall_ms=wall_ms, busy_ms=union_ms(device), activities=len(device),
                kernel_ms=kernel_ms, device_ops=top(by_name, 1e-3),
                idle_gaps=top(name_gaps(gaps(device), host), 1e-3))
