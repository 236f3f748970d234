"""The port's tracer over a benchmark cell's window, and its cost, on the card.

    env PYTHONPATH=. python3 scripts/torch_trace_window.py --workload viterbinet.meta \
        --seed 12345 --seconds 30 [--order 0110]

Sets the cell up as its module in portbench/drivers/ does (the same seed
gives the same set-up), then runs its window several times, as that
module's timed loop runs it: `--order` gives each window's tracing, 0 with
no tracer active and 1 with utils/profiling.py::Tracer active around the
window only. A by-word window starts where the last ended (the next run of
the seed's order), a training window goes on with the same training object
and minibatches, so the windows are alike but not the same. Per window it
prints the end-to-end rate (blocks or words per second, from CUDA events at
that module's boundaries); per traced window the tracer's readings: the idle
share of the window's device time, its idle ms by the host span open at
each gap, and for a by-word cell the RS decode's device ms per block, a
run's start (device ms from its "start" span to its first "detect" span),
the warm-ups' and captures' host ms per run and the host syncs per run, and
the accounting (covered plus idle against the window; the block graph's
three parts against the replays that hold them). With `--pairs N` it then
times one unit of work (a by-word run on the same batch and draws, or one
minibatch) N times untraced and traced, in turns, for the tracer's cost.
Then one JSON line. It imports portbench's
cell modules and changes none of them.

Temporary: its loops copy the drivers' timed loops, and `readings` is what
the benchmark's readers of these metrics would compute. It goes once the
drivers enter the tracer around their window and `readings` moves into
portbench/metrics/.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch

from metaviterbinet_tpu_torch.utils import profiling
from metaviterbinet_tpu_torch.utils.profiling import Summary, Tracer
from portbench import harness, window
from portbench.marks import Marks

BLOCK_PARTS = ("detect.viterbi", "detect.rs_decode", "detect.label")


def byword_window(drv, cell, su, seed: int, seconds: float, r0: int, device) -> tuple[float, int]:
    """The by-word cell's timed loop from run r0: (blocks per second, runs)."""
    marks = Marks(device)
    runs, bounds = 0, []
    first = prev = marks.mark()
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        sp = drv.Spans(marks)
        drv.window_run(cell, su, r0 + runs, seed, spans=sp)
        end = marks.mark()
        bounds.append([prev] + sp.detect[1:] + [end])
        prev = end
        runs += 1
    marks.synchronize()
    boundaries = [[marks.ms(first, m) for m in b] for b in bounds]
    return window.rate(boundaries, 1e3 * seconds), runs


def sweep_window(su, done: int, cell, seed: int, seconds: float, device) -> tuple[float, int]:
    """The training cell's timed loop from minibatch `done`, the loss
    read a "loss_read" span: (words per second, minibatches done)."""
    from metaviterbinet_tpu_torch.train.loop import word_sweep

    bits, rx, select = su.words
    marks = Marks(device)
    ends = []

    def timed(*args):
        out = su.step(*args)
        ends.append(marks.mark())
        return out

    t = cell.traffic
    first = marks.mark()
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        if done and done % t["restart_every"] == 0:
            su.new_object(cell, seed, done // t["restart_every"], device)
        b = 1 + done % t["pool"]
        total = word_sweep(su.loss_fn, su.optimizer, su.params, su.state, rx[b], bits[b],
                           list(select[b]), timed, su.chunk)
        with profiling.span("loss_read"):
            float(total)
        done += 1
    marks.synchronize()
    boundaries = [[0.0] + [marks.ms(first, e) for e in ends]]
    return window.rate(boundaries, 1e3 * seconds, per_item=su.chunk), done


def unit_ms(drv, cell, su, seed: int, device, traced: bool) -> float:
    """Device ms (CUDA events) of one unit of the cell's work, the same each
    time: the by-word window's first run (its batch and draws), or one
    minibatch of the sweep with its loss read; with a tracer active around
    it where `traced`."""
    from metaviterbinet_tpu_torch.train.loop import word_sweep

    marks = Marks(device)
    tracer = Tracer(device) if traced else None
    with tracer or profiling.NO_SPAN:
        a = marks.mark()
        if cell.traffic["driver"] == "by_word":
            drv.window_run(cell, su, 0, seed)
        else:
            bits, rx, select = su.words
            total = word_sweep(su.loss_fn, su.optimizer, su.params, su.state, rx[1], bits[1],
                               list(select[1]), su.step, su.chunk)
            with profiling.span("loss_read"):
                float(total)
        b = marks.mark()
        marks.synchronize()
    return marks.ms(a, b)


def parts_over_block(s: Summary) -> float:
    """The block graph's three parts' device ms over the device ms of the
    "block" spans that replayed them (a warm-up runs them eagerly inside a
    "block.warmup" span; a capture runs nothing in its "block.capture",
    then replays)."""
    parts: dict[int, float] = {}
    for sp in s.spans:
        if sp.name in BLOCK_PARTS and s.spans[sp.parent].name == "block":
            parts[sp.parent] = parts.get(sp.parent, 0.0) + sp.device[1] - sp.device[0]
    for sp in s.spans:
        if sp.name == "block.capture":
            parts.pop(sp.parent, None)
    held = sum(s.spans[i].device[1] - s.spans[i].device[0] for i in parts)
    return sum(parts.values()) / held


def readings(s: Summary) -> dict:
    """What the tracer reads of one window."""
    runs = sorted(r for r in {sp.run for sp in s.spans} if r is not None)
    out = {"idle_share_pct": 100 * s.idle_share, "window_ms": s.window_ms,
           "covered_plus_idle_over_window": (s.covered_ms + sum(s.idle_ms.values())) / s.window_ms,
           "idle_ms": dict(sorted(s.idle_ms.items(), key=lambda kv: -kv[1])),
           "dropped": s.dropped, "runs": len(runs),
           "device_ms": {k: v.device_ms for k, v in s.by_name.items()},
           "self_ms": {k: v.self_ms for k, v in s.by_name.items()},
           "host_ms": {k: v.host_ms for k, v in s.by_name.items()},
           "count": {k: v.count for k, v in s.by_name.items()}}
    if "block" in s.by_name:
        rs = s.by_name["detect.rs_decode"]
        out["rs_decode_ms"] = rs.device_ms / rs.count
        out["parts_over_block"] = parts_over_block(s)
        starts = {sp.run: sp.device[0] for sp in s.spans if sp.name == "start"}
        firsts: dict = {}
        for sp in s.spans:
            if sp.name == "detect" and sp.run not in firsts:
                firsts[sp.run] = sp.device[0]
        out["run_start_ms"] = float(np.mean([firsts[r] - starts[r] for r in starts
                                             if r in firsts]))
        captures = sum(v.host_ms for k, v in s.by_name.items()
                       if k.endswith((".warmup", ".capture")))
        out["capture_ms"] = captures / len(runs)
        out["host_syncs"] = float(np.mean([s.counters.get(r, {}).get("host_syncs", 0)
                                           for r in runs]))
        out["upload_bytes"] = float(np.mean([s.counters.get(r, {}).get("upload_bytes", 0)
                                             for r in runs]))
        out["counters_first_run"] = s.counters.get(runs[0], {})
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--order", default="0110")
    ap.add_argument("--pairs", type=int, default=0,
                    help="then this many pairs of one unit of work untraced and traced, "
                         "in turns")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    print(card, flush=True)
    torch.set_num_threads(2)
    device = torch.device("cuda")
    cell = harness.cell(args.workload)
    drv = cell.driver()
    t0 = time.perf_counter()
    su = drv.set_up(cell, args.seed, device)
    torch.cuda.synchronize()
    print(f"set-up {time.perf_counter() - t0:.1f} s", flush=True)
    windows, position = [], 0
    for traced in (c == "1" for c in args.order):
        tracer = Tracer(device) if traced else None
        with tracer or profiling.NO_SPAN:
            if cell.traffic["driver"] == "by_word":
                rate, n = byword_window(drv, cell, su, args.seed, args.seconds, position, device)
            else:
                rate, n = sweep_window(su, position, cell, args.seed, args.seconds, device)
        position = n if cell.traffic["driver"] == "word_sweep" else position + n
        out = {"traced": traced, "rate": rate}
        if traced:
            t1 = time.perf_counter()
            out.update(readings(tracer.summary()), summary_s=time.perf_counter() - t1)
        windows.append(out)
        brief = {k: v for k, v in out.items() if k not in ("device_ms", "self_ms", "host_ms",
                                                          "count", "counters_first_run")}
        print(json.dumps(brief), flush=True)
        for k in ("device_ms", "self_ms", "host_ms", "count", "counters_first_run"):
            if k in out:
                print(f"  {k}: {json.dumps(out[k])}", flush=True)
    plain = [w["rate"] for w in windows if not w["traced"]]
    traced = [w["rate"] for w in windows if w["traced"]]
    pairs = []
    for i in range(args.pairs):
        first = bool(i % 2)  # untraced first, then traced first, in turns
        ms = {t: unit_ms(drv, cell, su, args.seed, device, t) for t in (first, not first)}
        pairs.append((ms[False], ms[True]))
        print(f"pair {i}: untraced {ms[False]:.3f} ms, traced {ms[True]:.3f} ms", flush=True)
    ratios = [b / a for a, b in pairs]
    print(json.dumps({"workload": args.workload, "seed": args.seed, "card": card,
                      "untraced": plain, "traced": traced,
                      "traced_over_untraced": float(np.mean(traced) / np.mean(plain))
                      if plain and traced else None,
                      "pairs_ms": pairs,
                      "traced_ms_over_untraced_median": float(np.median(ratios))
                      if ratios else None}))


if __name__ == "__main__":
    main()
