"""Run one cell of the port's benchmark once, on the card.

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell's entry in BENCHMARK.json names its
configuration file and its traffic mix, whose driver (portbench/drivers/)
sets it up from the seed, measures for --seconds and checks the program's
outputs against the plain reference (portbench/reference/). The last line
of standard output is one JSON object: correct, attempted, failed, the
metrics (the cell's end-to-end ones, or with --trace 1 its per-layer ones,
each read by portbench/metrics/<name>.py), the device, with --trace 1 a
breakdown, and last the numbers compared, each with its limit; standard
error ends with the same numbers, one a line.

Without a CUDA card, or with fewer cards than the cell asks for, it prints
no result and exits 2. If JAX, flax or the JAX package are loaded once the
window has closed, it names them on standard error and exits 3.
"""
from __future__ import annotations

import time

STARTED = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "metaviterbinet_tpu")


def process_start() -> float:
    """The process's start on the wall clock (Linux), else this module's."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            boot = next(int(line.split()[1]) for line in f if line.startswith("btime"))
        return boot + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return STARTED


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is one of FORBIDDEN, compared
    whole: the port's name begins with the JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def cache_dirs(root: Path) -> None:
    """Every build and kernel cache inside the checkout, at fixed paths
    (the port builds its kernels into metaviterbinet_tpu_torch/kernels/
    _build/ itself)."""
    cache = root / ".portbench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["USE_FLAX"] = "0"


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from portbench import harness

    root = harness.ROOT
    cache_dirs(root)
    cell = harness.cell(args.workload, root)
    import torch

    torch.set_num_threads(2)  # few threads: a steady load, and the reference's small ops

    chips = cell.workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {args.workload} needs {chips} CUDA card(s); this machine has {have}",
              file=sys.stderr)
        return 2
    device = torch.device("cuda")
    outcome = cell.driver().run(cell, args.seed, args.seconds, bool(args.trace), device,
                                process_start())
    found = forbidden_modules()
    if found:
        print(f"portbench: loaded after the window: {', '.join(found)}", file=sys.stderr)
        return 3
    if args.trace:
        metrics = {}
        for m in cell.metrics(trace=True):
            value = cell.reader(m["name"]).read(outcome.layer)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": outcome.e2e[m["name"]], "unit": m["unit"]}
                   for m in cell.metrics(trace=False)}
    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": chips,
           "memory_peak_bytes": outcome.memory_peak_bytes}
    if args.trace and outcome.busy_s:
        dev.update(busy_s=outcome.busy_s, window_s=outcome.window_s)
    line = {"correct": outcome.correct, "attempted": outcome.attempted, "failed": outcome.failed,
            "metrics": metrics, "device": dev}
    if args.trace and outcome.breakdown:
        line["breakdown"] = outcome.breakdown
    # a number that is not finite has failed its check; JSON has no word for it
    line["checks"] = {k: {"value": v if math.isfinite(v) else str(v), "limit": lim}
                      for k, (v, lim) in outcome.checks.items()}
    for k, v in outcome.readings.items():
        print(f"reading {k}: {v}", file=sys.stderr)
    for k, (v, lim) in outcome.checks.items():
        print(f"check {k}: {v!r} limit {lim!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
