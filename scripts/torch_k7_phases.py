"""Where K7's time goes inside a second-order MAML pair, on a card.

    env PYTHONPATH=. python3 scripts/torch_k7_phases.py [--csrc DIR ...] [--label NAME ...]

For each kernel source directory given (default: the package's
`kernels/csrc`; another checkout's with `--csrc <checkout>/metaviterbinet_tpu_torch/
kernels/csrc`), builds its `maml_pairs.cu` twice into libraries of the
probe's own under `kernels/_build/k7_phases/`: once as the package builds it
and once with K7_PHASE_STAMPS defined, which the package's build never
defines. Both run a meta slot's 200 draws (chip_smoke.k7_slot, S = 16, T =
136, window 1, second order) as one launch through K7's wrapper.

The stamped library's thread 0 of every CTA adds the clock64 cycles since
its previous stamp to the phase that the stamp ends. The script prints, per
taken pair, each phase's microseconds on rank 0 (9 columns of the support
and of the query at T = 136) and on rank 15 (one), converted at the clock
rate that clock64 and %globaltimer give over the launch, and their sums by
kind: global reads at the pair's start, column-local phases, CTA barrier
waits (`__syncthreads`), cluster barrier waits and the exchange (the
owners' reductions and updates and the pulls).

Then it holds each plain library's slot against K7's plain version
(chip_smoke.K7_LIMITS["200 pairs"]) and times the slot's graphed call
(chip_smoke.graph_ms, the sort, mask, gather and labels included) and the
K7 launch alone (CUDA events around back-to-back launches on the same
arguments), the sources in turns: A B B A for two. Ends with a JSON line of
the turns; `--json PATH` writes the whole result (every phase) there too.
Exits non-zero if a check fails.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402
from metaviterbinet_tpu_torch.kernels import maml_pairs, native  # noqa: E402
from metaviterbinet_tpu_torch.train.meta import masked_pairs  # noqa: E402
from metaviterbinet_tpu_torch.train.optim import Optimizer  # noqa: E402

PROBE_DIR = native.BUILD_DIR / "k7_phases"
CLUSTER = maml_pairs.CLUSTER_SIZE
SLOTS = 96  # csrc/maml_pairs.cu::kProbeSlots
RANKS = (0, CLUSTER - 1)
KINDS = ("global reads", "column-local", "CTA barriers", "cluster barriers", "exchange")


def kind(phase: str) -> str | None:
    """The kind of a phase by its name in csrc/maml_pairs.cu::K7_PHASES."""
    if phase in ("prologue", "skip", "epilogue"):
        return None
    if phase in ("take", "rows", "c3_table") or phase.endswith("_read"):
        return "global reads"
    if re.fullmatch(r"c\d_sync", phase):
        return "cluster barriers"
    if re.fullmatch(r"c\d_(reduce|adam|pull)", phase):
        return "exchange"
    if phase.endswith("_sync"):
        return "CTA barriers"
    return "column-local"


def build(dirs: list[Path]) -> dict[tuple[Path, bool], Path]:
    """nvcc of each csrc/maml_pairs.cu with the package's flags, and with the
    stamps' macro, into the probe's directory, all at once; returns the
    libraries by (directory, stamped), their ptxas reports printed."""
    PROBE_DIR.mkdir(parents=True, exist_ok=True)
    built, running = {}, []
    for csrc in dirs:
        for stamped in (True, False):
            flags = list(native.NVCC_FLAGS) + (["-DK7_PHASE_STAMPS"] if stamped else [])
            digest = hashlib.sha256(" ".join(flags).encode())
            for src in sorted(csrc.glob("*.cuh")) + [csrc / "maml_pairs.cu"]:
                digest.update(src.read_bytes())
            target = PROBE_DIR / f"libmaml_pairs-{digest.hexdigest()[:16]}.so"
            built[(csrc, stamped)] = target
            if not target.exists():
                cmd = [native._nvcc(), *flags, "-I", str(csrc), "-o", str(target),
                       str(csrc / "maml_pairs.cu")]
                running.append((csrc, stamped, target, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    for csrc, stamped, target, proc in running:
        out, _ = proc.communicate()
        report = "\n".join(line for line in out.splitlines()
                           if "registers" in line or "spill" in line or "error" in line)
        print(f"  nvcc {'stamped' if stamped else 'plain'} {csrc} -> {target.name}: rc "
              f"{proc.returncode}\n{report}")
        if proc.returncode != 0:
            raise SystemExit(out)
    return built


class Library:
    """One built maml_pairs library, put in place of the package's K7 for
    the wrapper's calls (`use`), remembering the arguments of its last call."""

    def __init__(self, path: Path):
        self.dll = ctypes.CDLL(str(path))
        self.fn = self.dll.maml_pairs
        self.fn.argtypes, self.fn.restype = maml_pairs.MAML_PAIRS_ABI, ctypes.c_int
        self.last = None

    def __call__(self, *args):
        self.last = args
        return self.fn(*args)

    def use(self) -> None:
        native._functions[("maml_pairs", "maml_pairs")] = self


def slot_call(seed: int):
    """A slot's 200 draws as one call of masked_pairs through K7's wrapper,
    and the state it updates (params, opt state, st)."""
    params, rx, tx, draws = chip_smoke.k7_slot(seed)
    p = {k: v.clone() for k, v in params.items()}
    opt = Optimizer("Adam", chip_smoke.K7_LR)
    state = opt.init(p)
    st = {"rx": rx, "tx": tx, "loss": torch.zeros((), device="cuda"),
          "pairs": torch.zeros((), dtype=torch.int32, device="cuda")}
    first = torch.zeros(1, dtype=torch.int64, device="cuda")
    run = chip_smoke.k7_pairs(maml_pairs.maml_pairs_viterbinet, opt)

    def call():
        masked_pairs(run, lambda st, j: (st["rx"][j[:, None] - 1], st["tx"][j[:, None] - 1],
                                         st["rx"][j[:, None]], st["tx"][j[:, None]]),
                     p, state, st, draws, first, draws.numel())
    return call, (p, state, st)


def phases(lib: Library, seed: int) -> dict:
    """One slot through the stamped library: microseconds a taken pair by
    phase on RANKS, the sums by kind, and the clock rate."""
    lib.use()
    call, (_, state, _) = slot_call(seed)
    call()
    torch.cuda.synchronize()
    pairs = int(state.count)
    names = lib.dll.k7_phase_names
    names.restype = ctypes.c_char_p
    names = names().decode().split()
    out = np.zeros(CLUSTER * SLOTS + CLUSTER * 4, dtype=np.int64)
    rc = lib.dll.k7_phase_cycles(ctypes.c_void_p(out.ctypes.data))
    native.check_launch("k7_phase_cycles", rc)
    cycles = out[:CLUSTER * SLOTS].reshape(CLUSTER, SLOTS)
    span = out[CLUSTER * SLOTS:].reshape(CLUSTER, 4)
    ghz = (span[:, 2] - span[:, 0]) / np.maximum(span[:, 3] - span[:, 1], 1)
    us = {r: {n: float(cycles[r, i] / ghz[r] / 1e3 / pairs) for i, n in enumerate(names)}
          for r in RANKS}
    by_kind = {r: {k: sum(v for n, v in us[r].items() if kind(n) == k) for k in KINDS}
               for r in RANKS}
    launch_us = float((span[0, 3] - span[0, 1]) / 1e3)
    return {"pairs": pairs, "ghz": [float(g) for g in ghz[list(RANKS)]], "us": us,
            "by_kind": by_kind, "pair_us": {r: sum(by_kind[r].values()) for r in RANKS},
            "launch_us": launch_us}


def check(lib: Library, seed: int) -> float:
    """The slot through lib in one launch against K7's plain version: max |dparam|."""
    lib.use()
    inputs = chip_smoke.k7_slot(seed)
    kernel = chip_smoke.k7_slot_run(*inputs, "kernel", one_launch=True)
    plain = chip_smoke.k7_slot_run(*inputs, "plain", one_launch=True)
    if not int(kernel[1].count) == int(plain[1].count) == int(kernel[2]["pairs"]):
        raise SystemExit(f"K7 counts differ: {int(kernel[1].count)}, {int(plain[1].count)}")
    return chip_smoke._max_diff(kernel[0], plain[0])


def timings(lib: Library, seed: int, launches: int = 50) -> dict:
    """The slot's graphed call (chip_smoke.graph_ms) and the K7 launch alone."""
    lib.use()
    call, _ = slot_call(seed)
    graphed = chip_smoke.graph_ms(call, per_graph=1, replays=5)
    call()
    torch.cuda.synchronize()
    args = lib.last
    for _ in range(3):
        lib.fn(*args)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(launches):
        lib.fn(*args)
    end.record()
    torch.cuda.synchronize()
    return {"slot_call_ms": graphed, "launch_ms": start.elapsed_time(end) / launches}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--csrc", type=Path, action="append",
                    help="kernel source directories (default: the package's)")
    ap.add_argument("--label", action="append", help="a name for each --csrc")
    ap.add_argument("--seed", type=int, default=chip_smoke.K7_WITNESS_SEEDS[0])
    ap.add_argument("--json", type=Path, help="a file for the whole result")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card: K7 has no CPU build")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card)
    dirs = [d.resolve() for d in (args.csrc or [native.CSRC_DIR])]
    labels = args.label or [str(d) for d in dirs]
    if len(labels) != len(dirs):
        raise SystemExit("one --label for each --csrc")
    built = build(dirs)
    libs = {label: (Library(built[(d, True)]), Library(built[(d, False)]))
            for label, d in zip(labels, dirs)}
    result = {"card": card, "seed": args.seed, "sources": {}}
    failed = False
    for label, (stamped, plain) in libs.items():
        split = phases(stamped, args.seed)
        err = check(plain, args.seed)
        ok = err <= chip_smoke.K7_LIMITS["200 pairs"]
        failed |= not ok
        result["sources"][label] = {"split": split, "max_dparam": err, "ok": ok}
        print(f"\n{label}: {split['pairs']} pairs taken, clock {split['ghz'][0]:.3f} GHz, the "
              f"stamped launch {split['launch_us']:.1f} us; the plain library's slot against "
              f"K7's plain version max |dparam| {err:.3e} (limit "
              f"{chip_smoke.K7_LIMITS['200 pairs']:g}) {'ok' if ok else 'FAILED'}")
        print(f"  {'phase (us a pair)':<22}" + "".join(f"rank {r:>2}".rjust(10) for r in RANKS))
        for name in split["us"][RANKS[0]]:
            print(f"  {name:<22}" + "".join(f"{split['us'][r][name]:10.3f}" for r in RANKS))
        for k in KINDS:
            print(f"  = {k:<20}" + "".join(f"{split['by_kind'][r][k]:10.3f}" for r in RANKS))
        print(f"  = {'a pair':<20}" + "".join(f"{split['pair_us'][r]:10.3f}" for r in RANKS))
    order = list(libs) + list(libs)[::-1]
    turns = []
    for label in order:
        t = timings(libs[label][1], args.seed)
        turns.append({"label": label, **t})
        print(f"turn {label}: the slot's graphed call {t['slot_call_ms']:.5f} ms, the K7 launch "
              f"alone {t['launch_ms']:.5f} ms [{card}]")
    result["turns"] = turns
    if args.json is not None:
        args.json.write_text(json.dumps(result) + "\n")
    print(json.dumps({"card": card, "turns": turns,
                      "pair_us": {k: v["split"]["pair_us"] for k, v in result["sources"].items()}}))
    if failed:
        raise SystemExit("a source's slot differs from K7's plain version beyond its limit")


if __name__ == "__main__":
    main()
