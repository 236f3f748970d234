"""Driver of a by-word cell: the port's online engine
(metaviterbinet_tpu_torch.online.engine.run_online, called as
Trainer.eval_by_word calls it) run after run over a pool of inputs, for
the ViterbiNet family.

Set-up: the pool (traffic "pool" batches of the protocol's blocks, made
on the device) and the start params (traffic "start_params":
"meta_trained" runs the reference's plain MAML meta-training on the
device, "random" draws them), the same for every --seed, since the data
and the params set how many blocks pass the gate and so the work; then,
from --seed, the batches' order and the program's start runs: for each N
of traffic "start_blocks" (the first block; through the first meta slot),
as many runs of N blocks as "start_words" gives, each from a pilot of the
pool the seed picks. The first builds and loads the kernels and the runs
capture every graph a run uses, so they are the warm-up too.

The window: runs back to back, run r on the seed's r-th batch (cycling)
with draws seeded from (--seed, r), until --seconds have passed on the
host; a CUDA event before each run's call, at each block's "detect" span
and after the call bound the blocks, which partition the runs' time. A
block counts where it ended within --seconds of the first event.

With --trace 1 the spans also time "detect", "meta" and "adapt" on the
device, and after the window one pass of the first run's blocks (traffic
"profile_blocks") runs under torch.profiler, its spans on the wall clock.

The check, after the window: a by-word run is chaotic (a relative change
of 1e-7 in the start params changes its blocks' errors from block 53 on,
and Adam's steps on a well-fitted word drive rounding apart within one
block on some words; PERF.md), so no reference can follow a whole run. The
reference (float64, on the host, its runs side by side in processes of
their own) follows the start runs, whose params it compares by the median
over the words, and the first "checked_blocks" blocks of "checked_runs"
window runs drawn from the seed, through several meta slots and well
before the chaos sets in, whose bit errors it compares; and it judges
every run's counts by the rules that tie them to its own per-block errors
and its draws.

The cell runs the protocol as the reference writes it: weights_init
'last_frame' from an empty buffer (WEIGHTS_INIT, BUFFER_EMPTY)."""
from __future__ import annotations

import contextlib
import dataclasses
import time

import numpy as np
import torch

from portbench import counts, pool as workers, trace, window
from portbench.harness import Cell, Outcome, sub_seed
from portbench.marks import Marks
from portbench.reference import byword, channel, meta_train
from portbench.reference import viterbinet as ref_vnet

# the key of the pool and the start params, the same for every --seed
WORK_KEY = 0
# the protocol's start of a block's adaptation and its buffer's at the
# run's start, the only ones the reference follows
WEIGHTS_INIT = "last_frame"
BUFFER_EMPTY = True


class Spans:
    """The engine's `spans`: a mark at each "detect" entry (the blocks'
    boundaries) and the host clock at "sync"; with `detail`, a mark at the
    entry and exit of every span; with `wall`, every span's start and end
    on the wall clock in ms, which trace.profiled names idle gaps by."""

    def __init__(self, marks: Marks, detail: bool = False, wall: bool = False):
        self.marks, self.detail, self.on_wall = marks, detail, wall
        self.detect: list = []
        self.pairs: dict[str, list] = {}
        self.wall: list[tuple[float, float, str]] = []
        self.sync_at = None

    @contextlib.contextmanager
    def __call__(self, name: str):
        if name == "detect":
            self.detect.append(self.marks.mark())
        if name == "sync":
            self.sync_at = time.perf_counter()
        start = self.marks.mark() if self.detail else None
        t0 = time.time_ns() if self.on_wall else None
        yield
        if self.on_wall:
            self.wall.append((t0 / 1e6, time.time_ns() / 1e6, name))
        if self.detail:
            self.pairs.setdefault(name, []).append((start, self.marks.mark()))


def port_config(cell: Cell):
    from metaviterbinet_tpu_torch import Config

    c, t = cell.config, cell.traffic
    fields = {f.name for f in dataclasses.fields(Config)}
    values = {k: v for k, v in c.items() if k in fields}
    values.update(eval_mode="by_word", val_SNR_start=c["snr_db"], val_SNR_end=c["snr_db"],
                  train_SNR_start=c["snr_db"], train_SNR_end=c["snr_db"],
                  self_supervised=t["self_supervised"], online_meta=t["online_meta"],
                  weights_init=WEIGHTS_INIT, buffer_empty=BUFFER_EMPTY)
    return Config(**values)


def protocol(cell: Cell) -> byword.Protocol:
    return byword.Protocol.of(cell.config, cell.traffic["self_supervised"],
                              cell.traffic["online_meta"])


def start_params(cell: Cell, seed: int, device: torch.device) -> dict[str, torch.Tensor]:
    c = cell.config
    g = torch.Generator(device=device).manual_seed(sub_seed(seed, 0))
    params = ref_vnet.init(c["n_states"], g, device)
    if cell.traffic["start_params"] == "meta_trained":
        params = meta_train.meta_train(
            params, protocol(cell), c["train_minibatch_num"],
            c["train_frames"] * c["subframes_in_frame"], c["snr_db"], c["gamma"],
            c["fading_taps_type"], g, torch.Generator().manual_seed(sub_seed(seed, 5)),
            c["val_block_length"])
    return params


@dataclasses.dataclass
class RunOut:
    """One run's outputs and how it was made."""
    blocks: int
    item: int
    offset: int
    host_seed: int
    errors: list[int]
    sers: np.ndarray
    n_gated: int
    pairs: int
    n_buffer: int
    params: dict | None = None


def program_run(cell: Cell, spec, model, pool, item: int, n: int, seed_keys: tuple, seed: int,
                spans=contextlib.nullcontext, keep_params: bool = False,
                offset: int = 0) -> RunOut:
    """The program's run over blocks offset .. offset + n - 1 of batch
    `item` (a run of its own: its first block is its block 0)."""
    from metaviterbinet_tpu_torch.online.engine import Draws, run_online

    bits, rx, h = pool
    device = rx.device
    cfg = port_config(cell)
    host_seed = sub_seed(seed, *seed_keys, 1)
    draws = Draws(cfg, spec, device, torch.Generator(device=device).manual_seed(
        sub_seed(seed, *seed_keys, 0)), torch.Generator().manual_seed(host_seed))
    at = slice(offset, offset + n)
    res = run_online(cfg, spec, model, bits[item, at], rx[item, at], h[at], draws, spans=spans)
    k_bits = bits.shape[-1]
    return RunOut(blocks=n, item=item, offset=offset, host_seed=host_seed,
                  errors=[int(v) for v in np.rint(res.ser_by_word * k_bits)],
                  sers=res.ser_by_word,
                  n_gated=res.n_gated, pairs=res.steps["maml"], n_buffer=res.n_buffer,
                  params={name: v.detach().to("cpu", torch.float64)
                          for name, v in spec.model.param_dict(res.params).items()}
                  if keep_params else None)


def leaf_gap(params: dict, ref: dict) -> float:
    """The median over the leaves of |p - r| / |r|."""
    return float(np.median([float((params[k] - ref[k]).norm() / ref[k].norm()) for k in ref]))


def reference_job(cell: Cell, start: dict, pool, run: RunOut, n: int, dtype=torch.float64,
                  tf32: bool = False) -> tuple:
    """byword.run_job's job: the reference over the first n blocks of a
    program's run, with the run's draws; with `tf32`, its products in
    TF32."""
    proto = dataclasses.replace(protocol(cell), tf32=tf32)
    bits, rx, _ = pool
    draws = byword.QueryDraws(run.host_seed, len(byword.meta_slots(proto, run.blocks)), proto)
    at = slice(run.offset, run.offset + n)
    return ({k: v.cpu().numpy() for k, v in start.items()}, rx[run.item, at].cpu().numpy(),
            bits[run.item, at].cpu().numpy(), proto, draws, str(dtype).removeprefix("torch."))


def reference_run(cell: Cell, start: dict, pool, run: RunOut, n: int, dtype=torch.float64,
                  device="cpu", tf32: bool = False) -> dict:
    """The same reference here, on `device`."""
    params, rx, tx, proto, draws, _ = reference_job(cell, start, pool, run, n, dtype, tf32)
    return byword.run({k: torch.from_numpy(v).to(device, dtype) for k, v in params.items()},
                      torch.from_numpy(rx).to(device, dtype), torch.from_numpy(tx), proto, draws)


def reference_runs(jobs: list[tuple]) -> list[dict]:
    """byword.run_job over the jobs, side by side; params back as float64
    tensors."""
    out = workers.run_all(byword.run_job, jobs, cost=lambda job: job[1].shape[0])
    for r in out:
        r["params"] = {k: torch.from_numpy(v).to(torch.float64) for k, v in r["params"].items()}
    return out


def in_units(a: float, unit: float) -> float:
    """a / unit; where the unit is 0 (nothing moved), 0 for a 0, else inf."""
    return a / unit if unit else (0.0 if a == 0 else float("inf"))


def start_numbers(cell: Cell, starts: list[RunOut], refs: list[dict],
                  yardsticks: list[dict]) -> dict[str, float]:
    """The start runs against the reference's float64 runs of the same
    blocks. After the first block, over each word, the program's distance
    (median leaf) in units of the distance of the reference computed with
    TF32 products (`yardsticks`, one per one-block run), median over the
    words: a program as imprecise as TF32 reads about 1. After the first
    meta slot, the median over the words of the median leaf's distance.
    And the blocks' errors apart."""
    n1, n6 = cell.traffic["start_blocks"]
    ones = [(s, r) for s, r in zip(starts, refs) if s.blocks == n1]
    first = [in_units(leaf_gap(s.params, r["params"]), leaf_gap(y["params"], r["params"]))
             for (s, r), y in zip(ones, yardsticks)]
    slot = [leaf_gap(s.params, r["params"]) for s, r in zip(starts, refs) if s.blocks == n6]
    return {"first_block_params": float(np.median(first)),
            "first_slot_params": float(np.median(slot)),
            "start_errors_apart": errors_apart(starts, refs)}


def yardstick_jobs(cell: Cell, start: dict, pool, starts: list[RunOut]) -> list[tuple]:
    """The reference with TF32 products over each one-block start run."""
    n1 = cell.traffic["start_blocks"][0]
    return [reference_job(cell, start, pool, s, n1, torch.float32, tf32=True)
            for s in starts if s.blocks == n1]


def errors_apart(runs: list[RunOut], refs: list[dict], n: int | None = None) -> float:
    """Bit errors apart over the first n blocks (all) of each run."""
    return float(sum(abs(a - b) for ru, r in zip(runs, refs)
                     for a, b in zip(ru.errors[:n], r["errors"][:n])))


def run_counts_apart(cell: Cell, run: RunOut) -> int:
    """How far a run's counts are from what its own per-block errors and
    its draws make them: the gated blocks, the MAML pairs, the buffer's
    fill, errors at pilots and error rates off the grid of whole bits."""
    proto = protocol(cell)
    k = cell.config["val_block_length"]
    allowed = byword.errors_allowed(proto, k)
    gates = [e <= allowed for e in run.errors]
    draws = byword.QueryDraws(run.host_seed, len(byword.meta_slots(proto, run.blocks)), proto)
    off_grid = int(np.sum(np.abs(run.sers * k - np.rint(run.sers * k)) > 1e-3))
    pilots = sum(run.errors[c] for c in range(0, run.blocks, proto.subframes))
    pairs = byword.expected_pairs(gates, proto, draws)
    return (abs(run.n_gated - sum(gates)) + abs(run.pairs - pairs)
            + abs(run.n_buffer - min(sum(gates), proto.buffer_capacity)) + pilots + off_grid)


@dataclasses.dataclass
class SetUp:
    pool: tuple
    start: dict
    spec: object
    model: object
    starts: list
    order: np.ndarray  # the window's run r takes batch order[r mod pool]


def set_up(cell: Cell, seed: int, device: torch.device) -> SetUp:
    """The pool, the start params, the program's model and its start runs."""
    from metaviterbinet_tpu_torch.detectors import DETECTORS

    c, t = cell.config, cell.traffic
    n_blocks = c["val_frames"] * c["subframes_in_frame"]
    # the same batches and start params for every seed, so that no seed
    # changes the work; the seed orders them, draws the queries and picks
    # the start runs' words
    g = torch.Generator(device=device).manual_seed(sub_seed(WORK_KEY, 6))
    pool = channel.words(t["pool"], n_blocks, c["val_block_length"], c["n_symbols"],
                         c["memory_length"], c["gamma"], c["snr_db"], c["fading_taps_type"], g,
                         device)
    start = start_params(cell, WORK_KEY, device)
    spec = DETECTORS[t["detector"]]
    model = spec.model.from_params(start, device)
    rng = np.random.default_rng(sub_seed(seed, 10))
    order = rng.permutation(t["pool"])
    starts = []
    for n, words in zip(t["start_blocks"], t["start_words"]):
        # distinct pilots of the pool from which n blocks fit
        pilots = [(item, k * c["subframes_in_frame"]) for item in range(t["pool"])
                  for k in range(n_blocks // c["subframes_in_frame"])
                  if k * c["subframes_in_frame"] + n <= n_blocks]
        for w in rng.choice(len(pilots), words, replace=False):
            item, offset = pilots[w]
            starts.append(program_run(cell, spec, model, pool, item, n, (7, n, int(w)), seed,
                                      keep_params=True, offset=offset))
    return SetUp(pool=pool, start=start, spec=spec, model=model, starts=starts, order=order)


def checked(cell: Cell, runs: list[RunOut], seed: int) -> list[RunOut]:
    """The window runs whose first blocks the reference follows, drawn
    from the seed."""
    rng = np.random.default_rng(sub_seed(seed, 9))
    return [runs[i] for i in rng.choice(len(runs), min(cell.traffic["checked_runs"], len(runs)),
                                        replace=False)]


def references(cell: Cell, su: SetUp, window_runs: list[RunOut]) -> tuple[list, list, list]:
    """The float64 reference over the start runs and over the first
    "checked_blocks" blocks of the window runs, and the TF32 yardsticks."""
    pool = tuple(x.cpu() for x in su.pool)
    start = {k: v.cpu() for k, v in su.start.items()}
    n1, n2 = len(su.starts), len(su.starts) + len(window_runs)
    refs = reference_runs([reference_job(cell, start, pool, s, s.blocks) for s in su.starts]
                          + [reference_job(cell, start, pool, ru, cell.traffic["checked_blocks"])
                             for ru in window_runs]
                          + yardstick_jobs(cell, start, pool, su.starts))
    return refs[:n1], refs[n1:n2], refs[n2:]


def compare(cell: Cell, starts: list[RunOut], window_runs: list[RunOut], refs: list[dict],
            window_refs: list[dict], yards: list[dict]) -> dict[str, float]:
    """start_numbers, and the bit errors apart over the checked blocks of
    the window runs."""
    numbers = start_numbers(cell, starts, refs, yards)
    numbers["window_errors_apart"] = errors_apart(window_runs, window_refs,
                                                  cell.traffic["checked_blocks"])
    return numbers


def check(cell: Cell, su: SetUp, runs: list[RunOut], seed: int) -> dict[str, float]:
    """Every number of the check: the start runs and the first blocks of
    the checked window runs against the reference, every run's counts
    against its own errors and draws."""
    window_runs = checked(cell, runs, seed)
    numbers = compare(cell, su.starts, window_runs, *references(cell, su, window_runs))
    numbers["run_counts_apart"] = float(sum(run_counts_apart(cell, ru) for ru in su.starts + runs))
    return numbers


def window_run(cell: Cell, su: SetUp, r: int, seed: int, spans=contextlib.nullcontext,
               n: int | None = None) -> RunOut:
    """The window's run r, or its first n blocks."""
    c = cell.config
    return program_run(cell, su.spec, su.model, su.pool, int(su.order[r % cell.traffic["pool"]]),
                       n or c["val_frames"] * c["subframes_in_frame"], (8, r), seed, spans=spans)


def run(cell: Cell, seed: int, seconds: float, traced: bool, device: torch.device,
        started: float) -> Outcome:
    c, t = cell.config, cell.traffic
    n_blocks = c["val_frames"] * c["subframes_in_frame"]
    entered_s = time.time() - started
    su = set_up(cell, seed, device)
    marks = Marks(device)
    marks.synchronize()
    setup_s = time.time() - started

    runs, bounds, host_ms, spans_all = [], [], [], []
    first = prev = marks.mark()
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        r = len(runs)
        sp = Spans(marks, detail=traced)
        h0 = time.perf_counter()
        runs.append(window_run(cell, su, r, seed, spans=sp))
        end = marks.mark()
        host_ms.append(1e3 * (sp.sync_at - h0) / n_blocks)
        bounds.append([prev] + sp.detect[1:] + [end])
        spans_all.append(sp)
        prev = end
    marks.synchronize()
    memory_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    boundaries = [[marks.ms(first, m) for m in b] for b in bounds]
    latencies = window.in_window(boundaries, 1e3 * seconds)
    if not latencies:
        raise RuntimeError(f"no block ended within the {seconds} s window")
    e2e = {"blocks_per_s": window.rate(boundaries, 1e3 * seconds),
           "block_p95_ms": window.p95(latencies), "setup_s": setup_s}

    layer, busy_s, window_s, breakdown = {}, None, None, None
    if traced:
        S, T = c["n_states"], c["val_block_length"] + 8 * c["n_symbols"]
        span_ms = {n: [marks.ms(a, b) for sp in spans_all for a, b in sp.pairs.get(n, [])]
                   for n in ("detect", "meta", "adapt")}
        ops = sum(n_blocks * counts.detect_ops(T, S)
                  + ru.pairs * counts.maml_pair_ops(T, S, c["window_size"])
                  + ru.n_gated * counts.adapt_ops(T, S, c["self_supervised_iterations"])
                  for ru in runs)
        layer = {"config": c, "T": T, "host_ms_per_block": host_ms, "span_ms": span_ms,
                 "pairs": sum(ru.pairs for ru in runs), "n_gated": sum(ru.n_gated for ru in runs),
                 "model_ops": ops, "runs_ms": boundaries[-1][-1]}
        sp = Spans(marks, wall=True)
        p = trace.profiled(lambda: window_run(cell, su, 0, seed, sp, t["profile_blocks"]),
                           sp.wall)
        if p.activities:
            layer["kernel_ms"] = p.kernel_ms
            busy_s, window_s = p.busy_ms / 1e3, p.wall_ms / 1e3
            breakdown = {"device_ops": p.device_ops, "idle_gaps": p.idle_gaps}

    # the check, with the program's state freed
    su.model = None
    t_check = time.perf_counter()
    numbers = check(cell, su, runs, seed)
    check_s = time.perf_counter() - t_check
    checks = {k: (v, cell.limits[k]["limit"]) for k, v in numbers.items() if k in cell.limits}
    readings = {k: v for k, v in numbers.items() if k not in cell.limits}
    readings.update(check_s=check_s, setup_entered_s=entered_s, runs=len(runs), gated=sum(ru.n_gated for ru in runs),
                    pairs=sum(ru.pairs for ru in runs),
                    mean_data_ber=float(np.mean([np.mean([e for i, e in enumerate(ru.errors)
                                                          if i % c["subframes_in_frame"]])
                                                 for ru in runs]) / c["val_block_length"]))
    return Outcome(e2e=e2e, layer=layer, checks=checks, readings=readings,
                   attempted=len(runs) * n_blocks, failed=0, memory_peak_bytes=memory_peak,
                   busy_s=busy_s, window_s=window_s, breakdown=breakdown)
