"""Driver of an offline-training cell: the port's word sweep
(metaviterbinet_tpu_torch.train.loop.word_sweep with make_sweep_step, in
chunks of chunk_steps(words, STEP_NODES) steps), one minibatch of words a
call with its loss read on the host, as Trainer.train runs a
train-on-miss; every traffic "restart_every" minibatches training starts
over from fresh params, with a new step and so a new capture.

Set-up, from --seed: the words (a first minibatch whose first rows start
the training, then traffic "pool" minibatches that the window cycles
through), each word's select_batch positions, and the params, all drawn
on the device; then the training object (params, Adam state, step) takes
its first three steps through word_sweep, one word a call, then
WARMUP_STEPS + 2 calls of the window's own chunk of steps (its warm-ups,
its capture with the first replay, and a second replay of the graph the
window goes on replaying), and goes on into the window.

The window: minibatches back to back until --seconds have passed on the
host; a CUDA event after each chunk call bounds the chunks, which
partition the window. A word counts where its chunk ended within --seconds
of the window's first event.

The check, after the window: the reference (float64, on the host) takes
the same first steps from the same params, and the training bullet of the
benchmark's contract compares each call's loss, the first gradient's norm
per leaf (read from Adam's first moment after one step), each leaf's
change over the first three steps and each leaf's change over the chunk
calls."""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from portbench import counts, trace, window
from portbench.harness import Cell, Outcome, sub_seed
from portbench.marks import Marks
from portbench.reference import channel
from portbench.reference import lstm as ref_lstm
from portbench.reference.adam import B1, Adam

FIRST_STEPS = 3


def chunk_calls() -> int:
    """The chunk calls the set-up checks: the warm-ups, the capture (which
    replays once) and a second replay."""
    from metaviterbinet_tpu_torch.online.graphs import WARMUP_STEPS

    return WARMUP_STEPS + 2


def words(cell: Cell, seed: int, device: torch.device):
    """(info bits [M + 1, n, k], received [M + 1, n, T], select positions
    [M + 1, n, B]) for the M = traffic "pool" minibatches of n words and
    the first one."""
    c = cell.config
    n = c["train_frames"] * c["subframes_in_frame"]
    k = c["train_block_length"]
    g = torch.Generator(device=device).manual_seed(sub_seed(seed, 1))
    bits, rx, _ = channel.words(cell.traffic["pool"] + 1, n, k, c["n_symbols"],
                                c["memory_length"], c["gamma"], c["snr_db"],
                                c["fading_taps_type"], g, device)
    # select_batch's law: k positions weighted by their index, no replacement
    weights = torch.arange(k, dtype=torch.float32, device=device).repeat(bits.shape[0] * n, 1)
    select = torch.multinomial(weights, c["train_minibatch_size"], replacement=False, generator=g)
    return bits, rx, select.reshape(bits.shape[0], n, -1)


def fresh(cell: Cell, spec, seed: int, index: int, device: torch.device):
    """A training object: the port's model from params drawn on the device,
    its param dict, a fresh Adam state, and the reference's copy of the
    params in float64 on the host."""
    g = torch.Generator(device=device).manual_seed(sub_seed(seed, 2, index))
    params = ref_lstm.init(g, device)
    model = spec.model.from_params(params, device)
    return model, spec.model.param_dict(model), {k: v.to("cpu", torch.float64)
                                                 for k, v in params.items()}


def host(params: dict) -> dict:
    """A float64 copy on the host (never a view of the params)."""
    return {k: v.detach().to("cpu", torch.float64, copy=True) for k, v in params.items()}


def norms(tree: dict) -> dict:
    return {k: float(v.norm()) for k, v in tree.items()}


def gap(prog: dict, ref: dict, keep=None) -> float:
    """Worst leaf of | |prog| - |ref| | over the larger of |ref| and the
    median leaf's |ref|."""
    a, b = norms(prog), norms(ref)
    keep = keep or list(b)
    median = float(np.median([b[k] for k in keep]))
    return max(abs(a[k] - b[k]) / max(b[k], median) for k in keep)


def reference_steps(cell: Cell, p0: dict, rx, bits, select, calls: list[int],
                    dtype=torch.float64, device="cpu") -> dict:
    """The reference over the rows of the first calls, `calls` their
    steps: each call's loss (its rows' losses added), the first gradient,
    each leaf's change over the first FIRST_STEPS steps and over the rest."""
    p = {k: v.to(device, dtype).clone().requires_grad_(True) for k, v in p0.items()}
    adam = Adam(p, cell.config["lr"])
    losses, first, at_three = [], None, None
    for i in range(sum(calls)):
        loss = ref_lstm.loss(p, rx[i:i + 1].to(device, dtype), bits[i:i + 1].to(device),
                             select[i].to(device))
        grads = torch.autograd.grad(loss, list(p.values()))
        if first is None:
            first = {k: g.detach().to("cpu", torch.float64) for k, g in zip(p, grads)}
        adam.step(p, dict(zip(p, grads)))
        losses.append(loss.item())
        if i + 1 == FIRST_STEPS:
            at_three = host(p)
    ends = np.cumsum(calls)
    return {"losses": [sum(losses[e - n:e]) for n, e in zip(calls, ends)], "first_grad": first,
            "change": {k: v - p0[k].to(torch.float64) for k, v in at_three.items()},
            "sweep_change": {k: v - at_three[k] for k, v in host(p).items()}}


def numbers(prog: dict, ref: dict) -> dict[str, float]:
    """The numbers of the training comparison. The changes leave out
    leaves whose reference gradient is below a thousandth of the median
    leaf's (their moves are round-off under Adam)."""
    g = norms(ref["first_grad"])
    median = float(np.median(list(g.values())))
    moved = [k for k in g if g[k] >= 1e-3 * median]
    return {"loss_gap": max(abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"])),
            "grad_gap": gap(prog["first_grad"], ref["first_grad"]),
            "change_gap": gap(prog["change"], ref["change"], moved),
            "sweep_change_gap": gap(prog["sweep_change"], ref["sweep_change"], moved)}


@dataclasses.dataclass
class SetUp:
    words: tuple
    spec: object
    chunk: int
    loss_fn: object
    optimizer: object
    ref_p0: dict
    prog: dict
    calls: list
    model: object = None
    params: dict = None
    state: object = None
    step: object = None

    def new_object(self, cell: Cell, seed: int, index: int, device: torch.device) -> dict:
        """A fresh training object in place of the last; returns the
        reference's float64 copy of its params."""
        from metaviterbinet_tpu_torch.train.loop import make_sweep_step

        self.model, self.params, ref_p0 = fresh(cell, self.spec, seed, index, device)
        self.state = self.optimizer.init(self.params)
        self.step = make_sweep_step(self.loss_fn, self.optimizer)
        return ref_p0


def set_up(cell: Cell, seed: int, device: torch.device) -> SetUp:
    """The words, the first training object and its first steps."""
    from metaviterbinet_tpu_torch.detectors import DETECTORS
    from metaviterbinet_tpu_torch.online.graphs import chunk_steps
    from metaviterbinet_tpu_torch.train.losses import make_loss_fn
    from metaviterbinet_tpu_torch.train.loop import word_sweep
    from metaviterbinet_tpu_torch.train.optim import Optimizer

    c, t = cell.config, cell.traffic
    spec = DETECTORS[t["detector"]]
    bits, rx, select = words(cell, seed, device)
    chunk = chunk_steps(rx.shape[1], spec.model.STEP_NODES)
    calls = [1] * FIRST_STEPS + [chunk] * chunk_calls()
    if sum(calls) > rx.shape[1]:
        raise ValueError(f"the first calls take {sum(calls)} rows of a {rx.shape[1]}-word minibatch")
    su = SetUp(words=(bits, rx, select), spec=spec, chunk=chunk,
               loss_fn=make_loss_fn(spec.score, spec.label_kind, c["memory_length"],
                                    spec.subsample_loss, c["loss_type"]),
               optimizer=Optimizer(c["optimizer_type"], c["lr"]), ref_p0={}, prog={"losses": []},
               calls=calls)
    su.ref_p0 = su.new_object(cell, seed, 0, device)
    at = 0
    for i, n in enumerate(calls):
        su.prog["losses"].append(float(word_sweep(
            su.loss_fn, su.optimizer, su.params, su.state, rx[0, at:at + n], bits[0, at:at + n],
            list(select[0, at:at + n]), su.step, n)))
        at += n
        if i == 0:
            su.prog["first_grad"] = {k: v / (1 - B1) for k, v in host(su.state.mu).items()}
        if at == FIRST_STEPS:
            at_three = host(su.params)
    su.prog["change"] = {k: v - su.ref_p0[k] for k, v in at_three.items()}
    su.prog["sweep_change"] = {k: v - at_three[k] for k, v in host(su.params).items()}
    return su


def check(cell: Cell, su: SetUp) -> dict[str, float]:
    n = sum(su.calls)
    bits, rx, select = (x[0, :n].cpu() for x in su.words)
    return numbers(su.prog, reference_steps(cell, su.ref_p0, rx, bits, select, su.calls))


def run(cell: Cell, seed: int, seconds: float, traced: bool, device: torch.device,
        started: float) -> Outcome:
    from metaviterbinet_tpu_torch.train.loop import word_sweep

    t = cell.traffic
    entered_s = time.time() - started
    su = set_up(cell, seed, device)
    bits, rx, select = su.words
    chunk, loss_fn, optimizer = su.chunk, su.loss_fn, su.optimizer
    n = rx.shape[1]
    marks = Marks(device)
    marks.synchronize()
    setup_s = time.time() - started

    ends, call_ms = [], []

    def timed(*args):
        a = marks.mark() if traced else None
        out = su.step(*args)
        ends.append(marks.mark())
        if traced:
            call_ms.append((a, ends[-1]))
        return out

    restart_every, pool = t["restart_every"], t["pool"]
    first = marks.mark()
    t0 = time.perf_counter()
    done = 0
    while time.perf_counter() - t0 < seconds:
        if done and done % restart_every == 0:
            su.new_object(cell, seed, done // restart_every, device)
        b = 1 + done % pool
        float(word_sweep(loss_fn, optimizer, su.params, su.state, rx[b], bits[b], list(select[b]),
                         timed, chunk))
        done += 1
    marks.synchronize()
    memory_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    boundaries = [[0.0] + [marks.ms(first, e) for e in ends]]
    if not window.in_window(boundaries, 1e3 * seconds):
        raise RuntimeError(f"no chunk of steps ended within the {seconds} s window")
    e2e = {"train_words_per_s": window.rate(boundaries, 1e3 * seconds, per_item=chunk),
           "setup_s": setup_s}

    layer, busy_s, window_s, breakdown = {}, None, None, None
    if traced:
        steps_done = chunk * len(ends)
        layer = {"config": cell.config, "T": rx.shape[2],
                 "step_ms": sum(marks.ms(a, b) for a, b in call_ms) / steps_done,
                 "model_ops": steps_done * counts.lstm_step_ops(rx.shape[2]),
                 "runs_ms": boundaries[0][-1]}
        b = 1 + done % pool
        host: list[tuple[float, float, str]] = []

        def profiled_minibatch():
            t0 = time.time_ns()
            total = word_sweep(loss_fn, optimizer, su.params, su.state, rx[b], bits[b],
                               list(select[b]), su.step, chunk)
            t1 = time.time_ns()
            float(total)
            host.extend([(t0 / 1e6, t1 / 1e6, "sweep"), (t1 / 1e6, time.time_ns() / 1e6,
                                                          "loss read")])

        pr = trace.profiled(profiled_minibatch, host)
        if pr.activities:
            busy_s, window_s = pr.busy_ms / 1e3, pr.wall_ms / 1e3
            breakdown = {"device_ops": pr.device_ops, "idle_gaps": pr.idle_gaps}

    su.model = su.params = su.state = su.step = None
    t_check = time.perf_counter()
    got = check(cell, su)
    check_s = time.perf_counter() - t_check
    checks = {k: (v, cell.limits[k]["limit"]) for k, v in got.items() if k in cell.limits}
    readings = {k: v for k, v in got.items() if k not in cell.limits}
    readings.update(check_s=check_s, setup_entered_s=entered_s, minibatches=done, first_losses=su.prog["losses"])
    return Outcome(e2e=e2e, layer=layer, checks=checks, readings=readings,
                   attempted=done * n, failed=0, memory_peak_bytes=memory_peak,
                   busy_s=busy_s, window_s=window_s, breakdown=breakdown)
