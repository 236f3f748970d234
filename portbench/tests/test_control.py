"""The check's two readings on the card, at the cells' own sizes: the
program's numbers on a few seeds (the benchmark's own runs add the rest of
its dozen), and the control's, the plain reference in the program's place
computed in TF32 on the card (the precision below the configurations'
float32 with TF32 off), on four seeds: the control has to fail a number of
each cell. The faults of the training bullet are read too, planted in the
reference in the program's place, on three seeds: half of each step's
positions left out, and for the by-word cell the MAML pair and the
self-supervised steps that leave the params as they were, and
self-supervision on half of the word. Every fault has to fail a number of
its cell.

    python -m pytest portbench/tests/test_control.py -q -m cuda -s

prints one JSON line of readings per cell."""
import contextlib
import dataclasses
import functools
import json

import pytest
import torch

from portbench import harness, pool as workers
from portbench.reference import byword

SEEDS = tuple(range(9_000_000_001, 9_000_000_013))
BYWORD_SEEDS = SEEDS[:5]
CONTROL_SEEDS = SEEDS[:4]
FAULT_SEEDS = SEEDS[:3]


@contextlib.contextmanager
def tf32():
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def failed(cell, numbers: dict) -> list[str]:
    return [k for k, v in numbers.items() if k in cell.limits and not v <= cell.limits[k]["limit"]]


def _no_pair(*args):
    pass


def _no_adapt(*args):
    pass


def _half_adapt(p, adam, proto, rx, label, adapt=byword.adapt):
    half = rx.shape[-1] // 2
    adapt(p, adam, proto, rx[..., :half], label[..., :half])


BYWORD_FAULTS = {"maml pair unchanged": ("maml_pair", "_no_pair"),
                 "adapt unchanged": ("adapt", "_no_adapt"),
                 "adapt on half the word": ("adapt", "_half_adapt")}


def _plant(name: str, fn: str) -> None:
    """In a worker process: the reference's `name` replaced by this
    module's `fn`."""
    setattr(byword, name, globals()[fn])


def stand_in(cell, drv, su, window_runs, card=None, fault=None):
    """The reference in the program's place over the start runs and the
    checked window runs' first blocks, as the program's run outputs: on
    the card, or with a fault planted, in float32 in worker processes."""
    start = {k: v.cpu() for k, v in su.start.items()}
    items = [(s, s.blocks) for s in su.starts] + [(ru, cell.traffic["checked_blocks"])
                                                  for ru in window_runs]
    if card is not None:
        outs = [drv.reference_run(cell, start, su.pool, ru, n, torch.float32, card)
                for ru, n in items]
    else:
        pool = tuple(x.cpu() for x in su.pool)
        outs = workers.run_all(byword.run_job,
                               [drv.reference_job(cell, start, pool, ru, n, torch.float32)
                                for ru, n in items],
                               cost=lambda job: job[1].shape[0],
                               plant=functools.partial(_plant, *BYWORD_FAULTS[fault]))
    out = [dataclasses.replace(ru, errors=r["errors"], n_gated=r["n_gated"], pairs=r["pairs"],
                               params={k: torch.as_tensor(v).to("cpu", torch.float64)
                                       for k, v in r["params"].items()})
           for (ru, _), r in zip(items, outs)]
    return out[:len(su.starts)], out[len(su.starts):]


@pytest.mark.cuda
def test_byword_control(card):
    cell = harness.cell("viterbinet.meta")
    drv = cell.driver()
    out = {"program": {}, "control": {}, **{f: {} for f in BYWORD_FAULTS}}
    for seed in BYWORD_SEEDS:
        su = drv.set_up(cell, seed, card)
        # the window's first runs, as the window runs them
        runs = [drv.window_run(cell, su, r, seed) for r in range(cell.traffic["checked_runs"])]
        out["program"][seed] = drv.check(cell, su, runs, seed)
        if seed not in CONTROL_SEEDS:
            continue
        window_runs = drv.checked(cell, runs, seed)
        refs = drv.references(cell, su, window_runs)
        with tf32():
            out["control"][seed] = drv.compare(cell, *stand_in(cell, drv, su, window_runs, card),
                                               *refs)
        if seed not in FAULT_SEEDS:
            continue
        for fault in BYWORD_FAULTS:
            out[fault][seed] = drv.compare(cell, *stand_in(cell, drv, su, window_runs,
                                                           fault=fault), *refs)
    print(json.dumps({"cell": cell.name, **out}))
    assert not any(failed(cell, n) for n in out["program"].values())
    for kind, readings in out.items():
        if kind != "program":
            assert all(failed(cell, n) for n in readings.values()), kind


@pytest.mark.cuda
def test_sweep_control(card):
    cell = harness.cell("lstm.train")
    drv = cell.driver()
    out = {"program": {}, "control": {}, "half_batch": {}}
    for seed in SEEDS:
        su = drv.set_up(cell, seed, card)
        out["program"][seed] = drv.check(cell, su)
        if seed not in CONTROL_SEEDS:
            continue
        bits, rx, select = (x[0, :sum(su.calls)].cpu() for x in su.words)
        ref = drv.reference_steps(cell, su.ref_p0, rx, bits, select, su.calls)
        with tf32():
            ctl = drv.reference_steps(cell, su.ref_p0, rx, bits, select, su.calls,
                                      torch.float32, card)
        out["control"][seed] = drv.numbers(ctl, ref)
        if seed in FAULT_SEEDS:
            half = drv.reference_steps(cell, su.ref_p0, rx, bits, select[:, ::2], su.calls,
                                       torch.float32, card)
            out["half_batch"][seed] = drv.numbers(half, ref)
    print(json.dumps({"cell": cell.name, **out}))
    assert not any(failed(cell, n) for n in out["program"].values())
    for kind, readings in out.items():
        if kind != "program":
            assert all(failed(cell, n) for n in readings.values()), kind
