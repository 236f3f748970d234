"""Independent pieces of the reference run side by side after the window,
each in a process of its own with one thread: the by-word check's
reference runs are small operations one after another, bound by the host's
Python, and run one after another they took about as long as the window.

A job and its result are plain data (numpy arrays, numbers, the
reference's own small objects), and `fn` a function that a fresh
interpreter can import: the workers are spawned, never forked from the
process that holds the card. Every worker has ended when `run_all` returns."""
from __future__ import annotations

import multiprocessing
from concurrent.futures import ProcessPoolExecutor
from typing import Callable, Optional, Sequence

WORKERS = 4


def _start(plant: Optional[Callable]) -> None:
    import torch

    torch.set_num_threads(1)
    if plant is not None:
        plant()


def run_all(fn: Callable, jobs: Sequence, cost: Callable, plant: Optional[Callable] = None) -> list:
    """[fn(job) for job in jobs], the costliest jobs (by `cost`) started
    first; `plant()`, where given, runs first in every worker (the tests
    plant faults in the reference so)."""
    if not jobs:
        return []
    order = sorted(range(len(jobs)), key=lambda i: -cost(jobs[i]))
    with ProcessPoolExecutor(max_workers=min(WORKERS, len(jobs)),
                             mp_context=multiprocessing.get_context("spawn"),
                             initializer=_start, initargs=(plant,)) as ex:
        done = list(ex.map(fn, [jobs[i] for i in order]))
    out = [None] * len(jobs)
    for i, r in zip(order, done):
        out[i] = r
    return out
