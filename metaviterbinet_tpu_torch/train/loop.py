"""Offline supervised training: the reference's per-word sweep (reference
trainer.py:455-505), one optimizer step per word, in word order. The JAX
package compiles the sweep as one jitted `lax.scan` over words (its
train/loop.py); here a chunk of the sweep's steps is one CUDA graph on the
card, captured once per set of params and replayed over the words, chunk by
chunk (online/graphs.py), and the same chunk function runs directly on the
CPU."""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from metaviterbinet_tpu_torch.online.graphs import GraphedStep
from metaviterbinet_tpu_torch.train.optim import Optimizer, OptState


def sgd_step(loss_fn: Callable, optimizer: Optimizer, params: dict[str, torch.Tensor],
             opt_state: OptState, rx: torch.Tensor, label: torch.Tensor,
             idx: Optional[torch.Tensor]) -> torch.Tensor:
    """One optimizer step on loss_fn(params, rx [1, T], label [1, n], idx),
    in place, at the optimizer state's count; returns the loss. Reads
    nothing back to the host, so a graph can hold it (the engine's
    self-supervised steps and the word sweep's)."""
    loss = loss_fn(params, rx, label, idx)
    grads = torch.autograd.grad(loss, list(params.values()))
    optimizer.apply(params, dict(zip(params, grads)), opt_state)
    return loss.detach()


def make_sweep_step(loss_fn: Callable, optimizer: Optimizer) -> GraphedStep:
    """A chunk of the word sweep, a CUDA graph on the card:
    chunk(params, opt_state, rx [c, T], tx [c, n], idx [c, B] or None,
    total []) takes one step per row, in row order, and returns total plus
    the rows' losses, added in row order."""

    def chunk(params, opt_state, rx, tx, idx, total) -> torch.Tensor:
        for i in range(rx.shape[0]):
            total = total + sgd_step(loss_fn, optimizer, params, opt_state, rx[i:i + 1],
                                     tx[i:i + 1], None if idx is None else idx[i])
        return total

    return GraphedStep(chunk, "word_sweep")


def word_sweep(loss_fn: Callable, optimizer: Optimizer, params: dict[str, torch.Tensor],
               opt_state: OptState, rx_words: torch.Tensor, tx_words: torch.Tensor,
               select: Optional[Sequence[torch.Tensor]] = None,
               step: Optional[GraphedStep] = None, chunk: int = 1) -> torch.Tensor:
    """One step per word on `params` and `opt_state`, in place; `select[i]`
    are word i's select_batch indices (None for a loss that does not
    subsample). `step` is make_sweep_step(loss_fn, optimizer), which a
    caller that sweeps more than once passes so that its graph is captured
    once; by default the sweep makes its own. `chunk` (a divisor of the
    words, online/graphs.py::chunk_steps) is the steps of one call of it.
    Returns the sum of the words' losses, added in word order, as a 0-d
    tensor."""
    step = step or make_sweep_step(loss_fn, optimizer)
    n = rx_words.shape[0]
    if n % chunk:
        raise ValueError(f"a chunk of {chunk} steps does not divide {n} words")
    idx = None if select is None else torch.stack(list(select))
    total = rx_words.new_zeros(())
    for i in range(0, n, chunk):
        total = step(params, opt_state, rx_words[i:i + chunk], tx_words[i:i + chunk],
                     None if idx is None else idx[i:i + chunk], total)
    return total.clone()  # the graph's output, which its next replay overwrites
