"""Offline supervised training: the reference's per-word sweep (reference
trainer.py:455-505), one optimizer step per word, in word order. The JAX
package compiles the sweep as one jitted `lax.scan` over words (its
train/loop.py); here each word's step is a CUDA graph on the card, captured
once per set of params and replayed once per word (online/graphs.py), and
the same step function runs directly on the CPU."""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from metaviterbinet_tpu_torch.online.graphs import GraphedStep, device_rows
from metaviterbinet_tpu_torch.train.optim import Optimizer, OptState


def make_sgd_step(loss_fn: Callable, optimizer: Optimizer, name: str) -> GraphedStep:
    """One optimizer step on one word, a CUDA graph on the card:
    step(params, opt_state, rx [1, T], label [1, n], idx [B] or None, bc [2])
    takes one step on loss_fn(params, rx, label, idx) with the bias
    correction bc (Optimizer.advance), in place, and returns the loss (on a
    replay the graph's static output). The engine's self-supervised step
    and the word sweep's step are this step under their own names."""

    def sgd_step(params, opt_state, rx, label, idx, bc) -> torch.Tensor:
        loss = loss_fn(params, rx, label, idx)
        grads = torch.autograd.grad(loss, list(params.values()))
        optimizer.apply(params, dict(zip(params, grads)), opt_state, bc)
        return loss.detach()

    return GraphedStep(sgd_step, name)


def word_sweep(loss_fn: Callable, optimizer: Optimizer, params: dict[str, torch.Tensor],
               opt_state: OptState, rx_words: torch.Tensor, tx_words: torch.Tensor,
               select: Optional[Sequence[torch.Tensor]] = None,
               step: Optional[GraphedStep] = None) -> torch.Tensor:
    """One step per word on `params` and `opt_state`, in place; `select[i]`
    are word i's select_batch indices (None for a loss that does not
    subsample). `step` is make_sgd_step(loss_fn, optimizer, ...), which a
    caller that sweeps more than once passes so that its graph is captured
    once; by default the sweep makes its own. Returns the sum of the words'
    losses, added in word order, as a 0-d tensor."""
    step = step or make_sgd_step(loss_fn, optimizer, "word_sweep")
    n = rx_words.shape[0]
    bc = device_rows(optimizer.advance(opt_state, n), rx_words.device)
    total = rx_words.new_zeros(())
    for i in range(n):
        loss = step(params, opt_state, rx_words[i:i + 1], tx_words[i:i + 1],
                    None if select is None else select[i], bc[i])
        total = total + loss  # in stream order, before the next replay
    return total
