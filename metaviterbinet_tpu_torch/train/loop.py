"""Offline supervised training: the reference's per-word sweep (reference
trainer.py:455-505; the JAX package's train/loop.py), one optimizer step per
word, in word order."""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from metaviterbinet_tpu_torch.train.optim import Optimizer, OptState


def word_sweep(loss_fn: Callable, optimizer: Optimizer, params: dict[str, torch.Tensor],
               opt_state: OptState, rx_words: torch.Tensor, tx_words: torch.Tensor,
               select: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
    """One step per word on `params` and `opt_state`, in place; `select[i]`
    are word i's select_batch indices (None for a loss that does not
    subsample). Returns the sum of the words' losses as a 0-d tensor."""
    names = list(params)
    total = rx_words.new_zeros(())
    for i in range(rx_words.shape[0]):
        loss = loss_fn(params, rx_words[i:i + 1], tx_words[i:i + 1],
                       None if select is None else select[i])
        grads = torch.autograd.grad(loss, [params[k] for k in names])
        optimizer.step(params, dict(zip(names, grads)), opt_state)
        total = total + loss.detach()
    return total
