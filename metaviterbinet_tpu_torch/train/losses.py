"""Loss functions and minibatch subsampling (the JAX package's
train/losses.py).

Parity notes:
  - ViterbiNet trains with CE between per-symbol state logits and trellis
    state labels (reference vnet_trainer.py:37-47); the LSTM with CE
    between per-symbol class logits and bit labels (lstm_trainer.py:30-40).
  - `select_batch` is the reference's index-proportional multinomial
    subsampling without replacement (trainer.py:534-544), index 0 never
    drawn (its weight is 0). The caller draws the indices and passes them to
    the loss, so that a test can pass another package's draws.
  - Meta losses use all symbols, no subsampling (metavnet_trainer.py:41-50).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F

from metaviterbinet_tpu_torch.ops.trellis import calculate_states


def select_batch(n: int, batch_size: int, generator: Optional[torch.Generator] = None,
                 device: str | torch.device = "cpu") -> torch.Tensor:
    """Indices of a minibatch: multinomial over arange weights, no replacement."""
    weights = torch.arange(n, dtype=torch.float32, device=device)
    return torch.multinomial(weights, batch_size, replacement=False, generator=generator)


def _criterion(loss_type: str, logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """The reference's three criterion choices (trainer.py:178-185): CE on
    integer labels, BCE and MSE against the one-hot target."""
    if loss_type == "CrossEntropy":
        return F.cross_entropy(logits, labels.long())
    one_hot = F.one_hot(labels.long(), logits.shape[-1]).to(logits.dtype)
    if loss_type == "BCE":
        return F.binary_cross_entropy_with_logits(logits, one_hot)
    if loss_type == "MSE":
        return torch.mean((logits - one_hot) ** 2)
    raise NotImplementedError(f"No such loss function implemented: {loss_type}")


def make_loss_fn(score_fn: Callable, label_kind: str, memory_length: int, subsample: bool,
                 loss_type: str = "CrossEntropy") -> Callable:
    """Build loss(params, rx, tx, idx=None) for a detector's score function.

    label_kind 'states': CE over trellis states (ViterbiNet); 'bits': CE
    over bit classes, the labels tx.reshape(-1) (LSTM). With `subsample`,
    `idx` (a select_batch draw over the label count) picks the symbols;
    otherwise all symbols with a label contribute."""
    if label_kind not in ("states", "bits"):
        raise ValueError(f"unknown label kind {label_kind}")

    def loss_fn(params, rx: torch.Tensor, tx: torch.Tensor,
                idx: Optional[torch.Tensor] = None) -> torch.Tensor:
        logits = score_fn(params, rx)
        flat = logits.reshape(-1, logits.shape[-1])
        labels = calculate_states(memory_length, tx) if label_kind == "states" \
            else tx.reshape(-1)
        # tx may be the 120-bit info word while logits span the 136-symbol
        # codeword: indices run over the LABEL count and index both
        # (trainer.py:542-544 via vnet_trainer.py:45), so symbols past the
        # label range never contribute to the loss
        if subsample:
            if idx is None:
                raise ValueError("this loss subsamples: pass select_batch indices")
            flat, labels = flat[idx], labels[idx]
        else:
            flat = flat[: labels.shape[0]]
        return _criterion(loss_type, flat, labels)

    return loss_fn
