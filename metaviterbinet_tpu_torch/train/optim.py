"""Optimizers with optax semantics over parameter dicts (reference
trainer.py:163-177 Adam/RMSprop/SGD; the JAX package's train/optim.py).

The state is plain tensors (the moments) and a host-side step count, so that
one state can be shared by the online self-supervised steps, the meta outer
step (online/engine.py) and the fused adaptation kernel
(kernels/online_sgd.py), which reads and writes the same tensors. Updates
are in place, under `torch.no_grad()`.

Where optax and torch.optim differ, this follows optax:
  - Adam: p + (-lr) * (mu / (1 - b1^t)) / (sqrt(nu / (1 - b2^t)) + eps),
    with mu = (1 - b1) g + b1 mu and nu = (1 - b2) g^2 + b2 nu;
  - RMSprop (decay 0.99): p + (-lr) * g / sqrt(nu + eps), eps INSIDE the
    square root (torch.optim.RMSprop adds it outside);
  - global-norm clipping: g unchanged when ||g|| < max_norm, else
    (g / ||g||) * max_norm (torch's clip_grad_norm_ adds 1e-6).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
RMS_DECAY, RMS_EPS = 0.99, 1e-8


@dataclass
class OptState:
    """count: steps taken (Adam's bias correction); mu, nu: first and second
    moments per parameter name (empty where the optimizer keeps none)."""
    count: int = 0
    mu: dict[str, torch.Tensor] = field(default_factory=dict)
    nu: dict[str, torch.Tensor] = field(default_factory=dict)


def _bias_correction(decay: float, count: int) -> float:
    """1 - decay^count in float32, as optax computes it."""
    return float(np.float32(1.0) - np.float32(decay) ** np.float32(count))


class Optimizer:
    def __init__(self, optimizer_type: str, lr: float, clip_grad_norm: float = 0.0):
        if optimizer_type not in ("Adam", "RMSprop", "SGD"):
            raise NotImplementedError(f"No such optimizer: {optimizer_type}")
        self.optimizer_type = optimizer_type
        self.lr = lr
        self.clip_grad_norm = clip_grad_norm

    def init(self, params: dict[str, torch.Tensor]) -> OptState:
        zeros = lambda: {k: torch.zeros_like(p, memory_format=torch.contiguous_format)
                         for k, p in params.items()}
        if self.optimizer_type == "Adam":
            return OptState(mu=zeros(), nu=zeros())
        if self.optimizer_type == "RMSprop":
            return OptState(nu=zeros())
        return OptState()

    def _clip(self, grads: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        # optax.clip_by_global_norm: the norm over the leaves in key order
        norm = torch.sqrt(sum(torch.sum(grads[k] * grads[k]) for k in sorted(grads)))
        return {k: torch.where(norm < self.clip_grad_norm, g, (g / norm) * self.clip_grad_norm)
                for k, g in grads.items()}

    @torch.no_grad()
    def step(self, params: dict[str, torch.Tensor], grads: dict[str, torch.Tensor],
             state: OptState) -> None:
        """One update of `params` and `state`, in place."""
        if self.clip_grad_norm and self.clip_grad_norm > 0:
            grads = self._clip(grads)
        lr = self.lr
        if self.optimizer_type == "Adam":
            state.count += 1
            bc1 = _bias_correction(ADAM_B1, state.count)
            bc2 = _bias_correction(ADAM_B2, state.count)
            for k, p in params.items():
                g, mu, nu = grads[k], state.mu[k], state.nu[k]
                mu.copy_((1 - ADAM_B1) * g + ADAM_B1 * mu)
                nu.copy_((1 - ADAM_B2) * (g * g) + ADAM_B2 * nu)
                p.add_((mu / bc1) / (torch.sqrt(nu / bc2) + ADAM_EPS) * -lr)
        elif self.optimizer_type == "RMSprop":
            for k, p in params.items():
                g, nu = grads[k], state.nu[k]
                nu.copy_((1 - RMS_DECAY) * (g * g) + RMS_DECAY * nu)
                p.add_(torch.rsqrt(nu + RMS_EPS) * g * -lr)
        else:
            for k, p in params.items():
                p.add_(grads[k] * -lr)
