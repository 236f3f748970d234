"""Adam as Kingma and Ba give it, with optax's placement of eps:
mu <- b1 mu + (1 - b1) g, nu <- b2 nu + (1 - b2) g^2, and at step t
p <- p - lr (mu / (1 - b1^t)) / (sqrt(nu / (1 - b2^t)) + eps)."""
from __future__ import annotations

import torch

B1, B2, EPS = 0.9, 0.999, 1e-8


class Adam:
    def __init__(self, params: dict[str, torch.Tensor], lr: float):
        self.lr, self.t = lr, 0
        self.mu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in params.items()}

    @torch.no_grad()
    def step(self, params: dict[str, torch.Tensor], grads: dict[str, torch.Tensor]) -> None:
        self.t += 1
        c1, c2 = 1 - B1 ** self.t, 1 - B2 ** self.t
        for k, p in params.items():
            g = grads[k]
            self.mu[k].mul_(B1).add_((1 - B1) * g)
            self.nu[k].mul_(B2).add_((1 - B2) * g * g)
            p.sub_(self.lr * (self.mu[k] / c1) / (torch.sqrt(self.nu[k] / c2) + EPS))
