"""Optimizers with optax semantics over parameter dicts (reference
trainer.py:163-177 Adam/RMSprop/SGD; the JAX package's train/optim.py).

The state is plain tensors on the params' device: the moments and the step
count, a 0-d int32 tensor as optax's is. One state is shared by the online
self-supervised steps, the meta outer step (online/engine.py) and the fused
adaptation kernel (kernels/online_sgd.py), which reads and advances the same
count. Updates are in place, under `torch.no_grad()`, and read nothing back
to the host, so that a CUDA graph (online/graphs.py) can capture them and a
replay takes the count it finds on the device.

Adam's bias corrections come from a table of float32 reciprocals
(`adam_factors`), built on the host once per process with optax's float32
expression and uploaded once per device: a step gathers the row of its count
on the device and advances the count there. Row i holds the factors of step
i + 1, and the last row is the first count at which both 1 - b^count round
to exactly 1.0f (count 17,321, so 17,321 rows), so clamping the count to it
changes no bit. The update multiplies by the reciprocal: that is what PyTorch's
division by a host float computes on the card (its CUDA kernel multiplies
by the divisor's reciprocal), so the table gives the bits of the eager
division; a division by a device tensor would divide exactly and move the
updates by an ulp.

Where optax and torch.optim differ, this follows optax:
  - Adam: p + (-lr) * (mu / (1 - b1^t)) / (sqrt(nu / (1 - b2^t)) + eps),
    with mu = (1 - b1) g + b1 mu and nu = (1 - b2) g^2 + b2 nu, each
    division by a bias correction a product with its float32 reciprocal
    (within an ulp of optax's quotient);
  - RMSprop (decay 0.99): p + (-lr) * g / sqrt(nu + eps), eps INSIDE the
    square root (torch.optim.RMSprop adds it outside);
  - global-norm clipping: g unchanged when ||g|| < max_norm, else
    (g / ||g||) * max_norm (torch's clip_grad_norm_ adds 1e-6).
"""
from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from metaviterbinet_tpu_torch.utils import profiling

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
RMS_DECAY, RMS_EPS = 0.99, 1e-8


def _count0(device: torch.device | str = "cpu") -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32, device=device)


@dataclass
class OptState:
    """count: steps taken (Adam's bias correction), a 0-d int32 tensor on
    the params' device; mu, nu: first and second moments per parameter name
    (empty where the optimizer keeps none)."""
    count: torch.Tensor = field(default_factory=_count0)
    mu: dict[str, torch.Tensor] = field(default_factory=dict)
    nu: dict[str, torch.Tensor] = field(default_factory=dict)


def _bias_correction(decay: float, count: int) -> float:
    """1 - decay^count in float32, as optax computes it."""
    return float(np.float32(1.0) - np.float32(decay) ** np.float32(count))


@functools.lru_cache(maxsize=None)
def adam_factors() -> np.ndarray:
    """[17321, 2] float32: row i holds (1 / (1 - b1^t),
    1 / (1 - b2^t)) at step t = i + 1; the last row is the first t at which
    both are exactly 1.0f, as they are at every later t."""
    one = np.float32(1.0)
    rows = []
    while not rows or rows[-1] != (one, one):
        t = len(rows) + 1
        rows.append((one / np.float32(_bias_correction(ADAM_B1, t)),
                     one / np.float32(_bias_correction(ADAM_B2, t))))
    return np.array(rows, dtype=np.float32)


class Optimizer:
    def __init__(self, optimizer_type: str, lr: float, clip_grad_norm: float = 0.0):
        if optimizer_type not in ("Adam", "RMSprop", "SGD"):
            raise NotImplementedError(f"No such optimizer: {optimizer_type}")
        self.optimizer_type = optimizer_type
        self.lr = lr
        self.clip_grad_norm = clip_grad_norm
        self._tables: dict[torch.device, torch.Tensor] = {}

    def table(self, device: torch.device) -> torch.Tensor:
        """adam_factors() on `device`, uploaded at the first call there
        (Optimizer.init makes it, before any capture)."""
        if device not in self._tables:
            self._tables[device] = profiling.upload(torch.from_numpy(adam_factors()), device)
        return self._tables[device]

    def init(self, params: dict[str, torch.Tensor], out: Optional[OptState] = None) -> OptState:
        """A fresh state for `params`; with `out`, `out` reset to it in place
        (zero moments and count), so that CUDA graphs captured on its
        tensors stay valid."""
        if out is not None:
            out.count.zero_()
            for t in (*out.mu.values(), *out.nu.values()):
                t.zero_()
            return out
        device = next(iter(params.values())).device
        zeros = lambda: {k: torch.zeros_like(p, memory_format=torch.contiguous_format)
                         for k, p in params.items()}
        if self.optimizer_type == "Adam":
            self.table(device)
            return OptState(count=_count0(device), mu=zeros(), nu=zeros())
        if self.optimizer_type == "RMSprop":
            return OptState(count=_count0(device), nu=zeros())
        return OptState(count=_count0(device))

    def _factors(self, state: OptState) -> torch.Tensor:
        """[2]: the table's row at the state's count, gathered on the
        device; advances the count."""
        table = self.table(state.count.device)
        row = table.index_select(0, state.count.clamp(max=table.shape[0] - 1).reshape(1).long())
        state.count.add_(1)
        return row[0]

    def _clip(self, grads: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        # optax.clip_by_global_norm: the norm over the leaves in key order
        norm = torch.sqrt(sum(torch.sum(grads[k] * grads[k]) for k in sorted(grads)))
        return {k: torch.where(norm < self.clip_grad_norm, g, (g / norm) * self.clip_grad_norm)
                for k, g in grads.items()}

    def step(self, params: dict[str, torch.Tensor], grads: dict[str, torch.Tensor],
             state: OptState) -> None:
        """One update of `params` and `state`, in place, at the state's
        count (`apply`)."""
        self.apply(params, grads, state)

    @torch.no_grad()
    def apply(self, params: dict[str, torch.Tensor], grads: dict[str, torch.Tensor],
              state: OptState, bc=None) -> None:
        """One update of `params` and `state`, in place, with no host read.
        Adam takes its bias correction from the table at the state's count,
        which it advances (RMSprop and SGD keep the count); `bc`, two host
        floats or a [2] float32 tensor, gives the factors instead and leaves
        the count."""
        if self.clip_grad_norm and self.clip_grad_norm > 0:
            grads = self._clip(grads)
        lr = self.lr
        if self.optimizer_type == "Adam":
            if bc is None:
                bc = self._factors(state)
            for k, p in params.items():
                g, mu, nu = grads[k], state.mu[k], state.nu[k]
                mu.copy_((1 - ADAM_B1) * g + ADAM_B1 * mu)
                nu.copy_((1 - ADAM_B2) * (g * g) + ADAM_B2 * nu)
                p.add_((mu * bc[0]) / (torch.sqrt(nu * bc[1]) + ADAM_EPS) * -lr)
        elif self.optimizer_type == "RMSprop":
            for k, p in params.items():
                g, nu = grads[k], state.nu[k]
                nu.copy_((1 - RMS_DECAY) * (g * g) + RMS_DECAY * nu)
                p.add_(torch.rsqrt(nu + RMS_EPS) * g * -lr)
        else:
            for k, p in params.items():
                p.add_(grads[k] * -lr)
