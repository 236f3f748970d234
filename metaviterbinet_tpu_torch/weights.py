"""Carry ViterbiNet parameters and Adam state across from the JAX package.

The JAX parameter dict (w1 [100,1], b1 [100], w2 [50,100], b2 [50],
w3 [S,50], b3 [S]) has the same [out, in] layout as nn.Linear, so the
transplant is a plain copy (as scripts/crossload_same_words.py:80-89 does
for the reference); an optax Adam state carries over as its two moment
dicts and its step count. Everything goes through numpy arrays, so this
module needs no JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from metaviterbinet_tpu_torch.device import resolve_device
from metaviterbinet_tpu_torch.models.viterbinet import ViterbiNet, from_params, param_dict
from metaviterbinet_tpu_torch.train.optim import OptState


def params_from_jax(np_params: dict[str, np.ndarray],
                    device: str | torch.device = "cuda") -> ViterbiNet:
    # np.array copies: arrays from JAX are read-only
    return from_params({k: np.array(v, dtype=np.float32) for k, v in np_params.items()}, device)


def params_to_numpy(model: ViterbiNet) -> dict[str, np.ndarray]:
    """The model's params under the JAX package's names, as numpy arrays."""
    return {k: v.detach().cpu().numpy().copy() for k, v in param_dict(model).items()}


def adam_state_from_jax(mu: dict[str, np.ndarray], nu: dict[str, np.ndarray], count,
                        device: str | torch.device = "cuda") -> OptState:
    """An optax ScaleByAdamState's moments and count as the port's OptState."""
    device = resolve_device(device)
    to = lambda d: {k: torch.from_numpy(np.array(v, dtype=np.float32)).to(device)
                    for k, v in d.items()}
    return OptState(count=int(count), mu=to(mu), nu=to(nu))
