"""Carry ViterbiNet and LSTM parameters and Adam state across from the JAX
package.

The JAX parameter dicts keep nn.Linear's [out, in] layout (ViterbiNet: w1
[100, 1], b1 [100], w2 [50, 100], b2 [50], w3 [S, 50], b3 [S]) and nn.LSTM's
layout and gate order (w_ih{l}, w_hh{l}, b_ih{l}, b_hh{l}, w_fc, b_fc), so
the transplant is a plain copy (as scripts/crossload_same_words.py:66-89
does for the reference); the family is told by the keys. An optax Adam state
carries over as its two moment dicts and its step count. Everything goes
through numpy arrays, so this module needs no JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from metaviterbinet_tpu_torch.device import resolve_device
from metaviterbinet_tpu_torch.models import lstm, viterbinet
from metaviterbinet_tpu_torch.train.optim import OptState


def params_from_jax(np_params: dict[str, np.ndarray], device: str | torch.device = "cuda"):
    """A ViterbiNet or a WindowedLSTM holding the JAX params."""
    family = lstm if "w_ih0" in np_params else viterbinet
    # np.array copies: arrays from JAX are read-only
    return family.from_params({k: np.array(v, dtype=np.float32) for k, v in np_params.items()},
                              device)


def params_to_numpy(model) -> dict[str, np.ndarray]:
    """The model's params under the JAX package's names, as numpy arrays."""
    family = lstm if isinstance(model, lstm.WindowedLSTM) else viterbinet
    return {k: v.detach().cpu().numpy().copy() for k, v in family.param_dict(model).items()}


def adam_state_from_jax(mu: dict[str, np.ndarray], nu: dict[str, np.ndarray], count,
                        device: str | torch.device = "cuda") -> OptState:
    """An optax ScaleByAdamState's moments and count as the port's OptState
    (its count a 0-d int32 tensor on `device`)."""
    device = resolve_device(device)
    to = lambda d: {k: torch.from_numpy(np.array(v, dtype=np.float32)).to(device)
                    for k, v in d.items()}
    return OptState(count=torch.tensor(int(count), dtype=torch.int32, device=device),
                    mu=to(mu), nu=to(nu))
