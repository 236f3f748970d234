"""ViterbiNet: per-symbol DNN branch metrics plugged into the Viterbi ACS.

Architecture parity with reference detectors/VNET/vnet_detector.py:27-33:
1 -> 100 sigmoid -> 50 relu -> n_states. Weights are kept in the [out, in]
layout of both the reference and the JAX package (nn.Linear's own layout).

The module holds the parameters; `param_dict` names them as the JAX package
does (w1 [100, 1], b1, w2 [50, 100], b2, w3 [S, 50], b3), and `logits` is the
forward as a function of such a dict, so that training can update the
parameters in place and MAML can differentiate through an updated copy.
"""
from __future__ import annotations

import torch
from torch import nn

from metaviterbinet_tpu_torch.device import resolve_device

HIDDEN1 = 100
HIDDEN2 = 50
PARAM_NAMES = ("w1", "b1", "w2", "b2", "w3", "b3")
# device activities of one training step of the ViterbiNet (loss, gradient,
# Adam) under torch.profiler, chip_smoke.py phase 7c on an NVIDIA H100 80GB
# HBM3: the nodes a captured step adds to a graph (online/graphs.py::chunk_steps)
STEP_NODES = 119
# the same of one second-order MAML pair step (inner gradient, query loss
# through the adapted params, outer gradient, Adam): the nodes a captured
# pair adds to a graph (train/meta.py::masked_pairs)
MAML_NODES = 272


class ViterbiNet(nn.Module):
    def __init__(self, n_states: int, device: str | torch.device = "cuda"):
        super().__init__()
        device = resolve_device(device)
        self.fc1 = nn.Linear(1, HIDDEN1, device=device)
        self.fc2 = nn.Linear(HIDDEN1, HIDDEN2, device=device)
        self.fc3 = nn.Linear(HIDDEN2, n_states, device=device)

    @property
    def n_states(self) -> int:
        return self.fc3.out_features

    def forward(self, y: torch.Tensor) -> torch.Tensor:
        """Per-symbol state logits: y [words, T] -> [words, T, n_states] f32."""
        return logits(param_dict(self), y)


def param_dict(model: ViterbiNet) -> dict[str, torch.Tensor]:
    """The model's own parameter tensors under the JAX package's names."""
    return {"w1": model.fc1.weight, "b1": model.fc1.bias, "w2": model.fc2.weight,
            "b2": model.fc2.bias, "w3": model.fc3.weight, "b3": model.fc3.bias}


def logits(params: dict[str, torch.Tensor], y: torch.Tensor,
           compute_dtype: torch.dtype | None = None) -> torch.Tensor:
    """The forward over a parameter dict: y [words, T] -> [words, T, S] f32,
    each product followed by its bias add, as models/viterbinet.py::score of
    the JAX package computes it. With `compute_dtype` (torch.bfloat16) the
    params and y are cast to it and the products and activations run in it,
    and the logits are returned as f32; the casts are differentiable, so
    training and MAML take gradients through it."""
    x = y.reshape(-1, 1)
    p = params
    if compute_dtype is None:
        x = torch.sigmoid(x @ p["w1"].T + p["b1"])
    else:
        x = x.to(compute_dtype)
        p = {k: v.to(compute_dtype) for k, v in params.items()}
        # jax.nn.sigmoid as XLA lowers it, each op rounded to the dtype
        # (torch.sigmoid would round once)
        x = 1.0 / (1.0 + torch.exp(-(x @ p["w1"].T + p["b1"])))
    x = torch.relu(x @ p["w2"].T + p["b2"])
    out = (x @ p["w3"].T + p["b3"]).to(torch.float32)
    return out.reshape(y.shape[0], y.shape[1], -1)


def init_params(n_states: int, generator: torch.Generator,
                device: str | torch.device = "cuda") -> ViterbiNet:
    """A ViterbiNet with every weight and bias drawn from U(-sqrt(k), sqrt(k)),
    k = 1/in_features (the torch.nn.Linear family), from `generator`."""
    model = ViterbiNet(n_states, device=device)
    with torch.no_grad():
        for layer in (model.fc1, model.fc2, model.fc3):
            bound = (1.0 / layer.in_features) ** 0.5
            for p in (layer.weight, layer.bias):
                p.copy_(torch.rand(p.shape, generator=generator, device=device)
                        * (2 * bound) - bound)
    return model


def from_params(params: dict, device: str | torch.device = "cuda") -> ViterbiNet:
    """A ViterbiNet holding a copy of `params` (tensors or arrays under the
    JAX package's names, in its layout)."""
    model = ViterbiNet(int(params["w3"].shape[0]), device=device)
    with torch.no_grad():
        for k, p in param_dict(model).items():
            src = torch.as_tensor(params[k], dtype=torch.float32)
            if src.shape != p.shape:
                raise ValueError(f"{k}: shape {tuple(src.shape)}, expected {tuple(p.shape)}")
            p.copy_(src)
    return model


def score(model: ViterbiNet, y: torch.Tensor) -> torch.Tensor:
    return model(y)

