"""Fused online adaptation of ViterbiNet for Hopper.

`online_adapt_viterbinet` (csrc/online_adapt.cu) replaces the Pallas kernel
metaviterbinet_tpu/kernels/online_sgd.py::online_adapt_viterbinet: n Adam
steps of cross-entropy over the trellis states of one word, all T symbols,
mean reduction, in one launch of a cluster of CLUSTER_SIZE thread blocks
that split the word's symbols between them. It is the self-supervised step
of the online engine for the meta loss (online/engine.py), which otherwise
costs n eager forward + backward + Adam steps of dozens of small launches
each.

The wrapper updates the parameters, the Adam moments and the step count of
its arguments IN PLACE, on the card through the kernel and on the CPU
through `online_adapt_viterbinet_plain`. The plain version is the kernel's
own arithmetic in PyTorch: the hand-written backward of the TPU kernel
(softmax - onehot) / T through relu and sigmoid, and Adam with the bias
correction from running powers b1^t, b2^t (optax computes b1^t directly,
so the two differ by rounding; tests/test_torch_kernels.py holds the plain
version to the JAX kernel and to autograd + train/optim.py's Adam).
"""
from __future__ import annotations

import numpy as np
import torch

from metaviterbinet_tpu_torch.kernels.acs import (
    SUPPORTED_STATES, _check_f32, _check_launch, _library, _route)
from metaviterbinet_tpu_torch.models.viterbinet import HIDDEN1, HIDDEN2, PARAM_NAMES

MAX_SMEM_BYTES = 232448  # shared memory one CTA may use on an H100
# CTAs of the kernel's thread-block cluster, fixed in csrc/online_adapt.cu
# (kCluster): 16, the largest an H100 allows, measured faster than the
# portable 8 (PERF.md)
CLUSTER_SIZE = 16


def _n_params(S: int) -> int:
    return HIDDEN1 * 2 + HIDDEN2 * (HIDDEN1 + 1) + S * (HIDDEN2 + 1)


def _align4(n: int) -> int:
    return (n + 3) // 4 * 4


def smem_bytes(T: int, S: int) -> int:
    """Shared memory of one CTA of the cluster, which holds
    ceil(T / CLUSTER_SIZE) of the word's columns (csrc/online_adapt.cu::Smem):
    the parameters and their partial gradient (each padded to a multiple of
    4), y and the labels, and per column h1 [100], h2 and dz2 [52 each] and
    the logits [S + 1]."""
    cols = -(-T // CLUSTER_SIZE)
    return 4 * (2 * _align4(_n_params(S)) + 2 * _align4(cols)
                + cols * (HIDDEN1 + 2 * 52 + S + 1))


def _start_powers(b1: float, b2: float, count: int) -> tuple[np.float32, np.float32]:
    """b1^count and b2^count in float32, the running powers' start."""
    return np.float32(b1) ** np.float32(count), np.float32(b2) ** np.float32(count)


def _check(params, opt_state, y, states) -> int:
    """Validate the arguments; returns S."""
    name = "online_adapt_viterbinet"
    _check_f32(name, y, 1, y.device)
    T = y.shape[0]
    if states.dtype != torch.int32 or states.shape != (T,) or not states.is_contiguous():
        raise ValueError(f"{name}: states must be a contiguous int32 tensor of len(y) = {T}")
    if states.device != y.device:
        raise ValueError(f"{name}: states on {states.device}, y on {y.device}")
    S = params["w3"].shape[0]
    shapes = {"w1": (HIDDEN1, 1), "b1": (HIDDEN1,), "w2": (HIDDEN2, HIDDEN1),
              "b2": (HIDDEN2,), "w3": (S, HIDDEN2), "b3": (S,)}
    if S not in SUPPORTED_STATES or any(tuple(params[k].shape) != shapes[k] for k in PARAM_NAMES):
        raise ValueError(f"{name}: expected a 1-100-50-S network with S in {SUPPORTED_STATES}")
    for k in PARAM_NAMES:
        for t in (params[k], opt_state.mu[k], opt_state.nu[k]):
            _check_f32(name, t, len(shapes[k]), y.device)
            if t.shape != shapes[k]:
                raise ValueError(f"{name}: {k} moment of shape {tuple(t.shape)}")
    return S


@torch.no_grad()
def online_adapt_viterbinet_plain(params: dict[str, torch.Tensor], opt_state, y: torch.Tensor,
                                  states: torch.Tensor, n_iters: int, lr: float,
                                  b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> None:
    """Plain PyTorch version of the kernel; updates params, opt_state.mu,
    opt_state.nu and opt_state.count in place."""
    T = y.shape[0]
    S = params["w3"].shape[0]
    onehot = (torch.arange(S, device=y.device)[:, None] == states[None, :]).to(torch.float32)
    inv_t = float(np.float32(1.0 / T))
    yr = y.reshape(1, T)
    w1, bb1, w2, bb2, w3, bb3 = (params[k].clone() for k in PARAM_NAMES)
    bb1, bb2, bb3 = bb1.reshape(-1, 1), bb2.reshape(-1, 1), bb3.reshape(-1, 1)
    mu = [opt_state.mu[k].clone().reshape(-1, 1) if k[0] == "b" else opt_state.mu[k].clone()
          for k in PARAM_NAMES]
    nu = [opt_state.nu[k].clone().reshape(-1, 1) if k[0] == "b" else opt_state.nu[k].clone()
          for k in PARAM_NAMES]
    pow1, pow2 = _start_powers(b1, b2, opt_state.count)
    for _ in range(n_iters):
        pow1, pow2 = pow1 * np.float32(b1), pow2 * np.float32(b2)
        c1, c2 = float(np.float32(1.0) - pow1), float(np.float32(1.0) - pow2)
        h1 = torch.sigmoid(w1 * yr + bb1)                  # [100, T]
        z2 = w2 @ h1 + bb2                                 # [50, T]
        h2 = torch.relu(z2)
        logits = w3 @ h2 + bb3                             # [S, T]
        e = torch.exp(logits - logits.amax(dim=0, keepdim=True))
        dlogits = (e / e.sum(dim=0, keepdim=True) - onehot) * inv_t
        dz2 = torch.where(z2 > 0.0, w3.T @ dlogits, 0.0)
        dz1 = (w2.T @ dz2) * h1 * (1.0 - h1)
        grads = ((dz1 * yr).sum(dim=1, keepdim=True), dz1.sum(dim=1, keepdim=True),
                 dz2 @ h1.T, dz2.sum(dim=1, keepdim=True),
                 dlogits @ h2.T, dlogits.sum(dim=1, keepdim=True))
        new = []
        for i, (p, g) in enumerate(zip((w1, bb1, w2, bb2, w3, bb3), grads)):
            mu[i] = b1 * mu[i] + (1.0 - b1) * g
            nu[i] = b2 * nu[i] + (1.0 - b2) * g * g
            new.append(p - lr * (mu[i] / c1) / (torch.sqrt(nu[i] / c2) + eps))
        w1, bb1, w2, bb2, w3, bb3 = new
    for i, (k, p) in enumerate(zip(PARAM_NAMES, (w1, bb1, w2, bb2, w3, bb3))):
        params[k].copy_(p.reshape(params[k].shape))
        opt_state.mu[k].copy_(mu[i].reshape(params[k].shape))
        opt_state.nu[k].copy_(nu[i].reshape(params[k].shape))
    opt_state.count += n_iters


def online_adapt_viterbinet(params: dict[str, torch.Tensor], opt_state, y: torch.Tensor,
                            states: torch.Tensor, n_iters: int, lr: float, b1: float = 0.9,
                            b2: float = 0.999, eps: float = 1e-8) -> None:
    """Run `n_iters` fused Adam steps of CE over states on one word.

    params: ViterbiNet's parameter dict (models/viterbinet.py::param_dict);
    opt_state: its Adam state (train/optim.py::OptState: mu, nu, count);
    y [T] f32 samples; states [T] int32 trellis-state labels. Updates
    params, the moments and the count in place."""
    name = "online_adapt_viterbinet"
    S = _check(params, opt_state, y, states)
    T = y.shape[0]
    if not _route(name, y):
        online_adapt_viterbinet_plain(params, opt_state, y, states, n_iters, lr, b1, b2, eps)
        return
    if smem_bytes(T, S) > MAX_SMEM_BYTES:
        raise ValueError(f"{name}: T={T} needs {smem_bytes(T, S)} bytes of shared memory per "
                         f"CTA of a {CLUSTER_SIZE}-CTA cluster, more than a CTA has "
                         f"({MAX_SMEM_BYTES})")
    pow1, pow2 = _start_powers(b1, b2, opt_state.count)
    lib = _library("online_adapt")
    ptrs = [t.data_ptr() for group in (params, opt_state.mu, opt_state.nu)
            for t in (group[k] for k in PARAM_NAMES)]
    with torch.cuda.device(y.device):
        rc = lib.online_adapt(
            y.data_ptr(), states.data_ptr(), *ptrs, T, S, n_iters,
            lr, b1, b2, 1.0 - b1, 1.0 - b2, eps, 1.0 / T, float(pow1), float(pow2),
            torch.cuda.current_stream(y.device).cuda_stream)
    _check_launch(name, rc)
    opt_state.count += n_iters
    online_adapt_viterbinet.launches += 1


online_adapt_viterbinet.launches = 0
