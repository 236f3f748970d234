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
through `online_adapt_viterbinet_plain`. The count is a 0-d int32 tensor on
the device (train/optim.py::OptState), as optax's is, and the TPU kernel
raises b1 and b2 to it on the device; here the wrapper gathers b1^count and
b2^count from a float32 table on the card (`power_table`, built with
`_start_powers`' expression, so the bits are the host's) into a [2] row the
kernel reads, and advances the count with a device op after the launch. No
host read: a CUDA graph can capture the call (online/engine.py captures it
under the gate's conditional node). The plain version is the kernel's
own arithmetic in PyTorch: the hand-written backward of the TPU kernel
(softmax - onehot) / T through relu and sigmoid, and Adam with the bias
correction from running powers b1^t, b2^t (optax computes b1^t directly,
so the two differ by rounding; tests/test_torch_kernels.py holds the plain
version to the JAX kernel and to autograd + train/optim.py's Adam).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from metaviterbinet_tpu_torch.kernels.acs import SUPPORTED_STATES
from metaviterbinet_tpu_torch.kernels.native import (
    F32, INT, PTR, check_f32, counted, launched, load, route)
from metaviterbinet_tpu_torch.models.viterbinet import HIDDEN1, HIDDEN2, PARAM_NAMES
from metaviterbinet_tpu_torch.utils import profiling

# The cluster layout that K6 and K7 (kernels/maml_pairs.py) share, as
# csrc/viterbinet_cluster.cuh declares it for both kernels.
MAX_SMEM_BYTES = 232448  # shared memory one CTA may use on an H100
# CTAs of the kernels' thread-block cluster, fixed in
# csrc/viterbinet_cluster.cuh (kCluster): 16, the largest an H100 allows,
# measured faster than the portable 8 (PERF.md)
CLUSTER_SIZE = 16

# the argument types of csrc/online_adapt.cu's C function
ONLINE_ADAPT_ABI = (PTR,) * 20 + (INT,) * 3 + (F32,) * 7 + (PTR,) * 2


def n_params(S: int) -> int:
    """The parameters of a 1-100-50-S network."""
    return HIDDEN1 * 2 + HIDDEN2 * (HIDDEN1 + 1) + S * (HIDDEN2 + 1)


def align4(n: int) -> int:
    return (n + 3) // 4 * 4


def check_network(name: str, params: dict[str, torch.Tensor], opt_state,
                  device: torch.device) -> int:
    """The state K6 and K7 update in place: a 1-100-50-S network's
    parameters (S in SUPPORTED_STATES) and their Adam moments, each
    contiguous in its tensor's shape on `device`, and the step count, a 0-d
    int32 tensor there. Returns S."""
    S = params["w3"].shape[0]
    shapes = {"w1": (HIDDEN1, 1), "b1": (HIDDEN1,), "w2": (HIDDEN2, HIDDEN1),
              "b2": (HIDDEN2,), "w3": (S, HIDDEN2), "b3": (S,)}
    if S not in SUPPORTED_STATES or any(tuple(params[k].shape) != shapes[k] for k in PARAM_NAMES):
        raise ValueError(f"{name}: expected a 1-100-50-S network with S in {SUPPORTED_STATES}")
    for k in PARAM_NAMES:
        for t in (params[k], opt_state.mu[k], opt_state.nu[k]):
            if t.shape != shapes[k] or t.device != device or not t.is_contiguous():
                raise ValueError(f"{name}: {k} or its moments not contiguous {shapes[k]} on "
                                 f"{device}")
    count = opt_state.count
    if count.device != device or count.dtype != torch.int32 or count.dim() != 0:
        raise ValueError(f"{name}: the count must be a 0-d int32 tensor on {device}")
    return S


def smem_bytes(T: int, S: int) -> int:
    """Shared memory of one CTA of the cluster, which holds
    ceil(T / CLUSTER_SIZE) of the word's columns (csrc/online_adapt.cu::Smem):
    the parameters and their partial gradient (each padded to a multiple of
    4), y and the labels, and per column h1 [100], h2 and dz2 [52 each] and
    the logits [S + 1]."""
    cols = -(-T // CLUSTER_SIZE)
    return 4 * (2 * align4(n_params(S)) + 2 * align4(cols)
                + cols * (HIDDEN1 + 2 * 52 + S + 1))


def _start_powers(b1: float, b2: float, count: int) -> tuple[np.float32, np.float32]:
    """b1^count and b2^count in float32, the running powers' start."""
    return np.float32(b1) ** np.float32(count), np.float32(b2) ** np.float32(count)


@functools.lru_cache(maxsize=None)
def start_powers_table(b1: float, b2: float) -> np.ndarray:
    """[n, 2] float32: row c is _start_powers(b1, b2, c), for every count up
    to the first at which both powers are 0.0f, as they are at every later
    count (103,923 rows for Adam's b1 and b2). Built entry by entry:
    numpy's vectorised float32 power rounds some entries apart from the
    scalar one."""
    rows = []
    while not rows or rows[-1] != (0.0, 0.0):
        rows.append(_start_powers(b1, b2, len(rows)))
    return np.array(rows, dtype=np.float32)


_power_tables: dict[tuple, torch.Tensor] = {}


def power_table(b1: float, b2: float, device: torch.device) -> torch.Tensor:
    """start_powers_table(b1, b2) on `device`, uploaded at the first call
    there: make it before a CUDA graph captures the wrapper."""
    key = (b1, b2, device)
    if key not in _power_tables:
        _power_tables[key] = profiling.upload(torch.from_numpy(start_powers_table(b1, b2)), device)
    return _power_tables[key]


def _check(params, opt_state, y, states) -> int:
    """Validate the arguments; returns S."""
    name = "online_adapt_viterbinet"
    check_f32(name, y, 1, y.device)
    T = y.shape[0]
    if states.dtype != torch.int32 or states.shape != (T,) or not states.is_contiguous():
        raise ValueError(f"{name}: states must be a contiguous int32 tensor of len(y) = {T}")
    if states.device != y.device:
        raise ValueError(f"{name}: states on {states.device}, y on {y.device}")
    S = check_network(name, params, opt_state, y.device)
    for t in (*params.values(), *opt_state.mu.values(), *opt_state.nu.values()):
        check_f32(name, t, t.dim(), y.device)
    return S


@torch.no_grad()
def online_adapt_viterbinet_plain(params: dict[str, torch.Tensor], opt_state, y: torch.Tensor,
                                  states: torch.Tensor, n_iters: int, lr: float,
                                  b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> None:
    """Plain PyTorch version of the kernel; updates params, opt_state.mu,
    opt_state.nu and opt_state.count in place (it reads the count to the
    host: CPU tensors)."""
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
    pow1, pow2 = _start_powers(b1, b2, int(opt_state.count))
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
    opt_state.count.add_(n_iters)


@counted
def online_adapt_viterbinet(params: dict[str, torch.Tensor], opt_state, y: torch.Tensor,
                            states: torch.Tensor, n_iters: int, lr: float, b1: float = 0.9,
                            b2: float = 0.999, eps: float = 1e-8) -> None:
    """Run `n_iters` fused Adam steps of CE over states on one word.

    params: ViterbiNet's parameter dict (models/viterbinet.py::param_dict);
    opt_state: its Adam state (train/optim.py::OptState: mu, nu and the
    0-d int32 count on y's device); y [T] f32 samples; states [T] int32
    trellis-state labels. Updates params, the moments and the count in
    place, with no host read."""
    name = "online_adapt_viterbinet"
    S = _check(params, opt_state, y, states)
    T = y.shape[0]
    if not route(name, y):
        online_adapt_viterbinet_plain(params, opt_state, y, states, n_iters, lr, b1, b2, eps)
        return
    if smem_bytes(T, S) > MAX_SMEM_BYTES:
        raise ValueError(f"{name}: T={T} needs {smem_bytes(T, S)} bytes of shared memory per "
                         f"CTA of a {CLUSTER_SIZE}-CTA cluster, more than a CTA has "
                         f"({MAX_SMEM_BYTES})")
    count = opt_state.count
    table = power_table(b1, b2, y.device)
    # b1^count and b2^count, gathered on the device: the kernel reads them
    powers = table.index_select(0, count.clamp(max=table.shape[0] - 1).reshape(1).long())
    ptrs = [t.data_ptr() for group in (params, opt_state.mu, opt_state.nu)
            for t in (group[k] for k in PARAM_NAMES)]
    with torch.cuda.device(y.device):
        rc = load("online_adapt", ONLINE_ADAPT_ABI)(
            y.data_ptr(), states.data_ptr(), *ptrs, T, S, n_iters,
            lr, b1, b2, 1.0 - b1, 1.0 - b2, eps, 1.0 / T, powers.data_ptr(),
            torch.cuda.current_stream(y.device).cuda_stream)
    launched(online_adapt_viterbinet, rc)
    count.add_(n_iters)
