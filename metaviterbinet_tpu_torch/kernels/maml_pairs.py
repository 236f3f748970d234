"""Fused MAML pairs of ViterbiNet for Hopper (K7).

`maml_pairs_viterbinet` (csrc/maml_pairs.cu) replaces no Pallas kernel: the
JAX package runs a meta iteration's pairs as plain `jax.grad` through
`jax.grad` under `lax.cond` in a scan (its train/meta.py::make_maml_step and
the engine's `meta_adapt`). The port ran them the same way, through
autograd (train/meta.py::maml_pair_step), each pair about 243 small kernels
under an IF node of its own, and a by-word meta run spent nine tenths of
its device time there (PERF.md). K7 runs a chunk of pairs in ONE launch of
a cluster of CLUSTER_SIZE thread blocks, K6's layout (kernels/
online_sgd.py, csrc/viterbinet_cluster.cuh): for each pair i whose `take[i]` holds, in order,
  1. the support's CE over its trellis states and its gradient g_s at theta;
  2. theta' = theta - meta_lr * g_s;
  3. the query's CE and its gradient g_q at theta' (the CE added to `loss`);
  4. second order: the meta-gradient g_q - meta_lr * H_s g_q, the support's
     Hessian times g_q by a forward-over-reverse pass at theta over step 1's
     activations (sigmoid's second derivative included, relu's zero);
     first order: g_q;
  5. one Adam step of theta on that gradient, the bias correction the row
     of train/optim.py's factors table at the state's count, which it
     advances.
A pair whose `take[i]` is false changes nothing, the count included.

The wrapper updates the params, the moments, the count and `loss` IN PLACE,
on the card through the kernel (no host read: a CUDA graph captures it,
online/engine.py under the meta slot's IF node) and on the CPU through
`maml_pairs_viterbinet_plain`, the kernel's arithmetic in PyTorch: the
hand-written backward of kernels/online_sgd.py's plain version, the same
backward differentiated along g_q for the Hessian-vector product, and
train/optim.py's Adam expression op for op. tests/test_torch_maml_kernel.py
holds it to autograd's pair (train/meta.py::maml_pair_step) and to the JAX
package's pair loop.
"""
from __future__ import annotations

import numpy as np
import torch

from metaviterbinet_tpu_torch.kernels.native import (
    F32, INT, PTR, check_f32, counted, launched, load, route)
from metaviterbinet_tpu_torch.kernels.online_sgd import (
    CLUSTER_SIZE, MAX_SMEM_BYTES, align4, check_network, n_params)
from metaviterbinet_tpu_torch.models.viterbinet import HIDDEN1, PARAM_NAMES
from metaviterbinet_tpu_torch.train.optim import ADAM_B1, ADAM_B2, ADAM_EPS, OptState

# floats of one column's activations (csrc/maml_pairs.cu::Smem): the
# support's, kept for the Hessian-vector product (h1 and dh1 [100], h2 and
# dz2 [52], then the softmax and dlogits [S + 1]), and one of work, which the
# query's and then the product's own take in turn (h1 or R h1 and dh1 [100],
# h2 or R h2 and dz2 or R dz2 [52], then dlogits or R dlogits [S + 1])
_COLUMN = 2 * HIDDEN1 + 2 * 52

# the argument types of csrc/maml_pairs.cu's C function
MAML_PAIRS_ABI = (PTR,) * 26 + (INT,) * 6 + (F32,) * 7 + (PTR,)


def smem_bytes(n_support: int, n_query: int, S: int) -> int:
    """Shared memory of one CTA of the cluster (csrc/maml_pairs.cu::Smem):
    theta, theta', the direction g_q and the partial gradient (each padded
    to a multiple of 4, the last with 4 floats more for the query's CE), the
    samples and labels of ceil(n / CLUSTER_SIZE) columns of the support and
    of the query, and those columns' activations (each [S + 1] group padded
    to a multiple of 4)."""
    cs = -(-n_support // CLUSTER_SIZE)
    cw = max(cs, -(-n_query // CLUSTER_SIZE))
    return 4 * (4 * align4(n_params(S)) + 4 + 4 * align4(cw) + cs * _COLUMN
                + 2 * align4(cs * (S + 1)) + cw * _COLUMN + align4(cw * (S + 1)))


def _columns(p: dict[str, torch.Tensor]) -> tuple[torch.Tensor, ...]:
    """The six tensors as [out, in] matrices and [out, 1] columns."""
    return tuple(p[k].reshape(-1, 1) if k[0] == "b" else p[k] for k in PARAM_NAMES)


def _forward_backward(theta, y: torch.Tensor, onehot: torch.Tensor, n: int):
    """CE over the states of the columns y [1, n] (onehot [S, n]) at theta,
    mean over n: the gradient (six tensors in _columns' shapes), the
    activations the Hessian-vector product reuses and the CE."""
    w1, b1, w2, b2, w3, b3 = theta
    h1 = torch.sigmoid(w1 * y + b1)                            # [100, n]
    h2 = torch.relu(w2 @ h1 + b2)                              # [50, n]
    logits = w3 @ h2 + b3                                      # [S, n]
    mx = logits.amax(dim=0, keepdim=True)
    e = torch.exp(logits - mx)
    total = e.sum(dim=0, keepdim=True)
    prob = e / total
    ce = ((mx + torch.log(total)) - (logits * onehot).sum(dim=0, keepdim=True)).sum() / n
    dl = (prob - onehot) / n
    dz2 = torch.where(h2 > 0.0, w3.T @ dl, 0.0)
    dh1 = w2.T @ dz2
    dz1 = dh1 * (h1 * (1.0 - h1))
    grads = ((dz1 * y).sum(dim=1, keepdim=True), dz1.sum(dim=1, keepdim=True),
             dz2 @ h1.T, dz2.sum(dim=1, keepdim=True), dl @ h2.T, dl.sum(dim=1, keepdim=True))
    return grads, (h1, h2, prob, dl, dz2, dh1), ce


def _hessian_vector(theta, v, y: torch.Tensor, act, n: int):
    """The support's Hessian at theta times the direction v (six tensors),
    forward over reverse through _forward_backward's activations: R{x} is
    x's derivative along v. relu's mask is fixed (its second derivative is
    zero); sigmoid's enters as R{h1 (1 - h1)} = (1 - 2 h1) R{h1}."""
    _, _, w2, _, w3, _ = theta
    vw1, vb1, vw2, vb2, vw3, vb3 = v
    h1, h2, prob, dl, dz2, dh1 = act
    live = h2 > 0.0
    r_h1 = h1 * (1.0 - h1) * (vw1 * y + vb1)
    r_h2 = torch.where(live, vw2 @ h1 + w2 @ r_h1 + vb2, 0.0)
    r_logits = vw3 @ h2 + w3 @ r_h2 + vb3
    r_dl = prob * (r_logits - (prob * r_logits).sum(dim=0, keepdim=True)) / n
    r_dz2 = torch.where(live, vw3.T @ dl + w3.T @ r_dl, 0.0)
    r_dz1 = (vw2.T @ dz2 + w2.T @ r_dz2) * (h1 * (1.0 - h1)) + dh1 * (r_h1 * (1.0 - 2.0 * h1))
    return ((r_dz1 * y).sum(dim=1, keepdim=True), r_dz1.sum(dim=1, keepdim=True),
            r_dz2 @ h1.T + dz2 @ r_h1.T, r_dz2.sum(dim=1, keepdim=True),
            r_dl @ h2.T + dl @ r_h2.T, r_dl.sum(dim=1, keepdim=True))


@torch.no_grad()
def maml_pairs_viterbinet_plain(params: dict[str, torch.Tensor], opt_state: OptState,
                                table: torch.Tensor, s_rx: torch.Tensor, s_states: torch.Tensor,
                                q_rx: torch.Tensor, q_states: torch.Tensor, take: torch.Tensor,
                                loss: torch.Tensor, meta_lr: float, lr: float,
                                second_order: bool) -> None:
    """Plain PyTorch version of the kernel, in the params' dtype; updates
    params, opt_state and loss in place (it reads take and the count to the
    host: CPU tensors)."""
    S = params["w3"].shape[0]
    dtype = params["w3"].dtype
    states = torch.arange(S, device=s_rx.device)[:, None]
    theta = [t.clone() for t in _columns(params)]
    mu = [t.clone() for t in _columns(opt_state.mu)]
    nu = [t.clone() for t in _columns(opt_state.nu)]
    factors = table.to(dtype)
    count = int(opt_state.count)
    for i in np.flatnonzero(take.cpu().numpy()):
        ys, yq = s_rx[i][None].to(dtype), q_rx[i][None].to(dtype)
        g_s, act, _ = _forward_backward(theta, ys, (states == s_states[i][None]).to(dtype),
                                        ys.shape[1])
        adapted = [p - meta_lr * g for p, g in zip(theta, g_s)]
        g_q, _, ce = _forward_backward(adapted, yq, (states == q_states[i][None]).to(dtype),
                                       yq.shape[1])
        loss.add_(ce.to(loss.dtype))
        grads = g_q
        if second_order:
            hv = _hessian_vector(theta, g_q, ys, act, ys.shape[1])
            grads = [g - meta_lr * h for g, h in zip(g_q, hv)]
        # train/optim.py's Adam at the count, op for op
        bc = factors[min(count, factors.shape[0] - 1)]
        count += 1
        for k, g in enumerate(grads):
            mu[k] = (1 - ADAM_B1) * g + ADAM_B1 * mu[k]
            nu[k] = (1 - ADAM_B2) * (g * g) + ADAM_B2 * nu[k]
            theta[k] = theta[k] + (mu[k] * bc[0]) / (torch.sqrt(nu[k] * bc[1]) + ADAM_EPS) * -lr
    for k, name in enumerate(PARAM_NAMES):
        params[name].copy_(theta[k].reshape(params[name].shape))
        opt_state.mu[name].copy_(mu[k].reshape(params[name].shape))
        opt_state.nu[name].copy_(nu[k].reshape(params[name].shape))
    opt_state.count.fill_(count)


def _check(params, opt_state, table, s_rx, s_states, q_rx, q_states, take, loss) -> int:
    """Validate the arguments; returns S."""
    name = "maml_pairs_viterbinet"
    device = s_rx.device
    if s_rx.dim() != 2 or q_rx.dim() != 2 or q_rx.shape[0] != s_rx.shape[0]:
        raise ValueError(f"{name}: support rows [chunk, n] and query rows [chunk, n'] expected, "
                         f"got {tuple(s_rx.shape)} and {tuple(q_rx.shape)}")
    chunk = s_rx.shape[0]
    for rx, states in ((s_rx, s_states), (q_rx, q_states)):
        if states.dtype != torch.int32 or states.shape != rx.shape or not states.is_contiguous():
            raise ValueError(f"{name}: labels must be contiguous int32 of their rows' shape "
                             f"{tuple(rx.shape)}")
        if rx.device != device or states.device != device or not rx.is_contiguous():
            raise ValueError(f"{name}: rows and labels must be contiguous on {device}")
    if take.dtype != torch.bool or take.shape != (chunk,) or take.device != device:
        raise ValueError(f"{name}: take must be a [{chunk}] bool tensor on {device}")
    if loss.dim() != 0 or loss.device != device or table.device != device:
        raise ValueError(f"{name}: loss (0-d) and the factors table must lie on {device}")
    if table.dim() != 2 or table.shape[1] != 2 or table.dtype != torch.float32:
        raise ValueError(f"{name}: the factors table must be [n, 2] float32")
    return check_network(name, params, opt_state, device)


@counted
def maml_pairs_viterbinet(params: dict[str, torch.Tensor], opt_state: OptState,
                          table: torch.Tensor, s_rx: torch.Tensor, s_states: torch.Tensor,
                          q_rx: torch.Tensor, q_states: torch.Tensor, take: torch.Tensor,
                          loss: torch.Tensor, meta_lr: float, lr: float,
                          second_order: bool) -> None:
    """Run a chunk of MAML pairs, pair i on support s_rx[i] [n] (its
    window's words back to back) with labels s_states[i], and query q_rx[i]
    [T] with q_states[i], where take[i] holds, in order.

    params: ViterbiNet's parameter dict (models/viterbinet.py::param_dict);
    opt_state: its Adam state (train/optim.py::OptState, the 0-d int32 count
    on the rows' device); table: Optimizer.table's Adam factors [n, 2];
    labels int32 trellis states (ops/trellis.py::calculate_states); take
    [chunk] bool; loss 0-d f32, to which each pair's query CE is added.
    Updates params, the moments, the count and loss in place, with no host
    read."""
    name = "maml_pairs_viterbinet"
    S = _check(params, opt_state, table, s_rx, s_states, q_rx, q_states, take, loss)
    if not route(name, s_rx):
        maml_pairs_viterbinet_plain(params, opt_state, table, s_rx, s_states, q_rx, q_states,
                                    take, loss, meta_lr, lr, second_order)
        return
    for t in (s_rx, q_rx, loss, *params.values(), *opt_state.mu.values(),
              *opt_state.nu.values()):
        check_f32(name, t, t.dim(), s_rx.device)
    chunk, n_s = s_rx.shape
    n_q = q_rx.shape[1]
    if smem_bytes(n_s, n_q, S) > MAX_SMEM_BYTES:
        raise ValueError(f"{name}: {n_s} support and {n_q} query symbols need "
                         f"{smem_bytes(n_s, n_q, S)} bytes of shared memory per CTA of a "
                         f"{CLUSTER_SIZE}-CTA cluster, more than a CTA has ({MAX_SMEM_BYTES})")
    ptrs = [t.data_ptr() for group in (params, opt_state.mu, opt_state.nu)
            for t in (group[k] for k in PARAM_NAMES)]
    with torch.cuda.device(s_rx.device):
        rc = load("maml_pairs", MAML_PAIRS_ABI)(
            s_rx.data_ptr(), s_states.data_ptr(), q_rx.data_ptr(), q_states.data_ptr(),
            take.data_ptr(), *ptrs, opt_state.count.data_ptr(), table.data_ptr(),
            loss.data_ptr(), chunk, n_s, n_q, S, table.shape[0], int(second_order),
            meta_lr, lr, ADAM_B1, ADAM_B2, 1 - ADAM_B1, 1 - ADAM_B2, ADAM_EPS,
            torch.cuda.current_stream(s_rx.device).cuda_stream)
    launched(maml_pairs_viterbinet, rc)
