"""ViterbiNet, written plainly (Shlezinger et al.; the Meta-ViterbiNet
reference's detectors/VNET/vnet_detector.py): per received sample the MLP
1 -> 100 (sigmoid) -> 50 (relu) -> S gives S state logits; the greedy
zero-delay Viterbi recursion over their negation gives the bits.

Params are a dict of tensors under the names w1 [100, 1], b1, w2 [50, 100],
b2, w3 [S, 50], b3, in nn.Linear's [out, in] layout. Everything here is a
function of tensors in their own dtype and device: the benchmark's checks
run it in float64 on the host. With `tf32`, every product, forward and
backward, takes its operands rounded to TF32 (10 mantissa bits, to
nearest) and adds in float32, as TF32 tensor cores do: the precision the
checks measure the program's against.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

HIDDEN = (100, 50)


def shapes(n_states: int) -> dict[str, tuple[int, ...]]:
    h1, h2 = HIDDEN
    return {"w1": (h1, 1), "b1": (h1,), "w2": (h2, h1), "b2": (h2,), "w3": (n_states, h2),
            "b3": (n_states,)}


def unflatten(flat: torch.Tensor, n_states: int) -> dict[str, torch.Tensor]:
    """The leaves as views of one flat vector, in NAMES order."""
    out, at = {}, 0
    for k, s in shapes(n_states).items():
        size = int(np.prod(s))
        out[k] = flat[at:at + size].view(s)
        at += size
    return out


def init(n_states: int, generator: torch.Generator,
         device: torch.device) -> dict[str, torch.Tensor]:
    """U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for every leaf (nn.Linear's law),
    from one draw on the device."""
    fan_in = {"w1": 1, "b1": 1, "w2": HIDDEN[0], "b2": HIDDEN[0], "w3": HIDDEN[1], "b3": HIDDEN[1]}
    bounds = torch.cat([torch.full((int(np.prod(s)),), fan_in[k] ** -0.5, device=device)
                        for k, s in shapes(n_states).items()])
    u = torch.rand(bounds.shape, generator=generator, device=device)
    return unflatten((2 * u - 1) * bounds, n_states)


def _tf32(x: torch.Tensor) -> torch.Tensor:
    bits = x.detach().to(torch.float32).contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32).to(x.dtype)


def _through(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32, its gradient passed through unrounded."""
    return x + (_tf32(x) - x.detach())


def product(a: torch.Tensor, b: torch.Tensor, tf32: bool = False) -> torch.Tensor:
    if not tf32:
        return a @ b
    out = _through(a) @ _through(b)
    if out.requires_grad:  # the backward products' incoming gradient, rounded
        out.register_hook(_through)
    return out


def logits(p: dict[str, torch.Tensor], y: torch.Tensor, tf32: bool = False) -> torch.Tensor:
    """y [..., T] -> [..., T, S]."""
    x = y.unsqueeze(-1)
    h1 = torch.sigmoid(product(x, p["w1"].T, tf32) + p["b1"])
    h2 = torch.relu(product(h1, p["w2"].T, tf32) + p["b2"])
    return product(h2, p["w3"].T, tf32) + p["b3"]


def states(bits: torch.Tensor, memory_length: int) -> torch.Tensor:
    """Trellis state of each position of bit words [..., T]: sum_i
    b_(t+i) 2^i, zero past the end; int64."""
    T = bits.shape[-1]
    padded = torch.cat([bits, bits.new_zeros(bits.shape[:-1] + (memory_length,))], dim=-1)
    return sum(padded[..., i:T + i].long() << i for i in range(memory_length))


def loss(p: dict[str, torch.Tensor], y: torch.Tensor, label_bits: torch.Tensor,
         memory_length: int, tf32: bool = False) -> torch.Tensor:
    """Mean cross-entropy of the state logits of words y [..., T] against
    the states of label_bits [..., T]."""
    z = logits(p, y, tf32)
    return F.cross_entropy(z.reshape(-1, z.shape[-1]),
                           states(label_bits, memory_length).reshape(-1))


def viterbi(priors: np.ndarray) -> np.ndarray:
    """Greedy zero-delay Viterbi over branch costs [T, S] (lower is
    likelier): before step t the emitted bit is the low bit of the lowest
    state index of least path metric; then each state s takes the lesser of
    its predecessors 2s mod S and 2s + 1 mod S plus its cost, and the
    metrics are shifted so that their least is 0."""
    T, S = priors.shape
    m = np.zeros(S, dtype=priors.dtype)
    bits = np.empty(T, dtype=np.int64)
    pred = np.arange(S) * 2 % S
    for t in range(T):
        bits[t] = int(np.argmin(m)) & 1
        total = m + priors[t]
        m = np.minimum(total[pred], total[pred + 1])
        m = m - m.min()
    return bits


def detect(p: dict[str, torch.Tensor], y: torch.Tensor, tf32: bool = False) -> np.ndarray:
    """One word y [T] -> its detected bits [T]."""
    with torch.no_grad():
        z = logits(p, y, tf32)
    return viterbi(-z.cpu().numpy())
