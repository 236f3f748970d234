"""Trellis primitives: transition structure, add-compare-select, state labeling.

Semantics of reference python_code/utils/trellis_utils.py:7-46. With n states
the predecessors of state s are (2s) mod n and (2s+1) mod n, so for s < n/2
the pair is (2s, 2s+1) and for s >= n/2 it is the pair of s - n/2:
new_metric = tile(pairwise_min(metric + branch), 2).

These are the plain tensor versions; batch detection on the card runs the
same recursion inside the CUDA kernels of kernels/acs.py.
"""
from __future__ import annotations

import numpy as np
import torch


def transition_table(n_states: int) -> np.ndarray:
    """[n_states, 2] array; row s holds the two predecessor states of s."""
    s = np.arange(n_states)
    return np.stack([(2 * s) % n_states, (2 * s + 1) % n_states], axis=1)


def acs_step(in_prob: torch.Tensor, branch: torch.Tensor) -> torch.Tensor:
    """One add-compare-select stage (min-sum over negative log-likelihoods).

    in_prob: [..., n_states] path metrics entering this stage.
    branch:  [..., n_states] branch metric attached to each predecessor state.
    returns: [..., n_states] updated path metrics.
    """
    n_states = in_prob.shape[-1]
    total = in_prob + branch
    m = total.reshape(*total.shape[:-1], n_states // 2, 2).amin(dim=-1)
    return torch.cat([m, m], dim=-1)


def _first_argmin_lsb(in_prob: torch.Tensor) -> torch.Tensor:
    """LSB of the lowest state index attaining the per-word minimum.

    Exact ties occur (renormalization pins the running min to 0.0); they
    break toward the lowest index, as argmin does in both references."""
    n_states = in_prob.shape[-1]
    iota = torch.arange(n_states, device=in_prob.device)
    first = torch.where(in_prob == in_prob.amin(dim=-1, keepdim=True),
                        iota, n_states).amin(dim=-1)
    return (first % 2).to(in_prob.dtype)


def viterbi_decode_with_metrics(priors: torch.Tensor, in_prob0: torch.Tensor):
    """Greedy zero-delay Viterbi decode from explicit initial metrics.

    priors: [batch, T, n_states] branch metrics; in_prob0: [batch, n_states].
    returns ([batch, T] hard bits, [batch, n_states] final metrics).

    At each step the emitted bit is the LSB of the current argmin state, then
    the ACS stage runs and the metrics are renormalized by their per-word
    min (no traceback, as in the reference va_detector.py:89-97).
    """
    in_prob = in_prob0
    bits = []
    for t in range(priors.shape[1]):
        bits.append(_first_argmin_lsb(in_prob))
        out = acs_step(in_prob, priors[:, t])
        in_prob = out - out.amin(dim=-1, keepdim=True)
    if not bits:
        return priors.new_zeros(priors.shape[:2]), in_prob
    return torch.stack(bits, dim=1), in_prob


def viterbi_decode(priors: torch.Tensor) -> torch.Tensor:
    """Greedy zero-delay Viterbi decode over a batch: [batch, T, S] -> [batch, T]."""
    batch, _, n_states = priors.shape
    in_prob0 = priors.new_zeros((batch, n_states))
    return viterbi_decode_with_metrics(priors, in_prob0)[0]


def viterbi_decode_lowlat(priors: torch.Tensor) -> torch.Tensor:
    """Greedy zero-delay Viterbi decode as a (min,+) parallel prefix:
    [batch, T, S] -> [batch, T] bits, the semantics of `viterbi_decode`.

    Step t is the matrix M_t[p, s] = priors_t[p] where p is a predecessor
    of s, else +inf. Their inclusive (min,+) prefix products C_t = M_1 ..
    M_t take ceil(log2 T) rounds of one batched product each (Hillis-Steele
    doubling), so the sequential depth is log T instead of T. The metrics
    entering step t are m_0 = 0 and m_t = min_p C_t[p, :]; the bit is the
    LSB of the first argmin.

    This is the latency path, for one word or a few in flight: each round
    materialises a [batch, T, S, S, S] float32 product, 16 KiB per word and
    step at S = 16 (2.2 MB at 1 x 136, 668 MB at 300 x 136), and does S^2
    times the work of `viterbi_decode`, which stays the throughput path.

    On integer-valued metrics the bits equal `viterbi_decode`'s. On float
    metrics the products add in another order than the sequential
    recursion, so rare near-ties may resolve the other way."""
    batch, T, n_states = priors.shape
    # the predecessors of s are 2s and 2s + 1 mod S (transition_table), made
    # on the device so that a CUDA graph can capture the whole decode
    s = torch.arange(n_states, device=priors.device)
    p, pred = s[:, None], (2 * s[None, :]) % n_states
    mask = torch.full((n_states, n_states), float("inf"), dtype=priors.dtype,
                      device=priors.device).masked_fill((p == pred) | (p == pred + 1), 0.0)
    prefix = priors[..., None] + mask  # [batch, T, S, S]
    step = 1
    while step < T:
        # prefix[t] <- prefix[t - step] (min,+) prefix[t], the earlier on the left
        a, b = prefix[:, :-step], prefix[:, step:]
        composed = (a[..., :, :, None] + b[..., None, :, :]).amin(dim=-2)
        prefix = torch.cat([prefix[:, :step], composed], dim=1)
        step *= 2
    m = torch.cat([priors.new_zeros((batch, 1, n_states)), prefix[:, :-1].amin(dim=2)], dim=1)
    return _first_argmin_lsb(m)


def calculate_states(memory_length: int, words: torch.Tensor) -> torch.Tensor:
    """Per-time trellis state label of a bit word, for CE training targets.

    words: [batch, T] bits. State at time t is sum_i b_{t+i} * 2^i with zero
    padding past the end (reference trellis_utils.py:33-46).
    returns: [batch*T] int32 labels in [0, 2^memory_length).
    """
    batch, T = words.shape
    padded = torch.cat([words, words.new_zeros((batch, memory_length))], dim=1)
    windows = torch.stack([padded[:, i:T + i] for i in range(memory_length)], dim=-1)
    weights = (2 ** torch.arange(memory_length, device=words.device)).to(words.dtype)
    states = (windows * weights).sum(dim=-1)
    return states.reshape(-1).to(torch.int32)
