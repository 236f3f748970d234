"""Classical Viterbi detector with full CSI (analytic Gaussian branch metrics).

Parity with reference detectors/VA/va_detector.py:42-100. The detector has
no parameters; CSI enters as explicit per-word channel taps.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

from metaviterbinet_tpu_torch.ops.modulation import bpsk_modulate
from metaviterbinet_tpu_torch.ops.trellis import viterbi_decode

LOG_SQRT_2PI = math.log(math.sqrt(2 * math.pi))


def state_symbols(n_states: int, memory_length: int) -> np.ndarray:
    """[n_states, memory_length] BPSK symbols of each state's bit pattern.

    Column l holds the symbol of bit (L-1-l) of the state index, the MSB-first
    layout of the reference's np.unpackbits slice (va_detector.py:43-47).
    """
    s = np.arange(n_states).reshape(-1, 1)
    shifts = np.arange(memory_length - 1, -1, -1).reshape(1, -1)
    bits = (s >> shifts) & 1
    return bpsk_modulate(bits).astype(np.float32)


@functools.lru_cache(maxsize=8)
def _symbols_on(memory_length: int, device: torch.device) -> torch.Tensor:
    """state_symbols as a tensor on `device`, made once per device so that
    a CUDA graph can capture state_means (no copy from host memory)."""
    return torch.as_tensor(state_symbols(2 ** memory_length, memory_length), device=device)


def state_means(h: torch.Tensor) -> torch.Tensor:
    """Per-word noiseless state means mu [words, n_states] = h @ symbols^T.

    Summed tap by tap in a fixed order (the products are exact, the symbols
    being +-1), so the result does not depend on a matmul's reduction order
    or on TF32 settings."""
    L = h.shape[-1]
    sym = _symbols_on(L, h.device)
    mu = h[:, None, 0] * sym[:, 0]
    for l in range(1, L):
        mu = mu + h[:, None, l] * sym[:, l]
    return mu


def branch_priors_from_mu(y: torch.Tensor, mu: torch.Tensor) -> torch.Tensor:
    """Gaussian NLL branch metrics [words, T, n_states]: (y - mu_s)^2/2 - log sqrt(2 pi)."""
    diff = y[:, :, None] - mu[:, None, :]
    return diff ** 2 / 2 - LOG_SQRT_2PI


def branch_priors(y: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """Branch metrics from samples y [words, T] and taps h [words, L]
    (reference va_detector.py:49,64-68)."""
    return branch_priors_from_mu(y, state_means(h))


def detect(y: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """Full-CSI Viterbi decode: [words, T] samples + [words, L] taps -> bits."""
    return viterbi_decode(branch_priors(y, h))
