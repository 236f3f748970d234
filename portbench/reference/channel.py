"""The protocol's words, written plainly: random info bits, RS encode, BPSK,
and an L-tap ISI channel with AWGN whose time-decay taps fade with the
word's index (the Meta-ViterbiNet reference's channel/ package, as
metaviterbinet_tpu_torch/data/dataset.py and ops/channel.py at cb310e9 also
compute it).

Taps of word i: h_l = exp(-gamma l), l < L, times the fading factor of
fading type 1 (0.8 + 0.2 cos(2 pi i / P_l)) or 2 (0.8 + 0.2 cos(pi i /
(max(5 P_l - 1.5 i, 10) - 1e-5))), P = (51, 39, 33, 21). The received
sample t is sum_l h_(L-1-l) s_(t+l) + snr^(-1/2) w_t over the codeword's
BPSK symbols s = 1 - 2c, zero-padded by L bits.
"""
from __future__ import annotations

import math

import torch

from portbench.reference import rs

FADING_PERIODS = (51.0, 39.0, 33.0, 21.0)


def taps(memory_length: int, gamma: float, n_words: int, fading: bool, fading_type: int,
         device: torch.device) -> torch.Tensor:
    """[n_words, L] float32 taps of words 0 .. n_words - 1."""
    h = torch.exp(-gamma * torch.arange(memory_length, dtype=torch.float32, device=device))
    h = h.expand(n_words, memory_length)
    if not fading:
        return h.contiguous()
    periods = torch.tensor(FADING_PERIODS[:memory_length], device=device)
    index = torch.arange(n_words, dtype=torch.float32, device=device)[:, None]
    if fading_type == 1:
        factor = 0.8 + 0.2 * torch.cos(2 * math.pi * index / periods)
    elif fading_type == 2:
        factor = 0.8 + 0.2 * torch.cos(math.pi * index / (torch.clamp(5 * periods - 1.5 * index,
                                                                     min=10.0) - 1e-5))
    else:
        raise ValueError(f"no fading type {fading_type}")
    return (h * factor).contiguous()


def transmit(coded: torch.Tensor, h: torch.Tensor, snr_db: float,
             noise: torch.Tensor) -> torch.Tensor:
    """coded [W, n] bits, h [W, L], noise [W, n] -> received [W, n]."""
    W, n = coded.shape
    L = h.shape[1]
    s = torch.cat([1 - 2 * coded, coded.new_ones((W, L))], dim=1)  # zero bits are +1
    y = sum(h[:, L - 1 - l, None] * s[:, l:n + l] for l in range(L))
    return y + (10.0 ** (snr_db / 10.0)) ** -0.5 * noise


def words(n_blocks: int, n_words: int, info_bits: int, nsym: int, memory_length: int,
          gamma: float, snr_db: float, fading_type: int, generator: torch.Generator,
          device: torch.device) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """n_blocks batches of n_words words, all drawn in two calls on the
    device: (info bits [n_blocks, n_words, info_bits], received samples
    [n_blocks, n_words, n], taps [n_words, L]); word i of every batch sees
    the taps of index i."""
    bits = torch.randint(0, 2, (n_blocks * n_words, info_bits), generator=generator,
                         device=device).to(torch.float32)
    coded = torch.from_numpy(rs.encode_bits(bits.cpu().numpy(), nsym)).to(device, torch.float32)
    noise = torch.randn(coded.shape, generator=generator, device=device)
    h = taps(memory_length, gamma, n_words, True, fading_type, device)
    y = transmit(coded, h.repeat(n_blocks, 1), snr_db, noise)
    return (bits.reshape(n_blocks, n_words, -1), y.reshape(n_blocks, n_words, -1), h)

