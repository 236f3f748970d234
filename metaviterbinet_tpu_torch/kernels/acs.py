"""Add-compare-select kernels for Hopper.

Four hand-written CUDA kernels, one per source in csrc/:
  - `fused_va_detect` (csrc/va_detect.cu) replaces the Pallas kernel
    metaviterbinet_tpu/kernels/acs.py::fused_va_detect;
  - `fused_viterbinet_detect` (csrc/viterbinet_detect.cu) replaces
    metaviterbinet_tpu/kernels/acs.py::fused_viterbinet_detect;
  - `fused_viterbinet_detect_chunked` (csrc/viterbinet_detect_chunked.cu)
    replaces metaviterbinet_tpu/kernels/acs.py::fused_viterbinet_detect_chunked;
  - `viterbi_decode_kernel` (csrc/viterbi_decode.cu) replaces
    metaviterbinet_tpu/kernels/acs.py::pallas_viterbi_decode.

K1, K2 and K4 are each a prior producer and a chain consumer in one block
(csrc/prior_ring.cuh); `chain_geometry` sizes K1's and K2's blocks and
`chunked_geometry` K4's from W and the card's SM count. kernels/native.py
builds and loads each source; a wrapper launches its kernel on the current
stream for CUDA tensors and counts the launch in its `launches` attribute,
and for CPU tensors runs the kernel's plain PyTorch version, which the tests
and chip_smoke.py also hold the kernel against.

The TPU kernels' `two_step` mode is a latency trick that is bit-exact
against the one-step recursion; these kernels run the one-step recursion
and give the same bits for either setting.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from metaviterbinet_tpu_torch.kernels.native import (
    INT, PTR, check_f32, check_launch, counted, launched, load, route)
from metaviterbinet_tpu_torch.models.va import branch_priors_from_mu
from metaviterbinet_tpu_torch.models.viterbinet import HIDDEN1, HIDDEN2, ViterbiNet
from metaviterbinet_tpu_torch.ops.trellis import viterbi_decode

SUPPORTED_STATES = (2, 4, 8, 16)

# the argument types of the C functions of csrc/{va_detect,viterbinet_detect,
# viterbinet_detect_chunked,viterbi_decode}.cu
VA_DETECT_ABI = (PTR, PTR, PTR) + (INT,) * 5 + (PTR,)
VITERBINET_DETECT_ABI = (PTR,) * 8 + (INT,) * 5 + (PTR,)
TILE_PRIORS_ABI = (PTR,) * 8 + (INT, PTR)
CHUNKED_ABI = (PTR,) * 8 + (INT,) * 9 + (PTR,)
VITERBI_DECODE_ABI = (PTR, PTR, INT, INT, INT, PTR)

# csrc/prior_ring.cuh: the chains of a block (one chain warp) and the
# symbols of a ring slot, at most
CHAIN_WORDS, SLOT_ROWS = 32, 128
VA_SLOT_STEPS = 32  # K2's steps per slot at most: its first slot is ready sooner


def chain_geometry(W: int, n_sms: int, max_slot_steps: int = SLOT_ROWS) -> tuple[int, int, int]:
    """K1's and K2's launch: (words per block, steps per slot, blocks).
    ceil(W / SMs) words per block, at most one chain warp's 32, so that
    small W spreads over one block per SM and large W fills every chain
    lane; a slot holds as many steps of those words as fit in SLOT_ROWS
    symbols, at most max_slot_steps."""
    words = max(1, min(CHAIN_WORDS, -(-W // n_sms)))
    steps = min(max_slot_steps, SLOT_ROWS // words)
    return words, steps, -(-W // words)


class ChunkedGeometry(NamedTuple):
    """K4's launch (csrc/viterbinet_detect_chunked.cu)."""
    chains: int      # chains of a chain set: the chain warp's live lanes
    warm_steps: int  # warm-up steps of a ring slot
    slot_steps: int  # stored steps of a ring slot
    sets: int        # chain sets, W C / chains rounded up
    blocks: int      # blocks, each taking every blocks-th set in turn


# symbols of a K4 ring slot at most: one 64-row tile per producer warpgroup
# (csrc/viterbinet_detect_chunked.cu's kRows; its launch refuses a larger slot)
K4_SLOT_ROWS = 192


def warming_chains(chains: int, C: int) -> int:
    """The chains of a K4 set of `chains` that run a warm-up: all but the
    stream-head chunks where a set is whole words (C <= 32), else all
    (csrc/viterbinet_detect_chunked.cu::warming_lanes)."""
    return chains - chains // C if C <= CHAIN_WORDS else chains


def chunked_geometry(W: int, C: int, T: int, overlap: int, n_sms: int) -> ChunkedGeometry:
    """K4's launch. ceil(W C / SMs) chains per set, rounded up to whole words
    where C <= 32 (at most 32: one chain warp), so that small W spreads over
    one block per SM and large W fills every chain lane; one block per SM at
    most, which runs its sets one after another. A warm-up slot holds as
    many steps of the set's warming chains as fit in K4_SLOT_ROWS symbols, a
    stored slot as many steps of all its chains, a multiple of 4 where 4
    divides the chunk length T / C, so that the kernel stores the bits 4 at
    a time (csrc/prior_ring.cuh::store_width)."""
    n = W * C
    per = max(1, -(-n // n_sms))
    if C <= CHAIN_WORDS:
        chains = min(-(-per // C), CHAIN_WORDS // C) * C
    else:
        chains = min(CHAIN_WORDS, per)
    warming = warming_chains(chains, C)
    warm = min(overlap, K4_SLOT_ROWS // warming) if warming else overlap
    steps = K4_SLOT_ROWS // chains
    if (T // C) % 4 == 0:
        steps -= steps % 4
    sets = -(-n // chains)
    return ChunkedGeometry(chains, warm, steps, sets, min(sets, n_sms))


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _geometry(y: torch.Tensor, max_slot_steps: int = SLOT_ROWS) -> tuple[int, int]:
    words, steps, _ = chain_geometry(y.shape[0], _sm_count(y.device.index), max_slot_steps)
    return words, steps


# --------------------------------------------------------------------------
# K2: full-CSI VA
# --------------------------------------------------------------------------

def fused_va_detect_plain(y: torch.Tensor, mu: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the VA kernel: viterbi_decode(branch_priors_from_mu)."""
    return viterbi_decode(branch_priors_from_mu(y, mu))


@counted
def fused_va_detect(y: torch.Tensor, mu: torch.Tensor) -> torch.Tensor:
    """Full-CSI VA hard decode. y [W, T] received samples, mu [W, S] per-word
    state means (models/va.py::state_means); returns [W, T] f32 bits,
    bit-identical to `fused_va_detect_plain`."""
    check_f32("fused_va_detect", y, 2, y.device)
    check_f32("fused_va_detect", mu, 2, y.device)
    W, T = y.shape
    S = mu.shape[1]
    if mu.shape[0] != W or S not in SUPPORTED_STATES:
        raise ValueError(f"fused_va_detect: mu {tuple(mu.shape)} for y {tuple(y.shape)}; "
                         f"S must be one of {SUPPORTED_STATES}")
    if not route("fused_va_detect", y):
        return fused_va_detect_plain(y, mu)
    out = torch.empty_like(y)
    if y.numel() == 0:
        return out
    with torch.cuda.device(y.device):
        rc = load("va_detect", VA_DETECT_ABI)(y.data_ptr(), mu.data_ptr(), out.data_ptr(), W, T, S,
                           *_geometry(y, VA_SLOT_STEPS),
                           torch.cuda.current_stream(y.device).cuda_stream)
    launched(fused_va_detect, rc)
    return out


# --------------------------------------------------------------------------
# K5: ACS over precomputed priors
# --------------------------------------------------------------------------

def viterbi_decode_kernel_plain(priors: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the decode kernel: ops/trellis.py::viterbi_decode."""
    return viterbi_decode(priors)


@counted
def viterbi_decode_kernel(priors: torch.Tensor) -> torch.Tensor:
    """Greedy zero-delay Viterbi decode of branch metrics priors [W, T, S]
    f32 (any W); returns [W, T] f32 bits, bit-identical to
    `viterbi_decode_kernel_plain`."""
    check_f32("viterbi_decode_kernel", priors, 3, priors.device)
    W, T, S = priors.shape
    if S not in SUPPORTED_STATES:
        raise ValueError(f"viterbi_decode_kernel: S={S} must be one of {SUPPORTED_STATES}")
    if not route("viterbi_decode_kernel", priors):
        return viterbi_decode_kernel_plain(priors)
    if priors.data_ptr() % (4 * min(S, 4)):
        raise ValueError("viterbi_decode_kernel: priors must be aligned for vector loads")
    out = priors.new_empty((W, T))
    if out.numel() == 0:
        return out
    with torch.cuda.device(priors.device):
        rc = load("viterbi_decode", VITERBI_DECODE_ABI)(
            priors.data_ptr(), out.data_ptr(), W, T, S,
            torch.cuda.current_stream(priors.device).cuda_stream)
    launched(viterbi_decode_kernel, rc)
    return out


# --------------------------------------------------------------------------
# K1: ViterbiNet
# --------------------------------------------------------------------------

def mlp_params(model: ViterbiNet) -> tuple[torch.Tensor, ...]:
    """(w1 [100], b1, w2 [50,100], b2, w3 [S,50], b3) as contiguous f32 tensors."""
    return tuple(p.detach().to(torch.float32).contiguous() for p in (
        model.fc1.weight.reshape(-1), model.fc1.bias, model.fc2.weight,
        model.fc2.bias, model.fc3.weight, model.fc3.bias))


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def bf16_priors(model: ViterbiNet, y: torch.Tensor) -> torch.Tensor:
    """The kernels' priors [W, T, S]: the MLP with h1, W2, h2 and W3 rounded
    to bf16 and f32 products, negated."""
    w1, b1, w2, b2, w3, b3 = mlp_params(model)
    W, T = y.shape
    h1 = torch.sigmoid(y.reshape(-1, 1) * w1 + b1)
    h2 = torch.relu(_bf16(h1) @ _bf16(w2).T + b2)
    logits = _bf16(h2) @ _bf16(w3).T + b3
    return -logits.reshape(W, T, -1)


@torch.no_grad()
def fused_viterbinet_detect_plain(model: ViterbiNet, y: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the ViterbiNet kernel: the bf16-rounded
    priors of `bf16_priors`, then viterbi_decode."""
    return viterbi_decode(bf16_priors(model, y))


def _check_viterbinet(name: str, model: ViterbiNet, y: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """K1's and K4's checks of y and the network; returns mlp_params."""
    check_f32(name, y, 2, y.device)
    params = mlp_params(model)
    for p in params:
        if p.device != y.device:
            raise ValueError(f"{name}: params on {p.device}, y on {y.device}")
    w1, _, w2, _, w3, _ = params
    if w1.shape[0] != HIDDEN1 or w2.shape != (HIDDEN2, HIDDEN1) or w3.shape[0] not in SUPPORTED_STATES:
        raise ValueError(f"{name}: expected a 1-100-50-S network with S in {SUPPORTED_STATES}")
    return params


@counted
@torch.no_grad()
def fused_viterbinet_detect(model: ViterbiNet, y: torch.Tensor) -> torch.Tensor:
    """ViterbiNet hard decode. y [W, T]; returns [W, T] f32 bits. On the card
    the bits agree with `fused_viterbinet_detect_plain` up to rare near-tie
    flips (the products sum in another order)."""
    params = _check_viterbinet("fused_viterbinet_detect", model, y)
    if not route("fused_viterbinet_detect", y):
        return fused_viterbinet_detect_plain(model, y)
    W, T = y.shape
    out = torch.empty_like(y)
    if y.numel() == 0:
        return out
    with torch.cuda.device(y.device):
        rc = load("viterbinet_detect", VITERBINET_DETECT_ABI)(
            y.data_ptr(), *(p.data_ptr() for p in params), out.data_ptr(), W, T,
            params[4].shape[0], *_geometry(y), torch.cuda.current_stream(y.device).cuda_stream)
    launched(fused_viterbinet_detect, rc)
    return out


@torch.no_grad()
def viterbinet_tile_priors(model: ViterbiNet, y: torch.Tensor) -> torch.Tensor:
    """The priors [64, S] of y [64] (CUDA) from one tensor-core tile, the
    code K1 and K4 run (csrc/viterbinet_mlp.cuh::mlp_tile), for holding the
    products against `bf16_priors`. Counts no launch: no path runs it."""
    params = _check_viterbinet("viterbinet_tile_priors", model, y.reshape(1, -1))
    if y.shape != (64,) or y.device.type != "cuda":
        raise ValueError("viterbinet_tile_priors: expected y [64] on a CUDA device")
    fn = load("viterbinet_detect", TILE_PRIORS_ABI, "viterbinet_tile_priors")
    S = params[4].shape[0]
    out = y.new_empty((64, S))
    with torch.cuda.device(y.device):
        rc = fn(y.data_ptr(), *(p.data_ptr() for p in params), out.data_ptr(), S,
                torch.cuda.current_stream(y.device).cuda_stream)
    check_launch("viterbinet_tile_priors", rc)
    return out


# --------------------------------------------------------------------------
# K4: ViterbiNet over overlap-save time chunks
# --------------------------------------------------------------------------

def _check_chunks(T: int, n_chunks: int, overlap: int) -> None:
    if n_chunks < 1 or T % n_chunks:
        raise ValueError(f"T={T} must divide into {n_chunks} chunks")
    if overlap < 1 or overlap > T // n_chunks:
        raise ValueError(f"overlap {overlap} must lie in [1, chunk length {T // n_chunks}]")


@torch.no_grad()
def fused_viterbinet_detect_chunked_plain(model: ViterbiNet, y: torch.Tensor, n_chunks: int,
                                          overlap: int = 32) -> torch.Tensor:
    """Plain PyTorch version of the chunked kernel, built as the JAX wrapper
    builds it: the [W * C, overlap + Tc] extended words (chunk c prefixed
    with the last `overlap` symbols of chunk c - 1, chunk 0 with zeros), K1's
    bf16-rounded priors on them with the first `overlap` steps of every
    chunk-0 word multiplied by 0, viterbi_decode, the warm-up bits dropped."""
    W, T = y.shape
    _check_chunks(T, n_chunks, overlap)
    Tc = T // n_chunks
    chunks = y.reshape(W, n_chunks, Tc)
    warm = torch.cat([y.new_zeros((W, 1, overlap)), chunks[:, :-1, Tc - overlap:]], dim=1)
    ext = torch.cat([warm, chunks], dim=2).reshape(W * n_chunks, overlap + Tc)
    priors = bf16_priors(model, ext)
    # word j = w * C + c holds chunk c of word w: mask 0 iff c == 0
    mask = (torch.arange(W * n_chunks, device=y.device) % n_chunks != 0).to(y.dtype)
    priors[:, :overlap] = priors[:, :overlap] * mask[:, None, None]
    return viterbi_decode(priors)[:, overlap:].reshape(W, T)


@counted
@torch.no_grad()
def fused_viterbinet_detect_chunked(model: ViterbiNet, y: torch.Tensor, n_chunks: int,
                                    overlap: int = 32) -> torch.Tensor:
    """ViterbiNet hard decode over `n_chunks` time chunks, each warmed up on
    its left neighbour's last `overlap` symbols. y [W, T] (any W), T %
    n_chunks == 0, 1 <= overlap <= T / n_chunks; returns [W, T] f32 bits.
    A symbol's priors are bit-identical to K1's, so the bits equal
    `fused_viterbinet_detect` wherever the trellis forgets within `overlap`
    steps; on the card they agree with the plain version up to rare
    near-tie flips, as K1's do. The launch is `chunked_geometry`'s."""
    params = _check_viterbinet("fused_viterbinet_detect_chunked", model, y)
    W, T = y.shape
    _check_chunks(T, n_chunks, overlap)
    if not route("fused_viterbinet_detect_chunked", y):
        return fused_viterbinet_detect_chunked_plain(model, y, n_chunks, overlap)
    out = torch.empty_like(y)
    if y.numel() == 0:
        return out
    g = chunked_geometry(W, n_chunks, T, overlap, _sm_count(y.device.index))
    with torch.cuda.device(y.device):
        rc = load("viterbinet_detect_chunked", CHUNKED_ABI)(
            y.data_ptr(), *(p.data_ptr() for p in params), out.data_ptr(), W, T,
            params[4].shape[0], n_chunks, overlap, g.chains, g.warm_steps, g.slot_steps, g.blocks,
            torch.cuda.current_stream(y.device).cuda_stream)
    launched(fused_viterbinet_detect_chunked, rc)
    return out
