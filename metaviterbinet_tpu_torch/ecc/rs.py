"""Batched Reed-Solomon codec over GF(2^8) on the device.

Behavioral parity with the reference scalar codec (python_code/ecc/
rs_encoder.py:7-37, rs_decoder.py:37-218, rs_main.py:9-37) and with the JAX
package's codec: systematic encode, decode by syndromes -> Berlekamp-Massey
-> Chien root search -> Forney magnitudes, with the same fallback: when BM
finds more errors than it can correct, the first n-nsym symbols are returned
uncorrected. Silent miscorrection beyond nsym/2 errors is the reference's
behaviour and is kept.

Every step works on a [words, n] tensor at once: polynomials live in
fixed-size buffers with a tracked length and BM runs exactly `nsym` masked
iterations, so no step depends on the data through the host. Loops run over
polynomial degrees (at most nsym + 2 steps), never over words.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from metaviterbinet_tpu_torch.ecc.gf256 import (
    _tables,
    alpha_pow,
    generator_poly,
    gf_div,
    gf_inverse,
    gf_mul,
    np_gf_mul,
    xor_reduce,
)

_BIT_WEIGHTS = (128, 64, 32, 16, 8, 4, 2, 1)


# The codec's constants are made once per device, like gf256.gf_tables: a
# copy from host memory on every call could not be captured in a CUDA graph
# (the engine captures the decode, online/engine.py), and the first call, a
# warm-up outside any capture, fills the cache.

@functools.lru_cache(maxsize=8)
def _bit_weights(device: torch.device) -> torch.Tensor:
    return torch.tensor(_BIT_WEIGHTS, dtype=torch.int64, device=device)


def bits_to_bytes(bits: torch.Tensor) -> torch.Tensor:
    """[..., 8k] {0,1} -> [..., k] int64 bytes, MSB-first (np.packbits order)."""
    bits = bits.to(torch.int64)
    return (bits.reshape(*bits.shape[:-1], bits.shape[-1] // 8, 8)
            * _bit_weights(bits.device)).sum(dim=-1)


def bytes_to_bits(by: torch.Tensor) -> torch.Tensor:
    """[..., k] int64 bytes -> [..., 8k] {0,1} int64 bits, MSB-first."""
    shifts = torch.arange(7, -1, -1, device=by.device)
    bits = (by.unsqueeze(-1) >> shifts) & 1
    return bits.reshape(*by.shape[:-1], by.shape[-1] * 8)


# --------------------------------------------------------------------------
# encode
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=16)
def _parity_matrix(k: int, nsym: int) -> np.ndarray:
    """[k, nsym]: row j is the parity of the unit message e_j.

    Systematic parity is the remainder of m(x) x^nsym mod g(x), linear over
    GF(2^8), so parity(m) = XOR_j m_j * row_j. Rows come from the LFSR
    division of the reference encoder."""
    g = generator_poly(nsym)
    rows = np.zeros((k, nsym), dtype=np.int64)
    for j in range(k):
        reg = [0] * nsym
        for i in range(k):
            feedback = (1 if i == j else 0) ^ reg[0]
            reg = [reg[r + 1] if r + 1 < nsym else 0 for r in range(nsym)]
            reg = [reg[r] ^ np_gf_mul(int(g[r + 1]), feedback) for r in range(nsym)]
        rows[j] = reg
    return rows


@functools.lru_cache(maxsize=16)
def _parity_rows(k: int, nsym: int, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(_parity_matrix(k, nsym), device=device)


def rs_encode_bytes(msg: torch.Tensor, nsym: int) -> torch.Tensor:
    """Systematic RS encode: msg [words, k] int64 -> codewords [words, k+nsym]."""
    k = msg.shape[-1]
    if k + nsym > 255:
        raise ValueError(f"codeword too long: {k + nsym} > 255")
    rows = _parity_rows(k, nsym, msg.device)
    parity = xor_reduce(gf_mul(msg.unsqueeze(-1), rows), dim=-2)
    return torch.cat([msg, parity], dim=-1)


def rs_encode_bits(bits: torch.Tensor, nsym: int) -> torch.Tensor:
    """Encode binary words: [words, 8k] bits -> [words, 8(k+nsym)] bits (bits' dtype)."""
    return bytes_to_bits(rs_encode_bytes(bits_to_bytes(bits), nsym)).to(bits.dtype)


# --------------------------------------------------------------------------
# decode
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=16)
def _decode_consts(n: int, nsym: int) -> tuple[np.ndarray, np.ndarray]:
    """Power matrices for syndrome and Chien evaluation at codeword length n."""
    exp = _tables()[0][:256]
    nb = nsym + 2  # BM buffer size (list lengths never exceed nsym+1)
    # syndrome: synd_i = XOR_j msg[j] * alpha^(i*(n-1-j)),  i = 0..nsym-1
    i_idx = np.arange(nsym)[:, None]
    j_idx = np.arange(n)[None, :]
    synd_pow = exp[(i_idx * (n - 1 - j_idx)) % 255]
    # chien: val_i = XOR_m coef_m * alpha^(i*m),  i = 0..n-1, m = 0..nb-1
    ii = np.arange(n)[:, None]
    mm = np.arange(nb)[None, :]
    chien_pow = exp[(ii * mm) % 255]
    return synd_pow, chien_pow


@functools.lru_cache(maxsize=16)
def _decode_tensors(n: int, nsym: int, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    return tuple(torch.as_tensor(a, device=device) for a in _decode_consts(n, nsym))


def rs_decode_bytes(rx: torch.Tensor, nsym: int):
    """Decode received codewords [words, n] int64 -> (messages [words, n-nsym],
    uncorrectable flags [words] bool)."""
    rx = rx.to(torch.int64)
    device = rx.device
    W, n = rx.shape
    nb = nsym + 2
    maxe = nsym
    synd_pow, chien_pow = _decode_tensors(n, nsym, device)

    # ---- syndromes (reference rs_decoder.py:37-47) ----
    synd_core = xor_reduce(gf_mul(rx[:, None, :], synd_pow), dim=2)  # [W, nsym]
    synd = torch.cat([rx.new_zeros((W, 1)), synd_core], dim=1)       # [W, nsym+1]

    # ---- Berlekamp-Massey with right-aligned fixed buffers ----
    # buffers hold list-form polynomials (highest degree first) right-aligned
    # in nb slots; (buffer, length) pairs replace the reference's lists.
    j_idx = torch.arange(nb, device=device)
    e_buf = rx.new_zeros((W, nb))
    e_buf[:, nb - 1] = 1                      # err_loc = [1]
    o_buf = e_buf.clone()                     # old_loc = [1]
    e_len = rx.new_ones((W,))
    o_len = rx.new_ones((W,))
    for i in range(nsym):
        K = i + 1  # synd_shift = 1
        # delta = synd[K] ^ XOR_{j=1..e_len-1} err_loc[-(j+1)] * synd[K-j]
        terms = gf_mul(e_buf[:, nb - 1 - j_idx], synd[:, (K - j_idx).clamp(0, nsym)])
        mask = (j_idx >= 1) & (j_idx < e_len[:, None]) & (K - j_idx >= 0)
        delta = synd[:, K] ^ xor_reduce(torch.where(mask, terms, 0), dim=1)
        # old_loc = old_loc + [0]  (append zero: shift left in the buffer)
        o_buf = torch.cat([o_buf[:, 1:], rx.new_zeros((W, 1))], dim=1)
        o_len = o_len + 1
        upd = delta != 0
        swap = upd & (o_len > e_len)
        new_e = gf_mul(o_buf, delta[:, None])
        o_buf2 = torch.where(swap[:, None], gf_mul(e_buf, gf_inverse(delta)[:, None]), o_buf)
        o_len2 = torch.where(swap, e_len, o_len)
        e_buf2 = torch.where(swap[:, None], new_e, e_buf)
        e_len2 = torch.where(swap, o_len, e_len)
        e_buf = torch.where(upd[:, None], e_buf2 ^ gf_mul(o_buf2, delta[:, None]), e_buf2)
        e_len = torch.where(upd, torch.maximum(e_len2, o_len2), e_len2)
        o_buf, o_len = o_buf2, o_len2

    # drop leading zeros (reference rs_decoder.py:199): first nonzero in the
    # active window [nb - e_len, nb); the constant term is always 1
    active = (j_idx >= nb - e_len[:, None]) & (e_buf != 0)
    first_nz = torch.where(active, j_idx, nb).amin(dim=1)            # [W]
    act_len = nb - first_nz
    uncorrectable = (act_len - 1) * 2 > nsym

    # ---- Chien search: roots of sum_m list[m] x^m at x = alpha^i ----
    rolled = torch.gather(e_buf, 1, (j_idx + first_nz[:, None]) % nb)
    coefs = torch.where(j_idx < act_len[:, None], rolled, 0)         # [W, nb]
    vals = xor_reduce(gf_mul(coefs[:, None, :], chien_pow), dim=2)   # [W, n]
    root_mask = vals == 0
    i_all = torch.arange(n, device=device)
    root_is = torch.sort(torch.where(root_mask, i_all, n), dim=1).values[:, :maxe]
    count = root_mask.sum(dim=1).clamp(max=maxe)
    valid = torch.arange(maxe, device=device) < count[:, None]       # [W, maxe]
    coef_pos = torch.where(valid, root_is, 0)
    err_pos = torch.where(valid, n - 1 - root_is, n)                 # n => dropped

    # ---- errata locator in power form: prod_k (1 + alpha^{coef_pos_k} x) ----
    lam = rx.new_zeros((W, maxe + 1))
    lam[:, 0] = 1
    for k in range(maxe):
        a = alpha_pow(coef_pos[:, k])
        shifted = torch.cat([rx.new_zeros((W, 1)), lam[:, :-1]], dim=1)
        lam = torch.where(valid[:, k, None], lam ^ gf_mul(a[:, None], shifted), lam)

    # ---- error evaluator Omega = [Synd_rev * Lambda] mod x^(count+1) ----
    d_idx = torch.arange(maxe + 1, device=device)[:, None]
    kk = torch.arange(maxe + 1, device=device)[None, :]
    s_at = synd[:, (d_idx - kk).clamp(0, nsym)]                      # [W, e+1, e+1]
    conv_terms = torch.where(kk <= d_idx, gf_mul(lam[:, None, :], s_at), 0)
    omega = xor_reduce(conv_terms, dim=2)                            # [W, maxe+1]

    # ---- Forney magnitudes ----
    X = alpha_pow(coef_pos)                                          # [W, maxe]
    Xinv = gf_inverse(X)
    deg = torch.arange(maxe + 1, device=device)
    d_pow = alpha_pow((255 - coef_pos[:, :, None]) * deg)            # [W, maxe, maxe+1]
    y_terms = torch.where(deg <= count[:, None, None],
                          gf_mul(omega[:, None, :], d_pow), 0)
    y = gf_mul(X, xor_reduce(y_terms, dim=2))
    # denominator: prod_{j != k, j valid} (1 ^ Xinv_k * X_j)
    cross = 1 ^ gf_mul(Xinv[:, :, None], X[:, None, :])              # [W, maxe, maxe]
    eye = torch.eye(maxe, dtype=torch.bool, device=device)
    factors = torch.where(~eye & valid[:, None, :], cross, 1)
    prime = rx.new_ones((W, maxe))
    for j in range(maxe):
        prime = gf_mul(prime, factors[:, :, j])
    magnitude = torch.where(valid & (prime != 0), gf_div(y, prime), 0)

    # ---- apply the correction ----
    e_vec = rx.new_zeros((W, n + 1)).scatter_(1, err_pos, magnitude)[:, :n]
    corrected = rx ^ e_vec
    out = torch.where(uncorrectable[:, None], rx, corrected)[:, :n - nsym]
    return out, uncorrectable


def rs_decode_bits(bits: torch.Tensor, nsym: int):
    """Decode binary codewords: [words, 8n] bits -> ([words, 8(n-nsym)] bits
    in the input's dtype, [words] uncorrectable flags)."""
    out, flags = rs_decode_bytes(bits_to_bytes(bits), nsym)
    return bytes_to_bits(out).to(bits.dtype), flags
