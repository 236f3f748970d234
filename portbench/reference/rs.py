"""Reed-Solomon over GF(2^8), written plainly: systematic encode and a
bounded-distance decode by syndromes, Berlekamp-Massey, Chien search and
Forney, one word at a time.

The field and the code are those of the Meta-ViterbiNet reference's codec
(github.com/tomerraviv95/meta-viterbinet, python_code/ecc/): primitive
polynomial 0x11d, alpha = 2, generator roots alpha^0 .. alpha^(nsym - 1),
bits packed MSB first. Its departures from a textbook decoder are kept:
a word whose error locator has more roots than the code corrects, or none
inside the word, comes back with its first n - nsym symbols as received;
otherwise the symbols at the roots found are corrected, with magnitudes
from the locator of those roots alone.
"""
from __future__ import annotations

import functools

import numpy as np

PRIM = 0x11D


@functools.lru_cache(maxsize=1)
def tables() -> tuple[np.ndarray, np.ndarray]:
    """exp [512] and log [256] of alpha = 2."""
    exp = np.zeros(512, dtype=np.int64)
    log = np.zeros(256, dtype=np.int64)
    x = 1
    for i in range(255):
        exp[i] = x
        log[x] = i
        x <<= 1
        if x & 0x100:
            x ^= PRIM
    exp[255:] = exp[:257]
    return exp, log


def mul(a: int, b: int) -> int:
    exp, log = tables()
    return 0 if a == 0 or b == 0 else int(exp[log[a] + log[b]])


def inv(a: int) -> int:
    exp, log = tables()
    return int(exp[255 - log[a]])


def poly_eval(p: list[int], x: int) -> int:
    """p highest degree first."""
    y = 0
    for c in p:
        y = mul(y, x) ^ c
    return y


@functools.lru_cache(maxsize=8)
def generator(nsym: int) -> tuple[int, ...]:
    """prod_i (x - alpha^i), i < nsym, highest degree first."""
    exp, _ = tables()
    g = [1]
    for i in range(nsym):
        out = g + [0]
        for j, c in enumerate(g):
            out[j + 1] ^= mul(c, int(exp[i]))
        g = out
    return tuple(g)


def pack(bits: np.ndarray) -> np.ndarray:
    """[..., 8k] {0, 1} -> [..., k] bytes, MSB first."""
    return np.packbits(np.asarray(bits, dtype=np.uint8), axis=-1).astype(np.int64)


def unpack(by: np.ndarray) -> np.ndarray:
    return np.unpackbits(np.asarray(by, dtype=np.uint8), axis=-1)


def encode_bits(bits: np.ndarray, nsym: int) -> np.ndarray:
    """[words, 8k] bits -> [words, 8 (k + nsym)] bits: the message, then the
    remainder of m(x) x^nsym divided by the generator, by long division
    (vectorised over words)."""
    msg = pack(bits)
    g = generator(nsym)
    exp, log = tables()
    rem = np.zeros((msg.shape[0], nsym), dtype=np.int64)
    for j in range(msg.shape[1]):
        lead = msg[:, j] ^ rem[:, 0]
        rem = np.concatenate([rem[:, 1:], np.zeros((msg.shape[0], 1), np.int64)], axis=1)
        nz = lead != 0
        for r in range(nsym):
            prod = np.where(nz, exp[(log[np.maximum(lead, 1)] + log[g[r + 1]]) % 255], 0)
            rem[:, r] ^= prod
    return unpack(np.concatenate([msg, rem], axis=1))


def decode_word(word: list[int], nsym: int) -> list[int]:
    """One received word of n bytes -> its first n - nsym bytes, corrected
    where the decoder finds at most nsym / 2 errors inside the word."""
    exp, log = tables()
    n = len(word)
    synd = [poly_eval(word, int(exp[i])) for i in range(nsym)]
    if not any(synd):
        return list(word[:n - nsym])
    # Berlekamp-Massey: the error locator, lowest degree first
    loc, old = [1], [1]
    for i in range(nsym):
        old = [0] + old
        delta = synd[i]
        for j in range(1, len(loc)):
            delta ^= mul(loc[j], synd[i - j])
        if delta:
            if len(old) > len(loc):
                new = [mul(c, delta) for c in old]
                old = [mul(c, inv(delta)) for c in loc]
                loc = new
            scaled = [mul(c, delta) for c in old]
            loc = [(loc[k] if k < len(loc) else 0) ^ (scaled[k] if k < len(scaled) else 0)
                   for k in range(max(len(loc), len(scaled)))]
    while len(loc) > 1 and loc[-1] == 0:
        loc.pop()
    errs = len(loc) - 1
    if 2 * errs > nsym:
        return list(word[:n - nsym])
    # Chien: position p (from the word's end) is an error where
    # loc(alpha^-p) = 0
    high_first = loc[::-1]
    positions = [p for p in range(n) if poly_eval(high_first, int(exp[(255 - p) % 255])) == 0]
    if not positions:
        return list(word[:n - nsym])
    # Forney over the locator of the positions found, first consecutive
    # root alpha^0: e = X omega(X^-1) / loc'(X^-1), omega = synd * loc mod
    # x^(roots found)
    loc = [1]
    for p in positions:
        loc = [a ^ mul(int(exp[p]), b) for a, b in zip(loc + [0], [0] + loc)]
    omega = [0] * len(positions)
    for d in range(len(positions)):
        for k in range(min(d + 1, len(loc))):
            omega[d] ^= mul(loc[k], synd[d - k])
    fixed = list(word)
    for p in positions:
        xinv = inv(int(exp[p]))
        den = 0  # the formal derivative: odd-degree terms
        for k in range(1, len(loc), 2):
            den ^= mul(loc[k], int(exp[(log[xinv] * (k - 1)) % 255]))
        if den:
            fixed[n - 1 - p] ^= mul(int(exp[p]), mul(poly_eval(omega[::-1], xinv), inv(den)))
    return fixed[:n - nsym]


def decode_bits(bits: np.ndarray, nsym: int) -> np.ndarray:
    """[words, 8n] bits -> [words, 8 (n - nsym)] decoded bits."""
    by = pack(bits)
    return unpack(np.array([decode_word([int(v) for v in w], nsym) for w in by], dtype=np.int64))
