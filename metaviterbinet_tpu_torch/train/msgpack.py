"""A msgpack decoder for the JAX package's checkpoints, with no `msgpack`
or `flax` (the port depends on neither).

The JAX package writes its checkpoints with flax's `msgpack_serialize`
(metaviterbinet_tpu/train/checkpoint.py there): a msgpack map whose array
leaves are ext types. `unpackb` decodes every msgpack type a flax checkpoint
can hold (the msgpack spec: nil, bool, every int and float width, str, bin,
array and map in their fix/8/16/32 forms, and ext) and flax's ext codes, as
flax's `msgpack_restore` does:
  1 ndarray   a msgpack of (shape, dtype name, C-order bytes) -> np.ndarray
  2 complex   a msgpack of (real, imag)                       -> complex
  3 npscalar  an ndarray payload of shape ()                  -> numpy scalar
Arrays come back as read-only numpy views of the input. An unknown ext code
or type byte raises ValueError.
"""
from __future__ import annotations

import struct

import numpy as np

EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3


class _Reader:
    def __init__(self, data: bytes, raw: bool):
        self.data, self.pos, self.raw = memoryview(data), 0, raw

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("msgpack: truncated input")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def uint(self, n: int) -> int:
        return int.from_bytes(self.take(n), "big")

    def sint(self, n: int) -> int:
        return int.from_bytes(self.take(n), "big", signed=True)

    def str_or_bin(self, n: int, is_str: bool):
        b = bytes(self.take(n))
        return b.decode("utf-8") if is_str and not self.raw else b

    def ext(self, n: int):
        code = self.sint(1)
        payload = bytes(self.take(n))
        if code == EXT_NDARRAY:
            return _ndarray(payload)
        if code == EXT_COMPLEX:
            real, imag = unpackb(payload)
            return complex(real, imag)
        if code == EXT_NPSCALAR:
            return _ndarray(payload)[()]
        raise ValueError(f"msgpack: unknown ext code {code}")

    def value(self):
        t = self.uint(1)
        if t <= 0x7F:
            return t
        if t >= 0xE0:
            return t - 0x100
        if 0x80 <= t <= 0x8F:
            return self.map(t & 0x0F)
        if 0x90 <= t <= 0x9F:
            return self.array(t & 0x0F)
        if 0xA0 <= t <= 0xBF:
            return self.str_or_bin(t & 0x1F, True)
        if t in _FIXED:
            return _FIXED[t](self)
        raise ValueError(f"msgpack: unknown type byte 0x{t:02x}")

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        return out


_FIXED = {
    0xC0: lambda r: None,
    0xC2: lambda r: False,
    0xC3: lambda r: True,
    0xC4: lambda r: r.str_or_bin(r.uint(1), False),
    0xC5: lambda r: r.str_or_bin(r.uint(2), False),
    0xC6: lambda r: r.str_or_bin(r.uint(4), False),
    0xC7: lambda r: r.ext(r.uint(1)),
    0xC8: lambda r: r.ext(r.uint(2)),
    0xC9: lambda r: r.ext(r.uint(4)),
    0xCA: lambda r: struct.unpack(">f", r.take(4))[0],
    0xCB: lambda r: struct.unpack(">d", r.take(8))[0],
    0xCC: lambda r: r.uint(1),
    0xCD: lambda r: r.uint(2),
    0xCE: lambda r: r.uint(4),
    0xCF: lambda r: r.uint(8),
    0xD0: lambda r: r.sint(1),
    0xD1: lambda r: r.sint(2),
    0xD2: lambda r: r.sint(4),
    0xD3: lambda r: r.sint(8),
    0xD4: lambda r: r.ext(1),
    0xD5: lambda r: r.ext(2),
    0xD6: lambda r: r.ext(4),
    0xD7: lambda r: r.ext(8),
    0xD8: lambda r: r.ext(16),
    0xD9: lambda r: r.str_or_bin(r.uint(1), True),
    0xDA: lambda r: r.str_or_bin(r.uint(2), True),
    0xDB: lambda r: r.str_or_bin(r.uint(4), True),
    0xDC: lambda r: r.array(r.uint(2)),
    0xDD: lambda r: r.array(r.uint(4)),
    0xDE: lambda r: r.map(r.uint(2)),
    0xDF: lambda r: r.map(r.uint(4)),
}


def _ndarray(payload: bytes) -> np.ndarray:
    """flax's ndarray ext: (shape, dtype name, bytes), its strings raw."""
    shape, dtype_name, buffer = unpackb(payload, raw=True)
    return np.frombuffer(buffer, dtype=np.dtype(dtype_name.decode())).reshape(shape)


def unpackb(data: bytes, raw: bool = False):
    """The object `data` encodes, as msgpack.unpackb(data, raw=raw) with
    flax's ext hook: maps as dicts, arrays as lists, str as str (bytes when
    `raw`), bin as bytes, flax's arrays as numpy arrays."""
    reader = _Reader(data, raw)
    out = reader.value()
    if reader.pos != len(reader.data):
        raise ValueError(f"msgpack: {len(reader.data) - reader.pos} bytes after the object")
    return out
