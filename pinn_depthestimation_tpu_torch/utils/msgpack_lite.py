"""A msgpack decoder for the JAX package's ``.msgpack`` checkpoints.

The JAX package writes its checkpoints with ``flax.serialization.to_bytes``
(``training/checkpoint.py::save_checkpoint``); the card's machine has
neither ``msgpack`` nor ``flax``. This module reads what that writer
produces with the standard library and numpy only:

* the msgpack types: maps, arrays (as lists), str, bin, ints, floats, nil
  and bool;
* flax's ext types: 1, an ndarray packed as ``(shape, dtype name, C-order
  buffer)``; 2, a Python complex; 3, a numpy scalar (an ndarray of shape
  ``()``); other ext codes come back as :class:`ExtType`;
* flax's chunked form of arrays over 2^30 bytes, a map with
  ``__msgpack_chunked_array__``, ``shape`` and ``chunks``, put back
  together as one array.

:func:`unpackb` returns what ``flax.serialization.msgpack_restore`` returns
for the same bytes (a test holds the two together on drawn trees).
``bfloat16`` arrays, which numpy lacks, come back as float32 with the same
values.
"""

from __future__ import annotations

import struct
from typing import Any, NamedTuple

import numpy as np

CHUNKED = "__msgpack_chunked_array__"


class ExtType(NamedTuple):
    """An ext value of a code flax does not define."""

    code: int
    data: bytes


class _Reader:
    def __init__(self, data: bytes, raw: bool):
        self.data = memoryview(data)
        self.pos = 0
        self.raw = raw

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("msgpack data ends inside a value")
        out = bytes(self.data[self.pos:self.pos + n])
        self.pos += n
        return out

    def unpack(self, fmt: str) -> Any:
        return struct.unpack(">" + fmt, self.take(struct.calcsize(">" + fmt)))[0]

    def str_(self, n: int):
        b = self.take(n)
        return b if self.raw else b.decode("utf-8")

    def value(self) -> Any:
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map_(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.value() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self.str_(b & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        if b in (0xC4, 0xC5, 0xC6):
            return self.take(self.unpack("BHI"[b - 0xC4]))
        if b in (0xC7, 0xC8, 0xC9):
            n = self.unpack("BHI"[b - 0xC7])
            return self.ext(self.unpack("b"), n)
        if b == 0xCA:
            return self.unpack("f")
        if b == 0xCB:
            return self.unpack("d")
        if 0xCC <= b <= 0xCF:
            return self.unpack("BHIQ"[b - 0xCC])
        if 0xD0 <= b <= 0xD3:
            return self.unpack("bhiq"[b - 0xD0])
        if 0xD4 <= b <= 0xD8:
            code = self.unpack("b")
            return self.ext(code, 1 << (b - 0xD4))
        if b in (0xD9, 0xDA, 0xDB):
            return self.str_(self.unpack("BHI"[b - 0xD9]))
        if b in (0xDC, 0xDD):
            return [self.value() for _ in range(self.unpack("HI"[b - 0xDC]))]
        if b in (0xDE, 0xDF):
            return self.map_(self.unpack("HI"[b - 0xDE]))
        raise ValueError(f"msgpack: unknown type byte 0x{b:02x} at offset {self.pos - 1}")

    def map_(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.value()
            out[tuple(k) if isinstance(k, list) else k] = self.value()
        return out

    def ext(self, code: int, n: int) -> Any:
        data = self.take(n)
        if code == 1:
            return _ndarray(data)
        if code == 2:
            real, imag = _unpack(data, raw=False)
            return complex(real, imag)
        if code == 3:
            return _ndarray(data)[()]
        return ExtType(code, data)


def _unpack(data: bytes, raw: bool) -> Any:
    r = _Reader(data, raw)
    out = r.value()
    if r.pos != len(r.data):
        raise ValueError(f"msgpack: {len(r.data) - r.pos} bytes past the end of the value")
    return out


def _ndarray(data: bytes) -> np.ndarray:
    """flax's ext 1: ``(shape, dtype name, buffer)``."""
    shape, name, buffer = _unpack(data, raw=True)
    name = name.decode() if isinstance(name, bytes) else name
    if name == "bfloat16":
        bits = np.frombuffer(buffer, dtype=np.uint16).astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    return np.frombuffer(buffer, dtype=np.dtype(name)).reshape(shape)


def _unchunk(tree: Any) -> Any:
    """flax's chunked arrays back as arrays, anywhere in ``tree``."""
    if isinstance(tree, dict):
        if CHUNKED in tree:
            shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
            chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
            return np.concatenate(chunks).reshape(shape)
        return {k: _unchunk(v) for k, v in tree.items()}
    return tree


def unpackb(data: bytes) -> Any:
    """The tree of a flax ``.msgpack`` file's bytes, as
    ``flax.serialization.msgpack_restore`` gives it."""
    return _unchunk(_unpack(bytes(data), raw=False))


def read(path: str) -> Any:
    """:func:`unpackb` of a file."""
    with open(path, "rb") as f:
        return unpackb(f.read())
