"""Read the bytes `flax.serialization.to_bytes` writes, without flax or msgpack.

The JAX package's NN drivers keep their weights as flax state dicts in
msgpack (`cli/basecall.py:62-65`, `cli/call_var.py:69-73`).  This reader
takes the subset those files use: maps, arrays, strings, ints, floats,
booleans, nil and bin, with flax's ext types: 1 an ndarray, 3 a numpy
scalar (each a packed (shape, dtype name, C-order buffer)), 2 a complex
(a packed (real, imag)); and flax's chunked form of arrays over 2^30
bytes.  It returns the nested dict of numpy arrays.
"""

from __future__ import annotations

import struct

import numpy as np

_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3
_CHUNKED = "__msgpack_chunked_array__"


class _Reader:
    def __init__(self, buf: bytes):
        self.buf = memoryview(buf)
        self.pos = 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.buf):
            raise ValueError("truncated msgpack data")
        out = self.buf[self.pos : self.pos + n].tobytes()
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(">" + fmt, self.take(struct.calcsize(">" + fmt)))[0]

    def value(self):
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self.take(b & 0x1F).decode()
        fixed = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in fixed:
            return fixed[b]
        ints = {0xCC: "B", 0xCD: "H", 0xCE: "I", 0xCF: "Q", 0xD0: "b", 0xD1: "h", 0xD2: "i",
                0xD3: "q", 0xCA: "f", 0xCB: "d"}
        if b in ints:
            return self.unpack(ints[b])
        lengths = {0xC4: "B", 0xC5: "H", 0xC6: "I", 0xD9: "B", 0xDA: "H", 0xDB: "I",
                   0xDC: "H", 0xDD: "I", 0xDE: "H", 0xDF: "I", 0xC7: "B", 0xC8: "H", 0xC9: "I"}
        if b in lengths:
            n = self.unpack(lengths[b])
            if b <= 0xC6:
                return self.take(n)
            if b <= 0xC9:
                return self.ext(n)
            if b <= 0xDB:
                return self.take(n).decode()
            return self.array(n) if b <= 0xDD else self.map(n)
        if 0xD4 <= b <= 0xD8:  # fixext 1, 2, 4, 8, 16
            return self.ext(1 << (b - 0xD4))
        raise ValueError(f"unsupported msgpack type byte {b:#x}")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        return out

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def ext(self, n: int):
        code = self.unpack("b")
        data = self.take(n)
        if code in (_EXT_NDARRAY, _EXT_NPSCALAR):
            arr = _ndarray(data)
            return arr if code == _EXT_NDARRAY else arr[()]
        if code == _EXT_COMPLEX:
            real, imag = _Reader(data).value()
            return complex(real, imag)
        raise ValueError(f"unsupported msgpack ext type {code}")


def _ndarray(data: bytes) -> np.ndarray:
    shape, dtype, buf = _Reader(data).value()
    if isinstance(dtype, bytes):
        dtype = dtype.decode()
    if dtype == "bfloat16":  # numpy has no bfloat16: widen to float32 exactly
        bits = np.frombuffer(buf, "<u2").astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    return np.frombuffer(buf, np.dtype(dtype)).reshape(shape)


def _unchunk(tree):
    if not isinstance(tree, dict):
        return tree
    if tree.get(_CHUNKED):
        shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def loads(data: bytes):
    """The tree `flax.serialization.msgpack_restore` would give."""
    reader = _Reader(data)
    tree = reader.value()
    if reader.pos != len(reader.buf):
        raise ValueError("trailing bytes after the msgpack value")
    return _unchunk(tree)


def load(path) -> dict:
    with open(path, "rb") as f:
        return loads(f.read())
