"""A small msgpack decoder, and flax's checkpoint encoding on top of it
(JAX counterpart: ``flax.serialization.msgpack_restore``, which the JAX
package's ``train/checkpoint.py::load_checkpoint`` calls).

The JAX package writes its checkpoints as msgpack of a nested dict whose
array leaves are msgpack extension types (``flax/serialization.py``):

  code 1, ndarray       msgpack of (shape, dtype name, C-order raw bytes)
  code 2, native complex msgpack of (real, imag)
  code 3, npscalar      an ndarray of shape (), returned as a numpy scalar

Arrays larger than 2**30 bytes are stored as ``__msgpack_chunked_array__``
dicts of chunks, which ``restore`` joins again. ``unpackb`` decodes maps,
arrays, str/bin, ints, floats, bool and nil, and extension types through
``ext_hook``. ``restore`` uses the ``msgpack`` package when it imports and
this decoder otherwise (the card's machine may lack the package); both
routes give identical trees, because both call the same ``ext_hook``.
Decoded arrays are read-only views of the file's bytes: copy one before
handing it to ``torch.from_numpy``.

bfloat16 arrays, which numpy cannot hold, come back widened to float32
(exact): the JAX package stores float32 weights and optimizer state, and
bfloat16 only as a compute dtype.
"""

from __future__ import annotations

import struct
from typing import NamedTuple

import numpy as np

NDARRAY, NATIVE_COMPLEX, NPSCALAR = 1, 2, 3


class ExtType(NamedTuple):
    """An extension type that ``ext_hook`` does not decode."""

    code: int
    data: bytes


_FIXED = {
    0xCA: (">f", 4), 0xCB: (">d", 8),
    0xCC: (">B", 1), 0xCD: (">H", 2), 0xCE: (">I", 4), 0xCF: (">Q", 8),
    0xD0: (">b", 1), 0xD1: (">h", 2), 0xD2: (">i", 4), 0xD3: (">q", 8),
}
_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}


class _Reader:
    def __init__(self, data: bytes, ext_hook, raw: bool):
        self.buf = memoryview(data)
        self.pos = 0
        self.ext_hook = ext_hook
        self.raw = raw

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.buf):
            raise ValueError("msgpack data ends inside an object at byte {}".format(self.pos))
        out = bytes(self.buf[self.pos : self.pos + n])
        self.pos += n
        return out

    def unpack(self, fmt: str, n: int):
        return struct.unpack(fmt, self.take(n))[0]

    def text(self, n: int):
        b = self.take(n)
        return b if self.raw else b.decode("utf-8")

    def ext(self, n: int):
        code = self.unpack(">b", 1)
        data = self.take(n)
        return self.ext_hook(code, data) if self.ext_hook is not None else ExtType(code, data)

    def obj(self):
        t = self.take(1)[0]
        if t <= 0x7F:
            return t
        if t >= 0xE0:
            return t - 0x100
        if 0x80 <= t <= 0x8F:
            return self.map(t & 0x0F)
        if 0x90 <= t <= 0x9F:
            return [self.obj() for _ in range(t & 0x0F)]
        if 0xA0 <= t <= 0xBF:
            return self.text(t & 0x1F)
        if t == 0xC0:
            return None
        if t == 0xC2:
            return False
        if t == 0xC3:
            return True
        if t in _FIXED:
            return self.unpack(*_FIXED[t])
        if t in (0xC4, 0xC5, 0xC6):
            return self.take(self.unpack(*{0xC4: (">B", 1), 0xC5: (">H", 2), 0xC6: (">I", 4)}[t]))
        if t in (0xD9, 0xDA, 0xDB):
            return self.text(self.unpack(*{0xD9: (">B", 1), 0xDA: (">H", 2), 0xDB: (">I", 4)}[t]))
        if t in (0xDC, 0xDD):
            return [self.obj() for _ in range(self.unpack(*{0xDC: (">H", 2), 0xDD: (">I", 4)}[t]))]
        if t in (0xDE, 0xDF):
            return self.map(self.unpack(*{0xDE: (">H", 2), 0xDF: (">I", 4)}[t]))
        if t in _FIXEXT:
            return self.ext(_FIXEXT[t])
        if t in (0xC7, 0xC8, 0xC9):
            return self.ext(self.unpack(*{0xC7: (">B", 1), 0xC8: (">H", 2), 0xC9: (">I", 4)}[t]))
        raise ValueError("byte 0x{:02x} at {} starts no msgpack object".format(t, self.pos - 1))

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.obj()
            out[k] = self.obj()
        return out


def unpackb(data: bytes, ext_hook=None, raw: bool = False):
    """Decode one msgpack object, as ``msgpack.unpackb(data, ext_hook=...,
    raw=...)`` does: arrays as lists, str as ``str`` (``bytes`` with
    ``raw``), bin as ``bytes``, extension types through ``ext_hook(code,
    data)`` (else ``ExtType``). Raises ValueError on malformed data or
    trailing bytes."""
    r = _Reader(data, ext_hook, raw)
    out = r.obj()
    if r.pos != len(r.buf):
        raise ValueError("{} bytes after the msgpack object".format(len(r.buf) - r.pos))
    return out


def _ndarray(data: bytes) -> np.ndarray:
    shape, name, buffer = unpackb(data, raw=True)
    if name == b"bfloat16":
        bits = np.frombuffer(buffer, dtype="<u2").astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    return np.frombuffer(buffer, dtype=np.dtype(name.decode())).reshape(shape)


def ext_hook(code: int, data: bytes):
    """flax's extension types: ndarray, native complex and numpy scalar;
    any other code as ``ExtType``."""
    if code == NDARRAY:
        return _ndarray(data)
    if code == NATIVE_COMPLEX:
        real, imag = unpackb(data)
        return complex(real, imag)
    if code == NPSCALAR:
        return _ndarray(data)[()]
    return ExtType(code, data)


def _unchunk(tree):
    """Join flax's chunked array leaves (``_chunk``), in place."""
    if isinstance(tree, dict):
        if "__msgpack_chunked_array__" in tree:
            shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
            chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
            return np.concatenate(chunks).reshape(shape)
        for k, v in tree.items():
            tree[k] = _unchunk(v)
    return tree


def restore(blob: bytes, use_msgpack: bool | None = None):
    """The tree of a flax msgpack blob (``flax.serialization.
    msgpack_restore``): through the ``msgpack`` package when it imports
    (``use_msgpack=None``) or is asked for (True), else this decoder
    (False)."""
    if use_msgpack is None:
        try:
            import msgpack  # noqa: F401
        except ImportError:
            use_msgpack = False
        else:
            use_msgpack = True
    if use_msgpack:
        import msgpack

        tree = msgpack.unpackb(blob, ext_hook=ext_hook, raw=False)
    else:
        tree = unpackb(blob, ext_hook=ext_hook, raw=False)
    return _unchunk(tree)


def read(path: str, use_msgpack: bool | None = None):
    """``restore`` of a file's bytes."""
    with open(path, "rb") as f:
        return restore(f.read(), use_msgpack)
