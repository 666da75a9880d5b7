"""A reader for flax's msgpack checkpoints, on the standard library and numpy.

The JAX package writes ``CP_epoch{n}.msgpack`` with
``flax.serialization.to_bytes``; this module reads those bytes back into the
same tree without flax or the ``msgpack`` package, as ``data/png.py`` reads
PNGs without Pillow.  The format (flax ``serialization.py``):

- one msgpack map of str keys; lists and tuples are stored as maps keyed
  ``"0"``, ``"1"``, ...;
- an ndarray is ext type 1, whose payload is itself msgpack:
  ``(shape, dtype name, C-order bytes)``; a numpy scalar is ext type 3 with
  the same payload; ext type 2 (a Python complex) is refused;
- an array above flax's ``MAX_CHUNK_SIZE`` is stored as the map
  ``{"__msgpack_chunked_array__": True, "shape": {...}, "chunks": {...}}``
  of its flattened pieces, which are joined back here.

numpy has no bfloat16, so a ``"bfloat16"`` array becomes a
``torch.bfloat16`` tensor (its bytes viewed as int16); every other array is
a read-only numpy view of the file's bytes, as flax returns it.  Truncated
or malformed bytes raise ``ValueError``.
"""
from __future__ import annotations

import struct
from typing import Any

import numpy as np
import torch

__all__ = ["msgpack_restore", "load_msgpack"]

_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3
_CHUNKED = "__msgpack_chunked_array__"

# fixed-width scalars: first byte -> struct format
_SCALARS = {0xca: ">f", 0xcb: ">d", 0xcc: ">B", 0xcd: ">H", 0xce: ">I", 0xcf: ">Q",
            0xd0: ">b", 0xd1: ">h", 0xd2: ">i", 0xd3: ">q"}
# length-prefixed: first byte -> (kind, struct format of the length)
_SIZED = {0xc4: ("bin", ">B"), 0xc5: ("bin", ">H"), 0xc6: ("bin", ">I"),
          0xc7: ("ext", ">B"), 0xc8: ("ext", ">H"), 0xc9: ("ext", ">I"),
          0xd9: ("str", ">B"), 0xda: ("str", ">H"), 0xdb: ("str", ">I"),
          0xdc: ("array", ">H"), 0xdd: ("array", ">I"),
          0xde: ("map", ">H"), 0xdf: ("map", ">I")}
_FIXEXT = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}


class _Reader:
    """``views``: bin values as views of ``data`` (an ndarray's payload),
    else as ``bytes``."""

    def __init__(self, data, views: bool = False):
        self.data = memoryview(data)
        self.views = views
        self.pos = 0

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.data):
            raise ValueError(f"msgpack: truncated at byte {self.pos} (wants {n} more, "
                             f"{len(self.data) - self.pos} left)")
        out = self.data[self.pos:end]
        self.pos = end
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self) -> Any:
        b = self.unpack(">B")
        if b <= 0x7f:
            return b
        if b >= 0xe0:
            return b - 0x100
        if 0x80 <= b <= 0x8f:
            return self.map(b & 0x0f)
        if 0x90 <= b <= 0x9f:
            return [self.value() for _ in range(b & 0x0f)]
        if 0xa0 <= b <= 0xbf:
            return self.str(b & 0x1f)
        if b == 0xc0:
            return None
        if b in (0xc2, 0xc3):
            return b == 0xc3
        if b in _SCALARS:
            return self.unpack(_SCALARS[b])
        if b in _FIXEXT:
            return self.ext(_FIXEXT[b])
        if b in _SIZED:
            kind, fmt = _SIZED[b]
            n = self.unpack(fmt)
            if kind == "bin":
                return self.take(n) if self.views else bytes(self.take(n))
            if kind == "str":
                return self.str(n)
            if kind == "ext":
                return self.ext(n)
            if kind == "array":
                return [self.value() for _ in range(n)]
            return self.map(n)
        raise ValueError(f"msgpack: byte 0x{b:02x} at {self.pos - 1} starts no value")

    def str(self, n: int) -> str:
        return str(self.take(n), "utf-8")

    def map(self, n: int) -> Any:
        out = {}
        for _ in range(n):
            key = self.value()
            try:
                out[key] = self.value()
            except TypeError:
                raise ValueError(f"msgpack: unhashable map key before byte {self.pos}") \
                    from None
        return _unchunk(out) if _CHUNKED in out else out

    def ext(self, n: int) -> Any:
        code = self.unpack(">b")
        payload = self.take(n)
        if code == _EXT_NDARRAY:
            return _ndarray(payload)
        if code == _EXT_NPSCALAR:
            arr = _ndarray(payload)
            return arr.reshape(()) if isinstance(arr, torch.Tensor) else arr[()]
        if code == _EXT_COMPLEX:
            raise ValueError("msgpack: a complex leaf (flax ext type 2) is not a "
                             "model weight; refusing it")
        raise ValueError(f"msgpack: unknown ext type {code}")


def _ndarray(payload: memoryview):
    """flax's ``_ndarray_from_bytes``: ``(shape, dtype name, bytes)``."""
    inner = _Reader(payload, views=True)
    tpl = inner.value()
    if inner.pos != len(payload) or not isinstance(tpl, list) or len(tpl) != 3:
        raise ValueError("msgpack: malformed ndarray payload")
    shape, name, buf = tpl
    if isinstance(name, memoryview):
        name = str(name, "utf-8")
    if not (isinstance(shape, list) and all(isinstance(s, int) and s >= 0 for s in shape)
            and isinstance(name, str) and isinstance(buf, memoryview)):
        raise ValueError("msgpack: malformed ndarray payload")
    if name == "bfloat16":
        dtype = np.dtype(np.int16)
    else:
        try:
            dtype = np.dtype(name)
        except TypeError:
            raise ValueError(f"msgpack: unknown array dtype {name!r}") from None
    count = int(np.prod(shape, dtype=np.int64))
    if count * dtype.itemsize != len(buf):
        raise ValueError(f"msgpack: {len(buf)} bytes for a {name} array of shape "
                         f"{tuple(shape)}")
    arr = np.frombuffer(buf, dtype=dtype, count=count).reshape(shape)
    if name == "bfloat16":
        return torch.from_numpy(arr.copy()).view(torch.bfloat16)
    return arr


def _unchunk(node: dict):
    """flax's ``_unchunk``: join a chunked array's flattened pieces."""
    try:
        shape = [node["shape"][str(i)] for i in range(len(node["shape"]))]
        chunks = [node["chunks"][str(i)] for i in range(len(node["chunks"]))]
    except (KeyError, TypeError):
        raise ValueError("msgpack: malformed chunked array") from None
    if chunks and all(isinstance(c, torch.Tensor) for c in chunks):
        return torch.cat(chunks).reshape(shape)
    if not chunks or not all(isinstance(c, np.ndarray) for c in chunks):
        raise ValueError("msgpack: malformed chunked array")
    return np.concatenate(chunks).reshape(shape)


def msgpack_restore(data: bytes) -> Any:
    """Decode the bytes of ``flax.serialization.to_bytes`` (or
    ``msgpack_serialize``) into nested dicts of arrays, as flax's
    ``msgpack_restore`` does."""
    reader = _Reader(data)
    tree = reader.value()
    if reader.pos != len(reader.data):
        raise ValueError(f"msgpack: {len(reader.data) - reader.pos} bytes after the "
                         "top-level value")
    return tree


def load_msgpack(path: str) -> Any:
    """``msgpack_restore`` of a file's bytes."""
    with open(path, "rb") as f:
        return msgpack_restore(f.read())
