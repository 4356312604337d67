"""Pure-stdlib reader for flax ``.msgpack`` parameter snapshots.

The JAX package writes its snapshots with ``flax.serialization.to_bytes``:
a msgpack map tree whose leaves are msgpack *ext* records of type 1, each
holding a nested msgpack array ``[shape, dtype name, C-order bytes]``
(flax's ``_ndarray_to_bytes``). This module decodes that format with the
standard library and numpy only, so the port reads the committed weights
on a machine that has neither flax nor ``msgpack``.

Only what such snapshots use is supported. Any other ext code (flax's
complex and numpy-scalar records included) and flax's chunked-array
records raise, rather than decode to something the caller would
misread.
"""

from __future__ import annotations

import struct
from typing import Any, Tuple

import numpy as np

NDARRAY_EXT = 1  # flax serialization._MsgpackExtType.ndarray


class MsgpackFormatError(ValueError):
    """The bytes are not a msgpack tree this reader supports."""


def _ndarray(data: bytes) -> np.ndarray:
    shape, dtype_name, buf = unpackb(data)
    if isinstance(dtype_name, bytes):
        dtype_name = dtype_name.decode()
    try:
        dtype = np.dtype(dtype_name)
    except TypeError as e:
        raise MsgpackFormatError(
            f"ndarray record of unsupported dtype {dtype_name!r}") from e
    return np.frombuffer(buf, dtype=dtype).reshape(tuple(shape))


class _Reader:
    __slots__ = ("buf", "pos")

    def __init__(self, buf: bytes):
        self.buf = memoryview(buf)
        self.pos = 0

    def take(self, n: int) -> bytes:
        end = self.pos + n
        if end > len(self.buf):
            raise MsgpackFormatError("truncated msgpack data")
        out = self.buf[self.pos:end].tobytes()
        self.pos = end
        return out

    def unpack(self, fmt: str) -> Tuple:
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))

    def ext(self, size: int) -> Any:
        (code,) = self.unpack(">b")
        data = self.take(size)
        if code != NDARRAY_EXT:
            raise MsgpackFormatError(
                f"msgpack ext code {code} is not supported (only the flax "
                f"ndarray record, code {NDARRAY_EXT})")
        return _ndarray(data)

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        if "__msgpack_chunked_array__" in out:
            raise MsgpackFormatError(
                "flax chunked-array records are not supported")
        return out

    def value(self) -> Any:  # noqa: C901 - one branch per msgpack type
        (b,) = self.unpack(">B")
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
        if b == 0xC0:
            return None
        if b == 0xC2:
            return False
        if b == 0xC3:
            return True
        if b in (0xC4, 0xC5, 0xC6):  # bin 8/16/32
            (n,) = self.unpack({0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}[b])
            return self.take(n)
        if b in (0xC7, 0xC8, 0xC9):  # ext 8/16/32
            (n,) = self.unpack({0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}[b])
            return self.ext(n)
        if b == 0xCA:
            return self.unpack(">f")[0]
        if b == 0xCB:
            return self.unpack(">d")[0]
        ints = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in ints:
            return self.unpack(ints[b])[0]
        if 0xD4 <= b <= 0xD8:  # fixext 1/2/4/8/16
            return self.ext(1 << (b - 0xD4))
        if b in (0xD9, 0xDA, 0xDB):  # str 8/16/32
            (n,) = self.unpack({0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}[b])
            return self.take(n).decode()
        if b in (0xDC, 0xDD):  # array 16/32
            (n,) = self.unpack(">H" if b == 0xDC else ">I")
            return self.array(n)
        if b in (0xDE, 0xDF):  # map 16/32
            (n,) = self.unpack(">H" if b == 0xDE else ">I")
            return self.map(n)
        raise MsgpackFormatError(f"unknown msgpack type byte 0x{b:02x}")


def unpackb(data: bytes) -> Any:
    """Decode one msgpack object that spans all of ``data``."""
    r = _Reader(data)
    out = r.value()
    if r.pos != len(r.buf):
        raise MsgpackFormatError(
            f"{len(r.buf) - r.pos} trailing bytes after the msgpack object")
    return out


def msgpack_restore(data: bytes) -> dict:
    """Counterpart of ``flax.serialization.msgpack_restore`` for parameter
    snapshots: a nested dict with numpy array leaves (read-only views
    over ``data``)."""
    return unpackb(data)


def read_snapshot(path: str) -> dict:
    """Read a flax ``.msgpack`` snapshot file into a nested numpy dict."""
    with open(path, "rb") as f:
        return msgpack_restore(f.read())


def flatten(tree: dict, prefix: Tuple[str, ...] = ()) -> dict:
    """Nested dict -> {path tuple: leaf} (flax ``flatten_dict``'s shape)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out
