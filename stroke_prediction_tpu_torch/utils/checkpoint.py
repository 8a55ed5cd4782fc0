"""Checkpoint files in the JAX package's format (port of train/checkpoint.py).

A ``.model`` file is one msgpack map ``{"state": tree, "__config__": uint8
JSON bytes}`` as written by flax's ``serialization.msgpack_serialize``:
nested maps with sorted str keys, ndarray leaves as msgpack ext type 1
whose payload is itself msgpack ``(shape, dtype name, C-order bytes)``, numpy scalars as
ext type 3 with the same payload.  This module carries its own small msgpack
reader and writer for that subset, so neither msgpack nor flax is needed, and
files go both ways between the two packages.
"""

from __future__ import annotations

import json
import struct
from typing import Any, Dict, Optional, Tuple

import numpy as np

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3


# --------------------------------------------------------------------------
# msgpack writer
# --------------------------------------------------------------------------

def _pack_len(out: bytearray, n: int, fix: Optional[Tuple[int, int]],
              codes: Tuple[int, int, int]) -> None:
    """Header of a str / bin / array / map of length n: the fix form
    (base, limit) when it fits, else the 8-, 16- or 32-bit length form."""
    if fix is not None and n < fix[1]:
        out.append(fix[0] | n)
    elif codes[0] is not None and n < 1 << 8:
        out += struct.pack(">BB", codes[0], n)
    elif n < 1 << 16:
        out += struct.pack(">BH", codes[1], n)
    else:
        out += struct.pack(">BI", codes[2], n)


def _pack_int(out: bytearray, v: int) -> None:
    if 0 <= v < 128:
        out.append(v)
    elif -32 <= v < 0:
        out += struct.pack(">b", v)
    elif v >= 0:
        for code, fmt, lim in ((0xcc, ">BB", 1 << 8), (0xcd, ">BH", 1 << 16),
                               (0xce, ">BI", 1 << 32),
                               (0xcf, ">BQ", 1 << 64)):
            if v < lim:
                out += struct.pack(fmt, code, v)
                return
        raise OverflowError(v)
    else:
        for code, fmt, lim in ((0xd0, ">Bb", 1 << 7), (0xd1, ">Bh", 1 << 15),
                               (0xd2, ">Bi", 1 << 31),
                               (0xd3, ">Bq", 1 << 63)):
            if v >= -lim:
                out += struct.pack(fmt, code, v)
                return
        raise OverflowError(v)


def _pack_ext(out: bytearray, code: int, data: bytes) -> None:
    n = len(data)
    fixext = {1: 0xd4, 2: 0xd5, 4: 0xd6, 8: 0xd7, 16: 0xd8}
    if n in fixext:
        out.append(fixext[n])
    else:
        _pack_len(out, n, None, (0xc7, 0xc8, 0xc9))
    out += struct.pack(">b", code)
    out += data


def _ndarray_payload(arr: np.ndarray) -> bytes:
    if arr.dtype.hasobject or arr.dtype.names is not None:
        raise ValueError(f"cannot serialize dtype {arr.dtype}")
    return packb([list(arr.shape), arr.dtype.name, arr.tobytes("C")])


def _pack(out: bytearray, obj: Any) -> None:
    if obj is None:
        out.append(0xc0)
    elif obj is True or obj is False:
        out.append(0xc3 if obj else 0xc2)
    elif isinstance(obj, np.ndarray):
        _pack_ext(out, _EXT_NDARRAY, _ndarray_payload(obj))
    elif isinstance(obj, np.generic):
        _pack_ext(out, _EXT_NPSCALAR, _ndarray_payload(np.asarray(obj)))
    elif isinstance(obj, int):
        _pack_int(out, obj)
    elif isinstance(obj, float):
        out += struct.pack(">Bd", 0xcb, obj)
    elif isinstance(obj, str):
        b = obj.encode("utf-8")
        _pack_len(out, len(b), (0xa0, 32), (0xd9, 0xda, 0xdb))
        out += b
    elif isinstance(obj, (bytes, bytearray)):
        _pack_len(out, len(obj), None, (0xc4, 0xc5, 0xc6))
        out += obj
    elif isinstance(obj, (list, tuple)):
        _pack_len(out, len(obj), (0x90, 16), (None, 0xdc, 0xdd))
        for v in obj:
            _pack(out, v)
    elif isinstance(obj, dict):
        # flax flattens the tree before packing, which sorts the keys
        _pack_len(out, len(obj), (0x80, 16), (None, 0xde, 0xdf))
        for k, v in sorted(obj.items()):
            _pack(out, k)
            _pack(out, v)
    else:
        raise TypeError(f"cannot serialize {type(obj).__name__}")


def packb(obj: Any) -> bytes:
    out = bytearray()
    _pack(out, obj)
    return bytes(out)


# --------------------------------------------------------------------------
# msgpack reader
# --------------------------------------------------------------------------

class _Reader:
    def __init__(self, data: bytes):
        self.data, self.pos = memoryview(data), 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        b = bytes(self.data[self.pos:self.pos + n])
        self.pos += n
        return b

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def obj(self) -> Any:
        c = self.unpack(">B")
        if c <= 0x7f:
            return c
        if c >= 0xe0:
            return c - 0x100
        if 0x80 <= c <= 0x8f:
            return self.map(c & 0x0f)
        if 0x90 <= c <= 0x9f:
            return self.array(c & 0x0f)
        if 0xa0 <= c <= 0xbf:
            return self.take(c & 0x1f).decode("utf-8")
        simple = {0xc0: None, 0xc2: False, 0xc3: True}
        if c in simple:
            return simple[c]
        lens = {0xc4: ">B", 0xc5: ">H", 0xc6: ">I",      # bin
                0xd9: ">B", 0xda: ">H", 0xdb: ">I",      # str
                0xdc: ">H", 0xdd: ">I",                  # array
                0xde: ">H", 0xdf: ">I",                  # map
                0xc7: ">B", 0xc8: ">H", 0xc9: ">I"}      # ext
        if c in lens:
            n = self.unpack(lens[c])
            if c <= 0xc6:
                return self.take(n)
            if c <= 0xc9:
                return self.ext(n)
            if c <= 0xdb:
                return self.take(n).decode("utf-8")
            if c <= 0xdd:
                return self.array(n)
            return self.map(n)
        if 0xd4 <= c <= 0xd8:
            return self.ext(1 << (c - 0xd4))
        nums = {0xca: ">f", 0xcb: ">d", 0xcc: ">B", 0xcd: ">H", 0xce: ">I",
                0xcf: ">Q", 0xd0: ">b", 0xd1: ">h", 0xd2: ">i", 0xd3: ">q"}
        if c in nums:
            return self.unpack(nums[c])
        raise ValueError(f"unsupported msgpack type byte 0x{c:02x}")

    def array(self, n: int):
        return [self.obj() for _ in range(n)]

    def map(self, n: int):
        out = {}
        for _ in range(n):
            k = self.obj()
            out[k] = self.obj()
        return out

    def ext(self, n: int):
        code = self.unpack(">b")
        data = self.take(n)
        if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
            raise ValueError(f"unsupported msgpack ext type {code}")
        shape, name, buf = unpackb(data)
        name = name.decode() if isinstance(name, bytes) else name
        if name == "bfloat16":
            raise ValueError("bfloat16 checkpoint arrays are not supported")
        arr = np.frombuffer(buf, dtype=np.dtype(name)).reshape(shape).copy()
        return arr if code == _EXT_NDARRAY else arr[()]


def unpackb(data: bytes) -> Any:
    r = _Reader(data)
    obj = r.obj()
    if r.pos != len(r.data):
        raise ValueError("trailing bytes after msgpack object")
    return obj


# --------------------------------------------------------------------------
# checkpoint files
# --------------------------------------------------------------------------

def save_checkpoint(path: str, state: Dict[str, Any],
                    config: Optional[Dict[str, Any]] = None) -> None:
    """Write ``state`` (a tree of dicts with numpy leaves) and an optional
    JSON config header in the JAX package's ``.model`` format."""
    payload = {"state": state}
    if config is not None:
        payload["__config__"] = np.frombuffer(
            json.dumps(config).encode(), dtype=np.uint8).copy()
    with open(path, "wb") as f:
        f.write(packb(payload))


def load_checkpoint(path: str):
    """Returns (state tree with numpy leaves, config dict or None)."""
    with open(path, "rb") as f:
        payload = unpackb(f.read())
    config = None
    if "__config__" in payload:
        config = json.loads(payload["__config__"].tobytes().decode())
    return payload["state"], config


def save_curves(path: str, curves: Dict[str, Any]) -> None:
    """Metric curves as plain JSON, ``{"training": [epoch dict, ...],
    "validate": [...]}``, written as the JAX package writes them (float
    ``inf`` as JSON ``Infinity``)."""

    def default(o):
        if isinstance(o, (np.floating, np.integer)):
            return o.item()
        if isinstance(o, np.ndarray):
            return o.tolist()
        raise TypeError(type(o))

    with open(path, "w") as f:
        json.dump(curves, f, default=default)


def load_curves(path: str) -> Dict[str, Any]:
    with open(path, "r") as f:
        return json.load(f)
