"""Parameter files in flax's msgpack layout, in pure Python (PyTorch port of
``save_params`` and ``load_params`` in ``moc_tpu/utils/checkpoint.py``).

The JAX package writes its best SENets as ``best_model_*.msgpack`` through
``flax.serialization.to_bytes``; the GPU's host has neither flax nor
msgpack, so this module reads and writes that layout itself:

* a tree of ``dict`` with ``str`` keys, in insertion order, as msgpack maps;
* ``str``, ``bytes``, ``int``, ``float``, ``None`` and ``bool`` leaves in the
  smallest msgpack form that msgpack-python picks (``str`` as str, ``bytes``
  as bin, floats as float 64);
* arrays as extension type 1, whose payload is itself msgpack: the array
  ``(shape, dtype name, C-order bytes)``.

A file written here is byte-equal to ``to_bytes`` of the same tree. Other
extension types (2, a complex; 3, a numpy scalar), chunked arrays (flax
splits arrays past 2**30 bytes) and bfloat16 arrays raise, naming what
they found.
"""

from __future__ import annotations

import os
import struct
from typing import Any, Mapping

import numpy as np
import torch

EXT_NDARRAY = 1
_EXT_NAMES = {2: "a native complex", 3: "a numpy scalar"}
MAX_CHUNK_SIZE = 2 ** 30  # flax chunks arrays past this many bytes
_CHUNKED = "__msgpack_chunked_array__"


# ------------------------------------------------------------------ writing

def _pack_int(x: int, out: bytearray) -> None:
    if 0 <= x < 0x80:
        out.append(x)
    elif -0x20 <= x < 0:
        out.append(x & 0xFF)
    elif 0 <= x <= 0xFF:
        out += b"\xcc" + struct.pack(">B", x)
    elif 0 <= x <= 0xFFFF:
        out += b"\xcd" + struct.pack(">H", x)
    elif 0 <= x <= 0xFFFFFFFF:
        out += b"\xce" + struct.pack(">I", x)
    elif 0 <= x <= 0xFFFFFFFFFFFFFFFF:
        out += b"\xcf" + struct.pack(">Q", x)
    elif -0x80 <= x:
        out += b"\xd0" + struct.pack(">b", x)
    elif -0x8000 <= x:
        out += b"\xd1" + struct.pack(">h", x)
    elif -0x80000000 <= x:
        out += b"\xd2" + struct.pack(">i", x)
    elif -0x8000000000000000 <= x:
        out += b"\xd3" + struct.pack(">q", x)
    else:
        raise OverflowError(f"integer {x} does not fit msgpack's 64 bits")


def _pack_len(n: int, fix: int | None, fix_max: int, codes: tuple, out: bytearray) -> None:
    """A length header: the fix form (``fix | n``) below ``fix_max``, else the
    8-, 16- or 32-bit form of ``codes`` (None where msgpack has no such form)."""
    if fix is not None and n < fix_max:
        out.append(fix | n)
    elif codes[0] is not None and n <= 0xFF:
        out += bytes([codes[0]]) + struct.pack(">B", n)
    elif n <= 0xFFFF:
        out += bytes([codes[1]]) + struct.pack(">H", n)
    elif n <= 0xFFFFFFFF:
        out += bytes([codes[2]]) + struct.pack(">I", n)
    else:
        raise ValueError(f"msgpack cannot hold a length of {n}")


def _pack_ext(code: int, data: bytes, out: bytearray) -> None:
    fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if len(data) in fixext:
        out.append(fixext[len(data)])
    else:
        _pack_len(len(data), None, 0, (0xC7, 0xC8, 0xC9), out)
    out += struct.pack(">b", code) + data


def _ndarray_payload(arr: np.ndarray) -> bytes:
    name = arr.dtype.name
    if arr.dtype.hasobject or arr.dtype.isalignedstruct or arr.dtype.names:
        raise ValueError(f"cannot write an array of dtype {arr.dtype}")
    if name == "bfloat16" or "V" in arr.dtype.str:
        raise ValueError(f"cannot write a {name} array: only numpy's own dtypes are supported")
    if arr.nbytes > MAX_CHUNK_SIZE:
        raise ValueError(f"an array of {arr.nbytes} bytes would be chunked by flax "
                         f"(past {MAX_CHUNK_SIZE}); chunked arrays are not supported")
    out = bytearray()
    _pack_value((tuple(int(d) for d in arr.shape), name, arr.tobytes("C")), out)
    return bytes(out)


def _pack_value(x: Any, out: bytearray) -> None:
    if x is None:
        out.append(0xC0)
    elif x is True or x is False:
        out.append(0xC3 if x else 0xC2)
    elif isinstance(x, int) and not isinstance(x, bool):
        _pack_int(x, out)
    elif isinstance(x, float):
        out += b"\xcb" + struct.pack(">d", x)
    elif isinstance(x, str):
        data = x.encode("utf-8")
        _pack_len(len(data), 0xA0, 32, (0xD9, 0xDA, 0xDB), out)
        out += data
    elif isinstance(x, (bytes, bytearray, memoryview)):
        data = bytes(x)
        _pack_len(len(data), None, 0, (0xC4, 0xC5, 0xC6), out)
        out += data
    elif isinstance(x, (tuple, list)):
        _pack_len(len(x), 0x90, 16, (None, 0xDC, 0xDD), out)
        for v in x:
            _pack_value(v, out)
    elif isinstance(x, Mapping):
        _pack_len(len(x), 0x80, 16, (None, 0xDE, 0xDF), out)
        for k, v in x.items():
            _pack_value(str(k), out)
            _pack_value(v, out)
    elif isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            raise ValueError("cannot write a bfloat16 tensor: only numpy's own dtypes are "
                             "supported")
        _pack_ext(EXT_NDARRAY, _ndarray_payload(x.detach().cpu().numpy()), out)
    elif isinstance(x, np.ndarray):
        _pack_ext(EXT_NDARRAY, _ndarray_payload(x), out)
    else:
        raise TypeError(f"cannot write a {type(x).__name__} in flax's msgpack layout")


def to_bytes(tree: Mapping) -> bytes:
    """The bytes ``flax.serialization.to_bytes`` gives for ``tree`` (nested
    dicts of arrays and Python scalars; tensors are written as arrays)."""
    out = bytearray()
    _pack_value(tree, out)
    return bytes(out)


def save_params(path: str, params: Mapping) -> str:
    """Write ``params`` to ``path`` in flax's msgpack layout."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(to_bytes(params))
    return path


# ------------------------------------------------------------------ reading

class _Reader:
    def __init__(self, data: bytes):
        self.data, self.pos = memoryview(data), 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos:self.pos + n].tobytes()
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self) -> Any:
        b = self.take(1)[0]
        if b < 0x80:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.value() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self.take(b & 0x1F).decode("utf-8")
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        ints = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q", 0xCA: ">f", 0xCB: ">d"}
        if b in ints:
            return self.unpack(ints[b])
        sizes = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}
        if b in sizes:
            return self.take(self.unpack(sizes[b])).decode("utf-8")
        sizes = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}
        if b in sizes:
            return self.take(self.unpack(sizes[b]))
        if b in (0xDC, 0xDD):
            return [self.value() for _ in range(self.unpack(">H" if b == 0xDC else ">I"))]
        if b in (0xDE, 0xDF):
            return self.map(self.unpack(">H" if b == 0xDE else ">I"))
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixext:
            return self.ext(fixext[b])
        sizes = {0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}
        if b in sizes:
            return self.ext(self.unpack(sizes[b]))
        raise ValueError(f"byte 0x{b:02x} starts no msgpack value")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        if _CHUNKED in out:
            raise ValueError("a chunked array (flax splits arrays past 2**30 bytes) is not "
                             "supported")
        return out

    def ext(self, n: int) -> np.ndarray:
        code = self.unpack(">b")
        data = self.take(n)
        if code != EXT_NDARRAY:
            what = _EXT_NAMES.get(code, "an unknown extension")
            raise ValueError(f"msgpack extension type {code} ({what}) is not supported; "
                             "only arrays (type 1)")
        inner = _Reader(data)
        shape, name, buf = inner.value()
        if isinstance(name, bytes):
            name = name.decode()
        if name == "bfloat16":
            raise ValueError("a bfloat16 array is not supported (numpy has no bfloat16)")
        return np.frombuffer(buf, dtype=np.dtype(name)).reshape(shape).copy()


def from_bytes(data: bytes) -> Any:
    """The tree that ``flax.serialization.msgpack_restore`` gives for ``data``:
    dicts, Python scalars and numpy arrays."""
    reader = _Reader(data)
    out = reader.value()
    if reader.pos != len(reader.data):
        raise ValueError(f"{len(reader.data) - reader.pos} bytes after the msgpack value")
    return out


def load_params(path: str) -> Any:
    """The tree of a file in flax's msgpack layout (``best_model_*.msgpack``)."""
    with open(path, "rb") as f:
        return from_bytes(f.read())
