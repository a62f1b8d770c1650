"""The flax msgpack checkpoint format, read and written without flax or
msgpack (neither is on the GPU host).

`flax.serialization.to_bytes` / `msgpack_serialize` write a tree of
string-keyed maps whose leaves are numpy arrays, each as msgpack ext type
1 holding a packed (shape, dtype name, C-order bytes) triple; a leaf over
2^30 bytes is first cut into a map {"__msgpack_chunked_array__": True,
"shape": {"0": n0, ...}, "chunks": {"0": flat chunk, ...}}.  This codec
writes exactly that (the same bytes as msgpack-python for the same tree)
and reads it back; any other msgpack type, ext code or dtype raises.
"""

from __future__ import annotations

import struct
from typing import Any, Dict, Tuple

import numpy as np

_EXT_NDARRAY = 1
MAX_CHUNK_SIZE = 2 ** 30  # flax.serialization.MAX_CHUNK_SIZE
_CHUNKED = "__msgpack_chunked_array__"


# ----------------------------------------------------------------------
# writing
# ----------------------------------------------------------------------
def _head(n: int, small: int, small_max: int, wide: Tuple[Tuple[int, str], ...]) -> bytes:
    """A length header: the fix form below small_max, else the first wide
    (marker, struct format) whose unsigned field holds n."""
    if small_max and n <= small_max:
        return bytes([small | n])
    for marker, fmt in wide:
        if n < 1 << (8 * struct.calcsize(fmt)):
            return bytes([marker]) + struct.pack(">" + fmt, n)
    raise ValueError(f"msgpack length {n} too large")


def _uint(n: int) -> bytes:
    if n < 0:
        raise ValueError(f"negative integer {n} is not in the checkpoint format")
    if n <= 0x7F:
        return bytes([n])
    return _head(n, 0, 0, ((0xCC, "B"), (0xCD, "H"), (0xCE, "I"), (0xCF, "Q")))


def _str(s: str) -> bytes:
    b = s.encode("utf-8")
    return _head(len(b), 0xA0, 31, ((0xD9, "B"), (0xDA, "H"), (0xDB, "I"))) + b


def _bin(b: bytes) -> bytes:
    return _head(len(b), 0, 0, ((0xC4, "B"), (0xC5, "H"), (0xC6, "I"))) + b


def _array_head(n: int) -> bytes:
    return _head(n, 0x90, 15, ((0xDC, "H"), (0xDD, "I")))


def _map_head(n: int) -> bytes:
    return _head(n, 0x80, 15, ((0xDE, "H"), (0xDF, "I")))


def _ext(code: int, data: bytes) -> bytes:
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    n = len(data)
    if n in fixed:
        head = bytes([fixed[n]])
    else:
        head = _head(n, 0, 0, ((0xC7, "B"), (0xC8, "H"), (0xC9, "I")))
    return head + struct.pack(">b", code) + data


def _ndarray(arr: np.ndarray) -> bytes:
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes are not in the checkpoint format")
    inner = (_array_head(3) + _array_head(arr.ndim) + b"".join(_uint(d) for d in arr.shape)
             + _str(arr.dtype.name) + _bin(arr.tobytes("C")))
    return _ext(_EXT_NDARRAY, inner)


def _chunk(arr: np.ndarray) -> Dict[str, Any]:
    """flax.serialization._chunk: the flat array cut into 2^30-byte chunks."""
    size = max(1, int(MAX_CHUNK_SIZE / arr.dtype.itemsize))
    flat = arr.reshape(-1)
    return {_CHUNKED: True,
            "shape": {str(i): d for i, d in enumerate(arr.shape)},
            "chunks": {str(i): flat[lo:lo + size]
                       for i, lo in enumerate(range(0, flat.size, size))}}


def _pack(x) -> bytes:
    if isinstance(x, dict):
        out = [_map_head(len(x))]
        for k, v in x.items():
            if not isinstance(k, str):
                raise TypeError(f"checkpoint keys are strings, got {k!r}")
            out += [_str(k), _pack(v)]
        return b"".join(out)
    if isinstance(x, np.ndarray):
        if x.size * x.dtype.itemsize > MAX_CHUNK_SIZE:
            return _pack(_chunk(x))
        return _ndarray(x)
    if x is True:
        return b"\xc3"
    if isinstance(x, int) and not isinstance(x, bool):
        return _uint(x)
    raise TypeError(f"{type(x).__name__} is not in the checkpoint format")


def pack(tree: Dict[str, Any]) -> bytes:
    """flax.serialization.msgpack_serialize of a tree of str-keyed dicts
    with numpy array leaves."""
    return _pack(tree)


# ----------------------------------------------------------------------
# reading
# ----------------------------------------------------------------------
class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack checkpoint")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unsigned(self, fmt: str) -> int:
        return struct.unpack(">" + fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self):
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self.text(b & 0x1F)
        if b == 0xC0:
            return None
        if b in (0xC2, 0xC3):
            return b == 0xC3
        sized = {0xC4: ("bin", "B"), 0xC5: ("bin", "H"), 0xC6: ("bin", "I"),
                 0xC7: ("ext", "B"), 0xC8: ("ext", "H"), 0xC9: ("ext", "I"),
                 0xCC: ("uint", "B"), 0xCD: ("uint", "H"), 0xCE: ("uint", "I"),
                 0xCF: ("uint", "Q"), 0xD9: ("str", "B"), 0xDA: ("str", "H"),
                 0xDB: ("str", "I"), 0xDC: ("array", "H"), 0xDD: ("array", "I"),
                 0xDE: ("map", "H"), 0xDF: ("map", "I")}
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixext:
            return self.ext(fixext[b])
        if b in sized:
            kind, fmt = sized[b]
            n = self.unsigned(fmt)
            if kind == "uint":
                return n
            if kind == "bin":
                return bytes(self.take(n))
            return getattr(self, {"str": "text"}.get(kind, kind))(n)
        raise ValueError(f"msgpack type 0x{b:02x} is not in the checkpoint format")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def text(self, n: int) -> str:
        return bytes(self.take(n)).decode("utf-8")

    def ext(self, n: int) -> np.ndarray:
        code = struct.unpack(">b", self.take(1))[0]
        data = bytes(self.take(n))
        if code != _EXT_NDARRAY:
            raise ValueError(f"msgpack ext type {code} is not in the checkpoint format "
                             "(only ndarrays, ext type 1)")
        inner = _Reader(data)
        triple = inner.value()
        if (not isinstance(triple, list) or len(triple) != 3 or inner.pos != len(data)
                or not isinstance(triple[1], str) or not isinstance(triple[2], bytes)):
            raise ValueError("malformed ndarray in the msgpack checkpoint")
        shape, name, buf = triple
        try:
            dtype = np.dtype(name)
        except TypeError as e:
            raise ValueError(f"dtype {name!r} is not in the checkpoint format") from e
        return np.frombuffer(buf, dtype=dtype).reshape(shape).copy()


def _unchunk(x):
    if isinstance(x, dict):
        if x.get(_CHUNKED) is True:
            shape = tuple(x["shape"][str(i)] for i in range(len(x["shape"])))
            chunks = [x["chunks"][str(i)] for i in range(len(x["chunks"]))]
            return np.concatenate(chunks).reshape(shape)
        return {k: _unchunk(v) for k, v in x.items()}
    return x


def unpack(data: bytes) -> Dict[str, Any]:
    """flax.serialization.msgpack_restore: the tree of dicts with numpy
    array leaves."""
    r = _Reader(data)
    tree = r.value()
    if r.pos != len(r.data):
        raise ValueError("trailing bytes after the msgpack checkpoint")
    return _unchunk(tree)
