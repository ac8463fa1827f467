"""A pure-Python reader and writer of the msgpack subset that the JAX
package's checkpoints use (``flax.serialization.to_bytes`` /
``from_bytes``): the port's checkpoint format, readable and writable
without the ``msgpack`` or ``flax`` packages.

Written from the msgpack specification
(https://github.com/msgpack/msgpack/blob/master/spec.md).  The subset:

- maps (keys in insertion order), arrays, nil, bool, int (up to 64 bits),
  float (32 and 64 bits; written as 64), str (UTF-8) and bin;
- ext type 1, an ndarray: its payload is itself msgpack, the array
  ``[shape, dtype name, raw C-order bytes]``;
- ext type 2, a Python complex: the array ``[real, imag]``;
- ext type 3, a numpy scalar: an ndarray payload of shape ``[]``;
- chunked leaves: an array over :data:`MAX_CHUNK_SIZE` bytes is written as
  the map ``{"__msgpack_chunked_array__": True, "shape": {"0": d0, ...},
  "chunks": {"0": flat piece, ...}}`` and read back as one array.

The writer encodes each value as the ``msgpack`` package does under flax's
settings (``use_bin_type=True``, the smallest integer, str and container
forms, floats as float 64), so a tree of numpy arrays gives flax's bytes.

Leaves read back as numpy arrays (``np.frombuffer`` copies), except
``bfloat16``, which numpy lacks: it reads back as a ``torch.bfloat16``
tensor.  The writer takes numpy arrays and scalars, and ``bfloat16``
tensors.  Truncated or malformed input raises
``ValueError``; a value the writer cannot encode raises ``TypeError``.
"""

from __future__ import annotations

import math
import struct
from typing import Any, Mapping

import numpy as np
import torch

MAX_CHUNK_SIZE = 2**30  # bytes of the largest leaf written whole (flax's)
CHUNKED = "__msgpack_chunked_array__"
EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3
MAX_DEPTH = 100  # containers nested deeper are refused (a checkpoint nests ~10)


# ---- writing ----

def _pack_int(v: int, out: bytearray) -> None:
    if 0 <= v < 0x80:
        out.append(v)
    elif -0x20 <= v < 0:
        out.append(v & 0xFF)
    elif v >= 0:
        for code, fmt, top in ((0xCC, ">B", 1 << 8), (0xCD, ">H", 1 << 16),
                               (0xCE, ">I", 1 << 32), (0xCF, ">Q", 1 << 64)):
            if v < top:
                out.append(code)
                out += struct.pack(fmt, v)
                return
        raise TypeError(f"integer {v} does not fit msgpack's 64 bits")
    else:
        for code, fmt, low in ((0xD0, ">b", -(1 << 7)), (0xD1, ">h", -(1 << 15)),
                               (0xD2, ">i", -(1 << 31)), (0xD3, ">q", -(1 << 63))):
            if v >= low:
                out.append(code)
                out += struct.pack(fmt, v)
                return
        raise TypeError(f"integer {v} does not fit msgpack's 64 bits")


def _pack_header(n: int, fix: int, fix_max: int, codes, out: bytearray) -> None:
    """A length header: the fix form below ``fix_max``, else the first of
    ``codes`` ((code, struct format, limit), ...) that holds ``n``."""
    if n < fix_max:
        out.append(fix | n)
        return
    for code, fmt, top in codes:
        if n < top:
            out.append(code)
            out += struct.pack(fmt, n)
            return
    raise TypeError(f"a msgpack object of length {n} is too long")


_STR = ((0xD9, ">B", 1 << 8), (0xDA, ">H", 1 << 16), (0xDB, ">I", 1 << 32))
_BIN = ((0xC4, ">B", 1 << 8), (0xC5, ">H", 1 << 16), (0xC6, ">I", 1 << 32))
_ARRAY = ((0xDC, ">H", 1 << 16), (0xDD, ">I", 1 << 32))
_MAP = ((0xDE, ">H", 1 << 16), (0xDF, ">I", 1 << 32))
_FIXEXT = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
_EXT = ((0xC7, ">B", 1 << 8), (0xC8, ">H", 1 << 16), (0xC9, ">I", 1 << 32))


def _pack_ext(code: int, data: bytes, out: bytearray) -> None:
    if len(data) in _FIXEXT:
        out.append(_FIXEXT[len(data)])
    else:
        _pack_header(len(data), 0, 0, _EXT, out)
    out += struct.pack(">b", code)
    out += data


def _array_payload(arr) -> bytes:
    """The ndarray ext payload ``[shape, dtype name, bytes]`` of a numpy
    array or a ``bfloat16`` tensor (numpy has no bfloat16)."""
    if isinstance(arr, torch.Tensor):
        if arr.dtype != torch.bfloat16:
            raise TypeError(f"a {arr.dtype} tensor: only bfloat16 leaves are written as tensors, "
                            "the others as numpy arrays")
        t = arr.detach().cpu().contiguous()
        return packb([list(t.shape), "bfloat16", t.view(torch.int16).numpy().tobytes()])
    if arr.dtype.hasobject or arr.dtype.fields is not None:
        raise TypeError(f"object and structured dtypes are not written ({arr.dtype})")
    return packb([list(arr.shape), arr.dtype.name, arr.tobytes("C")])


def _pack(obj, out: bytearray, depth: int) -> None:
    if depth > MAX_DEPTH:
        raise TypeError("the tree is nested too deeply")
    if obj is None:
        out.append(0xC0)
    elif obj is True or obj is False:
        out.append(0xC3 if obj else 0xC2)
    elif isinstance(obj, int) and not isinstance(obj, np.generic):
        _pack_int(int(obj), out)
    elif isinstance(obj, float) and not isinstance(obj, np.generic):
        out.append(0xCB)
        out += struct.pack(">d", obj)
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        _pack_header(len(data), 0xA0, 32, _STR, out)
        out += data
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        data = bytes(obj)
        _pack_header(len(data), 0, 0, _BIN, out)
        out += data
    elif isinstance(obj, Mapping):
        _pack_header(len(obj), 0x80, 16, _MAP, out)
        for k, v in obj.items():
            if not isinstance(k, (str, int)):
                raise TypeError(f"map keys are str or int, not {type(k).__name__}")
            _pack(k, out, depth + 1)
            _pack(v, out, depth + 1)
    elif isinstance(obj, (list, tuple)):
        _pack_header(len(obj), 0x90, 16, _ARRAY, out)
        for v in obj:
            _pack(v, out, depth + 1)
    elif isinstance(obj, (np.ndarray, torch.Tensor)):
        _pack_ext(EXT_NDARRAY, _array_payload(obj), out)
    elif isinstance(obj, np.generic):
        _pack_ext(EXT_NPSCALAR, _array_payload(np.asarray(obj)), out)
    elif isinstance(obj, complex):
        _pack_ext(EXT_COMPLEX, packb([obj.real, obj.imag]), out)
    else:
        raise TypeError(f"cannot write a {type(obj).__name__} as msgpack")


def packb(obj) -> bytes:
    """``obj`` as msgpack bytes (no chunking: see :func:`to_bytes`)."""
    out = bytearray()
    _pack(obj, out, 0)
    return bytes(out)


def _nbytes(leaf) -> int:
    if isinstance(leaf, torch.Tensor):
        return leaf.numel() * leaf.element_size()
    return leaf.nbytes


def _chunk(leaf) -> dict:
    """flax's chunked form of an array leaf: flat pieces of at most
    :data:`MAX_CHUNK_SIZE` bytes."""
    itemsize = leaf.element_size() if isinstance(leaf, torch.Tensor) else leaf.dtype.itemsize
    size = max(1, int(MAX_CHUNK_SIZE / itemsize))
    flat = leaf.reshape(-1)
    pieces = [flat[i:i + size] for i in range(0, flat.shape[0], size)]
    return {CHUNKED: True, "shape": {str(i): int(d) for i, d in enumerate(leaf.shape)},
            "chunks": {str(i): p for i, p in enumerate(pieces)}}


def _chunk_leaves(node):
    if isinstance(node, (np.ndarray, torch.Tensor)):
        return _chunk(node) if _nbytes(node) > MAX_CHUNK_SIZE else node
    if isinstance(node, Mapping):
        return {k: _chunk_leaves(v) for k, v in node.items()}
    return node


def to_bytes(tree) -> bytes:
    """A tree of maps and array leaves as flax's checkpoint bytes
    (``flax.serialization.msgpack_serialize``): leaves over
    :data:`MAX_CHUNK_SIZE` bytes written in chunks."""
    return packb(_chunk_leaves(tree))


# ---- reading ----

class _Reader:
    def __init__(self, data):
        self.data = memoryview(data).cast("B")
        self.pos = 0

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if n < 0 or end > len(self.data):
            raise ValueError(f"msgpack data truncated: {n} bytes wanted at offset {self.pos} "
                             f"of {len(self.data)}")
        out = self.data[self.pos:end]
        self.pos = end
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def count(self, n: int, per: int) -> int:
        """A container's element count ``n``, each of at least ``per``
        bytes, refused where the rest of the data cannot hold them."""
        if n * per > len(self.data) - self.pos:
            raise ValueError(f"msgpack data truncated: {n} elements claimed at offset "
                             f"{self.pos} of {len(self.data)}")
        return n

    def value(self, depth: int = 0):
        if depth > MAX_DEPTH:
            raise ValueError("msgpack data nested too deeply")
        b = self.unpack(">B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F, depth)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F, depth)
        if 0xA0 <= b <= 0xBF:
            return self.str(b & 0x1F)
        if b == 0xC0:
            return None
        if b in (0xC2, 0xC3):
            return b == 0xC3
        if b in (0xC4, 0xC5, 0xC6):
            return bytes(self.take(self.unpack({0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}[b])))
        if b in (0xC7, 0xC8, 0xC9):
            return self.ext(self.unpack({0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}[b]))
        if b == 0xCA:
            return self.unpack(">f")
        if b == 0xCB:
            return self.unpack(">d")
        if 0xCC <= b <= 0xD3:
            return self.unpack((">B", ">H", ">I", ">Q", ">b", ">h", ">i", ">q")[b - 0xCC])
        if 0xD4 <= b <= 0xD8:
            return self.ext(1 << (b - 0xD4))
        if b in (0xD9, 0xDA, 0xDB):
            return self.str(self.unpack({0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}[b]))
        if b in (0xDC, 0xDD):
            return self.array(self.unpack(">H" if b == 0xDC else ">I"), depth)
        if b in (0xDE, 0xDF):
            return self.map(self.unpack(">H" if b == 0xDE else ">I"), depth)
        raise ValueError(f"msgpack byte 0x{b:02x} at offset {self.pos - 1} is never used")

    def str(self, n: int) -> str:
        try:
            return str(self.take(n), "utf-8")
        except UnicodeDecodeError as err:
            raise ValueError(f"msgpack str is not UTF-8: {err}") from None

    def array(self, n: int, depth: int) -> list:
        return [self.value(depth + 1) for _ in range(self.count(n, 1))]

    def map(self, n: int, depth: int) -> dict:
        out = {}
        for _ in range(self.count(n, 2)):
            key = self.value(depth + 1)
            if isinstance(key, (list, dict)):
                raise ValueError(f"msgpack map key of type {type(key).__name__}")
            out[key] = self.value(depth + 1)
        return out

    def ext(self, n: int):
        code = self.unpack(">b")
        data = self.take(n)
        if code == EXT_NDARRAY:
            return _array_from_payload(data)
        if code == EXT_NPSCALAR:
            arr = _array_from_payload(data)
            if arr.ndim:
                raise ValueError(f"a msgpack numpy scalar of shape {tuple(arr.shape)}")
            return arr if isinstance(arr, torch.Tensor) else arr[()]
        if code == EXT_COMPLEX:
            parts = unpackb(data)
            if (not isinstance(parts, list) or len(parts) != 2
                    or not all(isinstance(x, (int, float)) for x in parts)):
                raise ValueError(f"a msgpack complex payload {parts!r}")
            return complex(parts[0], parts[1])
        raise ValueError(f"msgpack ext type {code} is not one of flax's")


def _array_from_payload(data):
    """An ndarray ext payload as a numpy array (``bfloat16``: a torch tensor)."""
    payload = unpackb(data)
    if not (isinstance(payload, list) and len(payload) == 3):
        raise ValueError("an ndarray payload is not [shape, dtype, bytes]")
    shape, name, raw = payload
    if not (isinstance(shape, list) and all(isinstance(d, int) and not isinstance(d, bool)
                                            and d >= 0 for d in shape)):
        raise ValueError(f"an ndarray payload's shape {shape!r}")
    if isinstance(name, bytes):
        name = name.decode("ascii", "replace")
    if not isinstance(name, str) or not isinstance(raw, bytes):
        raise ValueError("an ndarray payload's dtype name or bytes")
    if name == "bfloat16":
        dtype = np.dtype(np.int16)
    else:
        try:
            dtype = np.dtype(name)
        except TypeError:
            raise ValueError(f"an ndarray payload's dtype {name!r}") from None
        if dtype.hasobject or dtype.fields is not None or dtype.itemsize == 0:
            raise ValueError(f"an ndarray payload's dtype {name!r}")
    if math.prod(shape) * dtype.itemsize != len(raw):
        raise ValueError(f"an ndarray payload of shape {shape} and dtype {name} holds "
                         f"{len(raw)} bytes")
    arr = np.frombuffer(raw, dtype=dtype).reshape(shape).copy()
    return torch.from_numpy(arr).view(torch.bfloat16) if name == "bfloat16" else arr


def unpackb(data):
    """The one msgpack object that ``data`` holds (no unchunking: see
    :func:`from_bytes`); ``ValueError`` where it is truncated, malformed or
    followed by more bytes."""
    reader = _Reader(data)
    out = reader.value()
    if reader.pos != len(reader.data):
        raise ValueError(f"{len(reader.data) - reader.pos} bytes after the msgpack object")
    return out


def _unchunk(node: dict):
    try:
        shape = tuple(node["shape"][str(i)] for i in range(len(node["shape"])))
        chunks = [node["chunks"][str(i)] for i in range(len(node["chunks"]))]
    except (KeyError, TypeError):
        raise ValueError("a malformed chunked array") from None
    if not chunks or not all(isinstance(c, (np.ndarray, torch.Tensor)) and c.ndim == 1
                             for c in chunks):
        raise ValueError("a chunked array's chunks are not flat arrays")
    flat = (torch.cat(chunks) if isinstance(chunks[0], torch.Tensor)
            else np.concatenate(chunks))
    if not all(isinstance(d, int) and d >= 0 for d in shape) or math.prod(shape) != flat.shape[0]:
        raise ValueError(f"a chunked array of shape {shape} holds {flat.shape[0]} elements")
    return flat.reshape(shape)


def _unchunk_leaves(node):
    if isinstance(node, dict):
        if CHUNKED in node:
            return _unchunk(node)
        return {k: _unchunk_leaves(v) for k, v in node.items()}
    return node


def from_bytes(data) -> Any:
    """The tree that :func:`to_bytes` or ``flax.serialization.to_bytes``
    wrote, its chunked leaves joined again."""
    return _unchunk_leaves(unpackb(data))
