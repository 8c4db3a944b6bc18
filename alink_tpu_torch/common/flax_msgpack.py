"""Decoder and encoder for the msgpack subset that ``flax.serialization``
writes, so a model table written by ``alink_tpu`` is servable here, and the
reverse, without the ``msgpack`` or ``flax`` packages.

``flax.serialization.to_bytes(tree)`` packs the parameter tree as nested maps
with ``str`` keys. Each array leaf is msgpack ext type 1 whose payload is
itself msgpack: the array ``(shape, dtype_name, C-order bytes)``. Numpy
scalars are ext type 3 with the same payload. Arrays above flax's chunk limit
(2**30 bytes) are stored as maps marked ``__msgpack_chunked_array__``; they
are reassembled on decode.

The encoder follows msgpack-python's choice of the smallest format for every
value, so ``dumps(loads(b)) == b`` for the trees flax writes. ``bfloat16``
leaves decode to ``float32`` arrays holding the same values (numpy has no
bfloat16); the encoder writes ``float32`` for them.
"""

from __future__ import annotations

import struct
from typing import Any, Dict, Tuple

import numpy as np

from .exceptions import AkParseErrorException

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3
_CHUNK_KEY = "__msgpack_chunked_array__"


# ---------------------------------------------------------------------------
# decoding
# ---------------------------------------------------------------------------


class _Reader:
    def __init__(self, buf):
        self.buf = memoryview(buf)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise AkParseErrorException("truncated msgpack data")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]


def _decode(r: _Reader, raw: bool) -> Any:
    b = r.take(1)[0]
    if b <= 0x7F:
        return b
    if b >= 0xE0:
        return b - 0x100
    if 0x80 <= b <= 0x8F:
        return _decode_map(r, b & 0x0F, raw)
    if 0x90 <= b <= 0x9F:
        return _decode_array(r, b & 0x0F, raw)
    if 0xA0 <= b <= 0xBF:
        return _decode_str(r, b & 0x1F, raw)
    if b == 0xC0:
        return None
    if b == 0xC2:
        return False
    if b == 0xC3:
        return True
    if b in (0xC4, 0xC5, 0xC6):
        n = r.unpack({0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}[b])
        return r.take(n)
    if b in (0xC7, 0xC8, 0xC9):
        n = r.unpack({0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}[b])
        code = r.unpack(">b")
        return _decode_ext(code, r.take(n))
    if b == 0xCA:
        return r.unpack(">f")
    if b == 0xCB:
        return r.unpack(">d")
    if 0xCC <= b <= 0xD3:
        fmt = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
               0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}[b]
        return r.unpack(fmt)
    if 0xD4 <= b <= 0xD8:
        n = 1 << (b - 0xD4)
        code = r.unpack(">b")
        return _decode_ext(code, r.take(n))
    if b in (0xD9, 0xDA, 0xDB):
        n = r.unpack({0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}[b])
        return _decode_str(r, n, raw)
    if b in (0xDC, 0xDD):
        return _decode_array(r, r.unpack(">H" if b == 0xDC else ">I"), raw)
    if b in (0xDE, 0xDF):
        return _decode_map(r, r.unpack(">H" if b == 0xDE else ">I"), raw)
    raise AkParseErrorException(f"unsupported msgpack type byte 0x{b:02x}")


def _decode_str(r: _Reader, n: int, raw: bool):
    data = r.take(n)
    return bytes(data) if raw else str(data, "utf-8")


def _decode_array(r: _Reader, n: int, raw: bool) -> list:
    return [_decode(r, raw) for _ in range(n)]


def _decode_map(r: _Reader, n: int, raw: bool) -> dict:
    out = {}
    for _ in range(n):
        k = _decode(r, raw)
        out[k] = _decode(r, raw)
    return out


def _bf16_to_f32(bits: np.ndarray) -> np.ndarray:
    return (bits.astype(np.uint32) << 16).view(np.float32)


def _decode_ndarray(payload) -> np.ndarray:
    # flax unpacks the payload with raw=True: the dtype name is bytes
    r = _Reader(payload)
    shape, dtype_name, data = _decode(r, raw=True)
    name = dtype_name.decode() if isinstance(dtype_name, bytes) else dtype_name
    if name == "bfloat16":
        arr = _bf16_to_f32(np.frombuffer(data, dtype="<u2"))
    else:
        arr = np.frombuffer(data, dtype=np.dtype(name)).copy()
    return arr.reshape(tuple(shape), order="C")


def _decode_ext(code: int, payload):
    if code == _EXT_NDARRAY:
        return _decode_ndarray(payload)
    if code == _EXT_NPSCALAR:
        return _decode_ndarray(payload)[()]
    raise AkParseErrorException(f"unsupported msgpack ext type {code}")


def _unchunk(tree):
    if not isinstance(tree, dict):
        return tree
    if tree.get(_CHUNK_KEY) is True:
        shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def loads(data) -> Dict[str, Any]:
    """Decode ``flax.serialization.to_bytes`` output into a nested dict of
    numpy arrays."""
    r = _Reader(data)
    tree = _decode(r, raw=False)
    if r.pos != len(r.buf):
        raise AkParseErrorException(
            f"{len(r.buf) - r.pos} trailing bytes after msgpack data")
    return _unchunk(tree)


# ---------------------------------------------------------------------------
# encoding
# ---------------------------------------------------------------------------


def _sized(out: list, n: int, fix_base: int, fix_max: int,
           codes: Tuple[Tuple[int, int, str], ...]) -> None:
    if fix_base is not None and n <= fix_max:
        out.append(bytes([fix_base | n]))
        return
    for code, limit, fmt in codes:
        if n <= limit:
            out.append(bytes([code]) + struct.pack(fmt, n))
            return
    raise AkParseErrorException(f"msgpack object too large ({n})")


_STR = ((0xD9, 0xFF, ">B"), (0xDA, 0xFFFF, ">H"), (0xDB, 0xFFFFFFFF, ">I"))
_BIN = ((0xC4, 0xFF, ">B"), (0xC5, 0xFFFF, ">H"), (0xC6, 0xFFFFFFFF, ">I"))
_ARR = ((0xDC, 0xFFFF, ">H"), (0xDD, 0xFFFFFFFF, ">I"))
_MAP = ((0xDE, 0xFFFF, ">H"), (0xDF, 0xFFFFFFFF, ">I"))


def _encode_int(out: list, v: int) -> None:
    if 0 <= v <= 0x7F:
        out.append(bytes([v]))
    elif -32 <= v < 0:
        out.append(struct.pack(">b", v))
    elif v > 0:
        for code, limit, fmt in ((0xCC, 0xFF, ">B"), (0xCD, 0xFFFF, ">H"),
                                 (0xCE, 0xFFFFFFFF, ">I"),
                                 (0xCF, 0xFFFFFFFFFFFFFFFF, ">Q")):
            if v <= limit:
                out.append(bytes([code]) + struct.pack(fmt, v))
                return
        raise AkParseErrorException(f"integer {v} too large for msgpack")
    else:
        for code, limit, fmt in ((0xD0, -0x80, ">b"), (0xD1, -0x8000, ">h"),
                                 (0xD2, -0x80000000, ">i"),
                                 (0xD3, -0x8000000000000000, ">q")):
            if v >= limit:
                out.append(bytes([code]) + struct.pack(fmt, v))
                return
        raise AkParseErrorException(f"integer {v} too small for msgpack")


def _encode_ext(out: list, code: int, payload: bytes) -> None:
    n = len(payload)
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        out.append(bytes([fixed[n]]) + struct.pack(">b", code))
    else:
        _sized(out, n, None, -1, ((0xC7, 0xFF, ">B"), (0xC8, 0xFFFF, ">H"),
                                  (0xC9, 0xFFFFFFFF, ">I")))
        out.append(struct.pack(">b", code))
    out.append(payload)


def _ndarray_payload(arr: np.ndarray) -> bytes:
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise AkParseErrorException(f"cannot encode arrays of dtype {arr.dtype}")
    out: list = []
    _encode(out, (tuple(int(s) for s in arr.shape), arr.dtype.name,
                  arr.tobytes("C")))
    return b"".join(out)


def _encode(out: list, v: Any) -> None:
    if v is None:
        out.append(b"\xc0")
    elif v is True:
        out.append(b"\xc3")
    elif v is False:
        out.append(b"\xc2")
    elif isinstance(v, np.ndarray):
        _encode_ext(out, _EXT_NDARRAY, _ndarray_payload(v))
    elif isinstance(v, np.generic):
        _encode_ext(out, _EXT_NPSCALAR, _ndarray_payload(np.asarray(v)))
    elif isinstance(v, int):
        _encode_int(out, v)
    elif isinstance(v, float):
        out.append(b"\xcb" + struct.pack(">d", v))
    elif isinstance(v, str):
        data = v.encode("utf-8")
        _sized(out, len(data), 0xA0, 31, _STR)
        out.append(data)
    elif isinstance(v, (bytes, bytearray, memoryview)):
        data = bytes(v)
        _sized(out, len(data), None, -1, _BIN)
        out.append(data)
    elif isinstance(v, (list, tuple)):
        _sized(out, len(v), 0x90, 15, _ARR)
        for x in v:
            _encode(out, x)
    elif isinstance(v, dict):
        _sized(out, len(v), 0x80, 15, _MAP)
        for k, x in v.items():
            _encode(out, k)
            _encode(out, x)
    else:
        raise AkParseErrorException(f"cannot encode {type(v).__name__} as msgpack")


_MAX_CHUNK_BYTES = 2 ** 30


def _chunk(tree):
    """Split array leaves above flax's chunk limit exactly as flax does."""
    if isinstance(tree, dict):
        return {k: _chunk(v) for k, v in tree.items()}
    if isinstance(tree, np.ndarray) and tree.nbytes > _MAX_CHUNK_BYTES:
        step = max(1, _MAX_CHUNK_BYTES // tree.dtype.itemsize)
        flat = tree.reshape(-1)
        chunks = [flat[i:i + step] for i in range(0, flat.size, step)]
        return {_CHUNK_KEY: True,
                "shape": {str(i): int(s) for i, s in enumerate(tree.shape)},
                "chunks": {str(i): c for i, c in enumerate(chunks)}}
    return tree


def dumps(tree: Dict[str, Any]) -> bytes:
    """Encode a nested dict of numpy arrays the way
    ``flax.serialization.to_bytes`` does (``flax.serialization.from_bytes``
    reads the result back)."""
    out: list = []
    _encode(out, _chunk(tree))
    return b"".join(out)
