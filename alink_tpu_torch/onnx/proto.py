"""Self-contained ONNX protobuf wire-format codec (no `onnx` dependency): a
copy of ``alink_tpu.onnx.proto``, numpy and ``struct`` only.

The reference ships an ONNX Runtime predictor plugin (reference:
dl_predictors/predictor-onnx/src/main/java/com/alibaba/alink/plugins/onnx/
OnnxJavaPredictor.java:36 — OrtEnvironment/OrtSession). The port *imports*
the ONNX graph and runs it as PyTorch ops on the device (see convert.py); this
module is the storage layer: a minimal protobuf wire codec plus typed views of
the ONNX messages actually needed (ModelProto/GraphProto/NodeProto/
AttributeProto/TensorProto/ValueInfoProto), and an encoder so tests and users
can build valid .onnx files without the onnx package. The encoder writes the
same bytes as the reference's (its ``producer`` default included), so a file
written by either package loads in the other unchanged.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np

# -- wire primitives ---------------------------------------------------------

_VARINT, _I64, _LEN, _I32 = 0, 1, 2, 5


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _emit_varint(v: int) -> bytes:
    if v < 0:
        v &= (1 << 64) - 1  # two's complement, 64-bit
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def iter_fields(buf: bytes) -> Iterator[Tuple[int, int, Any]]:
    """Yield (field_no, wire_type, value) over a serialized message."""
    pos = 0
    n = len(buf)
    while pos < n:
        key, pos = _read_varint(buf, pos)
        fno, wt = key >> 3, key & 7
        if wt == _VARINT:
            v, pos = _read_varint(buf, pos)
        elif wt == _LEN:
            ln, pos = _read_varint(buf, pos)
            v = buf[pos:pos + ln]
            pos += ln
        elif wt == _I64:
            v = buf[pos:pos + 8]
            pos += 8
        elif wt == _I32:
            v = buf[pos:pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wt}")
        yield fno, wt, v


def fields_dict(buf: bytes) -> Dict[int, List[Any]]:
    out: Dict[int, List[Any]] = {}
    for fno, _, v in iter_fields(buf):
        out.setdefault(fno, []).append(v)
    return out


def _field(fno: int, wt: int, payload: bytes) -> bytes:
    return _emit_varint((fno << 3) | wt) + payload


def emit_varint_field(fno: int, v: int) -> bytes:
    return _field(fno, _VARINT, _emit_varint(v))


def emit_len_field(fno: int, data: bytes) -> bytes:
    return _field(fno, _LEN, _emit_varint(len(data)) + data)


def emit_str_field(fno: int, s: str) -> bytes:
    return emit_len_field(fno, s.encode("utf-8"))


def emit_float_field(fno: int, v: float) -> bytes:
    return _field(fno, _I32, struct.pack("<f", v))


def _zigzag_i64(raw: int) -> int:
    """Interpret a varint as a signed int64 (plain two's complement)."""
    if raw >= 1 << 63:
        raw -= 1 << 64
    return raw


# -- ONNX tensor element types ----------------------------------------------

TENSOR_DTYPES = {
    1: np.float32, 2: np.uint8, 3: np.int8, 4: np.uint16, 5: np.int16,
    6: np.int32, 7: np.int64, 9: np.bool_, 10: np.float16, 11: np.float64,
    12: np.uint32, 13: np.uint64,
}
DTYPE_CODES = {np.dtype(v): k for k, v in TENSOR_DTYPES.items()}


# -- typed message views -----------------------------------------------------

@dataclass
class TensorProto:
    name: str = ""
    dims: Tuple[int, ...] = ()
    data_type: int = 1
    array: Optional[np.ndarray] = None

    @staticmethod
    def parse(buf: bytes) -> "TensorProto":
        f = fields_dict(buf)
        dims = tuple(_zigzag_i64(v) for v in f.get(1, []))
        dtype_code = f.get(2, [1])[0]
        name = f.get(8, [b""])[0].decode("utf-8")
        np_dtype = TENSOR_DTYPES.get(dtype_code, np.float32)
        if 9 in f:  # raw_data
            arr = np.frombuffer(f[9][0], dtype=np_dtype)
        elif 4 in f:  # float_data (packed or repeated)
            arr = _unpack_packed(f[4], "<f", np.float32)
        elif 7 in f:  # int64_data
            arr = _unpack_varints(f[7], np.int64)
        elif 5 in f:  # int32_data (also holds bool/int8/uint8...)
            arr = _unpack_varints(f[5], np.int64).astype(np_dtype)
        elif 10 in f:  # double_data
            arr = _unpack_packed(f[10], "<d", np.float64)
        else:
            arr = np.zeros(0, np_dtype)
        return TensorProto(name, dims, dtype_code,
                           arr.reshape(dims) if dims else arr.reshape(()))

    def serialize(self) -> bytes:
        arr = np.ascontiguousarray(self.array)
        out = b"".join(emit_varint_field(1, int(d)) for d in arr.shape)
        out += emit_varint_field(2, DTYPE_CODES[arr.dtype])
        if self.name:
            out += emit_str_field(8, self.name)
        out += emit_len_field(9, arr.tobytes())
        return out

    @staticmethod
    def from_array(name: str, arr: np.ndarray) -> "TensorProto":
        arr = np.asarray(arr)
        return TensorProto(name, tuple(arr.shape), DTYPE_CODES[arr.dtype], arr)


def _unpack_packed(chunks: List[Any], fmt_char: str, dtype) -> np.ndarray:
    # LEN-encoded packed repeated, or a list of fixed32/64 scalars
    vals: List[float] = []
    size = struct.calcsize(fmt_char)
    for c in chunks:
        if isinstance(c, (bytes, bytearray)):
            vals.extend(
                struct.unpack_from(fmt_char, c, o)[0]
                for o in range(0, len(c), size)
            )
        else:
            vals.append(c)
    return np.asarray(vals, dtype)


def _unpack_varints(chunks: List[Any], dtype) -> np.ndarray:
    vals: List[int] = []
    for c in chunks:
        if isinstance(c, (bytes, bytearray)):  # packed
            pos = 0
            while pos < len(c):
                v, pos = _read_varint(c, pos)
                vals.append(_zigzag_i64(v))
        else:
            vals.append(_zigzag_i64(c))
    return np.asarray(vals, dtype)


@dataclass
class AttributeProto:
    name: str = ""
    f: Optional[float] = None
    i: Optional[int] = None
    s: Optional[bytes] = None
    t: Optional[TensorProto] = None
    floats: Tuple[float, ...] = ()
    ints: Tuple[int, ...] = ()
    strings: Tuple[bytes, ...] = ()

    @property
    def value(self):
        for v in (self.t, self.s, self.f, self.i):
            if v is not None:
                return v.decode() if isinstance(v, bytes) else v
        if self.floats:
            return list(self.floats)
        if self.ints:
            return list(self.ints)
        if self.strings:
            return [s.decode() for s in self.strings]
        return None

    @staticmethod
    def parse(buf: bytes) -> "AttributeProto":
        f = fields_dict(buf)
        a = AttributeProto(name=f.get(1, [b""])[0].decode("utf-8"))
        if 2 in f:
            a.f = struct.unpack("<f", f[2][0])[0]
        if 3 in f:
            a.i = _zigzag_i64(f[3][0])
        if 4 in f:
            a.s = f[4][0]
        if 5 in f:
            a.t = TensorProto.parse(f[5][0])
        if 7 in f:
            a.floats = tuple(_unpack_packed(f[7], "<f", np.float32).tolist())
        if 8 in f:
            a.ints = tuple(_unpack_varints(f[8], np.int64).tolist())
        if 9 in f:
            a.strings = tuple(f[9])
        return a

    def serialize(self) -> bytes:
        out = emit_str_field(1, self.name)
        if self.f is not None:
            out += emit_float_field(2, self.f) + emit_varint_field(20, 1)
        elif self.i is not None:
            out += emit_varint_field(3, self.i) + emit_varint_field(20, 2)
        elif self.s is not None:
            out += emit_len_field(4, self.s) + emit_varint_field(20, 3)
        elif self.t is not None:
            out += emit_len_field(5, self.t.serialize()) + emit_varint_field(20, 4)
        elif self.floats:
            out += b"".join(_field(7, _I32, struct.pack("<f", v))
                            for v in self.floats)
            out += emit_varint_field(20, 6)
        elif self.ints:
            out += b"".join(emit_varint_field(8, int(v)) for v in self.ints)
            out += emit_varint_field(20, 7)
        elif self.strings:
            out += b"".join(emit_len_field(9, s) for s in self.strings)
            out += emit_varint_field(20, 8)
        return out


@dataclass
class NodeProto:
    op_type: str
    inputs: List[str] = field(default_factory=list)
    outputs: List[str] = field(default_factory=list)
    name: str = ""
    attrs: Dict[str, AttributeProto] = field(default_factory=dict)

    def attr(self, name: str, default=None):
        a = self.attrs.get(name)
        return default if a is None else a.value

    @staticmethod
    def parse(buf: bytes) -> "NodeProto":
        f = fields_dict(buf)
        attrs = {}
        for ab in f.get(5, []):
            a = AttributeProto.parse(ab)
            attrs[a.name] = a
        return NodeProto(
            op_type=f.get(4, [b""])[0].decode("utf-8"),
            inputs=[b.decode("utf-8") for b in f.get(1, [])],
            outputs=[b.decode("utf-8") for b in f.get(2, [])],
            name=f.get(3, [b""])[0].decode("utf-8"),
            attrs=attrs,
        )

    def serialize(self) -> bytes:
        out = b"".join(emit_str_field(1, s) for s in self.inputs)
        out += b"".join(emit_str_field(2, s) for s in self.outputs)
        if self.name:
            out += emit_str_field(3, self.name)
        out += emit_str_field(4, self.op_type)
        out += b"".join(emit_len_field(5, a.serialize())
                        for a in self.attrs.values())
        return out


@dataclass
class ValueInfo:
    name: str
    elem_type: int = 1
    shape: Tuple[Optional[int], ...] = ()

    @staticmethod
    def parse(buf: bytes) -> "ValueInfo":
        f = fields_dict(buf)
        name = f.get(1, [b""])[0].decode("utf-8")
        elem_type, shape = 1, ()
        if 2 in f:  # TypeProto
            tf = fields_dict(f[2][0])
            if 1 in tf:  # tensor_type
                tt = fields_dict(tf[1][0])
                elem_type = tt.get(1, [1])[0]
                if 2 in tt:  # TensorShapeProto
                    dims = []
                    for db in fields_dict(tt[2][0]).get(1, []):
                        df = fields_dict(db)
                        dims.append(_zigzag_i64(df[1][0]) if 1 in df else None)
                    shape = tuple(dims)
        return ValueInfo(name, elem_type, shape)

    def serialize(self) -> bytes:
        dims = b""
        for d in self.shape:
            if d is None:
                dims += emit_len_field(1, emit_str_field(2, "N"))
            else:
                dims += emit_len_field(1, emit_varint_field(1, int(d)))
        tensor_type = emit_varint_field(1, self.elem_type) + emit_len_field(
            2, dims
        )
        type_proto = emit_len_field(1, tensor_type)
        return emit_str_field(1, self.name) + emit_len_field(2, type_proto)


@dataclass
class OnnxGraph:
    nodes: List[NodeProto] = field(default_factory=list)
    name: str = "graph"
    initializers: Dict[str, np.ndarray] = field(default_factory=dict)
    inputs: List[ValueInfo] = field(default_factory=list)
    outputs: List[ValueInfo] = field(default_factory=list)

    @staticmethod
    def parse(buf: bytes) -> "OnnxGraph":
        f = fields_dict(buf)
        inits = {}
        for tb in f.get(5, []):
            t = TensorProto.parse(tb)
            inits[t.name] = t.array
        return OnnxGraph(
            nodes=[NodeProto.parse(b) for b in f.get(1, [])],
            name=f.get(2, [b"graph"])[0].decode("utf-8"),
            initializers=inits,
            inputs=[ValueInfo.parse(b) for b in f.get(11, [])],
            outputs=[ValueInfo.parse(b) for b in f.get(12, [])],
        )

    def serialize(self) -> bytes:
        out = b"".join(emit_len_field(1, n.serialize()) for n in self.nodes)
        out += emit_str_field(2, self.name)
        out += b"".join(
            emit_len_field(5, TensorProto.from_array(k, v).serialize())
            for k, v in self.initializers.items()
        )
        out += b"".join(emit_len_field(11, v.serialize()) for v in self.inputs)
        out += b"".join(emit_len_field(12, v.serialize()) for v in self.outputs)
        return out


@dataclass
class OnnxModel:
    graph: OnnxGraph
    ir_version: int = 8
    opset: int = 17
    producer: str = "alink_tpu"

    @staticmethod
    def parse(data: bytes) -> "OnnxModel":
        f = fields_dict(data)
        if 7 not in f:
            raise ValueError("not an ONNX ModelProto (no graph field)")
        opset = 17
        for ob in f.get(8, []):
            of = fields_dict(ob)
            if 2 in of:
                opset = _zigzag_i64(of[2][0])
        return OnnxModel(
            graph=OnnxGraph.parse(f[7][0]),
            ir_version=f.get(1, [8])[0],
            opset=opset,
            producer=f.get(2, [b""])[0].decode("utf-8"),
        )

    @staticmethod
    def load(path: str) -> "OnnxModel":
        with open(path, "rb") as fh:
            return OnnxModel.parse(fh.read())

    def serialize(self) -> bytes:
        opset = emit_varint_field(2, self.opset)  # OperatorSetIdProto.version
        return (
            emit_varint_field(1, self.ir_version)
            + emit_str_field(2, self.producer)
            + emit_len_field(7, self.graph.serialize())
            + emit_len_field(8, opset)
        )

    def save(self, path: str):
        with open(path, "wb") as fh:
            fh.write(self.serialize())
