"""Tensor column operators: To/From tensor, reshape, (de)serialization
(port of ``alink_tpu.operator.batch.tensorops``; host code, the same wire
strings, so a tensor column written by one package reads in the other).

Capability parity with the reference's tensor dataproc family (reference:
operator/batch/dataproc/ToTensorBatchOp.java, TensorToVectorBatchOp.java,
VectorToTensorBatchOp.java, TensorReshapeBatchOp.java,
TensorSerializeBatchOp.java, VectorSerializeBatchOp.java,
MTableSerializeBatchOp.java, ToVectorBatchOp.java, ToMTableBatchOp.java;
string codec common/linalg/tensor/TensorUtil.java — ``DTYPE#shape#data``).

Tensor cells are plain ``np.ndarray``; the string wire format is
``DTYPE#d0,d1,...#v0 v1 v2 ...`` so tensors survive CSV/text round-trips.
All ops are stateless Mappers, so the stream twins generate automatically.
"""

from __future__ import annotations

import json
from typing import List

import numpy as np

from ...common.exceptions import (
    AkIllegalArgumentException,
    AkIllegalDataException,
)
from ...common.linalg import DenseVector, parse_vector
from ...common.mtable import AlinkTypes, MTable, TableSchema
from ...common.params import InValidator, ParamInfo
from ...mapper import (
    HasOutputCol,
    HasReservedCols,
    HasSelectedCol,
    SISOMapper,
)
from .utils import MapBatchOp

_DTYPES = {
    "FLOAT": np.float32, "DOUBLE": np.float64, "INT": np.int32,
    "LONG": np.int64, "BYTE": np.uint8, "BOOLEAN": np.bool_,
}
_DTYPE_OF = {v: k for k, v in _DTYPES.items()}



def _obj_col(cells) -> np.ndarray:
    """1-D object array of cells — np.asarray would stack equal-shape
    ndarrays into one block instead."""
    col = np.empty(len(cells), object)
    col[:] = cells
    return col

def tensor_to_string(a: np.ndarray) -> str:
    """``DTYPE#shape#flat-data`` wire form (reference:
    common/linalg/tensor/TensorUtil.java serialization)."""
    a = np.asarray(a)
    name = None
    for np_t, tag in _DTYPE_OF.items():
        if a.dtype == np_t:
            name = tag
            break
    if name is None:
        if np.issubdtype(a.dtype, np.floating):
            a, name = a.astype(np.float32), "FLOAT"
        elif np.issubdtype(a.dtype, np.integer):
            a, name = a.astype(np.int64), "LONG"
        else:
            raise AkIllegalDataException(f"unsupported tensor dtype {a.dtype}")
    shape = ",".join(str(int(s)) for s in a.shape)
    data = " ".join(repr(x) if a.dtype.kind == "f" else str(x)
                    for x in a.reshape(-1).tolist())
    return f"{name}#{shape}#{data}"


def string_to_tensor(s: str) -> np.ndarray:
    parts = str(s).split("#", 2)
    if len(parts) != 3:
        raise AkIllegalDataException(f"bad tensor string {s[:60]!r}")
    tag, shape_s, data = parts
    if tag not in _DTYPES:
        raise AkIllegalDataException(f"unknown tensor dtype tag {tag!r}")
    shape = tuple(int(x) for x in shape_s.split(",") if x != "")
    if tag == "BOOLEAN":
        flat = np.asarray([x in ("True", "true", "1") for x in data.split()])
    else:
        flat = np.asarray([float(x) for x in data.split()])
    return flat.astype(_DTYPES[tag]).reshape(shape)


def _cell_to_tensor(v, dtype) -> "np.ndarray | None":
    if v is None:
        return None  # nulls propagate, matching the serialize mappers
    if isinstance(v, np.ndarray):
        return v.astype(dtype) if dtype is not None else v
    if isinstance(v, (DenseVector,)) or hasattr(v, "to_dense"):
        a = v.to_dense().data
        return a.astype(dtype) if dtype is not None else a
    if isinstance(v, str):
        if "#" in v:
            a = string_to_tensor(v)
            return a.astype(dtype) if dtype is not None else a
        a = parse_vector(v).to_dense().data
        return a.astype(dtype) if dtype is not None else a
    a = np.asarray(v)
    return a.astype(dtype) if dtype is not None else a


class ToTensorMapper(SISOMapper):
    """Any supported cell (tensor string / vector / numeric) → tensor cell
    (reference: common/dataproc/ToTensorMapper.java)."""

    TENSOR_DATA_TYPE = ParamInfo(
        "tensorDataType", str, default="FLOAT",
        validator=InValidator(*_DTYPES))
    TENSOR_SHAPE = ParamInfo("tensorShape", list, default=None)

    def map_column(self, values, type_tag):
        dtype = _DTYPES[self.get(self.TENSOR_DATA_TYPE)]
        shape = self.get(self.TENSOR_SHAPE)
        out = []
        for v in values:
            a = _cell_to_tensor(v, dtype)
            if a is not None and shape:
                a = a.reshape(tuple(int(s) for s in shape))
            out.append(a)
        return _obj_col(out), AlinkTypes.TENSOR


class ToTensorBatchOp(MapBatchOp, HasSelectedCol, HasOutputCol,
                      HasReservedCols):
    """(reference: operator/batch/dataproc/ToTensorBatchOp.java)"""

    mapper_cls = ToTensorMapper
    TENSOR_DATA_TYPE = ToTensorMapper.TENSOR_DATA_TYPE
    TENSOR_SHAPE = ToTensorMapper.TENSOR_SHAPE


class TensorToVectorMapper(SISOMapper):
    """Flatten a tensor cell into a dense vector (reference:
    common/dataproc/TensorToVectorMapper.java; convertMethod FLATTEN /
    SUM / MEAN / MAX / MIN reduce over the leading axis)."""

    CONVERT_METHOD = ParamInfo(
        "convertMethod", str, default="FLATTEN",
        validator=InValidator("FLATTEN", "SUM", "MEAN", "MAX", "MIN"))

    def map_column(self, values, type_tag):
        how = self.get(self.CONVERT_METHOD)
        out = []
        for v in values:
            a = _cell_to_tensor(v, np.float64)
            if a is None:
                out.append(None)
                continue
            if how == "FLATTEN" or a.ndim <= 1:
                r = a.reshape(-1)
            elif how == "SUM":
                r = a.sum(axis=0).reshape(-1)
            elif how == "MEAN":
                r = a.mean(axis=0).reshape(-1)
            elif how == "MAX":
                r = a.max(axis=0).reshape(-1)
            else:
                r = a.min(axis=0).reshape(-1)
            out.append(DenseVector(r))
        return np.asarray(out, object), AlinkTypes.DENSE_VECTOR


class TensorToVectorBatchOp(MapBatchOp, HasSelectedCol, HasOutputCol,
                            HasReservedCols):
    """(reference: operator/batch/dataproc/TensorToVectorBatchOp.java)"""

    mapper_cls = TensorToVectorMapper
    CONVERT_METHOD = TensorToVectorMapper.CONVERT_METHOD


class VectorToTensorMapper(SISOMapper):
    """Vector column → tensor cell, optionally reshaped (reference:
    common/dataproc/VectorToTensorMapper.java)."""

    TENSOR_DATA_TYPE = ToTensorMapper.TENSOR_DATA_TYPE
    TENSOR_SHAPE = ToTensorMapper.TENSOR_SHAPE

    def map_column(self, values, type_tag):
        dtype = _DTYPES[self.get(self.TENSOR_DATA_TYPE)]
        shape = self.get(self.TENSOR_SHAPE)
        out = []
        for v in values:
            if v is None:
                out.append(None)
                continue
            a = parse_vector(v).to_dense().data.astype(dtype)
            if shape:
                a = a.reshape(tuple(int(s) for s in shape))
            out.append(a)
        return _obj_col(out), AlinkTypes.TENSOR


class VectorToTensorBatchOp(MapBatchOp, HasSelectedCol, HasOutputCol,
                            HasReservedCols):
    """(reference: operator/batch/dataproc/VectorToTensorBatchOp.java)"""

    mapper_cls = VectorToTensorMapper
    TENSOR_DATA_TYPE = VectorToTensorMapper.TENSOR_DATA_TYPE
    TENSOR_SHAPE = VectorToTensorMapper.TENSOR_SHAPE


class TensorReshapeMapper(SISOMapper):
    """(reference: operator/batch/dataproc/TensorReshapeBatchOp.java)"""

    NEW_SHAPE = ParamInfo("newShape", list, optional=False,
                          aliases=("size",))

    def map_column(self, values, type_tag):
        shape = tuple(int(s) for s in self.get(self.NEW_SHAPE))
        out = [None if v is None
               else _cell_to_tensor(v, None).reshape(shape) for v in values]
        return _obj_col(out), AlinkTypes.TENSOR


class TensorReshapeBatchOp(MapBatchOp, HasSelectedCol, HasOutputCol,
                           HasReservedCols):
    mapper_cls = TensorReshapeMapper
    NEW_SHAPE = TensorReshapeMapper.NEW_SHAPE


class TensorSerializeMapper(SISOMapper):
    """Tensor cell → wire string (reference: operator/batch/utils/
    TensorSerializeBatchOp.java)."""

    def map_column(self, values, type_tag):
        out = [None if v is None else tensor_to_string(_cell_to_tensor(v, None))
               for v in values]
        return np.asarray(out, object), AlinkTypes.STRING


class TensorSerializeBatchOp(MapBatchOp, HasSelectedCol, HasOutputCol,
                             HasReservedCols):
    mapper_cls = TensorSerializeMapper


class VectorSerializeMapper(SISOMapper):
    """Vector cell → canonical string form (reference: operator/batch/utils/
    VectorSerializeBatchOp.java)."""

    def map_column(self, values, type_tag):
        out = [None if v is None else str(parse_vector(v)) for v in values]
        return np.asarray(out, object), AlinkTypes.STRING


class VectorSerializeBatchOp(MapBatchOp, HasSelectedCol, HasOutputCol,
                             HasReservedCols):
    mapper_cls = VectorSerializeMapper


class MTableSerializeMapper(SISOMapper):
    """Nested MTable cell → JSON payload string (reference:
    operator/batch/utils/MTableSerializeBatchOp.java)."""

    def map_column(self, values, type_tag):
        out = []
        for v in values:
            if v is None:
                out.append(None)
            elif isinstance(v, MTable):
                data, meta = v.to_payload()
                out.append(json.dumps({"schema": json.loads(meta)["schema"],
                                       "npz": data.hex()}))
            else:
                out.append(str(v))
        return np.asarray(out, object), AlinkTypes.STRING


class MTableSerializeBatchOp(MapBatchOp, HasSelectedCol, HasOutputCol,
                             HasReservedCols):
    mapper_cls = MTableSerializeMapper


class ToVectorMapper(SISOMapper):
    """Any cell → vector cell (reference: operator/batch/dataproc/
    ToVectorBatchOp.java)."""

    def map_column(self, values, type_tag):
        out = []
        for v in values:
            if v is None:
                out.append(None)
            elif isinstance(v, np.ndarray):
                out.append(DenseVector(v.reshape(-1).astype(np.float64)))
            else:
                out.append(parse_vector(v))
        return np.asarray(out, object), AlinkTypes.DENSE_VECTOR


class ToVectorBatchOp(MapBatchOp, HasSelectedCol, HasOutputCol,
                      HasReservedCols):
    mapper_cls = ToVectorMapper


class ToMTableMapper(SISOMapper):
    """JSON payload string → nested MTable cell (reference:
    operator/batch/dataproc/ToMTableBatchOp.java)."""

    def map_column(self, values, type_tag):
        out = []
        for v in values:
            if v is None or isinstance(v, MTable):
                out.append(v)
            else:
                obj = json.loads(str(v))
                out.append(MTable.from_payload(
                    bytes.fromhex(obj["npz"]),
                    json.dumps({"schema": obj["schema"]})))
        return np.asarray(out, object), AlinkTypes.MTABLE


class ToMTableBatchOp(MapBatchOp, HasSelectedCol, HasOutputCol,
                      HasReservedCols):
    mapper_cls = ToMTableMapper
