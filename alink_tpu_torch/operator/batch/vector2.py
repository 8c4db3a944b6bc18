"""Vector function / expansion / hint / selector operators (port of
``alink_tpu.operator.batch.vector2``; host-side, copied).

Capability parity with the reference's remaining vector dataproc ops
(reference: operator/batch/dataproc/vector/VectorFunctionBatchOp.java,
VectorBiFunctionBatchOp.java [params/dataproc/vector/
HasBiFuncName.java], VectorPolynomialExpandBatchOp.java,
VectorSizeHintBatchOp.java, feature/VectorChiSqSelectorBatchOp.java).

All scalar/vector math vectorizes over the stacked (n, d) block — one
device-friendly pass per column rather than per-cell Java loops.
"""

from __future__ import annotations

from itertools import combinations_with_replacement
from typing import List

import numpy as np

from ...common.exceptions import AkIllegalDataException
from ...common.linalg import DenseVector, parse_vector
from ...common.mtable import AlinkTypes, MTable, TableSchema
from ...common.params import InValidator, MinValidator, ParamInfo
from ...mapper import (
    HasOutputCol,
    HasReservedCols,
    HasSelectedCol,
    HasSelectedCols,
    Mapper,
    SISOMapper,
)
from .base import BatchOperator
from .feature2 import ChiSqSelectorBatchOp
from .utils import MapBatchOp, ModelTrainOpMixin


_FUNCS = ("Max", "Min", "Mean", "ArgMax", "ArgMin", "NormL1", "NormL2",
          "NormL2Square", "Normalize", "Scale", "Abs")


class VectorFunctionMapper(SISOMapper):
    """Apply a named function to a vector column (reference:
    common/dataproc/vector/VectorFunctionMapper.java)."""

    FUNC_NAME = ParamInfo("funcName", str, optional=False,
                          validator=InValidator(*_FUNCS))
    WITH_VARIABLE = ParamInfo("withVariable", float, default=1.0,
                              desc="scalar operand for Scale")

    def map_column(self, values, type_tag):
        fn = self.get(self.FUNC_NAME)
        k = float(self.get(self.WITH_VARIABLE))
        scalars = fn in ("Max", "Min", "Mean", "ArgMax", "ArgMin", "NormL1",
                         "NormL2", "NormL2Square")
        out: List = []
        for v in values:
            a = parse_vector(v).to_dense().data
            if fn == "Max":
                out.append(float(a.max()))
            elif fn == "Min":
                out.append(float(a.min()))
            elif fn == "Mean":
                out.append(float(a.mean()))
            elif fn == "ArgMax":
                out.append(float(int(a.argmax())))
            elif fn == "ArgMin":
                out.append(float(int(a.argmin())))
            elif fn == "NormL1":
                out.append(float(np.abs(a).sum()))
            elif fn == "NormL2":
                out.append(float(np.linalg.norm(a)))
            elif fn == "NormL2Square":
                out.append(float((a * a).sum()))
            elif fn == "Normalize":
                n = float(np.linalg.norm(a))
                out.append(DenseVector(a / n if n > 0 else a))
            elif fn == "Scale":
                out.append(DenseVector(a * k))
            else:  # Abs
                out.append(DenseVector(np.abs(a)))
        if scalars:
            return np.asarray(out, np.float64), AlinkTypes.DOUBLE
        return np.asarray(out, object), AlinkTypes.DENSE_VECTOR


class VectorFunctionBatchOp(MapBatchOp, HasSelectedCol, HasOutputCol,
                            HasReservedCols):
    """(reference: operator/batch/dataproc/vector/VectorFunctionBatchOp.java)"""

    mapper_cls = VectorFunctionMapper
    FUNC_NAME = VectorFunctionMapper.FUNC_NAME
    WITH_VARIABLE = VectorFunctionMapper.WITH_VARIABLE


_BI_FUNCS = ("Plus", "Minus", "ElementWiseMultiply", "Merge", "Dot",
             "EuclidDistance", "Cosine")


class VectorBiFunctionMapper(Mapper, HasSelectedCols, HasOutputCol,
                             HasReservedCols):
    """Elementwise/binary op on TWO vector columns (reference:
    common/dataproc/vector/VectorBiFunctionMapper.java; params/dataproc/
    vector/HasBiFuncName.java)."""

    BI_FUNC_NAME = ParamInfo("biFuncName", str, optional=False,
                             validator=InValidator(*_BI_FUNCS))

    def _out_type(self):
        fn = self.get(self.BI_FUNC_NAME)
        return (AlinkTypes.DOUBLE
                if fn in ("Dot", "EuclidDistance", "Cosine")
                else AlinkTypes.DENSE_VECTOR)

    def output_schema(self, input_schema: TableSchema) -> TableSchema:
        out = self.get(HasOutputCol.OUTPUT_COL)
        return self._append_result_schema(input_schema, [out],
                                          [self._out_type()])

    def map_table(self, t: MTable) -> MTable:
        ca, cb = self.get(HasSelectedCols.SELECTED_COLS)
        fn = self.get(self.BI_FUNC_NAME)
        va = [parse_vector(v).to_dense().data for v in t.col(ca)]
        vb = [parse_vector(v).to_dense().data for v in t.col(cb)]
        out: List = []
        for a, b in zip(va, vb):
            if fn != "Merge" and a.shape != b.shape:
                raise AkIllegalDataException(
                    f"vector sizes differ: {a.shape} vs {b.shape}")
            if fn == "Plus":
                out.append(DenseVector(a + b))
            elif fn == "Minus":
                out.append(DenseVector(a - b))
            elif fn == "ElementWiseMultiply":
                out.append(DenseVector(a * b))
            elif fn == "Merge":
                out.append(DenseVector(np.concatenate([a, b])))
            elif fn == "Dot":
                out.append(float(a @ b))
            elif fn == "EuclidDistance":
                out.append(float(np.linalg.norm(a - b)))
            else:  # Cosine
                na, nb = np.linalg.norm(a), np.linalg.norm(b)
                out.append(float(a @ b / (na * nb)) if na > 0 and nb > 0
                           else 0.0)
        oc = self.get(HasOutputCol.OUTPUT_COL)
        ot = self._out_type()
        arr = (np.asarray(out, np.float64) if ot == AlinkTypes.DOUBLE
               else np.asarray(out, object))
        return self._append_result(t, {oc: arr}, {oc: ot})


class VectorBiFunctionBatchOp(MapBatchOp, HasSelectedCols, HasOutputCol,
                              HasReservedCols):
    """(reference: operator/batch/dataproc/vector/
    VectorBiFunctionBatchOp.java)"""

    mapper_cls = VectorBiFunctionMapper
    BI_FUNC_NAME = VectorBiFunctionMapper.BI_FUNC_NAME


class VectorPolynomialExpandMapper(SISOMapper):
    """Polynomial feature expansion of a vector column (reference:
    common/dataproc/vector/VectorPolynomialExpandMapper.java — all monomials
    of degree 1..degree over the input dims)."""

    DEGREE = ParamInfo("degree", int, default=2, validator=MinValidator(1))

    def map_column(self, values, type_tag):
        deg = int(self.get(self.DEGREE))
        out = []
        for v in values:
            a = parse_vector(v).to_dense().data
            feats = []
            for d in range(1, deg + 1):
                for combo in combinations_with_replacement(range(a.size), d):
                    feats.append(np.prod(a[list(combo)]))
            out.append(DenseVector(np.asarray(feats, np.float64)))
        return np.asarray(out, object), AlinkTypes.DENSE_VECTOR


class VectorPolynomialExpandBatchOp(MapBatchOp, HasSelectedCol, HasOutputCol,
                                    HasReservedCols):
    """(reference: operator/batch/dataproc/vector/
    VectorPolynomialExpandBatchOp.java)"""

    mapper_cls = VectorPolynomialExpandMapper
    DEGREE = VectorPolynomialExpandMapper.DEGREE


class VectorSizeHintMapper(SISOMapper):
    """Assert/declare the size of a vector column (reference:
    common/dataproc/vector/VectorSizeHintMapper.java; handleInvalid
    ERROR raises, SKIP nulls, OPTIMISTIC passes through)."""

    SIZE = ParamInfo("size", int, optional=False, validator=MinValidator(1))
    HANDLE_INVALID_METHOD = ParamInfo(
        "handleInvalidMethod", str, default="ERROR",
        aliases=("handleInvalid",),
        validator=InValidator("ERROR", "SKIP", "OPTIMISTIC"))

    def map_column(self, values, type_tag):
        size = int(self.get(self.SIZE))
        how = self.get(self.HANDLE_INVALID_METHOD)
        out = []
        for v in values:
            vec = parse_vector(v)
            ok = vec.size() == size
            if ok or how == "OPTIMISTIC":
                out.append(vec)
            elif how == "SKIP":
                out.append(None)
            else:
                raise AkIllegalDataException(
                    f"vector size {vec.size()} != declared {size}")
        return np.asarray(out, object), AlinkTypes.DENSE_VECTOR


class VectorSizeHintBatchOp(MapBatchOp, HasSelectedCol, HasOutputCol,
                            HasReservedCols):
    """(reference: operator/batch/dataproc/vector/VectorSizeHintBatchOp.java)"""

    mapper_cls = VectorSizeHintMapper
    SIZE = VectorSizeHintMapper.SIZE
    HANDLE_INVALID_METHOD = VectorSizeHintMapper.HANDLE_INVALID_METHOD


class VectorChiSqSelectorBatchOp(ModelTrainOpMixin, BatchOperator):
    """Chi-square feature selection over the DIMS of a vector column: expands
    the vector to per-dim columns, scores each against the label, and emits
    the same selector model the column variant produces (reference:
    operator/batch/feature/VectorChiSqSelectorBatchOp.java)."""

    SELECTED_COL = ParamInfo("selectedCol", str, optional=False,
                             aliases=("vectorCol",))
    LABEL_COL = ChiSqSelectorBatchOp.LABEL_COL
    NUM_TOP_FEATURES = ChiSqSelectorBatchOp.NUM_TOP_FEATURES

    _min_inputs = 1
    _max_inputs = 1

    def _execute_impl(self, t: MTable) -> MTable:
        vec_col = self.get(self.SELECTED_COL)
        label_col = self.get(self.LABEL_COL)
        dense = np.stack([parse_vector(v).to_dense().data
                          for v in t.col(vec_col)])
        cols = {f"v_{i}": dense[:, i] for i in range(dense.shape[1])}
        cols[label_col] = np.asarray(t.col(label_col))
        expanded = MTable(cols)
        inner = ChiSqSelectorBatchOp(
            selectedCols=[f"v_{i}" for i in range(dense.shape[1])],
            labelCol=label_col,
            numTopFeatures=self.get(self.NUM_TOP_FEATURES))
        return inner._execute_impl(expanded)

    def _static_meta_keys(self, in_schema):
        return {"modelName": "ChiSqSelectorModel"}
