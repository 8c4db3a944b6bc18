"""Vector dataproc operators + UDF/UDTF escape hatches (port of
``alink_tpu.operator.batch.vector``; host-side, copied).

Capability parity with the reference's vector dataproc family (reference:
core/src/main/java/com/alibaba/alink/operator/batch/dataproc/vector/
VectorNormalizeBatchOp.java, VectorSliceBatchOp.java,
VectorElementwiseProductBatchOp.java, VectorInteractionBatchOp.java,
VectorToColumnsBatchOp.java, dataproc/ColumnsToVectorBatchOp.java; UDF/UDTF
ops operator/batch/utils/UDFBatchOp.java / UDTFBatchOp.java backed by the
PyCalcRunner python-worker bridge — here UDFs are plain Python callables in
process)."""

from __future__ import annotations

from typing import Callable, List

import numpy as np

from ...common.exceptions import AkIllegalArgumentException
from ...common.linalg import DenseVector, parse_vector
from ...common.mtable import AlinkTypes, MTable, TableSchema
from ...common.params import InValidator, ParamInfo
from ...common.model import model_to_table, table_to_model
from ...mapper import (
    HasOutputCol,
    HasOutputCols,
    HasReservedCols,
    HasSelectedCol,
    HasSelectedCols,
    Mapper,
    ModelMapper,
    SISOMapper,
)
from .base import BatchOperator
from .utils import MapBatchOp, ModelMapBatchOp, ModelTrainOpMixin


def _dense_rows(col) -> List[np.ndarray]:
    return [parse_vector(v).to_dense().data for v in col]


class VectorNormalizeMapper(SISOMapper):
    """p-norm normalization of a vector column (reference:
    common/dataproc/vector/VectorNormalizeMapper.java)."""

    P = ParamInfo("p", float, default=2.0)

    def map_column(self, values, type_tag):
        p = float(self.get(self.P))
        out = []
        for v in values:
            arr = parse_vector(v).to_dense().data
            norm = float(np.linalg.norm(arr, ord=p))
            out.append(DenseVector(arr / norm if norm > 0 else arr))
        return np.asarray(out, object), AlinkTypes.DENSE_VECTOR


class VectorNormalizeBatchOp(MapBatchOp, HasSelectedCol, HasOutputCol,
                             HasReservedCols):
    mapper_cls = VectorNormalizeMapper
    P = VectorNormalizeMapper.P


class VectorSliceMapper(SISOMapper):
    """(reference: common/dataproc/vector/VectorSliceMapper.java)"""

    INDICES = ParamInfo("indices", list, optional=False)

    def map_column(self, values, type_tag):
        idx = np.asarray(self.get(self.INDICES), np.int64)
        out = [DenseVector(parse_vector(v).to_dense().data[idx])
               for v in values]
        return np.asarray(out, object), AlinkTypes.DENSE_VECTOR


class VectorSliceBatchOp(MapBatchOp, HasSelectedCol, HasOutputCol,
                         HasReservedCols):
    mapper_cls = VectorSliceMapper
    INDICES = VectorSliceMapper.INDICES


class VectorElementwiseProductMapper(SISOMapper):
    """(reference: common/dataproc/vector/VectorElementwiseProductMapper.java)"""

    SCALING_VECTOR = ParamInfo("scalingVector", str, optional=False)

    def map_column(self, values, type_tag):
        scale = parse_vector(self.get(self.SCALING_VECTOR)).to_dense().data
        out = [DenseVector(parse_vector(v).to_dense().data * scale)
               for v in values]
        return np.asarray(out, object), AlinkTypes.DENSE_VECTOR


class VectorElementwiseProductBatchOp(MapBatchOp, HasSelectedCol,
                                      HasOutputCol, HasReservedCols):
    mapper_cls = VectorElementwiseProductMapper
    SCALING_VECTOR = VectorElementwiseProductMapper.SCALING_VECTOR


class VectorInteractionMapper(Mapper, HasSelectedCols, HasOutputCol,
                              HasReservedCols):
    """Flattened outer product of two vector columns (reference:
    common/dataproc/vector/VectorInteractionMapper.java)."""

    def output_schema(self, input_schema):
        out = self.get(HasOutputCol.OUTPUT_COL) or "interaction"
        return self._append_result_schema(input_schema, [out],
                                          [AlinkTypes.DENSE_VECTOR])

    def map_table(self, t: MTable) -> MTable:
        cols = self.get(HasSelectedCols.SELECTED_COLS)
        if not cols or len(cols) != 2:
            raise AkIllegalArgumentException(
                "VectorInteraction needs selectedCols=[vecA, vecB]")
        out = self.get(HasOutputCol.OUTPUT_COL) or "interaction"
        a_rows = _dense_rows(t.col(cols[0]))
        b_rows = _dense_rows(t.col(cols[1]))
        vecs = [DenseVector(np.outer(a, b).ravel())
                for a, b in zip(a_rows, b_rows)]
        return self._append_result(
            t, {out: np.asarray(vecs, object)},
            {out: AlinkTypes.DENSE_VECTOR})


class VectorInteractionBatchOp(MapBatchOp, HasSelectedCols, HasOutputCol,
                               HasReservedCols):
    mapper_cls = VectorInteractionMapper


class VectorToColumnsMapper(Mapper, HasSelectedCol, HasOutputCols,
                            HasReservedCols):
    """Explode a vector column into numeric columns (reference:
    common/dataproc/vector/VectorToColumnsMapper.java)."""

    def _out_cols(self):
        return list(self.get(HasOutputCols.OUTPUT_COLS) or [])

    def output_schema(self, input_schema):
        outs = self._out_cols()
        if not outs:
            raise AkIllegalArgumentException(
                "VectorToColumns needs outputCols (defines the width)")
        return self._append_result_schema(
            input_schema, outs, [AlinkTypes.DOUBLE] * len(outs))

    def map_table(self, t: MTable) -> MTable:
        col = self.get(HasSelectedCol.SELECTED_COL)
        outs = self._out_cols()
        X = np.stack(_dense_rows(t.col(col)))
        if X.shape[1] != len(outs):
            raise AkIllegalArgumentException(
                f"vector size {X.shape[1]} != len(outputCols) {len(outs)}")
        cols = {oc: X[:, i] for i, oc in enumerate(outs)}
        return self._append_result(
            t, cols, {oc: AlinkTypes.DOUBLE for oc in outs})


class VectorToColumnsBatchOp(MapBatchOp, HasSelectedCol, HasOutputCols,
                             HasReservedCols):
    mapper_cls = VectorToColumnsMapper


class ColumnsToVectorMapper(Mapper, HasSelectedCols, HasOutputCol,
                            HasReservedCols):
    """(reference: operator/batch/dataproc/ColumnsToVectorBatchOp.java —
    the inverse of VectorToColumns; VectorAssembler's simple cousin)."""

    def output_schema(self, input_schema):
        out = self.get(HasOutputCol.OUTPUT_COL) or "vec"
        return self._append_result_schema(input_schema, [out],
                                          [AlinkTypes.DENSE_VECTOR])

    def map_table(self, t: MTable) -> MTable:
        cols = list(self.get(HasSelectedCols.SELECTED_COLS) or t.names)
        out = self.get(HasOutputCol.OUTPUT_COL) or "vec"
        X = t.to_numeric_block(cols, dtype=np.float64)
        vecs = [DenseVector(row) for row in X]
        return self._append_result(
            t, {out: np.asarray(vecs, object)},
            {out: AlinkTypes.DENSE_VECTOR})


class ColumnsToVectorBatchOp(MapBatchOp, HasSelectedCols, HasOutputCol,
                             HasReservedCols):
    mapper_cls = ColumnsToVectorMapper


# ---------------------------------------------------------------------------
# UDF / UDTF
# ---------------------------------------------------------------------------

class UdfBatchOp(BatchOperator, HasSelectedCols, HasOutputCol,
                 HasReservedCols):
    """Row-wise scalar UDF: ``func(*selected_values) -> value`` (reference:
    operator/batch/utils/UDFBatchOp.java; the PyCalcRunner process bridge
    collapses to an in-process callable)."""

    RESULT_TYPE = ParamInfo(
        "resultType", str, default="DOUBLE",
        validator=InValidator("DOUBLE", "LONG", "STRING", "BOOLEAN"))

    _min_inputs = 1
    _max_inputs = 1

    def __init__(self, func: Callable = None, params=None, **kwargs):
        super().__init__(params, **kwargs)
        if func is None:
            raise AkIllegalArgumentException("UdfBatchOp needs func")
        self.func = func

    def _execute_impl(self, t: MTable) -> MTable:
        cols = list(self.get(HasSelectedCols.SELECTED_COLS) or t.names)
        out = self.get(HasOutputCol.OUTPUT_COL) or "udf"
        arrays = [t.col(c) for c in cols]
        vals = [self.func(*vals) for vals in zip(*arrays)]
        rtype = self.get(self.RESULT_TYPE)
        if rtype in ("DOUBLE",):
            col = np.asarray(vals, np.float64)
        elif rtype == "LONG":
            col = np.asarray(vals, np.int64)
        elif rtype == "BOOLEAN":
            col = np.asarray(vals, bool)
        else:
            col = np.asarray([None if v is None else str(v) for v in vals],
                             object)
        return t.with_column(out, col, rtype)

    def _out_schema(self, in_schema):
        out = self.get(HasOutputCol.OUTPUT_COL) or "udf"
        return TableSchema(list(in_schema.names) + [out],
                           list(in_schema.types) + [self.get(self.RESULT_TYPE)])


class UdtfBatchOp(BatchOperator, HasSelectedCols, HasOutputCols,
                  HasReservedCols):
    """Table UDF: ``func(*selected_values) -> iterable of row tuples``; input
    row columns are replicated per emitted row (reference:
    operator/batch/utils/UDTFBatchOp.java flatMap semantics)."""

    RESULT_TYPES = ParamInfo("resultTypes", list)

    _min_inputs = 1
    _max_inputs = 1

    def __init__(self, func: Callable = None, params=None, **kwargs):
        super().__init__(params, **kwargs)
        if func is None:
            raise AkIllegalArgumentException("UdtfBatchOp needs func")
        self.func = func

    def _execute_impl(self, t: MTable) -> MTable:
        cols = list(self.get(HasSelectedCols.SELECTED_COLS) or t.names)
        outs = list(self.get(HasOutputCols.OUTPUT_COLS) or ["col0"])
        rtypes = list(self.get(self.RESULT_TYPES) or
                      [AlinkTypes.STRING] * len(outs))
        arrays = [t.col(c) for c in cols]
        out_rows = []
        for i, vals in enumerate(zip(*arrays)):
            for emitted in self.func(*vals):
                if not isinstance(emitted, (tuple, list)):
                    emitted = (emitted,)
                base = tuple(t.col(n)[i] for n in t.names)
                out_rows.append(base + tuple(emitted))
        schema = TableSchema(list(t.names) + outs,
                             list(t.schema.types) + rtypes)
        return MTable.from_rows(out_rows, schema)

    def _out_schema(self, in_schema):
        outs = list(self.get(HasOutputCols.OUTPUT_COLS) or ["col0"])
        rtypes = list(self.get(self.RESULT_TYPES) or
                      [AlinkTypes.STRING] * len(outs))
        return TableSchema(list(in_schema.names) + outs,
                           list(in_schema.types) + rtypes)


# ---------------------------------------------------------------------------
# vector-column scaler/imputer model family (reference:
# operator/batch/dataproc/vector/VectorStandardScalerTrainBatchOp.java,
# VectorMinMaxScalerTrainBatchOp.java, VectorMaxAbsScalerTrainBatchOp.java,
# VectorImputerTrainBatchOp.java + their Predict twins)
# ---------------------------------------------------------------------------


def _vector_block(t: MTable, col: str) -> np.ndarray:
    return np.stack([parse_vector(v).to_dense().data
                     for v in t.col(col)]).astype(np.float64)


class _VectorStatModelMapper(ModelMapper, HasSelectedCol, HasOutputCol,
                             HasReservedCols):
    """Shared vector-transform serving: load stats, map vectors in one
    vectorized pass."""

    def load_model(self, model: MTable):
        self.meta, self.arrays = table_to_model(model)
        return self

    def output_schema(self, input_schema):
        # mirror map_table exactly: selectedCol overrides the model's,
        # outputCol defaults to in-place
        col = (self.get(HasSelectedCol.SELECTED_COL)
               or self.meta["selectedCol"])
        out = self.get(HasOutputCol.OUTPUT_COL) or col
        return self._append_result_schema(
            input_schema, [out], [AlinkTypes.DENSE_VECTOR])

    def _transform(self, X: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def map_table(self, t: MTable) -> MTable:
        col = (self.get(HasSelectedCol.SELECTED_COL)
               or self.meta["selectedCol"])
        out = self.get(HasOutputCol.OUTPUT_COL) or col
        X = _vector_block(t, col)
        Y = self._transform(X)
        vecs = np.empty(len(Y), object)
        for i, row in enumerate(Y):
            vecs[i] = DenseVector(row)
        return self._append_result(
            t, {out: vecs}, {out: AlinkTypes.DENSE_VECTOR})


class _VectorStatTrainBase(ModelTrainOpMixin, BatchOperator, HasSelectedCol):
    _min_inputs = 1
    _max_inputs = 1
    _model_name = ""

    def _stats(self, X: np.ndarray) -> dict:
        raise NotImplementedError

    def _meta_extra(self) -> dict:
        return {}

    def _execute_impl(self, t: MTable) -> MTable:
        col = self.get(HasSelectedCol.SELECTED_COL)
        X = _vector_block(t, col)
        meta = {"modelName": self._model_name, "selectedCol": col,
                **self._meta_extra()}
        return model_to_table(meta, self._stats(X))

    def _static_meta_keys(self, in_schema):
        return {"modelName": self._model_name,
                "selectedCol": self.get(HasSelectedCol.SELECTED_COL)}


class VectorStandardScalerTrainBatchOp(_VectorStatTrainBase):
    """(reference: VectorStandardScalerTrainBatchOp.java)"""

    WITH_MEAN = ParamInfo("withMean", bool, default=True)
    WITH_STD = ParamInfo("withStd", bool, default=True)

    _model_name = "VectorStandardScalerModel"

    def _meta_extra(self):
        return {"withMean": self.get(self.WITH_MEAN),
                "withStd": self.get(self.WITH_STD)}

    def _stats(self, X):
        return {"mean": X.mean(axis=0), "std": X.std(axis=0, ddof=0)}


class VectorStandardScalerModelMapper(_VectorStatModelMapper):
    def _transform(self, X):
        mean = self.arrays["mean"]
        std = np.where(self.arrays["std"] > 0, self.arrays["std"], 1.0)
        if self.meta.get("withMean", True):
            X = X - mean
        if self.meta.get("withStd", True):
            X = X / std
        return X


class VectorStandardScalerPredictBatchOp(ModelMapBatchOp, HasSelectedCol,
                                         HasOutputCol, HasReservedCols):
    mapper_cls = VectorStandardScalerModelMapper


class VectorMinMaxScalerTrainBatchOp(_VectorStatTrainBase):
    """(reference: VectorMinMaxScalerTrainBatchOp.java)"""

    MIN_VALUE = ParamInfo("min", float, default=0.0)
    MAX_VALUE = ParamInfo("max", float, default=1.0)

    _model_name = "VectorMinMaxScalerModel"

    def _meta_extra(self):
        return {"min": self.get(self.MIN_VALUE),
                "max": self.get(self.MAX_VALUE)}

    def _stats(self, X):
        return {"dataMin": X.min(axis=0), "dataMax": X.max(axis=0)}


class VectorMinMaxScalerModelMapper(_VectorStatModelMapper):
    def _transform(self, X):
        lo, hi = self.arrays["dataMin"], self.arrays["dataMax"]
        span = np.where(hi > lo, hi - lo, 1.0)
        out_lo = self.meta.get("min", 0.0)
        out_hi = self.meta.get("max", 1.0)
        return (X - lo) / span * (out_hi - out_lo) + out_lo


class VectorMinMaxScalerPredictBatchOp(ModelMapBatchOp, HasSelectedCol,
                                       HasOutputCol, HasReservedCols):
    mapper_cls = VectorMinMaxScalerModelMapper


class VectorMaxAbsScalerTrainBatchOp(_VectorStatTrainBase):
    """(reference: VectorMaxAbsScalerTrainBatchOp.java)"""

    _model_name = "VectorMaxAbsScalerModel"

    def _stats(self, X):
        return {"maxAbs": np.abs(X).max(axis=0)}


class VectorMaxAbsScalerModelMapper(_VectorStatModelMapper):
    def _transform(self, X):
        m = np.where(self.arrays["maxAbs"] > 0, self.arrays["maxAbs"], 1.0)
        return X / m


class VectorMaxAbsScalerPredictBatchOp(ModelMapBatchOp, HasSelectedCol,
                                       HasOutputCol, HasReservedCols):
    mapper_cls = VectorMaxAbsScalerModelMapper


class VectorImputerTrainBatchOp(_VectorStatTrainBase):
    """NaN filling for vector columns (reference:
    VectorImputerTrainBatchOp.java — MEAN/MIN/MAX/VALUE strategies)."""

    STRATEGY = ParamInfo("strategy", str, default="MEAN",
                         validator=InValidator("MEAN", "MIN", "MAX",
                                               "VALUE"))
    FILL_VALUE = ParamInfo("fillValue", float, default=0.0)

    _model_name = "VectorImputerModel"

    def _meta_extra(self):
        return {"strategy": self.get(self.STRATEGY)}

    def _stats(self, X):
        strat = self.get(self.STRATEGY)
        with np.errstate(all="ignore"):
            if strat == "MEAN":
                fill = np.nanmean(X, axis=0)
            elif strat == "MIN":
                fill = np.nanmin(X, axis=0)
            elif strat == "MAX":
                fill = np.nanmax(X, axis=0)
            else:
                fill = np.full(X.shape[1], self.get(self.FILL_VALUE))
        return {"fill": np.nan_to_num(fill,
                                      nan=self.get(self.FILL_VALUE))}


class VectorImputerModelMapper(_VectorStatModelMapper):
    def _transform(self, X):
        fill = self.arrays["fill"]
        return np.where(np.isnan(X), fill[None, :], X)


class VectorImputerPredictBatchOp(ModelMapBatchOp, HasSelectedCol,
                                  HasOutputCol, HasReservedCols):
    mapper_cls = VectorImputerModelMapper
