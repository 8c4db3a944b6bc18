"""Feature engineering operators (first slice: assembler + scalers; port of
``alink_tpu.operator.batch.feature``, host-side, copied).

Capability parity with the reference (reference:
core/src/main/java/com/alibaba/alink/operator/batch/dataproc/vector/
VectorAssemblerBatchOp.java + common/dataproc/vector/VectorAssemblerMapper.java;
operator/batch/dataproc/StandardScalerTrainBatchOp.java + common/dataproc/
StandardScalerModelMapper.java; MinMaxScaler / MaxAbsScaler equivalents).
"""

from __future__ import annotations

import numpy as np

from ...common.linalg import dense_vectors
from ...common.model import model_to_table, table_to_model
from ...common.mtable import AlinkTypes, MTable
from ...common.params import ParamInfo
from ...mapper import (
    HasOutputCol,
    default_feature_cols,
    HasReservedCols,
    HasSelectedCols,
    Mapper,
    ModelMapper,
)
from .base import BatchOperator
from .utils import MapBatchOp, ModelMapBatchOp, ModelTrainOpMixin


class VectorAssemblerMapper(Mapper, HasSelectedCols, HasOutputCol, HasReservedCols):
    """Combine numeric/vector columns into one vector column."""

    def output_schema(self, input_schema):
        out = self.get(HasOutputCol.OUTPUT_COL) or "vec"
        return self._append_result_schema(input_schema, [out], [AlinkTypes.DENSE_VECTOR])

    def map_table(self, t: MTable) -> MTable:
        cols = self.get(HasSelectedCols.SELECTED_COLS) or default_feature_cols(
            t, include_vectors=True
        )
        out = self.get(HasOutputCol.OUTPUT_COL) or "vec"
        block = t.to_numeric_block(list(cols), dtype=np.float64)
        vecs = dense_vectors(block)
        return self._append_result(
            t, {out: vecs}, {out: AlinkTypes.DENSE_VECTOR}
        )


class VectorAssemblerBatchOp(MapBatchOp, HasSelectedCols, HasOutputCol,
                             HasReservedCols):
    mapper_cls = VectorAssemblerMapper

    # plan validator (analysis/plancheck.py): assembled columns must be
    # numeric or vector — a STRING here fails inside to_numeric_block
    _plan_col_requirements = {"selectedCols": "numvec"}


class StandardScalerTrainBatchOp(ModelTrainOpMixin, BatchOperator, HasSelectedCols):
    """(reference: StandardScalerTrainBatchOp.java) — one distributed moment
    pass; model = (mean, std) per column."""

    WITH_MEAN = ParamInfo("withMean", bool, default=True)
    WITH_STD = ParamInfo("withStd", bool, default=True)

    _min_inputs = 1
    _max_inputs = 1

    # plan validator: selected columns feed the moment kernel — numeric only
    _plan_col_requirements = {"selectedCols": "numeric"}

    def _execute_impl(self, t: MTable) -> MTable:
        cols = list(self.get(HasSelectedCols.SELECTED_COLS) or
                    default_feature_cols(t))
        X = t.to_numeric_block(cols, dtype=np.float64)
        mean = X.mean(axis=0)
        # sample std (n-1), matching the reference's
        # TableSummary.standardDeviation (basicstatistic/TableSummary.java)
        std = X.std(axis=0, ddof=1) if X.shape[0] > 1 else np.ones(X.shape[1])
        meta = {
            "modelName": "StandardScalerModel",
            "selectedCols": cols,
            "withMean": self.get(self.WITH_MEAN),
            "withStd": self.get(self.WITH_STD),
        }
        return model_to_table(meta, {"mean": mean, "std": std})

    def _static_meta_keys(self, in_schema):
        cols = list(self.get(HasSelectedCols.SELECTED_COLS) or
                    default_feature_cols(in_schema))
        return {"modelName": "StandardScalerModel", "selectedCols": cols}


def _retype_double(schema, cols):
    from ...common.mtable import TableSchema

    types = [
        AlinkTypes.DOUBLE if n in cols else t
        for n, t in zip(schema.names, schema.types)
    ]
    return TableSchema(list(schema.names), types)


class StandardScalerModelMapper(ModelMapper, HasReservedCols):
    def load_model(self, model: MTable):
        self.meta, arrays = table_to_model(model)
        self.mean = arrays["mean"]
        self.std = np.where(arrays["std"] < 1e-12, 1.0, arrays["std"])
        return self

    def output_schema(self, input_schema):
        return _retype_double(input_schema, self.meta["selectedCols"])

    def map_table(self, t: MTable) -> MTable:
        cols = self.meta["selectedCols"]
        out = t
        for i, c in enumerate(cols):
            v = np.asarray(t.col(c), np.float64)
            if self.meta["withMean"]:
                v = v - self.mean[i]
            if self.meta["withStd"]:
                v = v / self.std[i]
            out = out.with_column(c, v, AlinkTypes.DOUBLE)
        return out


class StandardScalerPredictBatchOp(ModelMapBatchOp, HasReservedCols):
    mapper_cls = StandardScalerModelMapper


class MinMaxScalerTrainBatchOp(ModelTrainOpMixin, BatchOperator, HasSelectedCols):
    """(reference: MinMaxScalerTrainBatchOp.java)"""

    MIN = ParamInfo("min", float, default=0.0)
    MAX = ParamInfo("max", float, default=1.0)

    _min_inputs = 1
    _max_inputs = 1

    _plan_col_requirements = {"selectedCols": "numeric"}

    def _execute_impl(self, t: MTable) -> MTable:
        cols = list(self.get(HasSelectedCols.SELECTED_COLS) or
                    default_feature_cols(t))
        X = t.to_numeric_block(cols, dtype=np.float64)
        meta = {
            "modelName": "MinMaxScalerModel",
            "selectedCols": cols,
            "targetMin": self.get(self.MIN),
            "targetMax": self.get(self.MAX),
        }
        return model_to_table(
            meta, {"dataMin": X.min(axis=0), "dataMax": X.max(axis=0)}
        )

    def _static_meta_keys(self, in_schema):
        cols = list(self.get(HasSelectedCols.SELECTED_COLS) or
                    default_feature_cols(in_schema))
        return {"modelName": "MinMaxScalerModel", "selectedCols": cols}


class MinMaxScalerModelMapper(ModelMapper, HasReservedCols):
    def load_model(self, model: MTable):
        self.meta, arrays = table_to_model(model)
        self.dmin = arrays["dataMin"]
        rng = arrays["dataMax"] - arrays["dataMin"]
        self.range = np.where(rng < 1e-12, 1.0, rng)
        return self

    def output_schema(self, input_schema):
        return _retype_double(input_schema, self.meta["selectedCols"])

    def map_table(self, t: MTable) -> MTable:
        lo, hi = self.meta["targetMin"], self.meta["targetMax"]
        out = t
        for i, c in enumerate(self.meta["selectedCols"]):
            v = np.asarray(t.col(c), np.float64)
            v = (v - self.dmin[i]) / self.range[i] * (hi - lo) + lo
            out = out.with_column(c, v, AlinkTypes.DOUBLE)
        return out


class MinMaxScalerPredictBatchOp(ModelMapBatchOp, HasReservedCols):
    mapper_cls = MinMaxScalerModelMapper
