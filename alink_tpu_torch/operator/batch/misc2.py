"""Final reference-surface closure: address parsing, sparse feature
indexing, SOM direct op, PSI capitalization, public base-class names (port
of ``alink_tpu.operator.batch.misc2``).

Capability parity (reference: operator/batch/nlp/AddressParserBatchOp.java;
dataproc/SparseFeatureIndexerTrainBatchOp.java /
SparseFeatureIndexerPredictBatchOp.java; clustering/SomBatchOp.java;
finance/PSIBatchOp.java; the Base* public base classes under
operator/batch and operator/stream).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from ...common.linalg import SparseVector
from ...common.model import model_to_table, table_to_model
from ...common.mtable import AlinkTypes, MTable
from ...common.params import ParamInfo
from ...mapper import (
    HasOutputCol,
    HasReservedCols,
    HasSelectedCol,
    ModelMapper,
    SISOMapper,
)
from .base import BatchOperator
from .clustering2 import SomPredictBatchOp, SomTrainBatchOp
from .finance import PsiBatchOp
from .utils import MapBatchOp, ModelMapBatchOp, ModelTrainOpMixin


# ---------------------------------------------------------------------------
# address parsing
# ---------------------------------------------------------------------------

# administrative suffixes, longest-first (reference: the AddressParser
# dictionary; this compact rule set covers the suffix-delimited form)
_ADDR_PARTS = [
    ("province", ("省", "自治区")),
    ("city", ("市", "自治州", "盟")),
    ("district", ("区", "县", "旗")),
    ("street", ("街道", "镇", "乡")),
    ("road", ("路", "街", "道", "巷")),
    ("number", ("号", "弄")),
]


class AddressParserMapper(SISOMapper):
    """Split a Chinese address string into administrative parts by suffix
    scanning (reference: operator/batch/nlp/AddressParserBatchOp.java —
    the reference resolves against a gazetteer; the suffix grammar covers
    the standard written form)."""

    def map_table(self, t: MTable) -> MTable:
        sel = self.get(HasSelectedCol.SELECTED_COL)
        cols: Dict[str, List] = {name: [] for name, _ in _ADDR_PARTS}
        for v in t.col(sel):
            rest = str(v) if v is not None else ""
            for name, suffixes in _ADDR_PARTS:
                match = None
                for suf in suffixes:
                    idx = rest.find(suf)
                    if idx >= 0 and (match is None or idx + len(suf) <
                                     match[1]):
                        match = (idx, idx + len(suf))
                if match:
                    cols[name].append(rest[:match[1]])
                    rest = rest[match[1]:]
                else:
                    cols[name].append(None)
        add = {k: np.asarray(vs, object) for k, vs in cols.items()}
        types = {k: AlinkTypes.STRING for k in add}
        return self._append_result(t, add, types)

    def output_schema(self, input_schema):
        names = [name for name, _ in _ADDR_PARTS]
        return self._append_result_schema(
            input_schema, names, [AlinkTypes.STRING] * len(names))

    def map_column(self, values, type_tag):
        raise NotImplementedError


class AddressParserBatchOp(MapBatchOp, HasSelectedCol, HasReservedCols):
    """(reference: operator/batch/nlp/AddressParserBatchOp.java)"""

    mapper_cls = AddressParserMapper


# ---------------------------------------------------------------------------
# sparse feature indexer
# ---------------------------------------------------------------------------


class SparseFeatureIndexerTrainBatchOp(ModelTrainOpMixin, BatchOperator,
                                       HasSelectedCol):
    """Collect the feature-NAME vocabulary of a ``name:value`` sparse string
    column so string-keyed features serve as contiguous indices (reference:
    operator/batch/dataproc/SparseFeatureIndexerTrainBatchOp.java)."""

    KV_DELIMITER = ParamInfo("kvValDelimiter", str, default=":",
                             aliases=("valDelimiter",))
    FEATURE_DELIMITER = ParamInfo("spareFeatureDelimiter", str, default=",",
                                  aliases=("featureDelimiter",))
    MIN_FREQUENCY = ParamInfo("minFrequency", int, default=-1)

    _min_inputs = 1
    _max_inputs = 1

    def _static_meta_keys(self, in_schema):
        return {"modelName": "SparseFeatureIndexerModel"}

    def _execute_impl(self, t: MTable) -> MTable:
        from collections import Counter

        fd = self.get(self.FEATURE_DELIMITER)
        kd = self.get(self.KV_DELIMITER)
        counts: Counter = Counter()
        for v in t.col(self.get(HasSelectedCol.SELECTED_COL)):
            if v is None:
                continue
            for part in str(v).split(fd):
                name = part.split(kd, 1)[0].strip()
                if name:
                    counts[name] += 1
        min_freq = int(self.get(self.MIN_FREQUENCY))
        vocab = sorted(k for k, c in counts.items()
                       if min_freq <= 0 or c >= min_freq)
        meta = {"modelName": "SparseFeatureIndexerModel",
                "selectedCol": self.get(HasSelectedCol.SELECTED_COL),
                "kvDelimiter": kd, "featureDelimiter": fd,
                "vocab": vocab}
        return model_to_table(meta, {})


class SparseFeatureIndexerPredictMapper(ModelMapper, HasSelectedCol,
                                        HasOutputCol, HasReservedCols):
    def load_model(self, model: MTable):
        self.meta, _ = table_to_model(model)
        self.lut = {k: i for i, k in enumerate(self.meta["vocab"])}
        return self

    def output_schema(self, input_schema):
        out = self.get(HasOutputCol.OUTPUT_COL) or "indexed"
        return self._append_result_schema(
            input_schema, [out], [AlinkTypes.SPARSE_VECTOR])

    def map_table(self, t: MTable) -> MTable:
        sel = (self.get(HasSelectedCol.SELECTED_COL) or
               self.meta["selectedCol"])
        out = self.get(HasOutputCol.OUTPUT_COL) or "indexed"
        fd = self.meta["featureDelimiter"]
        kd = self.meta["kvDelimiter"]
        dim = len(self.lut)
        vecs = np.empty(t.num_rows, object)
        for i, v in enumerate(t.col(sel)):
            idx, vals = [], []
            if v is not None:
                for part in str(v).split(fd):
                    if not part.strip():
                        continue
                    name, _, val = part.partition(kd)
                    j = self.lut.get(name.strip())
                    if j is None:
                        continue  # out-of-vocabulary features drop
                    idx.append(j)
                    vals.append(float(val) if val else 1.0)
            order = np.argsort(idx) if idx else []
            vecs[i] = SparseVector(
                dim, np.asarray(idx, np.int64)[order]
                if len(idx) else np.asarray([], np.int64),
                np.asarray(vals, np.float64)[order]
                if len(vals) else np.asarray([], np.float64))
        return self._append_result(
            t, {out: vecs}, {out: AlinkTypes.SPARSE_VECTOR})


class SparseFeatureIndexerPredictBatchOp(ModelMapBatchOp, HasSelectedCol,
                                         HasOutputCol, HasReservedCols):
    """(reference: operator/batch/dataproc/
    SparseFeatureIndexerPredictBatchOp.java)"""

    mapper_cls = SparseFeatureIndexerPredictMapper


# ---------------------------------------------------------------------------
# SOM direct op + PSI capitalization
# ---------------------------------------------------------------------------


class SomBatchOp(BatchOperator):
    """Direct SOM: train the map and emit each row's BMU coordinates in one
    op (reference: operator/batch/clustering/SomBatchOp.java)."""

    _min_inputs = 1
    _max_inputs = 1

    def _execute_impl(self, t: MTable) -> MTable:
        model = SomTrainBatchOp(self.get_params().clone())._execute_impl(t)
        pred = SomPredictBatchOp(self.get_params().clone())
        mapper = pred._make_mapper(model.schema, t.schema)
        mapper.load_model(model)
        return mapper.map_table(t)

    def _out_schema(self, in_schema):
        return SomPredictBatchOp(
            self.get_params().clone())._out_schema(None, in_schema)


class PSIBatchOp(PsiBatchOp):
    """(reference: operator/batch/finance/PSIBatchOp.java — the reference's
    capitalization of the population-stability-index op)."""


# surface the SOM trainer's ParamInfos on the direct op
from ...common.params import copy_param_infos as _cpi  # noqa: E402

_cpi(SomTrainBatchOp, SomBatchOp)



# ---------------------------------------------------------------------------
# public base-class names (reference exposes these abstract bases in its
# operator listing; each maps onto the engine's real base)
# ---------------------------------------------------------------------------


class BaseSourceBatchOp(BatchOperator):
    """Public base of batch sources (reference: operator/batch/source/
    BaseSourceBatchOp.java). Sources take no inputs."""

    _max_inputs = 0


class BaseSinkBatchOp(BatchOperator):
    """Public base of batch sinks (reference: operator/batch/sink/
    BaseSinkBatchOp.java)."""

    _min_inputs = 1
    _max_inputs = 1
    # the plan validator must never zero-row-probe a sink's _execute_impl
    # (it performs the write); sinks pass their input schema through
    _plan_passthrough = True


class BaseSqlApiBatchOp(BatchOperator):
    """Public base of the SQL-sugar ops (reference: operator/batch/sql/
    BaseSqlApiBatchOp.java)."""


class BaseFormatTransBatchOp(BatchOperator):
    """Public base of the format-conversion family (reference:
    operator/batch/dataproc/format/BaseFormatTransBatchOp.java — the pair
    ops metaprogram from the shared FormatMapper here)."""


class BaseRecommBatchOp(ModelMapBatchOp):
    """Public base of the recommendation serving ops (reference:
    operator/batch/recommendation/BaseRecommBatchOp.java)."""


class BaseNearestNeighborTrainBatchOp(ModelTrainOpMixin, BatchOperator):
    """Public base of the nearest-neighbor trainers (reference:
    operator/batch/similarity/BaseNearestNeighborTrainBatchOp.java)."""
