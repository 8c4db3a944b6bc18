"""Feature transforms: Binarizer, Bucketizer, MultiHot, TargetEncoder,
ExclusiveFeatureBundle, MultiStringIndexer, IndexToString (port of
``alink_tpu.operator.batch.feature3``; host-side, copied).

Capability parity (reference: operator/batch/feature/BinarizerBatchOp.java,
BucketizerBatchOp.java, MultiHotTrainBatchOp.java / MultiHotPredictBatchOp
.java, TargetEncoderTrainBatchOp.java / TargetEncoderPredictBatchOp.java,
ExclusiveFeatureBundlePredictBatchOp.java, dataproc/
MultiStringIndexerTrainBatchOp.java / MultiStringIndexerPredictBatchOp.java,
dataproc/IndexToStringPredictBatchOp.java).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from ...common.exceptions import AkIllegalArgumentException
from ...common.linalg import SparseVector, parse_vector
from ...common.model import model_to_table, table_to_model
from ...common.mtable import AlinkTypes, MTable, TableSchema
from ...common.params import ParamInfo
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
from .dataproc import StringIndexerPredictBatchOp, StringIndexerTrainBatchOp
from .utils import MapBatchOp, ModelMapBatchOp, ModelTrainOpMixin


class BinarizerMapper(SISOMapper):
    """Numeric → 0/1 by threshold (reference:
    common/feature/BinarizerMapper.java)."""

    THRESHOLD = ParamInfo("threshold", float, default=0.0)

    def map_column(self, values, type_tag):
        thr = float(self.get(self.THRESHOLD))
        a = np.asarray(values, np.float64)
        return (a > thr).astype(np.float64), AlinkTypes.DOUBLE


class BinarizerBatchOp(MapBatchOp, HasSelectedCol, HasOutputCol,
                       HasReservedCols):
    """(reference: operator/batch/feature/BinarizerBatchOp.java)"""

    mapper_cls = BinarizerMapper
    THRESHOLD = BinarizerMapper.THRESHOLD


class BucketizerMapper(Mapper, HasSelectedCols, HasOutputCols,
                       HasReservedCols):
    """Numeric → bucket index by explicit cut points (reference:
    common/feature/BucketizerMapper.java; cutsArray per column)."""

    CUTS_ARRAY = ParamInfo("cutsArray", list, optional=False,
                           desc="list of cut-point lists, one per column")

    def _io_cols(self):
        in_cols = list(self.get(HasSelectedCols.SELECTED_COLS))
        out_cols = list(self.get(HasOutputCols.OUTPUT_COLS) or in_cols)
        return in_cols, out_cols

    def output_schema(self, input_schema):
        in_cols, out_cols = self._io_cols()
        names, types = list(input_schema.names), list(input_schema.types)
        for oc in out_cols:
            if oc in names:
                types[names.index(oc)] = AlinkTypes.LONG
            else:
                names.append(oc)
                types.append(AlinkTypes.LONG)
        return TableSchema(names, types)

    def map_table(self, t: MTable) -> MTable:
        in_cols, out_cols = self._io_cols()
        cuts = self.get(self.CUTS_ARRAY)
        if len(cuts) != len(in_cols):
            raise AkIllegalArgumentException(
                f"cutsArray has {len(cuts)} entries for {len(in_cols)} cols")
        out = t
        for ic, oc, cut in zip(in_cols, out_cols, cuts):
            edges = np.asarray(sorted(float(c) for c in cut), np.float64)
            idx = np.searchsorted(edges, np.asarray(t.col(ic), np.float64),
                                  side="right")
            out = out.with_column(oc, idx.astype(np.int64), AlinkTypes.LONG)
        return out


class BucketizerBatchOp(MapBatchOp, HasSelectedCols, HasOutputCols,
                        HasReservedCols):
    """(reference: operator/batch/feature/BucketizerBatchOp.java)"""

    mapper_cls = BucketizerMapper
    CUTS_ARRAY = BucketizerMapper.CUTS_ARRAY


# ---------------------------------------------------------------------------
# MultiHot — delimiter-separated token sets → multi-hot sparse vector
# ---------------------------------------------------------------------------


class MultiHotTrainBatchOp(ModelTrainOpMixin, BatchOperator, HasSelectedCols):
    """Collect the token vocabulary of delimiter-separated categorical
    columns (reference: operator/batch/feature/MultiHotTrainBatchOp.java)."""

    DELIMITER = ParamInfo("delimiter", str, default=",")

    _min_inputs = 1
    _max_inputs = 1

    def _execute_impl(self, t: MTable) -> MTable:
        cols = list(self.get(HasSelectedCols.SELECTED_COLS) or t.names)
        delim = self.get(self.DELIMITER)
        vocab: Dict[str, List[str]] = {}
        for c in cols:
            toks = set()
            for v in t.col(c):
                if v is None:
                    continue
                for tok in str(v).split(delim):
                    tok = tok.strip()
                    if tok:
                        toks.add(tok)
            vocab[c] = sorted(toks)
        meta = {"modelName": "MultiHotModel", "selectedCols": cols,
                "delimiter": delim, "vocab": vocab}
        return model_to_table(meta, {})

    def _static_meta_keys(self, in_schema):
        return {"modelName": "MultiHotModel"}


class MultiHotModelMapper(ModelMapper, HasReservedCols, HasOutputCol):
    """Each selected column's token set → one concatenated multi-hot sparse
    vector (reference: common/feature/MultiHotModelMapper.java)."""

    def load_model(self, model: MTable):
        self.meta, _ = table_to_model(model)
        self.luts = {c: {tok: i for i, tok in enumerate(toks)}
                     for c, toks in self.meta["vocab"].items()}
        self.offsets = {}
        off = 0
        for c in self.meta["selectedCols"]:
            self.offsets[c] = off
            off += len(self.luts[c]) + 1  # +1 unseen slot per column
        self.dim = off
        return self

    def output_schema(self, input_schema):
        out = self.get(HasOutputCol.OUTPUT_COL) or "multihot"
        return self._append_result_schema(
            input_schema, [out], [AlinkTypes.SPARSE_VECTOR])

    def map_table(self, t: MTable) -> MTable:
        delim = self.meta["delimiter"]
        cols = self.meta["selectedCols"]
        n = t.num_rows
        vecs = np.empty(n, object)
        col_vals = {c: t.col(c) for c in cols}
        for i in range(n):
            idx = set()
            for c in cols:
                v = col_vals[c][i]
                lut, off = self.luts[c], self.offsets[c]
                if v is None:
                    continue
                for tok in str(v).split(delim):
                    tok = tok.strip()
                    if not tok:
                        continue
                    idx.add(off + lut.get(tok, len(lut)))
            sidx = np.asarray(sorted(idx), np.int64)
            vecs[i] = SparseVector(self.dim, sidx,
                                   np.ones(len(sidx), np.float64))
        out = self.get(HasOutputCol.OUTPUT_COL) or "multihot"
        return self._append_result(
            t, {out: vecs}, {out: AlinkTypes.SPARSE_VECTOR})


class MultiHotPredictBatchOp(ModelMapBatchOp, HasReservedCols, HasOutputCol):
    """(reference: operator/batch/feature/MultiHotPredictBatchOp.java)"""

    mapper_cls = MultiHotModelMapper


# ---------------------------------------------------------------------------
# TargetEncoder — category → smoothed mean label
# ---------------------------------------------------------------------------


class TargetEncoderTrainBatchOp(ModelTrainOpMixin, BatchOperator,
                                HasSelectedCols):
    """Per-category smoothed target means (reference:
    operator/batch/feature/TargetEncoderTrainBatchOp.java; the smoothing
    blends the category mean with the global prior by category count)."""

    LABEL_COL = ParamInfo("labelCol", str, optional=False)
    POSITIVE_LABEL_VALUE_STRING = ParamInfo(
        "positiveLabelValueString", str, default=None,
        desc="treat label as binary with this positive value")
    SMOOTHING = ParamInfo("smoothing", float, default=0.0,
                          desc="pseudo-count blending toward the global mean")

    _min_inputs = 1
    _max_inputs = 1

    def _execute_impl(self, t: MTable) -> MTable:
        label_col = self.get(self.LABEL_COL)
        cols = list(self.get(HasSelectedCols.SELECTED_COLS) or
                    [c for c in t.names if c != label_col])
        pos = self.get(self.POSITIVE_LABEL_VALUE_STRING)
        y_raw = t.col(label_col)
        if pos is not None:
            y = np.asarray([1.0 if str(v) == pos else 0.0 for v in y_raw])
        else:
            y = np.asarray(y_raw, np.float64)
        prior = float(y.mean())
        s = float(self.get(self.SMOOTHING))
        maps: Dict[str, Dict[str, float]] = {}
        for c in cols:
            vals = np.asarray(t.col(c), object).astype(str)
            enc: Dict[str, float] = {}
            for cat in np.unique(vals):
                mask = vals == cat
                cnt = float(mask.sum())
                enc[str(cat)] = (y[mask].sum() + s * prior) / (cnt + s)
            maps[c] = enc
        meta = {"modelName": "TargetEncoderModel", "selectedCols": cols,
                "prior": prior, "encodings": maps}
        return model_to_table(meta, {})

    def _static_meta_keys(self, in_schema):
        return {"modelName": "TargetEncoderModel"}


class TargetEncoderModelMapper(ModelMapper, HasReservedCols, HasOutputCols):
    def load_model(self, model: MTable):
        self.meta, _ = table_to_model(model)
        return self

    def _io_cols(self):
        in_cols = self.meta["selectedCols"]
        out_cols = list(self.get(HasOutputCols.OUTPUT_COLS) or
                        [f"{c}_te" for c in in_cols])
        return in_cols, out_cols

    def output_schema(self, input_schema):
        _, out_cols = self._io_cols()
        return self._append_result_schema(
            input_schema, out_cols, [AlinkTypes.DOUBLE] * len(out_cols))

    def map_table(self, t: MTable) -> MTable:
        in_cols, out_cols = self._io_cols()
        prior = self.meta["prior"]
        add, types = {}, {}
        for ic, oc in zip(in_cols, out_cols):
            enc = self.meta["encodings"][ic]
            vals = np.asarray(t.col(ic), object).astype(str)
            add[oc] = np.asarray([enc.get(v, prior) for v in vals],
                                 np.float64)
            types[oc] = AlinkTypes.DOUBLE
        return self._append_result(t, add, types)


class TargetEncoderPredictBatchOp(ModelMapBatchOp, HasReservedCols,
                                  HasOutputCols):
    """(reference: operator/batch/feature/TargetEncoderPredictBatchOp.java)"""

    mapper_cls = TargetEncoderModelMapper


# ---------------------------------------------------------------------------
# ExclusiveFeatureBundle — LightGBM-style EFB over sparse vectors
# ---------------------------------------------------------------------------


class ExclusiveFeatureBundleTrainBatchOp(ModelTrainOpMixin, BatchOperator):
    """Greedily bundle (almost) mutually-exclusive sparse dims so each bundle
    becomes ONE dense feature (reference: operator/batch/feature/
    ExclusiveFeatureBundlePredictBatchOp.java family — the EFB trick)."""

    SELECTED_COL = ParamInfo("selectedCol", str, optional=False,
                             aliases=("vectorCol",))

    _min_inputs = 1
    _max_inputs = 1

    def _execute_impl(self, t: MTable) -> MTable:
        vec_col = self.get(self.SELECTED_COL)
        vecs = [parse_vector(v) for v in t.col(vec_col)]
        dim = max((v.size() for v in vecs), default=0)
        nz: List[set] = [set() for _ in range(dim)]
        for row, v in enumerate(vecs):
            sv = v if isinstance(v, SparseVector) else None
            idxs = (sv.indices if sv is not None
                    else np.nonzero(v.to_dense().data)[0])
            for j in idxs:
                nz[int(j)].add(row)
        bundles: List[List[int]] = []
        bundle_rows: List[set] = []
        for j in range(dim):
            placed = False
            for b, rows in enumerate(bundle_rows):
                if not (rows & nz[j]):
                    bundles[b].append(j)
                    rows |= nz[j]
                    placed = True
                    break
            if not placed:
                bundles.append([j])
                bundle_rows.append(set(nz[j]))
        meta = {"modelName": "ExclusiveFeatureBundleModel",
                "vectorCol": vec_col, "dim": dim, "bundles": bundles}
        return model_to_table(meta, {})

    def _static_meta_keys(self, in_schema):
        return {"modelName": "ExclusiveFeatureBundleModel"}


class ExclusiveFeatureBundleModelMapper(ModelMapper, HasReservedCols,
                                        HasOutputCol):
    def load_model(self, model: MTable):
        self.meta, _ = table_to_model(model)
        self.slot = np.zeros(self.meta["dim"], np.int64)
        self.local = np.zeros(self.meta["dim"], np.int64)
        for b, dims in enumerate(self.meta["bundles"]):
            for k, j in enumerate(dims):
                self.slot[j] = b
                self.local[j] = k + 1  # 0 = empty
        return self

    def output_schema(self, input_schema):
        out = self.get(HasOutputCol.OUTPUT_COL) or "efb"
        return self._append_result_schema(
            input_schema, [out], [AlinkTypes.DENSE_VECTOR])

    def map_table(self, t: MTable) -> MTable:
        from ...common.linalg import DenseVector

        vec_col = self.meta["vectorCol"]
        nb = len(self.meta["bundles"])
        out_vecs = np.empty(t.num_rows, object)
        for i, v in enumerate(t.col(vec_col)):
            sv = parse_vector(v)
            dense = np.zeros(nb, np.float64)
            if isinstance(sv, SparseVector):
                for j in sv.indices:
                    dense[self.slot[int(j)]] = float(self.local[int(j)])
            else:
                for j in np.nonzero(sv.to_dense().data)[0]:
                    dense[self.slot[int(j)]] = float(self.local[int(j)])
            out_vecs[i] = DenseVector(dense)
        out = self.get(HasOutputCol.OUTPUT_COL) or "efb"
        return self._append_result(
            t, {out: out_vecs}, {out: AlinkTypes.DENSE_VECTOR})


class ExclusiveFeatureBundlePredictBatchOp(ModelMapBatchOp, HasReservedCols,
                                           HasOutputCol):
    """(reference: operator/batch/feature/
    ExclusiveFeatureBundlePredictBatchOp.java)"""

    mapper_cls = ExclusiveFeatureBundleModelMapper


# ---------------------------------------------------------------------------
# MultiStringIndexer / IndexToString
# ---------------------------------------------------------------------------


class MultiStringIndexerTrainBatchOp(StringIndexerTrainBatchOp):
    """Multi-column token indexing in one model — this engine's
    StringIndexer is already multi-column, so the Multi variant IS the
    base trainer (reference: dataproc/MultiStringIndexerTrainBatchOp.java)."""


class MultiStringIndexerPredictBatchOp(StringIndexerPredictBatchOp):
    """(reference: dataproc/MultiStringIndexerPredictBatchOp.java)"""


class IndexToStringModelMapper(ModelMapper, HasSelectedCol, HasOutputCol,
                               HasReservedCols):
    """Inverse of StringIndexer: LONG id → original token using the SAME
    StringIndexer model (reference: dataproc/
    IndexToStringPredictBatchOp.java)."""

    MODEL_NAME_COL = ParamInfo("modelCol", str, default=None,
                               desc="model column to invert; default first")

    def load_model(self, model: MTable):
        self.meta, _ = table_to_model(model)
        return self

    def output_schema(self, input_schema):
        out = (self.get(HasOutputCol.OUTPUT_COL) or
               self.get(HasSelectedCol.SELECTED_COL))
        names, types = list(input_schema.names), list(input_schema.types)
        if out in names:
            types[names.index(out)] = AlinkTypes.STRING
        else:
            names.append(out)
            types.append(AlinkTypes.STRING)
        return TableSchema(names, types)

    def map_table(self, t: MTable) -> MTable:
        sel = self.get(HasSelectedCol.SELECTED_COL)
        out = self.get(HasOutputCol.OUTPUT_COL) or sel
        model_col = (self.get(self.MODEL_NAME_COL) or
                     self.meta["selectedCols"][0])
        toks = self.meta["tokenMaps"][model_col]
        ids = np.asarray(t.col(sel), np.int64)
        vals = np.asarray(
            [toks[i] if 0 <= i < len(toks) else None for i in ids], object)
        return t.with_column(out, vals, AlinkTypes.STRING)


class IndexToStringPredictBatchOp(ModelMapBatchOp, HasSelectedCol,
                                  HasOutputCol, HasReservedCols):
    """(reference: operator/batch/dataproc/IndexToStringPredictBatchOp.java)"""

    mapper_cls = IndexToStringModelMapper
    MODEL_NAME_COL = IndexToStringModelMapper.MODEL_NAME_COL
