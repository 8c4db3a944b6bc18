"""Feature-engineering breadth: OneHot, PCA, discretizers, binning+WOE,
feature hashing, chi-square selection (port of
``alink_tpu.operator.batch.feature2``).

Capability parity with the reference feature package (reference:
core/src/main/java/com/alibaba/alink/operator/batch/feature/
OneHotTrainBatchOp.java:64 + common/feature/OneHotModelMapper.java,
PcaTrainBatchOp.java:53 + common/feature/pca/,
QuantileDiscretizerTrainBatchOp.java, EqualWidthDiscretizerTrainBatchOp.java,
BinningTrainBatchOp.java + common/feature/binning/FeatureBinsCalculator.java
(WOE at common/feature/binning/WoeUtils), FeatureHasherBatchOp.java
(common/feature/FeatureHasherMapper.java), ChiSqSelectorBatchOp.java
(common/feature/ChiSquareSelectorUtil)).

Re-design notes:
- OneHot / StringIndexer token maps are numpy unique passes; serving encodes
  whole blocks at once into one assembled SparseVector per row.
- PCA is an eigendecomposition of the covariance (or correlation) matrix on
  the host, as the reference's; the projection mapper runs on the session's
  device, in float64 (the reference's jitted projection runs in float32).
- Binning computes per-bin positive/negative counts with one one-hot matmul
  (same trick as NaiveBayes stats) and derives WOE/IV host-side.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from ...common.linalg import SparseVector, dense_vectors, parse_vector
from ...common.model import model_to_table, table_to_model
from ...common.mtable import AlinkTypes, MTable, TableSchema
from ...common.params import InValidator, MinValidator, ParamInfo
from ...mapper import (
    HasOutputCol,
    HasSelectedCol,
    HasReservedCols,
    HasSelectedCols,
    Mapper,
    ModelMapper,
    default_feature_cols,
)
from .base import BatchOperator
from .utils import MapBatchOp, ModelMapBatchOp, ModelTrainOpMixin


# ---------------------------------------------------------------------------
# OneHot
# ---------------------------------------------------------------------------

class OneHotTrainBatchOp(ModelTrainOpMixin, BatchOperator, HasSelectedCols):
    """Distinct-token index per selected column (reference:
    OneHotTrainBatchOp.java:64 — token→index pairs per column)."""

    DROP_LAST = ParamInfo("dropLast", bool, default=True)

    _min_inputs = 1
    _max_inputs = 1

    def _execute_impl(self, t: MTable) -> MTable:
        cols = list(self.get(HasSelectedCols.SELECTED_COLS) or t.names)
        token_maps: Dict[str, List[str]] = {}
        for c in cols:
            vals = np.asarray(t.col(c), dtype=object).astype(str)
            token_maps[c] = sorted(np.unique(vals).tolist())
        meta = {
            "modelName": "OneHotModel",
            "selectedCols": cols,
            "dropLast": self.get(self.DROP_LAST),
            "tokenMaps": token_maps,
        }
        return model_to_table(meta, {})

    def _static_meta_keys(self, in_schema):
        return {"modelName": "OneHotModel",
                "selectedCols": list(self.get(HasSelectedCols.SELECTED_COLS) or
                                     in_schema.names)}


class OneHotModelMapper(ModelMapper, HasOutputCol, HasReservedCols):
    """Encodes the selected columns into ONE assembled sparse vector
    (reference: common/feature/OneHotModelMapper.java, ASSEMBLED_VECTOR
    encode). Unseen tokens map to a per-column "invalid" slot."""

    def load_model(self, model: MTable):
        self.meta, _ = table_to_model(model)
        drop_last = self.meta["dropLast"]
        # Per column with T tokens:
        #   dropLast:  slots = T-1 real (last category → all-zeros) + 1 invalid
        #   else:      slots = T real + 1 invalid
        self.lookups = {}
        self.sizes = []
        for c in self.meta["selectedCols"]:
            tokens = self.meta["tokenMaps"][c]
            T = len(tokens)
            if drop_last:
                lut = {tok: i for i, tok in enumerate(tokens[:-1])}
                size = T  # T-1 real slots + invalid slot at T-1
            else:
                lut = {tok: i for i, tok in enumerate(tokens)}
                size = T + 1  # invalid slot at T
            self.lookups[c] = lut
            self.sizes.append(size)
        self.offsets = np.concatenate([[0], np.cumsum(self.sizes)])
        self.total = int(self.offsets[-1])
        return self

    def output_schema(self, input_schema):
        out = self.get(HasOutputCol.OUTPUT_COL) or "onehot"
        return self._append_result_schema(
            input_schema, [out], [AlinkTypes.SPARSE_VECTOR])

    def map_table(self, t: MTable) -> MTable:
        out = self.get(HasOutputCol.OUTPUT_COL) or "onehot"
        cols = self.meta["selectedCols"]
        drop_last = self.meta["dropLast"]
        n = t.num_rows
        per_col_idx = []
        for j, c in enumerate(cols):
            lut = self.lookups[c]
            tokens = self.meta["tokenMaps"][c]
            invalid_slot = self.sizes[j] - 1
            vals = np.asarray(t.col(c), dtype=object).astype(str)
            # each distinct token's slot once, then gathered per row
            uniq, inv = np.unique(vals, return_inverse=True)
            slots = np.empty(len(uniq), np.int64)
            for u, v in enumerate(uniq):
                if v in lut:
                    slots[u] = lut[v] + self.offsets[j]
                elif drop_last and tokens and v == tokens[-1]:
                    slots[u] = -1  # dropped last category → no slot
                else:
                    slots[u] = invalid_slot + self.offsets[j]
            per_col_idx.append(slots[inv.reshape(-1)])
        stacked = np.stack(per_col_idx, axis=1)  # (n, num_cols)
        # the columns' slot ranges ascend, so each row's kept slots are
        # sorted: a slice of the flat arrays is each row's vector
        keep = stacked >= 0
        flat = stacked[keep]
        ones = np.ones(flat.size)
        ends = np.cumsum(keep.sum(axis=1)).tolist()
        vecs = np.empty(n, object)
        start = 0
        for i, end in enumerate(ends):
            vecs[i] = SparseVector.from_sorted(self.total, flat[start:end],
                                               ones[start:end])
            start = end
        return self._append_result(
            t, {out: vecs}, {out: AlinkTypes.SPARSE_VECTOR})


class OneHotPredictBatchOp(ModelMapBatchOp, HasOutputCol, HasReservedCols):
    mapper_cls = OneHotModelMapper


# ---------------------------------------------------------------------------
# PCA
# ---------------------------------------------------------------------------

class PcaTrainBatchOp(ModelTrainOpMixin, BatchOperator, HasSelectedCols):
    """(reference: PcaTrainBatchOp.java:53 — covariance/correlation eigen
    decomposition; CALC_TYPE CORR standardizes first)."""

    K = ParamInfo("k", int, optional=False, validator=MinValidator(1))
    CALCULATION_TYPE = ParamInfo(
        "calculationType", str, default="CORR",
        validator=InValidator("CORR", "COV"))
    VECTOR_COL = ParamInfo("vectorCol", str)

    _min_inputs = 1
    _max_inputs = 1

    def _execute_impl(self, t: MTable) -> MTable:
        vec_col = self.get(self.VECTOR_COL)
        if vec_col:
            X = np.stack([parse_vector(v).to_dense().data
                          for v in t.col(vec_col)])
            cols = None
        else:
            cols = list(self.get(HasSelectedCols.SELECTED_COLS) or
                        default_feature_cols(t))
            X = t.to_numeric_block(cols, dtype=np.float64)
        k = int(self.get(self.K))
        mean = X.mean(axis=0)
        std = X.std(axis=0, ddof=0)
        std = np.where(std < 1e-12, 1.0, std)
        if self.get(self.CALCULATION_TYPE) == "CORR":
            Xc = (X - mean) / std
        else:
            Xc = X - mean
            std = np.ones_like(std)
        cov = Xc.T @ Xc / max(X.shape[0] - 1, 1)
        evals, evecs = np.linalg.eigh(cov)
        order = np.argsort(evals)[::-1][:k]
        components = evecs[:, order]          # (d, k)
        variances = np.maximum(evals[order], 0.0)
        meta = {
            "modelName": "PcaModel",
            "selectedCols": cols,
            "vectorCol": vec_col,
            "k": k,
            "calculationType": self.get(self.CALCULATION_TYPE),
            "explainedVarianceRatio":
                [float(v) for v in variances / max(evals.sum(), 1e-300)],
        }
        return model_to_table(meta, {
            "mean": mean, "std": std, "components": components,
            "variances": variances,
        })

    def _static_meta_keys(self, in_schema):
        return {"modelName": "PcaModel", "k": self.get(self.K)}


class PcaModelMapper(ModelMapper, HasOutputCol, HasReservedCols):
    def load_model(self, model: MTable):
        import torch

        from ...common.env import resolve_device

        self.meta, arrays = table_to_model(model)
        self._device = resolve_device(self.device)
        self._mean, self._std, self._W = (
            torch.as_tensor(np.asarray(arrays[n], np.float64),
                            device=self._device)
            for n in ("mean", "std", "components"))
        return self

    def project(self, X: np.ndarray) -> np.ndarray:
        """((X − mean) / std) @ components on the device, float64."""
        import torch

        Xd = torch.as_tensor(np.asarray(X, np.float64), device=self._device)
        return (((Xd - self._mean) / self._std) @ self._W).cpu().numpy()

    def output_schema(self, input_schema):
        out = self.get(HasOutputCol.OUTPUT_COL) or "pca"
        return self._append_result_schema(
            input_schema, [out], [AlinkTypes.DENSE_VECTOR])

    def map_table(self, t: MTable) -> MTable:
        out = self.get(HasOutputCol.OUTPUT_COL) or "pca"
        vec_col = self.meta.get("vectorCol")
        if vec_col:
            X = np.stack([parse_vector(v).to_dense().data
                          for v in t.col(vec_col)])
        else:
            X = t.to_numeric_block(self.meta["selectedCols"], dtype=np.float64)
        vecs = dense_vectors(self.project(X))
        return self._append_result(t, {out: vecs},
                                   {out: AlinkTypes.DENSE_VECTOR})


class PcaPredictBatchOp(ModelMapBatchOp, HasOutputCol, HasReservedCols):
    mapper_cls = PcaModelMapper


# ---------------------------------------------------------------------------
# Discretizers
# ---------------------------------------------------------------------------

class _BaseDiscretizerTrainOp(ModelTrainOpMixin, BatchOperator, HasSelectedCols):
    NUM_BUCKETS = ParamInfo("numBuckets", int, default=10,
                            validator=MinValidator(2))

    _min_inputs = 1
    _max_inputs = 1

    model_name: str = None

    def _cuts_for(self, arr: np.ndarray, nb: int) -> List[float]:
        raise NotImplementedError

    def _execute_impl(self, t: MTable) -> MTable:
        cols = list(self.get(HasSelectedCols.SELECTED_COLS) or
                    default_feature_cols(t))
        nb = int(self.get(self.NUM_BUCKETS))
        cutsmap = {}
        for c in cols:
            arr = np.asarray(t.col(c), np.float64)
            cutsmap[c] = [float(v) for v in self._cuts_for(arr[~np.isnan(arr)], nb)]
        meta = {"modelName": self.model_name, "selectedCols": cols,
                "cutsMap": cutsmap}
        return model_to_table(meta, {})

    def _static_meta_keys(self, in_schema):
        cols = list(self.get(HasSelectedCols.SELECTED_COLS) or
                    default_feature_cols(in_schema))
        return {"modelName": self.model_name, "selectedCols": cols}


class QuantileDiscretizerTrainBatchOp(_BaseDiscretizerTrainOp):
    """(reference: QuantileDiscretizerTrainBatchOp.java — distributed quantile
    sketch collapses to one sort per column)."""

    model_name = "QuantileDiscretizerModel"

    def _cuts_for(self, arr, nb):
        qs = np.quantile(arr, np.linspace(0, 1, nb + 1)[1:-1]) if arr.size else []
        return sorted(set(float(q) for q in qs))


class EqualWidthDiscretizerTrainBatchOp(_BaseDiscretizerTrainOp):
    """(reference: EqualWidthDiscretizerTrainBatchOp.java)."""

    model_name = "EqualWidthDiscretizerModel"

    def _cuts_for(self, arr, nb):
        if not arr.size:
            return []
        lo, hi = float(arr.min()), float(arr.max())
        if hi <= lo:
            return []
        return list(np.linspace(lo, hi, nb + 1)[1:-1])


class DiscretizerModelMapper(ModelMapper, HasReservedCols):
    """Replaces each selected column by its LONG bucket index (reference:
    common/feature/QuantileDiscretizerModelMapper.java)."""

    def load_model(self, model: MTable):
        self.meta, _ = table_to_model(model)
        self.cuts = {c: np.asarray(v, np.float64)
                     for c, v in self.meta["cutsMap"].items()}
        return self

    def output_schema(self, input_schema):
        cols = set(self.meta["selectedCols"])
        types = [AlinkTypes.LONG if n in cols else t
                 for n, t in zip(input_schema.names, input_schema.types)]
        return TableSchema(list(input_schema.names), types)

    def map_table(self, t: MTable) -> MTable:
        out = t
        for c in self.meta["selectedCols"]:
            arr = np.asarray(t.col(c), np.float64)
            idx = np.searchsorted(self.cuts[c], arr, side="right")
            out = out.with_column(c, idx.astype(np.int64), AlinkTypes.LONG)
        return out


class QuantileDiscretizerPredictBatchOp(ModelMapBatchOp, HasReservedCols):
    mapper_cls = DiscretizerModelMapper


class EqualWidthDiscretizerPredictBatchOp(ModelMapBatchOp, HasReservedCols):
    mapper_cls = DiscretizerModelMapper


# ---------------------------------------------------------------------------
# Binning + WOE
# ---------------------------------------------------------------------------

class BinningTrainBatchOp(ModelTrainOpMixin, BatchOperator, HasSelectedCols):
    """Numeric binning with per-bin WOE/IV against a binary label
    (reference: BinningTrainBatchOp.java + common/feature/binning/
    FeatureBinsCalculator.java; WOE = ln(posRate/negRate) per bin)."""

    LABEL_COL = ParamInfo("labelCol", str, optional=False)
    NUM_BUCKETS = ParamInfo("numBuckets", int, default=10,
                            validator=MinValidator(2))
    POSITIVE_LABEL = ParamInfo("positiveLabelValueString", str,
                               aliases=("positiveValue",))
    BINNING_METHOD = ParamInfo(
        "binningMethod", str, default="QUANTILE",
        validator=InValidator("QUANTILE", "BUCKET"))

    _min_inputs = 1
    _max_inputs = 1

    def _execute_impl(self, t: MTable) -> MTable:
        label_col = self.get(self.LABEL_COL)
        cols = list(self.get(HasSelectedCols.SELECTED_COLS) or
                    default_feature_cols(t, exclude=[label_col]))
        nb = int(self.get(self.NUM_BUCKETS))
        y_raw = np.asarray(t.col(label_col), dtype=object).astype(str)
        pos_label = self.get(self.POSITIVE_LABEL)
        if pos_label is None:
            pos_label = sorted(np.unique(y_raw).tolist())[0]
        y = (y_raw == str(pos_label)).astype(np.float64)
        total_pos = max(y.sum(), 0.5)
        total_neg = max((1 - y).sum(), 0.5)

        cutsmap, woemap, ivmap, statsmap = {}, {}, {}, {}
        for c in cols:
            arr = np.asarray(t.col(c), np.float64)
            ok = ~np.isnan(arr)
            if self.get(self.BINNING_METHOD) == "QUANTILE":
                qs = np.quantile(arr[ok], np.linspace(0, 1, nb + 1)[1:-1])
                cuts = sorted(set(float(q) for q in qs))
            else:
                lo, hi = float(arr[ok].min()), float(arr[ok].max())
                cuts = list(np.linspace(lo, hi, nb + 1)[1:-1]) if hi > lo else []
            idx = np.searchsorted(np.asarray(cuts), arr, side="right")
            k = len(cuts) + 1
            pos = np.zeros(k)
            neg = np.zeros(k)
            np.add.at(pos, idx[ok], y[ok])
            np.add.at(neg, idx[ok], 1 - y[ok])
            # smoothed WOE: ln((pos_i/total_pos)/(neg_i/total_neg))
            pr = np.maximum(pos, 0.5) / total_pos
            nr = np.maximum(neg, 0.5) / total_neg
            woe = np.log(pr / nr)
            iv = float(((pr - nr) * woe).sum())
            cutsmap[c] = cuts
            woemap[c] = [float(v) for v in woe]
            ivmap[c] = iv
            statsmap[c] = {"positive": [float(v) for v in pos],
                           "negative": [float(v) for v in neg]}
        meta = {
            "modelName": "BinningModel",
            "selectedCols": cols,
            "labelCol": label_col,
            "positiveLabel": str(pos_label),
            "cutsMap": cutsmap,
            "woeMap": woemap,
            "ivMap": ivmap,
            "binStats": statsmap,
        }
        return model_to_table(meta, {})

    def _static_meta_keys(self, in_schema):
        label_col = self.get(self.LABEL_COL)
        cols = list(self.get(HasSelectedCols.SELECTED_COLS) or
                    default_feature_cols(in_schema, exclude=[label_col]))
        return {"modelName": "BinningModel", "selectedCols": cols}


class BinningModelMapper(ModelMapper, HasReservedCols):
    """encode=WOE replaces values by bin WOE (DOUBLE); encode=INDEX by the
    LONG bin id (reference: common/feature/binning/BinningModelMapper.java)."""

    ENCODE = ParamInfo("encode", str, default="WOE",
                       validator=InValidator("WOE", "INDEX"))

    def load_model(self, model: MTable):
        self.meta, _ = table_to_model(model)
        self.cuts = {c: np.asarray(v, np.float64)
                     for c, v in self.meta["cutsMap"].items()}
        self.woe = {c: np.asarray(v, np.float64)
                    for c, v in self.meta["woeMap"].items()}
        return self

    def output_schema(self, input_schema):
        cols = set(self.meta["selectedCols"])
        enc = self.get(self.ENCODE)
        tag = AlinkTypes.DOUBLE if enc == "WOE" else AlinkTypes.LONG
        types = [tag if n in cols else t
                 for n, t in zip(input_schema.names, input_schema.types)]
        return TableSchema(list(input_schema.names), types)

    def map_table(self, t: MTable) -> MTable:
        enc = self.get(self.ENCODE)
        out = t
        for c in self.meta["selectedCols"]:
            arr = np.asarray(t.col(c), np.float64)
            idx = np.searchsorted(self.cuts[c], arr, side="right")
            if enc == "WOE":
                out = out.with_column(c, self.woe[c][idx], AlinkTypes.DOUBLE)
            else:
                out = out.with_column(c, idx.astype(np.int64), AlinkTypes.LONG)
        return out


class BinningPredictBatchOp(ModelMapBatchOp, HasReservedCols):
    mapper_cls = BinningModelMapper
    ENCODE = BinningModelMapper.ENCODE


# ---------------------------------------------------------------------------
# Feature hashing (stateless)
# ---------------------------------------------------------------------------

def _hash32(s: str) -> int:
    """Deterministic FNV-1a 32-bit (stable across processes, unlike hash())."""
    h = 0x811C9DC5
    for b in s.encode("utf-8"):
        h = ((h ^ b) * 0x01000193) & 0xFFFFFFFF
    return h


class FeatureHasherMapper(Mapper, HasSelectedCols, HasOutputCol, HasReservedCols):
    """Hashing-trick sparse encoding of mixed categorical/numeric columns
    (reference: common/feature/FeatureHasherMapper.java)."""

    NUM_FEATURES = ParamInfo("numFeatures", int, default=262144,
                             validator=MinValidator(2))
    CATEGORICAL_COLS = ParamInfo("categoricalCols", list)

    def output_schema(self, input_schema):
        out = self.get(HasOutputCol.OUTPUT_COL) or "hashed"
        return self._append_result_schema(
            input_schema, [out], [AlinkTypes.SPARSE_VECTOR])

    def map_table(self, t: MTable) -> MTable:
        out = self.get(HasOutputCol.OUTPUT_COL) or "hashed"
        cols = list(self.get(HasSelectedCols.SELECTED_COLS) or t.names)
        cat_cols = set(self.get(self.CATEGORICAL_COLS) or
                       [c for c in cols
                        if not AlinkTypes.is_numeric(t.schema.type_of(c))])
        m = int(self.get(self.NUM_FEATURES))
        n = t.num_rows
        acc: List[Dict[int, float]] = [dict() for _ in range(n)]
        for c in cols:
            vals = t.col(c)
            if c in cat_cols:
                for i, v in enumerate(vals):
                    slot = _hash32(f"{c}={v}") % m
                    acc[i][slot] = acc[i].get(slot, 0.0) + 1.0
            else:
                slot = _hash32(c) % m
                arr = np.asarray(vals, np.float64)
                for i in range(n):
                    acc[i][slot] = acc[i].get(slot, 0.0) + float(arr[i])
        vecs = np.asarray(
            [SparseVector(m, list(d.keys()), list(d.values())) for d in acc],
            object)
        return self._append_result(t, {out: vecs},
                                   {out: AlinkTypes.SPARSE_VECTOR})


class FeatureHasherBatchOp(MapBatchOp, HasSelectedCols, HasOutputCol,
                           HasReservedCols):
    mapper_cls = FeatureHasherMapper
    NUM_FEATURES = FeatureHasherMapper.NUM_FEATURES
    CATEGORICAL_COLS = FeatureHasherMapper.CATEGORICAL_COLS


# ---------------------------------------------------------------------------
# Chi-square feature selection
# ---------------------------------------------------------------------------

class ChiSqSelectorBatchOp(ModelTrainOpMixin, BatchOperator, HasSelectedCols):
    """Select top-k features by chi-square score against the label
    (reference: ChiSqSelectorBatchOp.java)."""

    LABEL_COL = ParamInfo("labelCol", str, optional=False)
    NUM_TOP_FEATURES = ParamInfo("numTopFeatures", int, default=50,
                                 validator=MinValidator(1))

    _min_inputs = 1
    _max_inputs = 1

    def _execute_impl(self, t: MTable) -> MTable:
        from .statistics import _contingency, chi_square_test

        label_col = self.get(self.LABEL_COL)
        cols = list(self.get(HasSelectedCols.SELECTED_COLS) or
                    default_feature_cols(t, exclude=[label_col]))
        y = t.col(label_col)
        scores = []
        for c in cols:
            stat, p, _ = chi_square_test(_contingency(t.col(c), y))
            scores.append((c, stat, p))
        k = min(int(self.get(self.NUM_TOP_FEATURES)), len(cols))
        top = sorted(scores, key=lambda s: -s[1])[:k]
        meta = {
            "modelName": "ChiSqSelectorModel",
            "selectedCols": cols,
            "siftOutCols": [c for c, _, _ in top],
            "chi2": {c: float(s) for c, s, _ in scores},
            "pValues": {c: float(p) for c, _, p in scores},
        }
        return model_to_table(meta, {})

    def _static_meta_keys(self, in_schema):
        return {"modelName": "ChiSqSelectorModel"}


class ChiSqSelectorModelMapper(ModelMapper, HasReservedCols):
    """Projects the table onto the selected feature columns."""

    def load_model(self, model: MTable):
        self.meta, _ = table_to_model(model)
        return self

    def output_schema(self, input_schema):
        keep = [n for n in input_schema.names
                if n in self.meta["siftOutCols"] or
                n not in self.meta["selectedCols"]]
        return TableSchema(keep, [input_schema.type_of(n) for n in keep])

    def map_table(self, t: MTable) -> MTable:
        schema = self.output_schema(t.schema)
        return MTable({n: t.col(n) for n in schema.names}, schema)


class ChiSqSelectorPredictBatchOp(ModelMapBatchOp, HasReservedCols):
    mapper_cls = ChiSqSelectorModelMapper


# ---------------------------------------------------------------------------
# MaxAbsScaler
# ---------------------------------------------------------------------------

class MaxAbsScalerTrainBatchOp(ModelTrainOpMixin, BatchOperator, HasSelectedCols):
    """(reference: MaxAbsScalerTrainBatchOp.java)"""

    _min_inputs = 1
    _max_inputs = 1

    def _execute_impl(self, t: MTable) -> MTable:
        cols = list(self.get(HasSelectedCols.SELECTED_COLS) or
                    default_feature_cols(t))
        X = t.to_numeric_block(cols, dtype=np.float64)
        meta = {"modelName": "MaxAbsScalerModel", "selectedCols": cols}
        return model_to_table(meta, {"maxAbs": np.abs(X).max(axis=0)})

    def _static_meta_keys(self, in_schema):
        cols = list(self.get(HasSelectedCols.SELECTED_COLS) or
                    default_feature_cols(in_schema))
        return {"modelName": "MaxAbsScalerModel", "selectedCols": cols}


class MaxAbsScalerModelMapper(ModelMapper, HasReservedCols):
    def load_model(self, model: MTable):
        self.meta, arrays = table_to_model(model)
        self.scale = np.where(arrays["maxAbs"] < 1e-12, 1.0, arrays["maxAbs"])
        return self

    def output_schema(self, input_schema):
        cols = set(self.meta["selectedCols"])
        types = [AlinkTypes.DOUBLE if n in cols else t
                 for n, t in zip(input_schema.names, input_schema.types)]
        return TableSchema(list(input_schema.names), types)

    def map_table(self, t: MTable) -> MTable:
        out = t
        for i, c in enumerate(self.meta["selectedCols"]):
            v = np.asarray(t.col(c), np.float64) / self.scale[i]
            out = out.with_column(c, v, AlinkTypes.DOUBLE)
        return out


class MaxAbsScalerPredictBatchOp(ModelMapBatchOp, HasReservedCols):
    mapper_cls = MaxAbsScalerModelMapper


class DCTMapper(Mapper, HasSelectedCol, HasOutputCol, HasReservedCols):
    """Orthonormal DCT-II of a vector column (reference:
    operator/batch/feature/DCTBatchOp.java + common/feature/DCTMapper)."""

    INVERSE = ParamInfo("inverse", bool, default=False)

    def output_schema(self, input_schema):
        out = (self.get(HasOutputCol.OUTPUT_COL) or
               self.get(HasSelectedCol.SELECTED_COL))
        return self._append_result_schema(
            input_schema, [out], [AlinkTypes.DENSE_VECTOR])

    def map_table(self, t: MTable) -> MTable:
        from ...common.linalg import DenseVector

        col = self.get(HasSelectedCol.SELECTED_COL)
        out = self.get(HasOutputCol.OUTPUT_COL) or col
        X = np.stack([parse_vector(v).to_dense().data for v in t.col(col)])
        n = X.shape[1]
        k = np.arange(n)
        basis = np.cos(np.pi / n * (k[:, None] + 0.5) * k[None, :])
        basis *= np.sqrt(2.0 / n)
        basis[:, 0] = np.sqrt(1.0 / n)
        Y = X @ basis.T if self.get(self.INVERSE) else X @ basis
        vecs = np.asarray([DenseVector(row) for row in Y], object)
        return self._append_result(t, {out: vecs},
                                   {out: AlinkTypes.DENSE_VECTOR})


class DCTBatchOp(MapBatchOp, HasSelectedCol, HasOutputCol, HasReservedCols):
    mapper_cls = DCTMapper
    INVERSE = DCTMapper.INVERSE


class AutoCrossBatchOp(ModelTrainOpMixin, BatchOperator):
    """Greedy categorical feature-cross search (reference:
    operator/batch/feature/AutoCrossTrainBatchOp.java + common/fe AutoCross —
    beam search over crosses scored by downstream LR gain).

    Re-design (compact): candidate pairwise crosses of the categorical
    columns are scored by the holdout AUC gain of a logistic regression on
    (base one-hot + cross one-hot); the top ``numCross`` winners persist in
    the model, and serving appends each cross as a combined categorical
    column crossed_a_b = "a=..#b=..". Chain OneHot afterwards for vectors."""

    CATEGORICAL_COLS = ParamInfo("categoricalCols", list, optional=False)
    LABEL_COL = ParamInfo("labelCol", str, optional=False)
    NUM_CROSS = ParamInfo("numCross", int, default=2,
                          validator=MinValidator(1))
    POSITIVE_LABEL = ParamInfo("positiveLabelValueString", str)
    RANDOM_SEED = ParamInfo("randomSeed", int, default=0, aliases=("seed",))

    _min_inputs = 1
    _max_inputs = 1

    def _encode(self, cols_vals):
        """one-hot index encode a list of string columns -> CSR-ish dense."""
        mats = []
        for vals in cols_vals:
            uniq, inv = np.unique(vals, return_inverse=True)
            m = np.zeros((len(vals), len(uniq)), np.float32)
            m[np.arange(len(vals)), inv] = 1.0
            mats.append(m)
        return np.concatenate(mats, axis=1) if mats else \
            np.zeros((0, 0), np.float32)

    def _auc(self, X, y, seed):
        from ...optim import logistic_obj, optimize
        from .evaluation import rank_auc

        rng = np.random.default_rng(seed)
        n = len(y)
        perm = rng.permutation(n)
        cut = int(n * 0.7)
        tr, te = perm[:cut], perm[cut:]
        Xb = np.concatenate([X, np.ones((n, 1), np.float32)], axis=1)
        res = optimize(logistic_obj(Xb.shape[1]), Xb[tr], y[tr],
                       max_iter=40, l2=1e-3)
        scores = Xb[te] @ res.weights
        return rank_auc(scores, y[te] > 0)

    def _execute_impl(self, t: MTable) -> MTable:
        from itertools import combinations

        cols = list(self.get(self.CATEGORICAL_COLS))
        label_col = self.get(self.LABEL_COL)
        y_raw = np.asarray(t.col(label_col), object).astype(str)
        pos = self.get(self.POSITIVE_LABEL) or sorted(set(y_raw))[0]
        y = np.where(y_raw == str(pos), 1.0, -1.0).astype(np.float32)
        seed = self.get(self.RANDOM_SEED)

        base_vals = {c: np.asarray(t.col(c), object).astype(str)
                     for c in cols}
        base_X = self._encode([base_vals[c] for c in cols])
        base_auc = self._auc(base_X, y, seed)

        scored = []
        for a, b in combinations(cols, 2):
            crossed = np.asarray(
                [f"{x}#{z}" for x, z in zip(base_vals[a], base_vals[b])],
                object)
            X = np.concatenate(
                [base_X, self._encode([crossed])], axis=1)
            gain = self._auc(X, y, seed) - base_auc
            scored.append(((a, b), float(gain)))
        scored.sort(key=lambda s: -s[1])
        chosen = [list(pair) for pair, gain in
                  scored[:self.get(self.NUM_CROSS)] if gain > 0]
        meta = {
            "modelName": "AutoCrossModel",
            "categoricalCols": cols,
            "crosses": chosen,
            "baseAuc": float(base_auc),
            "gains": {f"{a}#{b}": g for (a, b), g in scored},
        }
        return model_to_table(meta, {})

    def _static_meta_keys(self, in_schema):
        return {"modelName": "AutoCrossModel"}


class AutoCrossModelMapper(ModelMapper, HasReservedCols):
    """Appends one combined categorical column per learned cross."""

    def load_model(self, model: MTable):
        self.meta, _ = table_to_model(model)
        return self

    def output_schema(self, input_schema):
        names = list(input_schema.names)
        types = list(input_schema.types)
        for a, b in self.meta["crosses"]:
            names.append(f"cross_{a}_{b}")
            types.append(AlinkTypes.STRING)
        return TableSchema(names, types)

    def map_table(self, t: MTable) -> MTable:
        out = t
        for a, b in self.meta["crosses"]:
            va = np.asarray(t.col(a), object).astype(str)
            vb = np.asarray(t.col(b), object).astype(str)
            crossed = np.asarray([f"{x}#{z}" for x, z in zip(va, vb)], object)
            out = out.with_column(f"cross_{a}_{b}", crossed, AlinkTypes.STRING)
        return out


class AutoCrossPredictBatchOp(ModelMapBatchOp, HasReservedCols):
    mapper_cls = AutoCrossModelMapper
