"""Outlier batch operators + grouped-series variants + evaluation (port of
``alink_tpu.operator.batch.outlier``).

Capability parity with the reference (reference: operator/batch/outlier/ —
KSigmaOutlierBatchOp.java, BoxPlotOutlierBatchOp.java, MadOutlierBatchOp,
EsdOutlierBatchOp, ShEsdOutlierBatchOp, HbosOutlierBatchOp, KdeOutlierBatchOp,
LofOutlierBatchOp, IForestOutlierBatchOp, EcodOutlierBatchOp,
CopodOutlierBatchOp and the *Outlier4GroupedDataBatchOp series variants;
base harness common/outlier/BaseOutlierBatchOp.java + OutlierDetector.java;
evaluation/EvalOutlierBatchOp.java).

One shared harness: detectors are pure scoring functions
(``alink_tpu_torch.outlier``); ops bind columns, run the scorer on the
session's device (the pairwise distances of the O(n²) ones, the one-class
SVM's features and training), and
append predictionCol (bool) + predictionDetailCol (JSON {outlier_score}).
Grouped variants partition by groupCols and score each group's series
independently on the session's ``alink-local`` pool
(``operator.local.parallel_apply``), serially when called from that pool.
"""

from __future__ import annotations

import json
import math
from typing import Callable, Dict, List, Optional

import numpy as np

from ...common.exceptions import AkIllegalArgumentException
from ...common.mtable import AlinkTypes, MTable, TableSchema
from ...common.params import ParamInfo
from ...mapper import (
    HasFeatureCols,
    HasPredictionCol,
    HasPredictionDetailCol,
    HasVectorCol,
    get_feature_block,
)
from .base import BatchOperator


class _BaseOutlierBatchOp(BatchOperator, HasPredictionCol,
                          HasPredictionDetailCol):
    """Shared outlier harness (reference: BaseOutlierBatchOp.java)."""

    _min_inputs = 1
    _max_inputs = 1

    _univariate = False  # univariate ops read SELECTED_COL series

    SELECTED_COL = ParamInfo("selectedCol", str,
                             desc="value column (univariate detectors)")

    def _score(self, X: np.ndarray):
        """Return (scores, is_outlier). Implemented per op."""
        raise NotImplementedError

    def _matrix(self, t: MTable) -> np.ndarray:
        if self._univariate:
            col = self.get(self.SELECTED_COL)
            if not col:
                raise AkIllegalArgumentException(
                    f"{type(self).__name__} needs selectedCol"
                )
            return np.asarray(t.col(col), np.float64)
        return get_feature_block(t, self, dtype=np.float64)

    def _execute_impl(self, t: MTable) -> MTable:
        X = self._matrix(t)
        scores, flags = self._score(X)
        return _append_outlier(t, self, scores, flags)

    def _out_schema(self, in_schema: TableSchema) -> TableSchema:
        names = list(in_schema.names) + [self.get(self.PREDICTION_COL)]
        types = list(in_schema.types) + [AlinkTypes.BOOLEAN]
        if self.get(self.PREDICTION_DETAIL_COL):
            names.append(self.get(self.PREDICTION_DETAIL_COL))
            types.append(AlinkTypes.STRING)
        return TableSchema(names, types)


def _append_outlier(t: MTable, op, scores, flags) -> MTable:
    out = t.with_column(op.get(op.PREDICTION_COL), np.asarray(flags, bool),
                        AlinkTypes.BOOLEAN)
    detail_col = op.get(op.PREDICTION_DETAIL_COL)
    if detail_col:
        details = np.asarray(
            [json.dumps({
                "outlier_score": round(float(s), 6)
                if np.isfinite(s) else None  # strict-JSON safe
            }) for s in scores], object,
        )
        out = out.with_column(detail_col, details, AlinkTypes.STRING)
    return out


class _MultivariateOutlierOp(_BaseOutlierBatchOp, HasFeatureCols, HasVectorCol):
    _univariate = False


# -- univariate ops ----------------------------------------------------------

class KSigmaOutlierBatchOp(_BaseOutlierBatchOp):
    """(reference: KSigmaOutlierBatchOp.java)"""

    _univariate = True
    K = ParamInfo("k", float, default=3.0)

    def _score(self, x):
        from ...outlier import ksigma

        return ksigma(x, self.get(self.K))


class BoxPlotOutlierBatchOp(_BaseOutlierBatchOp):
    """(reference: BoxPlotOutlierBatchOp.java)"""

    _univariate = True
    K = ParamInfo("k", float, default=1.5)

    def _score(self, x):
        from ...outlier import boxplot

        return boxplot(x, self.get(self.K))


class MadOutlierBatchOp(_BaseOutlierBatchOp):
    """(reference: MadOutlierBatchOp.java)"""

    _univariate = True
    K = ParamInfo("k", float, default=3.5)

    def _score(self, x):
        from ...outlier import mad

        return mad(x, self.get(self.K))


class EsdOutlierBatchOp(_BaseOutlierBatchOp):
    """(reference: EsdOutlierBatchOp.java)"""

    _univariate = True
    ALPHA = ParamInfo("alpha", float, default=0.05)
    MAX_OUTLIER_NUM = ParamInfo("maxOutlierNum", int)

    def _score(self, x):
        from ...outlier import esd

        return esd(x, self.get(self.ALPHA), self.get(self.MAX_OUTLIER_NUM))


class ShEsdOutlierBatchOp(_BaseOutlierBatchOp):
    """(reference: ShEsdOutlierBatchOp.java)"""

    _univariate = True
    FREQUENCY = ParamInfo("frequency", int, optional=False,
                          desc="seasonal period")
    ALPHA = ParamInfo("alpha", float, default=0.05)
    MAX_OUTLIER_NUM = ParamInfo("maxOutlierNum", int)

    def _score(self, x):
        from ...outlier import shesd

        return shesd(x, self.get(self.FREQUENCY), self.get(self.ALPHA),
                     self.get(self.MAX_OUTLIER_NUM))


# -- multivariate ops --------------------------------------------------------

class HbosOutlierBatchOp(_MultivariateOutlierOp):
    """(reference: HbosOutlierBatchOp.java)"""

    NUM_BINS = ParamInfo("numBins", int, default=10)

    def _score(self, X):
        from ...outlier import hbos

        return hbos(X, self.get(self.NUM_BINS))


class KdeOutlierBatchOp(_MultivariateOutlierOp):
    """(reference: KdeOutlierBatchOp.java)"""

    BANDWIDTH = ParamInfo("bandwidth", float)

    def _score(self, X):
        from ...outlier import kde

        return kde(X, self.get(self.BANDWIDTH), device=self.env.device)


class LofOutlierBatchOp(_MultivariateOutlierOp):
    """(reference: LofOutlierBatchOp.java)"""

    NUM_NEIGHBORS = ParamInfo("numNeighbors", int, default=10, aliases=("k",))

    def _score(self, X):
        from ...outlier import lof

        return lof(X, self.get(self.NUM_NEIGHBORS), device=self.env.device)


class IForestOutlierBatchOp(_MultivariateOutlierOp):
    """(reference: IForestOutlierBatchOp.java)"""

    NUM_TREES = ParamInfo("numTrees", int, default=100)
    SUBSAMPLING_SIZE = ParamInfo("subsamplingSize", int, default=256)
    RANDOM_SEED = ParamInfo("randomSeed", int, default=0, aliases=("seed",))

    def _score(self, X):
        from ...outlier import iforest

        return iforest(X, self.get(self.NUM_TREES),
                       self.get(self.SUBSAMPLING_SIZE),
                       self.get(self.RANDOM_SEED), device=self.env.device)


class SosOutlierBatchOp(_MultivariateOutlierOp):
    """(reference: SosOutlierBatchOp.java)"""

    PERPLEXITY = ParamInfo("perplexity", float, default=4.5)

    def _score(self, X):
        from ...outlier import sos

        return sos(X, self.get(self.PERPLEXITY), device=self.env.device)


class OcsvmOutlierBatchOp(_MultivariateOutlierOp):
    """(reference: OcsvmOutlierBatchOp.java)"""

    NU = ParamInfo("nu", float, default=0.1)
    GAMMA = ParamInfo("gamma", float)

    def _score(self, X):
        from ...outlier import ocsvm

        return ocsvm(X, nu=self.get(self.NU), gamma=self.get(self.GAMMA),
                     device=self.env.device)


class EcodOutlierBatchOp(_MultivariateOutlierOp):
    """(reference: EcodOutlierBatchOp.java)"""

    def _score(self, X):
        from ...outlier import ecod

        return ecod(X)


class CopodOutlierBatchOp(_MultivariateOutlierOp):
    """(reference: CopodOutlierBatchOp.java)"""

    def _score(self, X):
        from ...outlier import copod

        return copod(X)


# -- grouped-series variants -------------------------------------------------

class _Grouped4DataMixin:
    """Per-group scoring (reference: *Outlier4GroupedDataBatchOp — the
    per-group task-parallel pattern, SURVEY §2.2 parallelism #4)."""

    GROUP_COLS = ParamInfo("groupCols", list, optional=False)

    def _execute_impl(self, t: MTable):
        from .utils2 import coerce_group_cols, group_row_indices

        group_cols = coerce_group_cols(self.get(self.GROUP_COLS))
        index, _ = group_row_indices(t, group_cols)
        n = t.num_rows
        scores = np.zeros(n)
        flags = np.zeros(n, bool)

        def one(rows):
            rows = np.asarray(rows)
            s, f = self._score(self._matrix(t.take(rows)))
            return rows, s, f

        from ..local import parallel_apply

        # per-group task parallelism on the session pool (the
        # AlinkLocalSession work-splitting role; SURVEY §2.2 pattern #4)
        for rows, s, f in parallel_apply(one, list(index.values()),
                                         env=self.env, min_items=4):
            scores[rows] = s
            flags[rows] = f
        return _append_outlier(t, self, scores, flags)


def _grouped(name: str, base):
    cls = type(name, (_Grouped4DataMixin, base), {
        "__doc__": f"Grouped variant of {base.__name__} "
        f"(reference: {name}.java)",
    })
    return cls


KSigmaOutlier4GroupedDataBatchOp = _grouped(
    "KSigmaOutlier4GroupedDataBatchOp", KSigmaOutlierBatchOp)
BoxPlotOutlier4GroupedDataBatchOp = _grouped(
    "BoxPlotOutlier4GroupedDataBatchOp", BoxPlotOutlierBatchOp)
MadOutlier4GroupedDataBatchOp = _grouped(
    "MadOutlier4GroupedDataBatchOp", MadOutlierBatchOp)
EsdOutlier4GroupedDataBatchOp = _grouped(
    "EsdOutlier4GroupedDataBatchOp", EsdOutlierBatchOp)
ShEsdOutlier4GroupedDataBatchOp = _grouped(
    "ShEsdOutlier4GroupedDataBatchOp", ShEsdOutlierBatchOp)
IForestOutlier4GroupedDataBatchOp = _grouped(
    "IForestOutlier4GroupedDataBatchOp", IForestOutlierBatchOp)
HbosOutlier4GroupedDataBatchOp = _grouped(
    "HbosOutlier4GroupedDataBatchOp", HbosOutlierBatchOp)
KdeOutlier4GroupedDataBatchOp = _grouped(
    "KdeOutlier4GroupedDataBatchOp", KdeOutlierBatchOp)
LofOutlier4GroupedDataBatchOp = _grouped(
    "LofOutlier4GroupedDataBatchOp", LofOutlierBatchOp)
SosOutlier4GroupedDataBatchOp = _grouped(
    "SosOutlier4GroupedDataBatchOp", SosOutlierBatchOp)
OcsvmOutlier4GroupedDataBatchOp = _grouped(
    "OcsvmOutlier4GroupedDataBatchOp", OcsvmOutlierBatchOp)
EcodOutlier4GroupedDataBatchOp = _grouped(
    "EcodOutlier4GroupedDataBatchOp", EcodOutlierBatchOp)
CopodOutlier4GroupedDataBatchOp = _grouped(
    "CopodOutlier4GroupedDataBatchOp", CopodOutlierBatchOp)


# -- evaluation --------------------------------------------------------------

class EvalOutlierBatchOp(BatchOperator):
    """Outlier metrics (reference: operator/batch/evaluation/
    EvalOutlierBatchOp.java): precision/recall/F1 on the boolean prediction
    plus AUC over the detail score."""

    LABEL_COL = ParamInfo("labelCol", str, optional=False)
    PREDICTION_COL = ParamInfo("predictionCol", str, optional=False)
    PREDICTION_DETAIL_COL = ParamInfo("predictionDetailCol", str)
    OUTLIER_VALUE_STRINGS = ParamInfo(
        "outlierValueStrings", list,
        desc="label values regarded as outliers; default: true/1",
    )

    _min_inputs = 1
    _max_inputs = 1

    def _out_schema(self, in_schema: TableSchema) -> TableSchema:
        return TableSchema(
            ["Precision", "Recall", "F1", "AUC", "Data"],
            [AlinkTypes.DOUBLE] * 4 + [AlinkTypes.STRING],
        )

    def _execute_impl(self, t: MTable) -> MTable:
        pos_vals = set(
            str(v) for v in (self.get(self.OUTLIER_VALUE_STRINGS) or
                             ["true", "True", "1", "1.0"])
        )
        y = np.asarray(
            [str(v) in pos_vals for v in t.col(self.get(self.LABEL_COL))]
        )
        raw_pred = t.col(self.get(self.PREDICTION_COL))

        def _flag(v):
            # bool/numeric predictions are truth-valued; strings carry the
            # label domain and go through the outlier value set (a bare
            # .astype(bool) made every non-empty string an outlier).
            # Per-element dispatch so object-dtype columns mixing bools/
            # ints/None keep their truth-value semantics
            if v is None:
                return False
            if isinstance(v, (float, np.floating)) and math.isnan(v):
                return False  # missing prediction is not an outlier
            if isinstance(v, (bool, np.bool_, int, float,
                              np.integer, np.floating)):
                return bool(v)
            return str(v) in pos_vals

        pred = np.asarray([_flag(v) for v in raw_pred])
        tp = int((pred & y).sum())
        fp = int((pred & ~y).sum())
        fn = int((~pred & y).sum())
        precision = tp / (tp + fp) if tp + fp else 0.0
        recall = tp / (tp + fn) if tp + fn else 0.0
        f1 = (2 * precision * recall / (precision + recall)
              if precision + recall else 0.0)
        auc = float("nan")
        detail_col = self.get(self.PREDICTION_DETAIL_COL)
        if detail_col:
            from .evaluation import rank_auc

            s = np.asarray([
                v if (v := json.loads(d)["outlier_score"]) is not None
                else np.nan
                for d in t.col(detail_col)
            ], np.float64)
            auc = rank_auc(np.nan_to_num(s), y)
        metrics = {"Precision": precision, "Recall": recall, "F1": f1,
                   "AUC": auc}
        return MTable(
            {**{k: [v] for k, v in metrics.items()},
             "Data": [json.dumps(metrics)]},
            self._out_schema(t.schema),
        )

    def collect_metrics(self):
        from .evaluation import Metrics

        t = self.collect()
        return Metrics(json.loads(t.col("Data")[0]))


# -- Cook's distance / DBSCAN / DTW -----------------------------------------

class CooksDistanceOutlierBatchOp(_BaseOutlierBatchOp, HasFeatureCols,
                                  HasVectorCol):
    """Linear-model leverage outliers: Cook's distance of every row under
    OLS of labelCol on featureCols, flagged above F(0.95, p, n-p)
    (reference: operator/batch/outlier/CooksDistanceOutlierBatchOp.java,
    common/outlier/CooksDistanceDetector.java)."""

    LABEL_COL = ParamInfo("labelCol", str, optional=False)

    def _execute_impl(self, t: MTable) -> MTable:
        from ...outlier.detectors import cooks_distance

        label_col = self.get(self.LABEL_COL)
        y = np.asarray(t.col(label_col), np.float64)
        X = get_feature_block(t, self, dtype=np.float64,
                              exclude=[label_col])
        scores, flags, _thr = cooks_distance(X, y)
        return _append_outlier(t, self, scores, flags)


class DbscanOutlierBatchOp(_MultivariateOutlierOp):
    """Density outliers: points whose k-th neighbor lies beyond the
    (auto-tuned) eps (reference: operator/batch/outlier/
    DbscanOutlierBatchOp.java, common/outlier/DbscanDetector.java)."""

    MIN_POINTS = ParamInfo("minPoints", int, default=4)
    EPSILON = ParamInfo("epsilon", float, default=None)

    def _score(self, X):
        from ...outlier.detectors import dbscan_outlier

        return dbscan_outlier(X, min_points=self.get(self.MIN_POINTS),
                              eps=self.get(self.EPSILON),
                              device=self.env.device)


DbscanOutlier4GroupedDataBatchOp = _grouped(
    "DbscanOutlier4GroupedDataBatchOp", DbscanOutlierBatchOp)


class SHEsdOutlierBatchOp(ShEsdOutlierBatchOp):
    """Reference-capitalization name for the S-H-ESD detector
    (reference: operator/batch/outlier/SHEsdOutlierBatchOp.java)."""


class DynamicTimeWarpOutlierBatchOp(_BaseOutlierBatchOp):
    """DTW novelty detection over fixed-length windows of a univariate
    series (reference: operator/stream/outlier/
    DynamicTimeWarpOutlierStreamOp.java, common/outlier/
    DynamicTimeWarpingDetector.java)."""

    _univariate = True

    SERIES_LENGTH = ParamInfo("seriesLength", int, default=10)
    SEARCH_WINDOW = ParamInfo("searchWindow", int, default=-1)
    K = ParamInfo("k", float, default=3.0, desc="k-sigma novelty threshold")

    def _score(self, x):
        from ...outlier.detectors import dtw_outlier

        return dtw_outlier(x, self.get(self.SERIES_LENGTH),
                           search_window=self.get(self.SEARCH_WINDOW),
                           k_sigma=self.get(self.K))


# -- model outlier train/predict families ------------------------------------

from ...common.model import model_to_table, table_to_model  # noqa: E402
from ...mapper import HasReservedCols, ModelMapper  # noqa: E402
from .utils import ModelMapBatchOp, ModelTrainOpMixin  # noqa: E402


class IForestModelOutlierTrainBatchOp(ModelTrainOpMixin, BatchOperator,
                                      HasFeatureCols, HasVectorCol):
    """Train a REUSABLE isolation forest (reference: operator/batch/outlier/
    IForestModelOutlierTrainBatchOp.java — persisted trees served by
    IForestModelDetector)."""

    NUM_TREES = ParamInfo("numTrees", int, default=100)
    SUBSAMPLING_SIZE = ParamInfo("subsamplingSize", int, default=256)
    RANDOM_SEED = ParamInfo("randomSeed", int, default=0, aliases=("seed",))

    _min_inputs = 1
    _max_inputs = 1

    def _static_meta_keys(self, in_schema):
        return {"modelName": "IForestModel"}

    def _execute_impl(self, t: MTable) -> MTable:
        from ...outlier.detectors import iforest_fit

        from ...mapper import resolve_feature_cols

        vec_col = self.get(HasVectorCol.VECTOR_COL)
        feature_cols = None if vec_col else resolve_feature_cols(t, self)
        X = get_feature_block(t, self, dtype=np.float64)
        arrays = iforest_fit(X, num_trees=self.get(self.NUM_TREES),
                             subsample=self.get(self.SUBSAMPLING_SIZE),
                             seed=self.get(self.RANDOM_SEED))
        meta = {"modelName": "IForestModel",
                "featureCols": feature_cols,
                "vectorCol": vec_col,
                "dim": int(X.shape[1])}
        return model_to_table(meta, arrays)


class _ModelOutlierMapper(ModelMapper, HasPredictionCol,
                          HasPredictionDetailCol, HasReservedCols,
                          HasFeatureCols, HasVectorCol):
    """Shared serving harness for trained outlier models (reference:
    common/outlier/ModelOutlierDetector.java)."""

    def load_model(self, model: MTable):
        self.meta, self.arrays = table_to_model(model)
        return self

    def output_schema(self, input_schema):
        names = [self.get(HasPredictionCol.PREDICTION_COL)]
        types = [AlinkTypes.BOOLEAN]
        if self.get(HasPredictionDetailCol.PREDICTION_DETAIL_COL):
            names.append(
                self.get(HasPredictionDetailCol.PREDICTION_DETAIL_COL))
            types.append(AlinkTypes.STRING)
        return self._append_result_schema(input_schema, names, types)

    def _features(self, t: MTable) -> np.ndarray:
        from ...mapper import merge_feature_params

        p = merge_feature_params(self.get_params(), self.meta)
        return get_feature_block(t, p, dtype=np.float64,
                                 vector_size=self.meta.get("dim"))

    def _score(self, X):
        raise NotImplementedError

    def _score_table(self, t: MTable, X):
        """Hook for mappers that need the table (e.g. group columns);
        default delegates to the feature-only scorer."""
        return self._score(X)

    def map_table(self, t: MTable) -> MTable:
        scores, flags = self._score_table(t, self._features(t))
        add = {self.get(HasPredictionCol.PREDICTION_COL):
               np.asarray(flags, bool)}
        types = {self.get(HasPredictionCol.PREDICTION_COL):
                 AlinkTypes.BOOLEAN}
        detail_col = self.get(HasPredictionDetailCol.PREDICTION_DETAIL_COL)
        if detail_col:
            add[detail_col] = np.asarray(
                [json.dumps({"outlier_score": round(float(s), 6)
                             if np.isfinite(s) else None})
                 for s in scores], object)
            types[detail_col] = AlinkTypes.STRING
        return self._append_result(t, add, types)


class IForestModelOutlierPredictMapper(_ModelOutlierMapper):
    def _score(self, X):
        from ...outlier.detectors import iforest_score

        return iforest_score(self.arrays, X, device=self.device)


class IForestModelOutlierPredictBatchOp(ModelMapBatchOp, HasPredictionCol,
                                        HasPredictionDetailCol,
                                        HasReservedCols, HasFeatureCols,
                                        HasVectorCol):
    """(reference: operator/batch/outlier/
    IForestModelOutlierPredictBatchOp.java)"""

    mapper_cls = IForestModelOutlierPredictMapper


class OcsvmModelOutlierTrainBatchOp(ModelTrainOpMixin, BatchOperator,
                                    HasFeatureCols, HasVectorCol):
    """Train a reusable one-class SVM (reference: operator/batch/outlier/
    OcsvmModelOutlierTrainBatchOp.java — OcsvmModelData support vectors)."""

    NU = ParamInfo("nu", float, default=0.1)
    GAMMA = ParamInfo("gamma", float, default=None)
    RANDOM_SEED = ParamInfo("randomSeed", int, default=0, aliases=("seed",))

    _min_inputs = 1
    _max_inputs = 1

    def _static_meta_keys(self, in_schema):
        return {"modelName": "OcsvmModel"}

    def _execute_impl(self, t: MTable) -> MTable:
        from ...outlier.detectors import ocsvm_fit

        from ...mapper import resolve_feature_cols

        vec_col = self.get(HasVectorCol.VECTOR_COL)
        feature_cols = None if vec_col else resolve_feature_cols(t, self)
        X = get_feature_block(t, self, dtype=np.float64)
        arrays = ocsvm_fit(X, nu=self.get(self.NU),
                           gamma=self.get(self.GAMMA),
                           seed=self.get(self.RANDOM_SEED),
                           device=self.env.device)
        meta = {"modelName": "OcsvmModel",
                "featureCols": feature_cols,
                "vectorCol": vec_col,
                "dim": int(X.shape[1])}
        return model_to_table(meta, arrays)


class OcsvmModelOutlierPredictMapper(_ModelOutlierMapper):
    def _score(self, X):
        from ...outlier.detectors import ocsvm_score

        return ocsvm_score(self.arrays, X, device=self.device)


class OcsvmModelOutlierPredictBatchOp(ModelMapBatchOp, HasPredictionCol,
                                      HasPredictionDetailCol,
                                      HasReservedCols, HasFeatureCols,
                                      HasVectorCol):
    """(reference: operator/batch/outlier/
    OcsvmModelOutlierPredictBatchOp.java)"""

    mapper_cls = OcsvmModelOutlierPredictMapper


class DbscanModelOutlierPredictMapper(_ModelOutlierMapper):
    """New points with no model point within eps are outliers; score =
    min-distance / eps. With a grouped model, each row only matches ITS
    group's points — cluster structure never leaks across groups
    (reference: common/outlier/DbscanModelDetector.java over the
    GroupDbscanModel points)."""

    EPSILON = ParamInfo("epsilon", float, default=None)

    _CHUNK = 4096

    def _min_dist(self, t: MTable, X) -> np.ndarray:
        """Per-row distance to the nearest eligible model point (inf when
        the row's group has no clustered points)."""
        pts = self.arrays["points"]
        X = np.asarray(X)
        mind = np.full(len(X), np.inf)
        for rows, pidx in _group_point_index(self.meta, self.arrays, t, X):
            if pidx.size == 0 or rows.size == 0:
                continue
            P = pts[pidx]
            for s0 in range(0, len(rows), self._CHUNK):
                blk = rows[s0:s0 + self._CHUNK]
                d2 = ((X[blk][:, None, :] - P[None, :, :]) ** 2).sum(-1)
                mind[blk] = np.sqrt(d2.min(axis=1))
        return mind

    def _score_table(self, t: MTable, X):
        eps = self.get(self.EPSILON)
        if eps is None:
            eps = float(self.meta.get("epsilon", 0.5))
        score = self._min_dist(t, X) / max(eps, 1e-12)
        return score, score > 1.0


def _group_point_index(meta, arrays, t: MTable, X):
    """Yield (row_indices, model_point_indices) pairs: one pair per group
    for grouped models (matched via the persisted group keys), or a single
    all-rows/all-points pair otherwise."""
    group_cols = meta.get("groupCols")
    gids = arrays.get("groups")
    keys = meta.get("groupKeys")
    all_pts = np.arange(arrays["points"].shape[0])
    if not group_cols or gids is None or not keys:
        yield np.arange(len(X)), all_pts
        return
    key_to_gid = {k: i for i, k in enumerate(keys)}
    cols = [np.asarray(t.col(c), object) for c in group_cols]
    row_keys = ["\x01".join(str(c[i]) for c in cols)
                for i in range(len(X))]
    by_gid = {}
    for i, k in enumerate(row_keys):
        by_gid.setdefault(key_to_gid.get(k, -1), []).append(i)
    for gid, rows in by_gid.items():
        rows = np.asarray(rows)
        if gid < 0:
            yield rows, np.asarray([], np.int64)  # unseen group: outliers
        else:
            yield rows, np.nonzero(gids == gid)[0]


class DbscanModelOutlierPredictBatchOp(ModelMapBatchOp, HasPredictionCol,
                                       HasPredictionDetailCol,
                                       HasReservedCols, HasFeatureCols,
                                       HasVectorCol):
    """(reference: operator/stream/outlier/
    DbscanModelOutlierPredictStreamOp.java — batch twin of the model-based
    DBSCAN detector)."""

    mapper_cls = DbscanModelOutlierPredictMapper
    EPSILON = DbscanModelOutlierPredictMapper.EPSILON


class GroupDbscanModelBatchOp(ModelTrainOpMixin, BatchOperator,
                              HasFeatureCols, HasVectorCol):
    """Per-group DBSCAN models: core points + cluster ids (+ group keys)
    persisted for model-based serving (reference: operator/batch/clustering/
    GroupDbscanModelBatchOp.java; served by DbscanModelDetector)."""

    GROUP_COLS = ParamInfo("groupCols", list, default=None)
    EPSILON = ParamInfo("epsilon", float, optional=False)
    MIN_POINTS = ParamInfo("minPoints", int, default=4)

    _min_inputs = 1
    _max_inputs = 1

    def _static_meta_keys(self, in_schema):
        return {"modelName": "DbscanModel"}

    def _execute_impl(self, t: MTable) -> MTable:
        from ..batch.clustering2 import DbscanBatchOp

        from ...mapper import resolve_feature_cols

        eps = float(self.get(self.EPSILON))
        min_pts = int(self.get(self.MIN_POINTS))
        group_cols = self.get(self.GROUP_COLS)
        pts_out, labels_out, gid_out = [], [], []
        group_keys: List[str] = []
        if group_cols:
            from .utils2 import coerce_group_cols, group_row_indices

            group_cols = coerce_group_cols(group_cols)
            index, order = group_row_indices(t, group_cols)
            groups = [(gi, np.asarray(index[k]))
                      for gi, k in enumerate(order)]
            group_keys = ["\x01".join(str(v) for v in k) for k in order]
        else:
            groups = [(0, np.arange(t.num_rows))]
        vec_col = self.get(HasVectorCol.VECTOR_COL)
        # resolve NOW (group columns excluded) so numeric group cols never
        # leak into the feature block and serving binds the same columns
        feature_cols = (None if vec_col else resolve_feature_cols(
            t, self, exclude=list(group_cols) if group_cols else []))
        for gid, rows in groups:
            sub = t.take(rows)
            clustered = DbscanBatchOp(
                featureCols=feature_cols,
                vectorCol=vec_col,
                epsilon=eps, minPoints=min_pts,
                predictionCol="cluster_id")._execute_impl(sub)
            labels = np.asarray(clustered.col("cluster_id"))
            X = (sub.to_numeric_block(feature_cols, dtype=np.float64)
                 if feature_cols
                 else get_feature_block(sub, self, dtype=np.float64))
            keep = labels >= 0  # persist clustered (non-noise) points
            pts_out.append(np.asarray(X, np.float64)[keep])
            labels_out.append(labels[keep])
            gid_out.append(np.full(int(keep.sum()), gid, np.int64))
        pts = (np.concatenate(pts_out) if pts_out
               else np.zeros((0, 1)))
        meta = {"modelName": "DbscanModel", "epsilon": eps,
                "minPoints": min_pts,
                "featureCols": feature_cols,
                "vectorCol": vec_col,
                "dim": int(pts.shape[1]) if pts.size else 0,
                "groupCols": group_cols, "groupKeys": group_keys}
        return model_to_table(meta, {
            "points": pts,
            "labels": (np.concatenate(labels_out) if labels_out
                       else np.zeros(0, np.int64)),
            "groups": (np.concatenate(gid_out) if gid_out
                       else np.zeros(0, np.int64)),
        })


class DbscanPredictMapper(_ModelOutlierMapper):
    """Assign each row the cluster id of its nearest model point within eps,
    else -1 (noise) (reference: operator/batch/clustering/
    DbscanPredictBatchOp.java semantics over the persisted model)."""

    def output_schema(self, input_schema):
        return self._append_result_schema(
            input_schema, [self.get(HasPredictionCol.PREDICTION_COL)],
            [AlinkTypes.LONG])

    _CHUNK = 4096

    def map_table(self, t: MTable) -> MTable:
        labels = self.arrays["labels"]
        eps = float(self.meta["epsilon"])
        X = self._features(t)
        pts = self.arrays["points"]
        out = np.full(t.num_rows, -1, np.int64)
        for rows, pidx in _group_point_index(self.meta, self.arrays, t, X):
            if pidx.size == 0 or rows.size == 0:
                continue
            P = pts[pidx]
            lab = labels[pidx]
            for s0 in range(0, len(rows), self._CHUNK):
                blk = rows[s0:s0 + self._CHUNK]
                d2 = ((X[blk][:, None, :] - P[None, :, :]) ** 2).sum(-1)
                j = d2.argmin(axis=1)
                mind = np.sqrt(d2[np.arange(len(blk)), j])
                out[blk] = np.where(mind <= eps, lab[j], -1)
        oc = self.get(HasPredictionCol.PREDICTION_COL)
        return self._append_result(t, {oc: out}, {oc: AlinkTypes.LONG})


class DbscanPredictBatchOp(ModelMapBatchOp, HasPredictionCol,
                           HasReservedCols, HasFeatureCols, HasVectorCol):
    """(reference: operator/batch/clustering/DbscanPredictBatchOp.java)"""

    mapper_cls = DbscanPredictMapper
