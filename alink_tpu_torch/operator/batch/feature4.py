"""Feature-selection and constrained-training long-tail (port of
``alink_tpu.operator.batch.feature4``).

The constrained trainers run ``optim.constrained_optimize`` (and the
divergence trainer its torch objective) on the session's device; the
selectors' candidate scoring, the crosses, WOE, VIF and the rule ops are
host code, copied.

Capability parity (reference: operator/batch/feature/
BinarySelectorTrainBatchOp.java / BinarySelectorPredictBatchOp.java /
RegressionSelectorTrainBatchOp.java / RegressionSelectorPredictBatchOp.java
and their Constrained* twins; finance/ConstrainedLinearRegTrainBatchOp.java /
ConstrainedLogisticRegressionTrainBatchOp.java /
ConstrainedDivergenceTrainBatchOp.java; feature/CrossFeatureTrainBatchOp
.java / CrossFeaturePredictBatchOp.java / HashCrossFeatureBatchOp.java /
CrossCandidateSelectorTrainBatchOp.java / AutoCrossTrainBatchOp.java;
finance/WoeTrainBatchOp.java / WoePredictBatchOp.java /
BinningTrainForScorecardBatchOp.java; statistics/MultiCollinearityBatchOp
.java; associationrule/GroupedFpGrowthBatchOp.java /
ApplyAssociationRuleBatchOp.java / ApplySequenceRuleBatchOp.java;
regression/GlmEvaluationBatchOp.java).
"""

from __future__ import annotations

import json
from typing import Dict, List

import numpy as np

from ...common.exceptions import (
    AkIllegalArgumentException,
    AkIllegalDataException,
)
from ...common.linalg import SparseVector
from ...common.model import model_to_table, table_to_model
from ...common.mtable import AlinkTypes, MTable, TableSchema
from ...common.params import InValidator, MinValidator, ParamInfo
from ...mapper import (
    HasOutputCol,
    HasPredictionCol,
    HasReservedCols,
    HasSelectedCol,
    HasSelectedCols,
    Mapper,
    ModelMapper,
)
from .base import BatchOperator
from .associationrule import FpGrowthBatchOp
from .feature2 import AutoCrossBatchOp, BinningTrainBatchOp
from .linear import (
    LinearRegTrainBatchOp,
    LogisticRegressionTrainBatchOp,
)
from .utils import MapBatchOp, ModelMapBatchOp, ModelTrainOpMixin


# ---------------------------------------------------------------------------
# constrained linear training
# ---------------------------------------------------------------------------


class _ConstrainedSolveMixin:
    """Routes the linear trainer's solver hook through the constrained
    optimizers. Constraints are linear, declared as JSON:
    ``{"A_eq": [[...]], "b_eq": [...], "A_ub": [[...]], "b_ub": [...]}``
    over the RAW weight vector incl. intercept slot — these ops default
    ``standardization`` OFF so the constraint means what the user wrote
    (a standardized fit would rescale the pinned weights at export)
    (reference: params/finance/HasConstraint.java — the reference encodes
    the same linear system in its ConstraintBetweenFeatures JSON)."""

    CONSTRAINT = ParamInfo("constraint", str, default=None,
                           desc="JSON linear constraint spec")
    CONSTRAINED_METHOD = ParamInfo(
        "constrainedMethod", str, default="alm",
        validator=InValidator("alm", "barrier"))

    def __init__(self, params=None, **kw):
        kw.setdefault("standardization", False)
        super().__init__(params, **kw)

    def _constraints(self):
        spec = self.get(self.CONSTRAINT)
        if not spec:
            return {}
        obj = json.loads(spec)
        out = {}
        for k in ("A_eq", "b_eq", "A_ub", "b_ub"):
            if k in obj:
                out[k] = np.asarray(obj[k], np.float32)
        return out

    def _solve(self, obj, X, y, sample_w):
        from ...optim import constrained_optimize

        cons = self._constraints()
        if not cons:
            return super()._solve(obj, X, y, sample_w)
        # same training knobs as the unconstrained path — adding a
        # constraint must not silently change unrelated behavior
        return constrained_optimize(
            obj, X, y, device=self.env.device,
            method=self.get(self.CONSTRAINED_METHOD),
            inner_max_iter=self.get(self.MAX_ITER),
            tol=self.get(self.EPSILON),
            sample_weights=sample_w,
            l1=self._effective_l1(), l2=self._effective_l2(),
            **cons)


def _divergence_loss(s, w, yj, wt):
    """The negated divergence of scores ``s`` between the classes, over
    their pooled variance, plus a tiny L2 (the divergence is
    scale-invariant); out-of-place torch ops, for ``torch.func``."""
    import torch

    p = yj * wt
    q = (1.0 - yj) * wt
    n_p = torch.clamp(p.sum(), min=1.0)
    n_q = torch.clamp(q.sum(), min=1.0)
    mu_p = (s * p).sum() / n_p
    mu_q = (s * q).sum() / n_q
    var_p = ((s - mu_p) ** 2 * p).sum() / n_p
    var_q = ((s - mu_q) ** 2 * q).sum() / n_q
    div = (mu_p - mu_q) ** 2 / (0.5 * (var_p + var_q) + 1e-6)
    # scaled by the rank's row count since the driver divides by n
    return -div + 1e-4 * (w @ w)


class ConstrainedLogisticRegressionTrainBatchOp(_ConstrainedSolveMixin,
                                                LogisticRegressionTrainBatchOp):
    """(reference: operator/batch/finance/
    ConstrainedLogisticRegressionTrainBatchOp.java)"""


class ConstrainedLinearRegTrainBatchOp(_ConstrainedSolveMixin,
                                       LinearRegTrainBatchOp):
    """(reference: operator/batch/finance/
    ConstrainedLinearRegTrainBatchOp.java)"""


class ConstrainedDivergenceTrainBatchOp(ModelTrainOpMixin, BatchOperator,
                                        _ConstrainedSolveMixin):
    """Scorecard-style divergence training: maximize the squared separation
    of score means between classes over the pooled score variance,
    optionally under linear weight constraints (reference:
    operator/batch/finance/ConstrainedDivergenceTrainBatchOp.java — the
    divergence objective of scorecard fitting)."""

    FEATURE_COLS = ParamInfo("featureCols", list, default=None)
    LABEL_COL = ParamInfo("labelCol", str, optional=False)
    MAX_ITER = ParamInfo("maxIter", int, default=100)

    _min_inputs = 1
    _max_inputs = 1

    def _static_meta_keys(self, in_schema):
        return {"modelName": "LinearModel",
                "labelType": in_schema.type_of(self.get(self.LABEL_COL))}

    def _execute_impl(self, t: MTable) -> MTable:
        from ...mapper import resolve_feature_cols

        label_col = self.get(self.LABEL_COL)
        feature_cols = resolve_feature_cols(t, self, exclude=[label_col])
        X = t.to_numeric_block(feature_cols, dtype=np.float32)
        y_raw = np.asarray(t.col(label_col))
        labels = sorted(set(y_raw.tolist()), key=str)
        if len(labels) != 2:
            raise AkIllegalDataException(
                f"divergence training needs 2 label values, got {len(labels)}")
        pos = (y_raw == labels[0]).astype(np.float32)
        n, d = X.shape
        Xb = np.concatenate([X, np.ones((n, 1), np.float32)], axis=1)

        def divergence_obj(dim):
            # per-rank divergence, all-reduce-averaged by the driver — exact
            # on one rank, a rank-average approximation across ranks
            from ...optim.objfunc import ObjFunc

            def local_loss(w, Xj, yj, wt):
                return _divergence_loss(Xj @ w, w, yj, wt) * Xj.shape[0]

            return ObjFunc(local_loss, dim)

        from ...optim import constrained_optimize, optimize

        cons = self._constraints()
        # w=0 is a stationary point of the divergence (all scores equal):
        # start from the class-mean direction instead
        mu_diff = (Xb[pos > 0.5].mean(0) - Xb[pos <= 0.5].mean(0))
        w0 = (mu_diff / max(np.linalg.norm(mu_diff), 1e-6)).astype(np.float32)
        if cons.get("A_eq") is not None and cons.get("A_ub") is None:
            # the divergence's scale-invariance defeats penalty methods
            # (shrinking w satisfies the penalty without changing the
            # objective) — equality constraints are solved EXACTLY in the
            # null space instead: w = N z, optimize z unconstrained
            A = np.atleast_2d(cons["A_eq"]).astype(np.float64)
            b = np.asarray(cons.get("b_eq", np.zeros(A.shape[0])),
                           np.float64)
            w_part = np.linalg.lstsq(A, b, rcond=None)[0]
            _u, sv, vt = np.linalg.svd(A)
            null = vt[np.sum(sv > 1e-10):].T  # (d+1, k)
            if null.shape[1] == 0:
                w = w_part.astype(np.float32)
                res = None
            else:
                Xz = (Xb @ null).astype(np.float32)
                shift = (Xb @ w_part).astype(np.float32)
                # scores = Xz z + shift with the shift coefficient FIXED at
                # 1 (append it as a column of the data, not of the weights)
                from ...optim.objfunc import ObjFunc as _ObjFunc

                def local_loss(z, Xj, yj, wt):
                    s = Xj[:, :-1] @ z + Xj[:, -1]
                    return _divergence_loss(s, z, yj, wt) * Xj.shape[0]

                obj2 = _ObjFunc(local_loss, null.shape[1])
                Xz2 = np.concatenate([Xz, shift[:, None]], axis=1)
                z0 = (null.T @ w0.astype(np.float64)).astype(np.float32)
                res = optimize(obj2, Xz2, pos, device=self.env.device, w0=z0,
                               max_iter=self.get(self.MAX_ITER))
                z = np.asarray(res.weights, np.float64)
                w = (null @ z + w_part).astype(np.float32)
        else:
            obj = divergence_obj(d + 1)
            if cons:
                res = constrained_optimize(
                    obj, Xb, pos, device=self.env.device,
                    method=self.get(self.CONSTRAINED_METHOD), w0=w0, **cons)
            else:
                res = optimize(obj, Xb, pos, device=self.env.device, w0=w0,
                               max_iter=self.get(self.MAX_ITER))
            w = res.weights
        # export at unit feature-weight norm when that cannot violate the
        # declared constraints (any inhomogeneous system pins a scale)
        rescalable = not cons or (
            cons.get("A_ub") is None
            and np.allclose(cons.get("b_eq", np.zeros(1)), 0.0))
        if rescalable:
            norm = float(np.linalg.norm(np.asarray(w)[:d]))
            if norm > 1e-9:
                w = np.asarray(w) / norm
        meta = {
            "modelName": "LinearModel",
            "linearModelType": "LinearReg",  # score = w·x + b serving
            "vectorCol": None,
            "featureCols": feature_cols,
            "labelCol": label_col,
            "labelType": t.schema.type_of(label_col),
            "labels": None,
            "hasIntercept": True,
            "dim": int(d),
            "loss": None if res is None else res.loss,
        }
        w = np.asarray(w)
        return model_to_table(meta, {
            "weights": w[:d].astype(np.float32),
            "intercept": np.asarray([w[d]], np.float32)})


# ---------------------------------------------------------------------------
# stepwise selectors
# ---------------------------------------------------------------------------


class _SelectorTrainBase(ModelTrainOpMixin, BatchOperator, HasSelectedCols):
    """Greedy forward selection: add the feature that most improves the
    training score until no gain or the cap (reference: feature/
    BaseStepwiseSelectorBatchOp.java forward stepwise)."""

    LABEL_COL = ParamInfo("labelCol", str, optional=False)
    MAX_SELECTED = ParamInfo("maxSelected", int, default=5,
                             aliases=("sMax", "k"),
                             validator=MinValidator(1))
    MIN_GAIN = ParamInfo("minGain", float, default=1e-4)

    _min_inputs = 1
    _max_inputs = 1
    _binary = True

    def _static_meta_keys(self, in_schema):
        return {"modelName": "SelectorModel"}

    def _fit_weights(self, X: np.ndarray, y: np.ndarray):
        """Least-squares fit of the working response — shared by the binary
        (linear-probability working model, like the reference's fast
        stepwise scoring) and regression selectors."""
        Xb = np.concatenate([X, np.ones((len(X), 1))], axis=1)
        w, *_ = np.linalg.lstsq(Xb, y, rcond=None)
        return w

    def _final_fit_weights(self, X: np.ndarray, y: np.ndarray):
        """Fit of the CHOSEN columns for the exported model — constrained
        variants override this (candidate scoring stays unconstrained)."""
        return self._fit_weights(X, y)

    def _score(self, X: np.ndarray, y: np.ndarray) -> float:
        w = self._fit_weights(X, y)
        Xb = np.concatenate([X, np.ones((len(X), 1))], axis=1)
        pred = Xb @ w
        if self._binary:
            # AUC of the score against the binary label
            order = np.argsort(pred)
            ranks = np.empty(len(pred))
            ranks[order] = np.arange(1, len(pred) + 1)
            pos = y > 0.5
            n_pos, n_neg = int(pos.sum()), int((~pos).sum())
            if n_pos == 0 or n_neg == 0:
                return 0.5
            return ((ranks[pos].sum() - n_pos * (n_pos + 1) / 2)
                    / (n_pos * n_neg))
        ss_res = float(((y - pred) ** 2).sum())
        ss_tot = float(((y - y.mean()) ** 2).sum()) + 1e-12
        return 1.0 - ss_res / ss_tot

    def _execute_impl(self, t: MTable) -> MTable:
        label_col = self.get(self.LABEL_COL)
        cols = list(self.get(HasSelectedCols.SELECTED_COLS) or
                    [c for c, tp in zip(t.names, t.schema.types)
                     if AlinkTypes.is_numeric(tp) and c != label_col])
        y_raw = np.asarray(t.col(label_col))
        if self._binary:
            labels = sorted(set(y_raw.tolist()), key=str)
            if len(labels) != 2:
                raise AkIllegalDataException(
                    f"binary selector needs 2 labels, got {len(labels)}")
            y = (y_raw == labels[1]).astype(np.float64)
        else:
            y = np.asarray(y_raw, np.float64)
        X_all = {c: np.asarray(t.col(c), np.float64) for c in cols}
        chosen: List[str] = []
        best_score = 0.5 if self._binary else 0.0
        history = []
        cap = min(int(self.get(self.MAX_SELECTED)), len(cols))
        min_gain = float(self.get(self.MIN_GAIN))
        while len(chosen) < cap:
            gains = []
            for c in cols:
                if c in chosen:
                    continue
                X = np.stack([X_all[k] for k in chosen + [c]], axis=1)
                gains.append((self._score(X, y), c))
            if not gains:
                break
            score, cand = max(gains)
            if score - best_score < min_gain and chosen:
                break
            chosen.append(cand)
            best_score = score
            history.append({"step": len(chosen), "col": cand,
                            "score": round(float(score), 6)})
        X = np.stack([X_all[k] for k in chosen], axis=1)
        w = self._final_fit_weights(X, y)
        meta = {
            "modelName": "SelectorModel",
            "binary": self._binary,
            "selectedCols": chosen,
            "labelCol": label_col,
            "score": float(best_score),
            "history": history,
        }
        return model_to_table(
            meta, {"weights": w[:-1].astype(np.float64),
                   "intercept": np.asarray([w[-1]], np.float64)})


class BinarySelectorTrainBatchOp(_SelectorTrainBase):
    """(reference: operator/batch/feature/BinarySelectorTrainBatchOp.java)"""

    _binary = True


class RegressionSelectorTrainBatchOp(_SelectorTrainBase):
    """(reference: operator/batch/feature/
    RegressionSelectorTrainBatchOp.java)"""

    _binary = False


class _SelectorPredictMapper(ModelMapper, HasPredictionCol, HasReservedCols):
    def load_model(self, model: MTable):
        self.meta, a = table_to_model(model)
        self.w = a["weights"]
        self.b = float(a["intercept"][0])
        return self

    def output_schema(self, input_schema):
        return self._append_result_schema(
            input_schema, [self.get(HasPredictionCol.PREDICTION_COL)],
            [AlinkTypes.DOUBLE])

    def map_table(self, t: MTable) -> MTable:
        X = np.stack([np.asarray(t.col(c), np.float64)
                      for c in self.meta["selectedCols"]], axis=1)
        score = X @ self.w + self.b
        oc = self.get(HasPredictionCol.PREDICTION_COL)
        return self._append_result(t, {oc: score}, {oc: AlinkTypes.DOUBLE})


class BinarySelectorPredictBatchOp(ModelMapBatchOp, HasPredictionCol,
                                   HasReservedCols):
    """(reference: operator/batch/feature/BinarySelectorPredictBatchOp.java)"""

    mapper_cls = _SelectorPredictMapper


class RegressionSelectorPredictBatchOp(BinarySelectorPredictBatchOp):
    """(reference: operator/batch/feature/
    RegressionSelectorPredictBatchOp.java)"""


class ConstrainedBinarySelectorTrainBatchOp(BinarySelectorTrainBatchOp,
                                            _ConstrainedSolveMixin):
    """Stepwise binary selection whose FINAL refit honors linear weight
    constraints; candidate scoring stays unconstrained. The constraint
    matrix columns map to the chosen columns in selection order plus the
    intercept slot (reference: operator/batch/feature/
    ConstrainedBinarySelectorTrainBatchOp.java)."""

    def _final_fit_weights(self, X, y):
        cons = self._constraints()
        if not cons:
            return super()._final_fit_weights(X, y)
        from ...optim import constrained_optimize, squared_obj

        Xb = np.concatenate([X, np.ones((len(X), 1))], axis=1)
        width = Xb.shape[1]
        for key in ("A_eq", "A_ub"):
            if key in cons and np.atleast_2d(cons[key]).shape[1] != width:
                raise AkIllegalArgumentException(
                    f"constraint {key} has "
                    f"{np.atleast_2d(cons[key]).shape[1]} columns but the "
                    f"final model has {width} (selected cols in order + "
                    f"intercept)")
        res = constrained_optimize(
            squared_obj(width), Xb.astype(np.float32),
            y.astype(np.float32), device=self.env.device,
            method=self.get(self.CONSTRAINED_METHOD), **cons)
        return np.asarray(res.weights, np.float64)


class ConstrainedRegSelectorTrainBatchOp(ConstrainedBinarySelectorTrainBatchOp):
    """(reference: operator/batch/feature/
    ConstrainedRegSelectorTrainBatchOp.java)"""

    _binary = False


class ConstrainedBinarySelectorPredictBatchOp(BinarySelectorPredictBatchOp):
    """(reference: operator/batch/feature/
    ConstrainedBinarySelectorPredictBatchOp.java)"""


class ConstrainedRegSelectorPredictBatchOp(BinarySelectorPredictBatchOp):
    """(reference: operator/batch/feature/
    ConstrainedRegSelectorPredictBatchOp.java)"""


# ---------------------------------------------------------------------------
# feature crosses
# ---------------------------------------------------------------------------


class CrossFeatureTrainBatchOp(ModelTrainOpMixin, BatchOperator,
                               HasSelectedCols):
    """Dictionary of observed value COMBINATIONS of the selected categorical
    columns (reference: operator/batch/feature/CrossFeatureTrainBatchOp
    .java)."""

    _min_inputs = 1
    _max_inputs = 1

    def _static_meta_keys(self, in_schema):
        return {"modelName": "CrossFeatureModel"}

    def _execute_impl(self, t: MTable) -> MTable:
        cols = list(self.get(HasSelectedCols.SELECTED_COLS))
        arrays = [np.asarray(t.col(c), object) for c in cols]
        combos: List[str] = []
        seen: Dict[str, int] = {}
        for i in range(t.num_rows):
            key = "\x01".join(str(a[i]) for a in arrays)
            if key not in seen:
                seen[key] = len(combos)
                combos.append(key)
        meta = {"modelName": "CrossFeatureModel", "selectedCols": cols,
                "combos": combos}
        return model_to_table(meta, {})


class CrossFeatureModelMapper(ModelMapper, HasOutputCol, HasReservedCols):
    """Combination → one-hot sparse vector (unseen → empty slot)."""

    def load_model(self, model: MTable):
        self.meta, _ = table_to_model(model)
        self.lut = {k: i for i, k in enumerate(self.meta["combos"])}
        return self

    def output_schema(self, input_schema):
        out = self.get(HasOutputCol.OUTPUT_COL) or "cross"
        return self._append_result_schema(
            input_schema, [out], [AlinkTypes.SPARSE_VECTOR])

    def map_table(self, t: MTable) -> MTable:
        cols = self.meta["selectedCols"]
        arrays = [np.asarray(t.col(c), object) for c in cols]
        dim = len(self.lut) + 1  # last slot = unseen
        vecs = np.empty(t.num_rows, object)
        for i in range(t.num_rows):
            key = "\x01".join(str(a[i]) for a in arrays)
            j = self.lut.get(key, dim - 1)
            vecs[i] = SparseVector(dim, np.asarray([j], np.int64),
                                   np.asarray([1.0]))
        out = self.get(HasOutputCol.OUTPUT_COL) or "cross"
        return self._append_result(
            t, {out: vecs}, {out: AlinkTypes.SPARSE_VECTOR})


class CrossFeaturePredictBatchOp(ModelMapBatchOp, HasOutputCol,
                                 HasReservedCols):
    """(reference: operator/batch/feature/CrossFeaturePredictBatchOp.java)"""

    mapper_cls = CrossFeatureModelMapper


class HashCrossFeatureMapper(Mapper, HasSelectedCols, HasOutputCol,
                             HasReservedCols):
    """Stateless cross: hash the value combination into numBuckets
    (reference: operator/batch/feature/HashCrossFeatureBatchOp.java)."""

    NUM_FEATURES = ParamInfo("numFeatures", int, default=262144,
                             aliases=("numBuckets",),
                             validator=MinValidator(2))

    def output_schema(self, input_schema):
        out = self.get(HasOutputCol.OUTPUT_COL) or "cross"
        return self._append_result_schema(
            input_schema, [out], [AlinkTypes.SPARSE_VECTOR])

    def map_table(self, t: MTable) -> MTable:
        from .similarity import _fnv64

        cols = list(self.get(HasSelectedCols.SELECTED_COLS))
        arrays = [np.asarray(t.col(c), object) for c in cols]
        dim = int(self.get(self.NUM_FEATURES))
        vecs = np.empty(t.num_rows, object)
        for i in range(t.num_rows):
            key = "\x01".join(str(a[i]) for a in arrays)
            j = _fnv64(key) % dim
            vecs[i] = SparseVector(dim, np.asarray([j], np.int64),
                                   np.asarray([1.0]))
        out = self.get(HasOutputCol.OUTPUT_COL) or "cross"
        return self._append_result(
            t, {out: vecs}, {out: AlinkTypes.SPARSE_VECTOR})


class HashCrossFeatureBatchOp(MapBatchOp, HasSelectedCols, HasOutputCol,
                              HasReservedCols):
    mapper_cls = HashCrossFeatureMapper
    NUM_FEATURES = HashCrossFeatureMapper.NUM_FEATURES


class CrossCandidateSelectorTrainBatchOp(ModelTrainOpMixin, BatchOperator):
    """Score candidate column crosses by chi-square against the label and
    keep the best (reference: operator/batch/feature/
    CrossCandidateSelectorTrainBatchOp.java)."""

    FEATURE_CANDIDATES = ParamInfo(
        "featureCandidates", list, optional=False,
        desc="list of column-name lists, one per candidate cross")
    LABEL_COL = ParamInfo("labelCol", str, optional=False)
    CROSS_FEATURE_NUMBER = ParamInfo("crossFeatureNumber", int, default=1,
                                     aliases=("topN",),
                                     validator=MinValidator(1))

    _min_inputs = 1
    _max_inputs = 1

    def _static_meta_keys(self, in_schema):
        return {"modelName": "CrossFeatureModel"}

    def _execute_impl(self, t: MTable) -> MTable:
        from .statistics import _contingency, chi_square_test

        label_col = self.get(self.LABEL_COL)
        y = t.col(label_col)
        scored = []
        for cand in self.get(self.FEATURE_CANDIDATES):
            cols = list(cand)
            arrays = [np.asarray(t.col(c), object) for c in cols]
            crossed = np.asarray(
                ["\x01".join(str(a[i]) for a in arrays)
                 for i in range(t.num_rows)], object)
            stat, _p, _dof = chi_square_test(_contingency(crossed, y))
            scored.append((float(stat), cols))
        scored.sort(key=lambda s: -s[0])
        keep = scored[: self.get(self.CROSS_FEATURE_NUMBER)]
        # train a combo dictionary for EVERY kept cross; the predict mapper
        # concatenates their one-hots
        crosses = []
        for _stat, cols in keep:
            inner_model = CrossFeatureTrainBatchOp(
                selectedCols=cols)._execute_impl(t)
            inner_meta, _ = table_to_model(inner_model)
            crosses.append({"cols": cols, "combos": inner_meta["combos"]})
        meta = {"modelName": "CrossFeatureModel",
                # single-cross fields kept for CrossFeatureModelMapper compat
                "selectedCols": crosses[0]["cols"],
                "combos": crosses[0]["combos"],
                "crosses": crosses,
                "candidates": [{"cols": c, "chi2": s} for s, c in scored]}
        return model_to_table(meta, {})


class CrossCandidateSelectorModelMapper(CrossFeatureModelMapper):
    """Concatenated one-hot over ALL selected crosses."""

    def load_model(self, model: MTable):
        self.meta, _ = table_to_model(model)
        self.crosses = self.meta.get(
            "crosses", [{"cols": self.meta["selectedCols"],
                         "combos": self.meta["combos"]}])
        self.luts = [({k: i for i, k in enumerate(c["combos"])}, c["cols"])
                     for c in self.crosses]
        return self

    def map_table(self, t: MTable) -> MTable:
        dims = [len(lut) + 1 for lut, _ in self.luts]
        offsets = np.concatenate([[0], np.cumsum(dims)])
        total = int(offsets[-1])
        vecs = np.empty(t.num_rows, object)
        col_arrays = [
            ([np.asarray(t.col(c), object) for c in cols], lut)
            for lut, cols in self.luts]
        for i in range(t.num_rows):
            idx = []
            for ci, (arrays, lut) in enumerate(col_arrays):
                key = "\x01".join(str(a[i]) for a in arrays)
                idx.append(offsets[ci] + lut.get(key, dims[ci] - 1))
            sidx = np.asarray(sorted(idx), np.int64)
            vecs[i] = SparseVector(total, sidx, np.ones(len(sidx)))
        out = self.get(HasOutputCol.OUTPUT_COL) or "cross"
        return self._append_result(
            t, {out: vecs}, {out: AlinkTypes.SPARSE_VECTOR})


class CrossCandidateSelectorPredictBatchOp(CrossFeaturePredictBatchOp):
    """(reference: operator/batch/feature/
    CrossCandidateSelectorPredictBatchOp.java)"""

    mapper_cls = CrossCandidateSelectorModelMapper


class AutoCrossTrainBatchOp(AutoCrossBatchOp):
    """(reference: operator/batch/feature/AutoCrossTrainBatchOp.java)"""


class AutoCrossAlgoTrainBatchOp(AutoCrossBatchOp):
    """(reference: operator/batch/feature/AutoCrossAlgoTrainBatchOp.java)"""


class BaseCrossTrainBatchOp(CrossFeatureTrainBatchOp):
    """(reference: operator/batch/feature/BaseCrossTrainBatchOp.java)"""


# ---------------------------------------------------------------------------
# WOE
# ---------------------------------------------------------------------------


class WoeTrainBatchOp(ModelTrainOpMixin, BatchOperator, HasSelectedCols):
    """Per-CATEGORY weight of evidence against a binary label (reference:
    operator/batch/finance/WoeTrainBatchOp.java; the numeric-binning WOE
    lives in BinningTrainBatchOp)."""

    LABEL_COL = ParamInfo("labelCol", str, optional=False)
    POSITIVE_LABEL = ParamInfo("positiveLabelValueString", str, default=None,
                               aliases=("positiveValue",))

    _min_inputs = 1
    _max_inputs = 1

    def _static_meta_keys(self, in_schema):
        return {"modelName": "WoeModel"}

    def _execute_impl(self, t: MTable) -> MTable:
        label_col = self.get(self.LABEL_COL)
        cols = list(self.get(HasSelectedCols.SELECTED_COLS) or
                    [c for c in t.names if c != label_col])
        y_raw = np.asarray(t.col(label_col))
        pos_val = self.get(self.POSITIVE_LABEL)
        if pos_val is None:
            pos_val = str(sorted(set(y_raw.tolist()), key=str)[-1])
        pos = np.asarray([str(v) == pos_val for v in y_raw])
        n_pos = max(int(pos.sum()), 1)
        n_neg = max(int((~pos).sum()), 1)
        maps: Dict[str, Dict[str, float]] = {}
        ivs: Dict[str, float] = {}
        for c in cols:
            vals = np.asarray(t.col(c), object).astype(str)
            woe: Dict[str, float] = {}
            iv = 0.0
            for cat in np.unique(vals):
                mask = vals == cat
                p = (pos & mask).sum() + 0.5
                q = (~pos & mask).sum() + 0.5
                rate_p = p / n_pos
                rate_q = q / n_neg
                w = float(np.log(rate_p / rate_q))
                woe[str(cat)] = w
                iv += (rate_p - rate_q) * w
            maps[c] = woe
            ivs[c] = float(iv)
        meta = {"modelName": "WoeModel", "selectedCols": cols,
                "positiveValue": pos_val, "woe": maps, "iv": ivs}
        return model_to_table(meta, {})


class WoeModelMapper(ModelMapper, HasReservedCols, HasSelectedCols):
    def load_model(self, model: MTable):
        self.meta, _ = table_to_model(model)
        return self

    def output_schema(self, input_schema):
        names, types = list(input_schema.names), list(input_schema.types)
        for c in self.meta["selectedCols"]:
            types[names.index(c)] = AlinkTypes.DOUBLE
        return TableSchema(names, types)

    def map_table(self, t: MTable) -> MTable:
        out = t
        for c in self.meta["selectedCols"]:
            woe = self.meta["woe"][c]
            vals = np.asarray(t.col(c), object).astype(str)
            out = out.with_column(
                c, np.asarray([woe.get(v, 0.0) for v in vals], np.float64),
                AlinkTypes.DOUBLE)
        return out


class WoePredictBatchOp(ModelMapBatchOp, HasReservedCols, HasSelectedCols):
    """(reference: operator/batch/finance/WoePredictBatchOp.java)"""

    mapper_cls = WoeModelMapper


class BinningTrainForScorecardBatchOp(BinningTrainBatchOp):
    """Binning preset used by the scorecard flow (reference:
    operator/batch/finance/BinningTrainForScorecardBatchOp.java)."""


# ---------------------------------------------------------------------------
# multicollinearity
# ---------------------------------------------------------------------------


class MultiCollinearityBatchOp(BatchOperator, HasSelectedCols):
    """Variance inflation factors + condition number per feature
    (reference: operator/batch/statistics/MultiCollinearityBatchOp.java)."""

    _min_inputs = 1
    _max_inputs = 1

    def _execute_impl(self, t: MTable) -> MTable:
        cols = list(self.get(HasSelectedCols.SELECTED_COLS) or
                    [c for c, tp in zip(t.names, t.schema.types)
                     if AlinkTypes.is_numeric(tp)])
        X = t.to_numeric_block(cols, dtype=np.float64)
        Xc = X - X.mean(0)
        sd = Xc.std(0)
        sd = np.where(sd < 1e-12, 1.0, sd)
        Xn = Xc / sd
        corr = (Xn.T @ Xn) / max(len(X) - 1, 1)
        # VIF_j = diag(corr^-1)
        inv = np.linalg.pinv(corr)
        vif = np.clip(np.diag(inv), 1.0, None)
        evals = np.linalg.eigvalsh(corr)
        cond = float(np.sqrt(max(evals.max(), 1e-12)
                             / max(evals.min(), 1e-12)))
        rows = [(c, float(v), cond) for c, v in zip(cols, vif)]
        return MTable.from_rows(rows, self._out_schema(t.schema))

    def _out_schema(self, in_schema):
        return TableSchema(["feature", "VIF", "conditionNumber"],
                           [AlinkTypes.STRING, AlinkTypes.DOUBLE,
                            AlinkTypes.DOUBLE])


# ---------------------------------------------------------------------------
# association-rule long-tail
# ---------------------------------------------------------------------------


class GroupedFpGrowthBatchOp(BatchOperator, HasSelectedCol):
    """FpGrowth per group (reference: operator/batch/associationrule/
    GroupedFpGrowthBatchOp.java)."""

    GROUP_COL = ParamInfo("groupCol", str, optional=False)
    MIN_SUPPORT_PERCENT = FpGrowthBatchOp.MIN_SUPPORT_PERCENT
    MIN_SUPPORT_COUNT = FpGrowthBatchOp.MIN_SUPPORT_COUNT
    ITEM_DELIMITER = FpGrowthBatchOp.ITEM_DELIMITER
    MAX_PATTERN_LENGTH = FpGrowthBatchOp.MAX_PATTERN_LENGTH

    _min_inputs = 1
    _max_inputs = 1

    def _execute_impl(self, t: MTable) -> MTable:
        group_col = self.get(self.GROUP_COL)
        groups = np.asarray(t.col(group_col), object)
        parts = []
        inner_params = self.get_params().clone()
        for g in sorted(set(groups.tolist()), key=str):
            sub = t.filter_mask(groups == g)
            inner = FpGrowthBatchOp(inner_params.clone())
            res = inner._execute_impl(sub)
            if isinstance(res, tuple):  # (itemsets, [rules side output])
                res = res[0]
            res = res.with_column(
                group_col, np.asarray([g] * res.num_rows, object),
                t.schema.type_of(group_col))
            parts.append(res)
        return MTable.concat(parts)

    def _out_schema(self, in_schema):
        inner = FpGrowthBatchOp(self.get_params().clone())
        base = inner._out_schema(in_schema)
        group_col = self.get(self.GROUP_COL)
        return TableSchema(
            list(base.names) + [group_col],
            list(base.types) + [in_schema.type_of(group_col)])


class ApplyAssociationRuleBatchOp(ModelMapBatchOp, HasSelectedCol,
                                  HasOutputCol, HasReservedCols):
    """Apply mined rules to transactions: emit the consequents whose
    antecedents are contained in the row's item set
    (reference: operator/batch/associationrule/
    ApplyAssociationRuleBatchOp.java; ``link_from(rules, data)``)."""

    class _Mapper(ModelMapper, HasSelectedCol, HasOutputCol,
                  HasReservedCols):
        ITEM_DELIMITER = ParamInfo("itemDelimiter", str, default=",")

        def load_model(self, model: MTable):
            # rules table: antecedent, consequent (, support/confidence...)
            delim = self.get(self.ITEM_DELIMITER)
            ant = [set(str(v).split(delim))
                   for v in model.col(model.names[0])]
            cons = [str(v) for v in model.col(model.names[1])]
            self.rules = list(zip(ant, cons))
            return self

        def output_schema(self, input_schema):
            out = self.get(HasOutputCol.OUTPUT_COL) or "recommendations"
            return self._append_result_schema(
                input_schema, [out], [AlinkTypes.STRING])

        def map_table(self, t: MTable) -> MTable:
            delim = self.get(self.ITEM_DELIMITER)
            sel = self.get(HasSelectedCol.SELECTED_COL)
            out = self.get(HasOutputCol.OUTPUT_COL) or "recommendations"
            res = np.empty(t.num_rows, object)
            for i, v in enumerate(t.col(sel)):
                items = set(str(v).split(delim)) if v is not None else set()
                hits = sorted({c for a, c in self.rules
                               if a <= items and c not in items})
                res[i] = ",".join(hits)
            return self._append_result(
                t, {out: res}, {out: AlinkTypes.STRING})

    mapper_cls = _Mapper
    ITEM_DELIMITER = _Mapper.ITEM_DELIMITER


class ApplySequenceRuleBatchOp(ApplyAssociationRuleBatchOp):
    """Apply sequence rules: the antecedent must appear as a SUBSEQUENCE
    (order preserved) of the row's event sequence (reference:
    operator/batch/associationrule/ApplySequenceRuleBatchOp.java)."""

    class _Mapper(ApplyAssociationRuleBatchOp._Mapper):
        def load_model(self, model: MTable):
            delim = self.get(self.ITEM_DELIMITER)
            self.rules = [
                ([a for a in str(v).split(delim) if a], str(c))
                for v, c in zip(model.col(model.names[0]),
                                model.col(model.names[1]))]
            return self

        @staticmethod
        def _subseq(needle: List[str], hay: List[str]) -> bool:
            it = iter(hay)
            return all(any(x == h for h in it) for x in needle)

        def map_table(self, t: MTable) -> MTable:
            delim = self.get(self.ITEM_DELIMITER)
            sel = self.get(HasSelectedCol.SELECTED_COL)
            out = self.get(HasOutputCol.OUTPUT_COL) or "recommendations"
            res = np.empty(t.num_rows, object)
            for i, v in enumerate(t.col(sel)):
                seq = [x for x in str(v).split(delim)] if v is not None else []
                hits = sorted({c for a, c in self.rules
                               if self._subseq(a, seq) and c not in seq})
                res[i] = ",".join(hits)
            return self._append_result(
                t, {out: res}, {out: AlinkTypes.STRING})

    mapper_cls = _Mapper


# ---------------------------------------------------------------------------
# GLM evaluation
# ---------------------------------------------------------------------------


class GlmEvaluationBatchOp(BatchOperator):
    """Deviance/AIC diagnostics of a fitted GLM on a dataset
    (reference: operator/batch/regression/GlmEvaluationBatchOp.java);
    ``link_from(glm_model, data)``."""

    _min_inputs = 2
    _max_inputs = 2

    def _execute_impl(self, model: MTable, t: MTable) -> MTable:
        from .regression import GlmPredictBatchOp

        meta, _ = table_to_model(model)
        label_col = meta["labelCol"]
        pred = GlmPredictBatchOp(predictionCol="__glm_pred")
        scored = pred._execute_impl(model, t)
        y = np.asarray(t.col(label_col), np.float64)
        mu = np.asarray(scored.col("__glm_pred"), np.float64)
        family = str(meta.get("family", "gaussian")).lower()

        def deviance(mu_hat):
            eps = 1e-12
            if family == "poisson":
                return float(2.0 * np.sum(np.where(
                    y > 0,
                    y * np.log(np.maximum(y, eps) / np.maximum(mu_hat, eps)),
                    0.0) - (y - mu_hat)))
            if family == "binomial":
                mu_c = np.clip(mu_hat, eps, 1 - eps)
                return float(-2.0 * np.sum(
                    y * np.log(mu_c) + (1 - y) * np.log(1 - mu_c)))
            if family == "gamma":
                return float(2.0 * np.sum(
                    -np.log(np.maximum(y, eps) / np.maximum(mu_hat, eps))
                    + (y - mu_hat) / np.maximum(mu_hat, eps)))
            return float(np.sum((y - mu_hat) ** 2))

        dev = deviance(mu)
        # intercept-only model: mu = mean(y) for every canonical family
        null_dev = deviance(np.full_like(y, y.mean()))
        k = int(meta.get("dim", 0)) + 1
        n = len(y)
        aic = float(dev + 2 * k)
        rows = [
            ("deviance", float(dev)),
            ("nullDeviance", null_dev),
            ("aic", aic),
            ("degreesOfFreedom", float(n - k)),
        ]
        return MTable.from_rows(rows, self._out_schema(None, None))

    def _out_schema(self, *_):
        return TableSchema(["metric", "value"],
                           [AlinkTypes.STRING, AlinkTypes.DOUBLE])
