"""Regression breadth: GLM, Isotonic regression, AFT survival regression,
forward-stepwise linear regression (port of
``alink_tpu.operator.batch.regression``).

Capability parity with the reference regression package (reference:
core/src/main/java/com/alibaba/alink/operator/batch/regression/
GlmTrainBatchOp.java + common/regression/glm/ (FamilyLink, Family.java,
Link.java — IRLS via WeightedLeastSquares), IsotonicRegTrainBatchOp.java +
common/regression/IsotonicRegressionModelData (pool-adjacent-violators),
AftSurvivalRegTrainBatchOp.java + common/regression/AftRegObjFunc.java;
LinearSvrTrainBatchOp lives in linear.py on the shared optimizer stack).

- GLM IRLS runs on the session's device in float32, a fixed count of
  rounds with no host sync between them: each round builds the working
  response and weights elementwise and solves the (d×d) normal equations
  from two products.
- Isotonic PAV is the inherently sequential pooling pass, and stepwise
  selection a loop of small float64 least-squares refits: both stay on the
  host in numpy, as in the reference.
- AFT rides the shared optimizer with a custom objective
  (optim/objfunc.py::aft_obj), as the reference routes it through its
  Optimizer framework.
- The GLM, AFT and Isotonic predictions are host numpy over the model's
  few coefficients, as the reference computes them.
"""

from __future__ import annotations

from typing import List

import numpy as np

from ...common.exceptions import AkIllegalArgumentException
from ...common.model import model_to_table, table_to_model
from ...common.mtable import AlinkTypes, MTable
from ...common.params import InValidator, MinValidator, ParamInfo
from ...mapper import (
    HasFeatureCols,
    HasPredictionCol,
    HasReservedCols,
    HasVectorCol,
    RichModelMapper,
    get_feature_block,
    merge_feature_params,
    resolve_feature_cols,
)
from ...optim import aft_obj, optimize
from .base import BatchOperator
from .utils import ModelMapBatchOp, ModelTrainOpMixin


# ---------------------------------------------------------------------------
# GLM
# ---------------------------------------------------------------------------

_CANONICAL_LINKS = {"Gaussian": "Identity", "Binomial": "Logit",
                    "Poisson": "Log", "Gamma": "Inverse"}


def _glm_fns(family: str, link: str, xp=np):
    """(link, inverse-link, d-mu/d-eta, variance) over the array namespace
    ``xp``: numpy on the host, torch on the device."""
    if link == "Identity":
        g = lambda mu: mu
        ginv = lambda eta: eta
        dmu = lambda eta: xp.ones_like(eta)
    elif link == "Log":
        g = lambda mu: xp.log(mu)
        ginv = lambda eta: xp.exp(eta)
        dmu = lambda eta: xp.exp(eta)
    elif link == "Logit":
        g = lambda mu: xp.log(mu / (1.0 - mu))
        ginv = lambda eta: 1.0 / (1.0 + xp.exp(-eta))
        dmu = lambda eta: (s := 1.0 / (1.0 + xp.exp(-eta))) * (1.0 - s)
    elif link == "Inverse":
        g = lambda mu: 1.0 / mu
        ginv = lambda eta: 1.0 / eta
        dmu = lambda eta: -1.0 / (eta * eta)
    elif link == "Sqrt":
        g = lambda mu: xp.sqrt(mu)
        ginv = lambda eta: eta * eta
        dmu = lambda eta: 2.0 * eta
    else:
        raise AkIllegalArgumentException(f"unknown GLM link {link}")

    lo = lambda v: xp.clip(v, 1e-8, None)
    if family == "Gaussian":
        var = lambda mu: xp.ones_like(mu)
    elif family == "Binomial":
        var = lambda mu: lo(mu * (1.0 - mu))
    elif family == "Poisson":
        var = lambda mu: lo(mu)
    elif family == "Gamma":
        var = lambda mu: lo(mu * mu)
    else:
        raise AkIllegalArgumentException(f"unknown GLM family {family}")
    return g, ginv, dmu, var


class GlmTrainBatchOp(ModelTrainOpMixin, BatchOperator, HasFeatureCols):
    """(reference: GlmTrainBatchOp.java — IRLS with family/link)"""

    LABEL_COL = ParamInfo("labelCol", str, optional=False)
    WEIGHT_COL = ParamInfo("weightCol", str)
    OFFSET_COL = ParamInfo("offsetCol", str)
    FAMILY = ParamInfo("family", str, default="Gaussian",
                       validator=InValidator("Gaussian", "Binomial",
                                             "Poisson", "Gamma"))
    LINK = ParamInfo("link", str)  # default: family's canonical link
    MAX_ITER = ParamInfo("maxIter", int, default=25, validator=MinValidator(1))
    REG_PARAM = ParamInfo("regParam", float, default=0.0,
                          validator=MinValidator(0.0))
    FIT_INTERCEPT = ParamInfo("fitIntercept", bool, default=True)

    _min_inputs = 1
    _max_inputs = 1

    def _family_link(self):
        family = self.get(self.FAMILY)
        link = self.get(self.LINK) or _CANONICAL_LINKS[family]
        return family, link

    def _static_meta_keys(self, in_schema):
        family, link = self._family_link()
        return {"modelName": "GlmModel", "family": family, "link": link}

    def _execute_impl(self, t: MTable) -> MTable:
        import torch

        from ...common.env import resolve_device

        label_col = self.get(self.LABEL_COL)
        weight_col = self.get(self.WEIGHT_COL)
        offset_col = self.get(self.OFFSET_COL)
        feature_cols = resolve_feature_cols(
            t, self, exclude=[label_col, weight_col, offset_col])
        X = t.to_numeric_block(feature_cols, dtype=np.float32)
        y = np.asarray(t.col(label_col), np.float32)
        n, d_raw = X.shape
        wt = (np.asarray(t.col(weight_col), np.float32) if weight_col
              else np.ones(n, np.float32))
        offset = (np.asarray(t.col(offset_col), np.float32) if offset_col
                  else np.zeros(n, np.float32))
        intercept = self.get(self.FIT_INTERCEPT)
        if intercept:
            X = np.concatenate([X, np.ones((n, 1), np.float32)], axis=1)
        d = X.shape[1]
        family, link = self._family_link()
        g, ginv, dmu, var = _glm_fns(family, link, torch)
        ridge = max(self.get(self.REG_PARAM), 1e-5)
        max_iter = self.get(self.MAX_ITER)

        dev = resolve_device(self.env.device)
        X, y, wt, offset = (torch.tensor(a, device=dev)
                            for a in (X, y, wt, offset))
        eye = ridge * torch.eye(d, dtype=torch.float32, device=dev)

        def solve(w, z):
            XtW = (X * w[:, None]).T           # (d, n)
            return torch.linalg.solve(XtW @ X + eye, XtW @ z)

        # standard GLM starting values: shrink the response toward the
        # center so no initial eta saturates (IRLS is undamped Newton —
        # extreme starts oscillate)
        if family == "Binomial":
            mu0 = (y + 0.5) / 2.0
        else:
            mu0 = torch.clamp((y + y.mean()) / 2.0, min=1e-3)
        eta0 = g(mu0)
        # one weighted-LS warm start on the working response at eta0
        mu = ginv(eta0)
        d_eta = dmu(eta0)
        z0 = eta0 - offset + (y - mu) / torch.where(
            d_eta.abs() < 1e-6, 1e-6, d_eta)
        beta = solve(wt * d_eta * d_eta / var(mu), z0)
        for _ in range(max_iter):
            # clip eta: saturated links (logit at |eta|≫0) zero the IRLS
            # weights and blow up the working response in f32
            eta = torch.clamp(X @ beta + offset, -15.0, 15.0)
            mu = ginv(eta)
            d_eta = dmu(eta)
            safe = torch.where(d_eta.abs() < 1e-6,
                               torch.sign(d_eta) * 1e-6 + (d_eta == 0) * 1e-6,
                               d_eta)
            z = eta - offset + (y - mu) / safe
            beta = solve(wt * d_eta * d_eta / var(mu), z)
        beta = beta.cpu().numpy()
        coef = beta[:d_raw]
        b = float(beta[d_raw]) if intercept else 0.0
        meta = {
            "modelName": "GlmModel",
            "family": family, "link": link,
            "featureCols": feature_cols,
            "labelCol": label_col,
            "hasIntercept": bool(intercept),
            "dim": int(d_raw),
        }
        return model_to_table(meta, {
            "coefficients": coef.astype(np.float32),
            "intercept": np.asarray([b], np.float32)})


class GlmModelMapper(RichModelMapper):
    """(reference: common/regression/GlmModelMapper.java)"""

    def load_model(self, model: MTable):
        self.meta, arrays = table_to_model(model)
        self.coef = arrays["coefficients"]
        self.intercept = float(arrays["intercept"][0])
        return self

    def _pred_type(self) -> str:
        return AlinkTypes.DOUBLE

    def predict_block(self, t: MTable):
        X = get_feature_block(
            t, merge_feature_params(self.get_params(), self.meta),
            vector_size=self.meta["dim"]).astype(np.float32)
        _, ginv, _, _ = _glm_fns(self.meta["family"], self.meta["link"])
        eta = X @ self.coef + np.float32(self.intercept)
        mu = np.asarray(ginv(eta), np.float32)
        return mu.astype(np.float64), AlinkTypes.DOUBLE, None


class GlmPredictBatchOp(ModelMapBatchOp, HasPredictionCol, HasReservedCols):
    mapper_cls = GlmModelMapper


# ---------------------------------------------------------------------------
# Isotonic regression
# ---------------------------------------------------------------------------

def _pav(x: np.ndarray, y: np.ndarray, w: np.ndarray, increasing: bool = True):
    """Pool-adjacent-violators on (x, y, w) sorted by x. Returns the
    (boundaries, values) step/interp model (reference:
    IsotonicRegTrainBatchOp.java final centralized PAV pass)."""
    order = np.argsort(x, kind="stable")
    xs, ys, ws = x[order], y[order], w[order]
    if not increasing:
        ys = -ys
    # blocks as (value_sum_weighted, weight, x_min, x_max)
    vals: List[float] = []
    wts: List[float] = []
    lo: List[float] = []
    hi: List[float] = []
    for xi, yi, wi in zip(xs, ys, ws):
        vals.append(yi * wi)
        wts.append(wi)
        lo.append(xi)
        hi.append(xi)
        while len(vals) > 1 and vals[-2] / wts[-2] >= vals[-1] / wts[-1]:
            v, wv, h = vals.pop(), wts.pop(), hi.pop()
            lo.pop()
            vals[-1] += v
            wts[-1] += wv
            hi[-1] = h
    fitted = np.asarray([v / wv for v, wv in zip(vals, wts)])
    if not increasing:
        fitted = -fitted
    # boundary per block edge; predict interpolates between block means
    boundaries = np.asarray([0.5 * (a + b) for a, b in zip(lo, hi)])
    return boundaries, fitted


class IsotonicRegTrainBatchOp(ModelTrainOpMixin, BatchOperator):
    """(reference: IsotonicRegTrainBatchOp.java)"""

    FEATURE_COL = ParamInfo("featureCol", str, optional=False,
                            aliases=("selectedCol",))
    LABEL_COL = ParamInfo("labelCol", str, optional=False)
    WEIGHT_COL = ParamInfo("weightCol", str)
    ISOTONIC = ParamInfo("isotonic", bool, default=True)

    _min_inputs = 1
    _max_inputs = 1

    def _static_meta_keys(self, in_schema):
        return {"modelName": "IsotonicRegressionModel"}

    def _execute_impl(self, t: MTable) -> MTable:
        x = np.asarray(t.col(self.get(self.FEATURE_COL)), np.float64)
        y = np.asarray(t.col(self.get(self.LABEL_COL)), np.float64)
        wc = self.get(self.WEIGHT_COL)
        w = (np.asarray(t.col(wc), np.float64) if wc
             else np.ones_like(x))
        boundaries, values = _pav(x, y, w, self.get(self.ISOTONIC))
        meta = {
            "modelName": "IsotonicRegressionModel",
            "featureCol": self.get(self.FEATURE_COL),
            "isotonic": self.get(self.ISOTONIC),
        }
        return model_to_table(meta, {"boundaries": boundaries,
                                     "values": values})


class IsotonicRegModelMapper(RichModelMapper):
    """Linear interpolation between block boundaries (reference:
    common/regression/IsotonicRegressionModelMapper.java)."""

    def load_model(self, model: MTable):
        self.meta, arrays = table_to_model(model)
        self.boundaries = arrays["boundaries"]
        self.values = arrays["values"]
        return self

    def _pred_type(self) -> str:
        return AlinkTypes.DOUBLE

    def predict_block(self, t: MTable):
        params = self.get_params()
        col = (params.get("featureCol") if params.contains("featureCol")
               else self.meta["featureCol"])
        x = np.asarray(t.col(col), np.float64)
        pred = np.interp(x, self.boundaries, self.values)
        return pred, AlinkTypes.DOUBLE, None


class IsotonicRegPredictBatchOp(ModelMapBatchOp, HasPredictionCol,
                                HasReservedCols):
    mapper_cls = IsotonicRegModelMapper


# ---------------------------------------------------------------------------
# AFT survival regression
# ---------------------------------------------------------------------------

class AftSurvivalRegTrainBatchOp(ModelTrainOpMixin, BatchOperator,
                                 HasVectorCol, HasFeatureCols):
    """Weibull accelerated-failure-time model (reference:
    AftSurvivalRegTrainBatchOp.java — censorCol marks observed events)."""

    LABEL_COL = ParamInfo("labelCol", str, optional=False)
    CENSOR_COL = ParamInfo("censorCol", str, optional=False)
    MAX_ITER = ParamInfo("maxIter", int, default=100, validator=MinValidator(1))
    EPSILON = ParamInfo("epsilon", float, default=1e-6)
    L_2 = ParamInfo("l2", float, default=0.0)
    WITH_INTERCEPT = ParamInfo("withIntercept", bool, default=True)

    _min_inputs = 1
    _max_inputs = 1

    def _static_meta_keys(self, in_schema):
        return {"modelName": "AftSurvivalRegModel"}

    def _execute_impl(self, t: MTable) -> MTable:
        label_col = self.get(self.LABEL_COL)
        censor_col = self.get(self.CENSOR_COL)
        vec_col = self.get(HasVectorCol.VECTOR_COL)
        if vec_col:
            feature_cols = None
            X = t.to_numeric_block([vec_col], dtype=np.float32)
        else:
            feature_cols = resolve_feature_cols(
                t, self, exclude=[label_col, censor_col])
            X = t.to_numeric_block(feature_cols, dtype=np.float32)
        n, d_raw = X.shape
        times = np.asarray(t.col(label_col), np.float64)
        if (times <= 0).any():
            raise AkIllegalArgumentException(
                "AFT survival times must be positive")
        y = np.log(times).astype(np.float32)
        censor = np.asarray(t.col(censor_col), np.float32)
        if self.get(self.WITH_INTERCEPT):
            X = np.concatenate([X, np.ones((n, 1), np.float32)], axis=1)
        d = X.shape[1]
        # censor rides as the last feature column (see optim.aft_obj)
        X_aug = np.concatenate([X, censor[:, None]], axis=1)
        obj = aft_obj(d)
        w0 = np.zeros(obj.num_params, np.float32)  # log_sigma starts at 0
        res = optimize(
            obj, X_aug, y, w0=w0, device=self.env.device, method="lbfgs",
            max_iter=self.get(self.MAX_ITER), l2=self.get(self.L_2),
            tol=self.get(self.EPSILON))
        w = res.weights
        intercept = self.get(self.WITH_INTERCEPT)
        meta = {
            "modelName": "AftSurvivalRegModel",
            "vectorCol": vec_col,
            "featureCols": feature_cols,
            "labelCol": label_col,
            "hasIntercept": bool(intercept),
            "dim": int(d_raw),
            "scale": float(np.exp(w[d])),
            "loss": res.loss,
        }
        coef = w[:d_raw]
        b = float(w[d_raw]) if intercept else 0.0
        return model_to_table(meta, {
            "coefficients": np.asarray(coef, np.float32),
            "intercept": np.asarray([b], np.float32)})


class AftSurvivalRegModelMapper(RichModelMapper):
    """Predicts the expected survival time exp(xβ)·Γ(1+σ) (reference:
    common/regression/AftSurvivalRegModelMapper.java quantile/expected
    prediction)."""

    def load_model(self, model: MTable):
        from ...stats.prob import gammaln

        self.meta, arrays = table_to_model(model)
        self.coef = arrays["coefficients"]
        self.intercept = float(arrays["intercept"][0])
        sigma = self.meta["scale"]
        self.mean_factor = float(np.exp(gammaln(1.0 + sigma)))
        return self

    def _pred_type(self) -> str:
        return AlinkTypes.DOUBLE

    def predict_block(self, t: MTable):
        X = get_feature_block(
            t, merge_feature_params(self.get_params(), self.meta),
            vector_size=self.meta["dim"]).astype(np.float32)
        eta = X @ self.coef + self.intercept
        pred = np.exp(eta.astype(np.float64)) * self.mean_factor
        return pred, AlinkTypes.DOUBLE, None


class AftSurvivalRegPredictBatchOp(ModelMapBatchOp, HasPredictionCol,
                                   HasReservedCols):
    mapper_cls = AftSurvivalRegModelMapper


class StepwiseLinearRegTrainBatchOp(ModelTrainOpMixin, BatchOperator,
                                    HasFeatureCols):
    """Forward-stepwise linear regression by AIC (reference:
    operator/common/finance/stepwise + regression Stepwise ops): greedily
    add the feature that lowers AIC most; stop when nothing improves. The
    final model is a standard LinearModel over the selected columns."""

    LABEL_COL = ParamInfo("labelCol", str, optional=False)
    MAX_FEATURES = ParamInfo("maxFeatures", int, default=0,
                             desc="0 = no cap")

    _min_inputs = 1
    _max_inputs = 1

    def _static_meta_keys(self, in_schema):
        return {"modelName": "LinearModel", "linearModelType": "LinearReg",
                "labelType": in_schema.type_of(self.get(self.LABEL_COL))}

    def _execute_impl(self, t: MTable) -> MTable:
        from .linear import LinearRegTrainBatchOp

        label_col = self.get(self.LABEL_COL)
        candidates = list(self.get(HasFeatureCols.FEATURE_COLS) or
                          resolve_feature_cols(t, self, exclude=[label_col]))
        y = np.asarray(t.col(label_col), np.float64)
        n = len(y)
        cap = self.get(self.MAX_FEATURES) or len(candidates)

        def aic(cols):
            X = t.to_numeric_block(cols, dtype=np.float64)
            Xb = np.concatenate([X, np.ones((n, 1))], axis=1)
            beta, *_ = np.linalg.lstsq(Xb, y, rcond=None)
            rss = float(((Xb @ beta - y) ** 2).sum())
            k = len(cols) + 1
            return n * np.log(max(rss / n, 1e-300)) + 2 * k

        selected: list = []
        best_aic = n * np.log(max(float(((y - y.mean()) ** 2).mean()),
                                  1e-300)) + 2
        improved = True
        while improved and len(selected) < cap:
            improved = False
            best_col, best_val = None, best_aic
            for c in candidates:
                if c in selected:
                    continue
                val = aic(selected + [c])
                if val < best_val - 1e-9:
                    best_val, best_col = val, c
            if best_col is not None:
                selected.append(best_col)
                best_aic = best_val
                improved = True
        if not selected:
            selected = [candidates[0]]
        trainer = LinearRegTrainBatchOp(featureCols=selected,
                                        labelCol=label_col)
        model = trainer._execute_impl(t)
        return model
