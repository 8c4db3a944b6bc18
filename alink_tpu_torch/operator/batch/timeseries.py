"""Timeseries family: ARIMA, HoltWinters, GARCH, shift/difference, eval
(port of ``alink_tpu.operator.batch.timeseries``).

Capability parity with the reference timeseries package (reference:
core/src/main/java/com/alibaba/alink/operator/batch/timeseries/
ArimaBatchOp.java + common/timeseries/arima/ (CSS fitting in
ArimaEstimate.java), HoltWintersBatchOp.java + common/timeseries/holtwinters/,
GarchBatchOp.java + common/timeseries/garch/, ShiftBatchOp.java,
DifferenceBatchOp.java, operator/batch/evaluation/EvalTimeSeriesBatchOp.java).

The grouped frame keeps groups in order of first appearance and forecasts
before the extras. The fitted ops run every group's fit, and AutoArima every
candidate order of every group, as lanes of one batched fit on the session's
device (:mod:`alink_tpu_torch.stats.lanefit`: optax's Adam on a log-depth
scan of each linear recurrence; Holt-Winters' 1,000-point grid as 1,000
lanes a series), in float64 where the reference runs float32. The forecast
recursions after the fit are the reference's host loops. DeepAR, LSTNet and
TFT train one net a series through the port's ``dl.train.train_model``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ...common.exceptions import (AkIllegalArgumentException,
                                  AkIllegalDataException)
from ...common.linalg import DenseVector
from ...common.mtable import AlinkTypes, MTable, TableSchema
from ...common.params import MinValidator, ParamInfo
from ...mapper import HasSelectedCol
from .base import BatchOperator


def _groups_in_order(groups: np.ndarray) -> Tuple[List, List[np.ndarray]]:
    """(group keys in order of first appearance, each group's row indices
    in row order)."""
    idx_of: Dict = {}
    codes = np.empty(len(groups), np.int64)
    for i, g in enumerate(groups):
        c = idx_of.get(g)
        if c is None:
            c = idx_of[g] = len(idx_of)
        codes[i] = c
    order = np.argsort(codes, kind="stable")
    cuts = np.cumsum(np.bincount(codes, minlength=len(idx_of)))[:-1]
    return list(idx_of), np.split(order, cuts)


class _BaseForecastOp(BatchOperator):
    """Shared frame: group rows by groupCol (ordered by appearance), forecast
    ``predictNum`` steps per series, emit (group?, forecast vector)."""

    VALUE_COL = ParamInfo("valueCol", str, optional=False,
                          aliases=("selectedCol",))
    GROUP_COL = ParamInfo("groupCol", str)
    PREDICT_NUM = ParamInfo("predictNum", int, default=12,
                            validator=MinValidator(1))
    PREDICTION_COL = ParamInfo("predictionCol", str, default="forecast")

    _min_inputs = 1
    _max_inputs = 1

    def _forecast(self, y: np.ndarray, horizon: int) -> np.ndarray:
        raise NotImplementedError

    def _extra_outputs(self, y: np.ndarray) -> Dict[str, float]:
        return {}

    def _forecast_series(self, ys: List[np.ndarray], horizon: int
                         ) -> Tuple[List[np.ndarray], List[Dict]]:
        """Forecasts and extras of every series. One series at a time here;
        the batched fits override it with one fit of all lanes."""
        fcs, extras = [], []
        for y in ys:
            fcs.append(self._forecast(y, horizon))
            extras.append(self._extra_outputs(y))
        return fcs, extras

    def _execute_impl(self, t: MTable) -> MTable:
        value_col = self.get(self.VALUE_COL)
        group_col = self.get(self.GROUP_COL)
        horizon = int(self.get(self.PREDICT_NUM))
        pred_col = self.get(self.PREDICTION_COL)
        vals = np.asarray(t.col(value_col), np.float64)
        if group_col:
            order, rows = _groups_in_order(
                np.asarray(t.col(group_col), object))
            fcs, extras = self._forecast_series([vals[r] for r in rows],
                                                horizon)
            out_groups = order
        else:
            out_groups = None
            fcs, extras = self._forecast_series([vals], horizon)
        out_vecs = [DenseVector(np.asarray(f, np.float64)) for f in fcs]
        cols: Dict = {}
        names, types = [], []
        if out_groups is not None:
            cols[group_col] = np.asarray(out_groups, object)
            names.append(group_col)
            types.append(AlinkTypes.STRING)
        cols[pred_col] = np.asarray(out_vecs, object)
        names.append(pred_col)
        types.append(AlinkTypes.DENSE_VECTOR)
        for key in (extras[0] or {}):
            cols[key] = np.asarray([e[key] for e in extras], np.float64)
            names.append(key)
            types.append(AlinkTypes.DOUBLE)
        return MTable(cols, TableSchema(names, types))

    def _out_schema(self, in_schema: TableSchema) -> TableSchema:
        group_col = self.get(self.GROUP_COL)
        pred_col = self.get(self.PREDICTION_COL)
        names, types = [], []
        if group_col:
            names.append(group_col)
            types.append(AlinkTypes.STRING)
        names.append(pred_col)
        types.append(AlinkTypes.DENSE_VECTOR)
        for key in self._extra_schema_keys():
            names.append(key)
            types.append(AlinkTypes.DOUBLE)
        return TableSchema(names, types)

    def _extra_schema_keys(self) -> List[str]:
        return []


# ---------------------------------------------------------------------------
# ARIMA
# ---------------------------------------------------------------------------


def _diffed(y: np.ndarray, d: int) -> np.ndarray:
    return np.diff(y, n=d) if d else y.astype(np.float64)


def _arima_forecast_from(y: np.ndarray, p: int, d: int, q: int, c: float,
                         phi: np.ndarray, theta: np.ndarray,
                         horizon: int) -> np.ndarray:
    """The reference's ``_arima_forecast`` after its fit: re-run the
    residual recursion on the host from the zero-seeded histories, iterate
    forward, and integrate back up through each difference level."""
    w = _diffed(y, d)
    phi, theta = list(phi[:p]), list(theta[:q])
    m = max(p, q)
    e_hist = [0.0] * max(q, 1)
    w_hist = [0.0] * max(p, 1)
    for t in range(m, len(w)):
        pred = c + sum(ph * wh for ph, wh in zip(phi, w_hist)) \
            + sum(th * eh for th, eh in zip(theta, e_hist))
        e = w[t] - pred
        w_hist = [w[t]] + w_hist[:-1]
        e_hist = [e] + e_hist[:-1]
    fc_w = []
    for _ in range(horizon):
        pred = c + sum(ph * wh for ph, wh in zip(phi, w_hist)) \
            + sum(th * eh for th, eh in zip(theta, e_hist))
        fc_w.append(pred)
        w_hist = [pred] + w_hist[:-1]
        e_hist = [0.0] + e_hist[:-1]
    levels = [np.asarray(y, np.float64)]
    for _ in range(d):
        levels.append(np.diff(levels[-1]))
    fc = np.asarray(fc_w, np.float64)
    for k in range(d, 0, -1):
        fc = np.cumsum(fc) + levels[k - 1][-1]
    return fc


def _arima_lanes(op, lanes: Sequence[Tuple[np.ndarray, int, int, int]]):
    """One CSS fit of every (y, p, d, q) lane on the op's device: returns
    (c, phi, theta, sigma2) per lane."""
    from ...stats.lanefit import arma_css_fit_lanes

    return arma_css_fit_lanes([_diffed(y, d) for y, p, d, q in lanes],
                              [p for _, p, _, _ in lanes],
                              [q for _, _, _, q in lanes], op.env.device)


class ArimaBatchOp(_BaseForecastOp):
    """(reference: ArimaBatchOp.java — order (p,d,q), CSS estimation)"""

    ORDER = ParamInfo("order", list, default=[1, 1, 1])

    def _fit_params(self):
        order = self.get(self.ORDER)
        if len(order) != 3:
            raise AkIllegalArgumentException("ARIMA order must be [p, d, q]")
        return int(order[0]), int(order[1]), int(order[2])

    def _forecast_series(self, ys, horizon):
        p, d, q = self._fit_params()
        c, phi, theta, _ = _arima_lanes(self, [(y, p, d, q) for y in ys])
        return ([_arima_forecast_from(y, p, d, q, c[i], phi[i], theta[i],
                                      horizon) for i, y in enumerate(ys)],
                [{} for _ in ys])


class AutoArimaBatchOp(_BaseForecastOp):
    """Order search over (p, d, q) by AIC on the CSS fit (reference:
    AutoArimaBatchOp.java — its ICQ grid evaluation; AIC = n*log(sigma2) +
    2*(p+q+1)). Every candidate of every series is a lane of one fit. The
    chosen order is emitted in p/d/q columns."""

    MAX_P = ParamInfo("maxP", int, default=3, aliases=("maxOrder",))
    MAX_D = ParamInfo("maxD", int, default=2)
    MAX_Q = ParamInfo("maxQ", int, default=3)

    def _candidates(self, y: np.ndarray) -> List[Tuple[int, int, int]]:
        out = []
        for d in range(int(self.get(self.MAX_D)) + 1):
            if len(_diffed(y, d)) < 8:
                continue
            for p_ in range(int(self.get(self.MAX_P)) + 1):
                for q_ in range(int(self.get(self.MAX_Q)) + 1):
                    if p_ == 0 and q_ == 0 and d == 0:
                        continue
                    out.append((p_, d, q_))
        return out

    def _forecast_series(self, ys, horizon):
        cands = [self._candidates(y) for y in ys]
        lanes = [(y, p, d, q) for y, cs in zip(ys, cands)
                 for p, d, q in cs]
        if lanes:
            c, phi, theta, sigma2 = _arima_lanes(self, lanes)
        fcs, extras, k = [], [], 0
        for y, cs in zip(ys, cands):
            best = None
            for j, (p_, d, q_) in enumerate(cs):
                s2 = sigma2[k + j]
                if not np.isfinite(s2) or s2 <= 0:
                    continue
                aic = len(_diffed(y, d)) * np.log(s2) + 2 * (p_ + q_ + 1)
                if best is None or aic < best[0]:
                    best = (aic, p_, d, q_, k + j)
            k += len(cs)
            if best is None:
                raise AkIllegalDataException(
                    "series too short for AutoArima order search")
            _, p_, d, q_, i = best
            fcs.append(_arima_forecast_from(y, p_, d, q_, c[i], phi[i],
                                            theta[i], horizon))
            extras.append({"p": float(p_), "d": float(d), "q": float(q_)})
        return fcs, extras

    def _extra_schema_keys(self) -> List[str]:
        return ["p", "d", "q"]


# ---------------------------------------------------------------------------
# Holt-Winters
# ---------------------------------------------------------------------------


class HoltWintersBatchOp(_BaseForecastOp):
    """Triple exponential smoothing, additive trend/seasonality (reference:
    HoltWintersBatchOp.java + holtwinters/HoltWintersUtil.java). When alpha/
    beta/gamma are unset, the whole 10 × 10 × 10 grid is evaluated, every
    grid point of every series a lane, and the SSE-minimizing triple wins."""

    FREQUENCY = ParamInfo("frequency", int, default=4, validator=MinValidator(1))
    ALPHA = ParamInfo("alpha", float)
    BETA = ParamInfo("beta", float)
    GAMMA = ParamInfo("gamma", float)
    DO_TREND = ParamInfo("doTrend", bool, default=True)
    DO_SEASONAL = ParamInfo("doSeasonal", bool, default=True)

    def _candidates(self) -> np.ndarray:
        alpha = self.get(self.ALPHA)
        if alpha is not None:
            beta_p, gamma_p = self.get(self.BETA), self.get(self.GAMMA)
            b = 0.1 if beta_p is None else float(beta_p)
            g = 0.1 if gamma_p is None else float(gamma_p)
            return np.asarray([[float(alpha), b, g]], np.float32)
        grid = np.linspace(0.05, 0.95, 10, dtype=np.float32)
        return np.stack(np.meshgrid(grid, grid, grid), axis=-1).reshape(-1, 3)

    def _forecast_series(self, ys, horizon):
        from ...stats.lanefit import holt_winters_lanes

        freq = int(self.get(self.FREQUENCY))
        do_trend = self.get(self.DO_TREND)
        cand = self._candidates().astype(np.float64)
        C = len(cand)
        fcs: List[Optional[np.ndarray]] = [None] * len(ys)
        # series of one length (and so one seasonal switch) share a batch
        by_len: Dict[int, List[int]] = {}
        for i, y in enumerate(ys):
            by_len.setdefault(len(y), []).append(i)
        for n, idx in by_len.items():
            do_seasonal = self.get(self.DO_SEASONAL) and n >= 2 * freq
            Y = np.stack([ys[i] for i in idx]).astype(np.float64)
            if do_seasonal:
                head = Y[:, :freq]
                season0 = head - head.mean(1, keepdims=True)
                level0 = head.mean(1)
                trend0 = (Y[:, freq:2 * freq].mean(1) - head.mean(1)) / freq
            else:
                season0 = np.zeros((len(idx), max(freq, 1)))
                level0 = Y[:, 0].copy()
                trend0 = np.zeros(len(idx))
            rep = lambda a: np.repeat(a, C, axis=0)  # noqa: E731
            sse, level, trend, season = holt_winters_lanes(
                rep(Y), np.tile(cand, (len(idx), 1)), rep(level0),
                rep(trend0), rep(season0), do_trend, do_seasonal,
                self.env.device)
            best = sse.reshape(len(idx), C).argmin(1)
            for j, i in enumerate(idx):
                lane = j * C + best[j]
                fc = []
                for h in range(1, horizon + 1):
                    s = season[lane, (h - 1) % freq] if do_seasonal else 0.0
                    fc.append(level[lane] + h * trend[lane] + s)
                fcs[i] = np.asarray(fc, np.float64)
        return fcs, [{} for _ in ys]


# ---------------------------------------------------------------------------
# GARCH
# ---------------------------------------------------------------------------


class GarchBatchOp(_BaseForecastOp):
    """GARCH(1,1) conditional-variance model; forecasts volatility
    (reference: GarchBatchOp.java + garch/GarchEstimate.java). Every
    series is a lane of one fit."""

    def _extra_schema_keys(self):
        return ["omega", "alpha", "beta", "unconditionalVariance"]

    def _forecast_series(self, ys, horizon):
        from ...stats.lanefit import garch_fit_lanes

        rs = [y - y.mean() for y in ys]
        k = len(rs)
        params, _, var0 = garch_fit_lanes(
            rs, [1] * k, [1] * k, self.env.device, steps=400,
            alpha_scale=[0.5] * k, beta_scale=[1.0] * k, start=[1] * k,
            seed_r2=False)
        fcs, extras = [], []
        for i, r in enumerate(rs):
            p = params[i]
            omega = float(np.log1p(np.exp(p[0])) * var0[i] * 0.1)
            alpha = float(1 / (1 + np.exp(-p[1])) * 0.5)
            beta = float(1 / (1 + np.exp(-p[2])))
            h = var0[i]
            for t in range(1, len(r)):
                h = omega + alpha * r[t - 1] ** 2 + beta * h
            fc = []
            h_next = omega + alpha * r[-1] ** 2 + beta * h
            for _ in range(horizon):
                fc.append(h_next)
                h_next = omega + (alpha + beta) * h_next
            fcs.append(np.sqrt(np.asarray(fc, np.float64)))
            denom = max(1.0 - alpha - beta, 1e-6)
            extras.append({"omega": omega, "alpha": alpha, "beta": beta,
                           "unconditionalVariance": omega / denom})
        return fcs, extras


# ---------------------------------------------------------------------------
# Shift / difference
# ---------------------------------------------------------------------------

class ShiftBatchOp(BatchOperator, HasSelectedCol):
    """Appends the series shifted by shiftNum (reference: ShiftBatchOp.java)."""

    SHIFT_NUM = ParamInfo("shiftNum", int, default=1)
    OUTPUT_COL = ParamInfo("outputCol", str, default="shifted")

    _min_inputs = 1
    _max_inputs = 1

    def _execute_impl(self, t: MTable) -> MTable:
        col = self.get(HasSelectedCol.SELECTED_COL)
        k = int(self.get(self.SHIFT_NUM))
        out = self.get(self.OUTPUT_COL)
        arr = np.asarray(t.col(col), np.float64)
        shifted = np.full_like(arr, np.nan)
        if k >= 0:
            k = min(k, len(arr))
            shifted[k:] = arr[:len(arr) - k]
        else:
            k = max(k, -len(arr))
            shifted[:len(arr) + k] = arr[-k:]
        return t.with_column(out, shifted, AlinkTypes.DOUBLE)

    def _out_schema(self, in_schema):
        out = self.get(self.OUTPUT_COL)
        return TableSchema(list(in_schema.names) + [out],
                           list(in_schema.types) + [AlinkTypes.DOUBLE])


class DifferenceBatchOp(BatchOperator, HasSelectedCol):
    """Appends the differenced series (reference: DifferenceBatchOp.java)."""

    DIFFERENCE_ORDER = ParamInfo("differenceOrder", int, default=1,
                                 validator=MinValidator(1))
    OUTPUT_COL = ParamInfo("outputCol", str, default="diff")

    _min_inputs = 1
    _max_inputs = 1

    def _execute_impl(self, t: MTable) -> MTable:
        col = self.get(HasSelectedCol.SELECTED_COL)
        d = int(self.get(self.DIFFERENCE_ORDER))
        out = self.get(self.OUTPUT_COL)
        arr = np.asarray(t.col(col), np.float64)
        diffed = arr.copy()
        for _ in range(d):
            diffed = np.concatenate([[np.nan], np.diff(diffed)])
        return t.with_column(out, diffed, AlinkTypes.DOUBLE)

    def _out_schema(self, in_schema):
        out = self.get(self.OUTPUT_COL)
        return TableSchema(list(in_schema.names) + [out],
                           list(in_schema.types) + [AlinkTypes.DOUBLE])


# ---------------------------------------------------------------------------
# Timeseries evaluation
# ---------------------------------------------------------------------------

_TS_METRIC_SCHEMA = TableSchema(
    ["mse", "rmse", "mae", "mape", "smape", "r2"],
    [AlinkTypes.DOUBLE] * 6)


class EvalTimeSeriesBatchOp(BatchOperator):
    """Forecast-accuracy metrics (reference: EvalTimeSeriesBatchOp.java +
    common/evaluation/TimeSeriesMetrics.java)."""

    LABEL_COL = ParamInfo("labelCol", str, optional=False)
    PREDICTION_COL = ParamInfo("predictionCol", str, optional=False)

    _min_inputs = 1
    _max_inputs = 1

    def _execute_impl(self, t: MTable) -> MTable:
        y = np.asarray(t.col(self.get(self.LABEL_COL)), np.float64)
        p = np.asarray(t.col(self.get(self.PREDICTION_COL)), np.float64)
        ok = ~(np.isnan(y) | np.isnan(p))
        y, p = y[ok], p[ok]
        err = p - y
        mse = float((err ** 2).mean())
        mae = float(np.abs(err).mean())
        denom = np.where(np.abs(y) < 1e-12, 1e-12, np.abs(y))
        mape = float((np.abs(err) / denom).mean())
        sdenom = (np.abs(y) + np.abs(p)) / 2.0
        sdenom = np.where(sdenom < 1e-12, 1e-12, sdenom)
        smape = float((np.abs(err) / sdenom).mean())
        ss_tot = float(((y - y.mean()) ** 2).sum())
        r2 = 1.0 - float((err ** 2).sum()) / max(ss_tot, 1e-12)
        self._metrics = {"mse": mse, "rmse": float(np.sqrt(mse)), "mae": mae,
                         "mape": mape, "smape": smape, "r2": r2}
        return MTable({k: [v] for k, v in self._metrics.items()},
                      _TS_METRIC_SCHEMA)

    def _out_schema(self, in_schema):
        return _TS_METRIC_SCHEMA

    def collect_metrics(self) -> dict:
        self.collect()
        return self._metrics


# ---------------------------------------------------------------------------
# nets: one model a series, on the session's device
# ---------------------------------------------------------------------------


class DeepARBatchOp(_BaseForecastOp):
    """Probabilistic LSTM forecaster with Gaussian output head (reference:
    akdl deepar model via DLLauncher — operator/batch/timeseries/
    DeepARTrainBatchOp + core/src/main/resources/entries/deepar_entry.py).

    Rides the shared DL train loop: sliding lookback windows train an LSTM
    whose head emits (mu, log_sigma) under Gaussian NLL; forecasting rolls
    the window forward on the predicted mean. ``predictionCol`` holds the
    mean path; sigma of the one-step-ahead distribution lands in the
    ``sigma`` column."""

    LOOKBACK = ParamInfo("lookback", int, default=24, validator=MinValidator(2))
    HIDDEN = ParamInfo("hiddenSize", int, default=32)
    NUM_EPOCHS = ParamInfo("numEpochs", int, default=40)
    BATCH_SIZE = ParamInfo("batchSize", int, default=64)
    LEARNING_RATE = ParamInfo("learningRate", float, default=5e-3)
    RANDOM_SEED = ParamInfo("randomSeed", int, default=0, aliases=("seed",))

    def _extra_schema_keys(self):
        return ["sigma"]

    def _fit_forecast(self, y: np.ndarray, horizon: int):
        from .timeseries2 import deepar_train, net_forecast

        dev = self.env.device
        model = deepar_train(
            y, lookback=self.get(self.LOOKBACK),
            hidden=self.get(self.HIDDEN),
            num_epochs=self.get(self.NUM_EPOCHS),
            batch_size=self.get(self.BATCH_SIZE),
            learning_rate=self.get(self.LEARNING_RATE),
            seed=self.get(self.RANDOM_SEED), device=dev)
        return net_forecast(model, y, horizon, device=dev)

    def _forecast(self, y: np.ndarray, horizon: int) -> np.ndarray:
        # the frame calls _forecast then _extra_outputs for each series:
        # stash sigma from this fit so the extra column reuses it
        means, sigma = self._fit_forecast(y, horizon)
        self._last_sigma = sigma
        return means

    def _extra_outputs(self, y: np.ndarray):
        return {"sigma": self._last_sigma}


class LSTNetBatchOp(_BaseForecastOp):
    """LSTNet forecaster: Conv feature extraction + GRU + skip-GRU + an
    autoregressive highway component (reference: akdl lstnet model via
    DLLauncher — core/src/main/python/akdl/akdl/models/tf/lstnet/ +
    resources/entries/lstnet_entry.py).

    Rides the shared DL train loop like DeepAR. The head is trained
    direct-multi-horizon (the LSTNet-paper contract): one forward pass
    emits the whole ``predictNum`` path, instead of compounding one-step
    recursion error across the horizon."""

    LOOKBACK = ParamInfo("lookback", int, default=24,
                         validator=MinValidator(4))
    HIDDEN = ParamInfo("hiddenSize", int, default=32)
    KERNEL_SIZE = ParamInfo("kernelSize", int, default=3)
    SKIP = ParamInfo("skip", int, default=4)
    AR_WINDOW = ParamInfo("arWindow", int, default=8)
    NUM_EPOCHS = ParamInfo("numEpochs", int, default=40)
    BATCH_SIZE = ParamInfo("batchSize", int, default=64)
    LEARNING_RATE = ParamInfo("learningRate", float, default=5e-3)
    RANDOM_SEED = ParamInfo("randomSeed", int, default=0, aliases=("seed",))

    def _forecast(self, y: np.ndarray, horizon: int) -> np.ndarray:
        from .timeseries2 import lstnet_train, net_forecast

        dev = self.env.device
        model = lstnet_train(
            y, lookback=self.get(self.LOOKBACK),
            hidden=self.get(self.HIDDEN),
            kernel=self.get(self.KERNEL_SIZE), skip=self.get(self.SKIP),
            ar_window=self.get(self.AR_WINDOW),
            num_epochs=self.get(self.NUM_EPOCHS),
            batch_size=self.get(self.BATCH_SIZE),
            learning_rate=self.get(self.LEARNING_RATE),
            seed=self.get(self.RANDOM_SEED),
            horizon=horizon, device=dev)  # direct multi-horizon head
        means, _ = net_forecast(model, y, horizon, device=dev)
        return means


class ProphetBatchOp(_BaseForecastOp):
    """Prophet forecaster, plugin-gated on the ``prophet`` package
    (reference: operator/common/timeseries/ProphetMapper.java). The port
    carries no Prophet: it raises the reference's missing-plugin guidance,
    naming ``prophet``."""

    FREQ = ParamInfo("freq", str, default="D",
                     desc="pandas offset alias for the synthetic fit index "
                          "(the series is modeled positionally)")

    def _forecast(self, y: np.ndarray, horizon: int) -> np.ndarray:
        from ...common.exceptions import AkPluginNotExistException

        raise AkPluginNotExistException(
            "ProphetBatchOp needs the 'prophet' package (the reference "
            "runs it as a python subprocess plugin): pip install "
            "prophet. Built-in alternatives: HoltWintersBatchOp, "
            "AutoArimaBatchOp, DeepARBatchOp, LSTNetBatchOp.")


class TFTBatchOp(_BaseForecastOp):
    """Attention-based forecaster in the Temporal-Fusion-Transformer family
    (reference: akdl tft model — core/src/main/python/akdl/akdl/models/tf/
    tft/; this is the single-series core of that design: LSTM encoding +
    multi-head self-attention over the lookback + gated residual head,
    without the multi-covariate variable-selection networks the reference
    wires for exogenous inputs)."""

    LOOKBACK = ParamInfo("lookback", int, default=24,
                         validator=MinValidator(4))
    HIDDEN = ParamInfo("hiddenSize", int, default=32)
    NUM_HEADS = ParamInfo("numHeads", int, default=4)
    NUM_EPOCHS = ParamInfo("numEpochs", int, default=60)
    BATCH_SIZE = ParamInfo("batchSize", int, default=64)
    LEARNING_RATE = ParamInfo("learningRate", float, default=5e-3)
    RANDOM_SEED = ParamInfo("randomSeed", int, default=0, aliases=("seed",))

    _init_params = None      # tests: the reference's initial tree, carried

    def _forecast(self, y: np.ndarray, horizon: int) -> np.ndarray:
        from ...dl.train import TrainConfig, train_model
        from .timeseries2 import TFTNet, roll_forecast

        if len(y) < 12:
            raise AkIllegalArgumentException(
                f"TFT needs at least 12 observations, got {len(y)}")
        L = min(self.get(self.LOOKBACK), max(len(y) - 1, 4))
        mu_y, sd_y = float(np.mean(y)), float(np.std(y) + 1e-9)
        z32 = ((np.asarray(y, np.float64) - mu_y) / sd_y).astype(np.float32)
        X = np.stack([z32[s:s + L] for s in range(len(z32) - L)])[..., None]
        t = z32[L:]

        hidden = self.get(self.HIDDEN)
        heads = max(1, min(self.get(self.NUM_HEADS), hidden))
        while hidden % heads:  # the attention needs heads | qkv dims
            heads -= 1
        cfg = TrainConfig(num_epochs=self.get(self.NUM_EPOCHS),
                          batch_size=self.get(self.BATCH_SIZE),
                          learning_rate=self.get(self.LEARNING_RATE),
                          loss="mse", seed=self.get(self.RANDOM_SEED))
        dev = self.env.device
        net = TFTNet(hidden, heads)
        train_model(net, {"x": X}, t, cfg, regression=True,
                    init_params=self._init_params, device=dev)
        preds = roll_forecast(net, z32[-L:], horizon, dev)
        return np.asarray(preds, np.float64) * sd_y + mu_y
