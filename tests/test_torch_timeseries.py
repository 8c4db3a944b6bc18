"""Parity of the port's timeseries family with the reference on the CPU.

- The fitted ops (ARIMA, AutoArima, HoltWinters, GARCH, AutoGarch) run
  every series and candidate order as lanes of one float64 fit on the
  port's device; the reference fits each in float32. Forecasts and
  parameters agree within 1e-5 relative to the largest forecast (float32's
  rounding carried through 400 Adam steps: 1e-6 to 3e-6 measured),
  AutoArima's and AutoGarch's chosen orders are equal, and the
  unconditional variance, ω, α, β within 1e-4 (the same, relative to the
  parameter).
- A lane of a batched fit equals its one-lane fit within 1e-12: each lane's
  arithmetic is its own but for sums over its time axis, which may
  associate differently with the lane count.
- Shift, Difference, EvalTimeSeries and the three lookups are host code:
  equal.
- Prophet raises ``AkPluginNotExistException`` in both packages.

The nets (DeepAR, LSTNet, TFT) are held in ``test_torch_timeseries_nets.py``.
"""

import numpy as np
import pytest

from torch_table_parity import both, same_table

FIT_RTOL = 1e-5
PARAM_RTOL = 1e-4


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("ALINK_TORCH_DEVICE", "cpu")


@pytest.fixture(scope="module")
def sid():
    from torch_table_parity import reference_session, remove_session

    s = reference_session()
    yield s
    remove_session(s)


def _series(k=3, n=150, seed=0, period=12):
    rng = np.random.default_rng(seed)
    ys = []
    for j in range(k):
        e = rng.normal(size=n)
        y = np.zeros(n)
        for t in range(1, n):
            y[t] = 0.6 * y[t - 1] + e[t] + 0.3 * e[t - 1]
        ys.append(np.cumsum(y) * 0.5 + 10 * j
                  + 3 * np.sin(np.arange(n) * 2 * np.pi / period))
    return ys


def _returns(k=3, n=200, seed=1):
    rng = np.random.default_rng(seed)
    out = []
    for j in range(k):
        h, r = 0.1, []
        for _ in range(n):
            h = 0.05 + (0.2 + 0.1 * j) * (r[-1] ** 2 if r else 0.1) + 0.6 * h
            r.append(rng.normal(0, np.sqrt(h)))
        out.append(np.asarray(r))
    return out


def _cols(ys, grouped):
    v = np.concatenate(ys)
    if not grouped:
        return {"v": ys[0]}
    return {"g": np.repeat(np.asarray([f"s{j}" for j in range(len(ys))],
                                      object), [len(y) for y in ys]),
            "v": v}


def _same_forecasts(got, ref, rtol=FIT_RTOL, param_cols=()):
    assert got.names == ref.names
    for name in ref.names:
        a, b = np.asarray(got.col(name)), np.asarray(ref.col(name))
        if name in ("forecast",):
            for x, y in zip(a, b):
                scale = np.abs(y.data).max()
                np.testing.assert_allclose(x.data, y.data, rtol=0,
                                           atol=rtol * scale)
        elif name in param_cols:
            np.testing.assert_allclose(a.astype(float), b.astype(float),
                                       rtol=PARAM_RTOL)
        else:
            assert list(a) == list(b), name


FORECASTERS = {
    "arima": ("ArimaBatchOp", dict(predictNum=6), _series, ()),
    "arima_200": ("ArimaBatchOp", dict(order=[2, 0, 0], predictNum=4),
                  _series, ()),
    "auto_arima": ("AutoArimaBatchOp", dict(maxP=1, maxQ=1, maxD=1,
                                            predictNum=6), _series, ()),
    "holt_winters_grid": ("HoltWintersBatchOp", dict(frequency=12,
                                                     predictNum=6),
                          _series, ()),
    "holt_winters_fixed": ("HoltWintersBatchOp",
                           dict(frequency=12, alpha=0.3, beta=0.1,
                                gamma=0.2, predictNum=6), _series, ()),
    "holt_winters_trend_only": ("HoltWintersBatchOp",
                                dict(doSeasonal=False, alpha=0.5, beta=0.3,
                                     predictNum=2), _series, ()),
    "garch": ("GarchBatchOp", dict(predictNum=4), _returns,
              ("omega", "alpha", "beta", "unconditionalVariance")),
    "auto_garch": ("AutoGarchBatchOp", dict(maxOrder=1, predictNum=4),
                   _returns, ("aic",)),
}


@pytest.mark.parametrize("grouped", [False, True])
@pytest.mark.parametrize("case", sorted(FORECASTERS))
def test_forecasters_match_reference(sid, case, grouped):
    op, params, data, param_cols = FORECASTERS[case]
    g = dict(groupCol="g") if grouped else {}
    ref, got = both(sid, _cols(data(), grouped), lambda B, e, s: getattr(
        B, op)(valueCol="v", **g, **params, **e).link_from(s))
    _same_forecasts(got, ref, param_cols=param_cols)


def test_batched_lanes_equal_one_lane_fits():
    from alink_tpu_torch.stats.lanefit import (arma_css_fit_lanes,
                                               garch_fit_lanes)

    ws = [np.diff(y) for y in _series(k=3, n=120)]
    orders = [(1, 1), (0, 1), (1, 0)]
    batch = arma_css_fit_lanes(ws, [p for p, _ in orders],
                               [q for _, q in orders], "cpu", steps=60)
    for i, (w, (p, q)) in enumerate(zip(ws, orders)):
        one = arma_css_fit_lanes([w], [p], [q], "cpu", steps=60)
        np.testing.assert_allclose(batch[0][i], one[0][0], rtol=1e-12)
        np.testing.assert_allclose(batch[1][i, :p], one[1][0, :p],
                                   rtol=1e-12)
        np.testing.assert_allclose(batch[2][i, :q], one[2][0, :q],
                                   rtol=1e-12)
        np.testing.assert_allclose(batch[3][i], one[3][0], rtol=1e-12)
    rs = _returns(k=2, n=150)
    kw = dict(steps=40, alpha_scale=[0.5, 0.25], beta_scale=[1.0, 0.5],
              start=[1, 2])
    pb, lb, _ = garch_fit_lanes(rs, [1, 2], [1, 2], "cpu", **kw)
    for i in range(2):
        one = garch_fit_lanes([rs[i]], [i + 1], [i + 1], "cpu",
                              **{k: [v[i]] if isinstance(v, list) else v
                                 for k, v in kw.items()})
        np.testing.assert_allclose(pb[i, :1], one[0][0, :1], rtol=1e-12)
        np.testing.assert_allclose(lb[i], one[1][0], rtol=1e-12)


def test_linear_recurrence_is_the_sequential_recursion():
    import torch

    from alink_tpu_torch.stats.lanefit import linear_recurrence

    rng = np.random.default_rng(3)
    u = rng.normal(size=(4, 37))
    c = rng.uniform(-0.4, 0.4, size=(4, 3))
    want = np.zeros_like(u)
    for t in range(37):
        want[:, t] = u[:, t] + sum(c[:, j] * want[:, t - 1 - j]
                                   for j in range(3) if t - 1 - j >= 0)
    got = linear_recurrence(torch.as_tensor(u), torch.as_tensor(c)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("build", [
    lambda B, e, s: B.ShiftBatchOp(selectedCol="v", shiftNum=2,
                                   **e).link_from(s),
    lambda B, e, s: B.ShiftBatchOp(selectedCol="v", shiftNum=-3,
                                   outputCol="o", **e).link_from(s),
    lambda B, e, s: B.DifferenceBatchOp(selectedCol="v", differenceOrder=2,
                                        **e).link_from(s),
])
def test_shift_and_difference_exact(sid, build):
    ref, got = both(sid, {"v": np.asarray([1.0, 3.0, 6.0, 10.0, 15.0])},
                    build)
    same_table(got, ref, rtol=0)


def test_eval_timeseries_exact(sid):
    cols = {"y": np.asarray([1.0, 2.0, 3.0, np.nan, 0.0]),
            "p": np.asarray([1.1, 1.9, 3.2, 4.0, 0.1])}
    ref, got = both(sid, cols, lambda B, e, s: B.EvalTimeSeriesBatchOp(
        labelCol="y", predictionCol="p", **e).link_from(s))
    same_table(got, ref, rtol=0)


def _series_cells(T, AT, TS):
    day = 86400.0
    series = T({"ts": np.asarray([0.0, day, 2 * day, 3 * day]),
                "val": np.asarray([1.0, 2.0, 3.0, 4.0])})
    vec_series = T({"ts": np.asarray([0.0, day]),
                    "vec": np.asarray(["1 0", "0 1"], object)},
                   TS(["ts", "vec"], [AT.DOUBLE, AT.DENSE_VECTOR]))
    when = np.asarray([2.5 * day, 0.5 * day, -1.0])
    return T({"s": np.asarray([series, series, None], object),
              "sv": np.asarray([vec_series, vec_series, vec_series], object),
              "when": when},
             TS(["s", "sv", "when"], [AT.MTABLE, AT.MTABLE, AT.DOUBLE]))


@pytest.mark.parametrize("op,params", [
    ("LookupValueInTimeSeriesBatchOp", dict(selectedCol="s")),
    ("LookupVectorInTimeSeriesBatchOp", dict(selectedCol="sv")),
    ("LookupRecentDaysBatchOp", dict(selectedCol="s", numDays=2)),
])
def test_lookups_exact(sid, op, params):
    import alink_tpu.common.mtable as RM
    import alink_tpu.operator.batch as R
    import alink_tpu_torch.common.mtable as PM
    import alink_tpu_torch.operator.batch as P

    outs = []
    for B, M, extra in ((R, RM, dict(MLEnvironmentId=sid)), (P, PM, {})):
        t = _series_cells(M.MTable, M.AlinkTypes, M.TableSchema)
        out = getattr(B, op)(timeCol="when", outputCol="o", **params,
                             **extra).link_from(
            B.TableSourceBatchOp(t)).collect()
        outs.append([None if v is None else list(v.data)
                     if type(v).__name__ == "DenseVector" else float(v)
                     for v in out.col("o")])
    assert str(outs[1]) == str(outs[0])


def test_lookup_recent_days_two_inputs(sid):
    model = {"k": np.asarray(["a", "b"], object),
             "f": np.asarray([1.5, 2.5])}
    data = {"k": np.asarray(["b", "c", "a"], object)}
    ref, got = both(sid, model, lambda B, e, m, d: B.LookupRecentDaysBatchOp(
        timeCol="k", **e).link_from(m, d), data)
    same_table(got, ref, rtol=0)


@pytest.mark.parametrize("op", ["ProphetBatchOp", "ProphetTrainBatchOp"])
def test_prophet_raises_plugin_exception_in_both(sid, op):
    import alink_tpu.operator.batch as R
    import alink_tpu_torch.operator.batch as P
    from alink_tpu.common.exceptions import AkPluginNotExistException as RE
    from alink_tpu.common.mtable import MTable as RT
    from alink_tpu_torch.common.exceptions import \
        AkPluginNotExistException as PE
    from alink_tpu_torch.common.mtable import MTable as PT

    y = np.arange(30, dtype=float)
    for B, T, E, extra in ((R, RT, RE, dict(MLEnvironmentId=sid)),
                           (P, PT, PE, {})):
        with pytest.raises(E, match="prophet"):
            getattr(B, op)(valueCol="y", **extra).link_from(
                B.TableSourceBatchOp(T({"y": y}))).collect()
