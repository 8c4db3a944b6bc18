"""Parity of the port's outlier family (``outlier/`` and
``operator/batch/outlier.py``) with ``alink_tpu`` on the CPU: the cases of
``tests/test_outlier.py`` (without the two stream-twin tests) and the
grouped variants of ``tests/test_longtail.py``, through both packages on
the same seeded tables.

Tolerances:
- The host detectors (k-sigma, box plot, MAD, ESD, S-H-ESD, HBOS, ECOD,
  COPOD, isolation forest, Cook's distance, DTW) are copies: flags and
  detail JSON equal.
- The pairwise detectors (KDE, LOF, SOS, DBSCAN) take float64-summed
  distances rounded to float32 where the reference sums in float32: flags
  equal, scores within PAIR_RTOL = 1e-4 relative.
- OCSVM: its first Adam step at the hinge tie within 1e-6, ten steps
  within 1e-4 (Adam's normalized steps grow rounding noise on small
  gradients toward the learning rate); after its 400
  steps, scores within OCSVM_ATOL = 1e-3 and flags equal except where the
  score is within OCSVM_ATOL of the threshold."""

import json

import numpy as np
import pytest

from torch_table_parity import both, reference_session, remove_session, \
    same_table

PAIR_RTOL = 1e-4
OCSVM_ATOL = 1e-3


@pytest.fixture(scope="module")
def sid():
    s = reference_session()
    yield s
    remove_session(s)


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("ALINK_TORCH_DEVICE", "cpu")


def _series_with_spikes(n=200, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(n)
    x[[20, 90, 150]] = [12.0, -11.0, 14.0]
    return x


def _blob(n=150, seed=1):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 3)
    X[[5, 60, 120]] += 10.0
    return {f"f{i}": X[:, i] for i in range(3)}


def scores_of(t, col="d"):
    return np.asarray([np.nan if (v := json.loads(d)["outlier_score"]) is None
                       else v for d in t.col(col)], np.float64)


def same_outliers(port, ref, rtol=0.0, atol=0.0, flag="o", detail="d"):
    """Flags equal (except where the two scores straddle within ``atol``
    of each other and of the flag's threshold — only with ``atol``), the
    detail scores within ``rtol``/``atol``, other columns equal."""
    rest = [c for c in ref.names if c not in (flag, detail)]
    same_table(port.select(rest), ref.select(rest))
    if detail in ref.names:
        np.testing.assert_allclose(scores_of(port, detail),
                                   scores_of(ref, detail), rtol=rtol,
                                   atol=atol)
    p, r = np.asarray(port.col(flag)), np.asarray(ref.col(flag))
    if atol == 0.0:
        np.testing.assert_array_equal(p, r)
    else:
        s = scores_of(ref, detail)
        assert (np.abs(s[p != r]) <= atol).all()


@pytest.mark.parametrize("op,kw", [
    ("KSigmaOutlierBatchOp", {}), ("BoxPlotOutlierBatchOp", {}),
    ("MadOutlierBatchOp", {}), ("EsdOutlierBatchOp", {}),
    ("EsdOutlierBatchOp", {"maxOutlierNum": 5, "alpha": 0.01}),
    ("ShEsdOutlierBatchOp", {"frequency": 24}),
    ("SHEsdOutlierBatchOp", {"frequency": 24}),
    ("DynamicTimeWarpOutlierBatchOp", {"seriesLength": 10}),
])
def test_univariate_detectors(sid, op, kw):
    x = _series_with_spikes()
    x[100:110] += 4.0
    ref, port = both(sid, {"v": x}, lambda ops, extra, src: getattr(ops, op)(
        selectedCol="v", predictionCol="o", predictionDetailCol="d", **kw,
        **extra).link_from(src))
    same_outliers(port, ref)
    assert np.asarray(port.col("o"))[20] or op.startswith("Dynamic")


def test_esd_with_nans_and_ecod_left_tail():
    from alink_tpu.outlier import ecod as r_ecod, esd as r_esd
    from alink_tpu_torch.outlier import ecod, esd

    x = _series_with_spikes()
    x[[10, 11]] = np.nan
    for got, want in zip(esd(x), r_esd(x)):
        np.testing.assert_array_equal(got, want)
    assert not esd(x)[1][10]
    rng = np.random.RandomState(5)
    col = np.exp(rng.randn(200))
    col[17] = -50.0
    for got, want in zip(ecod(col[:, None]), r_ecod(col[:, None])):
        np.testing.assert_array_equal(got, want)
    assert ecod(col[:, None])[1][17]


@pytest.mark.parametrize("op,kw,rtol", [
    ("HbosOutlierBatchOp", {}, 0.0),
    ("KdeOutlierBatchOp", {}, PAIR_RTOL),
    ("LofOutlierBatchOp", {"numNeighbors": 15}, PAIR_RTOL),
    ("IForestOutlierBatchOp", {"numTrees": 50}, 0.0),
    ("EcodOutlierBatchOp", {}, 0.0),
    ("CopodOutlierBatchOp", {}, 0.0),
    ("SosOutlierBatchOp", {}, PAIR_RTOL),
    ("DbscanOutlierBatchOp", {}, PAIR_RTOL),
])
def test_multivariate_detectors(sid, op, kw, rtol):
    ref, port = both(sid, _blob(), lambda ops, extra, src: getattr(ops, op)(
        featureCols=["f0", "f1", "f2"], predictionCol="o",
        predictionDetailCol="d", **kw, **extra).link_from(src))
    same_outliers(port, ref, rtol=rtol)
    assert set(np.argsort(-scores_of(port))[:3]) == {5, 60, 120} or \
        op in ("SosOutlierBatchOp", "DbscanOutlierBatchOp")


def test_lof_on_one_row(sid):
    ref, port = both(sid, {"a": np.asarray([1.0]), "b": np.asarray([2.0])},
                     lambda ops, extra, src: ops.LofOutlierBatchOp(
                         featureCols=["a", "b"], predictionCol="o", **extra)
                     .link_from(src))
    same_table(port, ref)
    assert not port.col("o")[0]


def test_ocsvm_first_adam_step_at_the_hinge_tie():
    """At w = 0, ρ = 0 every hinge term sits on its tie; JAX's gradient
    gives each side half. The port's first step (and ten steps) match."""
    from alink_tpu.outlier.detectors import ocsvm_fit as r_fit
    from alink_tpu_torch.outlier.detectors import ocsvm_fit

    rng = np.random.default_rng(0)
    X = rng.normal(size=(80, 2)).astype(np.float32)
    for steps, atol in ((1, 1e-6), (10, 1e-4)):
        a = r_fit(X, nu=0.05, num_features=32, num_steps=steps)
        b = ocsvm_fit(X, nu=0.05, num_features=32, num_steps=steps)
        np.testing.assert_array_equal(b["landmarks"], a["landmarks"])
        np.testing.assert_allclose(b["rho"], a["rho"], atol=atol)
        np.testing.assert_allclose(b["w"], a["w"], atol=atol)
    # dloss/dρ at the tie is -1 + 0.5/ν > 0, so Adam's first step takes ρ
    # to -lr; a relu hinge (zero gradient at the tie) gives -1 and +lr
    one = ocsvm_fit(X, nu=0.05, num_features=32, num_steps=1)
    assert one["rho"][0] == pytest.approx(-0.05, abs=1e-6)


def test_sos_and_ocsvm_detectors(sid):
    from alink_tpu.outlier import ocsvm as r_ocsvm, sos as r_sos
    from alink_tpu_torch.outlier import ocsvm, sos

    rng = np.random.default_rng(0)
    X = rng.normal(size=(80, 2)).astype(np.float32)
    X[-1] = [8.0, 8.0]
    (s, f), (rs, rf) = sos(X), r_sos(X)
    np.testing.assert_allclose(s, rs, rtol=PAIR_RTOL)
    np.testing.assert_array_equal(f, rf)
    (o, g), (ro, rg) = ocsvm(X, nu=0.05), r_ocsvm(X, nu=0.05)
    np.testing.assert_allclose(o, ro, atol=OCSVM_ATOL)
    assert (np.abs(ro[g != rg]) <= OCSVM_ATOL).all()
    assert g[-1] and f[-1]
    rows = [tuple(map(float, rng.normal(size=2))) for _ in range(60)]
    cols = {"x": np.asarray([r[0] for r in rows] + [9.0]),
            "y": np.asarray([r[1] for r in rows] + [9.0])}
    for op in ("SosOutlierBatchOp", "OcsvmOutlierBatchOp"):
        ref, port = both(sid, cols, lambda ops, extra, src: getattr(ops, op)(
            featureCols=["x", "y"], predictionDetailCol="d", **extra)
            .link_from(src))
        same_outliers(port, ref, flag="pred", rtol=PAIR_RTOL,
                      atol=OCSVM_ATOL if op.startswith("Ocsvm") else 0.0)
        assert port.col("pred")[-1]


def test_grouped_ksigma_and_new_variants(sid):
    x1 = _series_with_spikes(seed=3)
    x2 = np.random.RandomState(4).randn(200) * 100
    x2[7] = 5000.0
    cols = {"g": np.asarray(["a"] * 200 + ["b"] * 200, object),
            "v": np.concatenate([x1, x2])}
    ref, port = both(sid, cols, lambda ops, extra, src: ops
                     .KSigmaOutlier4GroupedDataBatchOp(
                         groupCols=["g"], selectedCol="v", predictionCol="o",
                         predictionDetailCol="d", **extra).link_from(src))
    same_outliers(port, ref)
    assert port.col("o")[207]
    rng = np.random.default_rng(0)
    base = rng.standard_normal((80, 2))
    base[[0, 40]] = 8.0
    cols = {"g": np.repeat(np.asarray(["a", "b"], object), 40),
            "x": base[:, 0], "y": base[:, 1]}
    for op, rtol in (("CopodOutlier4GroupedDataBatchOp", 0.0),
                     ("LofOutlier4GroupedDataBatchOp", PAIR_RTOL),
                     ("HbosOutlier4GroupedDataBatchOp", 0.0),
                     ("DbscanOutlier4GroupedDataBatchOp", PAIR_RTOL)):
        ref, port = both(sid, cols, lambda ops, extra, src: getattr(ops, op)(
            groupCols="g", featureCols=["x", "y"], predictionCol="o",
            predictionDetailCol="d", **extra).link_from(src))
        same_outliers(port, ref, rtol=rtol)
        assert port.col("o")[0] and port.col("o")[40]


def test_eval_outlier(sid):
    cols = _blob()
    y = np.zeros(150, np.int64)
    y[[5, 60, 120]] = 1
    cols["label"] = y
    ref, port = both(sid, cols, lambda ops, extra, src: ops
                     .EvalOutlierBatchOp(labelCol="label", predictionCol="o",
                                         predictionDetailCol="d", **extra)
                     .link_from(ops.IForestOutlierBatchOp(
                         featureCols=["f0", "f1", "f2"], predictionCol="o",
                         predictionDetailCol="d", numTrees=50, **extra)
                         .link_from(src)))
    same_table(port, ref)
    nan_pred = {"label": np.array([1, 0, 0, 1], np.int64),
                "o": np.array([1.0, np.nan, 0.0, 1.0])}
    ref, port = both(sid, nan_pred, lambda ops, extra, src: ops
                     .EvalOutlierBatchOp(labelCol="label", predictionCol="o",
                                         **extra).link_from(src))
    same_table(port, ref)
    assert json.loads(port.col("Data")[0])["Precision"] == 1.0


def test_cooks_distance_outlier(sid):
    rng = np.random.RandomState(0)
    X = rng.normal(size=(80, 2))
    y = X @ [1.0, 2.0] + rng.normal(0, 0.1, 80)
    X[0] = [6, 6]
    y[0] = -20
    ref, port = both(sid, {"a": X[:, 0], "b": X[:, 1], "y": y},
                     lambda ops, extra, src: ops.CooksDistanceOutlierBatchOp(
                         featureCols=["a", "b"], labelCol="y",
                         predictionCol="o", predictionDetailCol="d", **extra)
                     .link_from(src))
    same_outliers(port, ref)
    assert port.col("o")[0]


def test_model_outlier_train_predict_roundtrip(sid):
    rng = np.random.RandomState(2)
    train = {"a": rng.normal(size=200), "b": rng.normal(size=200)}
    test = {"a": np.asarray([0.1, 12.0, 1.5]), "b": np.asarray([0.0, 12.0,
                                                              -1.0])}
    for tr, pr, kw, atol in (
            ("IForestModelOutlierTrainBatchOp",
             "IForestModelOutlierPredictBatchOp", dict(numTrees=50), 0.0),
            ("OcsvmModelOutlierTrainBatchOp",
             "OcsvmModelOutlierPredictBatchOp", dict(nu=0.05), OCSVM_ATOL)):
        ref, port = both(sid, train, lambda ops, extra, src, t: getattr(
            ops, pr)(predictionCol="o", predictionDetailCol="d", **extra)
            .link_from(getattr(ops, tr)(featureCols=["a", "b"], **kw,
                                        **extra).link_from(src), t), test)
        same_outliers(port, ref, atol=atol)
        assert not port.col("o")[0] and port.col("o")[1]


def test_dbscan_model_family(sid):
    rng = np.random.RandomState(3)
    a = rng.normal(0, 0.2, size=(40, 2))
    b = rng.normal(5, 0.2, size=(40, 2))
    train = {"g": np.asarray(["p", "q"] * 40, object),
             "x": np.r_[a[:, 0], b[:, 0]], "y": np.r_[a[:, 1], b[:, 1]]}
    test = {"g": np.asarray(["p", "q", "p", "r"], object),
            "x": np.asarray([0.0, 5.0, 50.0, 0.0]),
            "y": np.asarray([0.0, 5.0, 50.0, 0.0])}
    for groups in (None, ["g"]):
        for pr in ("DbscanPredictBatchOp", "DbscanModelOutlierPredictBatchOp"):
            ref, port = both(sid, train, lambda ops, extra, src, t: getattr(
                ops, pr)(predictionCol="o", **extra).link_from(
                ops.GroupDbscanModelBatchOp(
                    featureCols=["x", "y"], epsilon=1.0, minPoints=4,
                    groupCols=groups, **extra).link_from(src), t), test)
            same_table(port, ref)
    assert list(port.col("o")) == [False, False, True, True]
