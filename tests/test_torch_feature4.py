"""Parity of the port's feature-selection and constrained-training ops
(``operator/batch/feature4.py``) with ``alink_tpu`` on the CPU: the cases of
``tests/test_feature4.py`` through both packages on the same seeded tables.

Tolerances. Host code copied (the stepwise selectors' scoring and their
least-squares refits, the crosses, WOE, VIF, the grouped FpGrowth and the
rule ops) gives equal tables, floats within 1e-12 relative. The
constrained trainers run float32 optimizers in both packages (the
reference's augmented Lagrangian and L-BFGS against the port's, sums in
other orders): weights within CONS_ATOL = 2e-3, and each model meets its
constraints to CONS_FEAS = 1e-2 as the reference's tests ask. The
divergence trainer (scale-free; exported at unit norm) within DIV_ATOL =
2e-3, its pinned weight exactly 0 in both. GLM evaluation: the GLM fits
are float32 IRLS in both packages; the metrics within 1e-4 relative."""

import json

import numpy as np
import pytest

from torch_table_parity import both, reference_session, remove_session, \
    same_model, same_table

CONS_ATOL = 2e-3
CONS_FEAS = 1e-2
DIV_ATOL = 2e-3


@pytest.fixture(scope="module")
def sid():
    s = reference_session()
    yield s
    remove_session(s)


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("ALINK_TORCH_DEVICE", "cpu")


def _data(n=200, seed=0):
    """Labels with logistic noise, so the logistic fits have a finite
    optimum to compare."""
    rng = np.random.default_rng(seed)
    x1, x2, noise = rng.normal(size=(3, n))
    y = x1 + 0.5 * x2 + 0.5 * rng.logistic(size=n) > 0
    return {"x1": x1, "x2": x2, "noise": noise, "y": y.astype(np.int64)}


def _arrays(t):
    from alink_tpu_torch.common.model import table_to_model

    return table_to_model(t)


@pytest.mark.parametrize("binary", [True, False])
def test_stepwise_selectors(sid, binary):
    cols = _data()
    if not binary:
        rng = np.random.default_rng(1)
        cols = dict(cols, y=2 * cols["x1"] + 0.05 * rng.normal(size=200))
    op = "BinarySelector" if binary else "RegressionSelector"

    def build(ops, extra, src):
        m = getattr(ops, f"{op}TrainBatchOp")(labelCol="y", maxSelected=2,
                                              **extra).link_from(src)
        return getattr(ops, f"{op}PredictBatchOp")(
            predictionCol="s", **extra).link_from(m, src)

    ref, port = both(sid, cols, lambda ops, extra, src: getattr(
        ops, f"{op}TrainBatchOp")(labelCol="y", maxSelected=2,
                                  **extra).link_from(src))
    same_model(port, ref)
    assert "x1" in _arrays(port)[0]["selectedCols"]
    ref, port = both(sid, cols, build)
    same_table(port, ref)


@pytest.mark.parametrize("op, cons", [
    ("ConstrainedLogisticRegressionTrainBatchOp",
     {"A_eq": [[0.0, 0.0, 1.0, 0.0]], "b_eq": [0.0]}),
    ("ConstrainedLogisticRegressionTrainBatchOp",
     {"A_eq": [[0.0, 0.0, 1.0, 0.0]], "b_eq": [0.0],
      "A_ub": [[1.0, 1.0, 0.0, 0.0]], "b_ub": [2.0]}),
    ("ConstrainedLinearRegTrainBatchOp",
     {"A_ub": [[1.0, -1.0, 0.0, 0.0]], "b_ub": [0.0]}),
])
def test_constrained_linear_ops(sid, op, cons):
    cols = _data()
    if op == "ConstrainedLinearRegTrainBatchOp":
        cols = dict(cols, y=(2.0 * cols["x1"] - cols["x2"]))
    ref, port = both(sid, cols, lambda ops, extra, src: getattr(ops, op)(
        labelCol="y", featureCols=["x1", "x2", "noise"],
        constraint=json.dumps(cons), maxIter=50, **extra).link_from(src))
    (pm, pa), (rm, ra) = _arrays(port), _arrays(ref)
    w_p = np.concatenate([pa["weights"], pa["intercept"]])
    w_r = np.concatenate([ra["weights"], ra["intercept"]])
    np.testing.assert_allclose(w_p, w_r, atol=CONS_ATOL)
    for w in (w_p, w_r):
        if "A_eq" in cons:
            assert np.abs(np.asarray(cons["A_eq"]) @ w
                          - cons["b_eq"]).max() < CONS_FEAS
        if "A_ub" in cons:
            assert (np.asarray(cons["A_ub"]) @ w - cons["b_ub"]).max() \
                < CONS_FEAS


@pytest.mark.parametrize("cons", [None, {"A_eq": [[0.0, 1.0, 0.0]],
                                         "b_eq": [0.0]}])
def test_constrained_divergence(sid, cons):
    cols = _data(150)
    del cols["noise"]
    params = {"constraint": json.dumps(cons)} if cons else {}
    ref, port = both(sid, cols, lambda ops, extra, src:
                     ops.ConstrainedDivergenceTrainBatchOp(
                         labelCol="y", featureCols=["x1", "x2"], **params,
                         **extra).link_from(src))
    (pm, pa), (rm, ra) = _arrays(port), _arrays(ref)
    np.testing.assert_allclose(pa["weights"], ra["weights"], atol=DIV_ATOL)
    w = pa["weights"]
    if cons:
        assert abs(float(w[1])) < 1e-5 and abs(float(w[0])) > 0.9
    else:
        cos = abs(w @ [1.0, 0.5]) / (np.linalg.norm(w) * np.linalg.norm(
            [1, 0.5]))
        assert cos > 0.9


def test_constrained_selectors(sid):
    cols = _data()
    cons = json.dumps({"A_eq": [[0.0, 1.0, 0.0]], "b_eq": [0.5]})
    ref, port = both(sid, cols, lambda ops, extra, src:
                     ops.ConstrainedBinarySelectorTrainBatchOp(
                         labelCol="y", maxSelected=2, constraint=cons,
                         **extra).link_from(src))
    (pm, pa), (rm, ra) = _arrays(port), _arrays(ref)
    assert pm["selectedCols"] == rm["selectedCols"]
    np.testing.assert_allclose(pa["weights"], ra["weights"], atol=CONS_ATOL)
    assert abs(pa["weights"][1] - 0.5) < CONS_FEAS


XOR = {"a": np.asarray(["p", "p", "q", "q"] * 10, object),
       "b": np.asarray(["x", "y", "x", "y"] * 10, object),
       "y": np.asarray([1, 0, 0, 1] * 10, np.int64)}


def test_cross_features(sid):
    def cross(ops, extra, src):
        m = ops.CrossFeatureTrainBatchOp(selectedCols=["a", "b"],
                                         **extra).link_from(src)
        return ops.CrossFeaturePredictBatchOp(outputCol="c",
                                              **extra).link_from(m, src)

    ref, port = both(sid, XOR, cross)
    same_table(port, ref)
    ref, port = both(sid, XOR, lambda ops, extra, src:
                     ops.HashCrossFeatureBatchOp(
                         selectedCols=["a", "b"], numFeatures=32,
                         outputCol="c", **extra).link_from(src))
    same_table(port, ref)

    def selector(ops, extra, src):
        m = ops.CrossCandidateSelectorTrainBatchOp(
            featureCandidates=[["a", "b"], ["a"]], labelCol="y",
            crossFeatureNumber=2, **extra).link_from(src)
        return ops.CrossCandidateSelectorPredictBatchOp(
            outputCol="c", **extra).link_from(m, src)

    ref, port = both(sid, XOR, selector)
    same_table(port, ref)


def test_woe_binning_and_vif(sid):
    cols = {"cat": np.asarray(["p"] * 10 + ["q"] * 10 + ["r"], object),
            "y": np.asarray([1] * 8 + [0] * 2 + [1] * 2 + [0] * 8 + [1],
                            np.int64)}

    def woe(ops, extra, src):
        m = ops.WoeTrainBatchOp(selectedCols=["cat"], labelCol="y",
                                positiveLabelValueString="1",
                                **extra).link_from(src)
        return ops.WoePredictBatchOp(**extra).link_from(m, src)

    ref, port = both(sid, cols, woe)
    same_table(port, ref)
    rng = np.random.default_rng(2)
    a = rng.normal(size=100)
    vif_cols = {"a": a, "b": a + 0.01 * rng.normal(size=100),
                "c": rng.normal(size=100)}
    ref, port = both(sid, vif_cols, lambda ops, extra, src:
                     ops.MultiCollinearityBatchOp(
                         selectedCols=["a", "b", "c"],
                         **extra).link_from(src))
    same_table(port, ref, rtol=1e-9)
    vif_cols["y"] = (vif_cols["a"] + vif_cols["c"] > 0).astype(np.int64)
    ref, port = both(sid, vif_cols, lambda ops, extra, src:
                     ops.BinningTrainForScorecardBatchOp(
                         selectedCols=["a", "c"], labelCol="y",
                         **extra).link_from(src))
    same_model(port, ref)


def test_grouped_fpgrowth_and_rule_application(sid):
    txn = {"g": np.asarray(["A", "A", "B", "B"], object),
           "items": np.asarray(["milk,bread", "milk,bread,eggs",
                                "beer,chips", "beer,nuts"], object)}
    ref, port = both(sid, txn, lambda ops, extra, src:
                     ops.GroupedFpGrowthBatchOp(
                         groupCol="g", selectedCol="items",
                         minSupportPercent=0.5, **extra).link_from(src))
    same_table(port, ref)
    rules = {"antecedent": np.asarray(["milk", "beer", "milk,eggs"], object),
             "consequent": np.asarray(["bread", "chips", "jam"], object)}
    data = {"items": np.asarray(["milk,eggs", "wine", None, "eggs,milk"],
                                object)}
    for op in ("ApplyAssociationRuleBatchOp", "ApplySequenceRuleBatchOp"):
        ref, port = both(sid, rules, lambda ops, extra, r, d: getattr(
            ops, op)(selectedCol="items", outputCol="rec",
                     **extra).link_from(r, d), data)
        same_table(port, ref)


def test_glm_evaluation(sid):
    rng = np.random.default_rng(3)
    x = rng.normal(size=150)
    cols = {"x": x, "y": np.exp(0.4 * x) + 0.02 * np.abs(rng.normal(
        size=150))}

    def build(ops, extra, src):
        m = ops.GlmTrainBatchOp(featureCols=["x"], labelCol="y",
                                family="Gamma", link="Log",
                                **extra).link_from(src)
        return ops.GlmEvaluationBatchOp(**extra).link_from(m, src)

    ref, port = both(sid, cols, build)
    same_table(port, ref, rtol=1e-4)
    metrics = dict(port.rows())
    assert metrics["deviance"] < 1.0
