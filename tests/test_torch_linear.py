"""The linear operators of the port (``operator/batch/linear.py``) held
against ``alink_tpu`` on the CPU, with inputs made by seeded numpy; the
reference runs in a session on a one-device mesh.

- Each of the seven train ops at maxIter 5: the same labels, label type,
  model type, feature columns and numIters; weights within 1e-4 of the
  largest weight, intercepts within 1e-4 of the largest of |weights| and
  |intercept| (float32 in both; the loss and gradient sums run in another
  order, and the standardisation's fold-back divides by the same float32
  std in both). maxIter 5 stops both before they converge: once a fit has
  converged, the test |Δloss| < 1e-6·|loss| is decided at float32's
  rounding level and a rounding-level difference can end it an iteration
  apart (tests/test_torch_optim.py and the digits fit of
  tests/test_torch_pipeline.py hold converging fits).
- Predictions on the training rows identical; the detail JSON's
  probabilities within 1e-4 (a probability moves by at most a quarter of
  its score's change, and the scores by up to 1e-4 of the largest weight
  times Σ|x|).
- The standardisation fold-back: a noiseless regression's raw
  coefficients come back, as the reference's do.
- The sparse route on a 10,000-dimensional problem.
- A model ``.ak`` written by either package predicts identically in the
  other (same weights: predictions equal, detail within 1e-6).
- ``tests/test_golden_parity.py::test_linear_reg_recovers_coefficients``
  on the port, on its golden values.
"""

import json

import numpy as np
import pytest

import jax

TRAIN_OPS = ["LogisticRegression", "LinearSvm", "LinearReg", "RidgeReg",
             "LassoReg", "LinearSvr", "Softmax"]
META_KEYS = ("modelName", "linearModelType", "labelType", "labels",
             "hasIntercept", "dim", "featureCols", "vectorCol", "labelCol",
             "numIters")


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("ALINK_TORCH_DEVICE", "cpu")


@pytest.fixture(scope="module")
def sid():
    """A reference session on a one-device mesh."""
    from alink_tpu.common.env import MLEnvironment, MLEnvironmentFactory
    from alink_tpu.parallel.mesh import default_mesh

    sid = MLEnvironmentFactory.get_new_environment_id(
        MLEnvironment(mesh=default_mesh(jax.devices()[:1])))
    yield sid
    MLEnvironmentFactory.remove(sid)


def _cols(seed=0, n=300):
    rng = np.random.default_rng(seed)
    X = (rng.normal(size=(n, 5)) * np.array([1, 2, 3, 0.5, 10])
         + np.array([0, 1, -2, 3, 5]))
    s = X @ rng.normal(size=5)
    cols = {f"f{i}": X[:, i] for i in range(5)}
    noisy = s + 0.3 * s.std() * rng.normal(size=n)
    label = {"bin": np.where(noisy > np.median(s), "yes", "no").astype(object),
             "reg": s + 0.1 * rng.normal(size=n),
             "multi": np.digitize(noisy, np.quantile(s, [0.33, 0.66]))
             .astype(np.int64)}
    return cols, label


def _label_kind(op):
    if op in ("LogisticRegression", "LinearSvm"):
        return "bin"
    return "multi" if op == "Softmax" else "reg"


def _tables(cols):
    from alink_tpu.common.mtable import MTable as RT
    from alink_tpu_torch.common.mtable import MTable as PT

    return RT(dict(cols)), PT(dict(cols))


def _fit(op, cols, sid, **kw):
    """Model tables of both packages for ``op`` on ``cols``."""
    import alink_tpu.operator.batch as R
    import alink_tpu_torch.operator.batch as P

    rt, pt = _tables(cols)
    kw = dict(labelCol="label", **kw)
    ref = getattr(R, op + "TrainBatchOp")(MLEnvironmentId=sid, **kw) \
        .link_from(R.TableSourceBatchOp(rt)).collect()
    port = getattr(P, op + "TrainBatchOp")(**kw) \
        .link_from(P.TableSourceBatchOp(pt)).collect()
    return ref, port


def _predict(pkg, op, model, cols, sid=None, **kw):
    import importlib

    ops = importlib.import_module(pkg + ".operator.batch")
    mt = importlib.import_module(pkg + ".common.mtable")
    if sid is not None:
        kw["MLEnvironmentId"] = sid
    if _label_kind(op) != "reg":
        kw["predictionDetailCol"] = "d"
    out = getattr(ops, op + "PredictBatchOp")(predictionCol="p", **kw) \
        .link_from(ops.TableSourceBatchOp(model),
                   ops.TableSourceBatchOp(mt.MTable(dict(cols)))).collect()
    detail = (None if "d" not in out.names else
              [json.loads(s) for s in out.col("d")])
    return np.asarray(out.col("p")), detail


def _check_details(a, b, atol):
    if a is None:
        assert b is None
        return
    assert [sorted(x) for x in a] == [sorted(x) for x in b]
    got = np.asarray([[x[k] for k in sorted(x)] for x in a])
    want = np.asarray([[x[k] for k in sorted(x)] for x in b])
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


def _models(ref, port):
    from alink_tpu.common.model import table_to_model as r_t2m
    from alink_tpu_torch.common.model import table_to_model as p_t2m

    return r_t2m(ref), p_t2m(port)


def _check_model(ref, port, rtol=1e-4):
    (rm, ra), (pm, pa) = _models(ref, port)
    for k in META_KEYS:
        assert pm.get(k) == rm.get(k), k
    scale = float(np.abs(ra["weights"]).max())
    np.testing.assert_allclose(pa["weights"], ra["weights"], rtol=0,
                               atol=rtol * scale)
    scale = max(scale, float(np.abs(ra["intercept"]).max()))
    np.testing.assert_allclose(pa["intercept"], ra["intercept"], rtol=0,
                               atol=rtol * scale)
    assert pm["loss"] == pytest.approx(rm["loss"], rel=1e-4, abs=1e-7)


@pytest.mark.parametrize("op", TRAIN_OPS)
def test_train_op_matches_reference(sid, op):
    cols, label = _cols(seed=1)
    cols["label"] = label[_label_kind(op)]
    ref, port = _fit(op, cols, sid, maxIter=5)
    _check_model(ref, port)
    rp, rd = _predict("alink_tpu", op, ref, cols, sid)
    pp, pd = _predict("alink_tpu_torch", op, port, cols)
    if _label_kind(op) == "reg":
        np.testing.assert_allclose(pp, rp, rtol=1e-4,
                                   atol=1e-4 * np.abs(rp).max())
    else:
        np.testing.assert_array_equal(pp, rp)
    _check_details(pd, rd, atol=1e-4)


def test_unstandardized_weighted_and_no_intercept_match_reference(sid):
    """standardization=False, a weight column, withIntercept=False and an
    explicit optimizer with l1 (owlqn) in one fit."""
    cols, label = _cols(seed=2)
    cols["label"] = label["bin"]
    cols["w"] = np.random.default_rng(3).uniform(0.5, 2.0, len(label["bin"]))
    ref, port = _fit("LogisticRegression", cols, sid, maxIter=5,
                     standardization=False, weightCol="w",
                     withIntercept=False, l1=0.01,
                     featureCols=[f"f{i}" for i in range(5)])
    _check_model(ref, port)


def test_standardization_fold_back_recovers_raw_coefficients(sid):
    """The weights learned on standardised features are folded back so the
    model predicts on raw ones: a noiseless regression on columns of very
    different scales recovers its raw coefficients and intercept, and the
    folded weights are the reference's."""
    rng = np.random.default_rng(4)
    X = rng.normal(size=(200, 3)) * np.array([1.0, 50.0, 0.01]) + 7.0
    coef = np.array([2.0, -0.05, 30.0])
    cols = {"a": X[:, 0], "b": X[:, 1], "c": X[:, 2], "label": X @ coef + 4.0}
    ref, port = _fit("LinearReg", cols, sid, maxIter=5)
    _check_model(ref, port)
    _, (meta, arrays) = _models(ref, port)
    np.testing.assert_allclose(arrays["weights"], coef, rtol=1e-3)
    assert float(arrays["intercept"][0]) == pytest.approx(4.0, abs=0.05)


def _sparse_cols(seed=0, n=200, dim=10_000, nnz=8):
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(n):
        lab = int(rng.integers(2))
        idx = np.sort(rng.choice(dim, nnz, replace=False))
        idx[0] = 0
        val = rng.normal(size=nnz)
        val[0] = (1.0 if lab else -1.0) + 0.8 * rng.normal()
        rows.append((lab, np.sort(idx), val))
    return rows, dim


def _sparse_table(pkg, rows, dim):
    import importlib

    la = importlib.import_module(pkg + ".common.linalg")
    mt = importlib.import_module(pkg + ".common.mtable")
    return mt.MTable(
        {"vec": np.asarray([la.SparseVector(dim, i, v) for _, i, v in rows],
                           object),
         "label": np.asarray([r[0] for r in rows], np.int64)},
        mt.TableSchema(["vec", "label"], ["SPARSE_VECTOR", "LONG"]))


def test_sparse_route_matches_reference(sid):
    """10,000-dimensional SparseVectors: the ELL route, never densified."""
    import alink_tpu.operator.batch as R
    import alink_tpu_torch.operator.batch as P

    rows, dim = _sparse_cols()
    kw = dict(vectorCol="vec", labelCol="label", maxIter=5,
              standardization=False)
    rt, pt = _sparse_table("alink_tpu", rows, dim), \
        _sparse_table("alink_tpu_torch", rows, dim)
    ref = R.LogisticRegressionTrainBatchOp(MLEnvironmentId=sid, **kw) \
        .link_from(R.TableSourceBatchOp(rt)).collect()
    port = P.LogisticRegressionTrainBatchOp(**kw) \
        .link_from(P.TableSourceBatchOp(pt)).collect()
    _check_model(ref, port)
    (rm, _), (pm, pa) = _models(ref, port)
    assert pm["dim"] == dim and pa["weights"].shape == (dim,)
    outs = []
    for pkg, ops, t, m, extra in (("r", R, rt, ref, dict(MLEnvironmentId=sid)),
                                  ("p", P, pt, port, {})):
        out = ops.LogisticRegressionPredictBatchOp(
            vectorCol="vec", predictionCol="p", predictionDetailCol="d",
            **extra).link_from(ops.TableSourceBatchOp(m),
                               ops.TableSourceBatchOp(t)).collect()
        outs.append((np.asarray(out.col("p")),
                     [json.loads(s) for s in out.col("d")]))
    np.testing.assert_array_equal(outs[1][0], outs[0][0])
    _check_details(outs[1][1], outs[0][1], atol=1e-4)


@pytest.mark.parametrize("op", ["LogisticRegression", "LinearReg",
                                "Softmax"])
def test_model_ak_crosses_packages(sid, tmp_path, op):
    """A model .ak written by either package predicts identically in the
    other: the same weights on both sides."""
    from alink_tpu.io.ak import read_ak as r_read
    from alink_tpu.io.ak import write_ak as r_write
    from alink_tpu_torch.io.ak import read_ak as p_read
    from alink_tpu_torch.io.ak import write_ak as p_write

    cols, label = _cols(seed=5)
    cols["label"] = label[_label_kind(op)]
    ref, port = _fit(op, cols, sid, maxIter=5)
    r_write(str(tmp_path / "ref.ak"), ref)
    p_write(str(tmp_path / "port.ak"), port)
    for model_ref, model_port in (
            (ref, p_read(str(tmp_path / "ref.ak"))),
            (r_read(str(tmp_path / "port.ak")), port)):
        rp, rd = _predict("alink_tpu", op, model_ref, cols, sid)
        pp, pd = _predict("alink_tpu_torch", op, model_port, cols)
        if _label_kind(op) == "reg":
            np.testing.assert_allclose(pp, rp, rtol=1e-6,
                                       atol=1e-6 * np.abs(rp).max())
        else:
            np.testing.assert_array_equal(pp, rp)
        _check_details(pd, rd, atol=1e-6)


def test_golden_linear_reg_recovers_coefficients():
    """tests/test_golden_parity.py::test_linear_reg_recovers_coefficients
    on the port."""
    from alink_tpu_torch.common.mtable import MTable
    from alink_tpu_torch.operator.batch import (LinearRegPredictBatchOp,
                                                LinearRegTrainBatchOp,
                                                TableSourceBatchOp)

    rng = np.random.default_rng(0)
    a = rng.normal(size=200)
    b = rng.normal(size=200)
    y = 3.0 * a - 2.0 * b + 1.0  # noiseless -> exact recovery
    src = TableSourceBatchOp(MTable({"a": a, "b": b, "y": y}))
    m = LinearRegTrainBatchOp(
        featureCols=["a", "b"], labelCol="y").link_from(src)
    out = LinearRegPredictBatchOp(predictionCol="p").link_from(
        m, src).collect()
    np.testing.assert_allclose(np.asarray(out.col("p")), y, atol=1e-3)


def test_big_block_scores_in_chunks_as_one_block(monkeypatch):
    """Blocks above STREAM_THRESHOLD_BYTES score in row chunks; the scores
    equal the one-block product's."""
    import alink_tpu_torch.operator.batch as P
    from alink_tpu_torch.common.mtable import MTable
    from alink_tpu_torch.operator.batch.linear import LinearModelMapper

    cols, label = _cols(seed=6, n=1000)
    cols["label"] = label["multi"]
    t = MTable(cols)
    model = P.SoftmaxTrainBatchOp(labelCol="label", maxIter=5) \
        .link_from(P.TableSourceBatchOp(t)).collect()

    def scores():
        return P.SoftmaxPredictBatchOp(predictionDetailCol="d").link_from(
            P.TableSourceBatchOp(model), P.TableSourceBatchOp(t)).collect()

    whole = scores()
    monkeypatch.setattr(LinearModelMapper, "STREAM_THRESHOLD_BYTES", 1024)
    monkeypatch.setattr(LinearModelMapper, "STREAM_CHUNK_BYTES", 4000)
    chunked = scores()
    np.testing.assert_array_equal(chunked.col("pred"), whole.col("pred"))
    _check_details([json.loads(s) for s in chunked.col("d")],
                   [json.loads(s) for s in whole.col("d")], atol=1e-6)
