"""The classification families of the port (``operator/batch/
classification.py``) and the int8 programs of their scorers
(``common/quant.py``) held against ``alink_tpu`` on the CPU, with inputs
made by seeded numpy; the reference's optimizers run in a session on a
one-device mesh.

- NaiveBayes (gaussian, multinomial, bernoulli): model arrays within 1e-5
  of the largest entry (float32 sums in another order), the same
  predictions, detail probabilities within 1e-5.
- Knn (euclidean, cosine) and KnnReg on continuous seeded data, queried
  with held-out rows whose 10th and 11th neighbours lie apart (checked):
  the same neighbour sets (on a tie the port's stable sort and
  ``lax.top_k`` both put the lower row first), so the same votes; KnnReg
  within 1e-5. Every case predicts held-out rows.
- FM (binary, regression), MLP and OneVsRest over LogisticRegression at
  maxIter 5, as tests/test_torch_linear.py runs L-BFGS: weights within
  1e-4 of the largest, the same predictions, detail probabilities and
  regression scores within 1e-4.
- The int8 programs: the NB and FM int32 accumulators equal to the
  reference's (the same int8 operands; integer sums are exact), MLP's
  served int8 weights equal, and the three ops served under the ``int8``
  and ``bf16`` policies from one calibration record: the same
  predictions, probabilities within 1e-4, FM's within 2e-3. FM's pairwise
  term runs in bf16 under int8 (as in the reference), summed over the
  factors in another order by each framework: a few bf16 ulps (2^-8) of
  its parts move a score by up to about 1e-2 here, and a probability by
  at most a quarter of that.
- ``PipelineModel`` files of the NaiveBayes, KnnClassifier, FmClassifier
  and MultilayerPerceptronClassifier stages load and predict alike in
  either package.
"""

import json

import numpy as np
import pytest

import jax

MODEL_ATOL = 1e-4        # L-BFGS weights, of the largest |weight|
PROB_ATOL = 1e-4
FM_BF16_ATOL = 2e-3     # see the module docstring


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


FEATS = ["f0", "f1", "f2", "f3"]


def _cols(seed=0, n=150, classes=3, counts=False):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, classes, n)
    centers = np.random.default_rng(9).normal(scale=2.0, size=(classes, 4))
    X = centers[y] + rng.normal(size=(n, 4))
    if counts:                         # multinomial/bernoulli: counts >= 0
        X = np.floor(np.abs(X) * 2)
    cols = {f: X[:, i] for i, f in enumerate(FEATS)}
    cols["label"] = np.asarray([f"c{v}" for v in y], object)
    cols["target"] = X @ np.array([1.0, -0.5, 0.25, 2.0]) \
        + rng.normal(scale=0.1, size=n)
    return cols


def _binary(cols):
    out = dict(cols)
    out["label"] = np.where(cols["label"] == "c0", "a", "b").astype(object)
    return out


# case -> (op family, train params, data options)
CASES = {
    "nb-gaussian": ("NaiveBayes", dict(modelType="GAUSSIAN"), {}),
    "nb-multinomial": ("NaiveBayes", dict(modelType="MULTINOMIAL"),
                       dict(counts=True)),
    "nb-bernoulli": ("NaiveBayes", dict(modelType="BERNOULLI",
                                        smoothing=0.5), dict(counts=True)),
    "knn-euclidean": ("Knn", dict(), {}),
    "knn-cosine": ("Knn", dict(distanceType="COSINE"), {}),
    "knnreg": ("KnnReg", dict(), {}),
    "fm-binary": ("FmClassifier", dict(numFactor=3, maxIter=5), dict(
        binary=True)),
    "fm-regression": ("FmRegressor", dict(numFactor=3, maxIter=5,
                                          lambda2=0.01), {}),
    "mlp": ("MultilayerPerceptron", dict(layers=[6], maxIter=5), {}),
    "ovr": ("OneVsRest", dict(), {}),
}


def _data(pkg, case, seed=0):
    """Training rows (seed 0) or held-out rows (seed 1) of ``case``."""
    import importlib

    MTable = importlib.import_module(pkg + ".common.mtable").MTable
    opts = dict(CASES[case][2])
    binary = opts.pop("binary", False)
    cols = _cols(seed=seed, **opts)
    return MTable(_binary(cols) if binary else cols)


def _train(pkg, case, sid=None):
    import importlib

    ops = importlib.import_module(pkg + ".operator.batch")
    name, params, _ = CASES[case]
    env = {} if sid is None else {"MLEnvironmentId": sid}
    label = "target" if case in ("knnreg", "fm-regression") else "label"
    src = ops.TableSourceBatchOp(_data(pkg, case))
    if name == "OneVsRest":
        proto = ops.LogisticRegressionTrainBatchOp(
            featureCols=FEATS, labelCol=label, maxIter=5, **env)
        op = ops.OneVsRestTrainBatchOp(proto, **env)
    else:
        op = getattr(ops, name + "TrainBatchOp")(
            featureCols=FEATS, labelCol=label, **params, **env)
    return op.link_from(src).collect()


def _predict_op(ops, case):
    name = CASES[case][0]
    return getattr(ops, {"FmClassifier": "FmPredictBatchOp",
                         "FmRegressor": "FmPredictBatchOp"}.get(
        name, name + "PredictBatchOp"))


def _predict(pkg, case, model, sid=None, **extra):
    import importlib

    ops = importlib.import_module(pkg + ".operator.batch")
    regression = case in ("knnreg", "fm-regression")
    if sid is not None:
        extra["MLEnvironmentId"] = sid
    if not regression:
        extra["predictionDetailCol"] = "d"
    out = _predict_op(ops, case)(predictionCol="p", **extra).link_from(
        ops.TableSourceBatchOp(model),
        ops.TableSourceBatchOp(_data(pkg, case, seed=1))).collect()
    pred = np.asarray(out.col("p"))
    if regression:
        return pred, None
    detail = [json.loads(s) for s in out.col("d")]
    return pred, np.asarray([[d[k] for k in sorted(d)] for d in detail])


def _port_table(t):
    from alink_tpu_torch.common.mtable import MTable

    return MTable.from_payload(*t.to_payload())


def _check_arrays(got, want, atol):
    assert sorted(got) == sorted(want)
    for k in want:
        scale = max(float(np.abs(want[k]).max()), 1.0)
        np.testing.assert_allclose(got[k], want[k], rtol=0,
                                   atol=atol * scale, err_msg=k)


@pytest.mark.parametrize("case", list(CASES))
def test_family_matches_reference(case, sid):
    from alink_tpu.common.model import table_to_model as r_t2m
    from alink_tpu_torch.common.model import table_to_model as p_t2m

    ref = _train("alink_tpu", case, sid)
    port = _train("alink_tpu_torch", case)
    (rm, ra), (pm, pa) = r_t2m(ref), p_t2m(port)
    for k in ("modelName", "labels", "labelType", "dim", "numIters",
              "modelType", "fmTask", "layerSizes", "mapperClass"):
        assert pm.get(k) == rm.get(k), k
    tight = CASES[case][0] in ("NaiveBayes", "Knn", "KnnReg")
    _check_arrays(pa, ra, 1e-5 if tight else MODEL_ATOL)
    pred, detail = _predict("alink_tpu_torch", case, port)
    r_pred, r_detail = _predict("alink_tpu", case, ref, sid)
    if r_detail is None:
        np.testing.assert_allclose(pred, r_pred, rtol=0,
                                   atol=(1e-5 if tight else PROB_ATOL)
                                   * max(1.0, np.abs(r_pred).max()))
    else:
        np.testing.assert_array_equal(pred, r_pred)
        np.testing.assert_allclose(detail, r_detail, rtol=0,
                                   atol=1e-5 if tight else PROB_ATOL)


def test_knn_neighbours_without_ties():
    """The Knn cases' held-out rows have no tie at their 10th neighbour
    (the gap to the 11th is above float32's rounding of the distances),
    and the port's neighbour sets are the float64 oracle's."""
    import torch

    from alink_tpu_torch.operator.batch.classification import knn_neighbors

    X = np.stack([_cols()[f] for f in FEATS], 1).astype(np.float32)
    Q = np.stack([_cols(seed=1)[f] for f in FEATS], 1).astype(np.float32)
    d64 = ((Q[:, None, :].astype(np.float64) - X[None]) ** 2).sum(-1)
    srt = np.sort(d64, 1)
    assert (srt[:, 10] - srt[:, 9] > 1e-4 * srt[:, 10]).all()
    _, idx = knn_neighbors(torch.from_numpy(Q), torch.from_numpy(X), 10,
                           False)
    want = np.argsort(d64, 1, kind="stable")[:, :10]
    assert [set(r) for r in idx.numpy()] == [set(r) for r in want]
    # equal distances: the lower training row first, as lax.top_k
    Q = torch.zeros((1, 2))
    T = torch.tensor([[1.0, 0.0], [0.0, 1.0], [-1.0, 0.0], [2.0, 0.0]])
    assert knn_neighbors(Q, T, 3, False)[1].tolist() == [[0, 1, 2]]


# ---------------------------------------------------------------------------
# the int8 programs
# ---------------------------------------------------------------------------

def test_int8_nb_and_fm_accumulators_exact():
    import jax.numpy as jnp
    import torch

    from alink_tpu.common import quant as R
    from alink_tpu_torch.common import quant as P

    rng = np.random.default_rng(3)
    X = rng.normal(size=(37, 12)).astype(np.float32)
    a = rng.normal(size=(12, 5)).astype(np.float32)
    b = rng.normal(size=(12, 5)).astype(np.float32)
    aq, _ = P.quantize_per_channel(a)
    bq, _ = P.quantize_per_channel(b)
    sx, sxx = np.float32(np.abs(X).max() / 127), \
        np.float32((X * X).max() / 127)

    def ref_acc(Xv, wq, s):
        q = Xv.astype(np.int8) if s is None else R._quantize_act(
            jnp, jnp.asarray(Xv), s)
        return np.asarray(R._int8_matmul(jax, jnp, q, jnp.asarray(wq)))

    t = [torch.from_numpy(v) for v in (X, aq, bq)]
    ts = [torch.tensor(v) for v in (sxx, sx)]
    for mtype, want in (
            ("GAUSSIAN", [ref_acc(X * X, aq, sxx), ref_acc(X, bq, sx)]),
            ("MULTINOMIAL", [ref_acc(X, aq, sx)]),
            ("BERNOULLI", [ref_acc((X > 0), aq, None)])):
        got = P.int8_nb_accumulators(mtype, *t, *ts)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.dtype == torch.int32
            np.testing.assert_array_equal(g.numpy(), w)
    w = rng.normal(size=12).astype(np.float32)
    wq, _ = P.quantize_per_channel(w)
    got = P.int8_fm_accumulators(t[0], torch.from_numpy(wq), ts[1])
    np.testing.assert_array_equal(got.numpy(), ref_acc(X, wq, sx))


INT8_CASES = {"nb-gaussian": "naivebayes", "nb-multinomial": "naivebayes",
              "nb-bernoulli": "naivebayes", "fm-binary": "fm", "mlp": "mlp"}


@pytest.mark.parametrize("case", list(INT8_CASES))
def test_policies_match_reference(case, sid):
    """A model the reference trained, calibrated once and served under
    fp32, bf16 and int8 by both packages."""
    from alink_tpu.common import quant as ref_quant

    ref_model = _train("alink_tpu", case, sid)
    port_model = _port_table(ref_model)
    site = "m:" + INT8_CASES[case]
    calib = {}
    with ref_quant.calibration(calib):
        _predict("alink_tpu", case, ref_model, sid, quantSite=site)
    for policy in ("bf16", "int8"):
        extra = {"inferencePrecision": policy, "quantCalib": calib,
                 "quantSite": site}
        got = _predict("alink_tpu_torch", case, port_model, **dict(extra))
        want = _predict("alink_tpu", case, ref_model, sid, **dict(extra))
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_allclose(got[1], want[1], rtol=0,
                                   atol=FM_BF16_ATOL if case == "fm-binary"
                                   else PROB_ATOL)
    if case == "mlp":
        from alink_tpu_torch.common.model import table_to_model
        from alink_tpu_torch.operator.batch.classification import (
            mlp_int8_layers)

        meta, arrays = table_to_model(port_model)
        packed = mlp_int8_layers(meta["layerSizes"], arrays["weights"])
        w = arrays["weights"]
        wq, s = ref_quant.quantize_per_channel(w[:4 * 6].reshape(4, 6))
        np.testing.assert_array_equal(packed[0], wq)
        np.testing.assert_array_equal(packed[1], s)


# ---------------------------------------------------------------------------
# PipelineModel files across the packages
# ---------------------------------------------------------------------------

STAGES = (("NaiveBayes", dict(modelType="GAUSSIAN"), "p1"),
          ("KnnClassifier", dict(k=5), "p2"),
          ("FmClassifier", dict(numFactor=2, maxIter=3), "p3"),
          ("MultilayerPerceptronClassifier", dict(layers=[4], maxIter=3),
           "p4"))


def _pipeline(pl):
    return pl.Pipeline(*[
        getattr(pl, name)(featureCols=FEATS, labelCol="label",
                          predictionCol=col, predictionDetailCol=col + "d",
                          **params)
        for name, params, col in STAGES])


@pytest.mark.parametrize("writer", ["alink_tpu", "alink_tpu_torch"])
def test_pipeline_model_crosses_packages(tmp_path, writer):
    import importlib

    reader = "alink_tpu" if writer == "alink_tpu_torch" else \
        "alink_tpu_torch"
    w_pl = importlib.import_module(writer + ".pipeline")
    r_pl = importlib.import_module(reader + ".pipeline")
    path = str(tmp_path / "m.ak")

    def table(pkg):
        MTable = importlib.import_module(pkg + ".common.mtable").MTable
        return MTable(_binary(_cols()))

    model = _pipeline(w_pl).fit(table(writer))
    want = model.transform(table(writer)).collect()
    model.save(path)
    loaded = r_pl.PipelineModel.load(path)
    assert [type(s).__name__ for s in loaded.stages] == \
        ["NaiveBayesModel", "KnnClassifierModel", "FmModel",
         "MultilayerPerceptronModel"]
    got = loaded.transform(table(reader)).collect()
    assert got.names == want.names
    for _, _, col in STAGES:
        np.testing.assert_array_equal(got.col(col), want.col(col))
        probs = [np.asarray([[json.loads(s)[k] for k in ("a", "b")]
                             for s in t.col(col + "d")]) for t in (got, want)]
        np.testing.assert_allclose(probs[0], probs[1], rtol=0, atol=1e-5)
