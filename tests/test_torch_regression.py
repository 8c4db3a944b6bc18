"""The regression families of the port (``operator/batch/regression.py``)
held against ``alink_tpu`` on the CPU, with inputs made by seeded numpy;
the reference's optimizer runs in a session on a one-device mesh.

- GLM (Gaussian, Poisson and Binomial at their canonical links, Poisson
  at the Sqrt link, Gamma at the Log link): both run a fixed 25 float32
  IRLS rounds, so coefficients and predictions agree within 1e-4 of the
  largest (the normal equations' sums and solves round in another order).
- Isotonic (increasing, decreasing, weighted): PAV is float64 numpy in
  both, so boundaries, values and predictions within 1e-12.
- AFT at maxIter 5 (L-BFGS in float32, as tests/test_torch_linear.py):
  coefficients, scale and predictions within 1e-4 (relative).
- Stepwise: the same selected columns in the same order (float64
  least squares in both), then the LinearReg fit's weights within 1e-4 of
  the largest, as tests/test_torch_linear.py holds LinearReg.
- ``PipelineModel`` files of the GeneralizedLinearRegression,
  IsotonicRegression and AftSurvivalRegression stages load and predict
  alike in either package.
"""

import numpy as np
import pytest

import jax

ATOL = 1e-4


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


FEATS = ["x0", "x1", "x2"]


def _cols(seed=0, n=200):
    rng = np.random.default_rng(seed)
    X = rng.normal(scale=0.5, size=(n, 3))
    eta = X @ np.array([0.8, -0.4, 0.3]) + 0.5
    t = np.exp(eta + 0.3 * rng.gumbel(size=n))
    return {"x0": X[:, 0], "x1": X[:, 1], "x2": X[:, 2],
            "gauss": eta + rng.normal(scale=0.2, size=n),
            "count": rng.poisson(np.exp(eta)).astype(np.float64),
            "binary": (rng.random(n) < 1 / (1 + np.exp(-eta))).astype(
                np.float64),
            "gamma": rng.gamma(3.0, np.exp(eta) / 3.0),
            "time": t, "censor": (rng.random(n) < 0.7).astype(np.float64),
            "w": rng.uniform(0.5, 2.0, n),
            "iso": np.round(X[:, 0] * 4) / 4,     # ties on the feature
            "noise": rng.normal(size=n)}


# case -> (op, train params)
CASES = {
    "glm-gaussian": ("Glm", dict(family="Gaussian", labelCol="gauss")),
    "glm-poisson": ("Glm", dict(family="Poisson", labelCol="count")),
    "glm-poisson-sqrt": ("Glm", dict(family="Poisson", link="Sqrt",
                                     labelCol="count")),
    "glm-binomial": ("Glm", dict(family="Binomial", labelCol="binary",
                                 weightCol="w")),
    "glm-gamma": ("Glm", dict(family="Gamma", link="Log", labelCol="gamma",
                              regParam=0.01)),
    "iso-up": ("IsotonicReg", dict(featureCol="iso", labelCol="gauss")),
    "iso-down": ("IsotonicReg", dict(featureCol="iso", labelCol="gauss",
                                     isotonic=False, weightCol="w")),
    "aft": ("AftSurvivalReg", dict(labelCol="time", censorCol="censor",
                                   maxIter=5)),
}


def _run(pkg, case, sid=None):
    import importlib

    ops = importlib.import_module(pkg + ".operator.batch")
    MTable = importlib.import_module(pkg + ".common.mtable").MTable
    name, params = CASES[case]
    env = {} if sid is None else {"MLEnvironmentId": sid}
    feats = {} if name == "IsotonicReg" else {"featureCols": FEATS}
    model = getattr(ops, name + "TrainBatchOp")(**params, **feats, **env) \
        .link_from(ops.TableSourceBatchOp(MTable(_cols()))).collect()
    out = getattr(ops, name + "PredictBatchOp")(predictionCol="p", **env) \
        .link_from(ops.TableSourceBatchOp(model),
                   ops.TableSourceBatchOp(MTable(_cols(seed=1)))).collect()
    return model, np.asarray(out.col("p"), np.float64)


@pytest.mark.parametrize("case", list(CASES))
def test_family_matches_reference(case, sid):
    from alink_tpu.common.model import table_to_model as r_t2m
    from alink_tpu_torch.common.model import table_to_model as p_t2m

    r_model, r_pred = _run("alink_tpu", case, sid)
    p_model, p_pred = _run("alink_tpu_torch", case)
    (rm, ra), (pm, pa) = r_t2m(r_model), p_t2m(p_model)
    iso = case.startswith("iso")
    for k in set(rm) - {"loss", "scale"}:
        assert pm[k] == rm[k], k
    assert sorted(pa) == sorted(ra)
    tol = 1e-12 if iso else ATOL
    for k in ra:
        np.testing.assert_allclose(pa[k], ra[k], rtol=0, err_msg=k,
                                   atol=tol * max(1.0, np.abs(ra[k]).max()))
    if "scale" in rm:
        np.testing.assert_allclose(pm["scale"], rm["scale"], rtol=ATOL)
    np.testing.assert_allclose(p_pred, r_pred, rtol=0,
                               atol=tol * max(1.0, np.abs(r_pred).max()))


def _stepwise(pkg, sid=None):
    import importlib

    ops = importlib.import_module(pkg + ".operator.batch")
    MTable = importlib.import_module(pkg + ".common.mtable").MTable
    env = {} if sid is None else {"MLEnvironmentId": sid}
    model = ops.StepwiseLinearRegTrainBatchOp(
        featureCols=FEATS + ["noise"], labelCol="gauss", **env).link_from(
        ops.TableSourceBatchOp(MTable(_cols()))).collect()
    mod = importlib.import_module(pkg + ".common.model")
    return mod.table_to_model(model)


def test_stepwise_matches_reference(sid):
    rm, ra = _stepwise("alink_tpu", sid)
    pm, pa = _stepwise("alink_tpu_torch")
    assert pm["featureCols"] == rm["featureCols"]
    assert "noise" not in pm["featureCols"] and len(pm["featureCols"]) == 3
    assert pm["linearModelType"] == rm["linearModelType"] == "LinearReg"
    scale = float(np.abs(ra["weights"]).max())
    np.testing.assert_allclose(pa["weights"], ra["weights"], rtol=0,
                               atol=ATOL * scale)
    np.testing.assert_allclose(pa["intercept"], ra["intercept"], rtol=0,
                               atol=ATOL * scale)


STAGES = (("GeneralizedLinearRegression", dict(family="Poisson",
                                               labelCol="count",
                                               featureCols=FEATS), "p1"),
          ("IsotonicRegression", dict(featureCol="x0", labelCol="gauss"),
           "p2"),
          ("AftSurvivalRegression", dict(labelCol="time", censorCol="censor",
                                         featureCols=FEATS), "p3"))


@pytest.mark.parametrize("writer", ["alink_tpu", "alink_tpu_torch"])
def test_pipeline_model_crosses_packages(tmp_path, writer):
    import importlib

    reader = "alink_tpu" if writer == "alink_tpu_torch" else \
        "alink_tpu_torch"
    path = str(tmp_path / "m.ak")

    def table(pkg):
        return importlib.import_module(pkg + ".common.mtable").MTable(
            _cols())

    w_pl = importlib.import_module(writer + ".pipeline")
    model = w_pl.Pipeline(*[getattr(w_pl, n)(predictionCol=c, **p)
                            for n, p, c in STAGES]).fit(table(writer))
    want = model.transform(table(writer)).collect()
    model.save(path)
    loaded = importlib.import_module(reader + ".pipeline").PipelineModel \
        .load(path)
    assert [type(s).__name__ for s in loaded.stages] == \
        ["GlmModel", "IsotonicRegressionModel", "AftSurvivalRegressionModel"]
    got = loaded.transform(table(reader)).collect()
    for _, _, c in STAGES:
        np.testing.assert_allclose(np.asarray(got.col(c), np.float64),
                                   np.asarray(want.col(c), np.float64),
                                   rtol=1e-6, atol=0)
