"""Model selection of the port (``alink_tpu_torch.pipeline.tuning``) held
against ``alink_tpu`` on the CPU, with inputs made by seeded numpy; the
reference's estimators fit in a session on a one-device mesh.

- Grid, Random and Bayes search, each as CV and as TVSplit: the same
  candidate lists, the same folds (index for index), the same best params,
  and per-candidate scores within the tolerance each metric allows.
  LogisticRegression's AUC, a rank statistic over the fold's detail
  probabilities, within 1e-9 (it came out equal). Ridge's RMSE within
  1e-4 of itself: both packages fit in float32 and their L-BFGS can stop
  at points 1e-4 apart (relative, in the weights) where the loss is flat
  to 2e-7, as tests/test_torch_linear.py allows for the weights; the
  estimators run at maxIter 5, as there.
- ``num_threads=1`` and ``num_threads=2`` give identical reports (exact
  equality) in the port.
- A RandomForestClassifier search, whose forests the tree test holds
  split for split: reports, best params and the refit's predictions
  equal to the reference's.
- ``GaussianProcessRegression`` and ``TreeParzenEstimator`` (pure numpy
  copies) equal to the reference's to 1e-12.
"""

import numpy as np
import pytest

import jax

AUC_ATOL = 1e-9
RMSE_RTOL = 1e-4


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("ALINK_TORCH_DEVICE", "cpu")
    monkeypatch.delenv("ALINK_GBDT_PALLAS", raising=False)


@pytest.fixture(scope="module")
def sid():
    """A reference session on a one-device mesh."""
    from alink_tpu.common.env import MLEnvironment, MLEnvironmentFactory
    from alink_tpu.parallel.mesh import default_mesh

    sid = MLEnvironmentFactory.get_new_environment_id(
        MLEnvironment(mesh=default_mesh(jax.devices()[:1])))
    yield sid
    MLEnvironmentFactory.remove(sid)


def _binary_cols(n=120, seed=2):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 3))
    noisy = X @ np.array([1.0, -2.0, 0.5]) + rng.normal(scale=1.0, size=n)
    cols = {f"f{i}": X[:, i] for i in range(3)}
    cols["y"] = np.where(noisy > 0, "p", "n").astype(object)
    return cols


def _reg_cols(n=120, seed=3):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 2))
    cols = {"x0": X[:, 0], "x1": X[:, 1],
            "y": 2.0 * X[:, 0] - X[:, 1] + rng.normal(scale=0.5, size=n)}
    return cols


# search class -> (space kind, estimator, keyword arguments). The
# reference compiles its optimizer at each fit (about 1 s for LR on this
# CPU), so the LR searches stay small: 2 candidates on 2 folds, 4 on one
# split
KINDS = {
    "GridSearchCV": ("grid", "lr", dict(num_folds=2)),
    "GridSearchTVSplit": ("grid", "ridge", dict(train_ratio=0.75)),
    "RandomSearchCV": ("dist", "ridge", dict(num_candidates=4, num_folds=4)),
    "RandomSearchTVSplit": ("dist", "ridge",
                            dict(num_candidates=4, train_ratio=0.7)),
    "BayesSearchCV": ("range", "ridge", dict(num_candidates=6,
                                             num_initial=3, num_folds=3)),
    "BayesSearchTVSplit": ("range", "lr", dict(num_candidates=4,
                                               num_initial=2,
                                               train_ratio=0.5)),
}


def _search(pkg, kind, sid=None, threads=1):
    """The search ``kind`` in ``pkg`` over its estimator; returns the
    search, the table it ran on and its result."""
    import importlib

    pl = importlib.import_module(pkg + ".pipeline")
    tuning = importlib.import_module(pkg + ".pipeline.tuning")
    MTable = importlib.import_module(pkg + ".common.mtable").MTable
    space, est_kind, kw = KINDS[kind]
    env = {} if sid is None else {"MLEnvironmentId": sid}
    if est_kind == "lr":
        t = MTable(_binary_cols())
        est = pl.LogisticRegression(featureCols=["f0", "f1", "f2"],
                                    labelCol="y", predictionCol="pred",
                                    predictionDetailCol="detail", maxIter=5,
                                    **env)
        ev = tuning.BinaryClassificationTuningEvaluator(
            labelCol="y", predictionDetailCol="detail")
        name, values, lo, hi = "l2", [1e-4, 3.0], 1e-4, 3.0
    else:
        t = MTable(_reg_cols())
        est = pl.Ridge(featureCols=["x0", "x1"], labelCol="y",
                       predictionCol="pred", maxIter=5, **env)
        ev = tuning.RegressionTuningEvaluator(labelCol="y",
                                              predictionCol="pred")
        name, values, lo, hi = "lambda", [1e-3, 1.0, 30.0], 1e-3, 30.0
    if space == "grid":
        sp = tuning.ParamGrid().add_grid(est, name, values)
    elif space == "dist":
        sp = tuning.ParamDist().add_dist(est, name, values)
    else:
        sp = tuning.ParamRange().add_range(est, name, lo, hi, log=True)
    search = getattr(tuning, kind)(est, sp, ev, seed=7, num_threads=threads,
                                   **kw)
    return search, t, search.fit(t)


def _folds(search, t):
    return [(tr.tolist(), te.tolist()) for tr, te in search._splits(t)]


@pytest.mark.parametrize("kind", list(KINDS))
def test_search_matches_reference(kind, sid):
    r_search, r_t, ref = _search("alink_tpu", kind, sid)
    p_search, p_t, port = _search("alink_tpu_torch", kind)
    assert _folds(p_search, p_t) == _folds(r_search, r_t)
    if not kind.startswith("Bayes"):
        cands = [[(type(s).__name__, i.name, v) for s, i, v in c]
                 for c in p_search._candidates()]
        assert cands == [[(type(s).__name__, i.name, v) for s, i, v in c]
                         for c in r_search._candidates()]
    assert [r["params"] for r in port.reports] == \
        [r["params"] for r in ref.reports]
    lr = KINDS[kind][1] == "lr"
    np.testing.assert_allclose([r["score"] for r in port.reports],
                               [r["score"] for r in ref.reports],
                               rtol=0 if lr else RMSE_RTOL,
                               atol=AUC_ATOL if lr else 0)
    assert port.best_params == ref.best_params
    assert [type(s).__name__ for s in port.best_model.stages] == \
        [type(s).__name__ for s in ref.best_model.stages]
    from alink_tpu_torch.pipeline.tuning import Report

    assert Report(port).to_list() == port.reports


@pytest.mark.parametrize("kind", ["GridSearchCV", "RandomSearchCV"])
def test_threads_give_identical_reports(kind):
    _, _, one = _search("alink_tpu_torch", kind, threads=1)
    _, _, two = _search("alink_tpu_torch", kind, threads=2)
    assert two.reports == one.reports
    assert two.best_params == one.best_params


def _forest_cols():
    rng = np.random.default_rng(0)
    X = rng.normal(size=(240, 4))
    y = ((X[:, 0] + 0.5 * X[:, 1] > 0) ^ (X[:, 2] > 1.2)).astype(np.int64)
    return {"a": X[:, 0], "b": X[:, 1], "c": X[:, 2], "d": X[:, 3],
            "label": y}


def _forest_search(pkg, threads):
    import importlib

    pl = importlib.import_module(pkg + ".pipeline")
    tuning = importlib.import_module(pkg + ".pipeline.tuning")
    MTable = importlib.import_module(pkg + ".common.mtable").MTable
    t = MTable(_forest_cols())
    rf = pl.RandomForestClassifier(
        featureCols=["a", "b", "c", "d"], labelCol="label", numTrees=4,
        maxBins=16, minSamplesPerLeaf=5, predictionCol="p",
        predictionDetailCol="pd")
    grid = tuning.ParamGrid().add_grid(rf, "maxDepth", [2, 4])
    ev = tuning.BinaryClassificationTuningEvaluator(
        labelCol="label", predictionDetailCol="pd")
    res = tuning.GridSearchCV(rf, grid, ev, num_folds=3,
                              num_threads=threads).fit(t)
    return res, np.asarray(res.transform(t).collect().col("p"))


def test_forest_search_matches_reference():
    port, port_pred = _forest_search("alink_tpu_torch", 2)
    ref, ref_pred = _forest_search("alink_tpu", 1)
    assert port.reports == ref.reports
    assert port.best_params == ref.best_params
    np.testing.assert_array_equal(port_pred, ref_pred)


def test_surrogates_match_reference():
    from alink_tpu.pipeline import tuning as R
    from alink_tpu_torch.pipeline import tuning as P

    rng = np.random.default_rng(5)
    X, y, Xs = rng.normal(size=(12, 2)), rng.normal(size=12), \
        rng.normal(size=(5, 2))
    got = P.GaussianProcessRegression(0.7, 1e-4).fit(X, y).predict(Xs)
    want = R.GaussianProcessRegression(0.7, 1e-4).fit(X, y).predict(Xs)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    obs = [(float(v), float(s)) for v, s in zip(rng.uniform(1, 9, 8),
                                                 rng.normal(size=8))]
    spec = ("range", 1.0, 9.0, True, False)
    for larger in (True, False):
        p = P.TreeParzenEstimator(seed=4)
        r = R.TreeParzenEstimator(seed=4)
        got = [p.propose(spec, obs, larger) for _ in range(3)]
        want = [r.propose(spec, obs, larger) for _ in range(3)]
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    assert P.TreeParzenEstimator(seed=1).propose(("choice", [1, 2, 3]), []) \
        == R.TreeParzenEstimator(seed=1).propose(("choice", [1, 2, 3]), [])
