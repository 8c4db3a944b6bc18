"""The clustering breadth of the port (``operator/batch/clustering2.py``)
held against ``alink_tpu`` on the CPU, with inputs made by seeded numpy;
the reference runs in a session on a one-device mesh.

- GaussianMixture at maxIter 5: the same numIters; weights, means and
  covariances within 1e-5 relative of the largest entry, the
  log-likelihood within 1e-6 relative (the reference's EM is float32, the
  port's float64 from the same float32 rows); posteriors within 1e-5,
  components identical.
- The GMM's second moments at a shape where an (n, k, d, d) tensor would
  take 1.2 GiB: the M-step's largest tensor stays under the (k, n, d)
  budget, and the moments equal float64 numpy's within 1e-6 relative.
- On one-hot cells (the Covertype pipeline of chip_smoke.py phase 19.1) the
  EM at PCA(k=20) collapses onto the cells in both packages (NaN in the
  reference's float32) and stays finite and agrees at k=10.
- BisectingKMeans: centroids within 1e-5 of the largest entry, the same
  assignments (the port splits on float64 distances, the reference on
  float32 ones; these blobs sit far from any tie).
- Dbscan, GroupDbscan, GroupGeoDbscan and its model op: labels identical
  (ε is taken on float64 distances in the port; no pair of these rows is
  within float32 rounding of ε).
- LDA: the vocabulary identical, λ within 1e-4 relative, predictions
  identical and their doc-topic details within 1e-6.
- KModes, Agnes (MIN, MAX, AVERAGE), GroupKMeans, GroupEm: identical.
- SOM: unit weights within 1e-5, best-matching units identical.
- A model ``.ak`` written by either package predicts identically in the
  other (GMM, LDA).
"""

import json

import numpy as np
import pytest

import jax


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


def _pkgs(sid):
    """(ops module, MTable, extra params) of the reference, then the port."""
    import alink_tpu.operator.batch as R
    import alink_tpu_torch.operator.batch as P
    from alink_tpu.common.mtable import MTable as RT
    from alink_tpu_torch.common.mtable import MTable as PT

    return ((R, RT, dict(MLEnvironmentId=sid)), (P, PT, {}))


def _blobs(seed=0, n=600, d=4, centres=3, scale=4.0):
    rng = np.random.default_rng(seed)
    C = rng.normal(0, scale, (centres, d))
    X = np.repeat(C, n // centres, 0) + rng.normal(size=(n, d)) \
        * rng.uniform(0.5, 1.5, d)
    return X[rng.permutation(n)]


def _cols(X):
    return {f"f{i}": X[:, i] for i in range(X.shape[1])}


def _train_predict(sid, cols, train, predict, train_kw, predict_kw):
    """Per package: (model table, predict output)."""
    out = []
    for ops, T, extra in _pkgs(sid):
        src = ops.TableSourceBatchOp(T(dict(cols)))
        model = getattr(ops, train)(**train_kw, **extra).link_from(src) \
            .collect()
        pred = getattr(ops, predict)(**predict_kw, **extra).link_from(
            ops.TableSourceBatchOp(model), src).collect()
        out.append((model, pred))
    return out


def _models(ref, port):
    from alink_tpu.common.model import table_to_model as r_t2m
    from alink_tpu_torch.common.model import table_to_model as p_t2m

    return r_t2m(ref), p_t2m(port)


def _close_to_largest(got, want, rel):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * np.abs(want).max())


def _details(col):
    return np.asarray([list(json.loads(s).values()) for s in col])


# ---------------------------------------------------------------------------
# GMM
# ---------------------------------------------------------------------------

def test_gmm_matches_reference(sid):
    X = _blobs(0)
    (rmodel, rpred), (pmodel, ppred) = _train_predict(
        sid, _cols(X), "GmmTrainBatchOp", "GmmPredictBatchOp",
        dict(k=3, maxIter=5), dict(predictionCol="c",
                                   predictionDetailCol="d"))
    (rm, ra), (pm, pa) = _models(rmodel, pmodel)
    for key in ("modelName", "k", "featureCols", "vectorCol", "dim"):
        assert pm[key] == rm[key], key
    assert pm["numIters"] == rm["numIters"] == 5
    for name in ("weights", "means", "covs"):
        _close_to_largest(pa[name], ra[name], 1e-5)
    assert pm["logLikelihood"] == pytest.approx(rm["logLikelihood"],
                                                rel=1e-6)
    np.testing.assert_array_equal(ppred.col("c"), rpred.col("c"))
    np.testing.assert_allclose(_details(ppred.col("d")),
                               _details(rpred.col("d")), rtol=0, atol=1e-5)
    assert str(ppred.schema) == str(rpred.schema)


def test_gmm_stops_where_the_reference_stops(sid):
    """The default tolerance (1e-6 relative on the log-likelihood) ends
    both EMs at the same iteration."""
    X = _blobs(3, n=300, d=3)
    (rmodel, _), (pmodel, _) = _train_predict(
        sid, _cols(X), "GmmTrainBatchOp", "GmmPredictBatchOp",
        dict(k=3, epsilon=1e-4), dict(predictionCol="c"))
    (rm, ra), (pm, pa) = _models(rmodel, pmodel)
    assert pm["numIters"] == rm["numIters"] < 100
    _close_to_largest(pa["means"], ra["means"], 1e-4)


def test_gmm_moments_never_form_n_k_d_d(sid):
    """At n = 20,000, k = 4, d = 64 an (n, k, d, d) float32 tensor takes
    1.2 GiB; the EM step's largest tensor is the (k, n, d) one (20 MiB),
    and its second moments equal float64 numpy's."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    from alink_tpu_torch.operator.batch import clustering2 as c2

    n, k, d = 20_000, 4, 64
    budget = 256 * 2 ** 20
    assert n * k * d * d * 4 > 4 * budget
    rng = np.random.default_rng(0)
    X = rng.normal(size=(n, d)).astype(np.float32)
    r = rng.dirichlet(np.ones(k), n).astype(np.float32)

    class Largest(TorchDispatchMode):
        numel = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for t in (out if isinstance(out, (tuple, list)) else (out,)):
                if isinstance(t, torch.Tensor):
                    Largest.numel = max(Largest.numel, t.numel())
            return out

    Xt, rt = torch.from_numpy(X), torch.from_numpy(r)
    w0, mu0, cov0 = (torch.from_numpy(a)
                     for a in c2._gmm_init(X, k, 0, 1e-6))
    mask = torch.ones(n)
    with Largest():
        nk, sx, sxx = c2._gmm_moments(Xt, rt)
        c2._gmm_step(Xt, mask, w0, mu0, cov0, mask.sum(), 1e-6)
    assert Largest.numel * 4 <= budget
    assert Largest.numel <= k * n * d
    X64, r64 = X.astype(np.float64), r.astype(np.float64)
    want = np.stack([(X64 * r64[:, j, None]).T @ X64 for j in range(k)])
    np.testing.assert_allclose(sxx.numpy(), want, rtol=0,
                               atol=1e-6 * np.abs(want).max())
    _close_to_largest(sx.numpy(), r64.T @ X64, 1e-6)
    np.testing.assert_allclose(nk.numpy(), r64.sum(0), rtol=1e-6)


def _one_hot_cell_block(pca_k, n=20_000):
    """GaussianMixture's input block in chip_smoke.py phase 19.1's
    pipeline on ``n`` seeded Covertype-layout rows, at PCA(k=pca_k)."""
    import chip_smoke
    from alink_tpu_torch.common.mtable import MTable
    from alink_tpu_torch.operator.batch import TableSourceBatchOp
    from alink_tpu_torch.operator.batch import clustering2 as c2

    X, _ = chip_smoke.covertype_data(n + 2_000, 0)
    src = TableSourceBatchOp(MTable(chip_smoke.covertype_categorical(X[:n])))
    kept = []
    undo = chip_smoke.keep_calls(c2, "_gmm_fit", kept)
    old = chip_smoke.FEATURE_PCA_K
    chip_smoke.FEATURE_PCA_K = pca_k
    try:
        chip_smoke.feature_pipeline(**chip_smoke.FEATURE_GMM).fit(src)
    finally:
        chip_smoke.FEATURE_PCA_K = old
        undo()
    (_, block, *_), out = kept[0]
    return block, out


@pytest.mark.parametrize("pca_k", [10, 20])
def test_gmm_on_one_hot_cells_at_pca_k(sid, pca_k):
    """Each (wilderness, soil) cell's rows span at most 10 dimensions, so
    at PCA(k=20) the full covariances collapse onto cells to the 1e-6
    ridge: the reference's float32 EM turns NaN within 5 iterations and
    the port's float64 one reaches the ridge. At k=10 (phase 19.1's) both
    stay finite and agree."""
    from alink_tpu.operator.batch import clustering2 as r2
    from alink_tpu.parallel.mesh import default_mesh

    block, (w, mu, cov, ll, iters, _) = _one_hot_cell_block(pca_k)
    rw, rmu, rcov, rll, riters = r2._gmm_fit(
        default_mesh(jax.devices()[:1]), block, 7, 5, 0.0, 0)
    if pca_k == 20:
        assert not np.isfinite(rll) and riters < 5
        assert np.linalg.eigvalsh(cov.astype(np.float64)).min() < 1e-5
        return
    assert iters == riters == 5 and np.isfinite(ll)
    assert ll == pytest.approx(rll, rel=1e-5)
    _close_to_largest(mu, rmu, 1e-4)
    assert np.linalg.eigvalsh(cov).min() > 1e-5


# ---------------------------------------------------------------------------
# BisectingKMeans, Dbscan
# ---------------------------------------------------------------------------

def test_bisecting_kmeans_matches_reference(sid):
    X = _blobs(1, n=800, d=5, centres=5)
    (rmodel, rpred), (pmodel, ppred) = _train_predict(
        sid, _cols(X), "BisectingKMeansTrainBatchOp",
        "BisectingKMeansPredictBatchOp", dict(k=5, maxIter=20),
        dict(predictionCol="c"))
    (rm, ra), (pm, pa) = _models(rmodel, pmodel)
    assert pm == rm
    _close_to_largest(pa["centroids"], ra["centroids"], 1e-5)
    np.testing.assert_array_equal(ppred.col("c"), rpred.col("c"))


def _label_runs(sid, cols, op, **kw):
    out = []
    for ops, T, extra in _pkgs(sid):
        t = getattr(ops, op)(predictionCol="c", **kw, **extra).link_from(
            ops.TableSourceBatchOp(T(dict(cols)))).collect()
        out.append((np.asarray(t.col("c")), t))
    (ref, rt), (port, pt) = out
    assert str(pt.schema) == str(rt.schema)
    return ref, port


def test_dbscan_matches_reference(sid):
    X = _blobs(2, n=600, d=3, centres=4, scale=6.0)
    X = np.concatenate([X, np.random.default_rng(9).uniform(-20, 20,
                                                             (40, 3))])
    ref, port = _label_runs(sid, _cols(X), "DbscanBatchOp", epsilon=0.9,
                            minPoints=6)
    assert (ref == -1).any() and ref.max() >= 2
    np.testing.assert_array_equal(port, ref)


def test_eps_neighbors_tiles_match_one_tile():
    """Tiles of any height give the neighbour lists one tile gives."""
    from alink_tpu_torch.operator.batch import clustering2 as c2

    X = _blobs(4, n=300, d=3).astype(np.float32)
    whole = c2._eps_neighbors(X, 1.0, block=300, device="cpu")
    for block in (1, 7, 128):
        got = c2._eps_neighbors(X, 1.0, block=block, device="cpu")
        assert len(got) == len(whole)
        for a, b in zip(got, whole):
            np.testing.assert_array_equal(a, b)


def test_group_ops_match_reference(sid):
    rng = np.random.default_rng(5)
    X = _blobs(5, n=360, d=3, centres=3)
    groups = np.asarray(rng.choice(["a", "b", "c"], 360), object)
    cols = dict(_cols(X), g=groups)
    ref, port = _label_runs(sid, cols, "GroupKMeansBatchOp", groupCol="g",
                            k=3)
    np.testing.assert_array_equal(port, ref)
    ref, port = _label_runs(sid, cols, "GroupDbscanBatchOp", groupCol="g",
                            epsilon=1.2, minPoints=4)
    np.testing.assert_array_equal(port, ref)
    ref, port = _label_runs(sid, cols, "GroupEmBatchOp", groupCols=["g"],
                            k=3)
    np.testing.assert_array_equal(port, ref)


def _geo_cols(seed=6):
    rng = np.random.default_rng(seed)
    centres = np.array([[48.85, 2.35], [48.90, 2.50], [40.71, -74.0]])
    pts = np.repeat(centres, 40, 0) + rng.normal(0, 0.01, (120, 2))
    pts = np.concatenate([pts, [[10.0, 10.0], [-30.0, 150.0]]])
    return {"latitude": pts[:, 0], "longitude": pts[:, 1],
            "city": np.asarray(rng.choice(["x", "y"], len(pts)), object)}


def test_group_geo_dbscan_matches_reference(sid):
    from alink_tpu.common.model import table_to_model as r_t2m
    from alink_tpu_torch.common.model import table_to_model as p_t2m

    cols = _geo_cols()
    ref, port = _label_runs(sid, cols, "GroupGeoDbscanBatchOp",
                            groupCols=["city"], epsilon=3.0, minPoints=3)
    assert ref.max() >= 2
    np.testing.assert_array_equal(port, ref)
    models = []
    for ops, T, extra in _pkgs(sid):
        models.append(ops.GroupGeoDbscanModelBatchOp(
            groupCols=["city"], epsilon=3.0, minPoints=3, **extra)
            .link_from(ops.TableSourceBatchOp(T(dict(cols)))).collect())
    (rm, ra), (pm, pa) = r_t2m(models[0]), p_t2m(models[1])
    assert pm == rm
    for name in ("points", "labels", "groups"):
        np.testing.assert_array_equal(pa[name], ra[name])


# ---------------------------------------------------------------------------
# LDA
# ---------------------------------------------------------------------------

def _lda_docs(seed=7, n=80, topics=4, words=40, length=30):
    rng = np.random.default_rng(seed)
    vocab = np.asarray([f"w{i}" for i in range(words)])
    docs = []
    for _ in range(n):
        t = rng.integers(topics)
        own = vocab[t::topics]
        toks = np.where(rng.random(length) < 0.7, rng.choice(own, length),
                        rng.choice(vocab, length))
        docs.append(" ".join(toks))
    docs[3] = None
    return {"doc": np.asarray(docs, object)}


def test_lda_matches_reference(sid, tmp_path):
    cols = _lda_docs()
    (rmodel, rpred), (pmodel, ppred) = _train_predict(
        sid, cols, "LdaTrainBatchOp", "LdaPredictBatchOp",
        dict(selectedCol="doc", topicNum=4, numIter=3, vocabSize=30),
        dict(predictionCol="t", predictionDetailCol="d"))
    (rm, ra), (pm, pa) = _models(rmodel, pmodel)
    assert pm == rm
    np.testing.assert_allclose(pa["topicWord"], ra["topicWord"], rtol=1e-4)
    np.testing.assert_array_equal(ppred.col("t"), rpred.col("t"))
    np.testing.assert_allclose(_details(ppred.col("d")),
                               _details(rpred.col("d")), rtol=0, atol=1e-6)


def test_build_corpus_matches_reference():
    """The doc-term counts and the vocabulary (most common first, ties in
    first-seen order) are the reference's exactly."""
    from alink_tpu.operator.batch import clustering2 as r2
    from alink_tpu_torch.operator.batch import clustering2 as c2

    docs = list(_lda_docs(seed=8, n=50)["doc"]) + ["", "w1 w1 zz"]
    for size in (5, 30, 1000):
        X, vocab = c2._build_corpus(docs, size)
        Xr, vocab_r = r2._build_corpus(docs, size)
        assert vocab == vocab_r
        np.testing.assert_array_equal(X, Xr)
        assert X.dtype == Xr.dtype


@pytest.mark.parametrize("op", ["Gmm", "Lda"])
def test_model_ak_crosses_packages(sid, tmp_path, op):
    """A model ``.ak`` written by either package predicts identically in
    the other."""
    import alink_tpu.operator.batch as R
    import alink_tpu_torch.operator.batch as P
    from alink_tpu.common.mtable import MTable as RT
    from alink_tpu.io.ak import read_ak as r_read
    from alink_tpu.io.ak import write_ak as r_write
    from alink_tpu_torch.common.mtable import MTable as PT
    from alink_tpu_torch.io.ak import read_ak as p_read
    from alink_tpu_torch.io.ak import write_ak as p_write

    if op == "Gmm":
        cols, kw = _cols(_blobs(0)), dict(k=3, maxIter=5)
    else:
        cols, kw = _lda_docs(), dict(selectedCol="doc", topicNum=4,
                                     numIter=2, vocabSize=30)
    (rmodel, _), (pmodel, _) = _train_predict(
        sid, cols, op + "TrainBatchOp", op + "PredictBatchOp", kw,
        dict(predictionCol="c"))
    r_write(str(tmp_path / "ref.ak"), rmodel)
    p_write(str(tmp_path / "port.ak"), pmodel)
    for to_port, to_ref in ((p_read(str(tmp_path / "ref.ak")), rmodel),
                            (pmodel, r_read(str(tmp_path / "port.ak")))):
        got = getattr(P, op + "PredictBatchOp")(predictionCol="c") \
            .link_from(P.TableSourceBatchOp(to_port),
                       P.TableSourceBatchOp(PT(dict(cols)))).collect()
        want = getattr(R, op + "PredictBatchOp")(
            predictionCol="c", MLEnvironmentId=sid).link_from(
            R.TableSourceBatchOp(to_ref),
            R.TableSourceBatchOp(RT(dict(cols)))).collect()
        np.testing.assert_array_equal(got.col("c"), want.col("c"))


# ---------------------------------------------------------------------------
# KModes, Agnes, SOM
# ---------------------------------------------------------------------------

def test_kmodes_matches_reference(sid):
    rng = np.random.default_rng(10)
    cols = {c: np.asarray(rng.choice(list("abcd"), 200, p=p), object)
            for c, p in (("x", [0.7, 0.1, 0.1, 0.1]),
                         ("y", [0.25] * 4), ("z", [0.1, 0.1, 0.1, 0.7]))}
    (rmodel, rpred), (pmodel, ppred) = _train_predict(
        sid, cols, "KModesTrainBatchOp", "KModesPredictBatchOp",
        dict(k=3, randomSeed=2), dict(predictionCol="c"))
    assert _models(rmodel, pmodel)[0] == _models(rmodel, pmodel)[1]
    np.testing.assert_array_equal(ppred.col("c"), rpred.col("c"))


@pytest.mark.parametrize("linkage", ["MIN", "MAX", "AVERAGE"])
def test_agnes_matches_reference(sid, linkage):
    X = _blobs(11, n=60, d=2, centres=3)
    ref, port = _label_runs(sid, _cols(X), "AgnesBatchOp", k=3,
                            linkage=linkage)
    np.testing.assert_array_equal(port, ref)


def test_som_matches_reference(sid):
    X = _blobs(12, n=400, d=3, centres=4)
    (rmodel, rpred), (pmodel, ppred) = _train_predict(
        sid, _cols(X), "SomTrainBatchOp", "SomPredictBatchOp",
        dict(xdim=3, ydim=2, numIters=60), dict(predictionCol="c"))
    (rm, ra), (pm, pa) = _models(rmodel, pmodel)
    assert pm == rm
    _close_to_largest(pa["weights"], ra["weights"], 1e-5)
    np.testing.assert_array_equal(ppred.col("c"), rpred.col("c"))
