"""The KMeans operators of the port (``operator/batch/clustering.py``) held
against ``alink_tpu`` on the CPU, with inputs made by seeded numpy; the
reference runs in a session on a one-device mesh.

- KMeans on each metric (EUCLIDEAN, COSINE, HAVERSINE): the same numIters,
  centroids within 1e-5 of the largest centroid entry (both sum float32
  rows; the port takes the argmin on float64 distances, the reference on
  float32 ones, which hand the same rows to the same centroids on these
  well-separated blobs), inertia within 1e-5 relative, assignments
  identical; the prediction detail's distances within 1e-4 relative (the
  reference's are float32 sums of ~1e2 with their rounding).
- ``KMeansModelInfoBatchOp`` and the GeoKMeans pair.
- A model ``.ak`` written by either package assigns identically in the
  other.
- ``tests/test_golden_parity.py::test_kmeans_separates_blobs`` on the port,
  on its golden values.
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


def _cols(metric, seed=0, n=600):
    rng = np.random.default_rng(seed)
    if metric == "HAVERSINE":
        # four cities' worth of (lat, lon) points, one across the antimeridian
        centres = np.array([[48.0, 2.0], [-33.0, 151.0], [40.0, -74.0],
                            [-17.0, 179.5]])
        X = np.repeat(centres, n // 4, 0) + rng.normal(0, 1.5, (n, 2))
        X[:, 1] = (X[:, 1] + 180.0) % 360.0 - 180.0
    else:
        X = (np.repeat(rng.normal(0, 3, (4, 6)), n // 4, 0)
             + rng.normal(size=(n, 6)))
    return {f"f{i}": X[:, i] for i in range(X.shape[1])}


def _both(cols, sid, train_kw, predict_kw=None, op="KMeans"):
    """(model table, predict output) of each package."""
    import alink_tpu.operator.batch as R
    import alink_tpu_torch.operator.batch as P
    from alink_tpu.common.mtable import MTable as RT
    from alink_tpu_torch.common.mtable import MTable as PT

    out = []
    for ops, T, extra in ((R, RT, dict(MLEnvironmentId=sid)), (P, PT, {})):
        src = ops.TableSourceBatchOp(T(dict(cols)))
        model = getattr(ops, op + "TrainBatchOp")(**train_kw, **extra) \
            .link_from(src).collect()
        pred = getattr(ops, op + "PredictBatchOp")(
            predictionCol="c", predictionDetailCol="d",
            **(predict_kw or {}), **extra).link_from(
            ops.TableSourceBatchOp(model), src).collect()
        out.append((model, pred))
    return out


def _check(ref, port):
    from alink_tpu.common.model import table_to_model as r_t2m
    from alink_tpu_torch.common.model import table_to_model as p_t2m

    (rmodel, rpred), (pmodel, ppred) = ref, port
    (rm, ra), (pm, pa) = r_t2m(rmodel), p_t2m(pmodel)
    for k in ("modelName", "k", "distanceType", "featureCols", "vectorCol",
              "dim", "numIters"):
        assert pm[k] == rm[k], k
    c_ref = ra["centroids"]
    np.testing.assert_allclose(pa["centroids"], c_ref, rtol=0,
                               atol=1e-5 * np.abs(c_ref).max())
    assert pm["inertia"] == pytest.approx(rm["inertia"], rel=1e-5)
    np.testing.assert_array_equal(ppred.col("c"), rpred.col("c"))
    assert str(ppred.schema) == str(rpred.schema)
    d_port = np.asarray([list(json.loads(s).values()) for s in ppred.col("d")])
    d_ref = np.asarray([list(json.loads(s).values()) for s in rpred.col("d")])
    np.testing.assert_allclose(d_port, d_ref, rtol=1e-4,
                               atol=1e-4 * np.abs(d_ref).max())


@pytest.mark.parametrize("metric", ["EUCLIDEAN", "COSINE", "HAVERSINE"])
def test_kmeans_matches_reference(sid, metric):
    ref, port = _both(_cols(metric, seed=1), sid,
                      dict(k=4, maxIter=30, distanceType=metric))
    _check(ref, port)


def test_kmeans_vector_col_and_seed_match_reference(sid):
    """A vector column, another seed and a tolerance that stops the loop
    before the assignments settle."""
    from alink_tpu.common.linalg import DenseVector as RDV
    from alink_tpu_torch.common.linalg import DenseVector as PDV

    X = np.stack(list(_cols("EUCLIDEAN", seed=2).values()), 1)
    import alink_tpu.operator.batch as R
    import alink_tpu_torch.operator.batch as P
    from alink_tpu.common.mtable import MTable as RT
    from alink_tpu_torch.common.mtable import MTable as PT

    outs = []
    for ops, T, DV, extra in ((R, RT, RDV, dict(MLEnvironmentId=sid)),
                              (P, PT, PDV, {})):
        src = ops.TableSourceBatchOp(T({"v": np.asarray(
            [DV(r) for r in X], object)}, "v DENSE_VECTOR"))
        model = ops.KMeansTrainBatchOp(vectorCol="v", k=3, randomSeed=7,
                                       epsilon=0.5, **extra) \
            .link_from(src).collect()
        pred = ops.KMeansPredictBatchOp(predictionCol="c",
                                        predictionDetailCol="d", **extra) \
            .link_from(ops.TableSourceBatchOp(model), src).collect()
        outs.append((model, pred))
    _check(*outs)


def test_model_info_matches_reference(sid):
    import alink_tpu.operator.batch as R
    import alink_tpu_torch.operator.batch as P

    (rmodel, _), (pmodel, _) = _both(_cols("EUCLIDEAN", seed=3), sid,
                                     dict(k=4, maxIter=30))
    ref = R.KMeansModelInfoBatchOp().link_from(
        R.TableSourceBatchOp(rmodel)).collect()
    port = P.KMeansModelInfoBatchOp().link_from(
        P.TableSourceBatchOp(rmodel)).collect()
    assert str(port.schema) == str(ref.schema)
    assert port.to_rows() == ref.to_rows()
    own = P.KMeansModelInfoBatchOp().link_from(
        P.TableSourceBatchOp(pmodel)).collect()
    np.testing.assert_array_equal(own.col("clusterId"), np.arange(4))


def test_geo_kmeans_matches_reference(sid):
    cols = _cols("HAVERSINE", seed=4)
    cols = {"lat": cols["f0"], "lon": cols["f1"]}
    ref, port = _both(cols, sid, dict(k=4, maxIter=30, latitudeCol="lat",
                                      longitudeCol="lon"), op="GeoKMeans")
    _check(ref, port)


def test_model_ak_crosses_packages(sid, tmp_path):
    import alink_tpu.operator.batch as R
    import alink_tpu_torch.operator.batch as P
    from alink_tpu.common.mtable import MTable as RT
    from alink_tpu.io.ak import read_ak as r_read
    from alink_tpu.io.ak import write_ak as r_write
    from alink_tpu_torch.common.mtable import MTable as PT
    from alink_tpu_torch.io.ak import read_ak as p_read
    from alink_tpu_torch.io.ak import write_ak as p_write

    cols = _cols("COSINE", seed=5)
    (rmodel, _), (pmodel, _) = _both(cols, sid, dict(
        k=4, maxIter=30, distanceType="COSINE"))
    r_write(str(tmp_path / "ref.ak"), rmodel)
    p_write(str(tmp_path / "port.ak"), pmodel)
    for to_port, to_ref in ((p_read(str(tmp_path / "ref.ak")), rmodel),
                            (pmodel, r_read(str(tmp_path / "port.ak")))):
        got = P.KMeansPredictBatchOp(predictionCol="c").link_from(
            P.TableSourceBatchOp(to_port),
            P.TableSourceBatchOp(PT(dict(cols)))).collect()
        want = R.KMeansPredictBatchOp(
            predictionCol="c", MLEnvironmentId=sid).link_from(
            R.TableSourceBatchOp(to_ref),
            R.TableSourceBatchOp(RT(dict(cols)))).collect()
        np.testing.assert_array_equal(got.col("c"), want.col("c"))


def test_golden_kmeans_separates_blobs():
    """tests/test_golden_parity.py::test_kmeans_separates_blobs on the port."""
    from alink_tpu_torch.common.mtable import MTable
    from alink_tpu_torch.operator.batch import (KMeansPredictBatchOp,
                                                KMeansTrainBatchOp,
                                                TableSourceBatchOp)

    rng = np.random.default_rng(0)
    a = np.concatenate([rng.normal(0, 0.1, 20), rng.normal(5, 0.1, 20)])
    b = np.concatenate([rng.normal(0, 0.1, 20), rng.normal(5, 0.1, 20)])
    src = TableSourceBatchOp(MTable({"a": a, "b": b}))
    m = KMeansTrainBatchOp(k=2, featureCols=["a", "b"],
                           maxIter=20).link_from(src)
    out = KMeansPredictBatchOp(predictionCol="c").link_from(m, src).collect()
    c = np.asarray(out.col("c"))
    assert len(set(c[:20])) == 1 and len(set(c[20:])) == 1
    assert c[0] != c[20]


def test_argmin_on_float64_distances_is_device_independent():
    """Rows a float32 distance cannot order: integer pixels ~2e6 from two
    centroids whose float64 distances differ by 0.5 (under float32's
    spacing of 0.25 at that size, after three rounded terms). The float64
    argmin picks the nearer centroid whatever the order of the sums."""
    import torch

    from alink_tpu_torch.operator.batch.clustering import _dists

    rng = np.random.default_rng(0)
    x = rng.integers(100, 256, (1, 784)).astype(np.float32)
    c0 = np.full((1, 784), 30.0, np.float32)
    c1 = c0.copy()
    # move one coordinate of c1 so its distance is 0.5 larger
    j = int(np.argmax(x[0]))
    d = x[0, j] - c0[0, j]
    c1[0, j] = c0[0, j] - (np.sqrt(d * d + 0.5) - d)
    c = torch.from_numpy(np.concatenate([c1, c0]))
    exact = ((x.astype(np.float64) - np.concatenate([c1, c0])
              .astype(np.float64)) ** 2).sum(1)
    X64 = torch.from_numpy(x).double()
    for perm in (np.arange(784), np.random.default_rng(1).permutation(784)):
        got = _dists(X64[:, perm], c[:, perm], "EUCLIDEAN")
        assert int(torch.argmin(got, dim=1)) == int(np.argmin(exact))
