"""The impurity trees and the tree-model encoder family of the port
(``tree/grow.py`` ``train_tree_impurity``, ``operator/batch/tree.py``)
held against ``alink_tpu`` on the CPU.

- ``_log2`` bitwise equal to the reference's ``jnp.log2`` (XLA's CPU log).
- ``_split_search_impurity`` over gini, infoGain and infoGainRatio on
  integer count histograms full of ties (few rows, mirrored and repeated
  partitions): the same split for every node.
- ``train_tree_impurity`` unchunked and chunked (the one-hot budget cut so
  that rows stream, as tests/test_tree.py does), with subsample and
  feature_fraction: identical trees (features and thresholds equal), leaf
  probabilities within 1e-6.
- The Cart, C45, Id3 and CartReg ops through both packages: identical
  model arrays (CartReg's leaves within 1e-6, as the forest's regression
  leaves are held in tests/test_torch_tree.py), and the reference tests'
  accuracy floor.
- The encoder family (tests/test_tree.py:158, tests/test_longtail.py:140):
  the port's SparseVectors equal to the reference's, row by row, for every
  encoder trainer.
"""

import numpy as np
import pytest

import jax

LEAF_ATOL = 1e-6
CRITERIA = ("gini", "infoGain", "infoGainRatio")


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("ALINK_TORCH_DEVICE", "cpu")


def test_log2_is_the_reference_log2():
    import jax.numpy as jnp
    import torch

    from alink_tpu_torch.tree.grow import _log2

    rng = np.random.default_rng(0)
    p = [rng.random(200_000).astype(np.float32), np.float32([1e-12, 1.0])]
    for t in (3, 7, 9, 100, 977, 65_537):
        p.append(np.arange(1, t + 1, dtype=np.float32) / np.float32(t))
    p = np.concatenate(p)
    want = np.asarray(jax.jit(jnp.log2)(p))
    got = _log2(torch.from_numpy(p)).numpy()
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("criterion", CRITERIA)
@pytest.mark.parametrize("seed", [0, 1])
def test_split_search_matches_reference(criterion, seed):
    import jax.numpy as jnp
    import torch

    from alink_tpu.tree.grow import _split_search_impurity as ref
    from alink_tpu_torch.tree.grow import _split_search_impurity

    rng = np.random.default_rng(seed)
    L, d, B, K = 64, 7, 12, 3
    hk = rng.integers(0, 4, (L, d, B, K)).astype(np.float32)
    hk *= rng.random((L, d, B, 1)) < 0.4               # empty bins
    hk[:, 1] = hk[:, 0, ::-1]                          # mirrored partitions
    hk[:, 2] = hk[:, 0]                                # repeated features
    fmask = (rng.random(d) < 0.85).astype(np.float32)
    want = jax.jit(lambda h, f: ref(h, f, 2.0, 0.0, criterion))(
        jnp.asarray(hk), jnp.asarray(fmask))
    got = _split_search_impurity(torch.from_numpy(hk),
                                 torch.from_numpy(fmask), 2.0, 0.0, criterion)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _cls_data(n=3000, d=9, K=4, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, d)).astype(np.float32)
    X[:, :3] = np.round(X[:, :3] * 2)                  # discrete columns
    y = ((X[:, 0] + 0.5 * X[:, 1] + 0.7 * rng.standard_normal(n)) > 0) \
        + (X[:, 2] > 1) + (K > 3) * (X[:, 3] > 0.5)
    return X, y.astype(np.int64)


@pytest.mark.parametrize("criterion", CRITERIA)
@pytest.mark.parametrize("route", ["whole", "chunked"])
def test_train_tree_impurity_matches_reference(criterion, route,
                                               monkeypatch):
    import alink_tpu.tree.grow as ref_grow
    import alink_tpu_torch.tree.grow as grow
    from alink_tpu.parallel.mesh import default_mesh

    if route == "chunked":   # 3 chunks in both packages
        budget = 3000 * 9 * 32 // 3
        monkeypatch.setattr(ref_grow, "_HIST_ONEHOT_BUDGET_ELEMS", budget)
        monkeypatch.setattr(grow, "_HIST_ONEHOT_BUDGET_ELEMS", budget)
        ref_grow._impurity_tree_fn.cache_clear()
    X, y = _cls_data()
    for kw in (dict(), dict(subsample=0.8, feature_fraction=0.7, seed=5)):
        kw = dict(criterion=criterion, num_classes=4, depth=7, num_bins=32,
                  min_samples=1.0, **kw)
        want = ref_grow.train_tree_impurity(
            X, y, mesh=default_mesh(jax.devices()[:1]), **kw)
        got = grow.train_tree_impurity(X, y, device="cpu", **kw)
        np.testing.assert_array_equal(got.feats, want.feats)
        np.testing.assert_array_equal(got.thrs, want.thrs)
        np.testing.assert_allclose(got.leaves, want.leaves, atol=LEAF_ATOL,
                                   rtol=0)
        assert got.task == want.task
    if route == "chunked":
        ref_grow._impurity_tree_fn.cache_clear()


def _tables(n=400, seed=3, regression=False):
    from alink_tpu.common.mtable import MTable as RefTable
    from alink_tpu_torch.common.mtable import MTable

    X, y = _cls_data(n, 5, 3, seed)
    cols = {f"f{i}": X[:, i].astype(np.float64) for i in range(5)}
    cols["label"] = (X[:, 0] + 0.3 * X[:, 4]).astype(np.float64) \
        if regression else y
    return RefTable(dict(cols)), MTable(dict(cols)), cols["label"]


OPS = (("Cart", "gini"), ("C45", "infoGainRatio"), ("Id3", "infoGain"),
       ("CartReg", None))


@pytest.mark.parametrize("name,criterion", OPS)
def test_impurity_ops_match_reference(name, criterion):
    import alink_tpu.operator.batch as R
    import alink_tpu_torch.operator.batch as P
    from alink_tpu.common.model import table_to_model as ref_t2m
    from alink_tpu_torch.common.model import table_to_model

    ref_t, port_t, y = _tables(regression=name == "CartReg")
    kw = dict(labelCol="label", maxDepth=5, minSamplesPerLeaf=2)
    models = [getattr(M, f"{name}TrainBatchOp")(**kw).link_from(
        M.TableSourceBatchOp(t)).collect()
        for M, t in ((R, ref_t), (P, port_t))]
    (rmeta, rarr), (pmeta, parr) = ref_t2m(models[0]), table_to_model(
        models[1])
    assert pmeta == rmeta
    if criterion:
        assert pmeta["criterion"] == criterion
    for k in ("feats", "thrs"):
        np.testing.assert_array_equal(parr[k], rarr[k])
    np.testing.assert_allclose(parr["leaves"], rarr["leaves"],
                               atol=LEAF_ATOL, rtol=0)
    pred = getattr(P, f"{name}PredictBatchOp")(predictionCol="p").link_from(
        P.TableSourceBatchOp(models[1]), P.TableSourceBatchOp(port_t)
    ).collect()
    p = np.asarray(pred.col("p"))
    if name == "CartReg":
        assert float(np.mean((p - y) ** 2)) < 0.1 * float(np.var(y))
    else:
        assert float(np.mean(p == y)) > 0.8


ENCODERS = ("GbdtEncoder", "GbdtRegEncoder", "RandomForestEncoder",
            "RandomForestRegEncoder", "DecisionTreeEncoder",
            "DecisionTreeRegEncoder", "C45Encoder", "CartEncoder",
            "CartRegEncoder", "Id3Encoder")


@pytest.mark.parametrize("trainer", ENCODERS)
def test_encoder_family_matches_reference(trainer):
    """The trainer's model (from the reference) encoded by both packages:
    every row's SparseVector equal (dimension, indices, values)."""
    import alink_tpu.operator.batch as R
    import alink_tpu_torch.operator.batch as P

    reg = "Reg" in trainer
    ref_t, port_t, _ = _tables(200, seed=1, regression=reg)
    kw = dict(labelCol="label", maxDepth=3)
    if "Gbdt" in trainer or "RandomForest" in trainer:
        kw["numTrees"] = 4
    model = getattr(R, f"{trainer}TrainBatchOp")(**kw).link_from(
        R.TableSourceBatchOp(ref_t)).collect()
    from alink_tpu_torch.common.mtable import MTable, TableSchema

    port_model = MTable({n: model.col(n) for n in model.schema.names},
                        TableSchema(model.schema.names, model.schema.types))
    op = "GbdtEncoderPredictBatchOp" if trainer == "GbdtEncoder" \
        else "TreeModelEncoderBatchOp"
    outs = [getattr(M, op)(encodeOutputCol="leaf").link_from(
        M.TableSourceBatchOp(m), M.TableSourceBatchOp(t)).collect()
        for M, m, t in ((R, model, ref_t), (P, port_model, port_t))]
    want, got = (list(o.col("leaf")) for o in outs)
    assert len(got) == len(want) == 200
    for a, b in zip(got, want):
        assert a.size() == b.size() and a.size() > 0
        np.testing.assert_array_equal(a.indices, b.indices)
        np.testing.assert_array_equal(a.values, b.values)


def test_gbdt_encoder_leaf_features_on_the_port():
    """tests/test_longtail.py's GbdtEncoderBatchOp case, on the port."""
    from alink_tpu_torch.common.linalg import SparseVector
    from alink_tpu_torch.common.mtable import MTable
    from alink_tpu_torch.operator.batch import (GbdtEncoderBatchOp,
                                                GbdtTrainBatchOp,
                                                TableSourceBatchOp)

    rng = np.random.default_rng(1)
    X = rng.normal(size=(200, 4)).astype(np.float32)
    cols = {f"f{i}": X[:, i].astype(np.float64) for i in range(4)}
    cols["label"] = (X[:, 0] > 0).astype(np.float64)
    t = MTable(cols)
    model = GbdtTrainBatchOp(
        featureCols=[f"f{i}" for i in range(4)], labelCol="label",
        numTrees=5, maxDepth=3).link_from(TableSourceBatchOp(t))
    out = GbdtEncoderBatchOp(encodeOutputCol="leaves").link_from(
        model, TableSourceBatchOp(t)).collect()
    v = out.col("leaves")[0]
    assert isinstance(v, SparseVector)
    assert v.size() == 5 * 8 and len(v.indices) == 5
    va = out.col("leaves")[int(np.argmax(X[:, 0]))]
    vb = out.col("leaves")[int(np.argmin(X[:, 0]))]
    assert set(va.indices.tolist()) != set(vb.indices.tolist())
