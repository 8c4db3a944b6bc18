"""The tree slice of the port (``alink_tpu_torch.tree`` and its operators)
held against ``alink_tpu`` on the CPU, with inputs made by seeded numpy.

- ``histogram_ref`` (the plain version of the CUDA kernel ``tree_histogram``)
  against the JAX kernel ``pallas_histogram`` in interpret mode and against
  the level program's knob-off fallback, a vmapped ``segment_sum``, at the
  shapes of ``tests/test_pallas_hist.py``: exact on integer vals, atol 1e-5
  on normal vals (the reference kernel's contract), out-of-range ids
  included.
- ``train_forest`` against JAX with ``ALINK_GBDT_PALLAS`` at 0 and at 1
  (interpret mode): split features and thresholds identical; leaves and
  ``raw_predict`` within 1e-6 for classification (integer histograms, so
  the splits cannot differ), ``raw_predict`` within 1e-5 for regression
  (real-valued sums taken in another order).
- ``train_gbdt`` against JAX at ``subsample = colsample = 1`` on the data of
  ``tests/test_tree.py``: heaps identical, ``raw_predict`` within 1e-4 (both
  round g and h to bf16; sigmoid/softmax may differ by an ulp between the
  frameworks).
- The operators, port against JAX, and model tables across the two packages
  through ``.ak``: predictions equal, detail probabilities within 1e-6.
"""

import json

import numpy as np
import pytest
import torch

HIST_SHAPES = [(100, 3, 16), (1000, 20, 96), (513, 129, 40)]


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("ALINK_TORCH_DEVICE", "cpu")
    monkeypatch.delenv("ALINK_GBDT_PALLAS", raising=False)


def _hist_inputs(n, d, S, integer, seed=0, oob=False):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, S, (n, d)).astype(np.int32)
    if oob:
        r = rng.random((n, d))
        ids[r < 0.05] = -1
        hi = r > 0.95
        ids[hi] = S + rng.integers(0, 8, int(hi.sum()))
    if integer:
        vals = -rng.integers(0, 4, n).astype(np.float32)
    else:
        vals = rng.normal(size=n).astype(np.float32)
    return ids, vals


def _jax_histograms(ids, vals, S):
    import jax
    import jax.numpy as jnp

    from alink_tpu.tree.pallas_hist import pallas_histogram

    kernel = np.asarray(pallas_histogram(jnp.asarray(ids), jnp.asarray(vals),
                                         num_segments=S, interpret=True))
    fallback = np.asarray(jax.vmap(
        lambda col: jax.ops.segment_sum(jnp.asarray(vals), col,
                                        num_segments=S),
        in_axes=1)(jnp.asarray(ids))).T
    return kernel, fallback


def _check_hist(ids, vals, S, integer):
    from alink_tpu_torch.tree.hist_cuda import histogram_ref

    got = histogram_ref(torch.from_numpy(ids), torch.from_numpy(vals),
                        num_segments=S).numpy()
    for ref in _jax_histograms(ids, vals, S):
        assert got.shape == ref.shape
        if integer:
            np.testing.assert_array_equal(got, ref)
        else:
            np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("n,d,S", HIST_SHAPES)
def test_histogram_ref_matches_jax_kernel(n, d, S, integer):
    _check_hist(*_hist_inputs(n, d, S, integer), S, integer)


@pytest.mark.parametrize("integer", [True, False])
def test_histogram_ref_drops_out_of_range_ids(integer):
    n, d, S = HIST_SHAPES[1]
    ids, vals = _hist_inputs(n, d, S, integer, seed=1, oob=True)
    assert (ids < 0).any() and (ids >= S).any()
    _check_hist(ids, vals, S, integer)


def test_histogram_takes_plain_version_only_for_cpu_tensors(monkeypatch):
    # a tensor off the CPU goes to the kernel, whose failure propagates:
    # nothing falls back to the plain version
    from alink_tpu_torch.native import kernels
    from alink_tpu_torch.tree.hist_cuda import histogram, histogram_ref

    calls = []

    def no_kernel():
        calls.append(1)
        raise RuntimeError("kernel unavailable")

    monkeypatch.setattr(kernels, "ops", no_kernel)
    kernels.reset_launches()
    ids, vals = (torch.from_numpy(a) for a in _hist_inputs(50, 4, 8, True))
    assert torch.equal(histogram(ids, vals, num_segments=8),
                       histogram_ref(ids, vals, num_segments=8))
    assert calls == [] and kernels.launches()["tree_histogram"] == 0
    with pytest.raises(RuntimeError, match="kernel unavailable"):
        histogram(ids.to("meta"), vals.to("meta"), num_segments=8)
    assert calls == [1] and kernels.launches()["tree_histogram"] == 0


def _forest_data(task):
    rng = np.random.default_rng(1)
    X = rng.normal(size=(300, 5)).astype(np.float32)
    if task == "binary":
        y = (X[:, 0] + X[:, 1] ** 2 > 0.5).astype(np.float32)
    elif task == "multiclass":
        y = np.digitize(X[:, 0] + 0.5 * X[:, 2], [-0.5, 0.5]).astype(
            np.float32)
    else:
        y = (2 * X[:, 0] + np.sin(X[:, 1])).astype(np.float32)
    return X, y


@pytest.mark.parametrize("knob", ["0", "1"])
@pytest.mark.parametrize("task", ["binary", "multiclass", "regression"])
def test_forest_matches_jax(monkeypatch, task, knob):
    from alink_tpu.tree import grow as jgrow

    from alink_tpu_torch.tree import train_forest

    X, y = _forest_data(task)
    kw = dict(task=task, num_trees=3, depth=3, num_bins=16, bootstrap=True,
              num_classes=3 if task == "multiclass" else 2, seed=5)
    monkeypatch.setenv("ALINK_GBDT_PALLAS", knob)
    jgrow._level_fn.cache_clear()   # kernels capture the flag at build time
    try:
        ref = jgrow.train_forest(X, y, **kw)
    finally:
        jgrow._level_fn.cache_clear()
    monkeypatch.delenv("ALINK_GBDT_PALLAS")
    got = train_forest(X, y, **kw)
    np.testing.assert_array_equal(got.feats, ref.feats)
    np.testing.assert_array_equal(got.thrs, ref.thrs)
    atol = 1e-5 if task == "regression" else 1e-6
    np.testing.assert_allclose(got.leaves, ref.leaves, rtol=0, atol=atol)
    np.testing.assert_allclose(got.raw_predict(X), ref.raw_predict(X),
                               rtol=0, atol=atol)


def _gbdt_data(task):
    # the data of tests/test_tree.py:32-75
    if task == "binary":
        rng = np.random.RandomState(0)
        X = rng.rand(400, 4)
        y = ((X[:, 0] > 0.5) & (X[:, 1] > 0.3)) | (X[:, 2] < 0.2)
        return X, y.astype(np.float32), dict(num_trees=30, depth=4,
                                             learning_rate=0.2)
    if task == "multiclass":
        rng = np.random.RandomState(1)
        X = rng.rand(300, 3)
        return X, (X[:, 0] * 3).astype(np.int64).astype(np.float32), dict(
            num_trees=20, depth=3, learning_rate=0.3, num_classes=3)
    rng = np.random.RandomState(2)
    X = rng.rand(400, 3)
    y = np.where(X[:, 0] > 0.5, 2.0, -1.0) + X[:, 1]
    return X, y.astype(np.float32), dict(num_trees=50, depth=4,
                                         learning_rate=0.2)


@pytest.mark.parametrize("task", ["binary", "multiclass", "regression"])
def test_gbdt_matches_jax(task):
    from alink_tpu.tree import grow as jgrow

    from alink_tpu_torch.tree import train_gbdt

    X, y, kw = _gbdt_data(task)
    ref = jgrow.train_gbdt(X, y, task=task, **kw)
    got = train_gbdt(X, y, task=task, **kw)
    np.testing.assert_array_equal(got.feats, ref.feats)
    np.testing.assert_array_equal(got.thrs, ref.thrs)
    np.testing.assert_allclose(got.raw_predict(X), ref.raw_predict(X),
                               rtol=0, atol=1e-4)


def _cls_columns(seed=3, n=400):
    rng = np.random.RandomState(seed)
    X = rng.rand(n, 4)
    y = ((X[:, 0] > 0.5) & (X[:, 1] > 0.3)) | (X[:, 2] < 0.2)
    return {"a": X[:, 0], "b": X[:, 1], "c": X[:, 2], "d": X[:, 3],
            "label": y.astype(np.int64)}


def _pipeline(pkg, algo, model_path=None, sink_path=None):
    """Train (or load from ``model_path``) and predict with ``pkg``'s
    operators; returns (predictions, detail probabilities)."""
    import importlib

    MTable = importlib.import_module(pkg + ".common.mtable").MTable
    ops = importlib.import_module(pkg + ".operator.batch")
    src = ops.TableSourceBatchOp(MTable(_cls_columns()))
    if model_path is None:
        train_cls, params = {
            "forest": (ops.RandomForestTrainBatchOp,
                       dict(numTrees=8, maxDepth=5)),
            "gbdt": (ops.GbdtTrainBatchOp,
                     dict(numTrees=10, maxDepth=4, learningRate=0.2)),
        }[algo]
        model = train_cls(labelCol="label", **params).link_from(src)
    else:
        model = ops.AkSourceBatchOp(filePath=model_path)
    if sink_path is not None:
        ops.AkSinkBatchOp(filePath=sink_path).link_from(model).collect()
    pred_cls = {"forest": ops.RandomForestPredictBatchOp,
                "gbdt": ops.GbdtPredictBatchOp}[algo]
    out = pred_cls(predictionCol="p", predictionDetailCol="pd").link_from(
        model, src).collect()
    probs = np.asarray([[json.loads(s)[k] for k in ("0", "1")]
                        for s in out.col("pd")])
    return np.asarray(out.col("p")), probs


@pytest.mark.parametrize("algo", ["forest", "gbdt"])
def test_tree_ops_match_jax(algo):
    pred, probs = _pipeline("alink_tpu_torch", algo)
    ref_pred, ref_probs = _pipeline("alink_tpu", algo)
    np.testing.assert_array_equal(pred, ref_pred)
    np.testing.assert_allclose(probs, ref_probs, rtol=0, atol=1e-6)
    assert np.mean(pred == _cls_columns()["label"]) > 0.9


@pytest.mark.parametrize("writer", ["alink_tpu", "alink_tpu_torch"])
@pytest.mark.parametrize("algo", ["forest", "gbdt"])
def test_ak_tree_models_cross_packages(tmp_path, algo, writer):
    reader = "alink_tpu" if writer == "alink_tpu_torch" else "alink_tpu_torch"
    path = str(tmp_path / f"{algo}.ak")
    pred, probs = _pipeline(writer, algo, sink_path=path)
    other_pred, other_probs = _pipeline(reader, algo, model_path=path)
    np.testing.assert_array_equal(other_pred, pred)
    np.testing.assert_allclose(other_probs, probs, rtol=0, atol=1e-6)


def test_impurity_trees_not_ported():
    from alink_tpu_torch.tree import train_tree_impurity

    with pytest.raises(NotImplementedError, match="ROADMAP A5"):
        train_tree_impurity(np.zeros((4, 2)), np.zeros(4), criterion="gini",
                            num_classes=2)
