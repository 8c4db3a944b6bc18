"""The feature-engineering families of the port (``operator/batch/
feature.py``, ``feature2.py``, ``feature3.py``) held against ``alink_tpu``
on the CPU, on data/iris.csv and seeded numpy columns; the reference runs
in a session on a one-device mesh.

Tolerances: the host-side ops are copies of the reference's and must give
the same tables (floats within 1e-12 relative, the rest exactly), except
- PCA's projection: the reference's jitted projection runs in float32, the
  port's on the device in float64, so the projected rows agree within
  1e-6 of the largest |entry|; the model (host eigh) within 1e-12;
- AutoCross: both fit their logistic regressions with float32 L-BFGS,
  summing in other orders, so the AUC gains agree within 1e-4 and the
  chosen crosses are the same.
FeatureHasher's buckets are the reference's exactly (FNV-1a).
"""

import os

import numpy as np
import pytest

from torch_table_parity import (both, remove_session, reference_session,
                                same_model, same_table)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IRIS = os.path.join(REPO, "data", "iris.csv")
FEATS = ["sl", "sw", "pl", "pw"]


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("ALINK_TORCH_DEVICE", "cpu")


@pytest.fixture(scope="module")
def sid():
    sid = reference_session()
    yield sid
    remove_session(sid)


def _iris():
    rows = [line.strip().split(",") for line in open(IRIS) if line.strip()]
    cols = {f: np.asarray([float(r[i]) for r in rows])
            for i, f in enumerate(FEATS)}
    cols["species"] = np.asarray([r[4] for r in rows], object)
    return cols


def _mixed(seed=0, n=120):
    rng = np.random.default_rng(seed)
    return {
        "x": rng.normal(size=n), "y": rng.uniform(-3, 3, n),
        "n": rng.integers(0, 5, n).astype(np.int64),
        "cat": np.asarray(rng.choice(["a", "b", "c", "d"], n), object),
        "tags": np.asarray([",".join(rng.choice(list("pqrst"),
                                                rng.integers(0, 4),
                                                replace=False))
                            for _ in range(n)], object),
        "label": np.asarray(rng.choice(["yes", "no"], n), object),
    }


def _fit_predict(train, predict, train_kw=None, predict_kw=None):
    """An operator builder: train on the source, predict the source."""
    def build(ops, extra, src):
        model = getattr(ops, train)(**(train_kw or {}), **extra) \
            .link_from(src)
        return getattr(ops, predict)(**(predict_kw or {}), **extra) \
            .link_from(model, src)
    return build


def _train(train, **kw):
    def build(ops, extra, src):
        return getattr(ops, train)(**kw, **extra).link_from(src)
    return build


def _map(op, **kw):
    def build(ops, extra, src):
        return getattr(ops, op)(**kw, **extra).link_from(src)
    return build


# ---------------------------------------------------------------------------
# feature.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", [
    ("StandardScaler", dict(selectedCols=FEATS)),
    ("StandardScaler", dict(selectedCols=FEATS, withMean=False)),
    ("MinMaxScaler", dict(selectedCols=FEATS, min=-1.0, max=2.0)),
    ("MaxAbsScaler", dict(selectedCols=FEATS)),
])
def test_scalers_match_reference(sid, case):
    name, kw = case
    cols = _iris()
    ref, port = both(sid, cols, _fit_predict(name + "TrainBatchOp",
                                             name + "PredictBatchOp", kw))
    same_table(port, ref)
    same_model(*both(sid, cols, _train(name + "TrainBatchOp", **kw))[::-1])


def test_vector_assembler_matches_reference(sid):
    cols = _iris()
    ref, port = both(sid, cols, _map("VectorAssemblerBatchOp",
                                     selectedCols=FEATS, outputCol="v"))
    same_table(port, ref)
    # a vector column among the assembled ones
    ref, port = both(sid, cols, lambda ops, x, src: ops.VectorAssemblerBatchOp(
        selectedCols=["sl", "v"], outputCol="w", **x).link_from(
        ops.VectorAssemblerBatchOp(selectedCols=FEATS[1:], outputCol="v",
                                   **x).link_from(src)))
    same_table(port, ref)


# ---------------------------------------------------------------------------
# feature2.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("drop_last", [True, False])
def test_one_hot_matches_reference(sid, drop_last):
    cols = _mixed()
    train = {k: v[:100] for k, v in cols.items()}
    test = {k: v[100:] for k, v in cols.items()}
    test["cat"] = test["cat"].copy()
    test["cat"][:3] = "unseen"

    def build(ops, extra, src, test_src):
        model = ops.OneHotTrainBatchOp(selectedCols=["cat", "n"],
                                       dropLast=drop_last, **extra) \
            .link_from(src)
        return ops.OneHotPredictBatchOp(outputCol="oh", **extra).link_from(
            model, test_src)

    ref, port = both(sid, train, build, test)
    same_table(port, ref)


@pytest.mark.parametrize("calc", ["CORR", "COV"])
def test_pca_matches_reference(sid, calc):
    cols = _iris()
    same_model(*both(sid, cols, _train("PcaTrainBatchOp", k=3,
                                       selectedCols=FEATS,
                                       calculationType=calc))[::-1])
    for kw in (dict(selectedCols=FEATS), dict(vectorCol="v")):
        def build(ops, x, src):
            vec = ops.VectorAssemblerBatchOp(selectedCols=FEATS,
                                             outputCol="v", **x) \
                .link_from(src)
            model = ops.PcaTrainBatchOp(k=3, calculationType=calc, **kw,
                                        **x).link_from(vec)
            return ops.PcaPredictBatchOp(outputCol="p", **x).link_from(
                model, vec)

        ref, port = both(sid, cols, build)
        P = np.stack([v.data for v in port.col("p")])
        R = np.stack([v.data for v in ref.col("p")])
        np.testing.assert_allclose(P, R, rtol=0,
                                   atol=1e-6 * np.abs(R).max())
        assert str(port.schema) == str(ref.schema)
        for name in FEATS + ["species"]:
            assert list(port.col(name)) == list(ref.col(name))


@pytest.mark.parametrize("name", ["QuantileDiscretizer",
                                  "EqualWidthDiscretizer"])
def test_discretizers_match_reference(sid, name):
    cols = _iris()
    ref, port = both(sid, cols, _fit_predict(
        name + "TrainBatchOp", name + "PredictBatchOp",
        dict(selectedCols=FEATS, numBuckets=4)))
    same_table(port, ref)


@pytest.mark.parametrize("method,encode", [("QUANTILE", "WOE"),
                                           ("BUCKET", "INDEX")])
def test_binning_matches_reference(sid, method, encode):
    cols = _mixed(1)
    ref, port = both(sid, cols, _fit_predict(
        "BinningTrainBatchOp", "BinningPredictBatchOp",
        dict(selectedCols=["x", "y"], labelCol="label", numBuckets=5,
             binningMethod=method), dict(encode=encode)))
    same_table(port, ref)


def test_feature_hasher_buckets_equal_reference(sid):
    from alink_tpu.operator.batch.feature2 import _hash32 as r_hash
    from alink_tpu_torch.operator.batch.feature2 import _hash32 as p_hash

    for s in ("", "a", "cat=b", "élan", "x" * 100, "n=3"):
        assert p_hash(s) == r_hash(s)
    cols = _mixed(2)
    for kw in (dict(selectedCols=["x", "cat", "n"], numFeatures=64),
               dict(selectedCols=["x", "cat", "n"], numFeatures=1 << 18,
                    categoricalCols=["cat", "n"])):
        ref, port = both(sid, cols, _map("FeatureHasherBatchOp",
                                         outputCol="h", **kw))
        same_table(port, ref)


def test_chisq_selector_matches_reference(sid):
    cols = _mixed(3)
    cols["z"] = np.asarray((cols["label"] == "yes") * 2 + cols["n"] % 2,
                           np.int64)
    build = _fit_predict("ChiSqSelectorBatchOp", "ChiSqSelectorPredictBatchOp",
                         dict(selectedCols=["n", "cat", "z"],
                              labelCol="label", numTopFeatures=2))
    ref, port = both(sid, cols, build)
    same_table(port, ref)


@pytest.mark.parametrize("inverse", [False, True])
def test_dct_matches_reference(sid, inverse):
    cols = _iris()
    ref, port = both(sid, cols, lambda ops, x, src: ops.DCTBatchOp(
        selectedCol="v", outputCol="d", inverse=inverse, **x).link_from(
        ops.VectorAssemblerBatchOp(selectedCols=FEATS, outputCol="v", **x)
        .link_from(src)))
    same_table(port, ref, rtol=1e-10)


def test_auto_cross_matches_reference(sid):
    from alink_tpu.common.model import table_to_model as r_t2m
    from alink_tpu_torch.common.model import table_to_model as p_t2m

    rng = np.random.default_rng(4)
    n = 400
    a, b, c = (rng.choice(list("uvw"), n) for _ in range(3))
    y = np.where((a == "u") ^ (b == "v"), "pos", "neg")
    flip = rng.random(n) < 0.1
    y = np.where(flip, np.where(y == "pos", "neg", "pos"), y)
    cols = {"a": np.asarray(a, object), "b": np.asarray(b, object),
            "c": np.asarray(c, object), "y": np.asarray(y, object)}
    kw = dict(categoricalCols=["a", "b", "c"], labelCol="y", numCross=2)
    ref_m, port_m = both(sid, cols, _train("AutoCrossBatchOp", **kw))
    (rm, _), (pm, _) = r_t2m(ref_m), p_t2m(port_m)
    assert pm["crosses"] == rm["crosses"] and pm["crosses"]
    assert pm["baseAuc"] == pytest.approx(rm["baseAuc"], abs=1e-4)
    for key, gain in rm["gains"].items():
        assert pm["gains"][key] == pytest.approx(gain, abs=1e-4), key
    ref, port = both(sid, cols, _fit_predict("AutoCrossBatchOp",
                                             "AutoCrossPredictBatchOp", kw))
    same_table(port, ref)


# ---------------------------------------------------------------------------
# feature3.py
# ---------------------------------------------------------------------------

def test_binarizer_and_bucketizer_match_reference(sid):
    cols = _mixed(5)
    ref, port = both(sid, cols, _map("BinarizerBatchOp", selectedCol="x",
                                     outputCol="xb", threshold=0.25))
    same_table(port, ref)
    ref, port = both(sid, cols, _map(
        "BucketizerBatchOp", selectedCols=["x", "y"],
        outputCols=["xb", "yb"], cutsArray=[[-1.0, 0.0, 1.0], [2.0, -2.0]]))
    same_table(port, ref)


def test_multi_hot_matches_reference(sid):
    cols = _mixed(6)
    train = {k: v[:90] for k, v in cols.items()}
    test = {k: v[90:] for k, v in cols.items()}
    test["tags"] = test["tags"].copy()
    test["tags"][0] = "p,zz"

    def build(ops, x, src, test_src):
        model = ops.MultiHotTrainBatchOp(selectedCols=["tags", "cat"],
                                         **x).link_from(src)
        return ops.MultiHotPredictBatchOp(outputCol="mh", **x).link_from(
            model, test_src)

    ref, port = both(sid, train, build, test)
    same_table(port, ref)


@pytest.mark.parametrize("kw", [
    dict(labelCol="label", positiveLabelValueString="yes", smoothing=2.0),
    dict(labelCol="x", selectedCols=["cat", "n"]),
])
def test_target_encoder_matches_reference(sid, kw):
    cols = _mixed(7)
    ref, port = both(sid, cols, _fit_predict(
        "TargetEncoderTrainBatchOp", "TargetEncoderPredictBatchOp",
        dict(kw, **({} if "selectedCols" in kw else
                    {"selectedCols": ["cat", "tags"]}))))
    same_table(port, ref)


def test_exclusive_feature_bundle_matches_reference(sid):
    def build(ops, x, src):
        oh = ops.OneHotPredictBatchOp(outputCol="oh", **x).link_from(
            ops.OneHotTrainBatchOp(selectedCols=["cat", "n"], **x)
            .link_from(src), src)
        model = ops.ExclusiveFeatureBundleTrainBatchOp(selectedCol="oh",
                                                       **x).link_from(oh)
        return ops.ExclusiveFeatureBundlePredictBatchOp(
            outputCol="efb", **x).link_from(model, oh)

    ref, port = both(sid, _mixed(8), build)
    same_table(port, ref)


def test_multi_string_indexer_and_index_to_string_match_reference(sid):
    cols = _mixed(9)

    def build(ops, x, src):
        model = ops.MultiStringIndexerTrainBatchOp(
            selectedCols=["cat", "label"], stringOrderType="FREQUENCY_DESC",
            **x).link_from(src)
        idx = ops.MultiStringIndexerPredictBatchOp(
            selectedCols=["cat", "label"], outputCols=["ci", "li"],
            **x).link_from(model, src)
        return ops.IndexToStringPredictBatchOp(
            selectedCol="li", outputCol="back", modelCol="label",
            **x).link_from(model, idx)

    ref, port = both(sid, cols, build)
    same_table(port, ref)
    assert list(port.col("back")) == list(cols["label"])
