"""Parity of the port's online learning and stream evaluation
(``operator/stream/onlinelearning.py``, ``evaluation.py``) with
``alink_tpu`` on the CPU: the cases of ``tests/test_stream.py`` and the
FTRL/OnlineFm cases of ``tests/test_recovery.py``, through both packages on
the same seeded tables.

Tolerances:
- FTRL model snapshots within FTRL_RTOL = 1e-5 of the largest |w| (the port
  takes each row's dot product and sigmoid in float64 and rounds once, the
  reference in float32; the rest is the same float32 arithmetic), meta
  equal;
- OnlineFm and OnlineLearning parameters within FM_RTOL = 1e-5 of the
  largest parameter (the same seeded initial factors; autograd's sums
  against XLA's);
- predictions: labels equal, probabilities within PROB_ATOL = 1e-5;
- the model filter's forwarded models, EvalBinaryClass and Summarizer rows
  equal (the eval's AUC and accuracy within 1e-12: the same host code on
  scores within PROB_ATOL can reorder only at exact ties, none here);
- a restored FTRL stream equals the uninterrupted one bit for bit.
"""

import importlib
import json
import pickle

import numpy as np
import pytest

FTRL_RTOL = 1e-5
FM_RTOL = 1e-5
PROB_ATOL = 1e-5
PACKAGES = ("alink_tpu", "alink_tpu_torch")


@pytest.fixture(scope="module", autouse=True)
def _cpu():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("ALINK_TORCH_DEVICE", "cpu")
        yield


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def _S(pkg):
    return _mod(pkg, "operator.stream")


def _lr_cols(n=600, seed=0, w=(2.0, -3.0), b=0.5):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 2).astype(np.float64)
    logits = X @ np.asarray(w) + b
    y = (1 / (1 + np.exp(-logits)) > rng.rand(n)).astype(np.int64)
    return {"f0": X[:, 0], "f1": X[:, 1], "label": y}


def _table(pkg, cols):
    return _mod(pkg, "common.mtable").MTable(dict(cols))


def _decode(pkg, model):
    return _mod(pkg, "common.model").table_to_model(model)


def _same_linear_models(port, ref, rtol=FTRL_RTOL):
    assert len(port) == len(ref)
    for p, r in zip(port, ref):
        (pm, pa), (rm, ra) = _decode("alink_tpu_torch", p), \
            _decode("alink_tpu", r)
        assert pm == rm
        wr = np.concatenate([ra["weights"].reshape(-1),
                             ra["intercept"].reshape(-1)])
        wp = np.concatenate([pa["weights"].reshape(-1),
                             pa["intercept"].reshape(-1)])
        assert wp.dtype == np.float32
        scale = max(np.abs(wr).max(), 1e-30)
        assert np.abs(wp - wr).max() <= rtol * scale, (
            np.abs(wp - wr).max(), scale)


def _ftrl_models(pkg, cols, chunk=None, num_chunks=10, initial=None,
                 **params):
    S = _S(pkg)
    src = S.TableSourceStreamOp(_table(pkg, cols), numChunks=num_chunks,
                                **({"chunkSize": chunk} if chunk else {}))
    op = S.FtrlTrainStreamOp(initial, **params).link_from(src)
    return list(op._stream())


@pytest.mark.parametrize("params", [
    dict(featureCols=["f0", "f1"], labelCol="label", alpha=0.5,
         modelSaveInterval=5),
    dict(featureCols=["f0", "f1"], labelCol="label", alpha=0.1, beta=0.5,
         l1=0.01, l2=0.02, modelSaveInterval=1),
], ids=["plain", "l1l2"])
def test_ftrl_train_snapshots_match_reference(params):
    cols = _lr_cols(800, seed=1)
    ref = _ftrl_models("alink_tpu", cols, num_chunks=20, **params)
    port = _ftrl_models("alink_tpu_torch", cols, num_chunks=20, **params)
    assert len(port) >= 4
    _same_linear_models(port, ref)


def test_ftrl_ragged_last_chunk_matches_reference():
    """37-row chunks over 400 rows: the last chunk is 30 rows (the
    reference pads it with no-op rows, the port scans it as it is)."""
    cols = _lr_cols(400, seed=6)
    params = dict(featureCols=["f0", "f1"], labelCol="label",
                  modelSaveInterval=1)
    ref = _ftrl_models("alink_tpu", cols, chunk=37, **params)
    port = _ftrl_models("alink_tpu_torch", cols, chunk=37, **params)
    assert len(port) == 11
    _same_linear_models(port, ref)


def _hashed_cols(n=300, dim=50, seed=2):
    rng = np.random.default_rng(seed)
    rows, labels = [], []
    for i in range(n):
        k = int(rng.integers(1, 6))
        idx = rng.choice(dim, size=k, replace=False)
        val = rng.normal(size=k)
        # a duplicated index keeps its last value, as the dense block does
        if i % 17 == 0:
            idx = np.concatenate([idx, idx[:1]])
            val = np.concatenate([val, [0.5]])
        rows.append((idx, val))
        labels.append("c" if val.sum() + rng.normal() * 0.3 > 0 else "n")
    return rows, np.asarray(labels, object)


def _hashed_table(pkg, rows, labels, dim):
    SV = _mod(pkg, "common.linalg").SparseVector
    M = _mod(pkg, "common.mtable")
    vecs = np.asarray([SV(dim, i, v) for i, v in rows], object)
    return M.MTable({"vec": vecs, "label": labels},
                    M.TableSchema(["vec", "label"],
                                  [M.AlinkTypes.SPARSE_VECTOR,
                                   M.AlinkTypes.STRING]))


def test_ftrl_sparse_vector_col_matches_reference():
    rows, labels = _hashed_cols()
    out = {}
    for pkg in PACKAGES:
        S = _S(pkg)
        src = S.TableSourceStreamOp(_hashed_table(pkg, rows, labels, 50),
                                    chunkSize=32)
        op = S.FtrlTrainStreamOp(vectorCol="vec", labelCol="label",
                                 vectorSize=50, alpha=0.2, l1=0.01,
                                 modelSaveInterval=2).link_from(src)
        out[pkg] = list(op._stream())
    _same_linear_models(out["alink_tpu_torch"], out["alink_tpu"])


def test_ftrl_predict_matches_reference():
    cols = _lr_cols(800, seed=1)
    preds = {}
    for pkg in PACKAGES:
        S = _S(pkg)
        train = S.FtrlTrainStreamOp(
            featureCols=["f0", "f1"], labelCol="label", alpha=0.5,
            modelSaveInterval=5,
        ).link_from(S.TableSourceStreamOp(_table(pkg, cols), numChunks=20))
        preds[pkg] = S.FtrlPredictStreamOp(
            predictionCol="p", predictionDetailCol="pd"
        ).link_from(train, S.TableSourceStreamOp(_table(pkg, cols),
                                                 numChunks=20)).collect()
    r, p = preds["alink_tpu"], preds["alink_tpu_torch"]
    assert p.names == r.names and p.num_rows == r.num_rows == 800
    assert list(p.col("p")) == list(r.col("p"))
    for a, b in zip(p.col("pd"), r.col("pd")):
        da, db = json.loads(a), json.loads(b)
        assert da.keys() == db.keys()
        assert all(abs(da[k] - db[k]) <= PROB_ATOL for k in da)
    acc = np.mean(np.asarray(p.col("p")).astype(str)
                  == np.asarray(p.col("label")).astype(str))
    assert acc > 0.8, acc


def _batch_lr(pkg, cols):
    B = _mod(pkg, "operator.batch")
    base = _mod(pkg, "operator.batch.base")
    return B.LogisticRegressionTrainBatchOp(
        featureCols=["f0", "f1"], labelCol="label",
    ).link_from(base.TableSourceBatchOp(_table(pkg, cols))).collect()


def test_ftrl_warm_start_matches_reference():
    """Warm start from the same batch model (the reference's, decoded into
    each package): the first snapshot after one chunk and the last agree."""
    cols = _lr_cols(400, seed=2)
    ref_model = _batch_lr("alink_tpu", cols)
    meta, arrays = _decode("alink_tpu", ref_model)
    out = {}
    for pkg in PACKAGES:
        init = _mod(pkg, "common.model").model_to_table(meta, arrays)
        out[pkg] = _ftrl_models(pkg, cols, num_chunks=10, initial=init,
                                featureCols=["f0", "f1"], labelCol="label",
                                modelSaveInterval=2)
    assert len(out["alink_tpu_torch"]) == 5
    _same_linear_models(out["alink_tpu_torch"], out["alink_tpu"])


def test_ftrl_default_feature_cols_persisted():
    cols = _lr_cols(400, seed=4)
    out = {}
    for pkg in PACKAGES:
        out[pkg] = _ftrl_models(pkg, cols, num_chunks=10, labelCol="label",
                                modelSaveInterval=2)
    meta, _ = _decode("alink_tpu_torch", out["alink_tpu_torch"][-1])
    assert meta["featureCols"] == ["f0", "f1"]
    _same_linear_models(out["alink_tpu_torch"], out["alink_tpu"])


def test_ftrl_single_label_warmup_deferred():
    cols = _lr_cols(200, seed=5)
    order = np.argsort(cols["label"], kind="stable")  # all 0s first
    cols = {k: v[order] for k, v in cols.items()}
    out = {}
    for pkg in PACKAGES:
        out[pkg] = _ftrl_models(pkg, cols, num_chunks=10,
                                featureCols=["f0", "f1"], labelCol="label",
                                modelSaveInterval=1)
    for m in out["alink_tpu_torch"]:
        meta, _ = _decode("alink_tpu_torch", m)
        assert sorted(meta["labels"]) == [0, 1]
    _same_linear_models(out["alink_tpu_torch"], out["alink_tpu"])


def _chunks(t, size):
    return [t.slice(s, min(s + size, t.num_rows))
            for s in range(0, t.num_rows, size)]


class _CrashCut(Exception):
    pass


def _cut_and_restore(make_op, chunks, cut, portable=False):
    """The full stream against one cut at chunk ``cut`` (the snapshot taken
    while the generator is suspended, then killed) and a restore into a
    fresh op; ``portable`` round-trips the snapshot through pickle."""
    full = list(make_op()._stream_impl(iter(chunks)))
    op_a = make_op()
    snap = {}

    def feeder():
        for i, c in enumerate(chunks):
            if i == cut:
                snap["state"] = op_a.state_snapshot()
                raise _CrashCut()
            yield c

    before = []
    try:
        for out in op_a._stream_impl(feeder()):
            before.append(out)
    except _CrashCut:
        pass
    state = snap["state"]
    if portable:
        state = pickle.loads(pickle.dumps(state))
    op_b = make_op()
    op_b.state_restore(state)
    return full, before, list(op_b._stream_impl(iter(chunks[cut:])))


def _model_bytes(models):
    return [tuple(np.asarray(x).tobytes() if isinstance(x, np.ndarray)
                  else x for r in m.rows() for x in r) for m in models]


@pytest.mark.parametrize("portable", [False, True],
                         ids=["in-process", "pickled"])
def test_ftrl_state_roundtrip_bit_identical(portable):
    """FTRL accumulators restore bit-exactly, in the process or through a
    pickled snapshot (host numpy z and n, so a snapshot taken on the card
    restores on the CPU and back)."""
    S = _S("alink_tpu_torch")
    rng = np.random.RandomState(3)
    n = 120
    t = _table("alink_tpu_torch", {
        "x0": rng.rand(n), "x1": rng.rand(n),
        "label": (rng.rand(n) > 0.5).astype(np.int64)})
    full, before, after = _cut_and_restore(
        lambda: S.FtrlTrainStreamOp(featureCols=["x0", "x1"],
                                    labelCol="label", modelSaveInterval=2),
        _chunks(t, 10), cut=5, portable=portable)
    assert len(before) + len(after) == len(full)
    assert _model_bytes(before + after) == _model_bytes(full)


def test_ftrl_snapshot_holds_host_float32():
    S = _S("alink_tpu_torch")
    op = S.FtrlTrainStreamOp(featureCols=["f0", "f1"], labelCol="label")
    t = _table("alink_tpu_torch", _lr_cols(60, seed=9))
    list(op._stream_impl(iter(_chunks(t, 20))))
    snap = op.state_snapshot()
    assert isinstance(snap["z"], np.ndarray) and snap["z"].dtype == np.float32
    assert isinstance(snap["n"], np.ndarray) and snap["n"].shape == (3,)
    assert "scan" not in snap
    # the servable model is the host closed form of the same accumulators
    meta, arrays = _decode("alink_tpu_torch", op.servable_model())
    assert meta["batchNo"] == 3
    last = list(S.FtrlTrainStreamOp(featureCols=["f0", "f1"],
                                    labelCol="label")
                ._stream_impl(iter(_chunks(t, 20))))[-1]
    _, a2 = _decode("alink_tpu_torch", last)
    assert arrays["weights"].tobytes() == a2["weights"].tobytes()


@pytest.mark.parametrize("which", ["ftrl", "fm", "eval"])
def test_global_state_partition_merge_bit_for_bit(which):
    """GlobalElasticStateMixin: the whole blob rides the pinned key group;
    partition → merge into a fresh op reproduces the state exactly, and a
    merge of two non-empty parts is refused."""
    S = _S("alink_tpu_torch")
    exc = _mod("alink_tpu_torch", "common.exceptions")
    t = _table("alink_tpu_torch", _lr_cols(80, seed=3))
    if which == "eval":
        det = np.asarray([json.dumps({"1": float(v), "0": float(1 - v)})
                          for v in np.linspace(0, 1, 80)], object)
        t = _table("alink_tpu_torch", {
            "label": np.asarray(_lr_cols(80, seed=3)["label"]).astype(str)
            .astype(object), "detail": det})

        def make():
            return S.EvalBinaryClassStreamOp(labelCol="label",
                                             predictionDetailCol="detail",
                                             positiveLabelValueString="1")
    elif which == "fm":
        def make():
            return S.OnlineFmTrainStreamOp(featureCols=["f0", "f1"],
                                           labelCol="label", numFactor=3)
    else:
        def make():
            return S.FtrlTrainStreamOp(featureCols=["f0", "f1"],
                                       labelCol="label")
    op = make()
    op.set_key_context(None, 8, pin_group=5)
    list(op._stream_impl(iter(_chunks(t, 20))))
    parts = op.state_partition([(0, 4), (4, 8)])
    assert parts[0] is None and parts[1] is not None
    fresh = make()
    fresh.state_merge(parts)
    assert pickle.dumps(_plain(fresh.state_snapshot())) == \
        pickle.dumps(_plain(op.state_snapshot()))
    with pytest.raises(exc.AkIllegalStateException):
        make().state_merge([parts[1], parts[1]])
    make().state_merge([None, None])  # nothing owned: a no-op


def _plain(state):
    """A snapshot with its RNG reduced to the generator's state dict."""
    out = dict(state)
    if "rng" in out:
        out["rng"] = out["rng"].bit_generator.state
    return out


def _fm_models(pkg, cols, **params):
    S = _S(pkg)
    op = S.OnlineFmTrainStreamOp(**params).link_from(
        S.TableSourceStreamOp(_table(pkg, cols), numChunks=8))
    return list(op._stream())


def test_online_fm_matches_reference():
    cols = _lr_cols(400, seed=7)
    params = dict(featureCols=["f0", "f1"], labelCol="label", numFactor=4,
                  learnRate=0.1, modelSaveInterval=2, randomSeed=3)
    ref = _fm_models("alink_tpu", cols, **params)
    port = _fm_models("alink_tpu_torch", cols, **params)
    assert len(port) == len(ref) == 4
    for p, r in zip(port, ref):
        (pm, pa), (rm, ra) = _decode("alink_tpu_torch", p), \
            _decode("alink_tpu", r)
        assert pm == rm
        for key in ("w0", "w", "V"):
            scale = max(np.abs(ra[key]).max(), 1e-30)
            assert np.abs(pa[key] - ra[key]).max() <= FM_RTOL * scale, key
    # the same numpy-seeded initial factors: the first model's V moved one
    # AdaGrad step from identical draws
    assert _decode("alink_tpu_torch", port[0])[1]["V"].shape == (2, 4)


def test_online_fm_state_roundtrip_continues_rng():
    S = _S("alink_tpu_torch")
    t = _table("alink_tpu_torch", _lr_cols(120, seed=8))
    full, before, after = _cut_and_restore(
        lambda: S.OnlineFmTrainStreamOp(featureCols=["f0", "f1"],
                                        labelCol="label", numFactor=3,
                                        modelSaveInterval=1),
        _chunks(t, 20), cut=3, portable=True)
    assert _model_bytes(before + after) == _model_bytes(full)


def test_online_fm_predict_matches_reference():
    cols = _lr_cols(300, seed=10)
    out = {}
    for pkg in PACKAGES:
        S = _S(pkg)
        models = S.OnlineFmTrainStreamOp(
            featureCols=["f0", "f1"], labelCol="label", numFactor=4,
            modelSaveInterval=2).link_from(
            S.TableSourceStreamOp(_table(pkg, cols), numChunks=6))
        out[pkg] = S.OnlineFmPredictStreamOp(
            predictionCol="p", predictionDetailCol="pd").link_from(
            models, S.TableSourceStreamOp(_table(pkg, cols),
                                          numChunks=6)).collect()
    p, r = out["alink_tpu_torch"], out["alink_tpu"]
    assert p.names == r.names and p.num_rows == r.num_rows
    for a, b in zip(p.col("pd"), r.col("pd")):
        da, db = json.loads(a), json.loads(b)
        assert all(abs(da[k] - db[k]) <= PROB_ATOL for k in da)


@pytest.mark.parametrize("kind", ["lr", "linreg"])
def test_online_learning_matches_reference(kind):
    cols = _lr_cols(400, seed=11)
    if kind == "linreg":
        cols = dict(cols, label=(cols["f0"] * 1.5 - cols["f1"]
                                 + 0.1).astype(np.float64))
    out = {}
    for pkg in PACKAGES:
        B = _mod(pkg, "operator.batch")
        base = _mod(pkg, "operator.batch.base")
        S = _S(pkg)
        trainer = B.LogisticRegressionTrainBatchOp if kind == "lr" \
            else B.LinearRegTrainBatchOp
        model = trainer(featureCols=["f0", "f1"], labelCol="label",
                        maxIter=3).link_from(
            base.TableSourceBatchOp(_table(pkg, cols))).collect()
        out[pkg] = (model, S)
    # both refine the reference's model
    ref_model = out["alink_tpu"][0]
    meta, arrays = _decode("alink_tpu", ref_model)
    got = {}
    for pkg in PACKAGES:
        S = _S(pkg)
        init = _mod(pkg, "common.model").model_to_table(meta, arrays)
        op = S.OnlineLearningStreamOp(learnRate=0.05,
                                      modelSaveInterval=2).link_from(
            S.TableSourceStreamOp(init, numChunks=1),
            S.TableSourceStreamOp(_table(pkg, cols), numChunks=8))
        got[pkg] = list(op._stream())
    assert len(got["alink_tpu_torch"]) == 4
    _same_linear_models(got["alink_tpu_torch"], got["alink_tpu"],
                        rtol=FM_RTOL)


def test_model_filter_matches_reference():
    cols = _lr_cols(600, seed=3)
    out = {}
    for pkg in PACKAGES:
        S = _S(pkg)
        train = S.FtrlTrainStreamOp(
            featureCols=["f0", "f1"], labelCol="label", modelSaveInterval=3,
        ).link_from(S.TableSourceStreamOp(_table(pkg, cols), numChunks=15))
        filt = S.BinaryClassModelFilterStreamOp(
            labelCol="label", accuracyThreshold=0.6,
        ).link_from(train, S.TableSourceStreamOp(_table(pkg, cols),
                                                 numChunks=15))
        out[pkg] = list(filt._stream())
    assert len(out["alink_tpu_torch"]) >= 1
    _same_linear_models(out["alink_tpu_torch"], out["alink_tpu"])


def _eval_cols(n=200, seed=5):
    rng = np.random.RandomState(seed)
    y = (rng.rand(n) > 0.5).astype(np.int64)
    s = np.clip(y * 0.6 + rng.rand(n) * 0.4, 0, 1)
    return {"label": y.astype(object).astype(str),
            "detail": np.asarray([json.dumps({"1": float(v),
                                              "0": float(1 - v)})
                                  for v in s], object)}


def _same_rows(p, r):
    assert p.names == r.names
    assert [tuple(x) for x in p.rows()] == [tuple(x) for x in r.rows()]


def test_eval_binary_class_rows_equal():
    cols = _eval_cols()
    out = {}
    for pkg in PACKAGES:
        S = _S(pkg)
        out[pkg] = S.EvalBinaryClassStreamOp(
            labelCol="label", predictionDetailCol="detail",
            positiveLabelValueString="1").link_from(
            S.TableSourceStreamOp(_table(pkg, cols), numChunks=8)).collect()
    _same_rows(out["alink_tpu_torch"], out["alink_tpu"])
    last = json.loads(out["alink_tpu_torch"].col("Data")[-1])
    assert last["Count"] == 200 and 0.5 < last["AUC"] <= 1.0


def test_eval_on_ftrl_predictions_matches_reference():
    cols = _lr_cols(600, seed=3)
    out = {}
    for pkg in PACKAGES:
        S = _S(pkg)
        pred = S.FtrlPredictStreamOp(
            predictionCol="p", predictionDetailCol="pd").link_from(
            S.FtrlTrainStreamOp(featureCols=["f0", "f1"], labelCol="label",
                                modelSaveInterval=3).link_from(
                S.TableSourceStreamOp(_table(pkg, cols), numChunks=15)),
            S.TableSourceStreamOp(_table(pkg, cols), numChunks=15))
        out[pkg] = S.EvalBinaryClassStreamOp(
            labelCol="label", predictionDetailCol="pd",
            positiveLabelValueString="1").link_from(pred).collect()
    p, r = out["alink_tpu_torch"], out["alink_tpu"]
    assert list(p.col("Statistics")) == list(r.col("Statistics"))
    for a, b in zip(p.col("Data"), r.col("Data")):
        da, db = json.loads(a), json.loads(b)
        assert da["Count"] == db["Count"]
        assert abs(da["Accuracy"] - db["Accuracy"]) <= 1e-12
        assert abs(da["AUC"] - db["AUC"]) <= 1e-12 or \
            (np.isnan(da["AUC"]) and np.isnan(db["AUC"]))


def test_eval_cumulative_state_roundtrip():
    S = _S("alink_tpu_torch")
    t = _table("alink_tpu_torch", _eval_cols(40))
    full, before, after = _cut_and_restore(
        lambda: S.EvalBinaryClassStreamOp(labelCol="label",
                                          predictionDetailCol="detail",
                                          positiveLabelValueString="1"),
        _chunks(t, 5), cut=4)
    rows = [tuple(r) for m in before + after for r in m.rows()]
    assert rows == [tuple(r) for m in full for r in m.rows()]


def test_summarizer_rows_equal():
    rng = np.random.RandomState(2)
    cols = {"a": rng.rand(50), "b": np.where(rng.rand(50) > 0.8, np.nan,
                                             rng.rand(50)),
            "s": np.asarray([None if i % 7 == 0 else f"x{i}"
                             for i in range(50)], object)}
    out = {}
    for pkg in PACKAGES:
        S = _S(pkg)
        out[pkg] = S.SummarizerStreamOp().link_from(
            S.TableSourceStreamOp(_table(pkg, cols), numChunks=5)).collect()
    p, r = out["alink_tpu_torch"], out["alink_tpu"]
    assert p.names == r.names and str(p.schema) == str(r.schema)
    for a, b in zip(p.rows(), r.rows()):
        for x, y in zip(a, b):
            if isinstance(x, float):
                assert (np.isnan(x) and np.isnan(y)) or x == y
            else:
                assert x == y
