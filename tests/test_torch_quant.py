"""The serving precision policies of the port (``common/quant.py`` and the
BERT, linear and tree mappers under ``inferencePrecision``) held against
``alink_tpu`` on the CPU.

- The host quantizers (``quantize_per_channel``, ``quantize_last_axis``,
  ``quantize_tree``) and ``bf16_round`` bitwise equal to the reference's
  (NaN as NaN).
- The calibration capture, ``degenerate_sites`` and
  ``accuracy_band_report`` give the reference's results on the reference's
  own cases (tests/test_quant.py).
- The int8 linear score: the int32 accumulators equal to the reference's
  ``dot_general``; the scores within 1e-6 relative (the rescale is one fp32
  multiply-add, which XLA may fuse).
- The int8 tree predict: routing identical to fp32 (leaf ids equal), scores
  equal to the reference's int8 program within 1e-6.
- Tiny BERT (data/bert_tiny_sst, fp32 compute) under ``predict_model`` at
  bf16 and int8: the int8 weights and scales leaf by leaf bitwise equal to
  the reference's ``quantize_tree``; logits within LOGIT_ATOL = 1e-4 of the
  reference's ``predict_model`` (ALINK_ATTN_PALLAS=0 around its call), and
  each policy's own effect on the logits well above that gap, so a policy
  served as fp32 fails.
- The linear (Softmax) and tree (GBDT) predict ops with stamped
  ``inferencePrecision``, ``quantCalib`` and ``quantSite`` through both
  packages: the same calibration record, the same predictions, detail
  probabilities within 1e-5.
"""

import json
import os
import threading

import numpy as np
import pytest

import jax

LOGIT_ATOL = 1e-4
PROB_ATOL = 1e-5


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("ALINK_TORCH_DEVICE", "cpu")
    monkeypatch.delenv("ALINK_ATTN_PALLAS", raising=False)


def _both():
    from alink_tpu.common import quant as ref
    from alink_tpu_torch.common import quant as port

    return ref, port


def _bits_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    if a.dtype.kind == "f":
        nan = np.isnan(a)
        assert np.array_equal(nan, np.isnan(b))
        a, b = np.where(nan, 0, a), np.where(nan, 0, b)
        assert np.array_equal(a.view(f"u{a.itemsize}"),
                              b.view(f"u{b.itemsize}"))
    else:
        assert np.array_equal(a, b)


# ---------------------------------------------------------------------------
# host quantizers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape,axis", [((16, 5), -1), ((16, 5), 0),
                                        ((3, 4, 6), -1), ((3, 4, 6), 1),
                                        ((7,), -1)])
def test_quantize_per_channel_bitwise(shape, axis):
    ref, port = _both()
    w = np.random.default_rng(1).normal(0, 3, shape).astype(np.float32)
    w.reshape(-1)[::5] = 0.0
    if len(shape) > 1:
        np.moveaxis(w, axis, 0)[0] = 0.0           # an all-zero channel
    for r, p in zip(ref.quantize_per_channel(w, axis),
                    port.quantize_per_channel(w, axis)):
        _bits_equal(p, r)


def test_quantize_last_axis_and_tree_bitwise():
    ref, port = _both()
    rng = np.random.default_rng(2)
    leaves = rng.normal(0, 1, (3, 2, 8)).astype(np.float32)
    leaves[1, 0] = 0.0
    for r, p in zip(ref.quantize_last_axis(leaves),
                    port.quantize_last_axis(leaves)):
        _bits_equal(p, r)
    tree = {"params": {"a": {"kernel": rng.normal(0, 1, (5, 3, 4)).astype(
        np.float32), "bias": rng.normal(0, 1, 4).astype(np.float32)},
        "emb": {"embedding": rng.normal(0, 1, (9, 4)).astype(np.float32)}},
        "steps": np.arange(3, dtype=np.int64)}
    rq, rs = ref.quantize_tree(tree)
    pq, ps = port.quantize_tree(tree)
    flat = jax.tree_util.tree_flatten_with_path
    assert [k for k, _ in flat(rq)[0]] == [k for k, _ in flat(pq)[0]]
    for (_, a), (_, b) in zip(flat(rq)[0], flat(pq)[0]):
        _bits_equal(b, a)
    for path in (("params", "a", "kernel"), ("params", "emb", "embedding")):
        r, p = rs, ps
        for k in path:
            r, p = r[k], p[k]
        _bits_equal(p, r)
    assert ps["params"]["a"]["bias"] is None and ps["steps"] is None


def test_bf16_round_bitwise():
    """Round to nearest even through bfloat16: ties both ways, subnormals,
    the overflow to inf, infinities and NaN."""
    ref, port = _both()
    rng = np.random.default_rng(3)
    x = np.concatenate([
        rng.normal(0, 1, 4096).astype(np.float32),
        rng.normal(0, 1e30, 512).astype(np.float32),
        (rng.integers(0, 2 ** 32, 4096, dtype=np.uint64).astype(np.uint32)
         .view(np.float32)),
        np.array([0x3F808000, 0x3F818000, 0x3F80C000, 0x00008000, 0x00018000,
                  0x7F7FFFFF, 0x80000001], np.uint32).view(np.float32),
        np.array([np.inf, -np.inf, np.nan, -0.0, 0.0], np.float32)])
    _bits_equal(port.bf16_round(x), ref.bf16_round(x))


# ---------------------------------------------------------------------------
# calibration and the accuracy band: the reference's own cases, both packages
# ---------------------------------------------------------------------------


def _calibration_cases(q):
    rec = {}
    with q.calibration(rec):
        assert q.capturing()
        q.observe("s", np.array([1.0, -3.0]))
        q.observe("s", np.array([2.0]))
        q.observe("t", np.zeros(0))
        q.observe("u", np.array([np.inf]))
        th = threading.Thread(target=lambda: q.observe("x", np.array([4.5])))
        th.start()
        th.join()
    q.observe("s", np.array([99.0]))          # outside: a no-op
    return rec, q.capturing()


def test_calibration_capture_matches_reference():
    ref, port = _both()
    assert _calibration_cases(port) == _calibration_cases(ref) == (
        {"s": 3.0, "t": 0.0, "u": float("inf"), "x": 4.5}, False)


def test_policy_parsing_and_degenerate_sites_match_reference():
    from alink_tpu.common.exceptions import AkIllegalStateException as RefErr
    from alink_tpu_torch.common.exceptions import AkIllegalStateException

    ref, port = _both()
    for p in (None, "", "fp32", "INT8", "bf16"):
        assert port.resolve_policy(p) == ref.resolve_policy(p)
    for calib in ({"a": 1.0, "b": 0.0, "c": float("inf")}, {}, None):
        assert port.degenerate_sites(calib) == ref.degenerate_sites(calib)
    with pytest.raises(AkIllegalStateException):
        port.calib_scale(None, "m:op0.x")
    with pytest.raises(RefErr):
        ref.calib_scale(None, "m:op0.x")


def test_accuracy_band_report_matches_reference():
    ref, port = _both()
    types = ["DOUBLE", "STRING", "STRING"]
    base = [(1.0, "pos", '{"p": 0.9}'), (2.0, "neg", '{"p": 0.1}')]
    for cand, band, tol in (
            ([(1.004, "pos", '{"p": 0.91}'), (2.0, "neg", '{"p": 0.1}')],
             0.0, 0.01),
            ([(1.0, "neg", "{}"), (2.0, "neg", "{}")], 0.0, 0.01),
            ([(1.5, "pos", "{}"), (2.0, "neg", "{}")], 0.0, 0.01),
            ([(1.0, "neg", "{}"), (2.0, "neg", "{}")], 0.5, 0.01)):
        assert port.accuracy_band_report(base, cand, types, band=band,
                                         tol=tol) == \
            ref.accuracy_band_report(base, cand, types, band=band, tol=tol)


# ---------------------------------------------------------------------------
# the int8 programs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("K", [0, 1, 3, 10])
def test_int8_linear_score_accumulators_equal(K):
    """K = 0 is binary LR's 1-D weight vector."""
    import jax.numpy as jnp
    import torch

    from alink_tpu.common.quant import _build_int8_linear_score

    ref, port = _both()
    rng = np.random.default_rng(K)
    n, d = 37, 19
    X = (rng.normal(0, 2, (n, d)) * (rng.random((n, d)) < 0.7)).astype(
        np.float32)
    X[0, :4] = [2.5, -2.5, 3.5, 0.5]          # halves: round to even
    w = rng.normal(0, 1, (d, K) if K else d).astype(np.float32)
    b = rng.normal(0, 1, K if K else ()).astype(np.float32)
    wq, sw = ref.quantize_per_channel(w)
    sx = np.float32(float(np.abs(X).max()) * 0.8 / 127.0)   # some clip
    xq = np.array(ref._quantize_act(jnp, jnp.asarray(X), sx))
    want_acc = np.asarray(ref._int8_matmul(jax, jnp, xq, wq))
    want = np.asarray(_build_int8_linear_score()(X, wq, b, sw, sx))
    t = torch.as_tensor
    sx_t = t(sx)
    _bits_equal(port.quantize_act(t(X), sx_t).numpy(), xq)
    acc = port.int8_matmul(port.quantize_act(t(X), sx_t),
                           t(wq if K else wq[:, None].copy()))
    assert acc.dtype == torch.int32
    np.testing.assert_array_equal(acc.numpy(),
                                  want_acc if K else want_acc[:, None])
    got = port.int8_linear_score(t(X), t(wq), t(b), t(sw), sx_t)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def _gbdt(task="multiclass", K=3, seed=0):
    from alink_tpu.parallel.mesh import default_mesh
    from alink_tpu.tree import train_gbdt

    rng = np.random.default_rng(seed)
    X = rng.normal(0, 1, (600, 6)).astype(np.float32)
    y = (np.digitize(X[:, 0] + 0.5 * X[:, 1], [-0.5, 0.5]) if K > 2
         else (X[:, 0] > 0)).astype(np.float32)
    ens = train_gbdt(X, y, task=task, num_trees=6, depth=4, num_classes=K,
                     mesh=default_mesh(jax.devices()[:1]))
    return ens, X


@pytest.mark.parametrize("policy", ["bf16", "int8"])
def test_tree_predict_policies_match_reference(policy):
    from alink_tpu_torch.tree.grow import TreeEnsemble

    ens, X = _gbdt()
    port = TreeEnsemble(ens.depth, ens.feats, ens.thrs, ens.leaves,
                        ens.base_score, ens.task)
    want = ens.raw_predict(X, precision=policy)
    got = port.raw_predict(X, precision=policy, device="cpu")
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    fp32 = port.raw_predict(X, device="cpu")
    assert np.abs(got - fp32).max() > 1e-5     # the policy took effect
    if policy == "int8":
        # routing is fp32's: the scores are the dequantized leaves of the
        # fp32 traversal's leaf ids
        from alink_tpu.common.quant import quantize_last_axis

        lq, ls = quantize_last_axis(ens.leaves)
        deq = lq.astype(np.float32) * ls[..., None]
        ids = port.leaf_ids(X, device="cpu")                    # (n, T)
        T, K = deq.shape[:2]
        picked = deq[np.arange(T)[None, :, None], np.arange(K)[None, None, :],
                     ids[:, :, None]]                           # (n, T, K)
        np.testing.assert_allclose(got, picked.sum(1) + ens.base_score,
                                   rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# tiny BERT under predict_model
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny_bert():
    """data/bert_tiny_sst grafted into both packages' encoders (fp32
    compute, cls pooling, 2 labels, the head from the reference's init),
    and 24 rows of sst2_mini text."""
    import csv

    import jax.numpy as jnp
    import torch

    from alink_tpu.dl.modules import BertConfig as RefConfig
    from alink_tpu.dl.modules import TransformerEncoder as RefEncoder
    from alink_tpu.dl.pretrained import (init_from_pretrained,
                                         load_bert_checkpoint)
    from alink_tpu_torch.dl.convert import flax_to_torch
    from alink_tpu_torch.dl.data import data_path
    from alink_tpu_torch.dl.modules import BertConfig, TransformerEncoder
    from alink_tpu_torch.dl.pretrained import load_vocab_file
    from alink_tpu_torch.dl.tokenizer import Tokenizer

    path = data_path("bert_tiny_sst")
    cfg, sub = load_bert_checkpoint(path)
    lower = cfg.pop("do_lower_case")
    kw = dict(cfg, num_labels=2, pool="cls", dropout=0.0)
    ref_model = RefEncoder(RefConfig(dtype=jnp.float32, **kw))
    tok = Tokenizer.from_list(load_vocab_file(path), lower)
    with open(data_path("sst2_mini.csv"), newline="") as f:
        texts = [t for t, _ in csv.reader(f)][:24]
    enc = tok.encode_batch(texts, max_len=cfg["max_position"])
    sample = {k: v[:1] for k, v in enc.items()}
    params = jax.tree_util.tree_map(
        np.asarray, init_from_pretrained(ref_model, None, sub, sample))
    model = TransformerEncoder(BertConfig(dtype=torch.float32, **kw))
    model.load_state_dict(flax_to_torch(params))
    return ref_model, params, model, enc


def _ref_predict(ref_model, params, enc, precision):
    from alink_tpu.dl.train import predict_model
    from alink_tpu.parallel.mesh import default_mesh

    os.environ["ALINK_ATTN_PALLAS"] = "0"
    try:
        return predict_model(ref_model, params, enc, precision=precision,
                             mesh=default_mesh(jax.devices()[:1]))
    finally:
        del os.environ["ALINK_ATTN_PALLAS"]


def test_bert_int8_weights_and_scales_equal_reference(tiny_bert):
    """The served int8 state, carried back to the flax layout, leaf by leaf
    bitwise: q against the reference's q, and each scale (broadcast over
    its weight) against the reference's per-last-axis scale. The qkv
    kernel's (hidden, 3, h·d) → (3·h·d, hidden) carry is where a scale on
    the wrong axis would show."""
    import torch

    from alink_tpu.common.quant import quantize_tree
    from alink_tpu_torch.dl.convert import torch_to_flax
    from alink_tpu_torch.dl.train import _int8_state

    _, params, model, _ = tiny_bert
    rq, rs = quantize_tree(params)
    state = _int8_state(model)
    q_tree = torch_to_flax({k: q for k, (q, _) in state.items()}, model.cfg)
    s_tree = torch_to_flax(
        {k: (torch.zeros(q.shape) if s is None
             else torch.broadcast_to(s, q.shape)) for k, (q, s)
         in state.items()}, model.cfg)
    flat = dict(jax.tree_util.tree_flatten_with_path(rq)[0])
    flat_s = dict(jax.tree_util.tree_flatten_with_path(
        rs, is_leaf=lambda x: x is None)[0])
    got_q = dict(jax.tree_util.tree_flatten_with_path(q_tree)[0])
    got_s = dict(jax.tree_util.tree_flatten_with_path(s_tree)[0])
    assert sorted(map(str, got_q)) == sorted(map(str, flat))
    n_quant = 0
    for path, want in flat.items():
        _bits_equal(got_q[path], np.asarray(want))
        if flat_s[path] is not None:
            n_quant += 1
            _bits_equal(got_s[path],
                        np.broadcast_to(flat_s[path], want.shape).copy())
    assert n_quant >= 10 and any(s is not None and s.ndim == 2 for s in (
        v for _, v in state.values()))


@pytest.mark.parametrize("policy", ["bf16", "int8"])
def test_bert_predict_model_policies_match_reference(tiny_bert, policy):
    from alink_tpu_torch.dl.train import predict_model

    ref_model, params, model, enc = tiny_bert
    want = _ref_predict(ref_model, params, enc, policy)
    want_fp32 = _ref_predict(ref_model, params, enc, None)
    got = predict_model(model, enc, device="cpu", precision=policy,
                        batch_size=16)
    gap = float(np.abs(got - want).max())
    effect = float(np.abs(want - want_fp32).max())
    assert gap <= LOGIT_ATOL, gap
    assert effect > 10 * LOGIT_ATOL, effect
    # the served state is built once and kept while the weights stand
    served = model._served_states[policy]
    predict_model(model, enc, device="cpu", precision="int8" if policy
                  == "bf16" else "bf16")
    again = predict_model(model, enc, device="cpu", precision=policy,
                          batch_size=16)
    assert model._served_states[policy] is served
    np.testing.assert_array_equal(again, got)


# ---------------------------------------------------------------------------
# the predict ops with stamped policy params, both packages
# ---------------------------------------------------------------------------


def _tables(pkg, cols, schema):
    import importlib

    mt = importlib.import_module(f"{pkg}.common.mtable")
    return mt.MTable(dict(cols), schema)


def _port_table(ref_table):
    from alink_tpu_torch.common.mtable import MTable

    return MTable({n: ref_table.col(n) for n in ref_table.schema.names},
                  ", ".join(f"{n} {t.lower()}" for n, t in zip(
                      ref_table.schema.names, ref_table.schema.types)))


def test_int8_chunked_linear_route_scores_fp32(monkeypatch):
    """Blocks of STREAM_THRESHOLD_BYTES or more take the chunked route,
    which scores fp32 under int8 in both packages (the W8A8 product is the
    single push's only): with the threshold lowered, the port's int8
    scores equal its fp32 scores exactly and the reference's int8 scores
    within PROB_ATOL; at the default threshold int8 differs from fp32."""
    import importlib

    from alink_tpu.operator.batch import (SoftmaxTrainBatchOp,
                                          TableSourceBatchOp)

    rng = np.random.default_rng(5)
    n, d = 240, 6
    X = rng.normal(0, 1, (n, d))
    y = np.digitize(X @ rng.normal(0, 1, d), [-0.7, 0.7]).astype(np.int64)
    cols = {f"f{i}": X[:, i] for i in range(d)}
    cols["label"] = y
    schema = ", ".join([f"f{i} double" for i in range(d)] + ["label long"])
    ref_data = _tables("alink_tpu", cols, schema)
    ref_model = SoftmaxTrainBatchOp(
        featureCols=[f"f{i}" for i in range(d)], labelCol="label",
        maxIter=20).link_from(TableSourceBatchOp(ref_data)).collect()
    port_model, port_data = _port_table(ref_model), _port_table(ref_data)
    site = "m:op0"

    def serve(pkg, extra):
        B = importlib.import_module(f"{pkg}.operator.batch")
        model, data = (ref_model, ref_data) if pkg == "alink_tpu" \
            else (port_model, port_data)
        t = B.SoftmaxPredictBatchOp(
            predictionCol="pred", predictionDetailCol="detail",
            **extra).link_from(B.TableSourceBatchOp(model),
                               B.TableSourceBatchOp(data)).collect()
        return np.asarray([list(json.loads(v).values())
                           for v in t.col("detail")])

    from alink_tpu.common import quant as ref_quant

    calib = {}
    with ref_quant.calibration(calib):
        serve("alink_tpu", {"quantSite": site})
    int8 = {"inferencePrecision": "int8", "quantCalib": calib,
            "quantSite": site}
    single = serve("alink_tpu_torch", int8)
    for pkg in ("alink_tpu", "alink_tpu_torch"):
        mapper = importlib.import_module(
            f"{pkg}.operator.batch.linear").LinearModelMapper
        monkeypatch.setattr(mapper, "STREAM_THRESHOLD_BYTES", 1024)
        monkeypatch.setattr(mapper, "STREAM_CHUNK_BYTES", 512)
    got = serve("alink_tpu_torch", int8)
    fp32 = serve("alink_tpu_torch", {})
    np.testing.assert_array_equal(got, fp32)
    np.testing.assert_allclose(got, serve("alink_tpu", int8),
                               atol=PROB_ATOL, rtol=0)
    assert np.abs(single - fp32).max() > PROB_ATOL


@pytest.mark.parametrize("kind", ["linear", "tree"])
def test_predict_ops_under_stamped_policies(kind):
    """A model the reference trained, served by both packages at fp32, then
    calibrated (quant.calibration around an fp32 predict with the op's
    quantSite) and served at bf16 and int8 with the calibration stamped."""
    import importlib

    from alink_tpu.operator.batch import (GbdtTrainBatchOp,
                                          SoftmaxTrainBatchOp,
                                          TableSourceBatchOp)

    rng = np.random.default_rng(4)
    n, d = 240, 6
    X = rng.normal(0, 1, (n, d))
    y = np.digitize(X @ rng.normal(0, 1, d), [-0.7, 0.7]).astype(np.int64)
    cols = {f"f{i}": X[:, i] for i in range(d)}
    cols["label"] = y
    schema = ", ".join([f"f{i} double" for i in range(d)] + ["label long"])
    ref_data = _tables("alink_tpu", cols, schema)
    feats = [f"f{i}" for i in range(d)]
    if kind == "linear":
        train = SoftmaxTrainBatchOp(featureCols=feats, labelCol="label",
                                    maxIter=20)
        op_name, site = "SoftmaxPredictBatchOp", "m:op0"
    else:
        train = GbdtTrainBatchOp(featureCols=feats, labelCol="label",
                                 numTrees=5, maxDepth=3)
        op_name, site = "GbdtPredictBatchOp", "m:op1"
    ref_model = train.link_from(TableSourceBatchOp(ref_data)).collect()
    port_model, port_data = _port_table(ref_model), _port_table(ref_data)

    def serve(pkg, extra):
        B = importlib.import_module(f"{pkg}.operator.batch")
        model, data = (ref_model, ref_data) if pkg == "alink_tpu" \
            else (port_model, port_data)
        op = getattr(B, op_name)(predictionCol="pred",
                                 predictionDetailCol="detail", **extra)
        return op.link_from(B.TableSourceBatchOp(model),
                            B.TableSourceBatchOp(data)).collect()

    records = {}
    for pkg in ("alink_tpu", "alink_tpu_torch"):
        q = importlib.import_module(f"{pkg}.common.quant")
        rec = {}
        with q.calibration(rec):
            serve(pkg, {"quantSite": site})
        records[pkg] = rec
    assert records["alink_tpu_torch"] == records["alink_tpu"]
    assert set(records["alink_tpu"]) == {site + ".x"}
    calib = records["alink_tpu"]
    outs = {}
    for policy in (None, "bf16", "int8"):
        extra = {} if policy is None else {
            "inferencePrecision": policy, "quantCalib": calib,
            "quantSite": site}
        got = serve("alink_tpu_torch", extra)
        want = serve("alink_tpu", extra)
        np.testing.assert_array_equal(np.asarray(got.col("pred")),
                                      np.asarray(want.col("pred")))
        probs = [np.asarray([list(json.loads(v).values()) for v in
                             t.col("detail")]) for t in (got, want)]
        np.testing.assert_allclose(probs[0], probs[1], atol=PROB_ATOL,
                                   rtol=0)
        outs[policy] = probs[0]
    for policy in ("bf16", "int8"):
        assert np.abs(outs[policy] - outs[None]).max() > PROB_ATOL
    # an int8 load whose calibration does not cover the site raises
    from alink_tpu_torch.common.exceptions import AkIllegalStateException

    if kind == "linear":
        with pytest.raises(AkIllegalStateException):
            serve("alink_tpu_torch", {"inferencePrecision": "int8",
                                      "quantCalib": {}, "quantSite": site})
