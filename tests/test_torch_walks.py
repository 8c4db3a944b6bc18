"""Parity of the port's LINE, metapath walks, MetaPath2Vec and the graph2
ops with the reference on the CPU.

- ``line_embeddings`` at orders 1 and 2 and the ops on it run against the
  reference's on a one-device mesh (``default_mesh(jax.devices()[:1])``,
  which the reference turns into ``model_mesh(1)``); the reference's
  threefry negatives are replayed into the port through its test-only
  ``negatives`` (the same draws on both sides). The tables agree within
  1e-6: the same per-row update sequence, fp32 sums in another order.
- Walks, indexers, label propagation, the risk expansion and the huge
  serving variants are host code: equal.
- SimRank runs in float64 on the port's device, in float32 in the reference:
  similarities within 2e-6 (float32's rounding of values below 1, plus the
  JSON's 6 decimals), the same top-N ids where no two candidates are
  within that of each other. MDS equals the reference's coordinates within
  1e-9, each column up to its eigenvector's sign.
"""

import json

import numpy as np
import pytest

TABLE_ATOL = 1e-6


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("ALINK_TORCH_DEVICE", "cpu")
    for knob in ("ALINK_SGNS_PALLAS", "ALINK_APS_HOT_ROWS",
                 "ALINK_HUGE_ENGINE"):
        monkeypatch.delenv(knob, raising=False)


@pytest.fixture(scope="module")
def sid():
    from torch_table_parity import reference_session, remove_session

    s = reference_session()
    yield s
    remove_session(s)


def _reference_negatives(seed, steps, B, negs, logits=None, neg_v=0):
    """The reference's per-step draws on one device:
    ``fold_in(fold_in(PRNGKey(seed), s), 0)``."""
    import jax
    import jax.numpy as jnp

    key0 = jax.random.PRNGKey(seed)

    def one(s):
        key = jax.random.fold_in(jax.random.fold_in(key0, s), 0)
        if logits is None:
            return jax.random.randint(key, (B, negs), 0, neg_v)
        return jax.random.categorical(key, jnp.asarray(logits)[None, :],
                                      shape=(B, negs))

    return np.asarray(jax.vmap(one)(jnp.arange(steps, dtype=jnp.int32)))


def _graph(n=60, e=240, seed=0):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, e)
    dst = (src + 1 + rng.integers(0, n - 1, e)) % n
    return src.astype(np.int64), dst.astype(np.int64)


def _one_device_mesh():
    import jax

    from alink_tpu.parallel.mesh import default_mesh

    return default_mesh(jax.devices()[:1])


@pytest.mark.parametrize("order", [1, 2])
def test_line_embeddings_match_reference(order):
    from alink_tpu.embedding.walks import line_embeddings as ref_line
    from alink_tpu_torch.embedding.walks import line_embeddings

    src, dst = _graph()
    kw = dict(num_nodes=60, dim=8, order=order, num_negatives=3,
              num_steps=50, batch_size=64, learning_rate=0.05, seed=3)
    ref = ref_line(src, dst, mesh=_one_device_mesh(), **kw)
    negs = _reference_negatives(3, 50, 64, 3, neg_v=60)
    got = line_embeddings(src, dst, negatives=negs, **kw)
    assert got.shape == (60, 8) and np.abs(ref - got).max() < TABLE_ATOL
    host = line_embeddings(src, dst, negatives=negs, engine="host", **kw)
    np.testing.assert_array_equal(host, got)


def test_line_batch_clamp_and_dropped_tail(monkeypatch):
    """E = 37 edges: B is min(512, 37) = 37 and one block; at B = 10 the
    shuffled tail of 7 edges is dropped (3 blocks)."""
    import alink_tpu_torch.embedding.skipgram as sk
    from alink_tpu.embedding.walks import line_embeddings as ref_line
    from alink_tpu_torch.embedding.walks import line_embeddings

    seen = []
    run = sk._run_pairs_sharded

    def spy(pairs, V, D, B, negs, steps, n_blocks, *a, **kw):
        seen.append((pairs.shape[0], B, n_blocks))
        return run(pairs, V, D, B, negs, steps, n_blocks, *a, **kw)

    monkeypatch.setattr(sk, "_run_pairs_sharded", spy)
    src, dst = _graph(n=20, e=37, seed=1)
    for batch, want in ((512, (37, 37, 1)), (10, (30, 10, 3))):
        kw = dict(num_nodes=20, dim=4, order=2, num_negatives=2,
                  num_steps=9, batch_size=batch, seed=5)
        negs = _reference_negatives(5, 9, want[1], 2, neg_v=20)
        got = line_embeddings(src, dst, negatives=negs, **kw)
        assert seen[-1] == want
        ref = ref_line(src, dst, mesh=_one_device_mesh(), **kw)
        assert np.abs(ref - got).max() < TABLE_ATOL


def test_line_empty_graph_is_the_seeded_init():
    from alink_tpu.embedding.walks import line_embeddings as ref_line
    from alink_tpu_torch.embedding.walks import line_embeddings

    e = np.zeros(0, np.int64)
    np.testing.assert_array_equal(
        line_embeddings(e, e, num_nodes=7, dim=5, seed=9),
        ref_line(e, e, num_nodes=7, dim=5, seed=9))


def _edge_cols(src, dst):
    return {"s": np.asarray([f"n{v}" for v in src], object),
            "t": np.asarray([f"n{v}" for v in dst], object)}


@pytest.mark.parametrize("order", [1, 2])
def test_line_op_matches_reference(sid, order):
    import alink_tpu_torch.operator.batch as P
    from alink_tpu_torch.common.mtable import MTable as MT
    from torch_table_parity import both

    src, dst = _graph(n=40, e=120, seed=2)
    # isToUndigraph doubles the 120 edges: 240 a block at batch 256
    P.LineBatchOp._negatives = _reference_negatives(0, 30, 240, 5,
                                                    neg_v=40)
    try:
        ref, got = both(sid, _edge_cols(src, dst), lambda B, e, s: (
            B.LineBatchOp(sourceCol="s", targetCol="t", vectorSize=8,
                          order=order, numSteps=30, batchSize=256, **e)
            .link_from(s)))
    finally:
        P.LineBatchOp._negatives = None
    assert list(got.col("word")) == list(ref.col("word"))
    diff = max(np.abs(a.data - b.data).max()
               for a, b in zip(got.col("vec"), ref.col("vec")))
    assert diff < TABLE_ATOL


def _hetero():
    rng = np.random.default_rng(4)
    users = [f"u{i}" for i in range(25)]
    items = [f"i{i}" for i in range(15)]
    s = [users[i] for i in rng.integers(0, 25, 150)]
    t = [items[i] for i in rng.integers(0, 15, 150)]
    edges = {"s": np.asarray(s, object), "t": np.asarray(t, object)}
    types = {"vertex": np.asarray(users + items, object),
             "type": np.asarray(["user"] * 25 + ["item"] * 15, object)}
    return edges, types


def test_metapath_walks_equal(sid):
    from torch_table_parity import both, same_table

    edges, types = _hetero()
    ref, got = both(sid, edges, lambda B, e, s, tp: (
        B.MetaPathWalkBatchOp(sourceCol="s", targetCol="t", walkNum=3,
                              metaPath="user-item-user-item", **e)
        .link_from(s, tp)), types)
    assert got.num_rows == 75
    same_table(got, ref)


def test_metapath2vec_matches_reference(sid):
    import alink_tpu_torch.operator.batch as P
    from alink_tpu_torch.common.mtable import MTable as MT
    from alink_tpu_torch.embedding import build_vocab, make_pairs
    from alink_tpu_torch.embedding.skipgram import (_prep_pairs,
                                                    _unigram75_logits)
    from torch_table_parity import both

    edges, types = _hetero()
    params = dict(sourceCol="s", targetCol="t", walkNum=4,
                  metaPath="user-item-user", vectorSize=8, window=2,
                  numIter=2, batchSize=32)
    walks = P.MetaPathWalkBatchOp(**params).link_from(
        P.TableSourceBatchOp(MT(dict(edges))),
        P.TableSourceBatchOp(MT(dict(types)))).collect()
    docs = [str(v).split(" ") for v in walks.col("path")]
    vocab, counts = build_vocab(docs, 1)
    pairs = make_pairs(docs, vocab, counts, 2, 0.0, 0)
    steps = _prep_pairs(pairs, 32, 1, 0)[1] * 2
    P.MetaPath2VecBatchOp._negatives = _reference_negatives(
        0, steps, 32, 5, logits=_unigram75_logits(counts))
    try:
        ref, got = both(sid, edges, lambda B, e, s, tp: (
            B.MetaPath2VecBatchOp(**params, **e).link_from(s, tp)), types)
    finally:
        P.MetaPath2VecBatchOp._negatives = None
    assert list(got.col("word")) == list(ref.col("word"))
    diff = max(np.abs(a.data - b.data).max()
               for a, b in zip(got.col("vec"), ref.col("vec")))
    assert 0 < steps and diff < TABLE_ATOL


def test_node_indexer_round_trip(sid):
    from torch_table_parity import both, same_table

    cols = {"source": np.asarray(["b", "a", "c", "a"], object),
            "target": np.asarray(["c", "d", "b", "b"], object)}

    def build(B, e, s):
        model = B.NodeIndexerTrainBatchOp(**e).link_from(s)
        idx = B.NodeToIndexBatchOp(**e).link_from(model, s)
        return B.IndexToNodeBatchOp(**e).link_from(model, idx)

    ref, got = both(sid, cols, build)
    same_table(got, ref)
    assert list(got.col("source")) == ["b", "a", "c", "a"]


def test_huge_serving_variants_in_blocks(sid):
    from torch_table_parity import both, same_table

    cols = {"k": np.asarray(["x", "y", "z", "x", "w"] * 3, object),
            "v": np.arange(15, dtype=np.int64)}
    lut = {"k": np.asarray(["x", "y", "z"], object),
           "m": np.asarray([1.5, 2.5, 3.5])}
    ref, got = both(sid, lut, lambda B, e, m, s: (
        B.HugeLookupBatchOp(mapKeyCols=["k"], mapValueCols=["m"],
                            blockSize=4, **e).link_from(m, s)), cols)
    same_table(got, ref)

    def indexed(B, e, s):
        model = B.StringIndexerTrainBatchOp(selectedCol="k", **e) \
            .link_from(s)
        idx = B.StringIndexerPredictBatchOp(selectedCols=["k"],
                                            outputCols=["i"], **e).link_from(model, s)
        return B.HugeIndexerStringPredictBatchOp(
            selectedCol="i", outputCol="back", blockSize=4, **e) \
            .link_from(model, idx)

    ref, got = both(sid, cols, indexed)
    same_table(got, ref)
    assert list(got.col("back")) == list(cols["k"])


def _ratings(nu=30, ni=20, e=160, seed=6):
    rng = np.random.default_rng(seed)
    return {"u": np.asarray([f"u{i}" for i in rng.integers(0, nu, e)],
                            object),
            "i": np.asarray([f"i{i}" for i in rng.integers(0, ni, e)],
                            object)}


def test_simrank_matches_reference(sid):
    from torch_table_parity import both

    ref, got = both(sid, _ratings(), lambda B, e, s: (
        B.SimrankBatchOp(userCol="u", itemCol="i", topN=5, **e)
        .link_from(s)))
    assert list(got.col("item")) == list(ref.col("item"))
    compared = 0
    for a, b in zip(got.col("similarities"), ref.col("similarities")):
        a, b = json.loads(a), json.loads(b)
        vals = sorted(b.values(), reverse=True)
        gaps = np.diff(vals)
        if len(gaps) == 0 or np.abs(gaps).min() > 2e-6:
            assert list(a) == list(b)
            compared += 1
        for k in set(a) & set(b):
            assert abs(a[k] - b[k]) <= 2e-6
    assert compared > 10


def test_simrank_sweeps_are_supersteps():
    """Each SimRank sweep counts as one superstep of the graph engine's
    accounting and is recorded inside ``superstep_trace`` (no events on
    the CPU; the card's CUDA event pairs time the op's own sweeps)."""
    from alink_tpu_torch.common.metrics import metrics
    from alink_tpu_torch.common.mtable import MTable
    from alink_tpu_torch.graph.engine import superstep_trace
    from alink_tpu_torch.operator.batch import (SimrankBatchOp,
                                                TableSourceBatchOp)

    t = MTable(_ratings())
    before = metrics.counter("graph.supersteps")
    with superstep_trace() as runs:
        SimrankBatchOp(userCol="u", itemCol="i", numIter=4).link_from(
            TableSourceBatchOp(t)).collect()
    assert metrics.counter("graph.supersteps") - before == 4
    assert [(r["fn"], r["supersteps"], r["host_syncs"], r["events"])
            for r in runs] == [("simrank", 4, 0, [])]
    assert runs[0]["n"] == len(set(t.col("u"))) + len(set(t.col("i")))


def test_mds_matches_reference_up_to_sign(sid):
    from torch_table_parity import both

    rng = np.random.default_rng(7)
    cols = {f"x{j}": rng.normal(size=40) for j in range(5)}
    ref, got = both(sid, cols, lambda B, e, s: (
        B.MdsBatchOp(dim=3, **e).link_from(s)))
    for j in range(3):
        a = np.asarray(got.col(f"mds_{j}"))
        b = np.asarray(ref.col(f"mds_{j}"))
        sign = np.sign(a @ b)
        np.testing.assert_allclose(a * sign, b, rtol=0, atol=1e-9)


def test_community_classify_and_risk_alike(sid):
    from torch_table_parity import both, same_table

    src, dst = _graph(n=30, e=60, seed=8)
    edges = _edge_cols(src, dst)
    labeled = {"vertex": np.asarray(["n0", "n1", "n2"], object),
               "label": np.asarray(["a", "b", "a"], object)}
    ref, got = both(sid, edges, lambda B, e, s, lab: (
        B.CommunityDetectionClassifyBatchOp(sourceCol="s", targetCol="t",
                                            **e).link_from(s, lab)), labeled)
    same_table(got, ref)
    seeds = {"vertex": np.asarray(["n3", "n7"], object)}
    ref, got = both(sid, seeds, lambda B, e, sd, s: (
        B.RiskAlikeBuildGraphBatchOp(sourceCol="s", targetCol="t",
                                     expandDegree=2, **e)
        .link_from(sd, s)), edges)
    same_table(got, ref)
    assert 0 < got.num_rows < 60


def test_huge_labeled_word2vec_prefixes_types():
    import alink_tpu_torch.operator.batch as P
    from alink_tpu_torch.common.mtable import MTable as MT

    docs = {"doc": np.asarray(["a b c", "b c a", "c a b"] * 4, object)}
    types = {"n": np.asarray(["a", "b"], object),
             "t": np.asarray(["X", "Y"], object)}
    out = P.HugeLabeledWord2VecTrainBatchOp(
        selectedCol="doc", vectorSize=4, window=1, numIter=1,
        batchSize=8).link_from(
        P.TableSourceBatchOp(MT(dict(docs))),
        P.TableSourceBatchOp(MT(dict(types)))).collect()
    assert sorted(out.col("word")) == ["X#a", "Y#b", "c"]
