"""The embedding slice of the port (``alink_tpu_torch.embedding``, the APS
tables and the huge operators) held against ``alink_tpu`` on the CPU, with
inputs made by seeded numpy.

- ``sgns_block_grads_ref`` (the plain version of the CUDA kernel
  ``sgns_block_grads`` given the pulled rows) against the reference's
  ``_block_grads`` and its Pallas kernel in interpret mode, at the shapes of
  ``tests/test_kernels.py`` and a ragged D = 37: atol 1e-5, the reference
  kernel's contract. ``sgns_pull_grads_ref`` (the plain version of the
  trainer's fused pull-and-gradients entry) against the reference's
  ``pull_cached``/``pull`` and the Pallas kernel on a one-device mesh, with
  hot, cold, sentinel and duplicate ids and a tied table: atol 1e-5, hits
  equal.
- The trainers against the reference's on one device
  (``model_mesh(1)``, and a one-device mesh for the host engine), with the
  reference's negative stream replayed into the port (its threefry draws
  cannot be reproduced by a torch generator): max|Δ| measured 7.5e-9 on
  every route, the sharded engine cached or not, kernel on or off on the
  JAX side, the host engine and the tied LINE-style step, over 60–135
  steps at table magnitude 0.07 (fp32 sums taken in another order);
  tolerance 1e-6.
- Within the port on the CPU, the host and sharded engines, cached or not,
  are bit-identical at equal seed, as the reference pins for its engines.
- Host pieces (vocabulary, pairs, shuffle, walks) equal the reference's.
- The operators: same vocabulary and row order; model tables and APS tables
  cross-load between the packages through ``.ak``; predictions equal.
"""

import os

import numpy as np
import pytest
import torch

TRAINER_ATOL = 1e-6


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("ALINK_TORCH_DEVICE", "cpu")
    for knob in ("ALINK_SGNS_PALLAS", "ALINK_APS_HOT_ROWS",
                 "ALINK_HUGE_ENGINE"):
        monkeypatch.delenv(knob, raising=False)


# ---------------------------------------------------------------------------
# the kernel's function
# ---------------------------------------------------------------------------


def _block_inputs(B, negs, D, seed=0, scale=1.0):
    rng = np.random.default_rng(seed)
    return tuple((rng.normal(size=s) * scale).astype(np.float32)
                 for s in ((B, D), (B, D), (B, negs, D)))


@pytest.mark.parametrize("B,negs,D", [(13, 5, 100), (8, 1, 128), (32, 7, 64),
                                      (9, 3, 37)])
def test_block_grads_ref_matches_reference_and_pallas(B, negs, D):
    import jax.numpy as jnp

    from alink_tpu.embedding.sgns_pallas import sgns_block_grads as pallas
    from alink_tpu.embedding.skipgram import _block_grads
    from alink_tpu_torch.embedding.sgns_cuda import sgns_block_grads_ref

    v, u_pos, u_neg = _block_inputs(B, negs, D)
    gv, gu = (x.numpy() for x in sgns_block_grads_ref(
        *(torch.from_numpy(x) for x in (v, u_pos, u_neg))))
    assert gv.shape == (B, D) and gu.shape == ((negs + 1) * B, D)
    j = [jnp.asarray(x) for x in (v, u_pos, u_neg)]
    for ref_v, ref_u in (_block_grads(*j, D),
                         pallas(*j, interpret=True)):
        np.testing.assert_allclose(gv, np.asarray(ref_v), rtol=0, atol=1e-5)
        np.testing.assert_allclose(gu, np.asarray(ref_u), rtol=0, atol=1e-5)

    # the layout, from the formulas in float64: context rows first, then the
    # negatives b-major (row B + b·negs + n)
    sig = lambda x: 1.0 / (1.0 + np.exp(-x))  # noqa: E731
    v64, up64, un64 = (x.astype(np.float64) for x in (v, u_pos, u_neg))
    g_pos = sig((v64 * up64).sum(-1)) - 1.0
    g_neg = sig(np.einsum("bd,bnd->bn", v64, un64))
    np.testing.assert_allclose(gu[:B], g_pos[:, None] * v64, atol=1e-5)
    np.testing.assert_allclose(
        gu[B:].reshape(B, negs, D), g_neg[..., None] * v64[:, None], atol=1e-5)
    np.testing.assert_allclose(
        gv, g_pos[:, None] * up64 + (g_neg[..., None] * un64).sum(1),
        atol=1e-5)


def test_wrapper_takes_the_plain_version_on_cpu_without_counting():
    from alink_tpu_torch.embedding.sgns_cuda import (sgns_block_grads,
                                                     sgns_block_grads_ref)
    from alink_tpu_torch.native import kernels

    args = [torch.from_numpy(x) for x in _block_inputs(16, 5, 100, seed=1)]
    before = kernels.launches()["sgns_block_grads"]
    for a, b in zip(sgns_block_grads(*args), sgns_block_grads_ref(*args)):
        assert torch.equal(a, b)
    assert kernels.launches()["sgns_block_grads"] == before
    spec = kernels.KERNELS["sgns_block_grads"]
    assert spec.replaces == "alink_tpu/embedding/sgns_pallas.py:100"
    assert spec.plain == ("sgns_block_grads_ref", "sgns_pull_grads_ref")
    assert os.path.exists(os.path.join(os.path.dirname(kernels.__file__),
                                       "..", spec.source))


def _pull_step(rows=40, D=16, B=12, negs=3, hot=6, tied=False, seed=2):
    """A step's pull inputs with every kind of id: hot ids (< hot), cold ids,
    sentinels (rows, the one-rank pull's parked id, and -1) and duplicates;
    replicas that differ from the tables' prefix, so a read of the table
    for a hot id shows."""
    rng = np.random.default_rng(seed)
    win = rng.normal(size=(rows, D)).astype(np.float32)
    wctx = win if tied else rng.normal(size=(rows, D)).astype(np.float32)
    rep_in = (rng.normal(size=(hot, D)) * 0.5).astype(np.float32)
    rep_ctx = rep_in if tied else (rng.normal(size=(hot, D)) * 0.5).astype(
        np.float32)
    center = rng.integers(0, rows, B)
    uids = rng.integers(0, rows, (negs + 1) * B)
    center[:3] = [0, rows, 1]                  # hot, sentinel, hot
    uids[:5] = [rows, -1, 2, 2, rows - 1]      # sentinels, duplicates, cold
    uids[B:B + 4] = [0, 0, rows, 5]
    return (win, wctx, center.astype(np.int64), uids.astype(np.int64),
            rep_in, rep_ctx)


def _jax_pull_grads(win, wctx, center, uids, rep_in, rep_ctx, *, negs, rows,
                    hot):
    """The reference's step on a one-device mesh: ``pull_cached`` (or
    ``pull``) of both id vectors, then the Pallas kernel in interpret
    mode. Returns (grad_v, grad_u, hits)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from alink_tpu.embedding.sgns_pallas import sgns_block_grads
    from alink_tpu.parallel.aps import AXIS_MODEL, model_mesh, pull
    from alink_tpu.parallel.hotcache import pull_cached
    from alink_tpu.parallel.shardmap import shard_map

    B, D = center.shape[0], win.shape[1]
    axis = AXIS_MODEL

    def body(win_l, wctx_l, r_in, r_ctx, c, u_ids):
        if hot > 0:
            v, h1 = pull_cached(win_l, r_in, c, axis, rows, hot)
            u, h2 = pull_cached(wctx_l, r_ctx, u_ids, axis, rows, hot)
            hits = h1 + h2
        else:
            v = pull(win_l, c, axis, rows)
            u = pull(wctx_l, u_ids, axis, rows)
            hits = jnp.zeros((), jnp.int32)
        gv, gu = sgns_block_grads(v, u[:B], u[B:].reshape(B, negs, D),
                                  interpret=True)
        return gv, gu, hits[None]

    run = jax.jit(shard_map(body, mesh=model_mesh(1),
                    in_specs=(P(axis), P(axis), P(), P(), P(), P()),
                    out_specs=(P(), P(), P(axis)), check_vma=False))
    gv, gu, hits = run(*(jnp.asarray(x) for x in (
        win, wctx, rep_in, rep_ctx, center.astype(np.int32),
        uids.astype(np.int32))))
    return np.asarray(gv), np.asarray(gu), int(np.asarray(hits).sum())


@pytest.mark.parametrize("tied", [False, True])
@pytest.mark.parametrize("hot", [0, 6])
def test_pull_grads_ref_matches_reference(hot, tied):
    # the fused entry's plain version against the reference's pull (through
    # the hot cache when hot > 0) and its Pallas kernel: grads at atol 1e-5,
    # hits equal
    from alink_tpu_torch.embedding.sgns_cuda import (sgns_pull_grads,
                                                     sgns_pull_grads_ref)

    negs, rows = 3, 40
    win, wctx, center, uids, rep_in, rep_ctx = _pull_step(hot=max(hot, 1),
                                                          tied=tied)
    ref_v, ref_u, ref_hits = _jax_pull_grads(
        win, wctx, center, uids, rep_in, rep_ctx, negs=negs, rows=rows,
        hot=hot)
    t = {k: torch.from_numpy(x) for k, x in dict(
        win=win, wctx=wctx, center=center, uids=uids, rep_in=rep_in,
        rep_ctx=rep_ctx).items()}
    if tied:
        t["wctx"], t["rep_ctx"] = t["win"], t["rep_in"]
    for fn in (sgns_pull_grads_ref, sgns_pull_grads):
        hits = torch.full((), 5, dtype=torch.int64)
        gv, gu = fn(t["win"], t["wctx"], t["center"], t["uids"], negs=negs,
                    rows=rows, hot=hot,
                    rep_in=t["rep_in"] if hot else None,
                    rep_ctx=t["rep_ctx"] if hot else None,
                    hits=hits if hot else None)
        np.testing.assert_allclose(gv.numpy(), ref_v, rtol=0, atol=1e-5)
        np.testing.assert_allclose(gu.numpy(), ref_u, rtol=0, atol=1e-5)
        assert int(hits) - 5 == ref_hits
    if hot:
        is_hot = lambda x: int(((x >= 0) & (x < hot)).sum())  # noqa: E731
        assert ref_hits == is_hot(center) + is_hot(uids) > 0


def test_pull_grads_takes_the_plain_version_only_for_cpu_tensors(
        monkeypatch):
    from alink_tpu_torch.embedding.sgns_cuda import (sgns_pull_grads,
                                                     sgns_pull_grads_ref)
    from alink_tpu_torch.native import kernels

    calls = []

    def no_kernel():
        calls.append(1)
        raise RuntimeError("kernel unavailable")

    monkeypatch.setattr(kernels, "ops", no_kernel)
    kernels.reset_launches()
    win, wctx, center, uids, rep_in, rep_ctx = (
        torch.from_numpy(x) for x in _pull_step())
    kw = dict(negs=3, rows=40, hot=6, rep_in=rep_in, rep_ctx=rep_ctx)
    h1, h2 = torch.zeros((), dtype=torch.int64), torch.zeros((),
                                                             dtype=torch.int64)
    for a, b in zip(sgns_pull_grads(win, wctx, center, uids, hits=h1, **kw),
                    sgns_pull_grads_ref(win, wctx, center, uids, hits=h2,
                                        **kw)):
        assert torch.equal(a, b)
    assert int(h1) == int(h2) > 0
    assert calls == [] and kernels.launches()["sgns_block_grads"] == 0
    meta = dict(kw, rep_in=rep_in.to("meta"), rep_ctx=rep_ctx.to("meta"))
    with pytest.raises(RuntimeError, match="kernel unavailable"):
        sgns_pull_grads(win.to("meta"), wctx.to("meta"), center.to("meta"),
                        uids.to("meta"), hits=h1.to("meta"), **meta)
    assert calls == [1] and kernels.launches()["sgns_block_grads"] == 0


# ---------------------------------------------------------------------------
# the APS pieces
# ---------------------------------------------------------------------------


def test_dedup_batch_matches_reference():
    import jax.numpy as jnp

    from alink_tpu.parallel.aps import _dedup_batch as ref_dedup
    from alink_tpu_torch.parallel.aps import _dedup_batch

    rng = np.random.default_rng(3)
    ids = (rng.zipf(1.3, 300) % 40).astype(np.int32)    # many duplicates
    grads = rng.normal(size=(300, 8)).astype(np.float32)
    uid, g = _dedup_batch(torch.from_numpy(ids).long(),
                          torch.from_numpy(grads), 1000)
    r_uid, r_g = ref_dedup(jnp.asarray(ids), jnp.asarray(grads), 1000)
    np.testing.assert_array_equal(uid.numpy(), np.asarray(r_uid))
    np.testing.assert_allclose(g.numpy(), np.asarray(r_g), rtol=0, atol=1e-6)


def test_pull_push_and_the_cache_on_one_rank():
    from alink_tpu_torch.parallel.aps import pull, push
    from alink_tpu_torch.parallel.hotcache import pull_cached, refresh_hot

    rng = np.random.default_rng(0)
    table = torch.from_numpy(rng.normal(size=(20, 4)).astype(np.float32))
    ids = torch.tensor([3, 19, 3, 0, 20, -1])       # 20, -1: outside
    rows = pull(table, ids, "model", 20)
    assert torch.equal(rows[:4], table[ids[:4]])
    assert torch.equal(rows[4:], torch.zeros(2, 4))
    cached, hits = pull_cached(table, refresh_hot(table, "model", 5), ids,
                               "model", 20, 5)
    assert torch.equal(cached, rows) and int(hits) == 3
    grads = torch.ones(6, 4)
    want = table.clone()
    want[3] -= 0.5 * 2
    want[19] -= 0.5
    want[0] -= 0.5
    push(table, ids, grads, "model", 20, 0.5)
    assert torch.equal(table, want)


def test_more_than_one_rank_raises(monkeypatch):
    from alink_tpu_torch.parallel import aps

    monkeypatch.setattr(aps, "axis_size", lambda axis="model": 2)
    table = torch.zeros(8, 2)
    with pytest.raises(NotImplementedError, match="A3"):
        aps.pull(table, torch.tensor([1]), "model", 4)
    with pytest.raises(NotImplementedError, match="A3"):
        aps.push(table, torch.tensor([1]), torch.ones(1, 2), "model", 4)


def test_sharded_embedding_ak_across_packages(tmp_path):
    from alink_tpu.parallel.aps import ShardedEmbedding as RefTable
    from alink_tpu.parallel.aps import model_mesh
    from alink_tpu_torch.parallel.aps import ShardedEmbedding

    ref = RefTable(model_mesh(1), 37, 6, seed=4)
    ref.save(str(tmp_path / "ref.ak"))
    got = ShardedEmbedding.load(str(tmp_path / "ref.ak"))
    np.testing.assert_array_equal(got.to_numpy(), ref.to_numpy())
    assert got.vocab_size == 37 and got.dim == 6
    # the port's default init is the reference's
    np.testing.assert_array_equal(ShardedEmbedding(37, 6, seed=4).to_numpy(),
                                  ref.to_numpy())

    mine = ShardedEmbedding.from_numpy(
        np.random.default_rng(5).normal(size=(11, 3)).astype(np.float32))
    mine.save(str(tmp_path / "port.ak"))
    back = RefTable.load(model_mesh(1), str(tmp_path / "port.ak"))
    np.testing.assert_array_equal(back.to_numpy(), mine.to_numpy())


def test_hot_rows_resolve_as_in_the_reference(monkeypatch):
    from alink_tpu.parallel.hotcache import resolve_hot_rows as ref_resolve
    from alink_tpu_torch.parallel.hotcache import resolve_hot_rows

    for raw in (None, "auto", "7", "junk", "0"):
        if raw is None:
            monkeypatch.delenv("ALINK_APS_HOT_ROWS", raising=False)
        else:
            monkeypatch.setenv("ALINK_APS_HOT_ROWS", raw)
        for V, rows in ((40, 40), (300, 300), (63000, 63000), (5000, 100)):
            assert resolve_hot_rows(None, V, rows) == ref_resolve(None, V, rows)


# ---------------------------------------------------------------------------
# the trainers
# ---------------------------------------------------------------------------


def _zipf_docs(seed=0, n_docs=60, length=30, types=260):
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, types + 1)
    ids = rng.choice(types, size=(n_docs, length), p=p / p.sum())
    return [[f"w{i}" for i in row] for row in ids]


@pytest.fixture(scope="module")
def corpus():
    from alink_tpu.embedding import SkipGramConfig, build_vocab, make_pairs

    docs = _zipf_docs()
    vocab, counts = build_vocab(docs)
    cfg = SkipGramConfig(dim=16, window=3, negatives=4, epochs=3,
                         batch_size=64, seed=11)
    pairs = make_pairs(docs, vocab, counts, cfg.window, cfg.subsample,
                       cfg.seed)
    return docs, vocab, counts, cfg, pairs


def _reference_negatives(seed, steps, B, negs, logits=None, neg_v=0):
    """The reference's per-step draws on one device:
    ``fold_in(fold_in(PRNGKey(seed), s), 0)`` (the step, then the device's
    axis index)."""
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


def _steps(pairs, cfg):
    from alink_tpu_torch.embedding.skipgram import _prep_pairs

    return _prep_pairs(pairs, cfg.batch_size, 1, cfg.seed)[1] * cfg.epochs


@pytest.fixture(scope="module")
def replayed(corpus):
    from alink_tpu_torch.embedding.skipgram import _unigram75_logits

    _, vocab, counts, cfg, pairs = corpus
    steps = _steps(pairs, cfg)
    return _reference_negatives(cfg.seed, steps, cfg.batch_size,
                                cfg.negatives, _unigram75_logits(counts))


@pytest.mark.parametrize("hot_rows", [0, None])
@pytest.mark.parametrize("pallas", ["0", "1"])
def test_sharded_trainer_matches_reference(corpus, replayed, monkeypatch,
                                           hot_rows, pallas):
    from alink_tpu.embedding import train_skipgram_sharded as ref_train
    from alink_tpu.parallel.aps import model_mesh
    from alink_tpu_torch.embedding import train_skipgram_sharded

    _, vocab, counts, cfg, pairs = corpus
    V = len(vocab)
    assert 64 <= V <= 300 and replayed.shape[0] >= 100   # auto hot is > 0
    monkeypatch.setenv("ALINK_SGNS_PALLAS", pallas)      # JAX side: interpret
    ref = ref_train(pairs, V, counts, cfg, mesh=model_mesh(1),
                    hot_rows=hot_rows).to_numpy()
    monkeypatch.delenv("ALINK_SGNS_PALLAS")
    got = train_skipgram_sharded(pairs, V, counts, cfg, hot_rows=hot_rows,
                                 negatives=replayed).to_numpy()
    assert got.shape == (V, cfg.dim) and 0.05 < np.abs(ref).max() < 1.0
    np.testing.assert_allclose(got, ref, rtol=0, atol=TRAINER_ATOL)


def test_host_trainer_matches_reference(corpus, replayed):
    import jax

    from alink_tpu.embedding import train_skipgram as ref_train
    from alink_tpu.parallel.mesh import default_mesh
    from alink_tpu_torch.embedding import train_skipgram

    _, vocab, counts, cfg, pairs = corpus
    ref = ref_train(pairs, len(vocab), counts, cfg,
                    mesh=default_mesh(jax.devices()[:1]))
    got = train_skipgram(pairs, len(vocab), counts, cfg, negatives=replayed)
    np.testing.assert_allclose(got, ref, rtol=0, atol=TRAINER_ATOL)


def test_tied_uniform_variant_matches_reference(corpus):
    """The LINE-style step: one tied table, uniform negatives over neg_v."""
    from alink_tpu.embedding.skipgram import _run_pairs_sharded as ref_run
    from alink_tpu.parallel.aps import model_mesh
    from alink_tpu_torch.embedding.skipgram import (_prep_pairs,
                                                    _run_pairs_host,
                                                    _run_pairs_sharded)

    _, vocab, _, cfg, pairs = corpus
    V, B, negs = len(vocab), 32, 3
    blocks, n_blocks = _prep_pairs(pairs, B, 1, 2)
    steps = 60
    args = (blocks, V, 8, B, negs, steps, n_blocks, 0.025, 2)
    kw = dict(tie=True, neg_logits=None, neg_v=V)
    ref = ref_run(*args, mesh=model_mesh(1), hot_rows=16, **kw).to_numpy()
    negatives = _reference_negatives(2, steps, B, negs, neg_v=V)
    got = _run_pairs_sharded(*args, hot_rows=16, negatives=negatives,
                             **kw).to_numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=TRAINER_ATOL)
    host = _run_pairs_host(*args, negatives=negatives, **kw)
    np.testing.assert_array_equal(host, got)


@pytest.mark.parametrize("hot_rows", [0, None, 7])
def test_port_engines_bit_identical(corpus, hot_rows):
    from alink_tpu_torch.embedding import (train_embedding, train_skipgram,
                                           train_skipgram_sharded)

    _, vocab, counts, cfg, pairs = corpus
    host = train_skipgram(pairs, len(vocab), counts, cfg)
    sharded = train_skipgram_sharded(pairs, len(vocab), counts, cfg,
                                     hot_rows=hot_rows).to_numpy()
    np.testing.assert_array_equal(host, sharded)
    np.testing.assert_array_equal(
        train_embedding(pairs, len(vocab), counts, cfg, engine="host"), host)


def test_drawn_negatives_follow_the_unigram_law():
    """The port's own stream: deterministic per (seed, step), different
    across steps, and distributed as unigram^0.75."""
    from alink_tpu_torch.embedding.skipgram import (_negative_stream,
                                                    _unigram75_logits)

    counts = 1000.0 / np.arange(1, 51)
    logits = _unigram75_logits(counts)
    draw = _negative_stream(3, 4000, 5, logits, 0, torch.device("cpu"))
    a, b = draw(0), draw(1)
    assert torch.equal(a, draw(0)) and not torch.equal(a, b)
    assert a.shape == (4000, 5) and int(a.min()) >= 0 and int(a.max()) < 50
    freq = np.bincount(torch.cat([a, b]).reshape(-1).numpy(), minlength=50)
    p = np.exp(logits.astype(np.float64))
    np.testing.assert_allclose(freq / freq.sum(), p / p.sum(), atol=0.01)
    uni = _negative_stream(3, 100, 2, None, 9, torch.device("cpu"))(0)
    assert int(uni.min()) >= 0 and int(uni.max()) < 9


def test_empty_pairs_return_the_initial_table():
    from alink_tpu.embedding.skipgram import _fresh_init
    from alink_tpu_torch.embedding import (SkipGramConfig, train_skipgram,
                                           train_skipgram_sharded)

    cfg = SkipGramConfig(dim=5)
    empty = np.zeros((0, 2), np.int32)
    init = _fresh_init(cfg.seed, 9, 5)
    np.testing.assert_array_equal(train_skipgram(empty, 9, np.ones(9), cfg),
                                  init)
    np.testing.assert_array_equal(
        train_skipgram_sharded(empty, 9, np.ones(9), cfg).to_numpy(), init)


# ---------------------------------------------------------------------------
# host pieces
# ---------------------------------------------------------------------------


def test_host_pieces_equal_reference(corpus):
    from alink_tpu.embedding import skipgram as ref_sg
    from alink_tpu_torch.embedding import skipgram as sg

    docs, vocab, counts, cfg, pairs = corpus
    v2, c2 = sg.build_vocab(docs, 2)
    rv2, rc2 = ref_sg.build_vocab(docs, 2)
    assert v2 == rv2 and np.array_equal(c2, rc2)
    got = sg.make_pairs(docs, vocab, counts, cfg.window, cfg.subsample,
                        cfg.seed)
    np.testing.assert_array_equal(got, pairs)
    for a, b in zip(sg._prep_pairs(pairs, 64, 1, 5),
                    ref_sg._prep_pairs(pairs, 64, 1, 5)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(sg._unigram75_logits(counts),
                                  ref_sg._unigram75_logits(counts))


@pytest.mark.parametrize("weighted", [False, True])
def test_walks_equal_reference(weighted):
    from alink_tpu.embedding import walks as ref_walks
    from alink_tpu_torch.embedding import walks

    rng = np.random.default_rng(2)
    src, dst = rng.integers(0, 30, 80), rng.integers(0, 30, 80)
    w = rng.random(80).astype(np.float32) + 0.1 if weighted else None
    csr = walks.build_csr(src, dst, w, num_nodes=31)
    for a, b in zip(csr, ref_walks.build_csr(src, dst, w, num_nodes=31)):
        np.testing.assert_array_equal(a, b)
    kw = dict(num_walks=2, walk_length=8, seed=4)
    np.testing.assert_array_equal(walks.random_walks(*csr, **kw),
                                  ref_walks.random_walks(*csr, **kw))
    np.testing.assert_array_equal(
        walks.node2vec_walks(*csr, p=0.5, q=2.0, **kw),
        ref_walks.node2vec_walks(*csr, p=0.5, q=2.0, **kw))


# ---------------------------------------------------------------------------
# operators
# ---------------------------------------------------------------------------


def _doc_table(pkg_mtable, docs):
    return pkg_mtable({"doc": np.asarray([" ".join(d) for d in docs],
                                         object)})


def test_word2vec_ops_across_packages(corpus, tmp_path):
    from alink_tpu.common.mtable import MTable as RefTable
    from alink_tpu.operator.batch import Word2VecPredictBatchOp as RefPredict
    from alink_tpu.operator.batch import Word2VecTrainBatchOp as RefTrain
    from alink_tpu.operator.batch.base import AkSinkBatchOp as RefSink
    from alink_tpu.operator.batch.base import AkSourceBatchOp as RefSource
    from alink_tpu.operator.batch.base import \
        TableSourceBatchOp as RefTableSource
    from alink_tpu_torch.common.mtable import MTable
    from alink_tpu_torch.operator.batch import (AkSinkBatchOp,
                                                AkSourceBatchOp,
                                                TableSourceBatchOp,
                                                Word2VecPredictBatchOp,
                                                Word2VecTrainBatchOp)

    docs = corpus[0]
    params = dict(selectedCol="doc", vectorSize=8, numIter=2, batchSize=64)
    ref_data = RefTableSource(_doc_table(RefTable, docs))
    data = TableSourceBatchOp(_doc_table(MTable, docs))
    ref_model = RefTrain(**params).link_from(ref_data).collect()
    model = Word2VecTrainBatchOp(**params).link_from(data).collect()
    assert list(model.col("word")) == list(ref_model.col("word"))
    assert model.names == ref_model.names == ["word", "vec"]
    vecs = np.stack([v.data for v in model.col("vec")])
    assert vecs.shape == (len(corpus[1]), 8) and np.isfinite(vecs).all()

    ref_path, path = str(tmp_path / "ref_w2v.ak"), str(tmp_path / "w2v.ak")
    RefSink(filePath=ref_path).link_from(RefTableSource(ref_model)).collect()
    AkSinkBatchOp(filePath=path).link_from(TableSourceBatchOp(model)).collect()
    pred = dict(selectedCol="doc", predictionCol="v")

    def served(op, model_src, data_src):
        out = op(**pred).link_from(model_src, data_src).collect()
        return np.stack([np.asarray(v.data) for v in out.col("v")])

    for model_path in (ref_path, path):      # each package's model, both
        mine = served(Word2VecPredictBatchOp, AkSourceBatchOp(
            filePath=model_path), data)
        theirs = served(RefPredict, RefSource(filePath=model_path), ref_data)
        np.testing.assert_allclose(mine, theirs, rtol=0, atol=1e-7)
        assert mine.shape == (len(docs), 8)


@pytest.mark.parametrize("op_name", ["DeepWalkEmbeddingBatchOp",
                                     "Node2VecEmbeddingBatchOp"])
def test_walk_embedding_ops_run_end_to_end(op_name):
    from alink_tpu.common.mtable import MTable as RefTable
    from alink_tpu.operator import batch as ref_batch
    from alink_tpu.operator.batch.base import \
        TableSourceBatchOp as RefTableSource
    from alink_tpu_torch.common.mtable import MTable
    from alink_tpu_torch.operator import batch

    edges = [(0, 1), (1, 2), (2, 0), (3, 4), (4, 5), (5, 3), (2, 3)]
    cols = {"src": np.asarray([f"n{a}" for a, _ in edges], object),
            "dst": np.asarray([f"n{b}" for _, b in edges], object)}
    params = dict(sourceCol="src", targetCol="dst", walkNum=4, walkLength=6,
                  vectorSize=8, numIter=2, batchSize=16)
    out = getattr(batch, op_name)(**params).link_from(
        batch.TableSourceBatchOp(MTable(cols))).collect()
    ref = getattr(ref_batch, op_name)(**params).link_from(
        RefTableSource(RefTable(cols))).collect()
    assert list(out.col("word")) == list(ref.col("word"))
    vecs = np.stack([v.data for v in out.col("vec")])
    assert vecs.shape == (6, 8) and np.isfinite(vecs).all()
