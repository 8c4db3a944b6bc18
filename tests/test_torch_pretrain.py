"""Port parity of MLM pretraining (``alink_tpu_torch/dl/pretrain.py``), the
streaming corpus (``dl/data.py``) and the torch twin of
``__graft_entry__.entry()`` against ``alink_tpu`` on the CPU.

The configuration is the reference's corpus-scale test's
(``tests/test_corpus_scale.py``): hidden 32, 1 layer, 2 heads,
intermediate 64, ``max_len=24``, 2 epochs, batch 32, on the first 300
review lines, with a 300-entry vocabulary built by each package's
tokenizer (equal). The reference's initial weights are carried into the
port through ``init_params`` (``flax_to_torch``); each reference
configuration runs once, in a module fixture.

Tolerances:
- masks, schedules and streamed rows: equal, bit for bit (the same numpy
  draws);
- loss history, both packages in fp32 (``BertConfig`` bound to
  ``dtype=float32`` in both modules): 1e-5 an epoch. The two frameworks sum
  products, softmax and LayerNorm statistics in other orders (about 1e-7
  relative an op); measured gaps 4.8e-8 (in-memory loop), 2.4e-7
  (``block_rows`` loop) and 1.4e-7 (``accum_steps=2``). adamw turns such
  noise on zero-gradient elements into ±lr steps, which the loss history
  carries no further than this;
- within the port: async ≡ sync, streaming ≡ in-memory and a mid-epoch
  crash-resume ≡ the straight run, bit for bit;
- the entry twin's logits: 1e-4 with both entries built in fp32, the
  tolerance of ``tests/test_torch_bert.py`` (measured 3.6e-7).
"""

import functools
import os

import numpy as np
import pytest
import torch

HIST_ATOL = 1e-5
ENTRY_ATOL = 1e-4

_KW = dict(hidden_size=32, num_layers=1, num_heads=2, intermediate_size=64,
           max_len=24, epochs=2, batch_size=32, seed=0)
# the three loops held against the reference: in-memory, block-scheduled,
# accumulated
_LOOPS = {"in-memory": {}, "block_rows=48": dict(block_rows=48),
          "accum_steps=2": dict(block_rows=48, accum_steps=2)}


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("ALINK_TORCH_DEVICE", "cpu")
    monkeypatch.delenv("NUM_PROCESSES", raising=False)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    from alink_tpu_torch.dl.data import load_reviews

    texts = load_reviews(limit=300)
    p = tmp_path_factory.mktemp("corpus") / "reviews.txt"
    p.write_text("\n".join(texts) + "\n", encoding="utf-8")
    return str(p), texts


@pytest.fixture(scope="module")
def toks(corpus):
    from alink_tpu.dl.tokenizer import Tokenizer as RefTok
    from alink_tpu_torch.dl.tokenizer import Tokenizer

    ref, port = (T.build(corpus[1], vocab_size=300) for T in (RefTok,
                                                              Tokenizer))
    assert ref.to_list() == port.to_list()
    return ref, port


def _ref_init(vocab, dtype):
    """The reference's initial tree for the fixture's configuration (flax
    init depends only on the shapes)."""
    import jax

    from alink_tpu.dl.modules import BertConfig, TransformerEncoder

    cfg = BertConfig(vocab_size=vocab, hidden_size=32, num_layers=1,
                     num_heads=2, intermediate_size=64, max_position=24,
                     dropout=0.0, pool="cls", dtype=dtype)
    z = np.zeros((1, 24), np.int32)
    tree = TransformerEncoder(cfg).init(jax.random.PRNGKey(0), z, z + 1)
    return jax.tree.map(np.asarray, tree)


def _fp32(monkeypatch):
    """Both packages' pretraining builds its BertConfig in fp32."""
    import jax.numpy as jnp

    import alink_tpu.dl.pretrain as ref_pre
    import alink_tpu_torch.dl.pretrain as port_pre

    monkeypatch.setattr(ref_pre, "BertConfig", functools.partial(
        ref_pre.BertConfig, dtype=jnp.float32))
    monkeypatch.setattr(port_pre, "BertConfig", functools.partial(
        port_pre.BertConfig, dtype=torch.float32))


@pytest.fixture(scope="module")
def reference_runs(corpus, toks):
    """The reference's loss history on each loop in fp32, and the initial
    tree they start from."""
    import jax.numpy as jnp

    from alink_tpu.dl.pretrain import pretrain_mlm

    mp = pytest.MonkeyPatch()
    try:
        _fp32(mp)
        init = _ref_init(toks[0].vocab_size, jnp.float32)
        runs = {name: pretrain_mlm(corpus[1], tokenizer=toks[0], **_KW,
                                   **kw)[3]
                for name, kw in _LOOPS.items()}
    finally:
        mp.undo()
    return init, runs


def _port(texts, tok, **kw):
    from alink_tpu_torch.dl.pretrain import pretrain_mlm

    return pretrain_mlm(texts, tokenizer=tok, **{**_KW, **kw})


# ---------------------------------------------------------------------------
# masks and schedules: bit for bit
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_mask_draws_equal_the_reference(seed):
    from alink_tpu.dl import pretrain as ref
    from alink_tpu_torch.dl import pretrain as port

    g = np.random.default_rng(100 + seed)
    ids = g.integers(0, 300, (32, 24)).astype(np.int32)
    attn = (np.arange(24)[None, :] < g.integers(3, 25, (32, 1))) \
        .astype(np.int32)
    a = ref._mask_tokens(ids, attn, 4, 300, np.random.default_rng(seed),
                         0.15)
    b = port._mask_tokens(ids, attn, 4, 300, np.random.default_rng(seed),
                          0.15)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert a[1].any() and (a[0] != ids).any()
    # row-stable draws: any partition of the 32 rows gives the full
    # batch's masks
    full = port._mask_rows(ids, attn, 4, 300, (seed, 1, 3), 32, 0, 0.15)
    ref_full = ref._mask_rows(ids, attn, 4, 300, (seed, 1, 3), 32, 0, 0.15)
    assert all(np.array_equal(x, y) for x, y in zip(full, ref_full))
    for bounds in ((0, 16, 32), (0, 8, 24, 32), (0, 5, 6, 31, 32)):
        for lo, hi in zip(bounds[:-1], bounds[1:]):
            got = port._mask_rows(ids[lo:hi], attn[lo:hi], 4, 300,
                                  (seed, 1, 3), 32, lo, 0.15)
            want = ref._mask_rows(ids[lo:hi], attn[lo:hi], 4, 300,
                                  (seed, 1, 3), 32, lo, 0.15)
            for x, y, z in zip(got, want, full):
                assert np.array_equal(x, y) and np.array_equal(x, z[lo:hi])


def test_schedules_and_corpus_stream_equal_the_reference(tmp_path):
    from alink_tpu.dl import data as ref
    from alink_tpu_torch.dl import data as port

    for n, br, seed, ep in ((517, 64, 0, 0), (517, 64, 5, 3), (10, 3, 2, 1),
                            (1, 4, 0, 0)):
        assert np.array_equal(port.scheduled_order(n, br, seed, ep),
                              ref.scheduled_order(n, br, seed, ep))
        nb = -(-n // br)
        assert np.array_equal(port.block_order(nb, seed, ep),
                              ref.block_order(nb, seed, ep))
    lines = [f"row {i} body" for i in range(517)]
    p = tmp_path / "c.txt"
    # blank lines (and a whitespace-only one) are dropped, as load_reviews
    # drops them
    p.write_text("\n" + "".join(
        line + ("\n" if i % 83 else "\n  \n\n") for i, line in
        enumerate(lines)))
    for limit in (None, 300):
        cs_p = port.CorpusStream(str(p), block_rows=64, buffer_rows=256,
                                 limit=limit)
        cs_r = ref.CorpusStream(str(p), block_rows=64, buffer_rows=256,
                                limit=limit)
        want_rows = limit or len(lines)
        assert cs_p.num_rows == cs_r.num_rows == len(cs_p) == want_rows
        assert cs_p.num_blocks == cs_r.num_blocks
        assert cs_p._block_off == cs_r._block_off
        assert cs_p.read_block(1) == cs_r.read_block(1)
        assert cs_p.sample_texts(70) == cs_r.sample_texts(70) \
            == lines[:70]
        for seed, ep in ((0, 0), (5, 3)):
            rows = list(cs_p.iter_rows(seed, ep))
            assert rows == list(cs_r.iter_rows(seed, ep))
            assert rows == [lines[i] for i in port.scheduled_order(
                want_rows, 64, seed, ep)]
        b_all = list(cs_p.iter_batches(32, 0, 1))
        assert b_all == list(cs_r.iter_batches(32, 0, 1))
        assert b_all[7:] == list(cs_p.iter_batches(32, 0, 1, start_batch=7))
        assert len(b_all[-1][1]) == (want_rows % 32 or 32)
        assert cs_p.max_resident_rows == cs_r.max_resident_rows
        assert cs_p.max_resident_rows <= cs_p.buffer_rows

    # a resumed sweep reads no block wholly before its start
    cs = port.CorpusStream(str(p), block_rows=64, buffer_rows=256)
    reads = []
    real_read = cs.read_block
    cs.read_block = lambda b: reads.append(b) or real_read(b)
    first = port.block_order(cs.num_blocks, 0, 1)
    list(cs.iter_batches(32, 0, 1, start_batch=4))   # rows 128+: block 3 on
    assert reads == [int(b) for b in first[2:]]
    with pytest.raises(ValueError, match="buffer"):
        port.CorpusStream(str(p), block_rows=64, buffer_rows=32)
    with pytest.raises(ValueError, match="buffer_rows"):
        list(port.CorpusStream(str(p), block_rows=2, buffer_rows=4)
             .iter_batches(8, 0, 0))


# ---------------------------------------------------------------------------
# the loss history against the reference's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("loop", list(_LOOPS))
def test_loss_history_matches_reference(reference_runs, corpus, toks,
                                        monkeypatch, loop):
    init, runs = reference_runs
    _fp32(monkeypatch)
    _, params, _, hist = _port(corpus[1], toks[1], init_params=init,
                               **_LOOPS[loop])
    assert len(hist) == 2 and hist[1] < hist[0]
    np.testing.assert_allclose(hist, runs[loop], atol=HIST_ATOL, rtol=0)
    assert all(t.dtype == torch.float32 for t in params.values())


# ---------------------------------------------------------------------------
# the port's own contracts, bit for bit
# ---------------------------------------------------------------------------


def _equal(a, b):
    return sorted(a) == sorted(b) and all(torch.equal(a[k], b[k]) for k in a)


def test_async_feed_gives_the_sync_run(corpus, toks):
    for kw in ({}, dict(block_rows=48, accum_steps=2)):
        _, pa, _, ha = _port(corpus[1], toks[1], feed="async", **kw)
        _, ps, _, hs = _port(corpus[1], toks[1], feed="sync", **kw)
        assert ha == hs and _equal(pa, ps)


def test_streaming_equals_in_memory(corpus, toks):
    from alink_tpu_torch.dl.data import CorpusStream

    path, texts = corpus
    cs = CorpusStream(path, block_rows=48, buffer_rows=96)   # << 300 rows
    _, ps, _, hs = _port(cs, toks[1])
    _, pm, _, hm = _port(texts, toks[1], block_rows=48)
    assert hs == hm and _equal(ps, pm)
    assert cs.max_resident_rows <= cs.buffer_rows


def test_crash_resume_mid_epoch_equals_straight_run(corpus, toks, tmp_path,
                                                    monkeypatch):
    """A crash after the third save (a mid-epoch one: 10 steps an epoch,
    ``checkpoint_every=3``); the resumed run restarts at the saved batch,
    skips the consumed blocks and ends bit-identical."""
    from alink_tpu_torch.common.metrics import metrics
    from alink_tpu_torch.dl import checkpoint as ckpt_mod
    from alink_tpu_torch.dl.data import CorpusStream

    path, _ = corpus

    def stream():
        return CorpusStream(path, block_rows=48, buffer_rows=96)

    _, straight, _, h_straight = _port(stream(), toks[1])
    d = str(tmp_path / "ckpt")
    real_save = ckpt_mod.TrainCheckpointManager.save
    saved = []

    def crashing(self, step, params, opt_state, extra):
        real_save(self, step, params, opt_state, extra)
        saved.append(dict(extra))
        if len(saved) == 3:
            raise RuntimeError("injected mid-epoch crash")

    monkeypatch.setattr(ckpt_mod.TrainCheckpointManager, "save", crashing)
    saves0 = metrics.counter("train.ckpt_saves")
    with pytest.raises(RuntimeError, match="injected mid-epoch crash"):
        _port(stream(), toks[1], checkpoint_dir=d, checkpoint_every=3)
    assert metrics.counter("train.ckpt_saves") == saves0 + 3
    assert saved[-1] == {"epoch": -1, "mid_epoch": 0, "next_batch": 9,
                         "step": 9}
    monkeypatch.setattr(ckpt_mod.TrainCheckpointManager, "save", real_save)
    restored = ckpt_mod.TrainCheckpointManager(d).restore_latest()
    assert restored[2] == saved[-1]
    _, resumed, _, h_resumed = _port(stream(), toks[1], checkpoint_dir=d,
                                     checkpoint_every=3)
    assert _equal(straight, resumed)
    # the resumed run's first epoch averages its one remaining step
    assert h_resumed[-1] == h_straight[-1]


# ---------------------------------------------------------------------------
# the checkpoint directory and the fine-tune that reads it
# ---------------------------------------------------------------------------


def test_saved_checkpoint_reads_in_the_reference_and_seeds_the_finetune(
        corpus, toks, tmp_path, monkeypatch):
    from alink_tpu.dl.pretrained import load_bert_checkpoint as ref_load
    from alink_tpu.dl.pretrained import load_vocab_file as ref_vocab
    from alink_tpu_torch.common.mtable import MTable
    from alink_tpu_torch.dl import train as train_mod
    from alink_tpu_torch.dl.convert import torch_to_flax
    from alink_tpu_torch.dl.pretrain import pretrain_and_save, pretrain_mlm
    from alink_tpu_torch.operator.batch import (
        BertTextClassifierTrainBatchOp, TableSourceBatchOp)

    d = str(tmp_path / "pre")
    kw = dict(_KW, epochs=1, vocab_size=300)
    summary = pretrain_and_save(corpus[1], d, **kw)
    cfg, params, tok, hist = pretrain_mlm(corpus[1], **kw)
    assert summary["vocab_size"] == tok.vocab_size == 300
    assert summary["initial_loss"] == round(hist[0], 4)
    assert ref_vocab(d) == tok.to_list()
    ref_cfg, tree = ref_load(d)
    assert (ref_cfg["hidden_size"], ref_cfg["num_layers"],
            ref_cfg["vocab_size"], ref_cfg["max_position"]) == (32, 1, 300,
                                                                24)
    want = torch_to_flax(params, cfg)["params"]
    assert "type_emb" not in want and "type_emb" not in tree

    def flat(t, pre=""):
        out = {}
        for k, v in t.items():
            out.update(flat(v, f"{pre}{k}/") if isinstance(v, dict)
                       else {pre + k: np.asarray(v)})
        return out

    got, want = flat(tree), flat(want)
    # an HF checkpoint holds the encoder and the pooler, not the head
    assert set(want) - set(got) == {"head/bias", "head/kernel"}
    assert all(np.array_equal(got[k], want[k]) for k in got)

    # the fine-tune op starts from exactly those encoder weights
    seen = {}
    real_train = train_mod.train_model

    def spy(model, inputs, y, tc, **kwargs):
        seen["init"] = flat(kwargs["init_params"]["params"])
        return real_train(model, inputs, y, tc, **kwargs)

    monkeypatch.setattr(train_mod, "train_model", spy)
    src = TableSourceBatchOp(MTable({"text": corpus[1][:8],
                                     "label": np.arange(8) % 2}))
    BertTextClassifierTrainBatchOp(
        textCol="text", labelCol="label", checkpointFilePath=d,
        maxSeqLength=24, numEpochs=1, batchSize=8).link_from(src).collect()
    for k in got:
        assert np.array_equal(seen["init"][k], want[k]), k


def test_refuses_more_than_one_process(corpus, toks, monkeypatch):
    from alink_tpu_torch.common.exceptions import \
        AkUnsupportedOperationException
    from alink_tpu_torch.dl.pretrain import pretrain_and_save

    monkeypatch.setenv("NUM_PROCESSES", "2")
    with pytest.raises(AkUnsupportedOperationException, match="A3"):
        _port(corpus[1], toks[1])
    with pytest.raises(AkUnsupportedOperationException, match="A3"):
        pretrain_and_save(corpus[1], os.devnull, epochs=1)


# ---------------------------------------------------------------------------
# the entry twin
# ---------------------------------------------------------------------------


def test_graft_entry_twin_matches_reference(monkeypatch):
    import jax
    import jax.numpy as jnp

    import __graft_entry__
    import alink_tpu.dl.modules as ref_modules
    import alink_tpu_torch.graft_entry as port_entry
    from alink_tpu_torch.dl.convert import flax_to_torch

    # both entries build their BertConfig in fp32 here
    monkeypatch.setattr(ref_modules, "BertConfig", functools.partial(
        ref_modules.BertConfig, dtype=jnp.float32))
    monkeypatch.setattr(port_entry, "BertConfig", functools.partial(
        port_entry.BertConfig, dtype=torch.float32))
    ref_fwd, (ref_params, ids, mask) = __graft_entry__.entry()
    ref = np.asarray(ref_fwd(ref_params, ids, mask))
    fwd, (params, p_ids, p_mask) = port_entry.entry()
    assert p_ids.device.type == "cpu" and p_ids.shape == (8, 128)
    assert np.array_equal(p_ids.numpy(), ids)
    assert np.array_equal(p_mask.numpy(), mask)
    # the reference's tree has no token-type table (no token types given)
    assert set(flax_to_torch(jax.tree.map(np.asarray, ref_params))) == \
        set(params) - {"type_emb.weight"}
    got = fwd(flax_to_torch(jax.tree.map(np.asarray, ref_params)), p_ids,
              p_mask).numpy()
    assert got.shape == ref.shape == (8, 2)
    np.testing.assert_allclose(got, ref, rtol=0, atol=ENTRY_ATOL)
    # its own seeded weights run too
    assert np.isfinite(fwd(params, p_ids, p_mask).numpy()).all()
