"""The checks of chip_smoke.py, held on the CPU.

chip_smoke.py holds each CUDA kernel against its plain version on the card;
the flash kernel first (its one-block entry, then the fused attention call),
the tree histogram's level call and the SGNS gradients (given rows, and the
fused pull-and-gradients entry) after. Here the same checks run on CPU
tensors, with the kernel's arithmetic re-done in plain torch and rounded to
the input type at the kernel's points. That stand-in must pass; broken
updates that mishandle the carried state, the per-block correction, the
zero keys of a ragged last block or the causal offset must not. Shapes are cut to B=2..4 from the card's B=32; the tolerances are
chip_smoke's own (fp32 atol 1e-5, bf16 bound of its module docstring).
Phase 11's checks (the card's fit against the CPU route, the floors) must
pass a match and reject a perturbation past the tolerance, another
iteration count and a value under the floor. Phase 12's checks must pass a
match and reject: an int8 accumulator off by one, an int8 scale on the
wrong axis, one flipped split, a flash counter that did not rise, a label
flipped past the band, and a KerasSequential route with an unbiased BN
variance or the exact gelu. Phase 13's fp32 check must pass bench.py's
ResNet-50 in fp32 and reject it with TF32 products (operands rounded to
TF32's 10-bit mantissa before every convolution and the head), at 32×32
images; its ONNX writer must give the model's logits; its flax-layout
variables must have the reference's tree. Phase 19 (clustering and
feature engineering) must run end to end at a small size with the CPU in
both routes, and fail when the card route's EM or LDA step drifts from the
CPU route's. Phase 20 (graphs, vector neighbours, text, constrained
features) likewise: end to end at a small size, no kernel launched, and a
failure when the card route's PageRank, neighbour distances or
NaiveBayesText counts part from the CPU route's.
"""

import json
import os

import numpy as np
import pytest
import torch

import chip_smoke
from alink_tpu_torch.dl.attn_cuda import NEG_INF

SCALE = 64 ** -0.5


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("ALINK_TORCH_DEVICE", "cpu")
    monkeypatch.delenv("ALINK_ATTN_PALLAS", raising=False)


def kernel_like(q, k, v, kvalid, ok, o, m, l, *, scale, mutant=None):
    """The kernel's update in plain torch; ``mutant`` breaks it on purpose:
    "drop_state" ignores the incoming o and l, "corr_one" never rescales.
    With bf16 inputs the sums run in fp64, in another order than the plain
    version's fp32 sums, so some scores land across a bf16 rounding boundary
    as the kernel's do; with fp32 inputs they run as the plain version's do
    (a more exact fp64 sum of 128 terms of size ~30 moves o by ~1e-5, the
    whole of the fp32 contract)."""
    def rnd(x):
        return x.to(q.dtype).float()

    acc = torch.float64 if q.dtype == torch.bfloat16 else torch.float32
    s = rnd(torch.einsum("bhqd,bhkd->bhqk", q.to(acc), k.to(acc)).float())
    s = s * scale
    s = torch.where((kvalid[:, None, None, :] > 0) & (ok[None, None] > 0),
                    s, NEG_INF)
    m_new = torch.maximum(m, s.amax(dim=-1))
    corr = torch.exp(torch.clamp(m - m_new, min=NEG_INF))
    if mutant == "corr_one":
        corr = torch.ones_like(corr)
    p = torch.exp(s - m_new[..., None])
    pv = rnd(torch.einsum("bhqk,bhkd->bhqd", rnd(p).to(acc),
                          v.to(acc)).float())
    lsum = p.to(acc).sum(dim=-1).float()
    if mutant == "drop_state":
        return pv, m_new, lsum
    return o * corr[..., None] + pv, m_new, l * corr + lsum


def _mismatch(dtype, fresh, causal=False, K=128, mutant=None):
    args = chip_smoke.block_inputs(3, 2, 128, K, 64, dtype, causal=causal,
                                   fresh=fresh, seed=7, device="cpu")
    got = kernel_like(*args, scale=SCALE, mutant=mutant)
    return max(chip_smoke.block_mismatch(args, got, SCALE)[1].values())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("fresh,causal,K", [(True, False, 128),
                                            (False, False, 128),
                                            (False, True, 100)])
def test_kernel_arithmetic_passes_the_smoke_check(dtype, fresh, causal, K):
    assert _mismatch(dtype, fresh, causal, K) <= 1.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mutant", ["drop_state", "corr_one"])
def test_smoke_check_rejects_a_mishandled_carried_state(dtype, mutant):
    assert _mismatch(dtype, fresh=False, mutant=mutant) > 1.0


def test_blockwise_kernel_route_passes_the_smoke_check():
    from alink_tpu_torch.dl.attention import blockwise_attention

    q, k, v, mask = chip_smoke.attn_inputs(4, 256, 2, 64, torch.bfloat16,
                                           seed=3, device="cpu")
    got = blockwise_attention(q, k, v, mask, block_size=64)
    assert chip_smoke.blockwise_mismatch(q, k, v, mask, got, 64)[1] <= 1.0


def fused_like(q, k, v, mask, block_size, causal=False, mutant=None):
    """The fused kernel's block loop in plain torch: ``kernel_like`` once per
    K/V block in the (B, H, ·, D) layout, the zero keys past S counted as
    masked keys, then o / max(l, 1e-30). ``mutant`` breaks it on purpose:
    "corr_at_end" never rescales o and l per block and applies the last
    block's correction once at the end; "drop_padding" cuts the last block
    at S, so the zero keys never count; "causal_block0" takes every block's
    causal key positions from block 0."""
    b, S, h, d = q.shape
    nb = -(-S // block_size)
    pad = nb * block_size - S
    keys = S if mutant == "drop_padding" else nb * block_size
    kh, vh = (torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad)).transpose(1, 2)
              for x in (k, v))
    kvalid = torch.nn.functional.pad(mask.to(torch.int32), (0, pad))
    o = torch.zeros((b, h, S, d))
    m = torch.full((b, h, S), NEG_INF)
    l = torch.zeros((b, h, S))
    q_pos = torch.arange(S)
    for i in range(nb):
        lo, hi = i * block_size, min((i + 1) * block_size, keys)
        k_pos = torch.arange(lo, hi) - (lo if mutant == "causal_block0" else 0)
        ok = (q_pos[:, None] >= k_pos[None, :]).to(torch.int32) if causal \
            else torch.ones((S, hi - lo), dtype=torch.int32)
        m_old = m
        o, m, l = kernel_like(q.transpose(1, 2), kh[:, :, lo:hi],
                              vh[:, :, lo:hi], kvalid[:, lo:hi], ok, o, m, l,
                              scale=d ** -0.5,
                              mutant="corr_one" if mutant == "corr_at_end"
                              else None)
    if mutant == "corr_at_end":
        corr = torch.exp(torch.clamp(m_old - m, min=NEG_INF))
        o, l = o * corr[..., None], l * corr
    l = torch.clamp(l, min=1e-30)
    return (o / l[..., None]).transpose(1, 2).to(q.dtype)


def _fused_ratio(causal, mutant=None):
    # S = 160 in blocks of 128: 96 zero keys in the last block
    q, k, v, mask = chip_smoke.attn_inputs(4, 160, 2, 64, torch.bfloat16,
                                           seed=3, device="cpu")
    q, k, v = chip_smoke.qkv_views(q, k, v)
    got = fused_like(q, k, v, mask, 128, causal, mutant)
    return chip_smoke.blockwise_mismatch(q, k, v, mask, got, 128, causal)[1]


@pytest.mark.parametrize("causal", [False, True])
def test_fused_route_passes_the_smoke_check(causal):
    assert _fused_ratio(causal) <= 1.0


@pytest.mark.parametrize("mutant,causal", [("corr_at_end", False),
                                           ("drop_padding", False),
                                           ("causal_block0", True)])
def test_smoke_check_rejects_a_broken_fused_route(mutant, causal):
    assert _fused_ratio(causal, mutant) > 1.0


def test_call_bound_counts_each_tensor_once():
    nbytes, flops = chip_smoke.call_bytes_flops(32, 512, 12, 64, itemsize=2)
    assert nbytes == 4 * 32 * 512 * 12 * 64 * 2 + 32 * 512 * 4   # 100.7 MB
    assert flops == 4 * 32 * 12 * 512 * 512 * 64                 # 25.8 GFLOP
    assert nbytes / 3.35e12 > flops / 989e12                      # bytes bound


def test_card_peaks_refuses_an_unknown_card():
    assert chip_smoke.card_peaks("NVIDIA H100 80GB HBM3")[0] == "H100"
    with pytest.raises(SystemExit):
        chip_smoke.card_peaks("NVIDIA A100-SXM4-80GB")


# -- the tree histogram (phase 5) ------------------------------------------
#
# chip_smoke.check_histogram holds the fused level call level_histograms
# against level_histograms_ref at n = 522,911 rows of Covertype-layout bins.
# Here the same check runs at n = 3,001 (not a multiple of any power-of-two
# row chunk) with the plain version standing in for the kernel; broken level
# calls must fail it, with integer vals (exact) and with normal vals (the
# summation bound of chip_smoke's level_mismatch).

HIST_N = 3001
CHANNELS = {              # a test's value kind -> the level call's (g, h, c)
    "g": ("g", "count", "count"),          # the forest's: h is c
    "count": ("count", "g", "g"),
    "normal": ("normal", "g", "count"),    # h != c
}


@pytest.fixture(scope="module")
def covertype_bins():
    from alink_tpu_torch.tree.binning import apply_bins, quantile_bins

    X, y = chip_smoke.covertype_data(HIST_N, seed=0)
    return apply_bins(X, quantile_bins(X, 64)).astype(np.uint8)


def test_covertype_data_keeps_the_file_layout():
    X, y = chip_smoke.covertype_data(HIST_N, seed=0)
    assert X.shape == (HIST_N, 54) and X.dtype == np.float32
    assert len(chip_smoke.COVTYPE_COLS) == 54
    # one wilderness area and one soil type per row
    np.testing.assert_array_equal(X[:, 10:14].sum(1), 1.0)
    np.testing.assert_array_equal(X[:, 14:].sum(1), 1.0)
    assert set(np.unique(y)) == {0, 1} and 0.2 < y.mean() < 0.8


def _ref(bins, node, vals, L):
    from alink_tpu_torch.tree.hist_cuda import level_histograms_ref

    return level_histograms_ref(bins, node, vals, num_nodes=L,
                                num_bins=chip_smoke.HIST_BINS)


def _drop_ragged_chunk(bins, node, vals, L, chunk=512):
    keep = bins.shape[0] // chunk * chunk
    return _ref(bins[:keep], node[:keep], [v[:keep] for v in vals], L)


def _clamp_out_of_range(bins, node, vals, L):
    # bins past B clamped to the last bin instead of landing past the node
    return _ref(bins.clamp(max=chip_smoke.HIST_BINS - 1), node, vals, L)


def _swap_two_features(bins, node, vals, L):
    return tuple(h[:, [1, 0] + list(range(2, h.shape[1]))]
                 for h in _ref(bins, node, vals, L))


def _drop_channel_c(bins, node, vals, L):
    hg, hh, _ = _ref(bins, node, vals, L)
    return hg, hh, torch.zeros_like(hh)


def _swap_h_and_c(bins, node, vals, L):
    hg, hh, hc = _ref(bins, node, vals, L)
    return hg, hc, hh


def _count_outside_nodes(bins, node, vals, L):
    # nodes outside [0, L) counted at the nearest node
    return _ref(bins, node.clamp(0, L - 1), vals, L)


def _level_ratio(bins, level, kind, fn, oob=True):
    b, node, L, vals = chip_smoke.level_inputs(bins, level, seed=level,
                                               device="cpu", oob=oob)
    names = CHANNELS[kind]
    chans = tuple(vals[k] for k in names)
    if names[1] == names[2]:
        chans = chans[:2] + (chans[1],)        # the same tensor: h is c
    got = fn(b, node, chans, L)
    return chip_smoke.level_mismatch(b, node, chans, L, got,
                                     tuple(k != "normal" for k in names))[1]


@pytest.mark.parametrize("kind", ["g", "count", "normal"])
@pytest.mark.parametrize("level,oob", [(0, False), (0, True), (6, True),
                                       (11, True)])
def test_histogram_ref_passes_the_smoke_check(covertype_bins, level, oob,
                                              kind):
    from alink_tpu_torch.tree.hist_cuda import level_histograms

    def kernel(bins, node, vals, L):
        return level_histograms(bins, node, vals, num_nodes=L,
                                num_bins=chip_smoke.HIST_BINS)

    assert _level_ratio(covertype_bins, level, kind, kernel, oob) <= 1.0


@pytest.mark.parametrize("kind", ["g", "normal"])
@pytest.mark.parametrize("mutant", [_drop_ragged_chunk, _clamp_out_of_range,
                                    _swap_two_features])
def test_histogram_smoke_check_rejects_broken_histograms(covertype_bins,
                                                         mutant, kind):
    assert _level_ratio(covertype_bins, 6, kind, mutant) > 1.0


@pytest.mark.parametrize("mutant,kind,oob", [
    (_drop_channel_c, "g", False), (_drop_channel_c, "normal", False),
    (_swap_h_and_c, "normal", False), (_count_outside_nodes, "g", True),
    (_count_outside_nodes, "normal", True)])
@pytest.mark.parametrize("level", [0, 11])
def test_level_smoke_check_rejects_broken_channels_and_nodes(
        covertype_bins, mutant, kind, oob, level):
    assert _level_ratio(covertype_bins, level, kind, mutant, oob) > 1.0


def test_level_cases_cover_the_forest_and_the_edges(covertype_bins):
    # phase 5's cases: the forest's channels with h the same tensor as c,
    # real ones with h != c, and at L = 1, 64, 2048 nodes and bins out of
    # range
    seen = {}
    for level in (0, 3, 6):
        for label, b, node, L, vals, exact in chip_smoke.level_cases(
                torch.from_numpy(covertype_bins), level, level,
                device="cpu"):
            seen[(L, label)] = (b, node, vals, exact)
    assert len(seen) == 2 * 3 + 2 * 2
    b, node, vals, exact = seen[(1, "forest g, count, count (h is c)")]
    assert vals[1] is vals[2] and exact == (True, True, True)
    b, node, vals, exact = seen[(64, "oob normal, g, count (h != c)")]
    assert vals[1] is not vals[2] and exact == (False, True, True)
    assert bool((node < 0).any()) and bool((node >= 64).any())
    assert int(b.max()) >= chip_smoke.HIST_BINS


def test_level_bound_counts_each_input_once():
    # bins, node and the distinct channels read once, their histograms
    # written once: 34.5 MB at L = 1 and 91.1 MB at L = 2048
    n, d = chip_smoke.COVTYPE_TRAIN, 54
    assert chip_smoke.level_bytes(n, d, 1, 2) == \
        n * d + 4 * n + 2 * (4 * n + 4 * 64 * d)
    assert round(chip_smoke.level_bytes(n, d, 2048, 2) / 1e6, 1) == 91.1


def test_predict_oracle_matches_the_ensemble():
    from alink_tpu_torch.tree import train_forest

    X, y = chip_smoke.covertype_data(HIST_N, seed=1)
    ens = train_forest(X, y.astype(np.float32), task="binary", num_trees=4,
                       depth=5, num_bins=64)
    np.testing.assert_allclose(ens.raw_predict(X),
                               chip_smoke.predict_numpy(ens, X), rtol=0,
                               atol=1e-6)


# -- the SGNS block gradients (phase 8) and the Word2Vec path (phase 9) ----
#
# chip_smoke.check_sgns holds sgns_block_grads against sgns_block_grads_ref
# at atol 1e-5. Here a plain-torch stand-in of the kernel's arithmetic (one
# row at a time, grad_v accumulated over the negatives in the kernel's
# order, grad_u rows written to their final places) must pass that check on
# N(0, 1) rows and on rows of tables trained on the CPU; stand-ins that lay
# grad_u's negatives out n-major, or drop the −1 of g_pos, must fail it.


def sgns_like(v, u_pos, u_neg, mutant=None):
    B, negs, D = u_neg.shape
    dot = lambda a, b: (a * b).flip(-1).sum(-1)  # noqa: E731 (another order)
    g_pos = torch.sigmoid(dot(v, u_pos))
    if mutant != "no_minus_one":
        g_pos = g_pos - 1.0
    grad_u = torch.empty(((negs + 1) * B, D))
    grad_u[:B] = g_pos[:, None] * v
    grad_v = g_pos[:, None] * u_pos
    for n in range(negs):
        g = torch.sigmoid(dot(v, u_neg[:, n]))
        grad_v = grad_v + g[:, None] * u_neg[:, n]
        rows = (B + torch.arange(B) * negs + n if mutant != "n_major"
                else B + n * B + torch.arange(B))
        grad_u[rows] = g[:, None] * v
    return grad_v, grad_u


@pytest.fixture(scope="module")
def text8_docs():
    return chip_smoke.text8_corpus(20 * chip_smoke.SENTENCE, seed=0)


@pytest.mark.parametrize("B,negs,D", chip_smoke.SGNS_SHAPES)
def test_sgns_stand_in_passes_the_smoke_check(B, negs, D):
    args = chip_smoke.sgns_normal_inputs(B, negs, D, seed=0, device="cpu")
    assert chip_smoke.sgns_mismatch(args, sgns_like(*args)) \
        <= chip_smoke.FP32_ATOL


def test_sgns_stand_in_passes_on_trained_rows(text8_docs):
    from alink_tpu_torch.embedding.sgns_cuda import pull_rows

    args = pull_rows(**chip_smoke.sgns_trained_step(
        chip_smoke.word_pairs(text8_docs), 256, 5, 100, steps=40,
        device="cpu"))[:3]
    assert args[0].shape == (256, 100) and args[2].shape == (256, 5, 100)
    assert 0 < float(args[2].abs().max()) < 10     # the context table moved
    assert all(bool(torch.isfinite(a).all()) for a in args)
    assert chip_smoke.sgns_mismatch(args, sgns_like(*args)) \
        <= chip_smoke.FP32_ATOL


@pytest.mark.parametrize("mutant", ["n_major", "no_minus_one"])
def test_sgns_smoke_check_rejects_broken_kernels(mutant):
    args = chip_smoke.sgns_normal_inputs(1000, 15, 100, seed=1, device="cpu")
    assert chip_smoke.sgns_mismatch(args, sgns_like(*args, mutant=mutant)) \
        > chip_smoke.FP32_ATOL


# The fused entry: chip_smoke.check_sgns holds sgns_pull_grads against
# sgns_pull_grads_ref on the tables and ids of a trained step, with sentinel
# and duplicate ids, the cache on (replicas that differ from the tables'
# prefix), off and tied, and equal hits. A plain-torch stand-in of the
# kernel (each row read through its id, the gradients of sgns_like, the hot
# ids counted) must pass; stand-ins that read the table for hot ids, read
# sentinel ids as row 0, or count only the centers' hits must fail.


def pull_like(win, w_ctx, center, uids, *, negs, rows, hot, rep_in=None,
              rep_ctx=None, hits=None, mutant=None):
    def read(table, rep, ids):
        inside = (ids >= 0) & (ids < rows)
        if mutant == "sentinel_row0":
            rows_of = table[torch.where(inside, ids, 0)]
        else:
            rows_of = torch.where(inside[:, None],
                                  table[ids.clamp(0, rows - 1)], 0.0)
        if hot > 0 and mutant != "ignore_replica":
            is_hot = (ids >= 0) & (ids < hot)
            rows_of = torch.where(is_hot[:, None],
                                  rep[ids.clamp(0, hot - 1)], rows_of)
        return rows_of

    B, D = center.shape[0], win.shape[1]
    v, u = read(win, rep_in, center), read(w_ctx, rep_ctx, uids)
    if hits is not None:
        n_hot = lambda x: ((x >= 0) & (x < hot)).sum()  # noqa: E731
        hits += n_hot(center)
        if mutant != "miscount_hits":
            hits += n_hot(uids)
    return sgns_like(v, u[:B], u[B:].reshape(B, negs, D))


@pytest.fixture(scope="module")
def trained_step(text8_docs):
    return chip_smoke.sgns_trained_step(chip_smoke.word_pairs(text8_docs),
                                        256, 5, 100, steps=40, device="cpu")


def test_pull_cases_cover_the_ids_and_the_cache(trained_step):
    cases = dict(chip_smoke.pull_cases(trained_step, seed=0))
    hot, rows = trained_step["hot"], trained_step["rows"]
    assert len(cases) == 3 and hot > 0
    on = cases[f"hot cache on ({hot} rows)"]
    ids = torch.cat([on["center"], on["uids"]])
    assert bool((ids == rows).any()) and bool((ids == -1).any())
    assert bool(((ids >= 0) & (ids < hot)).any())
    assert len(torch.unique(ids)) < len(ids)                 # duplicates
    assert not torch.equal(on["rep_in"], on["win"][:hot])    # replica shows
    assert cases["hot cache off"]["hot"] == 0
    tied = cases[f"tied table, hot cache on ({hot} rows)"]
    assert tied["w_ctx"] is tied["win"] and tied["rep_ctx"] is tied["rep_in"]


def test_pull_stand_in_passes_the_smoke_check(trained_step):
    for label, args in chip_smoke.pull_cases(trained_step, seed=0):
        assert chip_smoke.pull_mismatch(args, pull_like) \
            <= chip_smoke.FP32_ATOL, label


@pytest.mark.parametrize("mutant", ["ignore_replica", "sentinel_row0",
                                    "miscount_hits"])
def test_pull_smoke_check_rejects_broken_kernels(trained_step, mutant):
    on = chip_smoke.pull_cases(trained_step, seed=0)[0][1]

    def broken(**kw):
        return pull_like(**kw, mutant=mutant)

    assert chip_smoke.pull_mismatch(on, broken) > chip_smoke.FP32_ATOL


def test_pull_bound_counts_each_row_once():
    # the 7·B ids and their rows read once, grad_v and grad_u written once:
    # 5.79 MB, 1.73 us at 3.35 TB/s
    nbytes = chip_smoke.pull_bytes(1024, 5, 100)
    assert nbytes == 7 * 1024 * 8 + 2 * 7 * 1024 * 100 * 4
    assert round(nbytes / 3.35e12 * 1e6, 2) == 1.73


def test_sgns_bound_counts_each_row_once():
    nbytes, flops = chip_smoke.sgns_bytes_flops(1024, 5, 100)
    assert nbytes == 2 * 7 * 1024 * 100 * 4           # 5.73 MB
    assert nbytes / 3.35e12 > flops / 67e12           # bytes bound it


def test_text8_corpus_keeps_the_layout(text8_docs):
    toks = [d.split(" ") for d in text8_docs]
    assert len(toks) == 20 and {len(t) for t in toks} == {1000}
    ranks = np.asarray([[int(w[1:]) for w in t] for t in toks])
    assert ranks.min() >= 0 and ranks.max() < chip_smoke.TEXT8_TYPES
    # half of each sentence from one topic: its modal topic holds > 45 %
    share = [np.bincount(r % chip_smoke.TOPICS).max() / 1000 for r in ranks]
    assert min(share) > 0.45
    assert text8_docs == chip_smoke.text8_corpus(20 * 1000, seed=0)


def test_topic_share_reads_the_topics():
    words = [f"w{i}" for i in range(3000)]
    topics = np.arange(3000) % chip_smoke.TOPICS
    rng = np.random.default_rng(0)
    clustered = np.eye(chip_smoke.TOPICS)[topics] \
        + 0.01 * rng.normal(size=(3000, chip_smoke.TOPICS))
    assert chip_smoke.topic_share(words, clustered, device="cpu") == 1.0
    noise = rng.normal(size=(3000, 16))
    assert chip_smoke.topic_share(words, noise, device="cpu") < 0.03


# -- wide tables and wide rows (phases 5 and 8) -----------------------------
def test_case_lists_cover_wide_tables_and_rows():
    """Past one feature block of the histogram kernel (256 features) and
    past the SGNS kernel's register-held rows (1,024 entries)."""
    assert min(chip_smoke.WIDE_D) > 256 and 784 in chip_smoke.WIDE_D
    assert [1 << lv for lv in chip_smoke.WIDE_LEVELS] == [1, 64, 2048]
    assert min(chip_smoke.SGNS_WIDE_D) > 1024 and max(
        chip_smoke.SGNS_WIDE_D) >= 2048


@pytest.fixture(scope="module")
def mnist_bins():
    from alink_tpu_torch.tree.binning import apply_bins, quantile_bins

    X, y = chip_smoke.mnist_layout(2_000, seed=0)
    return X, y, apply_bins(X, quantile_bins(X, chip_smoke.HIST_BINS))


def test_mnist_layout_keeps_the_file_layout(mnist_bins):
    X, y, bins = mnist_bins
    assert X.shape == (2_000, 784) and bins.shape == (2_000, 784)
    assert np.array_equal(X, np.round(X)) and X.min() == 0 and X.max() <= 255
    assert 0.1 < float((X > 0).mean()) < 0.3      # MNIST: ~19 % ink
    assert 0.4 < float(y.mean()) < 0.6


def test_wide_histogram_check_passes_the_plain_version(mnist_bins):
    errors, times = chip_smoke.check_wide_histograms(None, mnist_bins[2],
                                                     device="cpu")
    assert len(errors) == 2 * 3 * 4 and max(errors.values()) == 0.0
    assert times == {}


def _drop_second_block(bins, node, vals, L):
    # a feature-block walk that stops after the first block of 256
    return tuple(torch.cat([h[:, :256], torch.zeros_like(h[:, 256:])], 1)
                 for h in _ref(bins, node, vals, L))


@pytest.mark.parametrize("kind", ["g", "normal"])
def test_wide_histogram_check_rejects_a_cut_feature_walk(mnist_bins, kind):
    bins = torch.tensor(mnist_bins[2][:, :300].copy())
    assert _level_ratio(bins, 6, kind, _drop_second_block) > 1.0


def test_wide_sgns_check_passes_the_plain_versions():
    errors = chip_smoke.check_sgns_wide(B=32, rows=3_000, device="cpu")
    assert len(errors) == 2 * (2 + 3) and max(errors.values()) == 0.0


# -- the flash route's backward (phase 10) ----------------------------------
def bwd_like(q, k, v, kmask, out, dout, *, block_size, causal, scale,
             mutant=None):
    """The backward in plain torch over the whole score matrix. ``mutant``
    breaks it on purpose: "masked_carry" lets masked scores carry gradient,
    "no_rowsum" drops the rowsum(dO∘O) term, "unpadded" leaves out the zero
    keys of the ragged last block (a fully masked row then spreads over S
    keys, not over whole blocks)."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    pad = 0 if mutant == "unpadded" else -sk % block_size
    kp, vp = (torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad)) for x in (k, v))
    km = torch.nn.functional.pad(kmask.to(torch.int32), (0, pad))
    qf, kf, vf, do = (x.float() for x in (q, kp, vp, dout))
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    ok = (km[:, None, None, :] > 0).expand_as(s)
    if causal:
        ok = ok & torch.ones(s.shape[-2:], dtype=torch.bool).tril()
    p = torch.softmax(torch.where(ok, s, NEG_INF), dim=-1)
    dp = torch.einsum("bqhd,bkhd->bhqk", do, vf)
    dsum = (do * out.float()).sum(-1).transpose(1, 2)[..., None]
    ds = p * dp if mutant == "no_rowsum" else p * (dp - dsum)
    if mutant != "masked_carry":
        ds = torch.where(ok, ds, 0.0)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do)
    return tuple(x.to(q.dtype) for x in (dq, dk[:, :sk], dv[:, :sk]))


BWD_CASES = [("S=40", 40, False, False), ("S=40 causal views", 40, True, True),
             ("ragged S=36 views", 36, False, True)]


def _bwd_ratio(monkeypatch, dtype, S, causal, views, fn=None):
    from alink_tpu_torch.dl import attn_cuda

    if fn is not None:
        monkeypatch.setattr(attn_cuda, "flash_blockwise_bwd", fn)
    q, k, v, mask = chip_smoke.attn_inputs(4, S, 2, 16, dtype, seed=5,
                                           device="cpu")
    ct = torch.tensor(np.random.default_rng(6).standard_normal(q.shape),
                      dtype=torch.float32).to(dtype)
    _, got = chip_smoke.route_grads(q, k, v, mask, ct, 16, causal, views)
    monkeypatch.undo()
    monkeypatch.setenv("ALINK_TORCH_DEVICE", "cpu")
    return chip_smoke.backward_mismatch(q, k, v, mask, ct, got, 16,
                                        causal)[1]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("label,S,causal,views", BWD_CASES)
def test_backward_check_passes_the_port_and_a_stand_in(monkeypatch, dtype,
                                                       label, S, causal,
                                                       views):
    assert _bwd_ratio(monkeypatch, dtype, S, causal, views) <= 1.0
    assert _bwd_ratio(monkeypatch, dtype, S, causal, views, bwd_like) <= 1.0


@pytest.mark.parametrize("mutant,case", [("masked_carry", 0),
                                         ("no_rowsum", 1),
                                         ("unpadded", 2)])
def test_backward_check_rejects_broken_backwards(monkeypatch, mutant, case):
    _, S, causal, views = BWD_CASES[case]

    def broken(*a, **kw):
        return bwd_like(*a, mutant=mutant, **kw)

    assert _bwd_ratio(monkeypatch, torch.float32, S, causal, views,
                      broken) > 1.0


def test_training_flops_count_the_layers_and_attention():
    from alink_tpu_torch.dl.modules import BertConfig

    cfg = BertConfig.base()
    assert chip_smoke.layer_matmul_params(cfg) == 84_934_656
    flops = chip_smoke.train_step_flops(cfg, 32, 128)
    assert flops == 6 * 84_934_656 * 32 * 128 + 12 * 12 * 32 * 128 ** 2 * 768


# -- phase 11: the classical path's checks ---------------------------------

def test_classical_case_list_covers_both_baselines_and_the_sparse_route():
    labels = [c[0] for c in chip_smoke.CLASSICAL_CASES]
    sources = [c[1] for c in chip_smoke.CLASSICAL_CASES]
    assert [lab.split()[0] for lab in labels] == ["11.1", "11.2", "11.3",
                                                  "11.4"]
    assert sources == ["bench.py:246-279", "chip_smoke.mnist_layout",
                       "bench.py:281-350",
                       "examples/sparse_highdim_logistic.py"]
    assert chip_smoke.SOFTMAX_ROWS == (20_000, 60_000)
    assert chip_smoke.KMEANS_REAL == dict(k=10, maxIter=50)
    assert chip_smoke.SOFTMAX_GATE_L2 > 0 \
        and chip_smoke.SOFTMAX_PERMUTATIONS >= 2
    assert (chip_smoke.SPARSE_ROWS, chip_smoke.SPARSE_DIM,
            chip_smoke.SPARSE_ITERS) == (300, 1_000_000, 20)


@pytest.mark.parametrize("relative,tol", [(False, chip_smoke.CENTROID_ATOL),
                                          (True, chip_smoke.CENTROID_RTOL)])
def test_fit_check_passes_a_match_and_rejects_a_perturbation(relative, tol):
    want = np.random.default_rng(0).normal(size=(10, 784)) \
        .astype(np.float32) * 100
    scale = float(np.abs(want).max()) if relative else 1.0
    near = want.copy()
    near[3, 5] += 0.5 * tol * scale
    far = want.copy()
    far[7, 2] -= 2.0 * tol * scale
    assert chip_smoke.fit_mismatch(want, want, 12, 12, tol, relative) is None
    assert chip_smoke.fit_mismatch(near, want, 12, 12, tol, relative) is None
    assert "max |Δ|" in chip_smoke.fit_mismatch(far, want, 12, 12, tol,
                                                relative)


def _softmax_weights():
    Wc = np.random.default_rng(0).normal(size=(785, 10)).astype(np.float32)
    scale = float(np.abs(Wc).max())
    spread = Wc.copy()
    spread[1, 2] += 1e-4 * scale      # a permutation's spread: 1e-4
    return Wc, scale, spread


@pytest.mark.parametrize("factor", [0.5, 5.0, 20.0])
def test_softmax_gate_scales_with_the_measured_spread(factor):
    """The card passes within SOFTMAX_SPREAD_FACTOR permutation spreads of
    the CPU route's weights and fails beyond; the tolerance is read from
    the permuted fits, the largest of them."""
    Wc, scale, spread = _softmax_weights()
    small = Wc.copy()
    small[0, 0] -= 0.3e-4 * scale
    card = Wc.copy()
    card[4, 4] += factor * 1e-4 * scale
    tol, problems = chip_smoke.softmax_weight_gate(
        card, 25, Wc, 25, [small, spread], {})
    assert tol == pytest.approx(chip_smoke.SOFTMAX_SPREAD_FACTOR * 1e-4,
                                rel=1e-3)
    passes = factor < chip_smoke.SOFTMAX_SPREAD_FACTOR
    assert (problems == []) == passes
    if not passes:
        assert "max |Δ| (relative)" in problems[0]


def test_softmax_gate_must_reject_its_wrong_routes():
    """A wrong route on the card (TF32 products, the bf16 wire) that lands
    inside the gate, by weights and numIters, fails the gate itself; one
    that stops at another iteration or lies outside is rejected."""
    Wc, scale, spread = _softmax_weights()
    far = Wc + 1e-2 * scale
    near = Wc.copy()
    near[2, 2] += 2e-4 * scale
    _, problems = chip_smoke.softmax_weight_gate(
        Wc, 25, Wc, 25, [spread], {"TF32": (far, 25), "bf16 wire":
                                   (near, 24)})
    assert problems == []
    _, problems = chip_smoke.softmax_weight_gate(
        Wc, 25, Wc, 25, [spread], {"TF32": (near, 25)})
    assert len(problems) == 1 and "does not reject the TF32 route" \
        in problems[0]
    _, problems = chip_smoke.softmax_weight_gate(
        Wc, 26, Wc, 25, [spread], {})
    assert "numIters 26 on the card, 25" in problems[0]


def test_fit_check_rejects_another_iteration_count():
    c = np.ones((3, 4), np.float32)
    assert "numIters 13 on the card, 12" in chip_smoke.fit_mismatch(
        c, c, 13, 12, chip_smoke.CENTROID_ATOL)
    assert "shape" in chip_smoke.fit_mismatch(c[:2], c, 12, 12, 1e-4)


def test_floors_reject_purity_and_accuracy_below_them():
    floor = chip_smoke.DIGITS_REFERENCE_ACC - chip_smoke.DIGITS_SLACK
    assert chip_smoke.below_floor(floor, floor, "acc") is None
    assert "below" in chip_smoke.below_floor(floor - 1e-9, floor, "acc")
    assert "below" in chip_smoke.below_floor(float("nan"), floor, "acc")
    pred = np.asarray([0, 0, 1, 1, 2, 2])
    assert chip_smoke.purity(pred, ["a", "a", "b", "b", "c", "c"]) == 1.0
    assert chip_smoke.purity(pred, ["a", "b", "a", "b", "c", "c"]) \
        == pytest.approx(4 / 6)
    assert chip_smoke.IRIS_REFERENCE_PURITY == 134 / 150


def test_classical_data_keep_their_sources_layout():
    """bench.py's Softmax problem and the sparse example's rows, from the
    same seeds as their sources."""
    table, feats = chip_smoke.softmax_table(50)
    assert len(feats) == 784 and table.num_rows == 50
    labels = np.asarray(table.col("label"))
    assert labels.dtype == np.int64 and labels.min() >= 0 \
        and labels.max() <= 9
    rng = np.random.default_rng(1)
    W = rng.normal(size=(784, 10)).astype(np.float32)
    X = rng.normal(size=(50, 784)).astype(np.float32)
    np.testing.assert_array_equal(table.col("p3"), X[:, 3])
    y = (X @ W + 0.5 * rng.normal(size=(50, 10))).argmax(1)
    np.testing.assert_array_equal(labels, y)
    sparse = chip_smoke.sparse_table()
    cells = sparse.col("vec")
    assert sparse.num_rows == chip_smoke.SPARSE_ROWS
    assert all(c.n == chip_smoke.SPARSE_DIM and c.indices[0] == 0
               and c.indices.size == 8 for c in cells)
    assert ((np.asarray([c.values[0] for c in cells]) > 0)
            == (np.asarray(sparse.col("label")) == 1)).mean() > 0.99


def test_torch_device_switches_and_restores(monkeypatch):
    monkeypatch.delenv("ALINK_TORCH_DEVICE")
    with chip_smoke.torch_device("cpu"):
        assert os.environ["ALINK_TORCH_DEVICE"] == "cpu"
    assert "ALINK_TORCH_DEVICE" not in os.environ
    monkeypatch.setenv("ALINK_TORCH_DEVICE", "cuda")
    with chip_smoke.torch_device("cpu"):
        pass
    assert os.environ["ALINK_TORCH_DEVICE"] == "cuda"


# -- phase 12: model families -------------------------------------------------
def test_model_family_case_list():
    """The bands are the reference's ServingConfig defaults; the cells are
    the issue's: mnist_mlp's layers, Covertype at maxDepth 12, the check at
    60,000 rows and maxDepth 8."""
    from alink_tpu.serving.router import ServingConfig

    cfg = ServingConfig()
    assert (chip_smoke.QUANT_BAND, chip_smoke.QUANT_TOL) == (
        cfg.quant_band, cfg.quant_tol)
    assert chip_smoke.POLICIES == ("bf16", "int8")
    assert chip_smoke.CALIB_ROWS == 1_024
    assert [n for n, _ in chip_smoke.IMPURITY_OPS] == ["Cart", "C45", "Id3"]
    assert chip_smoke.IMPURITY["maxDepth"] == 12 \
        and chip_smoke.IMPURITY["maxBins"] == 64
    assert chip_smoke.IMPURITY_CHECK["maxDepth"] == 8 \
        and chip_smoke.IMPURITY_CHECK_ROWS == 60_000
    assert chip_smoke.KERAS_LAYERS == [
        "Dense(512, activation=relu)", "Dropout(0.2)",
        "Dense(512, activation=relu)", "Dropout(0.2)"]
    assert chip_smoke.KERAS_MNIST["batchSize"] == 128 \
        and chip_smoke.KERAS_MNIST["numEpochs"] == 1
    assert sum("BatchNorm" in s for s in chip_smoke.KERAS_BN_LAYERS) == 2
    assert all("gelu" in s for s in chip_smoke.KERAS_BN_LAYERS
               if s.startswith("Dense"))


def test_accumulator_check_rejects_an_off_by_one():
    from alink_tpu_torch.common import quant

    g = torch.Generator().manual_seed(0)
    a = torch.randint(-127, 128, (40, 24), dtype=torch.int8, generator=g)
    b = torch.randint(-127, 128, (24, 10), dtype=torch.int8, generator=g)
    want = quant.int8_matmul_ref(a, b)
    assert chip_smoke.accumulator_mismatch(torch._int_mm(a, b), want) == 0
    off = want.clone()
    off[3, 7] += 1
    assert chip_smoke.accumulator_mismatch(off, want) == 1


def _tiny_bert():
    from alink_tpu_torch.dl.modules import BertConfig, TransformerEncoder

    return TransformerEncoder(BertConfig.tiny(
        dtype=torch.float32, vocab_size=64, max_position=16)).init_weights(0)


def test_dequant_check_rejects_a_scale_on_the_wrong_axis():
    from alink_tpu_torch.dl.train import served_state

    model = _tiny_bert()
    served = dict(served_state(model, "int8"))
    assert chip_smoke.dequant_mismatch(model, served) == 0.0
    name = "layers.0.attention.out.weight"           # (hd, hd): square
    q, s = served[name]
    assert s.shape == (q.shape[0], 1)
    served[name] = (q, s.reshape(1, -1))             # per input column
    assert chip_smoke.dequant_mismatch(model, served) > 0.0
    q, s = served["layers.0.attention.qkv.weight"]
    assert s.shape == (q.shape[0], 1)                # rows r mod h·d


def test_tree_check_rejects_a_flipped_split():
    from alink_tpu_torch.tree import train_tree_impurity

    X, y = chip_smoke.covertype_data(2_000, seed=0)
    ens = train_tree_impurity(X, y, criterion="gini", num_classes=2,
                              depth=5, device="cpu")
    again = train_tree_impurity(X, y, criterion="gini", num_classes=2,
                                depth=5, device="cpu")
    assert chip_smoke.tree_mismatch(ens, again) == []
    node = int(np.nonzero(ens.feats[0] >= 0)[0][-1])
    again.feats = again.feats.copy()
    again.feats[0, node] = (again.feats[0, node] + 1) % X.shape[1]
    assert chip_smoke.tree_mismatch(ens, again) == [node]


def test_leaf_id_oracle_is_the_device_traversal():
    from alink_tpu_torch.tree import train_gbdt

    X, y = chip_smoke.covertype_data(1_500, seed=1)
    ens = train_gbdt(X, y, task="binary", num_trees=4, depth=4,
                     device="cpu")
    np.testing.assert_array_equal(chip_smoke.leaf_ids_numpy(ens, X),
                                  ens.leaf_ids(X, device="cpu"))


def test_flash_rise_check_rejects_a_counter_that_did_not_rise():
    assert chip_smoke.flash_rise_problem(12, 1, 12, "x") is None
    assert chip_smoke.flash_rise_problem(24, 2, 12, "x") is None
    assert chip_smoke.flash_rise_problem(0, 1, 12, "x")
    assert chip_smoke.flash_rise_problem(11, 1, 12, "x")


def test_band_rejects_a_flipped_label():
    from alink_tpu_torch.common.mtable import MTable

    n = 64
    base = MTable({"text": np.asarray(["t"] * n, object),
                   "pred": np.zeros(n, np.int64),
                   "detail": np.asarray(['{"0": 0.6}'] * n, object)})
    assert chip_smoke.band_report(base, base)["ok"]
    flipped = base.take(np.arange(n))
    pred = np.zeros(n, np.int64)
    pred[5] = 1
    flipped = MTable({"text": base.col("text"), "pred": pred,
                      "detail": base.col("detail")})
    rep = chip_smoke.band_report(base, flipped)
    assert not rep["ok"] and rep["agreement"] < 1.0


KERAS_ROWS = 1_024


@pytest.fixture(scope="module")
def keras_routes():
    """12.5(c)'s route on the CPU at 1,024 MNIST-layout rows (8 steps), the
    port as it is and two mutants: the running variance unbiased, and the
    exact gelu for the tanh form."""
    import torch.nn.functional as F

    from alink_tpu_torch.dl import modules

    X, y = chip_smoke.mnist_layout(KERAS_ROWS, seed=0)
    X /= 255.0
    init = modules.KerasSequential(chip_smoke.KERAS_BN_LAYERS, 2, 784) \
        .init_weights(0).state_dict()
    spe = -(-KERAS_ROWS // chip_smoke.KERAS_BN_TRAIN["batch_size"])

    def run():
        return chip_smoke.keras_route(X, y, init, "cpu", spe)

    out = {"port": run()}
    with pytest.MonkeyPatch.context() as mp:
        real = modules.BatchNorm.forward

        def unbiased(self, x, deterministic=True):
            if deterministic:
                return real(self, x, deterministic)
            n = x.shape[0]
            mean = x.mean(0)
            var = x.var(0, unbiased=True)
            with torch.no_grad():
                self.mean.copy_(0.99 * self.mean + 0.01 * mean)
                self.var.copy_(0.99 * self.var + 0.01 * var)
            biased = var * (n - 1) / n
            return (x - mean) * (torch.rsqrt(biased + self.EPS)
                                 * self.weight) + self.bias

        mp.setattr(modules.BatchNorm, "forward", unbiased)
        out["unbiased_var"] = run()
    with pytest.MonkeyPatch.context() as mp:
        real_act = modules.activation
        mp.setattr(modules, "activation", lambda name, x: F.gelu(x)
                   if name == "gelu" else real_act(name, x))
        out["exact_gelu"] = run()
    # a small systematic drift of the loss history, 2x KERAS_LOSS_ATOL
    out["loss_drift"] = dict(out["port"], loss=[
        v + 2 * chip_smoke.KERAS_LOSS_ATOL for v in out["port"]["loss"]])
    return out


def test_keras_route_check_passes_the_port(keras_routes):
    port = keras_routes["port"]
    assert chip_smoke.keras_route_problems(port, port) == []
    noisy = dict(port, loss=[v + 1e-6 for v in port["loss"]],
                 probe_logits=port["probe_logits"] + 1e-7)
    assert chip_smoke.keras_route_problems(noisy, port) == []


@pytest.mark.parametrize("mutant", ["unbiased_var", "exact_gelu",
                                    "loss_drift"])
def test_keras_route_check_rejects_mutants(keras_routes, mutant):
    assert chip_smoke.keras_route_problems(keras_routes[mutant],
                                           keras_routes["port"])


def test_ingest_case_list():
    """Phase 13's cells: BASELINE #3 at bench.py's batch, 1,000 rows (three
    full batches and a 232-row tail), BASELINE #5's 16,384 rows in chunks
    of 4,096; the five cases in order."""
    assert [label.split()[0] for label, _ in chip_smoke.INGEST_CASES] == [
        "13.1", "13.2", "13.3", "13.4", "13.5"]
    assert [src for _, src in chip_smoke.INGEST_CASES][0] == \
        "bench.py:355-513"
    assert chip_smoke.INGEST_CASES[3][1] == "bench.py:549-582"
    assert (chip_smoke.RESNET_BATCH, chip_smoke.RESNET_SIDE) == (256, 224)
    assert chip_smoke.RESNET_ROWS == 3 * 256 + 232
    assert (chip_smoke.STREAM_ROWS, chip_smoke.STREAM_CHUNK) == (16_384,
                                                                 4_096)
    assert chip_smoke.INGEST_RTOL == 1e-4


def _tf32(t):
    """``t`` rounded to TF32 (10 mantissa bits, to nearest)."""
    i = t.float().contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


@pytest.fixture(scope="module")
def small_resnet50():
    """bench.py's ResNet-50 (chip_smoke's copy) on 2 seeded 32×32 images:
    the model, the images, its float64 logits."""
    import copy

    model = chip_smoke.bench_resnet50()
    x = torch.from_numpy(chip_smoke.resnet_images(2, side=32))
    with torch.no_grad():
        ref64 = copy.deepcopy(model).double()(x.double()).numpy()
    return model, x, ref64


def test_fp32_check_rejects_tf32_products(small_resnet50):
    import copy

    model, x, ref64 = small_resnet50
    with torch.no_grad():
        fp32 = model(x).numpy()
        tf32 = copy.deepcopy(model)
        for m in tf32.modules():
            if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear)):
                m.weight.copy_(_tf32(m.weight))
                m.register_forward_pre_hook(
                    lambda mod, args: (_tf32(args[0]),))
        tf32 = tf32(x).numpy()
    err, bound = chip_smoke.logit_check(fp32, ref64, chip_smoke.INGEST_RTOL)
    assert err <= bound
    err, bound = chip_smoke.logit_check(tf32, ref64, chip_smoke.INGEST_RTOL)
    assert err > bound
    problems, out = [], {}
    chip_smoke.check_logits("tf32", tf32, ref64, chip_smoke.INGEST_RTOL,
                            problems, out)
    assert problems and out["tf32"]["max_abs_err"] == err


def test_onnx_writer_gives_the_models_logits(small_resnet50, tmp_path,
                                             monkeypatch):
    from alink_tpu_torch.onnx import load_onnx_fn

    model, x, ref64 = small_resnet50
    path = str(tmp_path / "r.onnx")
    assert chip_smoke.onnx_resnet50(model, path) == 175
    fn, conv = load_onnx_fn(path)
    got = fn(x=x)["logits"].numpy()
    err, bound = chip_smoke.logit_check(got, ref64, chip_smoke.INGEST_RTOL)
    assert got.shape == (2, 1000) and err <= bound


def test_flax_resnet50_variables_have_the_reference_tree():
    import jax

    from alink_tpu.dl.resnet import resnet50

    want = jax.eval_shape(resnet50(dtype=np.float32).init,
                          jax.random.PRNGKey(0),
                          np.zeros((1, 32, 32, 3), np.float32))
    got = chip_smoke.flax_resnet50_variables(np.random.default_rng(0))
    assert jax.tree_util.tree_structure(got) == \
        jax.tree_util.tree_structure(want)
    assert jax.tree_util.tree_all(jax.tree_util.tree_map(
        lambda a, b: a.shape == b.shape and a.dtype == b.dtype, got, want))


# ---------------------------------------------------------------------------
# phase 14: BERT-base serving through ModelServer
# ---------------------------------------------------------------------------


def test_serving_case_list():
    """Phase 14's cell: batches of up to 64 rows flushed
    after 5 ms, warmed at the 8 rungs 8 … 64; 8 clients sending 512
    single-row requests beside 4 predict_many of 32; a queue of 16 under a
    burst of 200; the cases in order, both policies."""
    from alink_tpu_torch.serving import serving_bucket_ladder

    assert chip_smoke.SERVING == dict(max_batch_rows=64,
                                      flush_deadline_s=0.005)
    assert chip_smoke.SERVING_RUNGS == serving_bucket_ladder(64)
    assert (chip_smoke.SERVING_CLIENTS, chip_smoke.SERVING_SINGLE,
            chip_smoke.SERVING_MANY) == (8, 512, (4, 32))
    assert (chip_smoke.SERVING_QUEUE, chip_smoke.SERVING_BURST) == (16, 200)
    assert [c.split()[0] for c in chip_smoke.SERVING_CASES] == [
        "14.1", "14.2", "14.3", "14.4", "14.5", "14.5", "14.6", "14.7"]
    assert [c for c in chip_smoke.SERVING_CASES if c.startswith("14.5")] \
        == [f"14.5 {p} load" for p in chip_smoke.POLICIES]
    assert chip_smoke.MARGIN_BOUND == 2 * chip_smoke.LOGIT_ATOL


def _served_row(p1, label=None):
    detail = json.dumps({"0": 1.0 - p1, "1": p1})
    return ("t", int(p1 > 0.5) if label is None else label, detail)


def test_rung_report_holds_same_rung_rows_exactly():
    serial = [_served_row(0.7), _served_row(0.2), _served_row(0.5001)]
    same = [(serial[0], 1), (serial[1], 8), (serial[2], 3)]
    rep, bad = chip_smoke.rung_report(same, serial, "t")
    assert not bad and rep["same_rung_identical"] == 3
    # one bit off at the serial predict's rung fails
    nudged = _served_row(0.7 + 1e-12)
    rep, bad = chip_smoke.rung_report([(nudged, 5)], serial[:1], "t")
    assert bad and rep["same_rung"] == 1
    # the same nudge at another rung passes, counted as not identical
    rep, bad = chip_smoke.rung_report([(nudged, 40)], serial[:1], "t")
    assert not bad and rep["cross_rung"] == 1 \
        and rep["cross_rung_identical"] == 0
    # past the bound, or a flipped label where the gap is decisive, fails
    far = _served_row(0.71)
    assert chip_smoke.rung_report([(far, 64)], serial[:1], "t")[1]
    flip = _served_row(0.7, label=0)
    assert chip_smoke.rung_report([(flip, 64)], serial[:1], "t")[1]
    # a flip inside the bound (a near tie) is allowed
    tie = _served_row(0.5001, label=0)
    assert not chip_smoke.rung_report([(tie, 64)], serial[2:], "t")[1]


def test_batch_error_check_passes_the_server():
    assert chip_smoke.check_batch_errors() == []


def test_batch_error_check_rejects_a_server_that_swallows(monkeypatch):
    """A batcher that catches the batch's error and completes its requests
    with no row, or drops them (they hang), must fail 14.7."""
    from alink_tpu_torch.serving import router

    def answers_none(self, batch):
        try:
            self.predictor.predict_table(None)
        except BaseException:
            for req in batch:
                req.future._complete(None, None)

    def drops(self, batch):
        try:
            self.predictor.predict_table(None)
        except BaseException:
            pass

    for mutant in (answers_none, drops):
        monkeypatch.setattr(router._ModelEntry, "_run_batch", mutant)
        assert chip_smoke.check_batch_errors(wait_s=0.5)


def test_serving_launch_check_rejects_a_server_without_the_kernel():
    """14.1 and 14.2 hold the flash counter to 12 launches a served
    forward: a server whose batches ran without the kernel (the counter
    did not rise) fails."""
    assert chip_smoke.flash_rise_problem(96, 8, 12, "14.1") is None
    assert chip_smoke.flash_rise_problem(0, 8, 12, "14.1")
    assert chip_smoke.flash_rise_problem(12 * 40, 41, 12, "14.2")


# -- phase 19: clustering and feature engineering ---------------------------
def test_text8_corpus_topics_are_the_sentences_topics():
    """``with_topics`` returns the sentences unchanged and each one's
    topic: the modal topic of its words (rank mod 100)."""
    docs, topics = chip_smoke.text8_corpus(20 * 1000, seed=0,
                                           with_topics=True)
    assert docs == chip_smoke.text8_corpus(20 * 1000, seed=0)
    ranks = np.asarray([[int(w[1:]) for w in d.split(" ")] for d in docs])
    modal = [np.bincount(r % chip_smoke.TOPICS).argmax() for r in ranks]
    np.testing.assert_array_equal(modal, topics)


def test_dbscan_eps_sits_off_the_data():
    """ε is the median 10th-neighbour distance of the sample, rounded to
    three significant digits (so that no pair of rows is at it)."""
    rng = np.random.default_rng(0)
    X = rng.normal(size=(2000, 5)).astype(np.float32)
    eps = chip_smoke.dbscan_eps(X)
    assert eps == float(f"{eps:.3g}")
    d = np.sqrt(((X[:200, None, :].astype(np.float64) - X[None]) ** 2)
                .sum(-1))
    kth = np.sort(d, axis=1)[:, chip_smoke.DBSCAN_MIN_POINTS]
    assert np.quantile(kth, 0.3) < eps < np.quantile(kth, 0.7)


class _Event:
    """A host-clock stand-in of ``torch.cuda.Event``."""

    def __init__(self, **kw):
        self.t = None

    def record(self):
        import time

        self.t = time.perf_counter()

    def elapsed_time(self, other):
        return (other.t - self.t) * 1e3


def _phase19_on_cpu(monkeypatch):
    """Phase 19 at a small size with the CPU standing in for the card:
    CUDA events, syncs and memory stats stubbed, the profiler on CPU
    activity, the sizes cut."""
    import functools

    import torch.profiler as tp

    for name, value in (("Event", _Event), ("synchronize", lambda *a: None),
                        ("memory_allocated", lambda *a: 0),
                        ("max_memory_allocated", lambda *a: 1),
                        ("reset_peak_memory_stats", lambda *a: None)):
        monkeypatch.setattr(torch.cuda, name, value)
    orig = tp.profile
    monkeypatch.setattr(tp, "profile", lambda activities=None, **kw: orig(
        activities=[tp.ProfilerActivity.CPU], **kw))
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(chip_smoke, "count_syncs", lambda fn: (fn(), 0))
    monkeypatch.setattr(chip_smoke, "gmm_direct", functools.partial(
        chip_smoke.gmm_direct, device="cpu"))
    for name, value in (("COVTYPE_TRAIN", 4_000), ("COVTYPE_TEST", 500),
                        ("WIDE_ROWS", 1_000), ("BKM_CHECK_ROWS", 400),
                        ("LDA_TOKENS", 60_000), ("LDA_CHECK_DOCS", 20),
                        ("LDA", dict(vocabSize=800, topicNum=20, numIter=2)),
                        ("DBSCAN_ROWS", 1_500), ("DBSCAN_EPS_SAMPLE", 200)):
        monkeypatch.setattr(chip_smoke, name, value)


def test_clustering_features_phase_passes_on_the_cpu(monkeypatch, capsys):
    """Phase 19 runs end to end at a small size on the CPU (both routes
    the CPU): every part reports, no check fails, no kernel launches."""
    _phase19_on_cpu(monkeypatch)
    out = chip_smoke.clustering_features_path("cpu stand-in")
    assert set(out) == {"19.1", "19.2", "19.3", "19.4"}
    g = out["19.1"]
    assert g["em_iterations"] == chip_smoke.FEATURE_GMM["maxIter"]
    assert g["em_host_syncs"] == g["em_iterations"] - 1
    assert len(g["em_step_ms"]) == g["em_iterations"]
    assert g["components_differ"] == 0 and g["ll_rel_err"] == 0.0
    assert g["pca_dim"] == chip_smoke.FEATURE_PCA_K
    assert g["nkdd_bytes"] == 4_000 * 7 * 10 * 10 * 4
    assert [s[0] for s in out["19.2"]["splits"]][0] == 1_000
    assert len(out["19.2"]["splits"]) == chip_smoke.BKM_K - 1
    assert len(out["19.3"]["outer_ms"]) == 2
    assert out["19.4"]["labels_differ"] == 0
    assert "phase 19: {" in capsys.readouterr().out


def test_clustering_features_phase_fails_when_the_routes_part(monkeypatch,
                                                              capsys):
    """A card route whose EM or LDA step drifts from the CPU route's fails
    the phase (the CPU stands in for both routes; the stand-in card is
    whatever runs outside ``chip_smoke.torch_device("cpu")``)."""
    import contextlib

    from alink_tpu_torch.operator.batch import clustering2 as c2

    _phase19_on_cpu(monkeypatch)
    step, outer = c2._gmm_step, c2._lda_outer
    cpu_route = []

    @contextlib.contextmanager
    def torch_device(name):
        cpu_route.append(name)
        try:
            yield
        finally:
            cpu_route.pop()

    def drifting_step(*a, **kw):
        w, mu, cov, ll = step(*a, **kw)
        return (w, mu, cov, ll) if cpu_route else \
            (w, mu + 2e-3, cov, ll * (1 + 1e-4))

    def drifting_outer(*a, **kw):
        lam, gamma = outer(*a, **kw)
        return (lam, gamma) if cpu_route else (lam * (1 + 2e-3), gamma)

    monkeypatch.setattr(chip_smoke, "torch_device", torch_device)
    monkeypatch.setattr(c2, "_gmm_step", drifting_step)
    monkeypatch.setattr(c2, "_lda_outer", drifting_outer)
    with pytest.raises(SystemExit):
        chip_smoke.clustering_features_path("cpu stand-in")
    fail = capsys.readouterr().out.splitlines()[-1]
    assert fail.startswith("FAIL: phase 19: ")
    for part in ("19.1: log-likelihood", "19.1: weights/means", "19.3: λ"):
        assert part in fail, fail


def _phase20_on_cpu(monkeypatch):
    """Phase 20 at a small size with the CPU standing in for the card, as
    ``_phase19_on_cpu`` sets it up."""
    _phase19_on_cpu(monkeypatch)
    monkeypatch.setenv("ALINK_TORCH_DEVICE", "cpu")
    for name, value in (("GRAPH_SCALE", 9), ("GRAPH_SMALL_SCALE", 7),
                        ("KCORE_K", 4), ("NN_BASE", 6_000),
                        ("NN_QUERIES", 300), ("NN_CLUSTERS", 30),
                        ("NN_CHECK", 40), ("LDA_TOKENS", 240_000),
                        ("TEXT_TRAIN", 200), ("TEXT_VOCAB", 3_000),
                        ("KEYWORD_DOCS", 12)):
        monkeypatch.setattr(chip_smoke, name, value)


def test_graph_text_phase_passes_on_the_cpu(monkeypatch, capsys):
    """Phase 20 runs end to end at a small size on the CPU (both routes
    the CPU): every part reports, no check fails, no kernel launches."""
    _phase20_on_cpu(monkeypatch)
    out = chip_smoke.graph_text_path("cpu stand-in")
    assert set(out) == {"20.1", "20.2", "20.3", "20.4", "launches"}
    assert sum(out["launches"].values()) == 0
    g = out["20.1"]
    assert g["edges"] == 16 << 9
    pr = g["PageRankBatchOp"]
    assert pr["l1"] == 0.0 and pr["card"]["supersteps"] == pr[
        "cpu_supersteps"]
    assert pr["card"]["host_syncs"] == pr["card"]["supersteps"]
    assert g["ModularityCalBatchOp"]["equal"]
    for metric in ("EUCLIDEAN", "COSINE"):
        assert out["20.2"][metric]["ids_differ"] == 0
    assert out["20.2"]["LSH"]["equal"]
    t = out["20.3"]
    assert t["counts_equal"] and t["keywords"]["differ"] == 0
    assert t["keywords"]["pagerank_calls"] == 12
    c = out["20.4"]
    assert c["weight_gap"] == 0.0 and c["eq_residual"] <= 1e-2
    assert "phase 20: {" in capsys.readouterr().out


def test_graph_text_phase_is_in_main_after_phase_19():
    """Phase 20 runs after phase 19 in one side process, and phase 20.5
    after it there (it reuses phase 20's graph); main reads the walks'
    launches from that process's returns after joining it, before the
    kernels line."""
    import inspect

    assert chip_smoke.SIDE_GROUPS[0] == ("19", "20", "20.5")
    assert "graph_text_path(card)" in inspect.getsource(
        chip_smoke.SIDE_RUNS["20"][1])
    assert "walks_path(card)" in inspect.getsource(
        chip_smoke.SIDE_RUNS["20.5"][1])
    src = inspect.getsource(chip_smoke.main)
    assert src.index("side.update(join_side(proc, log))") \
        < src.index('walks = side["20.5"]') < src.index("line = {")


def test_clustering_phase_runs_beside_the_kernel_build():
    """The side processes (phase 19's among them) launch nothing timed on
    the kernels line: ``main`` starts them only after the kernel build and
    every device time of the kernels line (phases 3 to 10: the flash
    kernel, serving, the histograms and forest, SGNS and Word2Vec, the
    backward and training), so no second CUDA context shares the card
    while they are timed, and before phase 12."""
    import inspect

    src = inspect.getsource(chip_smoke.main)
    start = src.index("start_side(workdir, card, lib, group")
    for timed in ("built.result()", "check_kernel(peaks)", "main_path(",
                  "check_histogram(", "forest_path(", "check_sgns(",
                  "word2vec_path(", "check_backward(",
                  "train_metric_of_record(", 'mark("phase 10 BERT training")'):
        assert src.index(timed) < start, timed
    assert start < src.index("model_families(")
    assert "classical_path(workdir)" not in src
    assert "19" in chip_smoke.SIDE_GROUPS[0]


def test_graph_text_phase_fails_when_the_routes_part(monkeypatch, capsys):
    """A card route whose PageRank ranks, neighbour distances or
    NaiveBayesText counts drift from the CPU route's fails the phase."""
    import contextlib

    from alink_tpu_torch.common.model import model_to_table
    from alink_tpu_torch.operator.batch import graph as graph_ops
    from alink_tpu_torch.operator.batch import nlp2, similarity

    _phase20_on_cpu(monkeypatch)
    cpu_route = []

    @contextlib.contextmanager
    def torch_device(name):
        cpu_route.append(name)
        try:
            yield
        finally:
            cpu_route.pop()

    pagerank = graph_ops.pagerank
    topn = similarity.VectorNearestNeighborModelMapper.topn

    def drifting_pagerank(*a, **kw):
        pr = pagerank(*a, **kw)
        return pr if cpu_route else pr * np.float32(1 + 1e-3)

    def drifting_topn(self, Q):
        idx, dist = topn(self, Q)
        return idx, dist if cpu_route else dist * np.float32(1 + 1e-4)

    def drifting_model(meta, arrays):
        if "logp" in arrays and not cpu_route:
            arrays = dict(arrays, logp=arrays["logp"] * np.float32(1.001))
        return model_to_table(meta, arrays)

    monkeypatch.setattr(chip_smoke, "torch_device", torch_device)
    monkeypatch.setattr(graph_ops, "pagerank", drifting_pagerank)
    monkeypatch.setattr(similarity.VectorNearestNeighborModelMapper, "topn",
                        drifting_topn)
    monkeypatch.setattr(nlp2, "model_to_table", drifting_model)
    with pytest.raises(SystemExit):
        chip_smoke.graph_text_path("cpu stand-in")
    fail = capsys.readouterr().out.splitlines()[-1]
    assert fail.startswith("FAIL: phase 20: ")
    for part in ("20.1 PageRank", "20.2 EUCLIDEAN", "20.2 COSINE",
                 "20.3 NaiveBayesText counts"):
        assert part in fail, fail


def _phase21_on_cpu(monkeypatch):
    """Phase 21 at a small size with the CPU standing in for the card, as
    ``_phase19_on_cpu`` sets it up."""
    _phase19_on_cpu(monkeypatch)
    monkeypatch.setenv("ALINK_TORCH_DEVICE", "cpu")
    for name, value in (("ML_USERS", 300), ("ML_ITEMS", 200),
                        ("ML_RATINGS", 12_000), ("ML_MAX_USER_RATINGS", 150),
                        ("ML_HELD_OUT", 1_000), ("ALS_CHECK_USERS", 40),
                        ("ALS_BLOCK_ROWS", 64), ("ITEMCF_USERS", 50),
                        ("SWING_ITEMS", 30), ("FM_EPOCHS", 3),
                        ("MNIST_ROWS", 600), ("MNIST_DIM", 20),
                        ("MNIST_OUTLIERS", 60), ("CREDIT_ROWS", 3_000),
                        ("CREDIT_FRAUD", 30), ("OUTLIER_GROUPS", 20),
                        ("COVTYPE_TRAIN", 3_000), ("COVTYPE_TEST", 500),
                        ("INDEXER_ROWS", 500), ("INDEXER_VOCAB", 100),
                        ("SOS_ROWS", 300), ("OCSVM_CHECK_ROWS", 400)):
        monkeypatch.setattr(chip_smoke, name, value)
    # the AUC floors hold the full size's rows; these few rows rank worse
    monkeypatch.setattr(chip_smoke, "AUC_FLOORS",
                        dict.fromkeys(chip_smoke.AUC_FLOORS, 0.0))


def test_recomm_outlier_phase_passes_on_the_cpu(monkeypatch, capsys):
    """Phase 21 runs end to end at a small size on the CPU (both routes
    the CPU): every part reports, no check fails, no kernel launches."""
    _phase21_on_cpu(monkeypatch)
    out = chip_smoke.recomm_outlier_path("cpu stand-in")
    assert set(out) == {"21.1", "21.2", "21.3", "launches"}
    assert sum(out["launches"].values()) == 0
    als = out["21.1"]["als"]
    assert als["half_sweeps"] == 2 * chip_smoke.ALS["numIter"]
    assert als["rate_max_err"] == 0.0 and als["top10_diff"] == 0
    assert als["blocked_equal"] and als["user_width"] >= 20
    cf = out["21.1"]["cf"]
    assert cf["neighbours_differ"] == 0 and cf["swing"]["finite"]
    for op in ("FmRecommTrainBatchOp", "DeepFmRecommTrainBatchOp"):
        assert out["21.1"]["fm"][op]["rmse_gap"] < 1e-6
    o = out["21.2"]
    assert o["KdeOutlierBatchOp"]["flags_differ"] == 0
    for op in ("IForestOutlierBatchOp", "IForestModel"):
        assert o[op]["score_gap"] == 0.0 and o[op]["flags_differ"] == 0
    assert o["IForestModel"]["check_rows"] == chip_smoke.CREDIT_ROWS
    assert o["grouped"]["equal"] and o["grouped"]["groups"] == 20
    f = out["21.3"]
    assert f["score_gap"] == 0.0 and f["psi_equal"] and f["sparse"]["equal"]
    assert "phase 21: {" in capsys.readouterr().out


def test_recomm_outlier_phase_is_in_main_after_phase_20():
    """Phases 11, 13 and 18 to 22 run in the three side processes, which
    ``main`` starts after phase 10 and joins, printing their output,
    after phase 15 and before phase 16, so that nothing runs beside phases
    16 and 17; every phase runs once, phase 21 after phase 22 in its
    process."""
    import inspect

    src = inspect.getsource(chip_smoke.main)
    assert src.index("model_families(") < src.index("serving_path(") \
        < src.index("pretraining_path(") \
        < src.index("side.update(join_side(proc, log))") \
        < src.index("fleet_path(") < src.index("dag_path(") \
        < src.index("line = {")
    for fn in ("tuning_path(", "graph_text_path(", "walks_path(",
               "ingest_path(", "classical_path(", "recomm_outlier_path(",
               "timeseries_path(", "clustering_features_path("):
        assert fn not in src, fn
    groups = chip_smoke.SIDE_GROUPS
    assert groups[1] == ("22", "21")
    assert sorted(p for g in groups for p in g) == sorted(
        chip_smoke.SIDE_RUNS)
    for ph, fn in (("11", "classical_path("), ("13", "ingest_path("),
                   ("18", "tuning_path(card)"),
                   ("19", "clustering_features_path(card)"),
                   ("21", "recomm_outlier_path(card)"),
                   ("22", "timeseries_path(card)")):
        assert fn in inspect.getsource(chip_smoke.SIDE_RUNS[ph][1]), ph


def test_side_phase_runs_phase_21_with_its_mark(monkeypatch, capsys):
    ran = []
    monkeypatch.setattr(chip_smoke, "recomm_outlier_path", ran.append)
    threads = torch.get_num_threads()
    try:
        assert chip_smoke.side_phase("cpu stand-in", "21") == 0
        assert torch.get_num_threads() == chip_smoke.SIDE_THREADS
    finally:
        torch.set_num_threads(threads)
    assert ran == ["cpu stand-in"]
    assert capsys.readouterr().out.splitlines()[-1].startswith(
        "[phase 21 recommendation, outliers and finance: ")


def test_start_side_runs_this_script_with_the_kernel_library(monkeypatch,
                                                             tmp_path):
    from alink_tpu_torch.native import kernels

    seen = {}

    def popen(args, stdout, stderr, env):
        seen.update(args=args, env=env, log=stdout.name)
        return "process"

    monkeypatch.setattr(chip_smoke.subprocess, "Popen", popen)
    proc, log = chip_smoke.start_side(str(tmp_path), "card, 700 W", "/k.so",
                                      ("22", "21"))
    assert proc == "process" and log == seen["log"]
    assert seen["args"][1:] == [os.path.abspath(chip_smoke.__file__),
                                "--side", "card, 700 W", "22,21"]
    assert seen["env"][kernels.PREBUILT_ENV] == "/k.so"
    assert seen["env"]["OMP_NUM_THREADS"] == str(chip_smoke.SIDE_THREADS)


def test_side_returns_reach_main_through_the_results_file(monkeypatch,
                                                          tmp_path, capsys):
    """A side process writes what its phases return (phase 18's record
    and launches, say) to the file SIDE_OUT_ENV names; ``join_side`` of
    that process reads it back, and a stale file is removed at the
    start."""
    import subprocess
    import sys

    log = str(tmp_path / "side_2.log")
    out = chip_smoke.side_results_path(log)
    with open(out, "w") as f:
        f.write('{"18": "stale"}')
    monkeypatch.setattr(chip_smoke.subprocess, "Popen",
                        lambda args, stdout, stderr, env: env)
    env, _ = chip_smoke.start_side(str(tmp_path), "card", None, ("18",),
                                   "side_2.log")
    assert env[chip_smoke.SIDE_OUT_ENV] == out and not os.path.exists(out)
    monkeypatch.undo()      # subprocess.Popen is itself again
    monkeypatch.setitem(chip_smoke.SIDE_RUNS, "18", (
        "phase 18 tuning", lambda card: ({"search": {"speedup": 1.5}}, 1080)))
    monkeypatch.setenv(chip_smoke.SIDE_OUT_ENV, out)
    threads = torch.get_num_threads()
    try:
        assert chip_smoke.side_phase("cpu stand-in", "18") == 0
    finally:
        torch.set_num_threads(threads)
    with open(log, "w") as f:
        f.write("[phase 18 tuning: 1.0 s in a side process]\n")
    proc = subprocess.Popen([sys.executable, "-c", "pass"])
    side = chip_smoke.join_side(proc, log)
    tuning, launches = side["18"]
    assert tuning == {"search": {"speedup": 1.5}} and launches == 1080
    os.remove(out)
    proc = subprocess.Popen([sys.executable, "-c", "pass"])
    assert chip_smoke.join_side(proc, log) == {}


@pytest.mark.parametrize("code, want", [
    ("print('[phase 21 ok]')", None),
    ("print('FAIL: phase 21: x'); raise SystemExit(1)", "exit 1"),
    ("import time; print('started', flush=True); time.sleep(60)",
     "killed after"),
])
def test_join_side_prints_the_log_and_fails_with_the_process(
        monkeypatch, capsys, tmp_path, code, want):
    import subprocess
    import sys

    monkeypatch.setattr(chip_smoke, "SIDE_TIMEOUT_S", 5)
    log = tmp_path / "side.log"
    with open(log, "w") as f:
        proc = subprocess.Popen([sys.executable, "-c", code], stdout=f,
                                stderr=subprocess.STDOUT)
    if want is None:
        chip_smoke.join_side(proc, str(log))
        assert capsys.readouterr().out == "[phase 21 ok]\n"
        return
    with pytest.raises(SystemExit):
        chip_smoke.join_side(proc, str(log))
    assert proc.poll() is not None
    out = capsys.readouterr().out.splitlines()
    assert out[0] in ("FAIL: phase 21: x", "started")
    assert out[-1].startswith("FAIL: the second process's phases: ")
    assert want in out[-1]


def test_recomm_outlier_phase_fails_when_the_routes_part(monkeypatch,
                                                         capsys):
    """A card route whose ALS sweeps, CF similarities, pairwise distances,
    isolation-forest scores or scorecard regression drift from the CPU
    route's fails the phase."""
    import contextlib

    from alink_tpu_torch import optim
    from alink_tpu_torch.outlier import detectors
    from alink_tpu_torch.recommendation import als, cf

    _phase21_on_cpu(monkeypatch)
    cpu_route = []

    @contextlib.contextmanager
    def torch_device(name):
        cpu_route.append(name)
        try:
            yield
        finally:
            cpu_route.pop()

    sweep, sim = als.half_sweep, cf.interaction_similarity
    dists, optimize = detectors._pairwise_sq_dists, optim.optimize
    iforest_score = detectors.iforest_score

    def drifting_iforest(*a, **kw):
        score, flags = iforest_score(*a, **kw)
        return (score, flags) if cpu_route else (score * (1 + 1e-4), flags)

    def drifting_sweep(*a, **kw):
        out = sweep(*a, **kw)
        return out if cpu_route else out * (1 + 1e-3)

    def drifting_sim(*a, **kw):
        ids, nbrs, sims, counts = sim(*a, **kw)
        return ids, nbrs, sims if cpu_route else sims * 1.001, counts

    def drifting_dists(*a, **kw):
        d = dists(*a, **kw)
        return d if cpu_route else d * np.float32(1.01)

    def drifting_optimize(*a, **kw):
        res = optimize(*a, **kw)
        return res if cpu_route else res._replace(weights=res.weights * 1.01)

    monkeypatch.setattr(chip_smoke, "torch_device", torch_device)
    monkeypatch.setattr(als, "half_sweep", drifting_sweep)
    monkeypatch.setattr(
        __import__("alink_tpu_torch.operator.batch.recommendation",
                   fromlist=["x"]), "interaction_similarity", drifting_sim)
    monkeypatch.setattr(detectors, "_pairwise_sq_dists", drifting_dists)
    monkeypatch.setattr(detectors, "iforest_score", drifting_iforest)
    monkeypatch.setattr(optim, "optimize", drifting_optimize)
    with pytest.raises(SystemExit):
        chip_smoke.recomm_outlier_path("cpu stand-in")
    fail = capsys.readouterr().out.splitlines()[-1]
    assert fail.startswith("FAIL: phase 21: ")
    for part in ("21.1 ALS: held-out", "21.1 ItemCF", "21.2 KdeOutlier",
                 "21.2 IForestOutlierBatchOp", "21.2 IForestModel",
                 "21.3 scorecard"):
        assert part in fail, fail


def test_chip_smoke_binds_each_module_name_once():
    """A phase's constant or helper never rebinds an earlier phase's (a
    second ``SPARSE_ROWS`` once resized phase 11's sparse LR)."""
    import ast
    import collections

    with open(chip_smoke.__file__) as f:
        tree = ast.parse(f.read())
    seen = collections.Counter()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            seen[node.name] += 1
        elif isinstance(node, ast.Assign):
            for target in node.targets:
                for name in ast.walk(target):
                    if isinstance(name, ast.Name):
                        seen[name.id] += 1
    assert [n for n, c in seen.items() if c > 1] == []


# ---------------------------------------------------------------------------
# phases 20.5 and 22
# ---------------------------------------------------------------------------


def test_electricity_layout_shape_and_seasonality():
    """321 clients × (672 + 24) hours, positive loads, strong daily and
    weekly autocorrelation (lags 24 and 168) and a weak one at 12 h."""
    Y = chip_smoke.electricity_layout(chip_smoke.SEED + 220)
    assert Y.shape == (chip_smoke.ELEC_CLIENTS,
                       chip_smoke.ELEC_FIT + chip_smoke.ELEC_HORIZON)
    assert (Y > 0).all() and np.isfinite(Y).all()

    def acf(lag):
        z = np.log(Y) - np.log(Y).mean(1, keepdims=True)
        return float(np.mean((z[:, lag:] * z[:, :-lag]).mean(1)
                             / (z * z).mean(1)))

    assert acf(24) > 0.6 and acf(168) > 0.6 and acf(12) < acf(24) - 0.2
    levels = np.exp(np.log(Y).mean(1))
    assert levels.max() / levels.min() > 50       # lognormal client levels
    np.testing.assert_array_equal(
        Y, chip_smoke.electricity_layout(chip_smoke.SEED + 220))


@pytest.fixture(scope="module")
def line_phase_routes():
    """Phase 20.5's route inputs at its own size: the training edges of
    phase 20's scale-17 graph as the op's rows, and for each order the
    (kernel, plain, init) tables at LINE_ROUTE_STEPS steps, the wrapper's
    plain version standing in for the kernel on the CPU."""
    gr = chip_smoke.line_graph()
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("ALINK_TORCH_DEVICE", "cpu")
        mp.delenv("ALINK_SGNS_PALLAS", raising=False)
        tables = {order: chip_smoke.line_routes(
            gr["s_ids"], gr["d_ids"], len(gr["words"]), order,
            chip_smoke.LINE_ROUTE_STEPS, device="cpu") for order in (2, 1)}
    return gr, tables


def _dropped_negative(ref):
    def grads(win, w_ctx, center, uids, *, negs, **kw):
        gv, gu = ref(win, w_ctx, center, uids, negs=negs, **kw)
        gu = gu.clone()
        gu[center.shape[0] + negs - 1::negs] = 0.0   # b-major negatives
        return gv, gu
    return grads


def _untied(ref):
    def grads(win, w_ctx, center, uids, **kw):
        return ref(win, torch.zeros_like(w_ctx), center, uids, **kw)
    return grads


@pytest.mark.parametrize("order, mutant", [
    (2, None), (1, None), (2, _dropped_negative), (1, _untied)])
def test_line_route_check_rejects_mutants(monkeypatch, line_phase_routes,
                                          order, mutant):
    """Phase 20.5's route check at the phase's own graph (89,783 vertices
    of 4.1 M directed training edges), dimension and LINE_ROUTE_STEPS: the
    kernel route (here the wrapper's plain version, the CPU stand-in)
    passes; a step that unties order 1's table fails it, and so does one
    that drops a negative's gradients, though that one stays within
    TABLE_ATOL of the plain route there (training moves order 2's table
    only ~1.5e-3)."""
    from alink_tpu_torch.embedding import skipgram

    gr, tables = line_phase_routes
    kernel, plain, init = tables[order]
    assert len(gr["words"]) == 89_783 and len(gr["s_ids"]) == 2_054_861
    if mutant is not None:
        monkeypatch.setenv("ALINK_TORCH_DEVICE", "cpu")
        monkeypatch.delenv("ALINK_SGNS_PALLAS", raising=False)
        monkeypatch.setattr(skipgram, "sgns_pull_grads",
                            mutant(skipgram.sgns_pull_grads_ref))
        kernel = chip_smoke.line_table(
            gr["s_ids"], gr["d_ids"], len(gr["words"]), order,
            chip_smoke.LINE_ROUTE_STEPS, device="cpu")
        if mutant is _dropped_negative:
            assert np.abs(kernel - plain).max() < chip_smoke.TABLE_ATOL
    problems = chip_smoke.route_gap_problems("LINE", kernel, plain, init)
    assert bool(problems) == (mutant is not None)


def test_line_auc_floors_tell_learning_from_chance():
    """Each order's AUC floor sits more than ten standard errors of a
    chance ranking above 0.5 at the phase's held-out edges, and the
    standard error is the Mann-Whitney one at AUC 0.5."""
    n = int(round(chip_smoke.LINE_HELD_OUT
                  * (chip_smoke.GRAPH_EDGE_FACTOR << chip_smoke.GRAPH_SCALE)))
    assert chip_smoke.auc_se(0.5, n, n) == pytest.approx(
        np.sqrt((2 * n + 1) / (12 * n * n)), rel=1e-12)
    for order, floor in chip_smoke.LINE_AUC_FLOOR.items():
        assert floor - 0.5 > 10 * chip_smoke.auc_se(0.5, n, n), order


def test_line_auc_ranks_held_edges():
    emb = np.eye(4, dtype=np.float32)
    held = np.asarray([[0, 0], [1, 1]])
    pairs = np.asarray([[0, 1], [2, 3]])
    assert chip_smoke.line_auc(emb, held, pairs) == 1.0
    assert chip_smoke.line_auc(emb, pairs, held) == 0.0
    assert chip_smoke.line_auc(np.zeros((4, 2)), held, pairs) == 0.5


def _transactions():
    t = np.asarray([0, 100, 86_400, 86_400, 90_000, 172_800, 5, 86_405,
                    86_405, 172_805], np.float64)
    acct = np.asarray(["a"] * 6 + ["b"] * 4, object)
    amount = np.asarray([1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 3.0, 5.0, 7.0,
                         11.0])
    return t, amount, acct


def _ndays(t, amount, acct, n_days):
    from alink_tpu_torch.common.mtable import MTable
    from alink_tpu_torch.operator.batch import (
        GenerateFeatureOfLatestNDaysBatchOp, TableSourceBatchOp)

    out = GenerateFeatureOfLatestNDaysBatchOp(
        timeCol="time", groupCols=["acct"], targetCols=["amount"],
        statTypes=chip_smoke.WINDOW_STATS, nDays=n_days).link_from(
        TableSourceBatchOp(MTable({"acct": acct, "time": t,
                                   "amount": amount}))).collect()
    cols = [c for c in out.names if c.startswith("amount_")]
    return {s: np.asarray(out.col(c))
            for s, c in zip(chip_smoke.WINDOW_STATS, cols)}


def test_window_oracle_rejects_an_off_by_one_edge(monkeypatch):
    """The NDays oracle passes the op's 1-day columns, and rejects the
    columns of a window one second short (its left edge drops the rows
    exactly one day back); the hop-window oracle passes the op's windows
    and rejects them with each window's end one second late."""
    from alink_tpu_torch.common.mtable import MTable
    from alink_tpu_torch.operator.batch import (
        GenerateFeatureOfWindowBatchOp, TableSourceBatchOp)

    monkeypatch.setenv("ALINK_TORCH_DEVICE", "cpu")
    t, amount, acct = _transactions()
    rows = np.arange(len(t))
    good = _ndays(t, amount, acct, 1.0)
    assert chip_smoke.trailing_oracle_gaps(t, amount, acct, good, 86_400,
                                           rows) == 0.0
    short = _ndays(t, amount, acct, (86_400 - 1) / 86_400)
    assert chip_smoke.trailing_oracle_gaps(t, amount, acct, short, 86_400,
                                           rows) > 0.1
    t2 = np.asarray([0, 1800, 3600, 3601, 5400, 7199, 7200], np.float64)
    a2 = np.asarray(["a"] * 7, object)
    v2 = np.arange(1.0, 8.0)
    hop = GenerateFeatureOfWindowBatchOp(timeCol="time", featureDefinitions={
        "groupCols": ["acct"], "windowType": "HOP", **chip_smoke.WINDOW_HOP,
        "targetCols": ["amount"], "statTypes": chip_smoke.WINDOW_STATS}) \
        .link_from(TableSourceBatchOp(MTable(
            {"acct": a2, "time": t2, "amount": v2}))).collect()
    wrows = np.arange(hop.num_rows)
    assert chip_smoke.window_oracle_gaps(t2, v2, a2, hop, wrows) == 0.0
    late = hop.with_column("window_end",
                           np.asarray(hop.col("window_end")) + 1.0)
    assert chip_smoke.window_oracle_gaps(t2, v2, a2, late, wrows) > 0.1


def test_timeseries_phase_passes_on_the_cpu_at_a_small_size(monkeypatch,
                                                            capsys):
    """Phase 22 end to end with the CPU on both routes at a small size:
    every check passes and no kernel launches."""
    import alink_tpu_torch.operator.batch.timeseries as ts

    monkeypatch.setenv("ALINK_TORCH_DEVICE", "cpu")
    for name, value in dict(ELEC_CLIENTS=4, ELEC_FIT=72, ELEC_HORIZON=24,
                            AUTO_ARIMA_SERIES=1, AUTO_GARCH_SERIES=2,
                            CPU_SERIES=dict(ArimaBatchOp=2,
                                            HoltWintersBatchOp=2,
                                            GarchBatchOp=2,
                                            AutoGarchBatchOp=1,
                                            AutoArimaBatchOp=1),
                            NET_SERIES=1, NET_ROUTE_EPOCHS=1,
                            CREDIT_ROWS=2000,
                            WINDOW_ACCOUNTS=50,
                            WINDOW_ORACLE_ROWS=100).items():
        monkeypatch.setattr(chip_smoke, name, value)
    for cls in (ts.DeepARBatchOp, ts.LSTNetBatchOp, ts.TFTBatchOp):
        monkeypatch.setattr(cls, "NUM_EPOCHS", type(cls.NUM_EPOCHS)(
            "numEpochs", int, default=1))
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "reset_peak_memory_stats",
                        lambda *a: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: 0)
    monkeypatch.setattr(chip_smoke, "device_profile", lambda fn, warm: (
        fn(), dict(operations=0, busy_ms=0.0, traced_wall_ms=1.0,
                   idle_share=1.0))[1])
    monkeypatch.setattr(chip_smoke, "count_syncs", lambda fn: (fn(), 0))
    out = chip_smoke.timeseries_path("cpu stand-in")
    assert sum(out["launches"].values()) == 0
    fits = out["22.1"]
    assert fits["AutoArimaBatchOp"]["orders_equal"]
    assert all(fits[op]["route_gap"] == 0.0 for op in (
        "ArimaBatchOp", "HoltWintersBatchOp", "GarchBatchOp"))
    assert out["22.3"]["ndays_gap"] <= chip_smoke.WINDOW_ORACLE_RTOL
    assert "phase 22: {" in capsys.readouterr().out


# -- phase 23: the rest of the batch families --------------------------------

CARD_STANDIN = "cpu:0"      # the "card" route here; torch_device("cpu") the
#                             CPU route, so a mutant can act on one of them


def _on_card():
    return os.environ.get("ALINK_TORCH_DEVICE") == CARD_STANDIN


def _phase23_on_cpu(monkeypatch):
    monkeypatch.setenv("ALINK_TORCH_DEVICE", CARD_STANDIN)
    for name, value in dict(SPEECH_CLIPS=40, MFCC_CPU_CLIPS=20, WAV_FILES=6,
                            VOCAB_KEYS=500, AGG_ROWS=400, AGG_EMPTY=8,
                            FACT_ROWS=10_000, LSQ_ROWS=3_000, LSQ_BATCH=512,
                            TRIPLE_ROWS=300, TENSOR_CELLS=50).items():
        monkeypatch.setattr(chip_smoke, name, value)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(chip_smoke, "dag_profile",
                        lambda run: (run(), (0.0, 1.0))[1])


def test_batch_families_phase_passes_on_the_cpu(monkeypatch, capsys,
                                                tmp_path):
    """Phase 23 end to end with the CPU on both routes at a small size:
    every check passes, every gate holds, no kernel launches."""
    _phase23_on_cpu(monkeypatch)
    out = chip_smoke.batch_families_path("cpu stand-in", str(tmp_path))
    assert sum(out["launches"].values()) == 0
    assert out["23.1"]["gaps"]["route"] <= chip_smoke.MFCC_ATOL
    assert all(out["23.2"][h]["rows_not_equal"] == 0
               for h in ("MAX", "MIN", "CONCAT"))
    assert set(chip_smoke.FACT_FAMILIES) <= set(out["23.3"]["kinds"])
    assert out["23.3"]["budget_cut"] == 0
    assert out["23.4"]["route_gap"] <= chip_smoke.LSQ_ATOL
    assert out["23.5"]["triples"] == 4 * chip_smoke.TRIPLE_ROWS
    assert out["23.6"]["xgboost"] == "absent, raised"
    assert "phase 23: {" in capsys.readouterr().out


def _periodic_window(monkeypatch):
    real = torch.hann_window

    def window(n, periodic=True, **kw):
        return real(n, periodic=periodic or _on_card(), **kw)

    monkeypatch.setattr(torch, "hann_window", window)


def _max_as_mean(monkeypatch):
    from alink_tpu_torch.operator.batch import io2

    real = io2.AggLookupMapper._reduce

    def reduce(self, rows, counts, how):
        if how == "MAX" and _on_card():
            how = "AVG"
        return real(self, rows, counts, how)

    monkeypatch.setattr(io2.AggLookupMapper, "_reduce", reduce)


def _pearson_keeps_nan_rows(monkeypatch):
    from alink_tpu_torch.operator.batch import insights

    real = insights._pearson

    def pearson(X, device):
        if not _on_card():
            return real(X, device)
        Z = torch.tensor(X, dtype=torch.float64)
        Z = Z - Z.mean(dim=0)
        c = (Z.T @ Z) / (Z.shape[0] - 1)
        sd = torch.sqrt(torch.diagonal(c))
        return (c / sd[:, None] / sd[None, :]).numpy()

    monkeypatch.setattr(insights, "_pearson", pearson)


@pytest.mark.parametrize("mutant, want", [
    (_periodic_window, "23.1: MFCC route gap"),
    (_max_as_mean, "23.2: AggLookup MAX"),
    (_pearson_keeps_nan_rows, "23.3: the findings'")])
def test_batch_families_checks_reject_a_parted_card_route(
        monkeypatch, capsys, tmp_path, mutant, want):
    """A card route with a periodic Hann window, MAX computed as a mean, or
    a Pearson matrix over the rows with a NaN fails phase 23 (the CPU
    route is untouched)."""
    _phase23_on_cpu(monkeypatch)
    mutant(monkeypatch)
    with pytest.raises(SystemExit):
        chip_smoke.batch_families_path("cpu stand-in", str(tmp_path))
    assert want in capsys.readouterr().out.splitlines()[-1]


def test_batch_families_gates_reject_an_op_that_returns(monkeypatch,
                                                        tmp_path):
    """A gate that returns instead of raising (XlsSink writing nothing, a
    redis:// store opened without the package) fails the gate check."""
    from alink_tpu_torch.io import kv
    from alink_tpu_torch.operator.batch import io2

    monkeypatch.setenv("ALINK_TORCH_DEVICE", "cpu")
    problems, seen = chip_smoke.gate_problems(str(tmp_path))
    assert problems == [] and seen["redis"] == "absent, raised"
    monkeypatch.setattr(io2.XlsSinkBatchOp, "_execute_impl",
                        lambda self, t: t)
    monkeypatch.setattr(kv, "RedisKvStore",
                        lambda uri: kv.MemoryKvStore("gate"))
    problems, seen = chip_smoke.gate_problems(str(tmp_path))
    assert seen["redis"] == "absent, ran"
    assert "23.6: redis gate: absent, ran" in problems
    assert "23.6: an op that needs openpyxl ran" in problems


def test_batch_families_phase_runs_in_main_after_phase_15():
    """Phase 23 runs in this process after phase 15 and before the side
    processes are joined, so nothing is added beside phases 3-10, 16 or
    17; its launch counts reach the kernels line."""
    import inspect

    src = inspect.getsource(chip_smoke.main)
    assert src.index("pretraining_path(") \
        < src.index("batch_families_path(card, workdir)") \
        < src.index("side.update(join_side(proc, log))")
    assert src.count('"phase 23 batch families":') == 3
    assert "23" not in chip_smoke.SIDE_RUNS
