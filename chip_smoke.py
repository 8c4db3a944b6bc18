"""Chip smoke test of the PyTorch/CUDA port (``alink_tpu_torch``) on one GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

It imports nothing of JAX or ``alink_tpu``. Phases, any failure exits
non-zero:

1. environment: card name and power limit (nvidia-smi), torch and CUDA;
2. build: every kernel of the port from ``alink_tpu_torch/csrc`` into
   ``build/kernels``;
3. kernel vs plain version on the card: ``flash_block_update`` (one block
   through the fused kernel with nb = 1) against ``flash_block_update_ref``
   at the serving shape (B=32, H=12, Q=512, K=128, D=64) in bf16 and fp32,
   with a fully masked batch row, a causal ``qk_ok`` and a ragged K=100,
   each from an empty state (the first K/V block) and from a carried one
   (every later block); then ``blockwise_attention`` on the kernel route
   (``flash_blockwise``, one launch per call) against its plain route
   (``ALINK_ATTN_PALLAS=0``) at (B, H, D) = (32, 12, 64), blocks of 128, in
   bf16 and fp32: S = 512; S = 512 causal; a ragged S = 500; the last two on
   q/k/v taken as ``unbind`` views of one (B, S, 3, H, D) tensor, as the main
   path hands them over (every case has a fully masked batch row); the fused
   call timed beside its bound and the plain route in turns, one block
   update timed, and ``scaled_dot_product_attention`` over the whole
   512-key attention as a labelled yardstick (the port never calls it);
4. main path: BERT-base at full width (hidden 768, 12 layers, 12 heads,
   vocab 30522, maxSeqLength 512, attentionBlockSize 128, mean pool, 2
   labels) with seeded random weights in the reference's flax layout (q/k
   weights drawn so that attention scores spread about one unit, so the
   logits depend on the attention), encoded with the port's codec into a
   model table, written to ``.ak``, read back, and served to 4 requests of
   1, 8, 32 and 64 rows through ``AkSourceBatchOp`` + ``TableSourceBatchOp``
   → ``BertTextClassifierPredictBatchOp`` → ``collect()``; the kernel's
   launch counter must rise by 12 per forward chunk (one launch per layer),
   and the logits must
   agree with the same model run with plain attention and with full
   attention; the warm forward is timed on all three attention routes;
5. tree histogram vs plain version on the card: the fused level call
   ``level_histograms`` (one launch of ``tree_histogram`` for the level's
   g, h and count histograms, ids built in the kernel from the uint8 bins)
   against ``level_histograms_ref`` at n = 522,911 rows of Covertype-layout
   bins (10 continuous and 44 binary columns) at every level of a depth-12
   tree (L = 1 … 2,048 nodes, S = 64 … 131,072) on evenly spread nodes,
   with the forest's channels (integer g and counts, h the same tensor as
   c) and real ones (normal, g, counts: h != c), plus nodes at -1 and in
   [L, L+8) and bins in [64, 256) at L = 1, 64 and 2,048; each level timed
   (device time in CUDA graphs) beside its bound, the plain version and one
   ``index_add_`` over the flat cell index as a labelled yardstick (the
   port never calls it);
6. forest path: seeded Covertype-layout data (sklearn's
   bench_covertype.py shape: 522,911 training and 58,101 held-out rows, 54
   features, class 1 against the rest) through ``TableSourceBatchOp`` →
   ``RandomForestTrainBatchOp(numTrees=20, maxDepth=12, maxBins=64,
   minSamplesPerLeaf=5)`` → ``collect()``; the kernel's launch counter must
   rise by 12·20 = 240, one per level (each level call timed with CUDA
   events), the first tree's 12 level calls are held against the plain
   version again and timed on their own inputs (the numbers of the kernels
   line), the ``ALINK_GBDT_PALLAS=0`` route must grow identical trees, the
   card's predict must match a numpy traversal, and
   the model goes to ``.ak`` and back into ``RandomForestPredictBatchOp``
   for requests of 1, 1,000 and 58,101 held-out rows; held-out accuracy
   must beat the majority class by 0.05;
7. GBDT path: ``GbdtTrainBatchOp(numTrees=20, maxDepth=6, maxBins=64)`` on
   the same data, then ``GbdtPredictBatchOp`` on the held-out requests,
   under the same accuracy floor;
8. SGNS gradients vs plain versions on the card: the gathered-rows entry
   ``sgns_block_grads`` against ``sgns_block_grads_ref`` at (B, negs, D) =
   (1024, 5, 100) (the main path's), (1000, 1, 37) and (1000, 15, 100), on
   the pulled rows of the 300th step of a plain-route training on a quarter
   of the corpus (realistic magnitudes) and on seeded N(0, 1) rows
   (saturated sigmoids); the fused entry ``sgns_pull_grads`` (the APS pull
   and the gradients in one launch) against ``sgns_pull_grads_ref`` on that
   step's tables and ids at the main path's shape, with 2 % sentinel and 2 %
   duplicated ids, the hot cache on (replicas that differ from the tables'
   prefix), off, and on one tied table, hits equal; both entries timed in a
   CUDA graph beside their bounds;
9. Word2Vec path: 1,000,000 tokens in text8's layout (the corpus of
   word2vec's demo-word.sh: Zipf law over 71,290 types, sentences of 1,000
   tokens, a topic per sentence; see ``text8_corpus``) through
   ``TableSourceBatchOp`` → ``Word2VecTrainBatchOp`` (the op's defaults:
   vectorSize 100, window 5, negative 5, numIter 3, batchSize 1024; minCount
   1) → ``collect()``; the kernel's launch counter must rise by the step
   count (one fused launch per step), the table must agree with the
   ``ALINK_SGNS_PALLAS=0`` route's, the embedding must pass a learning gate
   on the topics, the steps/s and the device operations a step (both
   routes, ``torch.profiler``) are reported, and the model goes to ``.ak``
   and back into ``Word2VecPredictBatchOp`` for requests of 1, 1,000 and
   10,000 sentences, checked against a numpy mean of the table's rows;
10. one JSON line of kernels, then the device line last.

Tolerances. fp32 kernel vs plain: atol 1e-5 (the reference kernel's
contract); ``blockwise_attention`` routes: atol 2e-5 (the reference's
blockwise contract). bf16: kernel and plain version round s, p and p·v to
bf16 at the same points, so they differ where an fp32 sum taken in another
order lands on the other side of a bf16 rounding boundary. A score s_j
that does so moves by one bf16 ulp (≤ 2**-7·|s_j|), which scales its p_j by
up to 1 + expm1(2**-7·|s_j|); when s_j is the row max it also moves m by
that ulp and rescales the row's o and l by exp(Δm), which the final o/l
cancels. So m must lie within 2**-7·|m| of the plain version's, and the
kernel's o and l, rescaled to the plain version's m, must lie within
2**-7·(|x| + x_abs) + flip of it, element by element: x_abs is the plain
version's result on |v| and |o| (the size of the terms summed into x; for
l, l itself) and flip is the most that one flipped score of the row can
change x, max_j p_j·expm1(2**-7·|s_j|)·|v_j| for o and the same without
|v_j| for l. The kernel route of ``blockwise_attention`` is held against
its plain route at the same bound for the output o/l, with the flip terms
taken over all keys (those causal allows, where causal): 2**-7·(|out| +
out_abs) + (flip_o + |out|·flip_l)/l.
Served logits: max|Δ| ≤ 0.01 against the plain-attention route and against
full attention, about 4x the gaps measured on the card (see PERF.md).
Tree histogram: integer vals are summed exactly in any order (every
partial sum is an integer below 2**24), so kernel and plain version must
agree exactly, channel by channel; real vals within 2·count·2**-24·Σ|vals|
per cell, the worst-case fp32 error of a sum taken in any order, for both
sides (count and Σ|vals| from the plain version on ones and on |vals|).
SGNS gradients, both entries: atol 1e-5 (the reference kernel's
contract); the fused entry's hit count exactly. Word2Vec
tables, kernel route vs plain route: max|Δ| ≤ 1e-3, 100x the 9.8e-6 that a
rounding-level change of the block gradients (computed in float64) moved a
table of magnitude 1.4 over 3,700 steps on a quarter of the corpus on the
CPU; ``index_add_`` on the card adds a batch's duplicate ids in any order,
so two card runs are not bit-identical either. Learning gate: the in-topic
share of the top-10 cosine neighbours of vocabulary rows 100..1099 must be
≥ 0.32 (chance 0.01), half the 0.641 of the port's CPU run on a quarter of
the corpus.
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
import time

import numpy as np

SEED = 0
REQUEST_ROWS = (1, 8, 32, 64)
WORDS = (5, 700)
SLICE = dict(B=32, H=12, Q=512, K=128, D=64)
FUSED_CASES = (          # (label, S, causal, q/k/v as the main path's views)
    ("S=512", 512, False, False),
    ("S=512, causal, views", 512, True, True),
    ("ragged S=500, views", 500, False, True),
)
BF16_ULP = 2.0 ** -7     # bf16's spacing, relative to the value, at most
FP32_ATOL = 1e-5
ATTN_FP32_ATOL = 2e-5    # the reference's blockwise-vs-full contract
LOGIT_ATOL = 0.01        # ~4x the gaps measured on an H100 (PERF.md)
NEG = -1e30              # the reference's finite mask value

# (HBM bytes/s, dense bf16 tensor FLOP/s, fp32 FLOP/s) by card; NVIDIA data
# sheets, SXM parts unless named
CARDS = {
    "H200": (4.8e12, 989e12, 67e12),
    "H100 NVL": (3.9e12, 835e12, 60e12),
    "H100 PCIe": (2.0e12, 756e12, 51e12),
    "H100": (3.35e12, 989e12, 67e12),
}


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def card_peaks(name: str):
    for key, peaks in CARDS.items():
        if key in name:
            return key, peaks
    fail(f"no peak table for {name!r}: bound_ms would rest on a guessed peak")


def cuda_ms(fn, iters: int = 30, warmup: int = 5) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ---------------------------------------------------------------------------
# phase 3: kernel vs plain
# ---------------------------------------------------------------------------


def block_inputs(B, H, Q, K, D, dtype, *, causal, fresh, seed,
                 device="cuda"):
    """Seeded inputs of one block update: standard-normal q/k/v, random
    ``kvalid`` with batch row 0 fully masked, an all-ones or causal
    ``qk_ok``. ``fresh`` starts o/m/l empty, as the first K/V block does;
    otherwise they carry a random state, as every later block does: o
    normal, m ~ N(2, 1) (near a block's row max of scores, so corr spans
    (0, 1]) with every 8th row still at -1e30, l uniform in [0.5, 2]."""
    import torch

    g = np.random.default_rng(seed)
    q, k, v = (torch.tensor(g.standard_normal((B, H, n, D), np.float32),
                            device=device).to(dtype) for n in (Q, K, K))
    kvalid = torch.tensor(g.integers(0, 2, (B, K)), dtype=torch.int32,
                          device=device)
    kvalid[0] = 0                                   # a fully masked row
    ok = torch.ones((Q, K), dtype=torch.int32, device=device)
    if causal:
        ok = ok.tril()
    if fresh:
        o = np.zeros((B, H, Q, D), np.float32)
        m = np.full((B, H, Q), -1e30, np.float32)
        l = np.zeros((B, H, Q), np.float32)
    else:
        o = g.standard_normal((B, H, Q, D), np.float32)
        m = g.normal(2.0, 1.0, (B, H, Q)).astype(np.float32)
        m[:, :, ::8] = -1e30
        l = g.uniform(0.5, 2.0, (B, H, Q)).astype(np.float32)
    o, m, l = (torch.tensor(x, device=device) for x in (o, m, l))
    return q, k, v, kvalid, ok, o, m, l


def worst_ratio(err, bound) -> float:
    """Largest elementwise err / bound; NaN counts as out of bound."""
    import torch

    r = err / bound.clamp_min(1e-30)
    return float(torch.nan_to_num(r, nan=float("inf")).max())


def flip_allowance(s, m, v):
    """The largest change one score rounded to the other side of a bf16
    boundary can make, per row: max over keys j of
    p_j·expm1(2**-7·|s_j|)·|v_j| (per column of v) and of
    p_j·expm1(2**-7·|s_j|), with p = exp(s − m). s: (B, H, Q, K) scores as
    the plain version forms them, masked at -1e30 (a mask never flips);
    m: (B, H, Q); v: (B, H, K, D)."""
    import torch

    p = torch.exp(s - m[..., None])
    e = torch.where(s > NEG / 2, p * torch.expm1(BF16_ULP * s.abs()), 0.0)
    flip_v = torch.stack([(e[b, ..., None] * v[b, :, None].abs().float())
                          .amax(dim=2) for b in range(e.shape[0])])
    return flip_v, e.amax(dim=-1)


def block_mismatch(args, got, scale):
    """Holds a block update's ``got`` = (o, m, l) against the plain version
    on the same ``args``. Returns the raw max |Δ| of o, m and l, and for
    each its worst error over its bound (> 1 fails): fp32 atol 1e-5, bf16
    as in the module docstring."""
    import torch

    from alink_tpu_torch.dl.attn_cuda import flash_block_update_ref

    q, k, v, kvalid, ok, o_in, m_in, l_in = args
    ref = flash_block_update_ref(*args, scale=scale)
    if not all(bool(torch.isfinite(a).all()) for a in got):
        return [float("nan")] * 3, dict.fromkeys("oml", float("inf"))
    raw = [float((a - b).abs().max()) for a, b in zip(got, ref)]
    if q.dtype != torch.bfloat16:
        return raw, {n: e / FP32_ATOL for n, e in zip("oml", raw)}
    (o, m, l), (o_r, m_r, l_r) = got, ref
    o_abs = flash_block_update_ref(q, k, v.abs(), kvalid, ok, o_in.abs(),
                                   m_in, l_in, scale=scale)[0]
    sc = torch.einsum("bhqd,bhkd->bhqk", q, k).float() * scale
    sc = torch.where((kvalid[:, None, None, :] > 0) & (ok[None, None] > 0),
                     sc, NEG)
    flip_o, flip_l = flip_allowance(sc, m_r, v)
    f = torch.exp(m - m_r)          # the kernel's o and l at the plain m
    return raw, {
        "o": worst_ratio((o * f[..., None] - o_r).abs(),
                         BF16_ULP * (o_r.abs() + o_abs) + flip_o),
        "m": worst_ratio((m - m_r).abs(), BF16_ULP * m_r.abs()),
        "l": worst_ratio((l * f - l_r).abs(), 2 * BF16_ULP * l_r + flip_l)}


def blockwise_mismatch(q, k, v, mask, got, block_size, causal=False):
    """Holds ``blockwise_attention``'s output ``got`` from the kernel route
    against its plain route (``ALINK_ATTN_PALLAS=0``) on the same inputs.
    Returns the raw max |Δ| and the worst error over its bound (> 1 fails):
    fp32 atol 2e-5, bf16 as in the module docstring."""
    import torch

    from alink_tpu_torch.dl.attention import blockwise_attention

    def plain(vv):
        return blockwise_attention(q, k, vv, mask, block_size=block_size,
                                   causal=causal)

    ref, ref_abs = plain_route(plain, v), plain_route(plain, v.abs())
    if not bool(torch.isfinite(got).all()):
        return float("nan"), float("inf")
    err = (got.float() - ref.float()).abs()
    if q.dtype != torch.bfloat16:
        return float(err.max()), float(err.max()) / ATTN_FP32_ATOL
    # (B, S, H, D) -> (B, H, S, D); the flip terms over all keys
    vh, r, r_abs, err = (x.transpose(1, 2).float()
                         for x in (v, ref, ref_abs, err))
    sc = torch.einsum("bhqd,bhkd->bhqk", q.transpose(1, 2),
                      k.transpose(1, 2)).float() * q.shape[-1] ** -0.5
    sc = torch.where(mask[:, None, None, :] > 0, sc, NEG)
    if causal:
        sq, sk = sc.shape[-2:]
        sc = torch.where(torch.ones((sq, sk), dtype=torch.bool,
                                    device=sc.device).tril(), sc, NEG)
    m = sc.amax(dim=-1)
    l = torch.exp(sc - m[..., None]).sum(dim=-1)
    flip_o, flip_l = flip_allowance(sc, m, vh)
    bound = BF16_ULP * (r.abs() + r_abs) \
        + (flip_o + r.abs() * flip_l[..., None]) / l[..., None]
    return float(err.max()), worst_ratio(err, bound)


def attn_inputs(B, S, H, D, dtype, seed, device="cuda"):
    """Standard-normal q/k/v (B, S, H, D) and a key mask of seeded lengths:
    row 0 fully masked, row 1 full, row 2 of 100 keys (3 blocks all
    padding), the rest uniform in [1, S]."""
    import torch

    g = np.random.default_rng(seed)
    q, k, v = (torch.tensor(g.standard_normal((B, S, H, D), np.float32),
                            device=device).to(dtype) for _ in range(3))
    lens = g.integers(1, S + 1, B)
    lens[:3] = 0, S, 100
    mask = torch.tensor(np.arange(S)[None, :] < lens[:, None],
                        dtype=torch.int32, device=device)
    return q, k, v, mask


def qkv_views(q, k, v):
    """q, k, v as ``SelfAttention.forward`` hands them over: ``unbind``
    views of one (B, S, 3, H, D) tensor, S stride 3·H·D."""
    import torch

    return torch.stack((q, k, v), dim=2).unbind(dim=2)


def plain_route(fn, *a):
    """``fn(*a)`` with ``ALINK_ATTN_PALLAS=0``: attention's plain route."""
    from alink_tpu_torch.dl.attention import ATTN_KERNEL_ENV

    os.environ[ATTN_KERNEL_ENV] = "0"
    try:
        return fn(*a)
    finally:
        del os.environ[ATTN_KERNEL_ENV]


def call_bytes_flops(B, S, H, D, itemsize):
    """One attention call: q, k, v read once, the output written once, the
    (B, S) key mask; 4·B·H·S²·D operations (the two products)."""
    return 4 * B * S * H * D * itemsize + B * S * 4, 4.0 * B * H * S * S * D


def check_kernel(peaks):
    import torch

    from alink_tpu_torch.dl.attention import blockwise_attention
    from alink_tpu_torch.dl.attn_cuda import (flash_block_update,
                                              flash_block_update_ref)

    s = SLICE
    scale = s["D"] ** -0.5
    results = {}
    cases = [("bf16", torch.bfloat16, s["K"], False),
             ("fp32", torch.float32, s["K"], False),
             ("bf16 causal", torch.bfloat16, s["K"], True),
             ("fp32 causal", torch.float32, s["K"], True),
             ("bf16 ragged K=100", torch.bfloat16, 100, False),
             ("fp32 ragged K=100", torch.float32, 100, True)]
    for i, (label, dt, K, causal) in enumerate(cases):
        for fresh in (True, False):
            name = label + (", empty state" if fresh else ", carried state")
            args = block_inputs(s["B"], s["H"], s["Q"], K, s["D"], dt,
                                causal=causal, fresh=fresh, seed=SEED + i)
            got = flash_block_update(*args, scale=scale)
            raw, ratio = block_mismatch(args, got, scale)
            print(f"kernel vs plain [{name}] max|Δ| o={raw[0]:.3g} "
                  f"m={raw[1]:.3g} l={raw[2]:.3g}; worst error/bound " +
                  " ".join(f"{n}={r:.3g}" for n, r in ratio.items()),
                  flush=True)
            if not max(ratio.values()) <= 1.0:
                fail(f"flash_block_update [{name}] outside its tolerance")
            results[name] = max(raw)

    # the fused route (one launch per attention call) against the plain
    # route, with masked rows, causal, a ragged S and the main path's views
    B, H, D, bs = s["B"], s["H"], s["D"], s["K"]
    for dt in (torch.bfloat16, torch.float32):
        for label, S, causal, strided in FUSED_CASES:
            q, k, v, mask = attn_inputs(B, S, H, D, dt, SEED)
            if strided:
                q, k, v = qkv_views(q, k, v)
            got = blockwise_attention(q, k, v, mask, block_size=bs,
                                      causal=causal)
            err, worst = blockwise_mismatch(q, k, v, mask, got, bs, causal)
            name = f"fused vs plain route {str(dt)[6:]} [{label}]"
            print(f"{name} (B, S, H, D) = ({B}, {S}, {H}, {D}), block {bs}: "
                  f"max|Δ| {err:.3g}; worst error/bound {worst:.3g}",
                  flush=True)
            if not worst <= 1.0:
                fail(f"{name} outside its tolerance")
            results[name] = err

    bw, bf16_peak, _ = peaks
    # timings at the serving shape, bf16, in turns (plain, kernel, kernel,
    # plain): the fused call on the main path's views, then one block update
    S = s["Q"]
    q, k, v, mask = attn_inputs(B, S, H, D, torch.bfloat16, SEED)
    q, k, v = qkv_views(q, k, v)
    kern = lambda: blockwise_attention(q, k, v, mask, block_size=bs)  # noqa: E731
    t = [plain_route(cuda_ms, kern), cuda_ms(kern), cuda_ms(kern),
         plain_route(cuda_ms, kern)]
    plain_ms, kern_ms = (t[0] + t[3]) / 2, (t[1] + t[2]) / 2
    nbytes, flops = call_bytes_flops(B, S, H, D, itemsize=2)
    bound_s = max(nbytes / bw, flops / bf16_peak)
    bound_by = "bytes" if nbytes / bw >= flops / bf16_peak else "operations"

    args = block_inputs(B, H, S, bs, D, torch.bfloat16, causal=False,
                        fresh=False, seed=SEED)
    blk = [cuda_ms(lambda: flash_block_update_ref(*args, scale=scale)),
           cuda_ms(lambda: flash_block_update(*args, scale=scale))]

    # yardstick: one library call for the whole attention
    sdpa = torch.nn.functional.scaled_dot_product_attention
    g = torch.Generator(device="cuda").manual_seed(SEED)
    qf, kf, vf = (torch.randn((B, H, S, D), generator=g, device="cuda",
                              dtype=torch.bfloat16) for _ in range(3))
    lib_ms = cuda_ms(lambda: sdpa(qf, kf, vf))
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    lib_views_ms = cuda_ms(lambda: sdpa(qt, kt, vt))
    print(f"flash_blockwise bf16 (B, S, H, D) = ({B}, {S}, {H}, {D}), block "
          f"{bs}, one launch: kernel {kern_ms:.4f} ms, plain route "
          f"{plain_ms:.4f} ms, bound {bound_s * 1e6:.1f} us ({bound_by}: "
          f"{nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP; kernel at "
          f"{bound_s * 1e3 / kern_ms:.3f} of it); turns plain,kernel,kernel,"
          f"plain = {[round(x, 4) for x in t]}", flush=True)
    print(f"flash_block_update one block B={B} H={H} Q={S} K={bs} D={D} "
          f"bf16, carried state: kernel {blk[1]:.4f} ms, plain "
          f"{blk[0]:.4f} ms", flush=True)
    print(f"yardstick: scaled_dot_product_attention over all {S} keys bf16 "
          f"{lib_ms:.4f} ms (contiguous (B, H, S, D)), {lib_views_ms:.4f} ms "
          f"(the same views, unmasked); the kernel takes "
          f"{kern_ms / lib_ms:.3f}x the first", flush=True)
    return dict(max_abs_err=max(results.values()), ms=kern_ms,
                plain_ms=plain_ms, bound_ms=bound_s * 1e3, bound_by=bound_by,
                library_ms=lib_ms, library_views_ms=lib_views_ms,
                block_ms=blk[1], block_plain_ms=blk[0], errors=results)


# ---------------------------------------------------------------------------
# phase 4: main path
# ---------------------------------------------------------------------------


SPECIALS = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]


def serving_config():
    """The served model: BERT-base at full width and depth, the op's
    long-document setting (attentionBlockSize 128, maxSeqLength 512)."""
    from alink_tpu_torch.dl.modules import BertConfig

    return BertConfig.base(max_position=512, num_labels=2, pool="mean",
                           attention_block_size=128)


def flax_params(cfg, rng):
    """A parameter tree of the reference's flax TransformerEncoder shapes:
    normal(0, 0.02) weights, except q and k at 1/sqrt(hidden), which gives
    attention scores (of LayerNorm'd inputs) a spread of about one unit."""
    h, inter = cfg.hidden_size, cfg.intermediate_size

    def normal(*shape):
        return (rng.standard_normal(shape, np.float32) * 0.02).astype(np.float32)

    def dense(i, o):
        return {"kernel": normal(i, o), "bias": normal(o)}

    def norm():
        return {"scale": np.ones(h, np.float32), "bias": np.zeros(h, np.float32)}

    def qkv():
        kernel = normal(h, 3, h)
        kernel[:, :2] *= h ** -0.5 / 0.02
        return {"kernel": kernel, "bias": normal(3, h)}

    p = {"tok_emb": {"embedding": normal(cfg.vocab_size, h)},
         "pos_emb": {"embedding": normal(cfg.max_position, h)},
         "type_emb": {"embedding": normal(cfg.type_vocab_size, h)},
         "ln_emb": norm()}
    for i in range(cfg.num_layers):
        p[f"layer_{i}"] = {
            "attention": {"qkv": qkv(), "out": dense(h, h)},
            "ln_att": norm(), "mlp_in": dense(h, inter),
            "mlp_out": dense(inter, h), "ln_mlp": norm()}
    p["pooler"] = dense(h, h)
    p["head"] = dense(h, cfg.num_labels)
    return {"params": p}


def synthetic_vocab(cfg):
    """``vocab_size`` wordpieces: the special tokens, then w0, w1, ..."""
    return SPECIALS + [f"w{i}" for i in range(cfg.vocab_size - len(SPECIALS))]


def request_texts(vocab, rng, n):
    """n texts of WORDS[0]..WORDS[1] seeded words: at maxSeqLength 512 their
    K blocks are full, partial or all padding."""
    lens = rng.integers(WORDS[0], WORDS[1] + 1, n)
    return [" ".join(vocab[j] for j in rng.integers(len(SPECIALS), len(vocab),
                                                    w))
            for w in lens]


def forward_ms(model, enc, reps: int = 3) -> float:
    """Wall ms of one warm ``predict_model`` call (host clock, synced)."""
    import torch

    from alink_tpu_torch.dl.train import predict_model

    predict_model(model, enc)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        predict_model(model, enc)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def main_path(workdir, cfg):
    import dataclasses

    import torch

    from alink_tpu_torch.common.model import model_to_table
    from alink_tpu_torch.common.mtable import MTable
    from alink_tpu_torch.dl.modules import TransformerEncoder
    from alink_tpu_torch.dl.train import predict_model
    from alink_tpu_torch.mapper import softmax_np
    from alink_tpu_torch.native import kernels
    from alink_tpu_torch.operator.batch import (
        AkSinkBatchOp, AkSourceBatchOp, BertTextClassifierPredictBatchOp,
        BertTextModelMapper, TableSourceBatchOp)
    from alink_tpu_torch.operator.batch.dl import params_to_bytes

    rng = np.random.default_rng(SEED)
    vocab = synthetic_vocab(cfg)
    t0 = time.perf_counter()
    tree = flax_params(cfg, rng)
    meta = {"modelName": "BertTextModel",
            "bertConfig": {k: v for k, v in dataclasses.asdict(cfg).items()
                           if k != "dtype"},
            "textCol": "text", "textPairCol": None, "labelCol": "label",
            "labelType": "LONG", "labels": [0, 1], "regression": False,
            "maxSeqLength": 512, "vocab": vocab, "doLowerCase": True}
    model_table = model_to_table(meta, {"params": params_to_bytes(tree)})
    path = os.path.join(workdir, "bert_base.ak")
    AkSinkBatchOp(filePath=path, overwriteSink=True).link_from(
        TableSourceBatchOp(model_table)).collect()
    model_src = AkSourceBatchOp(filePath=path)
    print(f"model: BERT-base weights from seed {SEED}, encoded and written to "
          f".ak ({os.path.getsize(path) / 1e6:.1f} MB) in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    requests = []
    for n in REQUEST_ROWS:
        texts = request_texts(vocab, rng, n)
        requests.append(MTable({"text": np.asarray(texts, dtype=object),
                                "label": rng.integers(0, 2, n)},
                               "text string, label long"))

    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    outs, lat = [], []
    for table in requests:
        t0 = time.perf_counter()
        out = BertTextClassifierPredictBatchOp(
            predictionCol="pred", predictionDetailCol="detail").link_from(
            model_src, TableSourceBatchOp(table)).collect()
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t0)
        outs.append(out)
    launches = kernels.launches()["flash_block_update"]
    peak = torch.cuda.max_memory_allocated()

    chunks = sum(-(-n // 256) for n in REQUEST_ROWS)
    expect = chunks * cfg.num_layers
    if launches != expect:
        fail(f"flash_block_update launched {launches} times on the main path, "
             f"expected {expect} (one per layer: 12 per forward chunk)")
    for n, out in zip(REQUEST_ROWS, outs):
        probs = np.asarray([[json.loads(d)[k] for k in ("0", "1")]
                            for d in out.col("detail")])
        if out.num_rows != n or probs.shape != (n, 2) \
                or not np.isfinite(probs).all() \
                or not np.allclose(probs.sum(1), 1.0, atol=1e-6) \
                or not set(np.asarray(out.col("pred")).tolist()) <= {0, 1}:
            fail(f"request of {n} rows: bad output table")
        print(f"request {n:3d} rows: {lat[REQUEST_ROWS.index(n)] * 1e3:.1f} ms "
              f"end to end (model load included), "
              f"{n / lat[REQUEST_ROWS.index(n)]:.1f} rows/s", flush=True)
    print(f"main path: {launches} flash_block_update launches over {chunks} "
          f"forward chunks; peak device memory {peak / 2**30:.2f} GiB",
          flush=True)

    # the same model, straight through predict_model: warm forward times
    # and the logits checks
    mapper = BertTextModelMapper(None, requests[-1].schema, None)
    mapper.load_model(model_src.collect())
    model = mapper.model
    enc = mapper.tokenizer.encode_batch(list(requests[-1].col("text")),
                                        max_len=512)
    lens = enc["attention_mask"].sum(1)
    full_blocks = int(((lens[:, None] - np.arange(4) * 128) >= 128).sum())
    empty_blocks = int(((lens[:, None] - np.arange(4) * 128) <= 0).sum())
    print(f"64-row request: token counts {int(lens.min())}..{int(lens.max())}; "
          f"K blocks full {full_blocks}, all padding {empty_blocks}, partial "
          f"{4 * len(lens) - full_blocks - empty_blocks}", flush=True)
    for n in REQUEST_ROWS:
        sub = {k: v[:n] for k, v in enc.items()}
        dt = forward_ms(model, sub)
        print(f"forward {n:3d} rows (warm, predict_model): {dt:.1f} ms, "
              f"{n / dt * 1e3:.1f} rows/s", flush=True)

    full_model = TransformerEncoder(
        dataclasses.replace(mapper.cfg, attention_block_size=0))
    full_model.load_state_dict(model.state_dict())

    routes = {"kernel": [], "plain": [], "full": []}
    for _ in range(2):
        routes["kernel"].append(forward_ms(model, enc))
        routes["plain"].append(plain_route(forward_ms, model, enc))
        routes["full"].append(forward_ms(full_model, enc))
    print("warm 64-row forward by attention route, ms (two turns each): "
          + ", ".join(f"{r} {t}" for r, t in routes.items()), flush=True)

    logits = predict_model(model, enc)
    plain = plain_route(predict_model, model, enc)
    full = predict_model(full_model, enc)
    if not np.isfinite(logits).all():
        fail("non-finite logits")
    for label, ref in (("plain attention", plain), ("full attention", full)):
        err = float(np.abs(logits - ref).max())
        agree = float(np.mean(logits.argmax(1) == ref.argmax(1)))
        print(f"served logits vs {label}: max|Δ| = {err:.4g} (tol "
              f"{LOGIT_ATOL}, max|logit| {float(np.abs(ref).max()):.4g}, "
              f"logit spread {float(ref.std()):.4g}), argmax agreement "
              f"{agree:.3f}", flush=True)
        if not err <= LOGIT_ATOL:
            fail(f"served logits differ from {label} by {err} > {LOGIT_ATOL}")
    served = np.asarray([[json.loads(d)[k] for k in ("0", "1")]
                         for d in outs[-1].col("detail")])
    gap = float(np.abs(served - softmax_np(logits)).max())
    print(f"64-row request probabilities vs predict_model softmax: max|Δ| = "
          f"{gap:.3g}", flush=True)
    if not gap <= 0.02:
        fail(f"operator output disagrees with predict_model ({gap})")
    return launches


# ---------------------------------------------------------------------------
# phases 5-7: the tree slice
# ---------------------------------------------------------------------------


COVTYPE_TRAIN, COVTYPE_TEST = 522_911, 58_101   # sklearn bench_covertype.py
COVTYPE_CONTINUOUS = (
    "Elevation", "Aspect", "Slope", "Horizontal_Distance_To_Hydrology",
    "Vertical_Distance_To_Hydrology", "Horizontal_Distance_To_Roadways",
    "Hillshade_9am", "Hillshade_Noon", "Hillshade_3pm",
    "Horizontal_Distance_To_Fire_Points")
COVTYPE_COLS = COVTYPE_CONTINUOUS \
    + tuple(f"Wilderness_Area{i}" for i in range(1, 5)) \
    + tuple(f"Soil_Type{i}" for i in range(1, 41))
FOREST = dict(numTrees=20, maxDepth=12, maxBins=64, minSamplesPerLeaf=5)
HIST_BINS = FOREST["maxBins"]
GBDT = dict(numTrees=20, maxDepth=6, maxBins=64)
TREE_REQUEST_ROWS = (1, 1000, COVTYPE_TEST)
FP32_EPS = 2.0 ** -24    # fp32 unit roundoff
ORACLE_ROWS = 1000       # held-out rows the predict traversal is held on


def covertype_data(n, seed):
    """n seeded rows in UCI Covertype's column layout (the file is not in the
    repository): 10 continuous columns in the file's ranges, rounded to
    integers as there, then 4 one-hot wilderness and 40 one-hot soil columns
    with skewed frequencies; the label (class 1 against the rest) is a fixed
    linear rule of the standardised continuous columns, wilderness and soil,
    plus noise. Returns X (n, 54) float32 and y (n,) int64."""
    g = np.random.default_rng(seed)
    rule = np.random.default_rng(seed + 1)   # the label rule, same for any n
    cont = np.stack([
        np.clip(g.normal(2959, 280, n), 1859, 3858),
        g.uniform(0, 360, n),
        np.clip(g.gamma(4.0, 3.5, n), 0, 66),
        np.clip(g.exponential(270, n), 0, 1397),
        np.clip(g.normal(46, 58, n), -173, 601),
        np.clip(g.exponential(2350, n), 0, 7117),
        np.clip(g.normal(212, 27, n), 0, 254),
        np.clip(g.normal(223, 20, n), 0, 254),
        np.clip(g.normal(143, 38, n), 0, 254),
        np.clip(g.exponential(1980, n), 0, 7173)], axis=1).round()
    wild = g.choice(4, n, p=[0.449, 0.051, 0.436, 0.064])
    soil_p = rule.permutation(1.0 / np.arange(1, 41) ** 1.1)
    soil = g.choice(40, n, p=soil_p / soil_p.sum())
    X = np.zeros((n, 54), np.float32)
    X[:, :10] = cont
    X[np.arange(n), 10 + wild] = 1.0
    X[np.arange(n), 14 + soil] = 1.0
    z = (cont - cont.mean(0)) / cont.std(0)
    wild_eff = np.array([0.4, 1.0, -0.3, -1.2])
    soil_eff = rule.normal(0.0, 0.8, 40)
    score = z @ np.array([1.2, 0.1, -0.6, -0.4, 0.2, 0.5, 0.2, 0.3, 0.0, 0.5]) \
        + wild_eff[wild] + soil_eff[soil] - 0.3 + g.normal(0.0, 0.5, n)
    return X, (score > 0).astype(np.int64)


def covertype_table(X, y):
    from alink_tpu_torch.common.mtable import MTable

    cols = {c: X[:, j].astype(np.float64) for j, c in enumerate(COVTYPE_COLS)}
    cols["label"] = y
    return MTable(cols)


def level_inputs(bins, level, seed, device="cuda", oob=False):
    """One level of the forest's level program on Covertype-layout bins
    (n, 54) uint8 (a numpy array, or a tensor already on ``device``):
    seeded node ids spread evenly over the level's L = 2**level nodes; with
    ``oob``, 1 % of the nodes set to -1 and 1 % to [L, L+8), and 1 % of the
    bins to [64, 256), where node·B + bin points past the node. Returns
    (bins, node int32, L, vals): vals maps "g" to the forest's integer
    g = -label·(bootstrap count), "count" to the counts, "normal" to
    standard-normal reals."""
    import torch

    g = np.random.default_rng(seed)
    n = bins.shape[0]
    L = 1 << level
    node = g.integers(0, L, n)
    if oob:
        r = g.random(n)
        node = np.where(r < 0.01, -1, node)
        node = np.where(r > 0.99, L + g.integers(0, 8, n), node)
        b = np.asarray(bins.cpu() if isinstance(bins, torch.Tensor) else bins)
        hi = g.random(b.shape) < 0.01
        bins = np.where(hi, g.integers(64, 256, b.shape), b).astype(np.uint8)
    if not isinstance(bins, torch.Tensor):
        bins = torch.tensor(bins, dtype=torch.uint8, device=device)
    w = g.multinomial(n, np.ones(n) / n).astype(np.float32)
    label = g.integers(0, 2, n).astype(np.float32)
    vals = {"g": -(label * w), "count": w,
            "normal": g.standard_normal(n).astype(np.float32)}
    return (bins, torch.tensor(node, dtype=torch.int32, device=device), L,
            {k: torch.tensor(v, device=device) for k, v in vals.items()})


def level_mismatch(bins, node, vals, L, got, exact):
    """Holds one level's histograms ``got`` (a tuple of C (L, d, B) tensors)
    against ``level_histograms_ref`` on the same inputs. ``exact``: per
    channel, integer vals. Returns (max|Δ|, worst error/bound; > 1 fails).
    Exact channels: any difference fails. Real vals: |Δ| ≤
    2·count·2**-24·Σ|vals| per cell, count and Σ|vals| from the plain
    version on ones and |vals| (the worst-case fp32 error of a sum in any
    order, for both sides)."""
    import torch

    from alink_tpu_torch.tree.hist_cuda import level_histograms_ref

    kw = dict(num_nodes=L, num_bins=HIST_BINS)
    ref = level_histograms_ref(bins, node, vals, **kw)
    if len(got) != len(ref) or any(
            a.shape != r.shape or not bool(torch.isfinite(a).all())
            for a, r in zip(got, ref)):
        return float("nan"), float("inf")
    raw, ratio = 0.0, 0.0
    for a, r, v, ex in zip(got, ref, vals, exact):
        err = (a - r).abs()
        raw = max(raw, float(err.max()))
        if ex:
            ratio = max(ratio, 0.0 if float(err.max()) == 0 else float("inf"))
            continue
        count, size = level_histograms_ref(bins, node,
                                           (torch.ones_like(v), v.abs()), **kw)
        ratio = max(ratio, worst_ratio(err, 2 * count * FP32_EPS * size))
    return raw, ratio


def level_bytes(n, d, L, channels, bin_bytes=1):
    """Bytes one level call must move: bins, node and the distinct channels'
    vals read once, their (L, d, B) histograms written once."""
    return n * d * bin_bytes + 4 * n + channels * (4 * n + 4 * L * d
                                                   * HIST_BINS)


def time_level(peaks, bins, node, vals, L, label):
    """Times one level call of ``level_histograms`` on (bins, node, vals) in
    turns with its plain version, and one
    ``index_add_`` over the flat cell index of the distinct channels as the
    yardstick, each as device time in a CUDA graph (the call's few
    launches issued from Python are timed at the host's pace otherwise);
    returns ms of each, the bound, the turns and the eager time."""
    import torch

    from alink_tpu_torch.tree.hist_cuda import (level_histograms,
                                                level_histograms_ref)

    n, d = bins.shape
    kw = dict(num_nodes=L, num_bins=HIST_BINS)
    plain = lambda: level_histograms_ref(bins, node, vals, **kw)  # noqa: E731
    kern = lambda: level_histograms(bins, node, vals, **kw)  # noqa: E731
    uniq = list({id(v): v for v in vals}.values())
    C = len(uniq)
    cell = (node.long()[:, None] * d + torch.arange(d, device="cuda")) \
        * HIST_BINS + bins.long()                            # (n, d)
    flat = torch.cat([cell.reshape(-1) + c * L * d * HIST_BINS
                      for c in range(C)])
    vflat = torch.cat([v[:, None].expand(n, d).reshape(-1) for v in uniq])
    lib = lambda: torch.zeros(C * L * d * HIST_BINS,  # noqa: E731
                              device="cuda").index_add_(0, flat, vflat)
    slow = dict(iters=3, reps=5)
    t = [graph_ms(plain, **slow), graph_ms(kern, 10, 20),
         graph_ms(kern, 10, 20), graph_ms(plain, **slow)]
    bw, _, fp32_peak = peaks
    nbytes = level_bytes(n, d, L, C)
    row = dict(ms=(t[1] + t[2]) / 2, plain_ms=(t[0] + t[3]) / 2,
               library_ms=graph_ms(lib, **slow), bound_ms=max(
                   nbytes / bw, C * n * d / fp32_peak) * 1e3, turns=t,
               eager_ms=cuda_ms(kern))
    del flat, vflat, cell
    print(f"tree_histogram level call {label} n={n} d={d} L={L} "
          f"(S = {L * HIST_BINS}), {len(vals)} channels ({C} distinct), "
          f"device time in CUDA graphs: kernel {row['ms']:.4f} ms (its sort "
          f"of the rows by node included), plain "
          f"{row['plain_ms']:.4f} ms, index_add_ yardstick "
          f"{row['library_ms']:.4f} ms, bound {row['bound_ms'] * 1e3:.1f} us "
          f"(bytes: {nbytes / 1e6:.1f} MB); turns plain,kernel,kernel,plain "
          f"= {[round(x, 4) for x in t]}; issued eagerly from Python "
          f"{row['eager_ms']:.4f} ms", flush=True)
    return row


LEVEL_CASES = (          # (label, the channels (g, h, c) by value kind)
    ("forest g, count, count (h is c)", ("g", "count", "count")),
    ("normal, g, count (h != c)", ("normal", "g", "count")),
)


def level_cases(bins, level, seed, device="cuda"):
    """Phase 5's inputs at one level: the forest's channels (h is c) and
    real-valued ones (h != c) on evenly spread nodes; at L = 1, 64 and 2,048
    both again with nodes and bins out of range. Yields (label, bins, node,
    L, vals, exact)."""
    cases = [(level_inputs(bins, level, seed, device), "")]
    if level in (0, 6, 11):
        cases.append((level_inputs(bins, level, seed + 100, device,
                                   oob=True), "oob "))
    for (b, node, L, vals), tag in cases:
        for label, names in LEVEL_CASES:
            if names[1] == names[2]:
                chans = (vals[names[0]], vals[names[1]], vals[names[1]])
            else:
                chans = tuple(vals[k] for k in names)
            yield (tag + label, b, node, L, chans,
                   tuple(k != "normal" for k in names))


def check_histogram(peaks, bins):
    """Phase 5: the fused level call ``level_histograms`` against
    ``level_histograms_ref`` on the card at every level of a depth-12 tree
    (L = 1 … 2,048, S = 64 … 131,072) with seeded node ids spread evenly
    over the level's nodes, then timed there. Returns the raw errors and the
    timings by S."""
    import torch

    from alink_tpu_torch.tree.hist_cuda import level_histograms

    staged = torch.tensor(bins, dtype=torch.uint8, device="cuda")
    by_segments, errors = {}, {}
    for level in range(FOREST["maxDepth"]):
        timed = None
        for label, b, node, L, vals, exact in level_cases(
                staged, level, SEED + level):
            got = level_histograms(b, node, vals, num_nodes=L,
                                   num_bins=HIST_BINS)
            raw, ratio = level_mismatch(b, node, vals, L, got, exact)
            S = L * HIST_BINS
            print(f"tree_histogram vs plain [S={S} {label}] max|Δ| "
                  f"{raw:.3g}; error/bound {ratio:.3g} (exact channels: "
                  f"{exact})", flush=True)
            if not ratio <= 1.0:
                fail(f"tree_histogram [S={S} {label}] outside its tolerance")
            errors[f"S={S} {label}"] = raw
            if timed is None:
                timed = (b, node, vals, L)
        by_segments[timed[3] * HIST_BINS] = time_level(
            peaks, *timed, "even nodes")
    return errors, by_segments


def main_path_histograms(peaks, kept):
    """The forest's first tree, level by level: its level calls' inputs as
    the main path made them (``kept``), held against the plain version
    (exact: integer vals) and timed. Returns the means over the levels, the
    raw errors and the timings by S."""
    from alink_tpu_torch.tree.hist_cuda import level_histograms

    rows, errors = {}, {}
    for bins, node, vals, L in kept:
        S = L * HIST_BINS
        got = level_histograms(bins, node, vals, num_nodes=L,
                               num_bins=HIST_BINS)
        raw, ratio = level_mismatch(bins, node, vals, L, got,
                                    (True,) * len(vals))
        if not ratio <= 1.0:
            fail(f"tree_histogram on the forest's level S={S}: max|Δ| {raw}")
        errors[f"forest level S={S}"] = raw
        rows[S] = time_level(peaks, bins, node, vals, L, "forest tree 1")
    mean = {k: sum(r[k] for r in rows.values()) / len(rows)
            for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
    return mean, errors, rows


def predict_numpy(ens, X):
    """The reference's traversal (alink_tpu/tree/grow.py:189-213) in numpy,
    tree by tree: the oracle the card's predict is held against."""
    n = X.shape[0]
    out = np.tile(ens.base_score[None, :].astype(np.float64), (n, 1))
    for f, t, lv in zip(ens.feats, ens.thrs, ens.leaves):
        node = np.zeros(n, np.int64)
        pos = np.zeros(n, np.int64)
        for _ in range(ens.depth):
            fs, ts = f[pos], t[pos]
            x = X[np.arange(n), np.maximum(fs, 0)]
            right = (~((fs < 0) | (x <= ts))).astype(np.int64)
            node = node * 2 + right
            pos = 2 * pos + 1 + right
        out += lv[:, node].T
    return out


def instrument_forest(grow):
    """Wraps ``grow._level`` and ``grow.level_histograms`` so that each call
    records CUDA events, and keeps the first tree's level-call inputs.
    Returns (levels, launches, kept, restore): (level, start, end) per
    level program, (start, end) per level call of the histogram, (bins,
    node, vals, L) per level of the first tree, and the hook that undoes
    the wrapping."""
    import torch

    orig_level, orig_hist = grow._level, grow.level_histograms
    levels, launches, kept = [], [], []

    def events():
        return (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))

    def level(*args, **kw):
        a, b = events()
        a.record()
        out = orig_level(*args, **kw)
        b.record()
        levels.append((args[6].bit_length() - 1, a, b))   # num_nodes
        return out

    def hist(bins, node, vals, *, num_nodes, num_bins):
        a, b = events()
        a.record()
        out = orig_hist(bins, node, vals, num_nodes=num_nodes,
                        num_bins=num_bins)
        b.record()
        if len(kept) < FOREST["maxDepth"]:
            kept.append((bins, node, tuple(vals), num_nodes))
        launches.append((a, b))
        return out

    def restore():
        grow._level, grow.level_histograms = orig_level, orig_hist

    grow._level, grow.level_histograms = level, hist
    return levels, launches, kept, restore


def train_trees(op_cls, params, table):
    """Train through ``TableSourceBatchOp`` → ``op_cls`` → ``collect()``;
    returns the model table and the wall seconds."""
    import torch

    from alink_tpu_torch.operator.batch import TableSourceBatchOp

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = op_cls(labelCol="label", **params).link_from(
        TableSourceBatchOp(table)).collect()
    torch.cuda.synchronize()
    return model, time.perf_counter() - t0


def serve_trees(op_cls, model_src, X_test, y_test, label):
    """Serves held-out requests of TREE_REQUEST_ROWS rows; checks each
    output table; returns the predictions of the whole held-out set."""
    import torch

    from alink_tpu_torch.operator.batch import TableSourceBatchOp

    pred = None
    for n in TREE_REQUEST_ROWS:
        req = covertype_table(X_test[:n], y_test[:n])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = op_cls(predictionCol="pred", predictionDetailCol="detail") \
            .link_from(model_src, TableSourceBatchOp(req)).collect()
        dt = time.perf_counter() - t0
        probs = np.asarray([[json.loads(s)[k] for k in ("0", "1")]
                            for s in out.col("detail")])
        pred = np.asarray(out.col("pred"))
        if out.num_rows != n or not np.isfinite(probs).all() \
                or not np.allclose(probs.sum(1), 1.0, atol=1e-6) \
                or not set(pred.tolist()) <= {0, 1}:
            fail(f"{label} request of {n} rows: bad output table")
        print(f"{label} predict {n:5d} rows: {dt * 1e3:.1f} ms end to end, "
              f"{n / dt:.0f} rows/s", flush=True)
    from alink_tpu_torch.common.model import table_to_model
    from alink_tpu_torch.tree import TreeEnsemble

    ens = TreeEnsemble.from_arrays(*table_to_model(model_src.collect()))
    ens.raw_predict(X_test)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        ens.raw_predict(X_test)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / 3
    print(f"{label} raw_predict alone (warm, {len(X_test)} rows, "
          f"{ens.feats.shape[0]} trees): {dt * 1e3:.2f} ms, "
          f"{len(X_test) / dt:.0f} rows/s", flush=True)
    return pred


def forest_path(workdir, X, y, peaks):
    """Phase 6: the forest at full size through the operators on the card.
    Returns the main path's tree_histogram launches, the device ms of its
    level calls and level programs there, and the kernel's timings on the
    first tree's inputs."""
    import torch

    from alink_tpu_torch.common.model import table_to_model
    from alink_tpu_torch.native import kernels
    from alink_tpu_torch.operator.batch import (
        AkSinkBatchOp, AkSourceBatchOp, RandomForestPredictBatchOp,
        RandomForestTrainBatchOp, TableSourceBatchOp)
    from alink_tpu_torch.tree import TreeEnsemble, grow

    n_tr = COVTYPE_TRAIN
    train = covertype_table(X[:n_tr], y[:n_tr])
    X_test, y_test = X[n_tr:], y[n_tr:]
    levels, launch_ev, kept, restore = instrument_forest(grow)
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    try:
        model, wall = train_trees(RandomForestTrainBatchOp, FOREST, train)
    finally:
        restore()
    launches = kernels.launches()["tree_histogram"]
    peak = torch.cuda.max_memory_allocated()
    expect = FOREST["maxDepth"] * FOREST["numTrees"]
    depth = FOREST["maxDepth"]
    first, rest = [0.0] * depth, [0.0] * depth
    for i, (lv, a, b) in enumerate(levels):
        (first if i < depth else rest)[lv] += a.elapsed_time(b)
    launch_ms = [a.elapsed_time(b) for a, b in launch_ev]
    print(f"forest train ({n_tr} rows, {FOREST}): {wall:.2f} s wall; "
          f"{launches} tree_histogram launches, {sum(launch_ms):.1f} ms of "
          f"device time in the level calls, sort of node included (mean "
          f"{np.mean(launch_ms):.4f} ms, by level of the first tree "
          f"{[round(t, 4) for t in launch_ms[:depth]]}); peak "
          f"device memory {peak / 2**30:.2f} GiB; level program device ms "
          f"by level, first tree {[round(t, 2) for t in first]}, mean of "
          f"the other {FOREST['numTrees'] - 1} "
          f"{[round(t / (FOREST['numTrees'] - 1), 3) for t in rest]}; all "
          f"levels of all trees {sum(first) + sum(rest):.1f} ms",
          flush=True)
    if launches != expect:
        fail(f"tree_histogram launched {launches} times on the forest path, "
             f"expected {expect} (one per level)")
    stats = main_path_histograms(peaks, kept)
    del kept

    os.environ[grow.HIST_KERNEL_ENV] = "0"
    try:
        plain_model, plain_wall = train_trees(RandomForestTrainBatchOp,
                                              FOREST, train)
    finally:
        del os.environ[grow.HIST_KERNEL_ENV]
    (meta, arrays), (_, plain_arrays) = (table_to_model(m)
                                         for m in (model, plain_model))
    same = {k: np.array_equal(arrays[k], plain_arrays[k])
            for k in ("feats", "thrs", "leaves")}
    print(f"forest trees vs the ALINK_GBDT_PALLAS=0 route "
          f"({plain_wall:.2f} s wall): identical {same}; split features "
          f"sha1 {hashlib.sha1(arrays['feats'].tobytes()).hexdigest()}",
          flush=True)
    if not all(same.values()):
        fail("the kernel route grew other trees than the plain route")

    path = os.path.join(workdir, "forest.ak")
    AkSinkBatchOp(filePath=path, overwriteSink=True).link_from(
        TableSourceBatchOp(model)).collect()
    model_src = AkSourceBatchOp(filePath=path)
    ens = TreeEnsemble.from_arrays(*table_to_model(model_src.collect()))
    got = ens.raw_predict(X_test[:ORACLE_ROWS])
    gap = float(np.abs(got - predict_numpy(ens, X_test[:ORACLE_ROWS])).max())
    print(f"forest raw_predict on the card vs numpy traversal "
          f"({ORACLE_ROWS} rows): max|Δ| {gap:.3g}", flush=True)
    if not gap <= 1e-6:
        fail(f"forest predict disagrees with the numpy traversal ({gap})")
    pred = serve_trees(RandomForestPredictBatchOp, model_src, X_test, y_test,
                       "forest")
    acc = float(np.mean(pred == y_test))
    base = max(np.mean(y_test), 1 - np.mean(y_test))
    print(f"forest held-out accuracy {acc:.4f} (majority class "
          f"{base:.4f})", flush=True)
    if not acc > base + 0.05:
        fail("forest held-out accuracy is no better than the majority class")
    return launches, dict(
        level_call_mean_ms=float(np.mean(launch_ms)),
        level_calls_total_ms=float(sum(launch_ms)),
        first_tree_level_call_ms=launch_ms[:depth],
        level_program_total_ms=sum(first) + sum(rest),
        level_program_first_tree_ms=first, train_wall_s=wall,
        plain_train_wall_s=plain_wall), stats


def gbdt_path(X, y):
    """Phase 7: GBDT at full size through the operators on the card."""
    import torch

    from alink_tpu_torch.operator.batch import (GbdtPredictBatchOp,
                                                GbdtTrainBatchOp,
                                                TableSourceBatchOp)

    n_tr = COVTYPE_TRAIN
    torch.cuda.reset_peak_memory_stats()
    model, wall = train_trees(GbdtTrainBatchOp, GBDT,
                              covertype_table(X[:n_tr], y[:n_tr]))
    print(f"gbdt train ({n_tr} rows, {GBDT}): {wall:.2f} s wall, "
          f"{n_tr / wall:.0f} rows/s; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    X_test, y_test = X[n_tr:], y[n_tr:]
    pred = serve_trees(GbdtPredictBatchOp, TableSourceBatchOp(model), X_test,
                       y_test, "gbdt")
    acc = float(np.mean(pred == y_test))
    base = max(np.mean(y_test), 1 - np.mean(y_test))
    print(f"gbdt held-out accuracy {acc:.4f} (majority class {base:.4f})",
          flush=True)
    if not acc > base + 0.05:
        fail("gbdt held-out accuracy is no better than the majority class")


# ---------------------------------------------------------------------------
# phases 8-9: the embedding slice
# ---------------------------------------------------------------------------


TEXT8_TYPES = 71_290     # text8's word types at min_count 5
SENTENCE = 1_000         # word2vec.c's MAX_SENTENCE_LENGTH
TOPICS = 100
W2V_TOKENS = 1_000_000
W2V = dict(vectorSize=100, window=5, negative=5, numIter=3, batchSize=1024,
           learningRate=0.025, minCount=1)
W2V_REQUEST_ROWS = (1, 1000, 10000)
SGNS_SHAPES = ((1024, 5, 100), (1000, 1, 37), (1000, 15, 100))
SGNS_TRAINED_STEPS = 300
OPS_STEPS = 100          # traced steps of the operations count
OPS_DOCS = 50            # sentences whose pairs they take
TABLE_ATOL = 1e-3        # trained tables, kernel route vs plain route
TOPIC_FLOOR = 0.32       # in-topic share of top-10 neighbours (chance 0.01)


def text8_corpus(n_tokens, seed):
    """Sentences in text8's layout (the file is not in the repository):
    ``n_tokens`` tokens ``w<rank>`` drawn by a Zipf law of exponent 1 over
    71,290 types, in sentences of 1,000 tokens. Each sentence has one of 100
    topics, and half its tokens come from the Zipf law restricted to its
    topic's words (rank mod 100), which gives the embedding something to
    learn. Returns the sentences as space-separated strings."""
    g = np.random.default_rng(seed)
    n_sent = n_tokens // SENTENCE
    p = 1.0 / np.arange(1, TEXT8_TYPES + 1)
    ids = np.searchsorted(np.cumsum(p) / p.sum(),
                          g.random((n_sent, SENTENCE)), side="right")
    topic = g.integers(0, TOPICS, n_sent)
    from_topic = g.random((n_sent, SENTENCE)) < 0.5
    u = g.random((n_sent, SENTENCE))
    for t in range(TOPICS):
        words = np.arange(t, TEXT8_TYPES, TOPICS)
        cdf = np.cumsum(1.0 / (words + 1.0))
        m = from_topic & (topic == t)[:, None]
        ids[m] = words[np.minimum(np.searchsorted(cdf / cdf[-1], u[m],
                                                  side="right"),
                                  len(words) - 1)]
    ids = np.minimum(ids, TEXT8_TYPES - 1)
    names = np.asarray([f"w{i}" for i in range(TEXT8_TYPES)], object)
    return [" ".join(row) for row in names[ids]]


def topic_share(words, vecs, device="cuda"):
    """The learning gate: of the top-10 cosine neighbours of the 1,000 most
    frequent words outside the top 100 (vocabulary rows 100..1099), the
    share that lies in the query's topic (rank mod 100); chance is 0.01."""
    import torch

    e = torch.as_tensor(np.asarray(vecs, np.float32), device=device)
    e = e / e.norm(dim=1, keepdim=True).clamp_min(1e-12)
    rows = torch.arange(100, 1100, device=device)
    sims = e[rows] @ e.T
    sims[torch.arange(1000, device=device), rows] = -float("inf")
    nb = sims.topk(10, dim=1).indices.cpu().numpy()
    topic = np.asarray([int(w[1:]) % TOPICS for w in words])
    return float(np.mean(topic[nb] == topic[100:1100, None]))


def sgns_bytes_flops(B, negs, D):
    """Bytes the function must move (v, u_pos, u_neg read once; grad_v and
    grad_u written once) and its fp32 operations: per row, negs+1 dot
    products (2D), negs+1 grad_u rows (D) and grad_v's negs+1 products and
    sums (2D)."""
    rows_in, rows_out = (2 + negs) * B, (2 + negs) * B
    return (rows_in + rows_out) * D * 4, 5.0 * (negs + 1) * B * D


def graph_ms(fn, iters: int = 30, reps: int = 50) -> float:
    """Device ms of one call of ``fn``: ``iters`` warm calls captured in a
    CUDA graph, replayed 20 times to warm up and then ``reps`` times between
    CUDA events (a window of milliseconds, long enough for the card's
    clocks to settle). A launch of a few microseconds issued from Python
    back to back is timed at the host's issue rate; the graph replays it at
    the device's."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    for _ in range(20):
        graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * iters)


def sgns_mismatch(args, got):
    """Holds ``got`` = (grad_v, grad_u) against ``sgns_block_grads_ref`` on
    the same ``args``; returns max|Δ| (NaN, wrong shapes or a non-finite
    value count as infinite). Tolerance: FP32_ATOL."""
    import torch

    from alink_tpu_torch.embedding.sgns_cuda import sgns_block_grads_ref

    ref = sgns_block_grads_ref(*args)
    if any(a.shape != b.shape or not bool(torch.isfinite(a).all())
           for a, b in zip(got, ref)):
        return float("inf")
    return max(float((a - b).abs().max()) for a, b in zip(got, ref))


def sgns_normal_inputs(B, negs, D, seed, device="cuda"):
    """Seeded N(0, 1) rows: dot products of size √D, which saturate the
    sigmoid."""
    import torch

    g = np.random.default_rng(seed)
    return tuple(torch.tensor(g.standard_normal(s), dtype=torch.float32,
                              device=device)
                 for s in ((B, D), (B, D), (B, negs, D)))


def word_pairs(docs):
    """(vocab, counts, pairs) of space-separated ``docs`` with the op's
    defaults (minCount 1, window 5, subsample 1e-3)."""
    from alink_tpu_torch.embedding import skipgram

    docs = [d.split(" ") for d in docs]
    vocab, counts = skipgram.build_vocab(docs)
    cfg = skipgram.SkipGramConfig()
    return vocab, counts, skipgram.make_pairs(docs, vocab, counts, cfg.window,
                                              cfg.subsample, SEED)


def sgns_trained_step(corpus, B, negs, D, steps=SGNS_TRAINED_STEPS,
                      device="cuda"):
    """The pull inputs of the ``steps``-th step of the plain route
    (``ALINK_SGNS_PALLAS=0``) training on ``corpus`` = (vocab, counts,
    pairs) at (B, negs, D): the tables (copied) and replicas at the
    magnitudes training gives them, the step's ids, rows and hot. Returns
    a dict of ``sgns_pull_grads``' arguments (hits aside)."""
    from alink_tpu_torch.embedding import skipgram
    from alink_tpu_torch.embedding.sgns_cuda import SGNS_KERNEL_ENV

    vocab, counts, pairs = corpus
    cfg = skipgram.SkipGramConfig(dim=D, negatives=negs, batch_size=B)
    n_blocks = max(1, len(pairs) // B)
    pairs = pairs[:steps * B]              # no more steps than needed
    cfg.epochs = -(-steps // n_blocks)
    seen, orig = [], skipgram.sgns_pull_grads_ref

    def keep(win, w_ctx, center, uids, **kw):
        seen.append(None)
        if len(seen) == steps:
            copy = lambda t: None if t is None else t.clone()  # noqa: E731
            seen[-1] = dict(
                win=win.clone(), w_ctx=w_ctx.clone(), center=center.clone(),
                uids=uids.clone(), negs=kw["negs"], rows=kw["rows"],
                hot=kw["hot"], rep_in=copy(kw["rep_in"]),
                rep_ctx=copy(kw["rep_ctx"]))
        return orig(win, w_ctx, center, uids, **kw)

    skipgram.sgns_pull_grads_ref = keep
    os.environ[SGNS_KERNEL_ENV] = "0"
    try:
        skipgram.train_skipgram_sharded(pairs, len(vocab), counts, cfg,
                                        device=device)
    finally:
        skipgram.sgns_pull_grads_ref = orig
        del os.environ[SGNS_KERNEL_ENV]
    return seen[steps - 1]


def pull_cases(step, seed):
    """Phase 8's inputs of the fused entry from a trained ``step``: the
    step's ids with 2 % of them set to sentinels (rows, where the one-rank
    pull parks hot ids, and -1) and 2 % to copies of other ids (duplicates
    beyond the Zipf draw's own), in three cases: the hot cache on, with
    replicas that differ from the tables' prefix by N(0, 0.01) noise (so a
    read of the table for a hot id shows); the hot cache off; one tied
    table with the cache on. Returns [(label, args)]."""
    import torch

    g = np.random.default_rng(seed)
    ids = {}
    for key in ("center", "uids"):
        x = step[key].cpu().numpy().copy()
        r = g.random(x.shape)
        x = np.where(r < 0.01, step["rows"], x)
        x = np.where((r >= 0.01) & (r < 0.02), -1, x)
        dup = r > 0.98
        x[dup] = x[g.integers(0, len(x), int(dup.sum()))]
        ids[key] = torch.tensor(x, dtype=torch.int64,
                                device=step["win"].device)

    def noisy(t):
        return t + torch.tensor(g.normal(0.0, 0.01, tuple(t.shape)),
                                dtype=torch.float32, device=t.device)

    hot = step["hot"]
    on = dict(step, **ids, rep_in=noisy(step["rep_in"]),
              rep_ctx=noisy(step["rep_ctx"]))
    off = dict(step, **ids, hot=0, rep_in=None, rep_ctx=None)
    tied = dict(on, w_ctx=on["win"], rep_ctx=on["rep_in"])
    return [(f"hot cache on ({hot} rows)", on), ("hot cache off", off),
            (f"tied table, hot cache on ({hot} rows)", tied)]


def pull_mismatch(args, fn):
    """Runs ``fn`` (``sgns_pull_grads`` or a stand-in) and
    ``sgns_pull_grads_ref`` on the same ``args``, each with a hit counter
    from 7 when the cache is on; returns max|Δ| of the gradients (infinite
    on other hits, wrong shapes or a non-finite value). Tolerance:
    FP32_ATOL."""
    import torch

    from alink_tpu_torch.embedding.sgns_cuda import sgns_pull_grads_ref

    dev = args["win"].device
    counters = [torch.full((), 7, dtype=torch.int64, device=dev)
                if args["hot"] > 0 else None for _ in range(2)]
    got = fn(**args, hits=counters[0])
    ref = sgns_pull_grads_ref(**args, hits=counters[1])
    if args["hot"] > 0 and int(counters[0]) != int(counters[1]):
        return float("inf")
    if len(got) != 2 or any(
            a.shape != b.shape or not bool(torch.isfinite(a).all())
            for a, b in zip(got, ref)):
        return float("inf")
    return max(float((a - b).abs().max()) for a, b in zip(got, ref))


def pull_bytes(B, negs, D):
    """Bytes the fused call must move: the (negs+2)·B ids and their table
    or replica rows read once, grad_v and grad_u written once."""
    rows = (2 + negs) * B
    return rows * 8 + 2 * rows * D * 4


def check_sgns(peaks, docs):
    """Phase 8: the gathered-rows entry ``sgns_block_grads`` against
    ``sgns_block_grads_ref`` at the main path's shape and two ragged ones,
    on rows of tables the plain route trained on ``docs`` and on N(0, 1)
    rows; the fused entry ``sgns_pull_grads`` against
    ``sgns_pull_grads_ref`` on the 300th-step tables and ids at the main
    path's shape (cache on and off, tied, sentinel and duplicate ids, hits
    equal); then both entries timed in a CUDA graph beside their bounds."""
    import torch

    from alink_tpu_torch.embedding.sgns_cuda import (pull_rows,
                                                     sgns_block_grads,
                                                     sgns_block_grads_ref,
                                                     sgns_pull_grads,
                                                     sgns_pull_grads_ref)

    corpus = word_pairs(docs)
    errors = {}
    for i, (B, negs, D) in enumerate(SGNS_SHAPES):
        step = sgns_trained_step(corpus, B, negs, D)
        cases = (("trained rows", pull_rows(**step)[:3]),
                 ("N(0,1) rows", sgns_normal_inputs(B, negs, D, SEED + i)))
        for kind, args in cases:
            err = sgns_mismatch(args, sgns_block_grads(*args))
            mag = max(float(a.abs().max()) for a in args)
            print(f"sgns_block_grads vs plain [(B, negs, D) = ({B}, {negs}, "
                  f"{D}), {kind}, max|input| {mag:.3g}] max|Δ| {err:.3g} "
                  f"(tol {FP32_ATOL})", flush=True)
            if not err <= FP32_ATOL:
                fail(f"sgns_block_grads ({B}, {negs}, {D}) {kind} outside "
                     f"its tolerance")
            errors[f"({B}, {negs}, {D}) {kind}"] = err
        if i == 0:
            timed, main_step = cases[0][1], step

    B, negs, D = SGNS_SHAPES[0]
    for label, args in pull_cases(main_step, SEED):
        err = pull_mismatch(args, sgns_pull_grads)
        print(f"sgns_pull_grads vs plain [(B, negs, D) = ({B}, {negs}, {D}), "
              f"300th-step tables, {label}, sentinel and duplicate ids] "
              f"max|Δ| {err:.3g} (tol {FP32_ATOL}; hits equal)", flush=True)
        if not err <= FP32_ATOL:
            fail(f"sgns_pull_grads [{label}] outside its tolerance or "
                 f"counted other hits")
        errors[f"pull ({B}, {negs}, {D}) {label}"] = err

    run = dict(main_step, hits=torch.zeros((), dtype=torch.int64,
                                           device="cuda"))
    plain = lambda: sgns_pull_grads_ref(**run)  # noqa: E731
    kern = lambda: sgns_pull_grads(**run)  # noqa: E731
    t = [graph_ms(plain), graph_ms(kern), graph_ms(kern), graph_ms(plain)]
    gplain = lambda: sgns_block_grads_ref(*timed)  # noqa: E731
    gkern = lambda: sgns_block_grads(*timed)  # noqa: E731
    gt = [graph_ms(gplain), graph_ms(gkern), graph_ms(gkern),
          graph_ms(gplain)]
    eager = [cuda_ms(plain), cuda_ms(kern), cuda_ms(kern), cuda_ms(plain)]
    bw, _, fp32_peak = peaks
    gbytes, flops = sgns_bytes_flops(B, negs, D)
    nbytes = pull_bytes(B, negs, D)
    bound_by = "bytes" if nbytes / bw >= flops / fp32_peak else "operations"
    row = dict(ms=(t[1] + t[2]) / 2, plain_ms=(t[0] + t[3]) / 2,
               bound_ms=max(nbytes / bw, flops / fp32_peak) * 1e3,
               bound_by=bound_by, library_ms=None, turns=t,
               gathered_ms=(gt[1] + gt[2]) / 2,
               gathered_plain_ms=(gt[0] + gt[3]) / 2,
               gathered_bound_ms=max(gbytes / bw, flops / fp32_peak) * 1e3,
               gathered_turns=gt,
               eager_ms=(eager[1] + eager[2]) / 2,
               eager_plain_ms=(eager[0] + eager[3]) / 2,
               hot_rows=main_step["hot"],
               errors=errors, max_abs_err=max(errors.values()))
    clocks = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(f"sgns_pull_grads ({B}, {negs}, {D}) fp32, hot cache of "
          f"{main_step['hot']} rows, device time per call (CUDA graph of 30 "
          f"launches, 50 replays; SM clock, max after: {clocks}): kernel "
          f"{row['ms']:.5f} ms, plain (pull + gradients) "
          f"{row['plain_ms']:.5f} ms, bound {row['bound_ms'] * 1e3:.2f} us "
          f"({bound_by}: {nbytes / 1e6:.2f} MB, {flops / 1e6:.2f} MFLOP); "
          f"turns plain,kernel,kernel,plain = {[round(x, 5) for x in t]}; "
          f"issued eagerly from Python: kernel {row['eager_ms']:.4f} ms, "
          f"plain {row['eager_plain_ms']:.4f} ms per call; gathered-rows "
          f"entry sgns_block_grads: kernel {row['gathered_ms']:.5f} ms, "
          f"plain {row['gathered_plain_ms']:.5f} ms, bound "
          f"{row['gathered_bound_ms'] * 1e3:.2f} us ({gbytes / 1e6:.2f} MB), "
          f"turns {[round(x, 5) for x in gt]}; no single PyTorch call "
          f"computes this function (library: none)", flush=True)
    return row


def step_operations(docs, steps=OPS_STEPS):
    """Device operations a step of the sharded loop (``torch.profiler``,
    CUDA activity, after an untraced warm run) on ``steps`` steps of the
    op's configuration over ``docs``, on the kernel route and on the plain
    route (``ALINK_SGNS_PALLAS=0``). Returns, per route, the operations,
    device µs and traced wall µs a step."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from alink_tpu_torch.embedding import skipgram
    from alink_tpu_torch.embedding.sgns_cuda import SGNS_KERNEL_ENV

    vocab, counts, pairs = word_pairs(docs)
    cfg = skipgram.SkipGramConfig(epochs=1)
    window = pairs[:steps * cfg.batch_size]
    out = {}
    for route, knob in (("kernel", None), ("plain", "0")):
        if knob is not None:
            os.environ[SGNS_KERNEL_ENV] = knob
        try:
            skipgram.train_skipgram_sharded(window, len(vocab), counts, cfg)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                skipgram.train_skipgram_sharded(window, len(vocab), counts,
                                                cfg)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
        finally:
            if knob is not None:
                del os.environ[SGNS_KERNEL_ENV]
        evs = [ev for ev in prof.key_averages()
               if ev.device_type == DeviceType.CUDA
               and ev.self_device_time_total > 0]
        out[route] = dict(
            operations_per_step=sum(ev.count for ev in evs) / steps,
            device_us_per_step=sum(ev.self_device_time_total
                                   for ev in evs) / steps,
            traced_wall_us_per_step=wall * 1e6 / steps)
    print(f"device operations a step ({steps} traced steps of the sharded "
          f"loop, vocabulary {len(vocab)}, torch.profiler): kernel route "
          f"{out['kernel']['operations_per_step']:.1f} "
          f"({out['kernel']['device_us_per_step']:.1f} us of device work, "
          f"{out['kernel']['traced_wall_us_per_step']:.1f} us traced wall), "
          f"plain route {out['plain']['operations_per_step']:.1f} "
          f"({out['plain']['device_us_per_step']:.1f} us, "
          f"{out['plain']['traced_wall_us_per_step']:.1f} us)", flush=True)
    return out


def instrument_word2vec(huge, skipgram):
    """Wraps the op's ``build_vocab`` and ``make_pairs`` (host clock) and the
    sharded step loop ``_run_pairs_sharded`` (host clock and CUDA events).
    Returns (stats, restore)."""
    import torch

    stats = {}
    orig = (huge.build_vocab, huge.make_pairs, skipgram._run_pairs_sharded)

    def timed(key, fn):
        def run(*args, **kw):
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            stats[key] = time.perf_counter() - t0
            return out
        return run

    def loop(*args, **kw):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        a.record()
        out = orig[2](*args, **kw)
        b.record()
        torch.cuda.synchronize()
        stats.update(loop_s=time.perf_counter() - t0,
                     loop_device_ms=a.elapsed_time(b), steps=args[5],
                     n_blocks=args[6], batch=args[3])
        return out

    def restore():
        huge.build_vocab, huge.make_pairs, skipgram._run_pairs_sharded = orig

    huge.build_vocab = timed("vocab_s", orig[0])
    huge.make_pairs = timed("pairs_s", orig[1])
    skipgram._run_pairs_sharded = loop
    return stats, restore


def train_word2vec(table):
    """``TableSourceBatchOp`` → ``Word2VecTrainBatchOp`` → ``collect()``;
    returns the model table and the wall seconds."""
    import torch

    from alink_tpu_torch.operator.batch import (TableSourceBatchOp,
                                                Word2VecTrainBatchOp)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = Word2VecTrainBatchOp(selectedCol="doc", **W2V).link_from(
        TableSourceBatchOp(table)).collect()
    torch.cuda.synchronize()
    return model, time.perf_counter() - t0


def model_vectors(model, dtype=np.float32):
    return np.stack([np.asarray(v.data, dtype) for v in model.col("vec")])


def word2vec_path(workdir, docs):
    """Phase 9: Word2Vec on the text8-layout corpus through the operators on
    the card. Returns the main path's sgns_block_grads launches and the
    path's numbers."""
    import torch

    from alink_tpu_torch.common.mtable import MTable
    from alink_tpu_torch.embedding import skipgram
    from alink_tpu_torch.embedding.sgns_cuda import SGNS_KERNEL_ENV
    from alink_tpu_torch.native import kernels
    from alink_tpu_torch.operator.batch import (AkSinkBatchOp,
                                                AkSourceBatchOp,
                                                TableSourceBatchOp,
                                                Word2VecPredictBatchOp, huge)

    table = MTable({"doc": np.asarray(docs, object)})
    stats, restore = instrument_word2vec(huge, skipgram)
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    try:
        model, wall = train_word2vec(table)
    finally:
        restore()
    launches = kernels.launches()["sgns_block_grads"]
    peak = torch.cuda.max_memory_allocated()
    steps, B = stats["steps"], stats["batch"]
    words = list(model.col("word"))
    vecs = model_vectors(model)
    print(f"word2vec train ({len(docs) * SENTENCE} tokens, {W2V}): "
          f"{wall:.2f} s wall; vocabulary {len(words)} types in "
          f"{stats['vocab_s']:.2f} s, pairs in {stats['pairs_s']:.2f} s "
          f"(host clock); step loop {steps} steps ({stats['n_blocks']} blocks "
          f"x {W2V['numIter']} epochs) in {stats['loop_s']:.2f} s: "
          f"{steps / stats['loop_s']:.0f} steps/s, "
          f"{steps * B / stats['loop_s']:.0f} pairs/s; device time per step "
          f"{stats['loop_device_ms'] / steps:.4f} ms (CUDA events around the "
          f"loop); {launches} sgns_block_grads launches; peak device memory "
          f"{peak / 2**30:.2f} GiB", flush=True)
    if launches != steps or steps != stats["n_blocks"] * W2V["numIter"]:
        fail(f"sgns_block_grads launched {launches} times on the Word2Vec "
             f"path, expected one per step ({steps})")
    if vecs.shape != (len(words), W2V["vectorSize"]) \
            or not np.isfinite(vecs).all():
        fail("the Word2Vec model table has bad vectors")

    os.environ[SGNS_KERNEL_ENV] = "0"
    try:
        plain_model, plain_wall = train_word2vec(table)
    finally:
        del os.environ[SGNS_KERNEL_ENV]
    plain = model_vectors(plain_model)
    gap = float(np.abs(vecs - plain).max())
    print(f"word2vec table vs the ALINK_SGNS_PALLAS=0 route "
          f"({plain_wall:.2f} s wall): same words "
          f"{list(plain_model.col('word')) == words}, max|Δ| {gap:.3g} "
          f"(tol {TABLE_ATOL}; max|table| {float(np.abs(plain).max()):.3g})",
          flush=True)
    if list(plain_model.col("word")) != words or not gap <= TABLE_ATOL:
        fail(f"the kernel route's table differs from the plain route's "
             f"({gap})")
    ops = step_operations(docs[:OPS_DOCS])
    share = topic_share(words, vecs)
    print(f"learning gate: in-topic share of the top-10 neighbours of "
          f"vocabulary rows 100..1099 = {share:.4f} (chance 0.01, floor "
          f"{TOPIC_FLOOR})", flush=True)
    if not share >= TOPIC_FLOOR:
        fail(f"Word2Vec did not learn the topics ({share} < {TOPIC_FLOOR})")

    path = os.path.join(workdir, "word2vec.ak")
    AkSinkBatchOp(filePath=path, overwriteSink=True).link_from(
        TableSourceBatchOp(model)).collect()
    model_src = AkSourceBatchOp(filePath=path)
    loaded = model_src.collect()
    # .ak keeps a vector as text of 6 significant digits (both packages)
    back = model_vectors(loaded, np.float64)
    ak_err = float((np.abs(back - vecs) / np.maximum(np.abs(vecs),
                                                      1e-30)).max())
    print(f"word2vec model through .ak ({os.path.getsize(path) / 1e6:.1f} "
          f"MB): largest relative change of a vector entry {ak_err:.3g} "
          f"(6 significant digits: ≤ 5e-6)", flush=True)
    if list(loaded.col("word")) != words or not ak_err <= 5.001e-6:
        fail("the Word2Vec model changed through .ak")
    lookup = dict(zip(words, back))
    requests = text8_corpus(max(W2V_REQUEST_ROWS) * SENTENCE, SEED + 1)
    rates = {}
    for n in W2V_REQUEST_ROWS:
        req = MTable({"doc": np.asarray(requests[:n], object)})
        t0 = time.perf_counter()
        out = Word2VecPredictBatchOp(
            selectedCol="doc", predictionCol="v").link_from(
            model_src, TableSourceBatchOp(req)).collect()
        dt = time.perf_counter() - t0
        got = np.stack([np.asarray(v.data) for v in out.col("v")])
        want = np.stack([np.mean([lookup[w] for w in d.split(" ")
                                  if w in lookup], axis=0)
                         for d in requests[:min(n, 100)]])
        err = float(np.abs(got[:len(want)] - want).max())
        rates[n] = n / dt
        print(f"word2vec predict {n:5d} sentences: {dt * 1e3:.1f} ms end to "
              f"end (the mapper's model load included; the .ak file was "
              f"read once above), {n / dt:.0f} rows/s; first "
              f"{len(want)} rows vs numpy mean of the table's rows: max|Δ| "
              f"{err:.3g}", flush=True)
        if out.num_rows != n or got.shape[1] != W2V["vectorSize"] \
                or not np.isfinite(got).all() or not err <= 1e-6:
            fail(f"word2vec request of {n} sentences: bad output table")
    return launches, dict(stats, wall_s=wall, plain_wall_s=plain_wall,
                          steps_per_s=steps / stats["loop_s"],
                          operations=ops, vocab=len(words), table_gap=gap,
                          topic_share=share, peak_gib=peak / 2**30,
                          predict_rows_per_s=rates)


def main() -> int:
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device: the port's smoke test runs only on the card")
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "alink_tpu_torch")):
        fail("alink_tpu_torch/ is not beside chip_smoke.py")
    sys.path.insert(0, here)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    name = torch.cuda.get_device_name(0)
    key, peaks = card_peaks(name)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, device {name} "
          f"(peaks used: {key}, {peaks[0] / 1e12:.2f} TB/s)", flush=True)

    from alink_tpu_torch.native import kernels

    kernels.build(verbose=False)
    print(f"build: {len(kernels.KERNELS)} kernel(s) + binding in "
          f"{kernels.build_seconds:.1f} s", flush=True)

    marks = [("setup and build", time.perf_counter())]
    stats = check_kernel(peaks)
    marks.append(("phase 3 flash kernel", time.perf_counter()))
    workdir = os.path.join(here, "build", "chip_smoke")
    os.makedirs(workdir, exist_ok=True)
    launches = main_path(workdir, serving_config())
    marks.append(("phase 4 BERT serving", time.perf_counter()))

    from alink_tpu_torch.tree.binning import apply_bins, quantile_bins

    t0 = time.perf_counter()
    X, y = covertype_data(COVTYPE_TRAIN + COVTYPE_TEST, SEED)
    bins = apply_bins(X[:COVTYPE_TRAIN], quantile_bins(X[:COVTYPE_TRAIN], 64))
    print(f"Covertype-layout data: {X.shape[0]} rows x {X.shape[1]} features "
          f"from seed {SEED}, label 1 in {y.mean():.3f} of rows; binned in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    errors, even = check_histogram(peaks, bins)
    del bins
    tree_launches, forest, (hist, forest_errors, levels) = forest_path(
        workdir, X, y, peaks)
    errors.update(forest_errors)
    hist.update(errors=errors, max_abs_err=max(errors.values()),
                bound_by="bytes")
    gbdt_path(X, y)
    marks.append(("phases 5-7 trees", time.perf_counter()))
    del X, y

    t0 = time.perf_counter()
    docs = text8_corpus(W2V_TOKENS, SEED)
    print(f"text8-layout corpus: {len(docs)} sentences of {SENTENCE} tokens "
          f"from seed {SEED} in {time.perf_counter() - t0:.1f} s", flush=True)
    sgns = check_sgns(peaks, docs[:250])
    sgns_launches, w2v = word2vec_path(workdir, docs)
    marks.append(("phases 8-9 Word2Vec", time.perf_counter()))

    def entry(name, launches, st, library_call, shape):
        spec = kernels.KERNELS[name]
        return {
            "name": spec.name, "route": spec.route,
            "source": "alink_tpu_torch/" + spec.source,
            "replaces": spec.replaces, "launches": launches,
            "max_abs_err": st["max_abs_err"], "ms": st["ms"],
            "plain_ms": st["plain_ms"], "bound_ms": st["bound_ms"],
            "bound_us": st["bound_ms"] * 1e3, "bound_by": st["bound_by"],
            "library_ms": st["library_ms"], "library_call": library_call,
            "shape": shape, "errors": st["errors"]}

    line = {"kernels": [
        dict(entry("flash_block_update", launches, stats,
                   "scaled_dot_product_attention over all 512 keys, "
                   "contiguous (B, H, S, D), unmasked (yardstick)",
                   "one attention call: (B, S, H, D) = (32, 512, 12, 64) "
                   "bf16, blocks of 128, q/k/v as unbind views of the qkv "
                   "product; ms is the fused launch, plain_ms the plain "
                   "route (ALINK_ATTN_PALLAS=0)"),
             library_views_ms=stats["library_views_ms"],
             block_ms=stats["block_ms"],
             block_plain_ms=stats["block_plain_ms"]),
        dict(entry("tree_histogram", tree_launches, hist,
                   "Tensor.index_add_ of the distinct channels over the "
                   "flat cell index (yardstick)",
                   f"one level call: n={COVTYPE_TRAIN} d=54 uint8 bins, "
                   f"int32 node, fp32 (g, count, count) with h is c; ms "
                   f"(device time in CUDA graphs), plain_ms, library_ms "
                   f"and bound_ms are means over the 12 levels (L = 1 ... "
                   f"2048, S = 64 ... 131072) of the forest's first tree, "
                   f"on its level calls' inputs"),
             forest=forest, forest_levels=levels,
             even_nodes=even),
        dict(entry("sgns_block_grads", sgns_launches, sgns, "none",
                   "one fused pull-and-gradients call (sgns_pull_grads): "
                   "B=1024 negs=5 D=100 fp32, the tables, hot replicas "
                   f"({sgns['hot_rows']} rows) and ids of the 300th step of "
                   "a training; ms and plain_ms (pull + gradients) are "
                   "device time per call from a CUDA graph of 30 launches; "
                   "gathered_* the gathered-rows entry sgns_block_grads on "
                   "that step's pulled rows"),
             **{k: sgns[k] for k in (
                 "gathered_ms", "gathered_plain_ms", "gathered_bound_ms",
                 "eager_ms", "eager_plain_ms", "turns", "gathered_turns")},
             word2vec=w2v)]}
    print("seconds by phase: " + ", ".join(
        f"{name} {t1 - t0:.1f}" for (_, t0), (name, t1)
        in zip([("", t_start)] + marks[:-1], marks)), flush=True)
    print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)
    print(card)
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
