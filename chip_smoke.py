"""Chip smoke test of the PyTorch/CUDA port (``alink_tpu_torch``) on one GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

It imports nothing of JAX or ``alink_tpu``. Phases, any failure exits
non-zero:

1. environment: card name and power limit (nvidia-smi), torch and CUDA;
2. build: every kernel of the port from ``alink_tpu_torch/csrc`` into
   ``build/kernels``;
3. kernel vs plain version on the card: ``flash_block_update`` against
   ``flash_block_update_ref`` at the serving shape (B=32, H=12, Q=512, K=128,
   D=64) in bf16 and fp32, with a fully masked batch row, a causal ``qk_ok``
   and a ragged K=100, each from an empty state (the first K/V block) and
   from a carried one (every later block); then ``blockwise_attention`` on
   the kernel route against its plain route (``ALINK_ATTN_PALLAS=0``) over
   all 4 blocks at (B, S, H, D) = (32, 512, 12, 64); timings beside the
   bound, and ``scaled_dot_product_attention`` over the whole 512-key
   attention as a labelled yardstick (the port never calls it);
4. main path: BERT-base at full width (hidden 768, 12 layers, 12 heads,
   vocab 30522, maxSeqLength 512, attentionBlockSize 128, mean pool, 2
   labels) with seeded random weights in the reference's flax layout (q/k
   weights drawn so that attention scores spread about one unit, so the
   logits depend on the attention), encoded with the port's codec into a
   model table, written to ``.ak``, read back, and served to 4 requests of
   1, 8, 32 and 64 rows through ``AkSourceBatchOp`` + ``TableSourceBatchOp``
   → ``BertTextClassifierPredictBatchOp`` → ``collect()``; the kernel's
   launch counter must rise by 48 per forward chunk, and the logits must
   agree with the same model run with plain attention and with full
   attention; the warm forward is timed on all three attention routes;
5. tree histogram vs plain version on the card: ``tree_histogram`` against
   ``histogram_ref`` at n = 522,911 rows of Covertype-layout bins (10
   continuous and 44 binary columns) at every S of a depth-12 tree's levels
   (64 … 131,072), with integer vals (the forest's g and its bootstrap
   counts) and normal vals, plus ids at -1 and in [S, S+8) at S = 64, 4,096
   and 131,072; each S timed beside its bound, the plain version and one
   ``index_add_`` over ``ids·d + f`` as a labelled yardstick (the port
   never calls it);
6. forest path: seeded Covertype-layout data (sklearn's
   bench_covertype.py shape: 522,911 training and 58,101 held-out rows, 54
   features, class 1 against the rest) through ``TableSourceBatchOp`` →
   ``RandomForestTrainBatchOp(numTrees=20, maxDepth=12, maxBins=64,
   minSamplesPerLeaf=5)`` → ``collect()``; the kernel's launch counter must
   rise by 3·12·20 = 720 (each launch timed with CUDA events), the first
   tree's 12 g histograms are held against the plain version again and
   timed on their own inputs (the numbers of the kernels line), the
   ``ALINK_GBDT_PALLAS=0`` route must grow identical trees, the card's
   predict must match a numpy traversal, and
   the model goes to ``.ak`` and back into ``RandomForestPredictBatchOp``
   for requests of 1, 1,000 and 58,101 held-out rows; held-out accuracy
   must beat the majority class by 0.05;
7. GBDT path: ``GbdtTrainBatchOp(numTrees=20, maxDepth=6, maxBins=64)`` on
   the same data, then ``GbdtPredictBatchOp`` on the held-out requests,
   under the same accuracy floor;
8. one JSON line of kernels, then the device line last.

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
taken over all keys: 2**-7·(|out| + out_abs) + (flip_o + |out|·flip_l)/l.
Served logits: max|Δ| ≤ 0.01 against the plain-attention route and against
full attention, about 4x the gaps measured on the card (see PERF.md).
Tree histogram: integer vals are summed exactly in any order (every
partial sum is an integer below 2**24), so kernel and plain version must
agree exactly; real vals within 2·count·2**-24·Σ|vals| per cell, the
worst-case fp32 error of a sum taken in any order, for both sides (count
and Σ|vals| from the plain version on ones and on |vals|).
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


def blockwise_mismatch(q, k, v, mask, got, block_size):
    """Holds ``blockwise_attention``'s output ``got`` from the kernel route
    against its plain route (``ALINK_ATTN_PALLAS=0``) on the same inputs.
    Returns the raw max |Δ| and the worst error over its bound (> 1 fails):
    fp32 atol 2e-5, bf16 as in the module docstring."""
    import torch

    from alink_tpu_torch.dl.attention import (ATTN_KERNEL_ENV,
                                              blockwise_attention)

    os.environ[ATTN_KERNEL_ENV] = "0"
    try:
        ref = blockwise_attention(q, k, v, mask, block_size=block_size)
        ref_abs = blockwise_attention(q, k, v.abs(), mask,
                                      block_size=block_size)
    finally:
        del os.environ[ATTN_KERNEL_ENV]
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


def block_bytes_flops(B, H, Q, K, D, itemsize):
    read = (B * H * Q * D + 2 * B * H * K * D) * itemsize + (B * K + Q * K) * 4 \
        + (B * H * Q * D + 2 * B * H * Q) * 4
    write = (B * H * Q * D + 2 * B * H * Q) * 4
    return read + write, 4.0 * B * H * Q * K * D


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

    # the whole 4-block loop: kernel route against the plain route
    B, Q, H, D = s["B"], s["Q"], s["H"], s["D"]
    for dt in (torch.bfloat16, torch.float32):
        q, k, v, mask = attn_inputs(B, Q, H, D, dt, SEED)
        got = blockwise_attention(q, k, v, mask, block_size=s["K"])
        err, worst = blockwise_mismatch(q, k, v, mask, got, s["K"])
        label = f"blockwise_attention kernel vs plain route {str(dt)[6:]}"
        print(f"{label} (B, S, H, D) = ({B}, {Q}, {H}, {D}), 4 blocks: "
              f"max|Δ| {err:.3g}; worst error/bound {worst:.3g}", flush=True)
        if not worst <= 1.0:
            fail(f"{label} outside its tolerance")
        results[label] = err

    # timings at the serving shape, bf16, kernel and plain in turns
    args = block_inputs(s["B"], s["H"], s["Q"], s["K"], s["D"],
                        torch.bfloat16, causal=False, fresh=False, seed=SEED)
    plain = lambda: flash_block_update_ref(*args, scale=scale)  # noqa: E731
    kern = lambda: flash_block_update(*args, scale=scale)  # noqa: E731
    t = [cuda_ms(plain), cuda_ms(kern), cuda_ms(kern), cuda_ms(plain)]
    plain_ms, kern_ms = (t[0] + t[3]) / 2, (t[1] + t[2]) / 2
    nbytes, flops = block_bytes_flops(**s, itemsize=2)
    bw, bf16_peak, _ = peaks
    bound_s = max(nbytes / bw, flops / bf16_peak)
    bound_by = "bytes" if nbytes / bw >= flops / bf16_peak else "operations"

    # yardstick: one library call for the whole 4-block attention
    B, H, Q, D = s["B"], s["H"], s["Q"], s["D"]
    g = torch.Generator(device="cuda").manual_seed(SEED)
    qf, kf, vf = (torch.randn((B, H, Q, D), generator=g, device="cuda",
                              dtype=torch.bfloat16) for _ in range(3))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_ms = cuda_ms(lambda: sdpa(qf, kf, vf))
    print(f"flash_block_update bf16 B=32 H=12 Q=512 K=128 D=64: kernel "
          f"{kern_ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
          f"{bound_s * 1e6:.1f} us ({bound_by}: {nbytes / 1e6:.1f} MB, "
          f"{flops / 1e9:.2f} GFLOP); turns plain,kernel,kernel,plain = "
          f"{[round(x, 4) for x in t]}", flush=True)
    print(f"yardstick: scaled_dot_product_attention over all 512 keys "
          f"(4 blocks) bf16 {lib_ms:.4f} ms; 4 kernel launches take "
          f"{4 * kern_ms:.4f} ms", flush=True)
    return dict(max_abs_err=max(results.values()), ms=kern_ms, plain_ms=plain_ms,
                bound_ms=bound_s * 1e3, bound_by=bound_by, library_ms=lib_ms,
                errors=results)


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
    from alink_tpu_torch.dl.attention import ATTN_KERNEL_ENV
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
    expect = chunks * cfg.num_layers * (512 // cfg.attention_block_size)
    if launches != expect:
        fail(f"flash_block_update launched {launches} times on the main path, "
             f"expected {expect} (48 per forward chunk)")
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

    def plain_route(fn, *a):
        os.environ[ATTN_KERNEL_ENV] = "0"
        try:
            return fn(*a)
        finally:
            del os.environ[ATTN_KERNEL_ENV]

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


def histogram_inputs(bins, level, seed, device="cuda", oob=False):
    """ids of one level of the forest's level program: seeded node ids of
    the level's 2**level nodes, ids = node·B + bin (B = 64) for Covertype-
    layout bins (n, 54); with ``oob``, 1 % of the ids set to -1 and 1 % to
    [S, S+8). Returns (ids int32, S, vals): vals maps "g" to the forest's
    integer g = -label·(bootstrap count), "count" to the counts, "normal" to
    standard-normal reals."""
    import torch

    g = np.random.default_rng(seed)
    n, _ = bins.shape
    S = 64 << level
    node = g.integers(0, 1 << level, n)
    ids = node[:, None] * 64 + bins
    if oob:
        r = g.random(ids.shape)
        ids = np.where(r < 0.01, -1, ids)
        ids = np.where(r > 0.99, S + g.integers(0, 8, ids.shape), ids)
    w = g.multinomial(n, np.ones(n) / n).astype(np.float32)
    label = g.integers(0, 2, n).astype(np.float32)
    vals = {"g": -(label * w), "count": w,
            "normal": g.standard_normal(n).astype(np.float32)}
    return (torch.tensor(ids, dtype=torch.int32, device=device), S,
            {k: torch.tensor(v, device=device) for k, v in vals.items()})


def histogram_mismatch(ids, vals, S, got, exact):
    """Holds a histogram ``got`` against ``histogram_ref`` on the same
    inputs. Returns (max|Δ|, worst error/bound; > 1 fails). Exact (integer
    vals): any difference fails. Real vals: |Δ| ≤ 2·count·2**-24·Σ|vals|
    per cell, count and Σ|vals| from the plain version on ones and |vals|
    (the worst-case fp32 error of a sum in any order, for both sides)."""
    import torch

    from alink_tpu_torch.tree.hist_cuda import histogram_ref

    ref = histogram_ref(ids, vals, num_segments=S)
    if got.shape != ref.shape or not bool(torch.isfinite(got).all()):
        return float("nan"), float("inf")
    err = (got - ref).abs()
    raw = float(err.max())
    if exact:
        return raw, 0.0 if raw == 0 else float("inf")
    count = histogram_ref(ids, torch.ones_like(vals), num_segments=S)
    size = histogram_ref(ids, vals.abs(), num_segments=S)
    return raw, worst_ratio(err, 2 * count * FP32_EPS * size)


def histogram_bytes(n, d, S):
    """Bytes the function must move: ids and vals read once, out written
    once."""
    return n * d * 4 + n * 4 + S * d * 4


def time_histogram(peaks, ids, vals, S, label):
    """Times ``tree_histogram`` on (ids, vals) in turns with its plain
    version, and one ``index_add_`` over ``ids·d + f`` as the yardstick;
    returns ms of each and the bound."""
    import torch

    from alink_tpu_torch.tree.hist_cuda import histogram, histogram_ref

    n, d = ids.shape
    bw, _, fp32_peak = peaks
    plain = lambda: histogram_ref(ids, vals, num_segments=S)  # noqa: E731
    kern = lambda: histogram(ids, vals, num_segments=S)  # noqa: E731
    flat = (ids.long() * d + torch.arange(d, device="cuda")).reshape(-1)
    vflat = vals[:, None].expand(n, d).reshape(-1)
    lib = lambda: torch.zeros(S * d, device="cuda").index_add_(  # noqa: E731
        0, flat, vflat)
    t = [cuda_ms(plain), cuda_ms(kern), cuda_ms(kern), cuda_ms(plain)]
    row = dict(ms=(t[1] + t[2]) / 2, plain_ms=(t[0] + t[3]) / 2,
               library_ms=cuda_ms(lib), bound_ms=max(
                   histogram_bytes(n, d, S) / bw, n * d / fp32_peak) * 1e3)
    print(f"tree_histogram {label} n={n} d={d} S={S}: kernel "
          f"{row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, index_add_ "
          f"yardstick {row['library_ms']:.4f} ms, bound "
          f"{row['bound_ms'] * 1e3:.1f} us (bytes: "
          f"{histogram_bytes(n, d, S) / 1e6:.1f} MB); turns "
          f"plain,kernel,kernel,plain = {[round(x, 4) for x in t]}",
          flush=True)
    return row


def check_histogram(peaks, bins):
    """Phase 5: ``tree_histogram`` against ``histogram_ref`` on the card at
    every level of a depth-12 tree (S = 64 … 131,072) with seeded node ids
    spread evenly over the level's nodes, then timed there. Returns the
    raw errors and the timings by S."""
    from alink_tpu_torch.tree.hist_cuda import histogram

    by_segments, errors = {}, {}
    for level in range(FOREST["maxDepth"]):
        ids, S, vals = histogram_inputs(bins, level, SEED + level)
        cases = [(k, ids, v) for k, v in vals.items()]
        if S in (64, 4096, 131072):
            oids, _, ovals = histogram_inputs(bins, level, SEED + 100 + level,
                                              oob=True)
            cases += [("oob " + k, oids, ovals[k]) for k in ("g", "normal")]
        for kind, i_, v in cases:
            exact = not kind.endswith("normal")
            raw, ratio = histogram_mismatch(i_, v, S, histogram(
                i_, v, num_segments=S), exact)
            print(f"tree_histogram vs plain [S={S} {kind}] max|Δ| {raw:.3g}; "
                  f"{'exact' if exact else 'error/bound'} {ratio:.3g}",
                  flush=True)
            if not ratio <= 1.0:
                fail(f"tree_histogram [S={S} {kind}] outside its tolerance")
            errors[f"S={S} {kind}"] = raw
        by_segments[S] = time_histogram(peaks, ids, vals["g"], S,
                                        "even nodes")
    return errors, by_segments


def main_path_histograms(peaks, kept):
    """The forest's first tree, level by level: its g histograms' inputs as
    the main path made them (``kept``), held against the plain version
    (exact: integer vals) and timed. Returns the means over the levels, the
    raw errors and the timings by S."""
    from alink_tpu_torch.tree.hist_cuda import histogram

    rows, errors = {}, {}
    for ids, vals, S in kept:
        raw, ratio = histogram_mismatch(ids, vals, S, histogram(
            ids, vals, num_segments=S), exact=True)
        if not ratio <= 1.0:
            fail(f"tree_histogram on the forest's level S={S}: max|Δ| {raw}")
        errors[f"forest level S={S} g"] = raw
        rows[S] = time_histogram(peaks, ids, vals, S, "forest tree 1")
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
    """Wraps ``grow._level`` and ``grow.histogram`` so that each call
    records CUDA events, and keeps the first tree's g-histogram inputs.
    Returns (levels, launches, kept, restore): (level, start, end) per
    level call, (start, end) per histogram launch, (ids, vals, S) per
    level of the first tree, and the hook that undoes the wrapping."""
    import torch

    orig_level, orig_hist = grow._level, grow.histogram
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

    def hist(ids, vals, *, num_segments):
        a, b = events()
        a.record()
        out = orig_hist(ids, vals, num_segments=num_segments)
        b.record()
        if len(launches) % 3 == 0 and len(kept) < FOREST["maxDepth"]:
            kept.append((ids, vals, num_segments))    # g: first of three
        launches.append((a, b))
        return out

    def restore():
        grow._level, grow.histogram = orig_level, orig_hist

    grow._level, grow.histogram = level, hist
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
    Returns the main path's tree_histogram launches, the mean device ms of
    a launch there, and the kernel's timings on the first tree's inputs."""
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
    expect = 3 * FOREST["maxDepth"] * FOREST["numTrees"]
    depth = FOREST["maxDepth"]
    first, rest = [0.0] * depth, [0.0] * depth
    for i, (lv, a, b) in enumerate(levels):
        (first if i < depth else rest)[lv] += a.elapsed_time(b)
    launch_ms = [a.elapsed_time(b) for a, b in launch_ev]
    print(f"forest train ({n_tr} rows, {FOREST}): {wall:.2f} s wall; "
          f"{launches} tree_histogram launches, {sum(launch_ms):.1f} ms of "
          f"device time in them (mean {np.mean(launch_ms):.4f} ms); peak "
          f"device memory {peak / 2**30:.2f} GiB; level program device ms "
          f"by level, first tree {[round(t, 2) for t in first]}, mean of "
          f"the other {FOREST['numTrees'] - 1} "
          f"{[round(t / (FOREST['numTrees'] - 1), 3) for t in rest]}; all "
          f"levels of all trees {sum(first) + sum(rest):.1f} ms",
          flush=True)
    if launches != expect:
        fail(f"tree_histogram launched {launches} times on the forest path, "
             f"expected {expect} (3 per level)")
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
    return launches, float(np.mean(launch_ms)), stats


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

    stats = check_kernel(peaks)
    workdir = os.path.join(here, "build", "chip_smoke")
    os.makedirs(workdir, exist_ok=True)
    launches = main_path(workdir, serving_config())

    from alink_tpu_torch.tree.binning import apply_bins, quantile_bins

    t0 = time.perf_counter()
    X, y = covertype_data(COVTYPE_TRAIN + COVTYPE_TEST, SEED)
    bins = apply_bins(X[:COVTYPE_TRAIN], quantile_bins(X[:COVTYPE_TRAIN], 64))
    print(f"Covertype-layout data: {X.shape[0]} rows x {X.shape[1]} features "
          f"from seed {SEED}, label 1 in {y.mean():.3f} of rows; binned in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    errors, even = check_histogram(peaks, bins)
    del bins
    tree_launches, launch_ms, (hist, forest_errors, levels) = forest_path(
        workdir, X, y, peaks)
    errors.update(forest_errors)
    hist.update(errors=errors, max_abs_err=max(errors.values()),
                bound_by="bytes")
    gbdt_path(X, y)

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
        entry("flash_block_update", launches, stats,
              "scaled_dot_product_attention, all 4 K/V blocks",
              "B=32 H=12 Q=512 K=128 D=64 bf16"),
        dict(entry("tree_histogram", tree_launches, hist,
                   "Tensor.index_add_ over ids*d+f (yardstick)",
                   f"n={COVTYPE_TRAIN} d=54 int32 ids, fp32 vals; ms, "
                   f"plain_ms, library_ms and bound_ms are means over the "
                   f"12 levels (S = 64 ... 131072) of the forest's first "
                   f"tree, on its g histograms' inputs"),
             main_path_launch_ms=launch_ms, forest_levels=levels,
             even_nodes=even)]}
    print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)
    print(card)
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
