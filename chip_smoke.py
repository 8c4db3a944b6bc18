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
5. one JSON line of kernels, then the device line last.

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
"""

from __future__ import annotations

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

    spec = kernels.KERNELS["flash_block_update"]
    line = {"kernels": [{
        "name": spec.name, "route": spec.route,
        "source": "alink_tpu_torch/" + spec.source,
        "replaces": spec.replaces, "launches": launches,
        "max_abs_err": stats["max_abs_err"], "ms": stats["ms"],
        "plain_ms": stats["plain_ms"], "bound_ms": stats["bound_ms"],
        "bound_us": stats["bound_ms"] * 1e3, "bound_by": stats["bound_by"],
        "library_ms": stats["library_ms"],
        "library_call": "scaled_dot_product_attention, all 4 K/V blocks",
        "shape": "B=32 H=12 Q=512 K=128 D=64 bf16",
        "errors": stats["errors"]}]}
    print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)
    print(card)
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
