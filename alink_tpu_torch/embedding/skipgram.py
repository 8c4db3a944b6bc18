"""Skip-gram with negative sampling (SGNS), the huge-embedding trainer (port
of ``alink_tpu.embedding.skipgram``).

(reference: huge/impl/Word2VecImpl.java:82-91 driving ApsEnv
pull→train→push; word2vec's original C algorithm.)

Two engines, one contract (``ALINK_HUGE_ENGINE``, see ``engine.py``):

- **host** (:func:`train_skipgram`): replicated tables, updates through
  :func:`~alink_tpu_torch.parallel.aps.apply_gathered_replicated`;
- **sharded** (:func:`train_skipgram_sharded`): tables row-sharded over
  the ``model`` ranks; per step one launch of the ``sgns_block_grads``
  kernel PULLs the rows a block touches (hot rows from the cache replica)
  and computes the block's gradients, and the updates are PUSHed back.

The step loop is a Python loop over torch ops on the device; it never
waits on the host (the cache's hit count stays on the device until the
call ends). Vocabulary, pairs, shuffle and the initial tables are the
reference's numpy code, so they match it bit for bit. Both engines run the
same per-row update sequence, so on the CPU they are bit-identical at equal
seed. On the card ``index_add_`` combines a batch's duplicate ids in any
order, so runs agree within a tolerance, not bit for bit.

Negatives come from a ``torch.Generator`` seeded from the seed and the step
(``searchsorted`` on the unigram^0.75 CDF for SGNS, uniform for LINE).
JAX's threefry stream cannot be reproduced, so the draws differ from the
reference's by design; the trainers take ``negatives=`` (steps, B, negs) to
replay a given stream, which is how the tests hold them to the reference.
"""

from __future__ import annotations

import collections
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..common.env import resolve_device
from ..parallel.mesh import AXIS_DATA, AXIS_MODEL, axis_size
from .sgns_cuda import (sgns_block_grads_ref, sgns_pull_grads,
                        sgns_pull_grads_ref, use_sgns_kernel)


@dataclass
class SkipGramConfig:
    dim: int = 100
    window: int = 5
    negatives: int = 5
    epochs: int = 3
    batch_size: int = 1024
    learning_rate: float = 0.025
    min_count: int = 1
    subsample: float = 1e-3  # frequent-word subsampling threshold; 0 = off
    seed: int = 0


def build_vocab(
    docs: Sequence[Sequence[str]], min_count: int = 1
) -> Tuple[Dict[str, int], np.ndarray]:
    """Returns (word -> id, counts array), most frequent first."""
    counter = collections.Counter()
    for doc in docs:
        counter.update(doc)
    items = [(w, c) for w, c in counter.most_common() if c >= min_count]
    vocab = {w: i for i, (w, _) in enumerate(items)}
    counts = np.asarray([c for _, c in items], np.float64)
    return vocab, counts


def make_pairs(
    docs: Sequence[Sequence[str]],
    vocab: Dict[str, int],
    counts: np.ndarray,
    window: int,
    subsample: float,
    seed: int,
) -> np.ndarray:
    """(P, 2) int32 center/context pairs with dynamic windows and
    frequent-word subsampling (the word2vec recipe)."""
    rng = np.random.default_rng(seed)
    total = counts.sum()
    if subsample > 0:
        freq = counts / total
        keep = np.minimum(1.0, np.sqrt(subsample / np.maximum(freq, 1e-12))
                          + subsample / np.maximum(freq, 1e-12))
    else:
        keep = np.ones_like(counts)
    pairs: List[Tuple[int, int]] = []
    for doc in docs:
        ids = [vocab[w] for w in doc if w in vocab]
        ids = [i for i in ids if rng.random() < keep[i]]
        L = len(ids)
        for pos, c in enumerate(ids):
            r = int(rng.integers(1, window + 1))
            for off in range(-r, r + 1):
                j = pos + off
                if off != 0 and 0 <= j < L:
                    pairs.append((c, ids[j]))
    if not pairs:
        return np.zeros((0, 2), np.int32)
    return np.asarray(pairs, np.int32)


# ---------------------------------------------------------------------------
# shared engine pieces: both engines run exactly this arithmetic
# ---------------------------------------------------------------------------


def _unigram75_logits(counts: np.ndarray) -> np.ndarray:
    """unigram^0.75 negative-sampling distribution (word2vec standard)."""
    probs = np.asarray(counts, np.float64) ** 0.75
    return np.log(probs / probs.sum()).astype(np.float32)


def _fresh_init(seed: int, V: int, D: int) -> np.ndarray:
    """The input-table init: byte for byte what ``ShardedEmbedding``'s
    default init draws, so both engines start from identical tables."""
    rng = np.random.default_rng(seed)
    return ((rng.random((V, D)) - 0.5) / D).astype(np.float32)


def _prep_pairs(pairs: np.ndarray, batch: int, ndev: int,
                seed: int) -> Tuple[np.ndarray, int]:
    """Shuffle once; cyclically pad so blocks divide evenly over
    (devices × batch). Identical for both engines."""
    rng = np.random.default_rng(seed)
    pairs = pairs[rng.permutation(pairs.shape[0])]
    block = batch * ndev
    n_blocks = max(1, pairs.shape[0] // block)
    return np.resize(pairs, (n_blocks * block, 2)), n_blocks


def _step_scales(lr0: float, steps: int, num_ranks: int) -> np.ndarray:
    """Per-step update scale ``lr / M`` with the reference's fp32 rounding:
    ``lr = lr0·max(1e-4, 1 − float32(s)/steps)``, every operation in fp32.
    Each value is exact in fp32, so multiplying an fp32 tensor by it rounds
    once, as the reference's fp32 product does."""
    s = np.arange(steps, dtype=np.float32)
    lr = np.float32(lr0) * np.maximum(
        np.float32(1e-4), np.float32(1.0) - s / np.float32(steps))
    return lr / np.float32(num_ranks)


def _negative_stream(seed: int, B: int, negs: int, neg_logits, neg_v: int,
                     device, negatives=None) -> Callable[[int], torch.Tensor]:
    """``draw(s)``: step ``s``'s (B, negs) int64 negatives on ``device``.
    SGNS (``neg_logits`` given): ``searchsorted`` of fp64 uniforms on the
    unigram^0.75 CDF; LINE: uniform over ``neg_v``. The generator is
    re-seeded from (seed, s) at each step, so a step's draws do not depend
    on the steps before it. ``negatives`` (steps, B, negs) replaces the
    draws (tests replay the reference's stream with it)."""
    if negatives is not None:
        table = torch.as_tensor(np.array(negatives), dtype=torch.int64,
                                device=device)
        return lambda s: table[s]
    gen = torch.Generator(device=device)
    base = (int(seed) << 32) & 0xFFFFFFFFFFFFFFFF
    if neg_logits is None:
        def draw(s):
            gen.manual_seed(base + s)
            return torch.randint(0, neg_v, (B, negs), generator=gen,
                                 device=device)
        return draw
    p = np.exp(np.asarray(neg_logits, np.float64))
    cdf = np.cumsum(p)
    cdf = torch.as_tensor(cdf / cdf[-1], device=device)
    last = len(p) - 1

    def draw(s):
        gen.manual_seed(base + s)
        u = torch.rand((B, negs), generator=gen, dtype=torch.float64,
                       device=device)
        return torch.searchsorted(cdf, u, right=True).clamp_(max=last)
    return draw


def _pair_columns(pairs: np.ndarray, device):
    """Center and context columns as contiguous int64 tensors on
    ``device`` (a block is then a view of each)."""
    t = torch.as_tensor(np.ascontiguousarray(pairs.T), dtype=torch.int64,
                        device=device)
    return t[0], t[1]


# ---------------------------------------------------------------------------
# engine drivers
# ---------------------------------------------------------------------------


def _run_pairs_host(pairs, V, D, B, negs, steps, n_blocks, lr0, seed, *,
                    tie=False, neg_logits=None, neg_v=0, device=None,
                    negatives=None) -> np.ndarray:
    """Host engine: replicated tables, gathered scatter-add updates."""
    from ..parallel.aps import apply_gathered_replicated

    dev = resolve_device(device)
    axis = AXIS_DATA
    scales = _step_scales(lr0, steps, axis_size(axis))
    w_in = torch.as_tensor(_fresh_init(seed, V, D), device=dev)
    w_out = torch.zeros((V, D), dtype=torch.float32, device=dev)
    centers, ctxs = _pair_columns(pairs, dev)
    draw = _negative_stream(seed, B, negs, neg_logits, neg_v, dev, negatives)
    for s in range(steps):
        b = s % n_blocks
        center, ctx = centers[b * B:(b + 1) * B], ctxs[b * B:(b + 1) * B]
        neg = draw(s)
        w_ctx = w_in if tie else w_out
        v = w_in[center]                       # "pull" = local gather
        grad_v, grad_u = sgns_block_grads_ref(v, w_ctx[ctx], w_ctx[neg])
        uids = torch.cat([ctx, neg.reshape(-1)])
        scale = float(scales[s])
        apply_gathered_replicated(w_in, center, grad_v, axis, V, scale)
        apply_gathered_replicated(w_ctx, uids, grad_u, axis, V, scale)
    return np.array(w_in.cpu())


def _run_pairs_sharded(pairs, V, D, B, negs, steps, n_blocks, lr0, seed, *,
                       tie=False, neg_logits=None, neg_v=0, device=None,
                       hot_rows=None, negatives=None, probs=None):
    """Sharded engine: per step one ``sgns_pull_grads`` (the pull, through
    the hot cache when ``hot > 0``, and the gradients), then the pushes.
    Returns the input table's handle. ``probs`` (the ids' empirical
    distribution) only sizes the multi-rank exchange's buckets in the
    reference (``cold_capacity``); one rank has no exchange, so it is
    accepted and unused (ROADMAP A3)."""
    from ..parallel.aps import ShardedEmbedding, push
    from ..parallel.hotcache import (note_cache_dropped, note_cache_traffic,
                                     refresh_hot, refresh_hot_many,
                                     resolve_hot_rows)

    dev = resolve_device(device)
    axis = AXIS_MODEL
    M = axis_size(axis)
    w_in = ShardedEmbedding(V, D, seed=seed, device=dev)
    w_out = ShardedEmbedding(
        V, D, init=lambda r: np.zeros((V, D), np.float32), seed=seed,
        device=dev)
    rows = w_in.rows_per_shard

    hot = resolve_hot_rows(hot_rows, V, rows)
    fused = use_sgns_kernel() and negs >= 1
    grads = sgns_pull_grads if fused else sgns_pull_grads_ref
    scales = _step_scales(lr0, steps, M)
    centers, ctxs = _pair_columns(pairs, dev)
    draw = _negative_stream(seed, B, negs, neg_logits, neg_v, dev, negatives)

    win, wout = w_in.array, w_out.array
    w_ctx = win if tie else wout

    def refresh():
        if tie:
            rep = refresh_hot(win, axis, hot)
            return rep, rep
        return refresh_hot_many((win, wout), axis, hot)

    rep_in = rep_ctx = hits = None
    if hot > 0:
        hits = torch.zeros((), dtype=torch.int64, device=dev)
        rep_in, rep_ctx = refresh()
    for s in range(steps):
        b = s % n_blocks
        center, ctx = centers[b * B:(b + 1) * B], ctxs[b * B:(b + 1) * B]
        uids = torch.cat([ctx, draw(s).reshape(-1)])
        grad_v, grad_u = grads(win, w_ctx, center, uids, negs=negs,
                               rows=rows, hot=hot, rep_in=rep_in,
                               rep_ctx=rep_ctx, hits=hits)

        scale = float(scales[s])
        push(win, center, grad_v, axis, rows, scale)
        push(w_ctx, uids, grad_u, axis, rows, scale)
        if hot > 0:
            rep_in, rep_ctx = refresh()
    if hot > 0:
        pulled = steps * B * (2 + negs)    # per rank: center + ctx + negs
        note_cache_traffic(int(hits), M * pulled)   # the call's one sync
        note_cache_dropped(hot)
    return w_in


def train_skipgram(
    pairs: np.ndarray,
    vocab_size: int,
    counts: np.ndarray,
    cfg: SkipGramConfig,
    *,
    device=None,
    negatives: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Train SGNS on the host engine (replicated tables); returns the input
    embedding matrix (V, dim) fp32. Bit-identical to the sharded engine on
    the CPU at equal seed (see the module docstring). ``negatives``: the
    tests' replay of a given negative stream, (steps, B, negs)."""
    V, D = vocab_size, cfg.dim
    if pairs.shape[0] == 0:
        resolve_device(device)
        return _fresh_init(cfg.seed, V, D)
    pairs, n_blocks = _prep_pairs(pairs, cfg.batch_size,
                                  axis_size(AXIS_DATA), cfg.seed)
    return _run_pairs_host(
        pairs, V, D, cfg.batch_size, cfg.negatives,
        n_blocks * cfg.epochs, n_blocks, cfg.learning_rate, cfg.seed,
        neg_logits=_unigram75_logits(counts), device=device,
        negatives=negatives)


def train_skipgram_sharded(
    pairs: np.ndarray,
    vocab_size: int,
    counts: np.ndarray,
    cfg: SkipGramConfig,
    *,
    device=None,
    hot_rows: Optional[int] = None,
    negatives: Optional[np.ndarray] = None,
):
    """SGNS with both embedding tables sharded over the ``model`` ranks,
    the APS path (reference: huge/impl/Word2VecImpl.java:82-91).

    Per step one ``sgns_block_grads`` launch PULLs the rows of the block
    (hot rows from the cache replica, ``hot_rows``/``ALINK_APS_HOT_ROWS``)
    and computes the gradients, and they are PUSHed back. Returns the trained
    input-embedding ``ShardedEmbedding``; ``.to_numpy()`` materialises it.
    ``negatives``: the tests' replay of a given negative stream."""
    from ..parallel.aps import ShardedEmbedding

    V, D = vocab_size, cfg.dim
    if pairs.shape[0] == 0:
        return ShardedEmbedding(V, D, seed=cfg.seed, device=device)
    pairs, n_blocks = _prep_pairs(pairs, cfg.batch_size,
                                  axis_size(AXIS_MODEL), cfg.seed)
    return _run_pairs_sharded(
        pairs, V, D, cfg.batch_size, cfg.negatives,
        n_blocks * cfg.epochs, n_blocks, cfg.learning_rate, cfg.seed,
        neg_logits=_unigram75_logits(counts), device=device,
        hot_rows=hot_rows, negatives=negatives)
