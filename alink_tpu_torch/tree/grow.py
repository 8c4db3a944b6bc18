"""Level-wise histogram tree growth + GBDT / RandomForest training loops
(port of ``alink_tpu/tree/grow.py``).

(reference: operator/common/tree/parallelcart/BaseGbdtTrainBatchOp.java:408 —
the boosting ICQ program; ConstructLocalHistogram.java — per-worker histogram;
CalcFeatureGain.java — split search; BaseRandomForestTrainBatchOp.java:221 —
forest BSP.)

Trees are perfect binary trees of fixed depth: internal nodes in heap layout
(2^D - 1), leaves 2^D. A node that does not split stores feature -1 — its
samples route left and both children inherit its statistics.

- The forest (:func:`train_forest`) grows each tree level by level with
  :func:`_level`: three histograms (g, h, counts) over ``node·B + bin`` by
  :func:`~alink_tpu_torch.tree.hist_cuda.histogram` — the hand-written CUDA
  kernel on the card — then the split search and the routing of every
  sample. The level's splits come to the host after each level, as in the
  reference. With one card the reference's ``psum`` over the data axis is
  the identity, so rows are neither sharded nor padded.
  ``ALINK_GBDT_PALLAS=0`` (the reference's knob) routes the level program to
  the plain version :func:`~alink_tpu_torch.tree.hist_cuda.histogram_ref`,
  for debugging only.
- GBDT (:func:`train_gbdt`) computes its histograms, as the reference does,
  as products of the bf16-rounded (3L, rows) value matrix with the bins'
  one-hot, accumulated in fp32 — plain ``torch.matmul``, no kernel of its
  own. The reference's one fused program becomes Python loops over torch
  ops.
- The binning is the reference's host numpy, so bins and thresholds are the
  reference's exactly.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..common.env import kernel_knob_on, resolve_device
from ..common.exceptions import AkIllegalArgumentException
from .binning import apply_bins, quantile_bins
from .hist_cuda import histogram, histogram_ref

HIST_KERNEL_ENV = "ALINK_GBDT_PALLAS"


# ---------------------------------------------------------------------------
# per-level split program
# ---------------------------------------------------------------------------


def _split_search(hg, hh, hc, fmask, l2, min_samples, min_gain):
    """Histograms (L, d, B) -> (feat (L,), thr (L,)) int32. THE split
    contract: cumsum left/right gains, min-child-count + last-bin masks, flat
    argmax (the first of equal gains); feat -1 = no split. Shared by the
    forest's level program and GBDT."""
    L, d, B = hg.shape
    GL = torch.cumsum(hg, dim=-1)
    HL = torch.cumsum(hh, dim=-1)
    CL = torch.cumsum(hc, dim=-1)
    G, H, C = GL[..., -1:], HL[..., -1:], CL[..., -1:]
    GR, HR, CR = G - GL, H - HL, C - CL
    gain = (GL * GL / (HL + l2) + GR * GR / (HR + l2) - G * G / (H + l2))
    ok = (CL >= min_samples) & (CR >= min_samples)
    # last bin position means "everything left" — not a split
    ok = ok & (torch.arange(B, device=hg.device) < B - 1)[None, None, :]
    gain = torch.where(ok & (fmask[None, :, None] > 0), gain, -torch.inf)
    flat = gain.reshape(L, d * B)
    best = torch.argmax(flat, dim=1)
    best_gain = flat.gather(1, best[:, None])[:, 0]
    split = best_gain > min_gain
    feat = torch.where(split, best // B, -1).to(torch.int32)
    thr = torch.where(split, best % B, B - 1).to(torch.int32)
    return feat, thr


def _route(bins, node, feat, thr):
    """Send each sample to its child: f<0 routes left (no split).
    bins (n, d) int32, node (n,) int32 -> (n,) int32."""
    idx = node.long()
    f_s = feat[idx]
    t_s = thr[idx]
    x_bin = bins.gather(1, f_s.clamp_min(0).long()[:, None])[:, 0]
    go_left = (f_s < 0) | (x_bin <= t_s)
    return node * 2 + (~go_left).to(torch.int32)


def _level(bins, g, h, c, node, fmask, num_nodes: int, num_bins: int,
           l2: float, min_samples: float, min_gain: float):
    """One level of one tree: histograms of g, h and c over
    ``node·B + bin``, split search, routing. bins (n, d) uint8 or int32;
    g, h, c (n,) fp32; node (n,) int32. Returns (feat, thr, node)."""
    L, B = num_nodes, num_bins
    bins = bins.to(torch.int32)  # staged as uint8 (_compact_bins)
    d = bins.shape[1]
    ids = node[:, None] * B + bins  # (n, d) in [0, L*B)
    hist = histogram if kernel_knob_on(HIST_KERNEL_ENV) else histogram_ref

    def seg(vals):  # (L*B, d) -> (L, d, B)
        return hist(ids, vals, num_segments=L * B).view(L, B, d) \
            .permute(0, 2, 1)

    hg, hh, hc = seg(g), seg(h), seg(c)
    feat, thr = _split_search(hg, hh, hc, fmask, l2, min_samples, min_gain)
    return feat, thr, _route(bins, node, feat, thr)


def _leaf_values(g, h, node, num_leaves: int, l2: float):
    """-Σg / (Σh + l2) per leaf, the sums as ``index_add_``."""
    sg = torch.zeros(num_leaves, dtype=torch.float32, device=g.device) \
        .index_add_(0, node, g)
    sh = torch.zeros(num_leaves, dtype=torch.float32, device=g.device) \
        .index_add_(0, node, h)
    return -sg / (sh + l2)


def predict_raw(X, feats, thrs, leaves, base_score, depth: int):
    """(n, K) raw scores: every tree's leaf value summed, plus the base.

    All arguments are tensors on one device: X (n, d) fp32; feats (T,
    2^D - 1) int; thrs (T, 2^D - 1) fp32 raw thresholds (x <= thr goes
    left); leaves (T, K, 2^D); base_score (K,). The trees walk in parallel,
    one gather per level."""
    T, n = feats.shape[0], X.shape[0]
    K = leaves.shape[1]
    feats = feats.long()
    node = torch.zeros((T, n), dtype=torch.long, device=X.device)
    pos = torch.zeros((T, n), dtype=torch.long, device=X.device)
    for _ in range(depth):
        fs = feats.gather(1, pos)
        ts = thrs.gather(1, pos)
        x = X.gather(1, fs.clamp_min(0).T).T  # x[t, i] = X[i, fs[t, i]]
        right = (~((fs < 0) | (x <= ts))).long()
        node = node * 2 + right
        pos = 2 * pos + 1 + right
    scores = leaves.gather(2, node[:, None, :].expand(T, K, n))  # (T, K, n)
    return scores.sum(0).T + base_score[None, :]


# ---------------------------------------------------------------------------
# ensemble container
# ---------------------------------------------------------------------------


@dataclass
class TreeEnsemble:
    """Perfect-depth trees in heap layout. feats/thrs: (T, 2^D - 1);
    leaves: (T, K, 2^D) — K output dims (1 for binary/regression)."""

    depth: int
    feats: np.ndarray
    thrs: np.ndarray  # raw-value thresholds (x <= thr goes left)
    leaves: np.ndarray
    base_score: np.ndarray  # (K,)
    task: str  # "regression" | "binary" | "multiclass"
    labels: Optional[list] = None
    feature_cols: Optional[list] = None
    vector_col: Optional[str] = None
    _staged: Optional[tuple] = field(default=None, init=False, repr=False,
                                     compare=False)

    def raw_predict(self, X: np.ndarray, device=None) -> np.ndarray:
        """(n, K) raw scores — sum of leaf values + base, in fp32 on
        ``device`` (default: see
        :func:`~alink_tpu_torch.common.env.resolve_device`). The tree arrays
        are staged on the device once per ensemble."""
        dev = resolve_device(device)
        if self._staged is None or self._staged[0] != dev:
            self._staged = (dev, tuple(
                torch.as_tensor(np.asarray(a), device=dev) for a in (
                    self.feats, self.thrs, self.leaves, self.base_score)))
        Xt = torch.as_tensor(np.asarray(X, np.float32), device=dev)
        with torch.inference_mode():
            out = predict_raw(Xt, *self._staged[1], depth=self.depth)
        return out.cpu().numpy()

    def to_arrays(self) -> Dict[str, np.ndarray]:
        return {
            "feats": self.feats,
            "thrs": self.thrs,
            "leaves": self.leaves,
            "base_score": self.base_score,
        }

    @staticmethod
    def from_arrays(meta: dict, arrays: Dict[str, np.ndarray]) -> "TreeEnsemble":
        return TreeEnsemble(
            depth=int(meta["depth"]),
            feats=np.asarray(arrays["feats"], np.int32),
            thrs=np.asarray(arrays["thrs"], np.float32),
            leaves=np.asarray(arrays["leaves"], np.float32),
            base_score=np.asarray(arrays["base_score"], np.float32),
            task=meta["task"],
            labels=meta.get("labels"),
            feature_cols=meta.get("featureCols"),
            vector_col=meta.get("vectorCol"),
        )


# ---------------------------------------------------------------------------
# single-tree growth (forest)
# ---------------------------------------------------------------------------


_MAX_DEPTH = 14  # 2^D heap nodes x num_bins histogram rows: beyond this the
# static perfect-depth layout (L*B segment space) outgrows device memory


def _check_depth(depth: int):
    if depth > _MAX_DEPTH:
        raise AkIllegalArgumentException(
            f"tree depth {depth} > {_MAX_DEPTH}: the perfect-depth heap "
            f"layout allocates 2^depth x num_bins histogram slots; use more "
            f"trees instead of deeper ones")


def _grow_tree(bins, g, h, c, edges, depth, num_bins, l2, min_samples,
               min_gain, fmask) -> Tuple[np.ndarray, np.ndarray, torch.Tensor]:
    """Grow one tree; returns (feat_heap (2^D-1,), thr_heap raw (2^D-1,),
    the final leaf of every sample as an (n,) int32 device tensor)."""
    node = torch.zeros(bins.shape[0], dtype=torch.int32, device=bins.device)
    feat_heap = np.full(2 ** depth - 1, -1, np.int32)
    thr_heap = np.zeros(2 ** depth - 1, np.float32)
    fmask_t = torch.as_tensor(fmask, dtype=torch.float32, device=bins.device)

    for level in range(depth):
        L = 2 ** level
        feat, thr, node = _level(bins, g, h, c, node, fmask_t, L, num_bins,
                                 float(l2), float(min_samples),
                                 float(min_gain))
        feat = feat.cpu().numpy()
        thr = thr.cpu().numpy()
        base = 2 ** level - 1
        feat_heap[base:base + L] = feat
        thr_heap[base:base + L] = _bins_to_thresholds(edges, feat, thr)
    return feat_heap, thr_heap, node


def _bins_to_thresholds(edges: np.ndarray, feat: np.ndarray,
                        thr: np.ndarray) -> np.ndarray:
    """bin index -> raw threshold; edges[f, t] is the UPPER boundary of bin
    t, and a non-splitting node (feat < 0) gets +inf so everything routes
    left. The one place encoding this contract (GBDT + forest)."""
    return np.where(
        feat >= 0,
        edges[np.maximum(feat, 0), np.minimum(thr, edges.shape[1] - 1)],
        np.inf)


def _compact_bins(bins: np.ndarray, num_bins: int) -> np.ndarray:
    """uint8 the bins when codes fit (4x less to stage); every consumer
    widens back to int32."""
    if num_bins <= 256:
        return bins.astype(np.uint8)
    return bins


def _pad_rows(arr, multiple):
    n = arr.shape[0]
    pad = (-n) % multiple
    if pad:
        pad_width = [(0, pad)] + [(0, 0)] * (arr.ndim - 1)
        arr = np.pad(arr, pad_width)
    return arr


# ---------------------------------------------------------------------------
# GBDT
# ---------------------------------------------------------------------------


# one-hot histogram operand budget (elements): above this the row chunks
# stream through the matmul instead of holding the whole (n, d*B) one-hot
_HIST_ONEHOT_BUDGET_ELEMS = 128 * 1024 * 1024


def _onehot_bins(b, num_bins: int):
    """(c, d) int bins -> (c, d*B) fp32 one-hot (exact)."""
    c, d = b.shape
    return (b[:, :, None] == torch.arange(num_bins, device=b.device)
            ).to(torch.float32).reshape(c, d * num_bins)


def _bf16(x):
    """x rounded to bf16, held in fp32."""
    return x.to(torch.bfloat16).to(torch.float32)


def _vmat(node, g, h, w, L):
    """(3L, c) value matrix: one-hot node × bf16-rounded g, h and w."""
    N = (node[:, None] == torch.arange(L, device=node.device)[None, :]
         ).to(torch.float32)
    return torch.cat([N * _bf16(g)[:, None], N * _bf16(h)[:, None],
                      N * _bf16(w)[:, None]], dim=1).T


def _gbdt_hists(bins, node, g, h, w, L, num_bins, num_chunks, onehot):
    """(g, h, count) histograms (L, d, B) as products of the bf16-rounded
    value matrix with the bins' one-hot, fp32 accumulation, over
    ``num_chunks`` row chunks (``onehot`` holds the whole one-hot when
    there is one chunk)."""
    n, d = bins.shape
    if num_chunks == 1:
        hist = torch.matmul(_vmat(node, g, h, w, L), onehot)
    else:
        chunk = n // num_chunks
        hist = torch.zeros((3 * L, d * num_bins), dtype=torch.float32,
                           device=bins.device)
        for i in range(num_chunks):
            s = slice(i * chunk, (i + 1) * chunk)
            hist += torch.matmul(_vmat(node[s], g[s], h[s], w[s], L),
                                 _onehot_bins(bins[s], num_bins))
    hist = hist.reshape(3, L, d, num_bins)
    return hist[0], hist[1], hist[2]


def _gbdt_run(bins, y_enc, valid, base, *, task, num_trees, depth, num_bins,
              K, hp, num_chunks, generator):
    """The boosting run on one device; returns the (num_trees, K, ·) heaps
    of split features and bin thresholds, and the leaf values."""
    lr, l2, min_samples, min_gain, subsample, colsample = hp
    dev = bins.device
    n, d = bins.shape
    B = num_bins
    HEAP, LEAF = 2 ** depth - 1, 2 ** depth
    F = base[None, :].repeat(n, 1)
    feats = torch.full((num_trees, K, HEAP), -1, dtype=torch.int32,
                       device=dev)
    thrs = torch.full((num_trees, K, HEAP), B - 1, dtype=torch.int32,
                      device=dev)
    leaves = torch.zeros((num_trees, K, LEAF), dtype=torch.float32,
                         device=dev)
    onehot = _onehot_bins(bins, B) if num_chunks == 1 else None
    leaf_ids = torch.arange(LEAF, device=dev)

    for it in range(num_trees):
        if task == "regression":
            g_all = F - y_enc
            h_all = torch.ones_like(F)
        else:
            p = torch.sigmoid(F) if task == "binary" \
                else torch.softmax(F, dim=1)
            g_all = p - y_enc
            h_all = torch.clamp_min(p * (1 - p), 1e-6)

        if subsample < 1.0:
            w = valid * torch.bernoulli(
                torch.full((n,), subsample, device=dev), generator=generator)
        else:
            w = valid
        if colsample < 1.0:
            fmask = torch.bernoulli(torch.full((d,), colsample, device=dev),
                                    generator=generator)
            # an all-zero draw falls back to ONE random feature
            one = torch.nn.functional.one_hot(
                torch.randint(0, d, (), device=dev, generator=generator),
                d).to(torch.float32)
            fmask = torch.where(fmask.sum() > 0, fmask, one)
        else:
            fmask = torch.ones(d, dtype=torch.float32, device=dev)

        for kcls in range(K):
            g = g_all[:, kcls] * w
            h = h_all[:, kcls] * w
            node = torch.zeros(n, dtype=torch.int32, device=dev)
            for level in range(depth):
                L = 2 ** level
                hg, hh, hc = _gbdt_hists(bins, node, g, h, w, L, B,
                                         num_chunks, onehot)
                feat, thr = _split_search(hg, hh, hc, fmask, l2,
                                          min_samples, min_gain)
                hbase = L - 1
                feats[it, kcls, hbase:hbase + L] = feat
                thrs[it, kcls, hbase:hbase + L] = thr
                node = _route(bins, node, feat, thr)

            NL = (node[:, None] == leaf_ids[None, :]).to(torch.float32)
            gh = _bf16(torch.stack([g, h], dim=1))
            sums = torch.matmul(NL.T, gh)  # (LEAF, 2)
            leaf_vals = (-sums[:, 0] / (sums[:, 1] + l2)) * lr
            leaves[it, kcls] = leaf_vals
            F[:, kcls] += leaf_vals[node.long()]
    return feats, thrs, leaves


def train_gbdt(
    X: np.ndarray,
    y: np.ndarray,
    *,
    task: str,
    num_trees: int = 100,
    depth: int = 5,
    learning_rate: float = 0.1,
    num_bins: int = 64,
    l2: float = 1.0,
    min_samples: float = 5.0,
    min_gain: float = 0.0,
    subsample: float = 1.0,
    colsample: float = 1.0,
    num_classes: int = 2,
    seed: int = 0,
    device=None,
) -> TreeEnsemble:
    """Histogram gradient boosting. task: regression | binary | multiclass.

    The host bins the data and stages it once; trees, classes and levels
    run as Python loops over torch ops on ``device`` (default: see
    :func:`~alink_tpu_torch.common.env.resolve_device`), and the tree arrays
    come back once. The hyper-parameters enter the arithmetic as fp32, as
    the reference's runtime scalars do.

    Row subsampling (``subsample < 1``) and column subsampling
    (``colsample < 1``) draw from a ``torch.Generator`` seeded with
    ``seed``; JAX's PRNG cannot be reproduced, so the port and the
    reference grow the same trees only at ``subsample = colsample = 1``."""
    _check_depth(depth)
    dev = resolve_device(device)
    n, d = X.shape
    X32 = np.asarray(X, np.float32)

    edges = quantile_bins(X32, num_bins)
    bins = apply_bins(X32, edges)

    # row-chunk the one-hot histogram operand when it would be too large;
    # pad rows so they split evenly into chunks
    num_chunks = max(1, -(-(n * d * num_bins) // _HIST_ONEHOT_BUDGET_ELEMS))
    bins_pad = _compact_bins(_pad_rows(bins, num_chunks), num_bins)
    n_pad = bins_pad.shape[0]
    valid = np.zeros(n_pad, np.float32)
    valid[:n] = 1.0

    K = num_classes if task == "multiclass" else 1
    if task == "regression":
        base = np.asarray([float(np.mean(y))], np.float32)
    elif task == "binary":
        p = float(np.clip(np.mean(y), 1e-6, 1 - 1e-6))
        base = np.asarray([np.log(p / (1 - p))], np.float32)
    else:
        probs = np.bincount(y.astype(int), minlength=K) / n
        base = np.log(np.clip(probs, 1e-6, None)).astype(np.float32)

    if task == "multiclass":
        y_enc = np.eye(K, dtype=np.float32)[np.asarray(y, int)]
    else:
        y_enc = np.asarray(y, np.float32)[:, None]
    y_pad = _pad_rows(y_enc, num_chunks)

    bins_t = torch.as_tensor(bins_pad, device=dev).to(torch.int32)
    y_t = torch.as_tensor(y_pad, device=dev)
    valid_t = torch.as_tensor(valid, device=dev)
    base_t = torch.as_tensor(base, device=dev)

    # the reference passes these as one fp32 array of runtime scalars
    hp = tuple(float(v) for v in np.asarray(
        [learning_rate, l2, min_samples, min_gain, subsample, colsample],
        np.float32))
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    with torch.inference_mode():
        feats_t, thrs_t, leaves_t = _gbdt_run(
            bins_t, y_t, valid_t, base_t, task=task,
            num_trees=int(num_trees), depth=int(depth),
            num_bins=int(num_bins), K=K, hp=hp, num_chunks=num_chunks,
            generator=gen)
    feats_b, thrs_b, leaves_np = (
        a.cpu().numpy() for a in (feats_t, thrs_t, leaves_t))

    # bin index -> raw threshold; flatten (iter, K) into T = num_trees*K
    # trees each holding only its class slot, keeping predict a plain sum
    leaf_count = 2 ** depth
    T = num_trees * K
    feats = np.zeros((T, 2 ** depth - 1), np.int32)
    thrs = np.zeros((T, 2 ** depth - 1), np.float32)
    leaves = np.zeros((T, K, leaf_count), np.float32)
    t = 0
    for it in range(num_trees):
        for kcls in range(K):
            fh = feats_b[it, kcls]
            feats[t] = fh
            thrs[t] = _bins_to_thresholds(edges, fh, thrs_b[it, kcls])
            leaves[t, kcls] = leaves_np[it, kcls]
            t += 1
    return TreeEnsemble(depth, feats, thrs, leaves, base, task)


# ---------------------------------------------------------------------------
# impurity-criterion single trees (C45 / Cart / Id3)
# ---------------------------------------------------------------------------


def train_tree_impurity(X, y, *, criterion: str, num_classes: int, **kw):
    """Not ported yet (ROADMAP A5: the impurity trees and their operators
    Cart/C45/Id3 come with a later slice)."""
    raise NotImplementedError(
        "train_tree_impurity (Cart/C45/Id3) is not ported yet: ROADMAP A5")


# ---------------------------------------------------------------------------
# RandomForest / DecisionTree
# ---------------------------------------------------------------------------


def train_forest(
    X: np.ndarray,
    y: np.ndarray,
    *,
    task: str,  # regression | binary | multiclass
    num_trees: int = 10,
    depth: int = 6,
    num_bins: int = 64,
    min_samples: float = 2.0,
    min_gain: float = 0.0,
    subsample: float = 1.0,
    feature_fraction: Optional[float] = None,
    num_classes: int = 2,
    bootstrap: bool = True,
    seed: int = 0,
    device=None,
) -> TreeEnsemble:
    """Random forest via the histogram level program: trees fit targets
    directly (g = -target·w, h = c = w -> leaf = mean target),
    variance-reduction splits. Classification fits one-vs-all class
    indicators; predict averages and argmaxes.

    Runs on ``device`` (default: see
    :func:`~alink_tpu_torch.common.env.resolve_device`). Bootstrap weights
    and feature masks come from the reference's host RNG
    (``np.random.default_rng(seed)``, drawn in the reference's order), so
    the port draws the same trees."""
    _check_depth(depth)
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    n, d = X.shape
    X32 = np.asarray(X, np.float32)
    edges = quantile_bins(X32, num_bins)
    bins = apply_bins(X32, edges)
    bins_t = torch.as_tensor(_compact_bins(bins, num_bins), device=dev)

    K = num_classes if task == "multiclass" else 1
    if task == "multiclass":
        targets = np.eye(K, dtype=np.float32)[np.asarray(y, int)]
    else:
        targets = np.asarray(y, np.float32)[:, None]

    if feature_fraction is None:
        feature_fraction = 1.0 if num_trees == 1 else max(1.0 / d, np.sqrt(d) / d)

    leaf_count = 2 ** depth
    T = num_trees * K
    feats = np.zeros((T, 2 ** depth - 1), np.int32)
    thrs = np.zeros((T, 2 ** depth - 1), np.float32)
    leaves = np.zeros((T, K, leaf_count), np.float32)

    t = 0
    with torch.inference_mode():
        for it in range(num_trees):
            if bootstrap and num_trees > 1:
                # bootstrap of subsample*n draws, so subsamplingRatio composes
                n_draw = max(1, int(round(n * min(subsample, 1.0))))
                w = rng.multinomial(n_draw, np.ones(n) / n).astype(np.float32)
            elif subsample < 1:
                w = (rng.random(n) < subsample).astype(np.float32)
            else:
                w = np.ones(n, np.float32)
            fmask = (rng.random(d) < feature_fraction).astype(np.float32)
            if fmask.sum() == 0:
                fmask[rng.integers(d)] = 1.0
            w_t = torch.as_tensor(w, device=dev)
            for kcls in range(K):
                g_t = torch.as_tensor(-(targets[:, kcls] * w), device=dev)
                fh, th, node = _grow_tree(
                    bins_t, g_t, w_t, w_t, edges, depth, num_bins, 1e-9,
                    min_samples, min_gain, fmask)
                leaf_vals = _leaf_values(g_t, w_t, node, leaf_count,
                                         1e-9).cpu().numpy() / num_trees
                feats[t] = fh
                thrs[t] = th
                leaves[t, kcls] = leaf_vals
                t += 1

    base = np.zeros(K, np.float32)
    return TreeEnsemble(depth, feats, thrs, leaves, base, task)
