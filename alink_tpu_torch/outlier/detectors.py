"""Outlier detector scoring kernels (port of
``alink_tpu.outlier.detectors``).

Capability parity with the reference's outlier calculators (reference:
core/src/main/java/com/alibaba/alink/operator/common/outlier/ —
KSigmaDetectorCalc, BoxPlotDetectorCalc, MadDetectorCalc, EsdDetectorCalc,
SHEsdDetectorCalc, HbosDetector, KdeDetector, LofDetector,
IForestDetector, EcodDetector, CopodDetector; 7.6k LoC).

Every detector is a vectorized scoring function — univariate detectors are
closed-form columnar reductions on the host; the O(n²) neighbourhood
detectors (KDE, LOF, SOS, DBSCAN) take their pairwise squared distances
from the device (``_pairwise_sq_dists``: blocks of 4,096 rows, each
``‖q‖² − 2q·x + ‖x‖²`` summed in float64 over the float32 rows and rounded
to float32, so a block gives the whole matrix's distances and the card the
CPU route's; the rest of each detector runs on the host, as in the
reference). The one-class SVM trains its primal weights on the device in
float64 (autograd under optax's Adam, step for step:
``dl.train.Optimizer``);
its hinge is written as ``torch.maximum(0, ρ − margin)``, whose gradient
at the tie (every margin at the start, w = 0 and ρ = 0) splits between the
two sides as JAX's ``jnp.maximum`` does (``relu`` would give 0 there).
Isolation forest grows tiny random trees host-side and descends all rows
through them on the device, with the reference's arithmetic (scores equal
the host's).

Each scorer returns (scores, is_outlier) with scores oriented so larger =
more anomalous.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np

Arr = np.ndarray


# -- univariate (series) detectors ------------------------------------------

def ksigma(x: Arr, k: float = 3.0) -> Tuple[Arr, Arr]:
    """(reference: KSigmaDetectorCalc) score = |z|; outlier if > k."""
    mu = np.nanmean(x)
    sd = np.nanstd(x)
    z = np.abs(x - mu) / max(sd, 1e-12)
    return z, z > k


def boxplot(x: Arr, k: float = 1.5) -> Tuple[Arr, Arr]:
    """(reference: BoxPlotDetectorCalc) distance beyond the IQR fences in
    IQR units; outlier if > 0 with fence factor k."""
    q1, q3 = np.nanpercentile(x, [25, 75])
    iqr = max(q3 - q1, 1e-12)
    lo, hi = q1 - k * iqr, q3 + k * iqr
    score = np.maximum(lo - x, x - hi) / iqr
    return np.maximum(score, 0.0), (x < lo) | (x > hi)


def mad(x: Arr, k: float = 3.5) -> Tuple[Arr, Arr]:
    """(reference: MadDetectorCalc) modified z-score via median absolute
    deviation (0.6745 consistency constant)."""
    med = np.nanmedian(x)
    m = np.nanmedian(np.abs(x - med))
    z = 0.6745 * np.abs(x - med) / max(m, 1e-12)
    return z, z > k


def esd(x: Arr, alpha: float = 0.05,
        max_outliers: Optional[int] = None) -> Tuple[Arr, Arr]:
    """Generalized ESD test (reference: EsdDetectorCalc). Iteratively removes
    the most extreme point and compares the test statistic to the critical
    value; scores are |z| at removal time."""
    from scipy import stats

    n = len(x)
    k = max_outliers or max(1, int(n * 0.1))
    work = x.astype(np.float64).copy()
    active = ~np.isnan(work)  # NaNs never participate (nan-aware like ksigma)
    out = np.zeros(n, bool)
    scores = np.zeros(n)
    order = []
    for i in range(1, k + 1):
        vals = work[active]
        m = len(vals)
        if m < 3:
            break
        mu, sd = vals.mean(), vals.std(ddof=1)
        if sd < 1e-12:
            break
        z = np.abs(work - mu) / sd
        z[~active] = -1
        j = int(np.argmax(z))
        R = z[j]
        p = 1 - alpha / (2 * (n - i + 1))
        t = stats.t.ppf(p, n - i - 1)
        lam = (n - i) * t / math.sqrt((n - i - 1 + t * t) * (n - i + 1))
        scores[j] = R
        order.append((j, R > lam))
        active[j] = False
    # ESD semantics: if the i-th test rejects, ALL i most extreme are outliers
    last_reject = -1
    for idx, (j, rej) in enumerate(order):
        if rej:
            last_reject = idx
    for idx, (j, _) in enumerate(order):
        if idx <= last_reject:
            out[j] = True
    return scores, out


def shesd(x: Arr, period: int, alpha: float = 0.05,
          max_outliers: Optional[int] = None) -> Tuple[Arr, Arr]:
    """Seasonal-hybrid ESD (reference: SHEsdDetectorCalc): remove the
    per-phase seasonal median and the global median, then run ESD on the
    residual."""
    n = len(x)
    phases = np.arange(n) % max(period, 1)
    seasonal = np.zeros(n)
    for p in range(max(period, 1)):
        m = phases == p
        if m.any():
            seasonal[m] = np.nanmedian(x[m])
    resid = x - seasonal - np.nanmedian(x - seasonal)
    return esd(resid, alpha=alpha, max_outliers=max_outliers)


# -- multivariate detectors --------------------------------------------------

def hbos(X: Arr, num_bins: int = 10) -> Tuple[Arr, Arr]:
    """Histogram-based outlier score (reference: HbosDetector):
    Σ_d -log(density_d(x)); outlier above the 95th percentile score."""
    n, d = X.shape
    score = np.zeros(n)
    for j in range(d):
        col = X[:, j]
        hist, edges = np.histogram(col, bins=num_bins)
        dens = hist / max(hist.max(), 1)
        idx = np.clip(np.searchsorted(edges, col, side="right") - 1,
                      0, num_bins - 1)
        score += -np.log(np.maximum(dens[idx], 1e-12))
    return score, score > np.percentile(score, 95)


def _pairwise_sq_dists(X: Arr, chunk: int = 4096, device=None) -> Arr:
    """(n, n) squared distances, row blocks on the device (float64 sums of
    the float32 rows, rounded to float32), clipped at 0, on the host."""
    import torch

    from ..common.env import resolve_device
    from ..common.linalg import pairwise_sq_dists

    dev = resolve_device(device)
    n = X.shape[0]
    X64 = torch.as_tensor(np.asarray(X, np.float32), device=dev).double()
    out = np.empty((n, n), np.float32)
    for s in range(0, n, chunk):
        out[s:s + chunk] = pairwise_sq_dists(
            X64[s:s + chunk], X64).float().cpu().numpy()
    return np.maximum(out, 0.0)


def kde(X: Arr, bandwidth: Optional[float] = None,
        device=None) -> Tuple[Arr, Arr]:
    """Gaussian KDE negative log density (reference: KdeDetector)."""
    n, d = X.shape
    if bandwidth is None:
        bandwidth = float(np.mean(np.std(X, axis=0)) *
                          (4 / (d + 2)) ** (1 / (d + 4)) *
                          n ** (-1 / (d + 4)) + 1e-12)
    d2 = _pairwise_sq_dists(X, device=device)
    K = np.exp(-d2 / (2 * bandwidth ** 2))
    np.fill_diagonal(K, 0.0)
    dens = K.sum(1) / max(n - 1, 1)
    score = -np.log(np.maximum(dens, 1e-300))
    return score, score > np.percentile(score, 95)


def lof(X: Arr, k: int = 10, device=None) -> Tuple[Arr, Arr]:
    """Local outlier factor (reference: LofDetector); outlier if LOF > 1.5."""
    n = X.shape[0]
    if n <= 1:
        return np.zeros(n), np.zeros(n, bool)
    k = min(k, n - 1)
    d2 = _pairwise_sq_dists(X, device=device)
    np.fill_diagonal(d2, np.inf)
    dist = np.sqrt(d2)
    nn_idx = np.argpartition(dist, k - 1, axis=1)[:, :k]
    nn_dist = np.take_along_axis(dist, nn_idx, axis=1)
    k_dist = nn_dist.max(axis=1)                       # k-distance per point
    reach = np.maximum(nn_dist, k_dist[nn_idx])        # reach-dist(a, b)
    lrd = 1.0 / np.maximum(reach.mean(axis=1), 1e-12)
    lof_score = (lrd[nn_idx].mean(axis=1)) / lrd
    return lof_score, lof_score > 1.5


def _tail_log_probs(col: Arr) -> Tuple[Arr, Arr, Arr]:
    """Per-column ECDF tail scores: (-log F, -log(1-F), skew-selected tail)
    — the shared core of ECOD and COPOD."""
    n = len(col)
    order = np.argsort(col, kind="stable")
    ranks = np.empty(n)
    ranks[order] = np.arange(1, n + 1)
    F = ranks / (n + 1)
    left = -np.log(F)
    right = -np.log(1 - F)
    skew = float(((col - col.mean()) ** 3).mean() /
                 max(col.std() ** 3, 1e-12))
    return left, right, (right if skew > 0 else left)


def _ecdf_tail_score(X: Arr) -> Arr:
    """max over the left / right / skew-corrected tail-probability sums —
    the ECOD/COPOD aggregation (both tails count, so a low outlier in a
    right-skewed dimension still scores)."""
    n, d = X.shape
    left = np.zeros(n)
    right = np.zeros(n)
    skewed = np.zeros(n)
    for j in range(d):
        l_, r_, a_ = _tail_log_probs(X[:, j])
        left += l_
        right += r_
        skewed += a_
    return np.maximum.reduce([left, right, skewed])


def ecod(X: Arr) -> Tuple[Arr, Arr]:
    """Empirical-CDF outlier detection (reference: EcodDetector): score =
    max(Σ-log F, Σ-log(1-F), Σ skew-selected tail)."""
    score = _ecdf_tail_score(X)
    return score, score > np.percentile(score, 95)


def copod(X: Arr) -> Tuple[Arr, Arr]:
    """Copula-based outlier detection (reference: CopodDetector): the
    empirical-copula formulation reduces to the same max-of-tail-sums
    aggregation as ECOD on per-dimension ECDFs."""
    score = _ecdf_tail_score(X)
    return score, score > np.percentile(score, 95)


# -- isolation forest --------------------------------------------------------

def _avg_path(n: float) -> float:
    if n <= 1:
        return 0.0
    return 2.0 * (math.log(n - 1) + 0.5772156649) - 2.0 * (n - 1) / n


def _avg_path_vec(ns: Arr) -> Arr:
    """Vectorized c(n) — the per-row hot path of iforest scoring."""
    ns = np.asarray(ns, np.float64)
    safe = np.maximum(ns, 2.0)
    val = 2.0 * (np.log(safe - 1.0) + 0.5772156649) - 2.0 * (safe - 1.0) / safe
    return np.where(ns <= 1, 0.0, val)


def iforest(X: Arr, num_trees: int = 100, subsample: int = 256,
            seed: int = 0, device=None) -> Tuple[Arr, Arr]:
    """Isolation forest (reference: IForestDetector) — a thin wrapper over
    the servable fit/score pair so the numeric kernel exists once."""
    X = np.asarray(X, np.float64)
    return iforest_score(iforest_fit(X, num_trees=num_trees,
                                     subsample=subsample, seed=seed), X,
                         device=device)


def sos(X: Arr, perplexity: float = 4.5, device=None) -> Tuple[Arr, Arr]:
    """Stochastic Outlier Selection (reference: common/outlier/SosDetector):
    adaptive-bandwidth affinities (binary search to the target perplexity),
    binding probabilities, outlier probability = prod(1 - b_ji)."""
    n = X.shape[0]
    if n < 3:
        return np.zeros(n), np.zeros(n, bool)
    d2 = _pairwise_sq_dists(np.asarray(X, np.float32),
                            device=device).astype(np.float64)
    np.fill_diagonal(d2, np.inf)
    target = np.log(min(perplexity, n - 1))
    # per-point binary search on precision so each row's entropy == target
    beta = np.asarray([_sos_precision(d2[i], target) for i in range(n)],
                      np.float64)
    A = np.exp(-beta[:, None] * d2)
    B = A / np.maximum(A.sum(axis=1, keepdims=True), 1e-300)  # binding probs
    with np.errstate(divide="ignore"):
        log1m = np.log(np.maximum(1.0 - B, 1e-300))
    prob = np.exp(log1m.sum(axis=0) - np.diag(log1m))  # prod over j != i
    return prob, prob > 0.5


def _sos_precision(d2_row: Arr, target: float) -> float:
    """One row's binary search on the precision β until the entropy of its
    affinities is within 1e-5 of ``target`` (50 steps at most)."""
    beta = np.float64(1.0)
    lo, hi = 0.0, np.inf
    for _ in range(50):
        a = np.exp(-beta * d2_row)
        s = a.sum()
        if s <= 0:
            beta /= 2.0
            continue
        p = a / s
        ent = -(p[p > 0] * np.log(p[p > 0])).sum()
        if abs(ent - target) < 1e-5:
            break
        if ent > target:
            lo = beta
            beta = beta * 2 if hi == np.inf else (beta + hi) / 2
        else:
            hi = beta
            beta = (lo + beta) / 2
    return beta


def ocsvm(X: Arr, nu: float = 0.1, gamma: Optional[float] = None,
          num_features: int = 256, num_steps: int = 400,
          seed: int = 0, device=None) -> Tuple[Arr, Arr]:
    """One-class SVM via Nyström RBF features (reference:
    common/outlier/OcsvmDetector) — wrapper over the servable fit/score
    pair (ocsvm_fit keeps the Nyström landmarks, so far outliers decay
    outside the boundary exactly as before)."""
    model = ocsvm_fit(X, nu=nu, gamma=gamma, num_features=num_features,
                      num_steps=num_steps, seed=seed, device=device)
    return ocsvm_score(model, X)


def cooks_distance(X: Arr, y: Arr, alpha: float = 0.95
                   ) -> Tuple[Arr, Arr, float]:
    """Cook's distance of each row under OLS with intercept (reference:
    common/outlier/CooksDistanceDetector.java — D_i > F(0.95, p, n-p)
    flags the row). Returns (distance, flags, f_threshold)."""
    from ..stats.prob import IDF

    X = np.asarray(X, np.float64)
    y = np.asarray(y, np.float64).reshape(-1)
    n = X.shape[0]
    Xd = np.concatenate([X, np.ones((n, 1))], axis=1)
    p = Xd.shape[1]
    if n <= p:
        raise ValueError("rowNum must be larger than colNum-1")
    G = np.linalg.pinv(Xd.T @ Xd)
    H_diag = np.einsum("ij,jk,ik->i", Xd, G, Xd)
    beta = G @ (Xd.T @ y)
    resid = y - Xd @ beta
    dof = max(n - p, 1)
    s2 = float(resid @ resid) / dof
    h = np.clip(H_diag, 0.0, 1.0 - 1e-12)
    d = (resid ** 2 / (p * max(s2, 1e-300))) * (h / (1.0 - h) ** 2)
    f_thr = float(IDF.f(alpha, p, dof))
    return d, d > f_thr, f_thr


# ---------------------------------------------------------------------------
# DBSCAN density outlier
# ---------------------------------------------------------------------------


def dbscan_outlier(X: Arr, min_points: int = 4,
                   eps: Optional[float] = None,
                   within_sd: float = 2.0, device=None) -> Tuple[Arr, Arr]:
    """DBSCAN-based outlier detection (reference: common/outlier/
    DbscanDetector.java): eps defaults to mean(k-th NN distance) +
    within_sd·sd; points whose k-th neighbor is beyond eps (density too
    low to be core-reachable) are outliers; score = k-th distance / eps."""
    X = np.asarray(X, np.float64)
    n = X.shape[0]
    k = min(max(min_points, 1), max(n - 1, 1))
    d2 = _pairwise_sq_dists(X, device=device)
    np.fill_diagonal(d2, np.inf)
    kth = np.sqrt(np.partition(d2, k - 1, axis=1)[:, k - 1])
    if eps is None:
        eps = float(kth.mean() + within_sd * kth.std())
    eps = max(eps, 1e-12)
    score = kth / eps
    return score, score > 1.0


# ---------------------------------------------------------------------------
# Dynamic time warping
# ---------------------------------------------------------------------------


def dtw_distance(a: Arr, b: Arr, search_window: int = -1) -> float:
    """Classic DP DTW with an optional Sakoe-Chiba band (reference:
    common/outlier/DynamicTimeWarpingDetector.java dtw())."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    n, m = len(a), len(b)
    w = max(search_window, abs(n - m)) if search_window >= 0 else max(n, m)
    D = np.full((n + 1, m + 1), np.inf)
    D[0, 0] = 0.0
    for i in range(1, n + 1):
        lo = max(1, i - w)
        hi = min(m, i + w)
        for j in range(lo, hi + 1):
            cost = abs(a[i - 1] - b[j - 1])
            D[i, j] = cost + min(D[i, j - 1], D[i - 1, j], D[i - 1, j - 1])
    return float(D[n, m])


def dtw_outlier(x: Arr, series_length: int,
                search_window: int = -1,
                k_sigma: float = 3.0) -> Tuple[Arr, Arr]:
    """Per-window DTW novelty: each length-``series_length`` window's DTW
    distance to its predecessor, flagged by k-sigma over the distance
    series (reference: DynamicTimeWarpingDetector — the stream op detects
    the LAST window against history; the batch scan scores every window,
    broadcast back to its rows)."""
    x = np.asarray(x, np.float64).reshape(-1)
    n = len(x)
    L = max(1, min(series_length, n))
    n_win = n // L
    if n_win < 3:
        return np.zeros(n), np.zeros(n, bool)
    wins = x[: n_win * L].reshape(n_win, L)
    dists = np.zeros(n_win)
    for i in range(1, n_win):
        dists[i] = dtw_distance(wins[i], wins[i - 1], search_window)
    base = dists[1:]
    mu, sd = float(base.mean()), float(base.std())
    flags_w = np.zeros(n_win, bool)
    if sd > 0:
        flags_w[1:] = np.abs(base - mu) > k_sigma * sd
    scores = np.zeros(n)
    flags = np.zeros(n, bool)
    for i in range(n_win):
        scores[i * L:(i + 1) * L] = dists[i]
        flags[i * L:(i + 1) * L] = flags_w[i]
    return scores, flags


# ---------------------------------------------------------------------------
# servable model variants (train once, score anywhere)
# ---------------------------------------------------------------------------


def iforest_fit(X: Arr, num_trees: int = 100, subsample: int = 256,
                seed: int = 0) -> Dict[str, np.ndarray]:
    """Isolation forest as serializable arrays: heap-layout trees
    (feat/thr/is_leaf/leaf_size) (reference: IForestModelDetector's
    persisted trees)."""
    rng = np.random.default_rng(seed)
    X = np.asarray(X, np.float64)
    n, d = X.shape
    psi = min(subsample, n)
    depth = max(1, int(np.ceil(np.log2(max(psi, 2)))))
    n_nodes = 2 ** (depth + 1) - 1
    feats = np.zeros((num_trees, n_nodes), np.int64)
    thrs = np.zeros((num_trees, n_nodes), np.float32)
    leaf = np.ones((num_trees, n_nodes), bool)
    sizes = np.zeros((num_trees, n_nodes), np.float64)
    for ti in range(num_trees):
        idx = rng.choice(n, psi, replace=False)
        queue = [(0, idx)]
        while queue:
            node, rows = queue.pop()
            node_depth = int(np.floor(np.log2(node + 1)))
            if len(rows) <= 1 or node_depth >= depth:
                sizes[ti, node] = len(rows)
                continue
            j = rng.integers(d)
            lo, hi = X[rows, j].min(), X[rows, j].max()
            if hi <= lo:
                sizes[ti, node] = len(rows)
                continue
            thr = rng.uniform(lo, hi)
            feats[ti, node] = j
            thrs[ti, node] = thr
            leaf[ti, node] = False
            mask = X[rows, j] < thr
            queue.append((2 * node + 1, rows[mask]))
            queue.append((2 * node + 2, rows[~mask]))
    return {"feats": feats, "thrs": thrs, "leaf": leaf.astype(np.int8),
            "sizes": sizes, "psi": np.asarray([psi], np.int64),
            "depth": np.asarray([depth], np.int64)}


def iforest_score(model: Dict[str, np.ndarray], X: Arr,
                  threshold: float = 0.6, device=None) -> Tuple[Arr, Arr]:
    """Mean path length over the trees → 2^(−E[h]/c(ψ)). The heap descent
    of every row runs on ``device``: the float64 comparisons, the level
    counts and the per-tree sums of the reference's numpy descent, in its
    order (each leaf's c(size) from the same numpy function), so the
    scores equal the host's."""
    import torch

    from ..common.env import resolve_device

    dev = resolve_device(device)
    X = torch.tensor(np.asarray(X, np.float64), device=dev)
    n = X.shape[0]
    leaf = torch.as_tensor(model["leaf"].astype(bool), device=dev)
    feats = torch.as_tensor(model["feats"], device=dev)
    thrs = torch.as_tensor(model["thrs"], device=dev).double()
    c_leaf = torch.as_tensor(np.stack([_avg_path_vec(s)
                                       for s in model["sizes"]]), device=dev)
    psi = int(model["psi"][0])
    depth = int(model["depth"][0])
    rows = torch.arange(n, device=dev)
    path = torch.zeros(n, dtype=torch.float64, device=dev)
    for ti in range(feats.shape[0]):
        cur = torch.zeros(n, dtype=torch.long, device=dev)
        depth_at = torch.zeros(n, dtype=torch.float64, device=dev)
        done = leaf[ti][cur]
        for _level in range(depth):
            go = ~done
            left = X[rows, feats[ti][cur]] < thrs[ti][cur]
            cur = torch.where(go, torch.where(left, 2 * cur + 1, 2 * cur + 2),
                              cur)
            depth_at += go
            done = leaf[ti][cur]
        path += depth_at + c_leaf[ti][cur]
    e_path = path.cpu().numpy() / feats.shape[0]
    score = 2.0 ** (-e_path / max(_avg_path(psi), 1e-12))
    return score, score > threshold


def ocsvm_fit(X: Arr, nu: float = 0.1, gamma: Optional[float] = None,
              num_features: int = 256, num_steps: int = 400,
              seed: int = 0, device=None,
              chunk: int = 4096) -> Dict[str, np.ndarray]:
    """One-class SVM model as arrays: Nyström landmarks + whitening + primal
    weights (reference: OcsvmModelData — persisted support vectors). The
    features and the Adam loop run on ``device`` in float64 over the
    float32 rows (the reference runs float32: 400 Adam steps grow the
    card's and the CPU's roundings until flags near the boundary part);
    the model keeps float32 weights, as the reference's."""
    import torch

    from ..common.env import resolve_device
    from ..dl.train import Optimizer

    dev = resolve_device(device)
    X = np.asarray(X, np.float32)
    n, d = X.shape
    if gamma is None:
        gamma = 1.0 / max(d, 1)
    rng = np.random.default_rng(seed)
    m = min(num_features, n)
    landmarks = X[rng.choice(n, m, replace=False)]

    def _rbf(A, B):
        d2 = ((A[:, None, :] - B[None, :, :]) ** 2).sum(-1)
        return np.exp(-gamma * d2)

    K_mm = _rbf(landmarks, landmarks) + 1e-6 * np.eye(m)
    evals, evecs = np.linalg.eigh(K_mm)
    evals = np.maximum(evals, 1e-8)
    whiten = (evecs / np.sqrt(evals)).astype(np.float32)

    Z = _rbf_features(X, landmarks, whiten, gamma, dev, chunk)

    def loss(w, rho):
        margins = Z @ w
        hinge = torch.maximum(torch.zeros((), dtype=Z.dtype, device=dev),
                              rho - margins).mean() / max(nu, 1e-6)
        return 0.5 * (w @ w) - rho + hinge

    params = {"w": torch.zeros(m, dtype=Z.dtype, device=dev,
                               requires_grad=True),
              "rho": torch.zeros((), dtype=Z.dtype, device=dev,
                                 requires_grad=True)}
    opt = Optimizer("adam", lambda _count: 0.05, params)
    for _ in range(num_steps):
        opt.step(torch.autograd.grad(loss(*opt.params), opt.params))
    return {"landmarks": landmarks, "whiten": whiten.astype(np.float32),
            "w": params["w"].detach().cpu().numpy().astype(np.float32),
            "rho": np.asarray([float(params["rho"].detach())], np.float32),
            "gamma": np.asarray([gamma], np.float32)}


def _rbf_features(X: Arr, landmarks: Arr, whiten: Arr, gamma: float, dev,
                  chunk: int):
    """exp(-γ‖x − l‖²) against every landmark, times the whitening: the
    (n, m) Nyström features on ``dev`` in float64, in row blocks (the
    (n, m, d) broadcast stays bounded)."""
    import torch

    L = torch.as_tensor(landmarks, device=dev).double()
    Wt = torch.as_tensor(whiten, device=dev).double()
    out = torch.empty((len(X), len(landmarks)), dtype=torch.float64,
                      device=dev)
    for s in range(0, len(X), chunk):
        blk = torch.as_tensor(X[s:s + chunk], device=dev).double()
        d2 = ((blk[:, None, :] - L[None, :, :]) ** 2).sum(-1)
        out[s:s + chunk] = torch.exp(-gamma * d2) @ Wt
    return out


def ocsvm_score(model: Dict[str, np.ndarray], X: Arr,
                chunk: int = 4096, device=None) -> Tuple[Arr, Arr]:
    """ρ − f(x)·w over the Nyström features, computed on ``device`` in
    float64, in row chunks."""
    import torch

    from ..common.env import resolve_device

    X = np.asarray(X, np.float32)
    rho = float(model["rho"][0])
    F = _rbf_features(X, model["landmarks"], model["whiten"],
                      float(model["gamma"][0]), resolve_device(device),
                      chunk)
    w = torch.as_tensor(np.asarray(model["w"], np.float64), device=F.device)
    score = (rho - (F @ w)).cpu().numpy()
    return score, score > 0
