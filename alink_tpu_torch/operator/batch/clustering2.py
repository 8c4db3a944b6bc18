"""Clustering breadth: GMM, BisectingKMeans, DBSCAN, LDA, KModes, Agnes,
the grouped ops and SOM (port of ``alink_tpu.operator.batch.clustering2``).

Capability parity with the reference clustering package (reference:
core/src/main/java/com/alibaba/alink/operator/batch/clustering/
GmmTrainBatchOp.java + common/clustering/GmmModelData.java,
BisectingKMeansTrainBatchOp.java, DbscanBatchOp.java (+ GroupDbscanBatchOp),
LdaTrainBatchOp.java:176-240 (common/clustering/lda/OnlineCorpusStep.java),
KModesTrainBatchOp.java, AgnesBatchOp.java).

Device work, on the session's device (``MLEnvironment.device``):

- GMM's full-covariance EM. Each iteration is one E-step (a batched
  Cholesky of the k covariances, one batched triangular solve of the rows
  against them, a logsumexp) and one M-step. The second moments Σ rᵢxᵢxᵢᵀ
  are a (k, d, n) × (n, d) product of the responsibility-weighted rows with
  the rows: nothing of size n·k·d·d is formed. The loop reads the stopping
  test, one scalar, once an iteration: its only host sync.
- GMM's posterior mapper.
- LDA's batch variational Bayes: each outer iteration's 50 inner steps are
  two (n, V, k) products each, with ``torch.special.digamma``.
- DBSCAN's ε-graph, in (block × n) tiles; the cluster expansion is host-side
  (a dynamic frontier), as in the reference.
- BisectingKMeans's splits, through the KMeans slice's Lloyd loop; the
  split's assignment on the device.
- SOM's batch updates.

Precision: the blocks are float32 as the reference's, and so are the
models. DBSCAN's ε test (GroupGeoDbscan's great-circle one too) and the
BisectingKMeans and GroupKMeans assignments are taken on float64 distances
of the float32 rows, as the KMeans slice takes its argmin
(``clustering.py``): a float32 distance near ε or near a tie rounds by the
device's summation order, so the neighbour lists and splits would depend on
the device. They differ from the reference's float32 decisions only for
pairs within that rounding of ε or of a tie. GMM's EM and posterior and
LDA's outer steps run in float64 from the float32 inputs (the reference's
run in float32): in float32 their results depend on the summation order of
their products over rows and vocabulary, which differs between the card
and the CPU, by more than the fit itself resolves. On 200,000 rows of the
Covertype feature pipeline a float32 EM's log-likelihood moves by ~7e-5
relative when the rows are permuted, a float64 one by ~1e-14; float32
LDA's λ by ~1e-4 on 500 text8-layout documents, and ~6e-3 from float64's
(``scripts/compare_clustering_precision.py`` on the CPU).

Host-side as in the reference: k-means++ seeding, LDA's corpus build, the
DBSCAN expansion, KModes, Agnes and GroupEm (small-n algorithms).
"""

from __future__ import annotations

from typing import List

import numpy as np

from ...common.exceptions import AkIllegalDataException
from ...common.model import model_to_table, table_to_model
from ...common.mtable import AlinkTypes, MTable, TableSchema
from ...common.params import InValidator, MinValidator, ParamInfo
from ...mapper import (
    HasFeatureCols,
    HasPredictionCol,
    HasPredictionDetailCol,
    HasReservedCols,
    HasSelectedCol,
    HasSelectedCols,
    HasVectorCol,
    RichModelMapper,
    detail_json,
    get_feature_block,
    merge_feature_params,
    resolve_feature_cols,
)
from ...parallel.comqueue import shard_rows
from .base import BatchOperator
from .clustering import KMeansModelMapper, _dists, _kmeanspp_init, _lloyd
from .utils import ModelMapBatchOp, ModelTrainOpMixin


def _append_pred_schema(op, in_schema):
    pred_col = op.get(HasPredictionCol.PREDICTION_COL)
    return TableSchema(list(in_schema.names) + [pred_col],
                       list(in_schema.types) + [AlinkTypes.LONG])


def _coerce_group_cols(value) -> List[str]:
    """groupCols accepts a list or a comma string (reference:
    operator/batch/utils2.py)."""
    if isinstance(value, (list, tuple)):
        return [str(c).strip() for c in value]
    return [c.strip() for c in str(value).split(",") if c.strip()]


def _group_row_indices(t: MTable, group_cols: List[str]):
    """key tuple -> row indices, first-seen order (reference:
    operator/batch/utils2.py)."""
    keys = list(zip(*[np.asarray(t.col(c), object) for c in group_cols]))
    index: dict = {}
    order: List[tuple] = []
    for r, k in enumerate(keys):
        if k not in index:
            index[k] = []
            order.append(k)
        index[k].append(r)
    return index, order


# ---------------------------------------------------------------------------
# Gaussian mixture
# ---------------------------------------------------------------------------

def _log_prob(X, mu, cov, reg: float):
    """(n, k) Gaussian log-densities of the rows ``X`` (n, d) under the k
    components (mu (k, d), cov (k, d, d)), through the Cholesky factors of
    cov + reg·I: one batched factorization and one batched triangular
    solve."""
    import math

    import torch

    d = X.shape[1]
    eye = torch.eye(d, dtype=X.dtype, device=X.device)
    L, _ = torch.linalg.cholesky_ex(cov + reg * eye)          # (k, d, d)
    maha = []
    for j in range(mu.shape[0]):       # one (d, n) solve at a time
        sol = torch.linalg.solve_triangular(L[j], (X - mu[j]).T,
                                            upper=False)
        maha.append((sol * sol).sum(0))
    logdet = 2.0 * torch.log(torch.diagonal(L, dim1=1, dim2=2)).sum(1)
    return -0.5 * (torch.stack(maha, dim=1) + logdet[None, :]
                   + d * math.log(2.0 * math.pi))


def _gmm_moments(X, r):
    """Σ rᵢ, Σ rᵢxᵢ and Σ rᵢxᵢxᵢᵀ of each component: (k,), (k, d),
    (k, d, d). Each component's second moments are one (d, n) × (n, d)
    product of its weighted rows with the rows (never an (n, k, d, d)
    tensor)."""
    import torch

    sxx = torch.stack([(X * r[:, j, None]).T @ X for j in range(r.shape[1])])
    return r.sum(0), r.T @ X, sxx


def _gmm_step(X, mask, w, mu, cov, total_n, reg: float):
    """One EM iteration (reference: clustering2.py:95-104). Returns the
    new (w, mu, cov) and the log-likelihood of the E-step's parameters."""
    import torch

    lp = _log_prob(X, mu, cov, reg) + torch.log(w)[None, :]
    norm = torch.logsumexp(lp, dim=1, keepdim=True)
    r = torch.exp(lp - norm) * mask[:, None]
    ll = (norm[:, 0] * mask).sum()
    nk, sx, sxx = _gmm_moments(X, r)
    nk = torch.clamp(nk, min=1e-10)
    mu_new = sx / nk[:, None]
    eye = torch.eye(X.shape[1], dtype=X.dtype, device=X.device)
    cov_new = (sxx / nk[:, None, None]
               - mu_new[:, :, None] * mu_new[:, None, :] + reg * eye)
    return nk / total_n, mu_new, cov_new, ll


def _gmm_em(X, mask, w0, mu0, cov0, max_iter: int, tol: float, reg: float):
    """The EM loop with the reference's stopping rule (clustering2.py:106-110):
    go on while i < max_iter and |ll − ll_prev| > tol·(|ll_prev| + 1).
    Returns (w, mu, cov, ll, iterations, host syncs); the syncs are the
    stopping tests read on the host, one an iteration after the first."""
    import torch

    w, mu, cov = w0, mu0, cov0
    # the carry's initial log-likelihoods; their test is decided here
    ll = torch.tensor(-1e30, dtype=X.dtype, device=X.device)
    ll_prev = torch.tensor(-2e30, dtype=X.dtype, device=X.device)
    total_n = mask.sum()
    go = 1e30 > tol * (2e30 + 1.0)
    i = syncs = 0
    while i < max_iter and go:
        ll_prev = ll
        w, mu, cov, ll = _gmm_step(X, mask, w, mu, cov, total_n, reg)
        i += 1
        if i < max_iter:
            go = bool((ll - ll_prev).abs() > tol * (ll_prev.abs() + 1.0))
            syncs += 1
    return w, mu, cov, ll, i, syncs


def _gmm_init(X: np.ndarray, k: int, seed: int, reg: float):
    """The reference's host-side start: k-means++ means, equal weights and
    the mean per-column variance on every diagonal."""
    d = X.shape[1]
    centers = _kmeanspp_init(X, k, seed)
    w0 = np.full((k,), 1.0 / k, np.float32)
    var0 = float(X.var(axis=0).mean()) + reg
    cov0 = np.tile(np.eye(d, dtype=np.float32) * var0, (k, 1, 1))
    return w0, centers.astype(np.float32), cov0


def _gmm_fit(device, X: np.ndarray, k: int, max_iter: int, tol: float,
             seed: int, reg: float = 1e-6):
    """The EM on ``device`` in float64 from the float32 rows (see the
    module docstring). Returns the float32 (w, mu, cov) as the reference's
    model holds them, the log-likelihood, the iterations and the host
    syncs."""
    import torch

    from ...common.env import resolve_device

    device = resolve_device(device)
    w0, mu0, cov0 = _gmm_init(X, k, seed, reg)
    Xs, mask = shard_rows(device, X.astype(np.float32), with_mask=True)
    w, mu, cov, ll, iters, syncs = _gmm_em(
        Xs.double(), mask.double(),
        *(torch.as_tensor(a, device=device).double()
          for a in (w0, mu0, cov0)),
        int(max_iter), float(tol), float(reg))
    return (*(a.float().cpu().numpy() for a in (w, mu, cov)), float(ll),
            iters, syncs)


class GmmTrainBatchOp(ModelTrainOpMixin, BatchOperator, HasVectorCol,
                      HasFeatureCols):
    """(reference: GmmTrainBatchOp.java — full-covariance EM)"""

    K = ParamInfo("k", int, default=2, validator=MinValidator(2))
    MAX_ITER = ParamInfo("maxIter", int, default=100, validator=MinValidator(1))
    EPSILON = ParamInfo("epsilon", float, default=1e-6)
    RANDOM_SEED = ParamInfo("randomSeed", int, default=0, aliases=("seed",))

    _min_inputs = 1
    _max_inputs = 1

    def _static_meta_keys(self, in_schema):
        return {"modelName": "GmmModel"}

    def _execute_impl(self, t: MTable) -> MTable:
        k = self.get(self.K)
        feature_cols = (None if self.get(HasVectorCol.VECTOR_COL)
                        else resolve_feature_cols(t, self))
        X = get_feature_block(t, self).astype(np.float32)
        if X.shape[0] < k:
            raise AkIllegalDataException(f"k={k} but only {X.shape[0]} rows")
        w, mu, cov, ll, iters, _ = _gmm_fit(
            self.env.device, X, k, self.get(self.MAX_ITER),
            self.get(self.EPSILON), self.get(self.RANDOM_SEED))
        meta = {
            "modelName": "GmmModel", "k": k,
            "vectorCol": self.get(HasVectorCol.VECTOR_COL),
            "featureCols": feature_cols,
            "dim": int(X.shape[1]),
            "logLikelihood": ll, "numIters": iters,
        }
        return model_to_table(meta, {"weights": w, "means": mu, "covs": cov})


def _gmm_posterior(X, w, mu, cov):
    """(n, k) posterior responsibilities (reference: clustering2.py:188-201,
    cov + 1e-6·I as there), in the dtype of the arguments."""
    import torch

    lp = _log_prob(X, mu, cov, 1e-6) + torch.log(w)[None, :]
    return torch.exp(lp - torch.logsumexp(lp, dim=1, keepdim=True))


class GmmModelMapper(RichModelMapper):
    """(reference: common/clustering/GmmModelMapper.java)"""

    def load_model(self, model: MTable):
        import torch

        from ...common.env import resolve_device

        self.meta, arrays = table_to_model(model)
        self._device = resolve_device(self.device)
        self._w, self._mu, self._cov = (
            torch.as_tensor(arrays[n].astype(np.float32),
                            device=self._device).double()
            for n in ("weights", "means", "covs"))
        return self

    def _pred_type(self) -> str:
        return AlinkTypes.LONG

    def predict_block(self, t: MTable):
        import torch

        X = get_feature_block(
            t, merge_feature_params(self.get_params(), self.meta),
            vector_size=self.meta["dim"]).astype(np.float32)
        P = _gmm_posterior(torch.as_tensor(X, device=self._device).double(),
                           self._w, self._mu, self._cov).cpu().numpy()
        pred = P.argmax(axis=1).astype(np.int64)
        detail = None
        if self.get(HasPredictionDetailCol.PREDICTION_DETAIL_COL):
            detail = detail_json(list(range(P.shape[1])), P)
        return pred, AlinkTypes.LONG, detail


class GmmPredictBatchOp(ModelMapBatchOp, HasPredictionCol,
                        HasPredictionDetailCol, HasReservedCols):
    mapper_cls = GmmModelMapper


# ---------------------------------------------------------------------------
# Bisecting KMeans
# ---------------------------------------------------------------------------

class BisectingKMeansTrainBatchOp(ModelTrainOpMixin, BatchOperator,
                                  HasVectorCol, HasFeatureCols):
    """Repeatedly 2-means-split the highest-inertia cluster (reference:
    BisectingKMeansTrainBatchOp.java). Each split runs the KMeans slice's
    Lloyd loop on the member rows and assigns them on the device."""

    K = ParamInfo("k", int, default=4, validator=MinValidator(2))
    MAX_ITER = ParamInfo("maxIter", int, default=30, validator=MinValidator(1))
    RANDOM_SEED = ParamInfo("randomSeed", int, default=0, aliases=("seed",))

    _min_inputs = 1
    _max_inputs = 1

    def _static_meta_keys(self, in_schema):
        return {"modelName": "KMeansModel"}

    def _execute_impl(self, t: MTable) -> MTable:
        import torch

        from ...common.env import resolve_device

        k = self.get(self.K)
        feature_cols = (None if self.get(HasVectorCol.VECTOR_COL)
                        else resolve_feature_cols(t, self))
        X = get_feature_block(t, self).astype(np.float32)
        if X.shape[0] < k:
            raise AkIllegalDataException(f"k={k} but only {X.shape[0]} rows")
        device = resolve_device(self.env.device)
        seed = self.get(self.RANDOM_SEED)
        max_iter = self.get(self.MAX_ITER)
        X64 = torch.as_tensor(X, device=device).double()

        members = [np.arange(X.shape[0])]
        inertias = [np.inf]
        centers: List[np.ndarray] = [X.mean(axis=0)]
        while len(members) < k:
            target = int(np.argmax(inertias))
            idx = members[target]
            if idx.size < 2:
                inertias[target] = -np.inf  # cannot split further
                if all(np.isneginf(v) for v in inertias):
                    break
                continue
            c2, _, _ = _lloyd(device, X[idx], 2, max_iter, 1e-4, False,
                              seed + len(members))
            d = _dists(X64[torch.as_tensor(idx, device=device)],
                       torch.as_tensor(c2, device=device), "EUCLIDEAN")
            a = torch.argmin(d, dim=1)
            dmin = d.gather(1, a[:, None])[:, 0]
            side = torch.stack([(dmin * (a == j)).sum() for j in (0, 1)])
            a, side = a.cpu().numpy(), side.cpu().numpy()
            if (a == 0).all() or (a == 1).all():
                inertias[target] = -np.inf
                if all(np.isneginf(v) for v in inertias):
                    break
                continue
            left, right = idx[a == 0], idx[a == 1]
            members[target] = left
            centers[target] = c2[0]
            inertias[target] = float(side[0])
            members.append(right)
            centers.append(c2[1])
            inertias.append(float(side[1]))
        c = np.stack(centers).astype(np.float32)
        meta = {
            "modelName": "KMeansModel",        # predict shares KMeans mapper
            "k": int(c.shape[0]),
            "distanceType": "EUCLIDEAN",
            "vectorCol": self.get(HasVectorCol.VECTOR_COL),
            "featureCols": feature_cols,
            "dim": int(c.shape[1]),
        }
        return model_to_table(meta, {"centroids": c})


class BisectingKMeansPredictBatchOp(ModelMapBatchOp, HasPredictionCol,
                                    HasPredictionDetailCol, HasReservedCols):
    mapper_cls = KMeansModelMapper


# ---------------------------------------------------------------------------
# DBSCAN
# ---------------------------------------------------------------------------

def _expand_clusters(neighbors, core):
    """Shared DBSCAN cluster expansion: BFS from each unvisited core point
    (used by the euclidean and haversine variants so the border-point
    semantics cannot drift)."""
    n = len(neighbors)
    labels = np.full(n, -1, np.int64)
    cid = 0
    for i in range(n):
        if labels[i] != -1 or not core[i]:
            continue
        labels[i] = cid
        frontier = list(neighbors[i])
        while frontier:
            j = frontier.pop()
            if labels[j] == -1:
                labels[j] = cid
                if core[j]:
                    frontier.extend(jj for jj in neighbors[j]
                                    if labels[jj] == -1)
        cid += 1
    return labels


def _eps_neighbors(X: np.ndarray, eps: float, block: int = 2048,
                   device=None):
    """Adjacency lists of the ε-graph (each row's neighbours in ascending
    order, itself included): (block × n) float64 distance tiles of the
    float32 rows on ``device``, thresholded there; only the (row, column)
    pairs within ε come back to the host."""
    import torch

    from ...common.env import resolve_device
    from ...common.linalg import pairwise_sq_dists

    device = resolve_device(device)
    n = X.shape[0]
    block = max(1, min(block, (1 << 25) // max(n, 1)))   # tiles of <= 256 MiB
    Xd = torch.as_tensor(np.ascontiguousarray(X, np.float32),
                         device=device).double()
    eps2 = float(eps) * float(eps)
    neighbors = []
    for s in range(0, n, block):
        hits = torch.nonzero(pairwise_sq_dists(Xd[s:s + block], Xd) <= eps2)
        hits = hits.cpu().numpy()
        rows = min(block, n - s)
        cuts = np.searchsorted(hits[:, 0], np.arange(1, rows))
        neighbors.extend(np.split(hits[:, 1], cuts))
    return neighbors


class DbscanBatchOp(BatchOperator, HasVectorCol, HasFeatureCols,
                    HasPredictionCol, HasReservedCols):
    """Density clustering; appends the cluster id (−1 = noise)
    (reference: DbscanBatchOp.java — MinPoints/Epsilon params)."""

    EPSILON = ParamInfo("epsilon", float, optional=False)
    MIN_POINTS = ParamInfo("minPoints", int, default=4,
                           validator=MinValidator(1))

    _min_inputs = 1
    _max_inputs = 1

    def _execute_impl(self, t: MTable) -> MTable:
        X = get_feature_block(t, self).astype(np.float32)
        eps = float(self.get(self.EPSILON))
        min_pts = int(self.get(self.MIN_POINTS))
        neighbors = _eps_neighbors(X, eps, device=self.env.device)
        core = np.asarray([len(nb) >= min_pts for nb in neighbors])
        labels = _expand_clusters(neighbors, core)
        pred_col = self.get(HasPredictionCol.PREDICTION_COL)
        return t.with_column(pred_col, labels, AlinkTypes.LONG)

    def _out_schema(self, in_schema):
        return _append_pred_schema(self, in_schema)


# ---------------------------------------------------------------------------
# LDA (batch variational Bayes)
# ---------------------------------------------------------------------------

def _build_corpus(docs, vocab_size: int):
    from collections import Counter

    counts = Counter()
    tokenized = []
    for doc in docs:
        toks = str(doc).split() if doc is not None else []
        tokenized.append(toks)
        counts.update(toks)
    vocab = [w for w, _ in counts.most_common(vocab_size)]
    w2i = {w: i for i, w in enumerate(vocab)}
    return _doc_term_counts(tokenized, w2i), vocab


def _doc_term_counts(tokenized, w2i) -> np.ndarray:
    """(docs, vocab) float32 counts of the in-vocabulary tokens, as the
    reference's ``X[i, j] += 1.0`` per token makes them (exact integers),
    in one scatter-add."""
    V = len(w2i)
    X = np.zeros((len(tokenized), V), np.float32)
    rows = np.repeat(np.arange(len(tokenized)), [len(t) for t in tokenized])
    get = w2i.get
    cols = np.fromiter((get(w, -1) for toks in tokenized for w in toks),
                       np.int64, count=rows.size)
    keep = cols >= 0
    np.add.at(X.reshape(-1), rows[keep] * V + cols[keep], 1.0)
    return X


def _exp_dirichlet(a):
    import torch

    return torch.exp(torch.special.digamma(a)
                     - torch.special.digamma(a.sum(dim=1, keepdim=True)))


def _lda_outer(lam, Xd, alpha: float, eta: float, inner_iter: int):
    """One outer iteration of batch variational Bayes (reference:
    clustering2.py:438-453): ``inner_iter`` doc-topic steps against the
    current topics, then the topic-word update. Returns (λ, γ)."""
    import torch

    n, V = Xd.shape
    k = lam.shape[0]
    elog_beta = _exp_dirichlet(lam)                           # (k, V)
    gamma = torch.full((n, k), alpha + V / k, dtype=Xd.dtype,
                       device=Xd.device)
    for _ in range(inner_iter):
        elog_theta = _exp_dirichlet(gamma)                    # (n, k)
        phinorm = elog_theta @ elog_beta + 1e-30              # (n, V)
        gamma = alpha + elog_theta * ((Xd / phinorm) @ elog_beta.T)
    elog_theta = _exp_dirichlet(gamma)
    phinorm = elog_theta @ elog_beta + 1e-30
    sstats = elog_beta * (elog_theta.T @ (Xd / phinorm))
    return eta + sstats, gamma


def _lda_init(k: int, V: int, seed: int) -> np.ndarray:
    """The reference's initial topics: numpy's gamma(100, 0.01) draws."""
    rng = np.random.default_rng(seed)
    return rng.gamma(100.0, 0.01, (k, V)).astype(np.float32)


def _lda_fit(device, X: np.ndarray, k: int, max_iter: int, inner_iter: int,
             alpha: float, eta: float, seed: int):
    """Batch variational Bayes (Hoffman et al. 2010, the same family as the
    reference's OnlineCorpusStep) — whole corpus per outer iteration, on
    ``device`` in float64 from the reference's float32 start (see the
    module docstring). Returns the float32 λ and γ."""
    import torch

    from ...common.env import resolve_device

    device = resolve_device(device)
    lam = torch.as_tensor(_lda_init(k, X.shape[1], seed),
                          device=device).double()
    Xd = torch.as_tensor(X, device=device).double()
    gamma = None
    for _ in range(max_iter):
        lam, gamma = _lda_outer(lam, Xd, alpha, eta, inner_iter)
    return lam.float().cpu().numpy(), gamma.float().cpu().numpy()


class LdaTrainBatchOp(ModelTrainOpMixin, BatchOperator, HasSelectedCol):
    """(reference: LdaTrainBatchOp.java:176-240 — online variational method)"""

    TOPIC_NUM = ParamInfo("topicNum", int, default=10,
                          validator=MinValidator(2), aliases=("k",))
    NUM_ITER = ParamInfo("numIter", int, default=20, validator=MinValidator(1))
    VOCAB_SIZE = ParamInfo("vocabSize", int, default=10000)
    ALPHA = ParamInfo("alpha", float, default=-1.0)
    BETA = ParamInfo("beta", float, default=-1.0)
    RANDOM_SEED = ParamInfo("randomSeed", int, default=0, aliases=("seed",))

    _min_inputs = 1
    _max_inputs = 1

    def _static_meta_keys(self, in_schema):
        return {"modelName": "LdaModel"}

    def _execute_impl(self, t: MTable) -> MTable:
        col = self.get(HasSelectedCol.SELECTED_COL)
        k = self.get(self.TOPIC_NUM)
        alpha = self.get(self.ALPHA)
        beta = self.get(self.BETA)
        alpha = 50.0 / k if alpha <= 0 else alpha
        beta = 0.01 if beta <= 0 else beta
        X, vocab = _build_corpus(t.col(col), self.get(self.VOCAB_SIZE))
        lam, _ = _lda_fit(self.env.device, X, k, self.get(self.NUM_ITER), 50,
                          alpha, beta, self.get(self.RANDOM_SEED))
        meta = {
            "modelName": "LdaModel", "topicNum": k,
            "selectedCol": col, "vocab": vocab,
            "alpha": alpha, "beta": beta,
        }
        return model_to_table(meta, {"topicWord": lam})


def _lda_theta(X, beta_norm, alpha: float, k: int):
    """The 30-step fixed point of the doc-topic distribution against the
    learned topics (reference: clustering2.py:522-527, float64 θ)."""
    import torch

    theta = torch.full((X.shape[0], k), 1.0 / k, dtype=torch.float64,
                       device=X.device)
    for _ in range(30):
        phinorm = theta @ beta_norm + 1e-30
        theta = alpha + theta * ((X / phinorm) @ beta_norm.T)
        theta = theta / theta.sum(dim=1, keepdim=True)
    return theta


class LdaModelMapper(RichModelMapper):
    """Infers the doc-topic distribution for new documents (reference:
    common/clustering/LdaModelMapper.java); the fixed point runs on the
    device, in float64 as the reference's numpy θ."""

    def load_model(self, model: MTable):
        import torch

        from ...common.env import resolve_device

        self.meta, arrays = table_to_model(model)
        lam = arrays["topicWord"]
        self.beta_norm = lam / lam.sum(axis=1, keepdims=True)
        self._device = resolve_device(self.device)
        self._beta_norm = torch.as_tensor(self.beta_norm,
                                          device=self._device).double()
        self.w2i = {w: i for i, w in enumerate(self.meta["vocab"])}
        return self

    def _pred_type(self) -> str:
        return AlinkTypes.LONG

    def predict_block(self, t: MTable):
        import torch

        col = self.meta["selectedCol"]
        k = self.meta["topicNum"]
        X = _doc_term_counts([str(doc).split() if doc is not None else []
                              for doc in t.col(col)], self.w2i)
        theta = _lda_theta(torch.as_tensor(X, device=self._device).double(),
                           self._beta_norm, self.meta["alpha"], k)
        theta = theta.cpu().numpy()
        pred = theta.argmax(axis=1).astype(np.int64)
        detail = None
        if self.get(HasPredictionDetailCol.PREDICTION_DETAIL_COL):
            detail = detail_json(list(range(k)), theta)
        return pred, AlinkTypes.LONG, detail


class LdaPredictBatchOp(ModelMapBatchOp, HasPredictionCol,
                        HasPredictionDetailCol, HasReservedCols):
    mapper_cls = LdaModelMapper


# ---------------------------------------------------------------------------
# KModes
# ---------------------------------------------------------------------------

class KModesTrainBatchOp(ModelTrainOpMixin, BatchOperator, HasSelectedCols):
    """Categorical k-modes (reference: KModesTrainBatchOp.java)."""

    K = ParamInfo("k", int, default=2, validator=MinValidator(2))
    MAX_ITER = ParamInfo("maxIter", int, default=30, validator=MinValidator(1))
    RANDOM_SEED = ParamInfo("randomSeed", int, default=0, aliases=("seed",))

    _min_inputs = 1
    _max_inputs = 1

    def _static_meta_keys(self, in_schema):
        return {"modelName": "KModesModel"}

    def _execute_impl(self, t: MTable) -> MTable:
        cols = list(self.get(HasSelectedCols.SELECTED_COLS) or t.names)
        k = self.get(self.K)
        rng = np.random.default_rng(self.get(self.RANDOM_SEED))
        S = np.stack([np.asarray(t.col(c), object).astype(str) for c in cols],
                     axis=1)
        n, d = S.shape
        modes = S[rng.choice(n, k, replace=False)].copy()
        for _ in range(self.get(self.MAX_ITER)):
            dist = (S[:, None, :] != modes[None]).sum(axis=2)
            a = dist.argmin(axis=1)
            new_modes = modes.copy()
            for ci in range(k):
                member = S[a == ci]
                if member.size == 0:
                    continue
                for j in range(d):
                    vals, counts = np.unique(member[:, j], return_counts=True)
                    new_modes[ci, j] = vals[counts.argmax()]
            if (new_modes == modes).all():
                break
            modes = new_modes
        meta = {"modelName": "KModesModel", "selectedCols": cols, "k": k,
                "modes": [list(row) for row in modes]}
        return model_to_table(meta, {})


class KModesModelMapper(RichModelMapper):
    def load_model(self, model: MTable):
        self.meta, _ = table_to_model(model)
        self.modes = np.asarray(self.meta["modes"], object)
        return self

    def _pred_type(self) -> str:
        return AlinkTypes.LONG

    def predict_block(self, t: MTable):
        cols = self.meta["selectedCols"]
        S = np.stack([np.asarray(t.col(c), object).astype(str) for c in cols],
                     axis=1)
        dist = (S[:, None, :] != self.modes[None]).sum(axis=2)
        return dist.argmin(axis=1).astype(np.int64), AlinkTypes.LONG, None


class KModesPredictBatchOp(ModelMapBatchOp, HasPredictionCol,
                           HasReservedCols):
    mapper_cls = KModesModelMapper


# ---------------------------------------------------------------------------
# Agnes (agglomerative)
# ---------------------------------------------------------------------------

class AgnesBatchOp(BatchOperator, HasVectorCol, HasFeatureCols,
                   HasPredictionCol, HasReservedCols):
    """Agglomerative clustering cut at k clusters; appends the cluster id
    (reference: AgnesBatchOp.java — linkage MIN/MAX/AVERAGE)."""

    K = ParamInfo("k", int, default=2, validator=MinValidator(1))
    LINKAGE = ParamInfo("linkage", str, default="AVERAGE",
                        validator=InValidator("MIN", "MAX", "AVERAGE"))

    _min_inputs = 1
    _max_inputs = 1

    def _execute_impl(self, t: MTable) -> MTable:
        X = get_feature_block(t, self).astype(np.float64)
        n = X.shape[0]
        k = int(self.get(self.K))
        linkage = self.get(self.LINKAGE)
        D = ((X[:, None, :] - X[None]) ** 2).sum(axis=2) ** 0.5
        np.fill_diagonal(D, np.inf)
        active = {i: [i] for i in range(n)}
        while len(active) > k:
            keys = list(active.keys())
            best = (np.inf, None, None)
            for ai in range(len(keys)):
                for bi in range(ai + 1, len(keys)):
                    a, b = keys[ai], keys[bi]
                    block = D[np.ix_(active[a], active[b])]
                    if linkage == "MIN":
                        v = block.min()
                    elif linkage == "MAX":
                        v = block.max()
                    else:
                        v = block.mean()
                    if v < best[0]:
                        best = (v, a, b)
            _, a, b = best
            active[a] = active[a] + active.pop(b)
        labels = np.empty(n, np.int64)
        for cid, idxs in enumerate(active.values()):
            labels[np.asarray(idxs)] = cid
        pred_col = self.get(HasPredictionCol.PREDICTION_COL)
        return t.with_column(pred_col, labels, AlinkTypes.LONG)

    def _out_schema(self, in_schema):
        return _append_pred_schema(self, in_schema)


class GroupKMeansBatchOp(BatchOperator, HasFeatureCols, HasPredictionCol,
                         HasReservedCols):
    """Independent KMeans per group key (reference:
    operator/batch/clustering/GroupKMeansBatchOp.java); each group's
    assignment on the device, on float64 distances as the KMeans slice's."""

    GROUP_COL = ParamInfo("groupCol", str, optional=False)
    K = ParamInfo("k", int, default=2, validator=MinValidator(2))
    MAX_ITER = ParamInfo("maxIter", int, default=30, validator=MinValidator(1))

    _min_inputs = 1
    _max_inputs = 1

    def _execute_impl(self, t: MTable) -> MTable:
        import torch

        from ...common.env import resolve_device

        device = resolve_device(self.env.device)
        group_col = self.get(self.GROUP_COL)
        feature_cols = resolve_feature_cols(t, self, exclude=[group_col])
        X = t.to_numeric_block(feature_cols, dtype=np.float32)
        groups = np.asarray(t.col(group_col), object)
        k = self.get(self.K)
        labels = np.full(t.num_rows, -1, np.int64)
        for g in dict.fromkeys(groups):           # stable group order
            rows = np.flatnonzero(groups == g)
            Xg = X[rows]
            if Xg.shape[0] < k:
                labels[rows] = 0
                continue
            c, _, _ = _lloyd(device, Xg, k, self.get(self.MAX_ITER), 1e-4,
                             False, 0)
            d = _dists(torch.as_tensor(Xg, device=device).double(),
                       torch.as_tensor(c, device=device), "EUCLIDEAN")
            labels[rows] = torch.argmin(d, dim=1).cpu().numpy()
        pred_col = self.get(HasPredictionCol.PREDICTION_COL)
        return t.with_column(pred_col, labels, AlinkTypes.LONG)

    def _out_schema(self, in_schema):
        return _append_pred_schema(self, in_schema)


class GroupDbscanBatchOp(BatchOperator, HasFeatureCols, HasPredictionCol,
                         HasReservedCols):
    """Independent DBSCAN per group key (reference:
    operator/batch/clustering/GroupDbscanBatchOp.java)."""

    GROUP_COL = ParamInfo("groupCol", str, optional=False)
    EPSILON = ParamInfo("epsilon", float, optional=False)
    MIN_POINTS = ParamInfo("minPoints", int, default=4,
                           validator=MinValidator(1))

    _min_inputs = 1
    _max_inputs = 1

    def _execute_impl(self, t: MTable) -> MTable:
        group_col = self.get(self.GROUP_COL)
        feature_cols = resolve_feature_cols(t, self, exclude=[group_col])
        groups = np.asarray(t.col(group_col), object)
        labels = np.full(t.num_rows, -1, np.int64)
        sub = DbscanBatchOp(epsilon=self.get(self.EPSILON),
                            minPoints=self.get(self.MIN_POINTS),
                            featureCols=feature_cols)
        for g in dict.fromkeys(groups):
            rows = np.flatnonzero(groups == g)
            cols = {c: np.asarray(t.col(c))[rows] for c in feature_cols}
            out = sub._execute_impl(MTable(cols))
            labels[rows] = np.asarray(out.col(
                sub.get(HasPredictionCol.PREDICTION_COL)), np.int64)
        pred_col = self.get(HasPredictionCol.PREDICTION_COL)
        return t.with_column(pred_col, labels, AlinkTypes.LONG)

    def _out_schema(self, in_schema):
        return _append_pred_schema(self, in_schema)


# ---------------------------------------------------------------------------
# SOM
# ---------------------------------------------------------------------------

def _som_fit(device, X: np.ndarray, xdim: int, ydim: int, num_steps: int,
             sigma0: float, lr0: float, seed: int) -> np.ndarray:
    """Batch SOM training on ``device`` (reference: clustering2.py:736-774,
    common/statistics/SomJni.java — pure-Java SOM despite the name).
    Returns (xdim*ydim, d) unit weights."""
    import math

    import torch

    from ...common.env import resolve_device

    device = resolve_device(device)
    n, d = X.shape
    u = xdim * ydim
    gx, gy = np.meshgrid(np.arange(xdim), np.arange(ydim), indexing="ij")
    grid = np.stack([gx.ravel(), gy.ravel()], axis=1).astype(np.float32)
    rng = np.random.default_rng(seed)
    w = torch.as_tensor(X[rng.choice(n, u, replace=n < u)].astype(np.float32),
                        device=device)
    Xd = torch.as_tensor(X, dtype=torch.float32, device=device)
    grid_d = torch.as_tensor(grid, device=device)
    batch = min(256, n)
    for s in range(num_steps):
        # the schedule in float32, as the reference's traced step computes it
        frac = np.float32(s) / np.float32(num_steps)
        decay = np.float32(math.exp(-3.0 * float(frac)))
        sigma = np.float32(sigma0) * decay + np.float32(0.5)
        lr = np.float32(lr0) * decay + np.float32(1e-3)
        start = (s * batch) % max(n - batch + 1, 1)
        xb = Xd[start:start + batch]
        d2 = ((xb[:, None, :] - w[None]) ** 2).sum(-1)        # (b, u)
        bmu = torch.argmin(d2, dim=1)
        gd2 = ((grid_d[bmu][:, None, :] - grid_d[None]) ** 2).sum(-1)
        h = torch.exp(-gd2 / float(np.float32(2.0) * sigma * sigma))
        num = h.T @ xb                                        # (u, d)
        den = h.sum(0)[:, None]
        target = num / torch.clamp(den, min=1e-9)
        blend = float(lr) * torch.clamp(den, max=1.0)
        w = w + blend * (target - w)
    return w.cpu().numpy()


class SomTrainBatchOp(ModelTrainOpMixin, BatchOperator, HasVectorCol,
                      HasFeatureCols):
    """Self-organizing map (reference: operator/batch/statistics/
    SomBatchOp.java + common/statistics/SomJni.java)."""

    XDIM = ParamInfo("xdim", int, default=4, validator=MinValidator(1))
    YDIM = ParamInfo("ydim", int, default=4, validator=MinValidator(1))
    NUM_ITERS = ParamInfo("numIters", int, default=200)
    SIGMA = ParamInfo("sigma", float, default=2.0)
    LEARN_RATE = ParamInfo("learnRate", float, default=0.5)
    RANDOM_SEED = ParamInfo("randomSeed", int, default=0, aliases=("seed",))

    _min_inputs = 1
    _max_inputs = 1

    def _static_meta_keys(self, in_schema):
        return {"modelName": "SomModel"}

    def _execute_impl(self, t: MTable) -> MTable:
        feature_cols = (None if self.get(HasVectorCol.VECTOR_COL)
                        else resolve_feature_cols(t, self))
        X = get_feature_block(t, self).astype(np.float32)
        xdim, ydim = self.get(self.XDIM), self.get(self.YDIM)
        w = _som_fit(self.env.device, X, xdim, ydim, self.get(self.NUM_ITERS),
                     self.get(self.SIGMA), self.get(self.LEARN_RATE),
                     self.get(self.RANDOM_SEED))
        meta = {"modelName": "SomModel", "xdim": xdim, "ydim": ydim,
                "vectorCol": self.get(HasVectorCol.VECTOR_COL),
                "featureCols": feature_cols, "dim": int(X.shape[1])}
        return model_to_table(meta, {"weights": w})


class SomPredictBatchOp(ModelMapBatchOp, HasPredictionCol, HasReservedCols):
    """Maps each row to its best-matching unit id (row-major grid index)."""

    class _Mapper(RichModelMapper):
        def load_model(self, model):
            self.meta, arrays = table_to_model(model)
            self.weights = arrays["weights"].astype(np.float32)
            return self

        def _pred_type(self):
            return AlinkTypes.LONG

        def predict_block(self, t):
            X = get_feature_block(
                t, merge_feature_params(self.get_params(), self.meta),
                vector_size=self.meta["dim"]).astype(np.float32)
            d2 = ((X[:, None, :] - self.weights[None]) ** 2).sum(-1)
            return d2.argmin(axis=1).astype(np.int64), AlinkTypes.LONG, None

    mapper_cls = _Mapper


# ---------------------------------------------------------------------------
# Geo DBSCAN and grouped EM
# ---------------------------------------------------------------------------

class GroupGeoDbscanBatchOp(BatchOperator, HasPredictionCol, HasReservedCols):
    """Independent DBSCAN per group over (lat, lon) with great-circle
    distances in kilometers (reference: operator/batch/clustering/
    GroupGeoDbscanBatchOp.java)."""

    GROUP_COL = ParamInfo("groupCols", list, aliases=("groupCol",),
                          optional=False)
    LATITUDE_COL = ParamInfo("latitudeCol", str, default="latitude")
    LONGITUDE_COL = ParamInfo("longitudeCol", str, default="longitude")
    EPSILON = ParamInfo("epsilon", float, optional=False,
                        desc="neighborhood radius in kilometers")
    MIN_POINTS = ParamInfo("minPoints", int, default=4,
                           validator=MinValidator(1))

    _min_inputs = 1
    _max_inputs = 1

    @staticmethod
    def _geo_cluster(lat, lon, eps_km, min_pts, device=None):
        import torch

        from ...common.env import resolve_device
        from .clustering import _haversine_dists

        X = torch.as_tensor(np.stack([lat, lon], axis=1),
                            device=resolve_device(device))
        D = _haversine_dists(X, X).cpu().numpy()
        n = len(lat)
        neighbors = [list(set(np.nonzero(D[i] <= eps_km)[0].tolist())
                          - {i}) for i in range(n)]
        core = np.asarray([len(nb) + 1 >= min_pts for nb in neighbors])
        return _expand_clusters(neighbors, core)

    def _execute_impl(self, t: MTable) -> MTable:
        lat = np.asarray(t.col(self.get(self.LATITUDE_COL)), np.float64)
        lon = np.asarray(t.col(self.get(self.LONGITUDE_COL)), np.float64)
        eps = float(self.get(self.EPSILON))
        min_pts = int(self.get(self.MIN_POINTS))
        index, order = _group_row_indices(
            t, _coerce_group_cols(self.get(self.GROUP_COL)))
        labels = np.full(t.num_rows, -1, np.int64)
        for key in order:
            rows = np.asarray(index[key])
            labels[rows] = self._geo_cluster(lat[rows], lon[rows], eps,
                                             min_pts, self.env.device)
        pred_col = self.get(HasPredictionCol.PREDICTION_COL)
        return t.with_column(pred_col, labels, AlinkTypes.LONG)

    def _out_schema(self, in_schema):
        return _append_pred_schema(self, in_schema)


class GroupGeoDbscanModelBatchOp(BatchOperator):
    """Per-group geo-DBSCAN models: clustered (lat, lon) points with group
    keys + cluster ids, persisted in the DbscanModel format (reference:
    operator/batch/clustering/GroupGeoDbscanModelBatchOp.java)."""

    GROUP_COL = GroupGeoDbscanBatchOp.GROUP_COL
    LATITUDE_COL = GroupGeoDbscanBatchOp.LATITUDE_COL
    LONGITUDE_COL = GroupGeoDbscanBatchOp.LONGITUDE_COL
    EPSILON = GroupGeoDbscanBatchOp.EPSILON
    MIN_POINTS = GroupGeoDbscanBatchOp.MIN_POINTS

    _min_inputs = 1
    _max_inputs = 1

    def _out_schema(self, in_schema):
        from ...common.model import MODEL_SCHEMA

        return MODEL_SCHEMA

    def _execute_impl(self, t: MTable) -> MTable:
        lat_col = self.get(self.LATITUDE_COL)
        lon_col = self.get(self.LONGITUDE_COL)
        lat = np.asarray(t.col(lat_col), np.float64)
        lon = np.asarray(t.col(lon_col), np.float64)
        eps = float(self.get(self.EPSILON))
        min_pts = int(self.get(self.MIN_POINTS))
        group_cols = _coerce_group_cols(self.get(self.GROUP_COL))
        index, order = _group_row_indices(t, group_cols)
        pts, labs, gids = [], [], []
        keys = []
        for gid, key in enumerate(order):
            rows = np.asarray(index[key])
            lab = GroupGeoDbscanBatchOp._geo_cluster(
                lat[rows], lon[rows], eps, min_pts, self.env.device)
            keep = lab >= 0
            pts.append(np.stack([lat[rows][keep], lon[rows][keep]], axis=1))
            labs.append(lab[keep])
            gids.append(np.full(int(keep.sum()), gid, np.int64))
            keys.append("\x01".join(str(v) for v in key))
        meta = {"modelName": "DbscanModel", "epsilon": eps,
                "minPoints": min_pts, "geo": True,
                "featureCols": [lat_col, lon_col], "vectorCol": None,
                "dim": 2, "groupCols": group_cols, "groupKeys": keys}
        return model_to_table(meta, {
            "points": (np.concatenate(pts) if pts else np.zeros((0, 2))),
            "labels": (np.concatenate(labs) if labs
                       else np.zeros(0, np.int64)),
            "groups": (np.concatenate(gids) if gids
                       else np.zeros(0, np.int64)),
        })


class GroupEmBatchOp(BatchOperator, HasFeatureCols, HasPredictionCol,
                     HasReservedCols):
    """Independent Gaussian-mixture EM per group key, diagonal covariance,
    host-side as in the reference (reference: operator/batch/clustering/
    GroupEmBatchOp.java)."""

    GROUP_COL = ParamInfo("groupCols", list, aliases=("groupCol",),
                          optional=False)
    K = ParamInfo("k", int, default=2, validator=MinValidator(1))
    MAX_ITER = ParamInfo("maxIter", int, default=50,
                         validator=MinValidator(1))
    RANDOM_SEED = ParamInfo("randomSeed", int, default=0, aliases=("seed",))

    _min_inputs = 1
    _max_inputs = 1

    def _execute_impl(self, t: MTable) -> MTable:
        group_cols = _coerce_group_cols(self.get(self.GROUP_COL))
        feature_cols = resolve_feature_cols(t, self, exclude=group_cols)
        X = t.to_numeric_block(feature_cols, dtype=np.float64)
        k = int(self.get(self.K))
        index, order = _group_row_indices(t, group_cols)
        labels = np.zeros(t.num_rows, np.int64)
        for key in order:
            rows = np.asarray(index[key])
            Xg = X[rows]
            if len(rows) <= k:
                labels[rows] = np.arange(len(rows)) % max(k, 1)
                continue
            labels[rows] = self._em(Xg, k)
        pred_col = self.get(HasPredictionCol.PREDICTION_COL)
        return t.with_column(pred_col, labels, AlinkTypes.LONG)

    def _em(self, X: np.ndarray, k: int) -> np.ndarray:
        rng = np.random.default_rng(self.get(self.RANDOM_SEED))
        n, d = X.shape
        mu = X[rng.choice(n, k, replace=False)]
        var = np.full((k, d), X.var(0) + 1e-6)
        pi = np.full(k, 1.0 / k)
        resp = None
        for _ in range(int(self.get(self.MAX_ITER))):
            # diagonal-covariance E step
            log_p = (-0.5 * (((X[:, None, :] - mu[None]) ** 2 / var[None])
                             + np.log(2 * np.pi * var[None])).sum(-1)
                     + np.log(pi)[None, :])
            m = log_p.max(1, keepdims=True)
            resp = np.exp(log_p - m)
            resp /= resp.sum(1, keepdims=True)
            nk = resp.sum(0) + 1e-9
            mu_new = (resp.T @ X) / nk[:, None]
            var = ((resp[:, :, None] * (X[:, None, :] - mu_new[None]) ** 2
                    ).sum(0) / nk[:, None]) + 1e-6
            pi = nk / n
            if np.allclose(mu, mu_new, atol=1e-7):
                mu = mu_new
                break
            mu = mu_new
        return resp.argmax(1).astype(np.int64)

    def _out_schema(self, in_schema):
        return _append_pred_schema(self, in_schema)
