"""Neighborhood collaborative filtering: ItemCF / UserCF / Swing (port of
``alink_tpu.recommendation.cf``).

Capability parity with the reference (reference:
operator/common/recommendation/ItemCfRecommTrainKernel + batch ops
operator/batch/recommendation/ItemCfTrainBatchOp.java,
UserCfTrainBatchOp.java, SwingTrainBatchOp.java — co-occurrence similarity
top-K tables; swing similarity Σ 1/(α+|I_u ∩ I_v|) over user pairs).

The interaction matrix is dense on the host, as the reference's; the
similarity matrix is one chunked product R̂ᵀR̂_b on the device per 2,048
columns (cosine: column-normalized R̂; jaccard: co-counts / (|i|+|j|-co)
with the 1e-12 floor), each product summed in float64 over the float32
entries and rounded to float32, so the card gives the CPU route's
similarities and a chunk gives the whole matrix's. The self entry is
masked with -inf (0 after the top-K), and each column's K largest are
taken in ``lax.top_k``'s order (ties to the lower index). Swing's
user-pair structure stays on the host, the reference's loop over
``np.intersect1d``, with the user cap drawn from ``default_rng(0)``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def _encode(users, items):
    u_ids, u_inv = np.unique(users, return_inverse=True)
    i_ids, i_inv = np.unique(items, return_inverse=True)
    return u_ids, u_inv.reshape(-1), i_ids, i_inv.reshape(-1)


def largest_k(s, k: int):
    """The k largest entries of each row of ``s`` (indices, values) in
    ``lax.top_k``'s order: descending, equal values by ascending index."""
    from ..operator.batch.similarity import smallest_k

    idx, vals = smallest_k(-s, k)
    return idx, -vals


def interaction_similarity(
    users: np.ndarray, items: np.ndarray, ratings: Optional[np.ndarray] = None,
    *, kind: str = "item", metric: str = "cosine", top_k: int = 64,
    chunk: int = 2048, device=None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Top-K similarity lists. Returns (entity_ids, other_ids_matrix (n,K),
    sims (n,K), counts). kind='item' → item-item over user co-occurrence;
    kind='user' → user-user."""
    import torch

    from ..common.env import resolve_device

    dev = resolve_device(device)
    u_ids, u_inv, i_ids, i_inv = _encode(users, items)
    if kind == "user":
        # swap roles: similarity between users
        u_ids, i_ids = i_ids, u_ids
        u_inv, i_inv = i_inv, u_inv
    n_u, n_i = len(u_ids), len(i_ids)
    vals = (np.asarray(ratings, np.float32) if ratings is not None
            else np.ones(len(u_inv), np.float32))
    R = np.zeros((n_u, n_i), np.float32)  # rows: co-occurrence axis
    R[u_inv, i_inv] = vals if metric == "cosine" else 1.0

    if metric == "cosine":
        norms = np.sqrt((R * R).sum(0))
        Rn = R / np.maximum(norms, 1e-12)
    else:
        Rn = R

    K = min(top_k, n_i - 1) if n_i > 1 else 1
    Rt = torch.as_tensor(Rn, device=dev).double()
    counts_all = torch.as_tensor(Rn.sum(0).astype(np.float32), device=dev)
    sims = np.zeros((n_i, K), np.float32)
    nbrs = np.zeros((n_i, K), np.int64)
    rows = torch.arange(n_i, device=dev)[:, None]
    for c0 in range(0, n_i, chunk):
        c1 = min(c0 + chunk, n_i)
        s = (Rt.T @ Rt[:, c0:c1]).float()               # (n_i, b)
        if metric == "jaccard":
            s = s / torch.clamp(counts_all[:, None] + counts_all[None, c0:c1]
                                - s, min=1e-12)
        cols = torch.arange(c0, c1, device=dev)
        s = torch.where(rows == cols[None, :], -torch.inf, s)
        ti, tv = largest_k(s.T.contiguous(), K)
        tv = tv.cpu().numpy()
        sims[c0:c1] = np.where(np.isfinite(tv), tv, 0.0) + 0.0
        nbrs[c0:c1] = ti.cpu().numpy()
    counts = (R != 0).sum(0)
    return i_ids, nbrs, sims, counts


def swing_similarity(
    users: np.ndarray, items: np.ndarray,
    *, alpha: float = 1.0, top_k: int = 64, max_users_per_item: int = 1000,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Swing: sim(i,j) = Σ_{u,v ∈ U_i∩U_j, u<v} 1/(α + |I_u ∩ I_v|)
    (reference: operator/common/recommendation/SwingTrainKernel semantics;
    user lists capped like the reference's userItemMaxCount)."""
    u_ids, u_inv, i_ids, i_inv = _encode(users, items)
    n_u, n_i = len(u_ids), len(i_ids)
    B = np.zeros((n_u, n_i), bool)
    B[u_inv, i_inv] = True
    overlap = B.astype(np.float32) @ B.astype(np.float32).T  # |I_u ∩ I_v|
    weight = 1.0 / (alpha + overlap)                         # (n_u, n_u)

    rng = np.random.default_rng(0)
    users_of = []
    for i in range(n_i):
        us = np.nonzero(B[:, i])[0]
        if len(us) > max_users_per_item:
            us = rng.choice(us, max_users_per_item, replace=False)
        users_of.append(us)

    sims = np.zeros((n_i, n_i), np.float32)
    for i in range(n_i):
        ui = users_of[i]
        if len(ui) < 2:
            continue
        for j in range(i + 1, n_i):
            uj = users_of[j]
            common = np.intersect1d(ui, uj, assume_unique=True)
            if len(common) < 2:
                continue
            W = weight[np.ix_(common, common)]
            s = float((np.triu(W, 1)).sum())
            sims[i, j] = sims[j, i] = s
    K = min(top_k, max(n_i - 1, 1))
    order = np.argsort(-sims, axis=1)[:, :K]
    top = np.take_along_axis(sims, order, axis=1)
    return i_ids, order.astype(np.int64), top
