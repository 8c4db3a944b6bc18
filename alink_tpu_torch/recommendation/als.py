"""Alternating Least Squares matrix factorization on the device (port of
``alink_tpu.recommendation.als``).

Capability parity with the reference's block ALS (reference:
core/src/main/java/com/alibaba/alink/operator/common/recommendation/
HugeMfAlsImpl.java:326 — block-partitioned alternating sweeps; normal
equations per user/item block at :409-438; implicit-preference variant per
Hu/Koren/Volinsky).

Ratings are laid out as padded per-entity neighbour lists (ragged →
rectangular): for every user a fixed-width row of rated item ids + ratings
+ mask, in input order (a stable sort by entity builds them in bulk; the
hot-point cap draws from ``default_rng(seed + 1)`` entity by entity, as
the reference). A half-sweep gathers the opposite side's factors into
(n, D, k), builds every k×k Gramian with one batched product, adds λI
(ALS-WR: λ·max(cnt, 1)), or for the implicit variant YᵀY + α-weighted
terms, and solves all systems with LU (``torch.linalg.solve``).

The Gramians, right-hand sides and solves run in float64 over the float32
factors, and each half-sweep's factors are rounded back to float32 (the
reference's carried precision). Rows go in blocks whose gather holds at
most ``GATHER_ELEMENTS`` entries, so the (n, D, k) gather stays bounded;
in float64 a batched product's summation order (which a GEMM may choose by
its batch count, and which differs between the card and the CPU) stays far
below a float32 rounding, so blocks give the unblocked factors and the
card gives the CPU route's. The port runs on one device; multi-rank ALS
waits for ROADMAP A3.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

# one gather block holds at most this many float64 entries (1 GiB)
GATHER_ELEMENTS = 1 << 27


@dataclass
class AlsModelData:
    user_ids: np.ndarray     # original user id values (n_users,)
    item_ids: np.ndarray     # original item id values (n_items,)
    user_factors: np.ndarray  # (n_users, k) float32
    item_factors: np.ndarray  # (n_items, k) float32


def build_lists(ent: np.ndarray, other: np.ndarray, r: np.ndarray,
                count: int, max_neighbors: int = 0, cap_rng=None
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-entity neighbour lists → (ids, ratings, mask) rectangles of
    width D = the largest (capped) degree: each entity's pairs in input
    order, or, above ``max_neighbors``, in the order ``cap_rng.choice``
    picks them, entities drawn in ascending order (the reference's dict
    order)."""
    order = np.argsort(ent, kind="stable")
    deg = np.bincount(ent, minlength=count)
    starts = np.zeros(count, np.int64)
    np.cumsum(deg[:-1], out=starts[1:])
    oth, val = other[order], r[order]
    capped = (np.flatnonzero(deg > max_neighbors) if max_neighbors
              and max_neighbors > 0 else np.zeros(0, np.int64))
    width = deg.copy()
    width[capped] = max_neighbors
    D = max(int(width.max(initial=0)), 1)
    ids = np.zeros((count, D), np.int32)
    rts = np.zeros((count, D), np.float32)
    mask = np.zeros((count, D), np.float32)
    keep = np.ones(len(ent), bool)
    for e in capped:
        pick = starts[e] + cap_rng.choice(int(deg[e]), max_neighbors,
                                          replace=False)
        ids[e, :max_neighbors] = oth[pick]
        rts[e, :max_neighbors] = val[pick]
        mask[e, :max_neighbors] = 1.0
        keep[starts[e]:starts[e] + deg[e]] = False
    rows = ent[order][keep]
    pos = (np.arange(len(ent)) - np.repeat(starts, deg))[keep]
    ids[rows, pos] = oth[keep]
    rts[rows, pos] = val[keep]
    mask[rows, pos] = 1.0
    return ids, rts, mask


def block_rows(n: int, D: int, k: int) -> int:
    """Entities a half-sweep block gathers: (rows, D, k) ≤ GATHER_ELEMENTS."""
    return max(1, min(n, GATHER_ELEMENTS // max(D * k, 1)))


def half_sweep(ids, rts, mask, cnt, right, *, lam: float, implicit: bool,
               alpha: float, rows: Optional[int] = None):
    """Solve all 'left' factors given the 'right' factors (float32, on the
    device): ids (n, D) int64, rts/mask (n, D) and cnt (n,) float64 tensors
    on the same device. Blocks of ``rows`` entities (default
    :func:`block_rows`). Returns (n, k) float32."""
    import torch

    n, D = ids.shape
    k = right.shape[1]
    R = right.double()
    eye = torch.eye(k, dtype=torch.float64, device=R.device)
    yty = R.T @ R if implicit else None
    rows = rows or block_rows(n, D, k)
    out = torch.empty((n, k), dtype=torch.float32, device=R.device)
    for s in range(0, n, rows):
        e = slice(s, s + rows)
        V = R[ids[e]]                                   # (b, D, k)
        c = cnt[e]
        if implicit:
            conf = alpha * rts[e] * mask[e]             # c - 1
            A = torch.bmm((V * conf[..., None]).transpose(1, 2), V)
            A = A + yty + (lam * c)[:, None, None] * eye
            w = (1.0 + conf) * mask[e]
        else:
            A = torch.bmm((V * mask[e][..., None]).transpose(1, 2), V)
            A = A + (lam * torch.clamp(c, min=1.0))[:, None, None] * eye
            w = rts[e] * mask[e]
        b = torch.bmm(V.transpose(1, 2), w[..., None])  # (b, k, 1)
        sol = torch.linalg.solve(A, b)[..., 0]
        out[e] = torch.where(c[:, None] > 0, sol, 0.0).float()
        del V, A, b, sol
    return out


def train_als(
    users: np.ndarray,
    items: np.ndarray,
    ratings: np.ndarray,
    *,
    rank: int = 10,
    num_iter: int = 10,
    lam: float = 0.1,
    implicit: bool = False,
    alpha: float = 40.0,
    seed: int = 0,
    max_neighbors: int = 0,
    device=None,
) -> AlsModelData:
    """Factorize sparse (user, item, rating) triples on ``device`` (see
    :func:`~alink_tpu_torch.common.env.resolve_device`). λ is scaled by
    each entity's rating count (ALS-WR weighting, matching the reference).

    ``max_neighbors > 0`` caps each entity's padded neighbor list by random
    subsampling — the hot-point strategy: one viral item/user otherwise sets
    the rectangle width D for EVERY row of the sweep (reference:
    AlsForHotPointTrainBatchOp.java / MfAlsForHotPointBatchOp.java)."""
    import torch

    from ..common.env import resolve_device

    dev = resolve_device(device)
    u_ids, u_inv = np.unique(users, return_inverse=True)
    i_ids, i_inv = np.unique(items, return_inverse=True)
    u_inv, i_inv = u_inv.reshape(-1), i_inv.reshape(-1)
    n_u, n_i = len(u_ids), len(i_ids)
    r = np.asarray(ratings, np.float32)

    cap_rng = (np.random.default_rng(seed + 1)
               if max_neighbors and max_neighbors > 0 else None)
    user_side = build_lists(u_inv, i_inv, r, n_u, max_neighbors, cap_rng)
    item_side = build_lists(i_inv, u_inv, r, n_i, max_neighbors, cap_rng)

    rng = np.random.default_rng(seed)
    scale = 1.0 / np.sqrt(rank)
    U = (rng.standard_normal((n_u, rank)) * scale).astype(np.float32)
    V = (rng.standard_normal((n_i, rank)) * scale).astype(np.float32)

    def stage(side):
        ids, rts, mask = side
        return (torch.as_tensor(ids, device=dev).long(),
                torch.as_tensor(rts, device=dev).double(),
                torch.as_tensor(mask, device=dev).double(),
                torch.as_tensor(mask.sum(1), device=dev).double())

    u_in, i_in = stage(user_side), stage(item_side)
    del user_side, item_side
    Ut = torch.as_tensor(U, device=dev)
    Vt = torch.as_tensor(V, device=dev)
    kw = dict(lam=float(lam), implicit=bool(implicit), alpha=float(alpha))
    for _ in range(num_iter):
        Ut = half_sweep(*u_in, Vt, **kw)
        Vt = half_sweep(*i_in, Ut, **kw)
    return AlsModelData(u_ids, i_ids, Ut.cpu().numpy(), Vt.cpu().numpy())
