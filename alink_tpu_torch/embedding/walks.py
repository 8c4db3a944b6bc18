"""Random walks over graphs, corpus generators for DeepWalk/Node2Vec.

A copy of the host-numpy walks of ``alink_tpu.embedding.walks``: the port
keeps its own, so that it imports nothing of the JAX package. The reference's
``line_embeddings`` comes with ``LineBatchOp`` (ROADMAP A6).

(reference: operator/batch/graph/DeepWalkBatchOp + walkpath/ and
storage/BaseCSRGraph.java random-walk storage; Node2Vec biased walks in
operator/batch/graph/Node2VecBatchOp + huge/impl/Node2VecImpl.)

Walks are generated host-side on a CSR adjacency (dynamic-length neighbor
lists are the classic XLA-hostile shape — SURVEY.md §7 hard parts) and the
resulting fixed-length walk matrix feeds the device-side skip-gram trainer.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def build_csr(
    src: np.ndarray, dst: np.ndarray, weights: Optional[np.ndarray] = None,
    num_nodes: Optional[int] = None, directed: bool = False,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(indptr, indices, weights) CSR from an edge list."""
    if not directed:
        src, dst = np.concatenate([src, dst]), np.concatenate([dst, src])
        if weights is not None:
            weights = np.concatenate([weights, weights])
    n = int(num_nodes or (max(src.max(), dst.max()) + 1))
    order = np.argsort(src, kind="stable")
    src, dst = src[order], dst[order]
    w = (weights[order] if weights is not None
         else np.ones(len(src), np.float32))
    indptr = np.zeros(n + 1, np.int64)
    np.add.at(indptr, src + 1, 1)
    indptr = np.cumsum(indptr)
    return indptr, dst.astype(np.int64), w.astype(np.float32)


def random_walks(
    indptr: np.ndarray, indices: np.ndarray, weights: np.ndarray,
    *, num_walks: int = 10, walk_length: int = 40, seed: int = 0,
) -> np.ndarray:
    """(num_nodes*num_walks, walk_length) uniform/weighted random walks.
    Dead-end nodes repeat in place."""
    rng = np.random.default_rng(seed)
    n = len(indptr) - 1
    starts = np.tile(np.arange(n), num_walks)
    rng.shuffle(starts)
    walks = np.empty((len(starts), walk_length), np.int64)
    walks[:, 0] = starts
    cur = starts.copy()
    uniform = bool(np.all(weights == weights[0])) if len(weights) else True
    for t in range(1, walk_length):
        deg = indptr[cur + 1] - indptr[cur]
        r = rng.random(len(cur))
        nxt = cur.copy()
        has = deg > 0
        if uniform:
            # uniform fast path: one vectorized gather for every active walk
            off = np.minimum((r[has] * deg[has]).astype(np.int64), deg[has] - 1)
            nxt[has] = indices[indptr[cur[has]] + off]
        else:
            # weighted pick: cumulative-weight inverse sampling per node
            for i in np.nonzero(has)[0]:
                s, e = indptr[cur[i]], indptr[cur[i] + 1]
                w = weights[s:e]
                cw = np.cumsum(w)
                j = np.searchsorted(cw, r[i] * cw[-1], side="right")
                nxt[i] = indices[s + min(j, e - s - 1)]
        walks[:, t] = nxt
        cur = nxt
    return walks


def node2vec_walks(
    indptr: np.ndarray, indices: np.ndarray, weights: np.ndarray,
    *, num_walks: int = 10, walk_length: int = 40,
    p: float = 1.0, q: float = 1.0, seed: int = 0,
) -> np.ndarray:
    """Biased second-order walks (Node2Vec): return prob ~ 1/p, in-out ~ 1/q."""
    rng = np.random.default_rng(seed)
    n = len(indptr) - 1
    starts = np.tile(np.arange(n), num_walks)
    rng.shuffle(starts)
    walks = np.empty((len(starts), walk_length), np.int64)
    walks[:, 0] = starts
    neigh_sets = [set(indices[indptr[v]:indptr[v + 1]].tolist())
                  for v in range(n)]
    for wi in range(len(starts)):
        prev = -1
        cur = int(starts[wi])
        for t in range(1, walk_length):
            s, e = indptr[cur], indptr[cur + 1]
            if s == e:
                walks[wi, t] = cur
                continue
            nbrs = indices[s:e]
            w = weights[s:e].astype(np.float64).copy()
            if prev >= 0:
                back = nbrs == prev
                shared = np.fromiter(
                    (x in neigh_sets[prev] for x in nbrs), bool, len(nbrs)
                )
                w[back] /= p
                w[~back & ~shared] /= q
            cw = np.cumsum(w)
            j = np.searchsorted(cw, rng.random() * cw[-1], side="right")
            nxt = int(nbrs[min(j, len(nbrs) - 1)])
            walks[wi, t] = nxt
            prev, cur = cur, nxt
    return walks


def metapath_walks(
    indptr: np.ndarray,
    indices: np.ndarray,
    node_types: np.ndarray,
    metapath: "list[str]",
    num_walks: int,
    seed: int = 0,
) -> np.ndarray:
    """Metapath-constrained random walks over a heterogeneous graph
    (reference: operator/batch/graph/MetaPathWalkBatchOp +
    huge/impl/MetaPath2VecImpl — HeteGraphEngine typed walks).

    ``node_types[v]`` is the type tag of vertex v; ``metapath`` like
    ["user", "item", "user"] constrains each step's target type; walks cycle
    the path (len = num_walks of full path traversals rooted at every vertex
    whose type matches metapath[0]). Unreachable steps truncate the walk
    (padded with -1)."""
    rng = np.random.default_rng(seed)
    n = indptr.shape[0] - 1
    walk_len = len(metapath)
    starts = np.flatnonzero(np.asarray(node_types, object).astype(str)
                            == str(metapath[0]))
    walks = []
    types = np.asarray(node_types, object).astype(str)
    for _ in range(num_walks):
        for v0 in starts:
            walk = [v0]
            cur = v0
            for hop in range(1, walk_len):
                lo, hi = indptr[cur], indptr[cur + 1]
                nbrs = indices[lo:hi]
                typed = nbrs[types[nbrs] == str(metapath[hop])]
                if typed.size == 0:
                    break
                cur = int(typed[rng.integers(typed.size)])
                walk.append(cur)
            walks.append(walk + [-1] * (walk_len - len(walk)))
    return np.asarray(walks, np.int64)
