"""Random walks over graphs, corpus generators for DeepWalk/Node2Vec.

A copy of the host-numpy walks of ``alink_tpu.embedding.walks``: the port
keeps its own, so that it imports nothing of the JAX package.
:func:`line_embeddings` trains LINE through the huge-embedding engine.

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


def line_embeddings(
    src: np.ndarray,
    dst: np.ndarray,
    num_nodes: int,
    dim: int = 64,
    order: int = 2,
    num_negatives: int = 5,
    num_steps: int = 2000,
    batch_size: int = 512,
    learning_rate: float = 0.025,
    seed: int = 0,
    *,
    engine: Optional[str] = None,
    device=None,
    hot_rows: Optional[int] = None,
    negatives: Optional[np.ndarray] = None,
) -> np.ndarray:
    """LINE first/second-order proximity embeddings (reference:
    operator/batch/graph/LineBatchOp + huge LINE impl).

    LINE is SGNS over edge mini-batches — order=2 trains a separate context
    table, order=1 ties both sides to ONE table — so it rides the shared
    huge-embedding engine (``embedding/skipgram.py``) on ``device``: on the
    card one ``sgns_pull_grads`` launch a step. Negatives are uniform over
    nodes. One process is one rank, so the batch is clamped to
    ``min(batch_size, E)``: one block never tiles the edge set into
    duplicate scatter-adds (which would multiply the effective learning
    rate), and the shuffled tail shorter than a block is dropped.
    ``negatives``: the tests' replay of a given negative stream,
    (num_steps, B, num_negatives)."""
    from ..common.env import resolve_device
    from .engine import huge_engine
    from .skipgram import _prep_pairs, _run_pairs_host, _run_pairs_sharded

    rng = np.random.default_rng(seed)
    E = src.shape[0]
    if E == 0:
        resolve_device(device)
        return ((rng.random((num_nodes, dim)) - 0.5) / dim).astype(np.float32)
    eng = huge_engine(engine)
    ndev = 1
    B = max(1, min(batch_size, E // ndev))
    edges = np.stack([src, dst], axis=1).astype(np.int32)
    edges, n_batches = _prep_pairs(edges, B, ndev, seed)
    common = dict(tie=order != 2, neg_logits=None, neg_v=num_nodes,
                  device=device, negatives=negatives)
    if eng == "host":
        return _run_pairs_host(
            edges, num_nodes, dim, B, num_negatives, num_steps, n_batches,
            learning_rate, seed, **common)
    # the reference also passes probs=deg + 1, which only sizes the
    # multi-rank exchange's buckets: one rank passes none (ROADMAP A3)
    handle = _run_pairs_sharded(
        edges, num_nodes, dim, B, num_negatives, num_steps, n_batches,
        learning_rate, seed, hot_rows=hot_rows, **common)
    return handle.to_numpy()
