"""Vertex-centric superstep engine over in-memory edge-list graphs (port of
``alink_tpu.graph.engine``).

Capability parity with the reference's memory graph engine (reference:
core/src/main/java/com/alibaba/alink/operator/batch/graph/memory/
MemoryVertexCentricIteration.java, MemoryEdgeListGraph.java,
storage/BaseCSRGraph.java — BSP supersteps over a per-TM shared graph with a
hand-built communication unit).

A superstep is ``state' = apply(state, scatter(msg))`` where the scatter is
one ``index_add_`` (the reference's ``segment_sum``) or ``scatter_reduce_``
with ``amin`` (its ``segment_min``) over the edge array, on the device the
caller resolves (:func:`~alink_tpu_torch.common.env.resolve_device`). The
reference runs its fixpoint loop as one ``lax.while_loop`` with the test on
the device; here the loop runs on the host, and each superstep reads its
convergence test back once (one host sync a superstep), so the loop stops
after exactly the reference's number of supersteps: at the fixpoint (a
step that changes nothing, or PageRank's L1 change at or below ``tol``) or
at ``max_iter``. A vertex that no edge reaches takes the reduction's
identity, as ``segment_min`` gives it: +inf for distances, INT32_MAX for
labels (``include_self`` with a tensor that starts from it).

On the CPU the scatter-adds run one by one in edge order, the order XLA's
CPU scatter adds in, and PageRank takes XLA's arithmetic (see
:func:`pagerank`), so on a graph without dangling vertices (TextRank's)
the ranks equal the reference's bit for bit; the dangling mass is a sum
whose order XLA picks, and there they part by float32 rounding. On the card
``index_add_`` adds duplicate indices in any order: ranks differ from the
CPU's by float32 rounding, and the stopping test can fall a superstep
apart.

Each run adds its supersteps and host syncs to the ``graph.supersteps`` and
``graph.host_syncs`` counters; inside :func:`superstep_trace` it also
records them with one CUDA event pair a superstep (on the card).

``triangles``, ``modularity`` and ``louvain`` run on the host, as in the
reference.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

INT32_MAX = 2 ** 31 - 1


class MemoryGraph:
    """Edge-list graph with contiguous int vertex ids and the original
    labels kept for output (reference: MemoryEdgeListGraph.java)."""

    def __init__(self, num_vertices: int, src: np.ndarray, dst: np.ndarray,
                 weight: Optional[np.ndarray] = None,
                 labels: Optional[np.ndarray] = None):
        self.num_vertices = int(num_vertices)
        self.src = np.asarray(src, np.int32)
        self.dst = np.asarray(dst, np.int32)
        self.weight = (np.ones_like(self.src, dtype=np.float32)
                       if weight is None else np.asarray(weight, np.float32))
        self.labels = (labels if labels is not None
                       else np.arange(num_vertices))

    @staticmethod
    def from_table(t, source_col: str, target_col: str,
                   weight_col: Optional[str] = None,
                   directed: bool = False) -> "MemoryGraph":
        # the ids as strings, factorized through a dict: the sorted labels
        # and inverse of np.unique, without sorting every endpoint
        s = list(map(str, np.asarray(t.col(source_col), object).tolist()))
        d = list(map(str, np.asarray(t.col(target_col), object).tolist()))
        labels = np.asarray(sorted(set(s).union(d)), dtype=str)
        index = {v: i for i, v in enumerate(labels.tolist())}
        src = np.fromiter(map(index.__getitem__, s), np.int32, len(s))
        dst = np.fromiter(map(index.__getitem__, d), np.int32, len(d))
        w = (np.asarray(t.col(weight_col), np.float32) if weight_col
             else np.ones(len(s), np.float32))
        if not directed:
            src, dst = np.concatenate([src, dst]), np.concatenate([dst, src])
            w = np.concatenate([w, w])
        return MemoryGraph(len(labels), src, dst, w, labels)

    def out_degree(self) -> np.ndarray:
        deg = np.zeros(self.num_vertices, np.float32)
        np.add.at(deg, self.src, self.weight)
        return deg

    def adjacency_sets(self):
        adj: Dict[int, set] = {i: set() for i in range(self.num_vertices)}
        for a, b in zip(self.src, self.dst):
            if a != b:
                adj[int(a)].add(int(b))
        return adj

    def on(self, device) -> Tuple:
        """(src, dst, weight) as int64/int64/float32 tensors on ``device``."""
        import torch

        return (torch.as_tensor(self.src.astype(np.int64), device=device),
                torch.as_tensor(self.dst.astype(np.int64), device=device),
                torch.as_tensor(self.weight, device=device))


# ---------------------------------------------------------------------------
# superstep accounting
# ---------------------------------------------------------------------------

_TRACE: Optional[List[dict]] = None
_TRACE_LOCK = threading.Lock()


@contextlib.contextmanager
def superstep_trace():
    """Collect one record a fixpoint run while the block runs, from any
    thread: ``{"fn", "n", "edges", "supersteps", "host_syncs", "events"}``,
    ``events`` one (start, end) CUDA event pair a superstep on the card
    (empty on the CPU). Read the events after a synchronize."""
    global _TRACE
    records: List[dict] = []
    with _TRACE_LOCK:
        prev, _TRACE = _TRACE, records
    try:
        yield records
    finally:
        with _TRACE_LOCK:
            _TRACE = prev


class _Run:
    """One fixpoint run's supersteps and host syncs."""

    def __init__(self, fn: str, n: int, edges: int, device):
        self.rec = {"fn": fn, "n": n, "edges": edges, "supersteps": 0,
                    "host_syncs": 0, "events": []}
        self.cuda = device.type == "cuda"
        with _TRACE_LOCK:
            self.trace = _TRACE

    @contextlib.contextmanager
    def step(self):
        ev = None
        if self.trace is not None and self.cuda:
            import torch

            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
        yield
        if ev is not None:
            ev[1].record()
            self.rec["events"].append(ev)
        self.rec["supersteps"] += 1

    def read(self, flag) -> bool:
        """The convergence test's answer on the host: one sync."""
        self.rec["host_syncs"] += 1
        return bool(flag.item())

    def done(self):
        from ..common.metrics import metrics

        metrics.incr("graph.supersteps", self.rec["supersteps"])
        metrics.incr("graph.host_syncs", self.rec["host_syncs"])
        if self.trace is not None:
            with _TRACE_LOCK:
                self.trace.append(self.rec)


def iterate_supersteps(step: Callable, state0, max_iter: int, *,
                       name: str = "supersteps", edges: int = 0):
    """Run ``step`` (tensor → tensor) from ``state0`` until a step changes
    nothing or ``max_iter`` steps; the state as a numpy array. The
    reference's ``while_loop``: the step that finds the fixpoint counts."""
    run = _Run(name, int(state0.shape[0]), edges, state0.device)
    state = state0
    for _ in range(int(max_iter)):
        with run.step():
            new = step(state)
            changed = (new != state).any()
        state = new
        if not run.read(changed):
            break
    run.done()
    return state.cpu().numpy()


def _device(device):
    from ..common.env import resolve_device

    return resolve_device(device)


def pagerank(g: MemoryGraph, damping: float = 0.85, max_iter: int = 100,
             tol: float = 1e-6, device=None) -> np.ndarray:
    """Power iteration with dangling-mass redistribution (reference:
    PageRankBatchOp.java). The reference's operations as XLA's CPU
    compiler runs them: ``contrib = pr[src]·((1/deg_safe)[src]·w)`` (its
    rewrite of ``pr[src] / deg_safe[src] * w``) added into ``dst``, the
    dangling mass summed and divided by n, ``(1 - d)/n + d·(summed +
    mass)`` as one fused multiply-add, and the L1 change against ``tol``."""
    import torch

    dev = _device(device)
    n = g.num_vertices
    deg = g.out_degree()
    dangling = torch.as_tensor(deg == 0, device=dev)
    inv_deg = torch.as_tensor(
        np.float32(1.0) / np.where(deg == 0, np.float32(1.0), deg),
        device=dev)
    src, dst, w = g.on(dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    base = np.float32((1.0 - damping) / n)
    d = np.float32(damping)
    run = _Run("pagerank", n, len(g.src), dev)
    pr = torch.full((n,), np.float32(1.0 / n), dtype=torch.float32,
                    device=dev)
    for _ in range(int(max_iter)):
        with run.step():
            contrib = pr[src] * (inv_deg[src] * w)
            summed = scatter_add(n, dst, contrib)
            mass = torch.where(dangling, pr, zero).sum() / np.float32(n)
            new = _fma(d, summed + mass, base)
            delta = torch.abs(new - pr).sum()
        pr = new
        if not run.read(delta > tol):
            break
    run.done()
    return pr.cpu().numpy()


def scatter_add(n: int, index, values):
    """``out[index[i]] += values[i]`` into n zeros (the reference's
    ``segment_sum``). On the CPU the adds run one by one in index order,
    the order XLA's CPU scatter adds in (``index_add_`` on the CPU adds in
    another); on the card ``index_add_``'s atomics, in any order."""
    import torch

    if values.device.type == "cpu":
        out = np.zeros(n, values.numpy().dtype)
        np.add.at(out, index.numpy(), values.numpy())
        return torch.from_numpy(out)
    return torch.zeros(n, dtype=values.dtype,
                       device=values.device).index_add_(0, index, values)


def _fma(a, x, c):
    """``a·x + c`` rounded once to float32, as XLA's CPU compiler fuses it
    (through float64: the float32 product is exact there)."""
    import torch

    return (torch.as_tensor(np.float64(a)) * x.to(torch.float64)
            + np.float64(c)).to(torch.float32)


def connected_components(g: MemoryGraph, max_iter: int = 200,
                         device=None) -> np.ndarray:
    """Min-label propagation supersteps (reference:
    ConnectedComponentsBatchOp.java)."""
    import torch

    dev = _device(device)
    n = g.num_vertices
    src, dst, _ = g.on(dev)
    empty = torch.full((n,), INT32_MAX, dtype=torch.int32, device=dev)

    def step(label):
        msg = empty.clone().scatter_reduce_(0, dst, label[src], "amin",
                                            include_self=True)
        return torch.minimum(label, msg)

    return iterate_supersteps(
        step, torch.arange(n, dtype=torch.int32, device=dev), max_iter,
        name="connected_components", edges=len(g.src))


def kcore(g: MemoryGraph, k: int, max_iter: int = 200,
          device=None) -> np.ndarray:
    """Alive mask of the k-core after iterative peeling (reference:
    KCoreBatchOp.java)."""
    import torch

    dev = _device(device)
    n = g.num_vertices
    src, dst, _ = g.on(dev)

    def step(alive):
        live = alive[src].to(torch.float32) * alive[dst].to(torch.float32)
        deg = scatter_add(n, dst, live)
        return alive & (deg >= k)

    alive = iterate_supersteps(
        step, torch.ones(n, dtype=torch.bool, device=dev), max_iter,
        name="kcore", edges=len(g.src))
    return np.asarray(alive, bool)


def sssp(g: MemoryGraph, source: int, max_iter: int = 200,
         device=None) -> np.ndarray:
    """Bellman-Ford supersteps (reference:
    SingleSourceShortestPathBatchOp.java)."""
    import torch

    dev = _device(device)
    n = g.num_vertices
    src, dst, w = g.on(dev)
    empty = torch.full((n,), float("inf"), dtype=torch.float32, device=dev)

    def step(dist):
        relaxed = empty.clone().scatter_reduce_(0, dst, dist[src] + w, "amin",
                                                include_self=True)
        return torch.minimum(dist, relaxed)

    dist0 = empty.clone()
    dist0[source] = 0.0
    return iterate_supersteps(step, dist0, max_iter, name="sssp",
                              edges=len(g.src))


def label_propagation(g: MemoryGraph, labels0: Optional[np.ndarray] = None,
                      max_iter: int = 50, seed: int = 0,
                      device=None) -> np.ndarray:
    """Weighted majority label propagation (reference:
    CommunityDetectionClusterBatchOp.java / CommunityDetectionFunction).
    Dense (n × n_labels) vote matrix, as the reference's; ``argmax`` keeps
    the lowest label on a tie, and a vertex keeps its label when it ties
    the best vote."""
    import torch

    dev = _device(device)
    n = g.num_vertices
    src, dst, w = g.on(dev)
    labels0 = (np.arange(n, dtype=np.int32) if labels0 is None
               else np.asarray(labels0, np.int32))
    uniq = int(labels0.max()) + 1
    rows = torch.arange(n, device=dev)

    def step(label):
        flat = dst * uniq + label[src].to(torch.int64)
        votes = scatter_add(n * uniq, flat, w).view(n, uniq)
        keep = votes[rows, label.to(torch.int64)]
        best = votes.argmax(dim=1).to(torch.int32)
        best_v = votes.max(dim=1).values
        isolated = votes.sum(dim=1) == 0
        new = torch.where(best_v > keep, best, label)
        return torch.where(isolated, label, new).to(torch.int32)

    return iterate_supersteps(step, torch.as_tensor(labels0, device=dev),
                              max_iter, name="label_propagation",
                              edges=len(g.src))


def triangles(g: MemoryGraph):
    """List unique triangles (i<j<k) and per-vertex triangle counts
    (reference: TriangleListBatchOp.java). Host adjacency-set enumeration."""
    adj = g.adjacency_sets()
    tris = []
    counts = np.zeros(g.num_vertices, np.int64)
    for u in range(g.num_vertices):
        nu = {v for v in adj[u] if v > u}
        for v in sorted(nu):
            for t in sorted(nu & adj[v]):
                if t > v:
                    tris.append((u, v, t))
                    counts[u] += 1
                    counts[v] += 1
                    counts[t] += 1
    return tris, counts


def modularity(g: MemoryGraph, communities: np.ndarray) -> float:
    """Newman modularity of a partition (reference: ModularityCalBatchOp.java)."""
    m = g.weight.sum() / 2.0  # undirected edge list holds both directions
    if m <= 0:
        return 0.0
    deg = np.zeros(g.num_vertices, np.float64)
    np.add.at(deg, g.src, g.weight)
    same = communities[g.src] == communities[g.dst]
    intra = g.weight[same].sum() / 2.0
    comm_deg = np.zeros(int(communities.max()) + 1, np.float64)
    np.add.at(comm_deg, communities, deg)
    return float(intra / m - ((comm_deg / (2.0 * m)) ** 2).sum())


def louvain(g: MemoryGraph, max_passes: int = 10,
            max_moves: int = 20) -> np.ndarray:
    """Greedy modularity optimization (reference: LouvainBatchOp.java).
    Host-side: local moves + community aggregation, repeated until no gain."""
    n = g.num_vertices
    cur_src, cur_dst, cur_w = g.src.copy(), g.dst.copy(), g.weight.copy()
    mapping = np.arange(n)  # original vertex -> current super-vertex

    for _ in range(max_passes):
        nn = int(max(cur_src.max(initial=0), cur_dst.max(initial=0))) + 1
        comm = np.arange(nn)
        two_m = cur_w.sum()
        if two_m <= 0:
            break
        deg = np.zeros(nn)
        np.add.at(deg, cur_src, cur_w)
        comm_deg = deg.copy()
        # adjacency (host dict of dicts)
        nbrs: list = [dict() for _ in range(nn)]
        for a, b, wv in zip(cur_src, cur_dst, cur_w):
            if a != b:
                nbrs[a][b] = nbrs[a].get(b, 0.0) + wv
        improved_any = False
        for _ in range(max_moves):
            moved = 0
            for u in range(nn):
                cu = comm[u]
                # weights from u to each neighboring community
                links = {}
                for v, wv in nbrs[u].items():
                    links[comm[v]] = links.get(comm[v], 0.0) + wv
                comm_deg[cu] -= deg[u]
                best_c, best_gain = cu, 0.0
                base = links.get(cu, 0.0) - deg[u] * comm_deg[cu] / two_m
                for c, l in links.items():
                    gain = (l - deg[u] * comm_deg[c] / two_m) - base
                    if gain > best_gain + 1e-12:
                        best_gain, best_c = gain, c
                comm[u] = best_c
                comm_deg[best_c] += deg[u]
                if best_c != cu:
                    moved += 1
            if moved == 0:
                break
            improved_any = True
        if not improved_any:
            break
        # compact community ids and aggregate the graph
        uniq, new_ids = np.unique(comm, return_inverse=True)
        # new_ids[v] IS vertex v's compacted community (inverse of unique
        # over comm) — indexing via comm[v] again would double-map
        mapping = new_ids[mapping]
        agg: Dict[Tuple[int, int], float] = {}
        for a, b, wv in zip(cur_src, cur_dst, cur_w):
            key = (int(new_ids[a]), int(new_ids[b]))
            agg[key] = agg.get(key, 0.0) + wv
        cur_src = np.asarray([k[0] for k in agg], np.int32)
        cur_dst = np.asarray([k[1] for k in agg], np.int32)
        cur_w = np.asarray(list(agg.values()), np.float32)
        if len(uniq) == nn:
            break
    return mapping
