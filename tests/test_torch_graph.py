"""Parity of the port's graph engine and graph operators with
``alink_tpu`` on the CPU (``ALINK_TORCH_DEVICE=cpu``): the cases of
``tests/test_graph.py`` run through both packages on the same edge tables,
plus the engine's edge cases (a vertex no edge reaches, ``max_iter``
reached before the fixpoint) and a seeded R-MAT graph.

Tolerances: connected components, k-core, shortest paths, label
propagation, Louvain, triangles and the coefficient ops are equal (integer
or min-plus results, or host code copied). PageRank on a graph with no
dangling vertex (every undirected graph here, and TextRank's) is equal bit
for bit: the port runs XLA's CPU arithmetic in edge order. On a directed
graph with dangling vertices the dangling mass is a float32 sum whose order
XLA picks; there the ranks are held within PR_RTOL = 1e-6 relative (seeded
graphs part by at most 2.1e-7) and the values must still sum to one."""

import numpy as np
import pytest

from torch_table_parity import both, reference_session, remove_session, \
    same_table

PR_RTOL = 1e-6


@pytest.fixture(scope="module")
def sid():
    s = reference_session()
    yield s
    remove_session(s)


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("ALINK_TORCH_DEVICE", "cpu")


def _cols(pairs, weights=None):
    cols = {"source": np.asarray([a for a, _ in pairs], object),
            "target": np.asarray([b for _, b in pairs], object)}
    if weights is not None:
        cols["weight"] = np.asarray(weights, np.float64)
    return cols


def _two_cliques():
    """Two 4-cliques joined by one bridge edge."""
    pairs = []
    for grp in (["a", "b", "c", "d"], ["e", "f", "g", "h"]):
        for i in range(4):
            for j in range(i + 1, 4):
                pairs.append((grp[i], grp[j]))
    pairs.append(("d", "e"))
    return pairs


def _rmat(scale, edges, seed):
    """A seeded R-MAT edge list (A, B, C = 0.57, 0.19, 0.19) as string
    vertex ids, self loops dropped, with weights in (0, 1]."""
    rng = np.random.default_rng(seed)
    src = np.zeros(edges, np.int64)
    dst = np.zeros(edges, np.int64)
    for bit in range(scale):
        r = rng.random(edges)
        right = (r >= 0.57) & (r < 0.76) | (r >= 0.95)
        down = r >= 0.76
        src |= down.astype(np.int64) << bit
        dst |= right.astype(np.int64) << bit
    keep = src != dst
    w = 1.0 - rng.random(keep.sum())
    return [(str(a), str(b)) for a, b in zip(src[keep], dst[keep])], w


def _run(sid, cols, op_name, *more, **params):
    return both(sid, cols, lambda ops, extra, *srcs: getattr(
        ops, op_name)(**params, **extra).link_from(*srcs), *more)


def test_pagerank_star(sid):
    pairs = [("l1", "hub"), ("l2", "hub"), ("l3", "hub"), ("l4", "hub")]
    ref, port = _run(sid, _cols(pairs), "PageRankBatchOp")
    same_table(port, ref, rtol=PR_RTOL)
    ranks = dict(zip(port.col("vertex"), port.col("value")))
    assert ranks["hub"] == max(ranks.values())
    assert sum(ranks.values()) == pytest.approx(1.0, abs=1e-3)


@pytest.mark.parametrize("max_iter", [3, 100])
def test_pagerank_on_a_seeded_graph(sid, max_iter):
    """Directed (dangling vertices: within PR_RTOL) and undirected through
    the engine (no dangling vertex: bit for bit), stopped by ``max_iter``
    or by the tolerance."""
    from alink_tpu.graph import engine as R
    from alink_tpu_torch.graph import engine as P

    pairs, w = _rmat(8, 2_000, seed=3)
    ref, port = _run(sid, _cols(pairs, w), "PageRankBatchOp",
                     weightCol="weight", maxIter=max_iter)
    same_table(port, ref, rtol=PR_RTOL)
    assert sum(port.col("value")) == pytest.approx(1.0, abs=1e-4)
    labels, inv = np.unique([p for pair in pairs for p in pair],
                            return_inverse=True)
    s, d = inv[0::2], inv[1::2]
    args = (len(labels), np.concatenate([s, d]), np.concatenate([d, s]),
            np.concatenate([w, w]).astype(np.float32))
    want = R.pagerank(R.MemoryGraph(*args), max_iter=max_iter)
    got = P.pagerank(P.MemoryGraph(*args), max_iter=max_iter, device="cpu")
    np.testing.assert_array_equal(got, want)


def test_connected_components(sid):
    pairs = [("a", "b"), ("b", "c"), ("x", "y")]
    ref, port = _run(sid, _cols(pairs), "ConnectedComponentsBatchOp")
    same_table(port, ref)
    comp = dict(zip(port.col("vertex"), port.col("value")))
    assert comp["a"] == comp["b"] == comp["c"] != comp["x"] == comp["y"]


def test_kcore_drops_pendant(sid):
    ref, port = _run(sid, _cols(_two_cliques() + [("h", "tail")]),
                     "KCoreBatchOp", k=3)
    same_table(port, ref)
    kept = set(port.col("source")) | set(port.col("target"))
    assert "tail" not in kept and port.num_rows >= 12


def test_sssp_weighted(sid):
    pairs = [("s", "a"), ("a", "t"), ("s", "t"), ("u", "v")]
    ref, port = _run(sid, _cols(pairs, [1.0, 1.0, 5.0, 1.0]),
                     "SingleSourceShortestPathBatchOp", sourcePoint="s",
                     weightCol="weight")
    same_table(port, ref)
    dist = dict(zip(port.col("vertex"), port.col("value")))
    assert (dist["s"], dist["a"], dist["t"]) == (0.0, 1.0, 2.0)
    assert dist["u"] == dist["v"] == np.inf     # another component


def test_louvain_and_modularity(sid):
    import alink_tpu.operator.batch as R
    import alink_tpu_torch.operator.batch as P
    from alink_tpu.common.mtable import MTable as RT
    from alink_tpu_torch.common.mtable import MTable as PT

    out = []
    for ops, T, extra in ((R, RT, dict(MLEnvironmentId=sid)), (P, PT, {})):
        edges = ops.TableSourceBatchOp(T(_cols(_two_cliques())))
        comm = ops.LouvainBatchOp(**extra).link_from(edges)
        q = ops.ModularityCalBatchOp(**extra).link_from(edges, comm)
        out.append((comm.collect(), q.collect()))
    (rc, rq), (pc, pq) = out
    same_table(pc, rc)
    same_table(pq, rq)
    by_v = dict(zip(pc.col("vertex"), pc.col("value")))
    assert by_v["a"] == by_v["d"] != by_v["e"] == by_v["h"]
    assert pq.col("modularity")[0] > 0.3


def test_community_detection_label_propagation(sid):
    ref, port = _run(sid, _cols(_two_cliques()),
                     "CommunityDetectionClusterBatchOp")
    same_table(port, ref)
    by_v = dict(zip(port.col("vertex"), port.col("value")))
    assert len({by_v[v] for v in "abcd"}) == 1
    assert len({by_v[v] for v in "efgh"}) == 1


@pytest.mark.parametrize("op", ["TriangleListBatchOp",
                                "VertexClusterCoefficientBatchOp",
                                "EdgeClusterCoefficientBatchOp"])
def test_triangle_list_and_coefficients(sid, op):
    pairs = [("a", "b"), ("b", "c"), ("a", "c"), ("c", "d")]
    ref, port = _run(sid, _cols(pairs), op)
    same_table(port, ref)
    if op == "TriangleListBatchOp":
        assert port.num_rows == 1
        assert set(next(iter(port.rows()))) == {"a", "b", "c"}


def test_triangle_list_without_triangles(sid):
    ref, port = _run(sid, _cols([("a", "b"), ("b", "c")]),
                     "TriangleListBatchOp")
    same_table(port, ref)
    assert port.num_rows == 0


def test_common_neighbors(sid):
    pairs = [("u", "x"), ("v", "x"), ("u", "y"), ("v", "y"), ("u", "v")]
    ref, port = _run(sid, _cols(pairs), "CommonNeighborsBatchOp")
    same_table(port, ref)
    row = {(r[0], r[1]): r for r in port.rows()}
    assert row[("u", "v")][3] == 2.0


def test_multi_source_shortest_path(sid):
    pairs = [("a", "b"), ("b", "c"), ("c", "d"), ("x", "y"), ("y", "d")]
    ref, port = _run(sid, _cols(pairs), "MultiSourceShortestPathBatchOp",
                     sourcePoints=["a", "x"])
    same_table(port, ref)
    d = {r[0]: (r[1], r[2]) for r in port.rows()}
    assert d["d"][0] == 2.0 and d["y"] == (1.0, "x")


def test_tree_depth(sid):
    pairs = [("r", "c1"), ("r", "c2"), ("c1", "g1"), ("r2", "z")]
    ref, port = _run(sid, _cols(pairs), "TreeDepthBatchOp")
    same_table(port, ref)
    d = {r[0]: (r[1], r[2]) for r in port.rows()}
    assert d["g1"] == ("r", 2) and d["z"] == ("r2", 1)


def test_vertex_neighbor_search(sid):
    pairs = [("a", "b"), ("b", "c"), ("c", "d")]
    ref, port = _run(sid, _cols(pairs), "VertexNeighborSearchBatchOp",
                     sources=["a"], depth=2)
    same_table(port, ref)
    assert {(r[0], r[1]) for r in port.rows()} == {("a", "b"), ("b", "c")}


@pytest.mark.parametrize("op, params", [
    ("PageRankBatchOp", {}),
    ("ConnectedComponentsBatchOp", {}),
    ("KCoreBatchOp", {"k": 4}),
    ("SingleSourceShortestPathBatchOp", {"sourcePoint": "0"}),
    ("CommunityDetectionClusterBatchOp", {}),
    ("LouvainBatchOp", {}),
    ("VertexClusterCoefficientBatchOp", {}),
])
def test_ops_on_a_seeded_rmat_graph(sid, op, params):
    pairs, w = _rmat(7, 1_200, seed=5)
    if op == "SingleSourceShortestPathBatchOp":
        params = dict(params, sourcePoint=pairs[0][0], weightCol="weight")
    ref, port = _run(sid, _cols(pairs, w), op, **params)
    same_table(port, ref, rtol=PR_RTOL if op == "PageRankBatchOp" else 0)


def _engine_pair(n, src, dst, w=None):
    from alink_tpu.graph import engine as R
    from alink_tpu_torch.graph import engine as P

    return (R, R.MemoryGraph(n, src, dst, w)), (P, P.MemoryGraph(n, src, dst, w))


@pytest.mark.parametrize("fn, kw", [
    ("connected_components", {}),
    ("connected_components", {"max_iter": 2}),
    ("kcore", {"k": 2}),
    ("kcore", {"k": 2, "max_iter": 1}),
    ("sssp", {"source": 0}),
    ("sssp", {"source": 0, "max_iter": 2}),
    ("label_propagation", {}),
    ("label_propagation", {"max_iter": 1}),
    ("pagerank", {}),
    ("pagerank", {"max_iter": 2}),
])
def test_engine_empty_segments_and_max_iter(fn, kw):
    """Vertices 7 and 8 lie on no edge: their segment is empty, so a
    min-reduction gives +inf / INT32_MAX (the state keeps its own value)
    and PageRank counts them dangling. A path 0-1-2-3-4-5-6 takes more
    supersteps than the small ``max_iter`` cases allow."""
    path = np.arange(6)
    src = np.concatenate([path, path + 1])
    dst = np.concatenate([path + 1, path])
    w = np.linspace(0.5, 1.0, len(src)).astype(np.float32)
    (R, rg), (P, pg) = _engine_pair(9, src, dst, w)
    want = getattr(R, fn)(rg, **kw)
    got = getattr(P, fn)(pg, device="cpu", **kw)
    if fn == "pagerank":
        np.testing.assert_allclose(got, want, rtol=PR_RTOL)
    else:
        np.testing.assert_array_equal(got, want)
    if fn == "sssp" and "max_iter" not in kw:
        assert np.isinf(got[7:]).all() and got[6] == w[:6].sum()


def test_engine_counts_supersteps_and_host_syncs():
    """One host sync a superstep; the fixpoint step counts (a 7-vertex
    path's labels settle after 6 steps, the 7th finds nothing to change)."""
    from alink_tpu_torch.common.metrics import metrics
    from alink_tpu_torch.graph import engine as P

    path = np.arange(6)
    g = P.MemoryGraph(7, np.concatenate([path, path + 1]),
                      np.concatenate([path + 1, path]))
    before = metrics.counter("graph.supersteps")
    with P.superstep_trace() as runs:
        P.connected_components(g, device="cpu")
        P.connected_components(g, max_iter=3, device="cpu")
    assert [(r["fn"], r["supersteps"], r["host_syncs"]) for r in runs] == [
        ("connected_components", 7, 7), ("connected_components", 3, 3)]
    assert metrics.counter("graph.supersteps") - before == 10
