"""Graph algorithm operators (port of ``alink_tpu.operator.batch.graph``).

Capability parity with the reference graph package (reference:
core/src/main/java/com/alibaba/alink/operator/batch/graph/
PageRankBatchOp.java, ConnectedComponentsBatchOp.java, KCoreBatchOp.java,
LouvainBatchOp.java, TriangleListBatchOp.java,
VertexClusterCoefficientBatchOp.java, EdgeClusterCoefficientBatchOp.java,
CommonNeighborsBatchOp.java, SingleSourceShortestPathBatchOp.java,
CommunityDetectionClusterBatchOp.java, ModularityCalBatchOp.java).

All ops take an edge table (sourceCol, targetCol[, weightCol]). PageRank,
ConnectedComponents, KCore, the shortest paths and CommunityDetectionCluster
run on the superstep engine in graph/engine.py, on the session's device
(``self.env.device``, resolved: they raise without a card unless the CPU is
asked for); Louvain, ModularityCal, the triangle and neighbour ops and
TreeDepth run on the host, as in the reference.
"""

from __future__ import annotations

import numpy as np

from ...common.mtable import AlinkTypes, MTable, TableSchema
from ...common.params import MinValidator, ParamInfo
from ...graph.engine import (
    MemoryGraph,
    connected_components,
    kcore,
    label_propagation,
    louvain,
    modularity,
    pagerank,
    sssp,
    triangles,
)
from .base import BatchOperator


class _HasGraphCols:
    SOURCE_COL = ParamInfo("sourceCol", str, default="source",
                           aliases=("edgeSourceCol",))
    TARGET_COL = ParamInfo("targetCol", str, default="target",
                           aliases=("edgeTargetCol",))
    WEIGHT_COL = ParamInfo("weightCol", str, aliases=("edgeWeightCol",))

    def _graph(self, t: MTable, directed: bool = False) -> MemoryGraph:
        return MemoryGraph.from_table(
            t, self.get(self.SOURCE_COL), self.get(self.TARGET_COL),
            self.get(self.WEIGHT_COL), directed=directed)


_VERTEX_DOUBLE = TableSchema(["vertex", "value"],
                             [AlinkTypes.STRING, AlinkTypes.DOUBLE])
_VERTEX_LONG = TableSchema(["vertex", "value"],
                           [AlinkTypes.STRING, AlinkTypes.LONG])


class PageRankBatchOp(BatchOperator, _HasGraphCols):
    """(reference: PageRankBatchOp.java)"""

    DAMPING_FACTOR = ParamInfo("dampingFactor", float, default=0.85)
    MAX_ITER = ParamInfo("maxIter", int, default=100, validator=MinValidator(1))
    EPSILON = ParamInfo("epsilon", float, default=1e-6)

    _min_inputs = 1
    _max_inputs = 1

    def _execute_impl(self, t: MTable) -> MTable:
        g = self._graph(t, directed=True)
        pr = pagerank(g, self.get(self.DAMPING_FACTOR),
                      self.get(self.MAX_ITER), self.get(self.EPSILON),
                      device=self.env.device)
        return MTable({"vertex": g.labels.astype(str),
                       "value": pr.astype(np.float64)}, _VERTEX_DOUBLE)

    def _out_schema(self, in_schema):
        return _VERTEX_DOUBLE


class ConnectedComponentsBatchOp(BatchOperator, _HasGraphCols):
    """(reference: ConnectedComponentsBatchOp.java)"""

    MAX_ITER = ParamInfo("maxIter", int, default=200, validator=MinValidator(1))

    _min_inputs = 1
    _max_inputs = 1

    def _execute_impl(self, t: MTable) -> MTable:
        g = self._graph(t)
        comp = connected_components(g, self.get(self.MAX_ITER),
                                    device=self.env.device)
        return MTable({"vertex": g.labels.astype(str),
                       "value": comp.astype(np.int64)}, _VERTEX_LONG)

    def _out_schema(self, in_schema):
        return _VERTEX_LONG


class KCoreBatchOp(BatchOperator, _HasGraphCols):
    """Edges of the k-core subgraph (reference: KCoreBatchOp.java)."""

    K = ParamInfo("k", int, default=3, validator=MinValidator(1))

    _min_inputs = 1
    _max_inputs = 1

    def _execute_impl(self, t: MTable) -> MTable:
        g = self._graph(t)
        alive = kcore(g, self.get(self.K), device=self.env.device)
        half = len(g.src) // 2  # undirected edge list duplicated both ways
        src, dst = g.src[:half], g.dst[:half]
        keep = alive[src] & alive[dst]
        return MTable(
            {"source": g.labels[src[keep]].astype(str),
             "target": g.labels[dst[keep]].astype(str)},
            TableSchema(["source", "target"],
                        [AlinkTypes.STRING, AlinkTypes.STRING]))

    def _out_schema(self, in_schema):
        return TableSchema(["source", "target"],
                           [AlinkTypes.STRING, AlinkTypes.STRING])


class SingleSourceShortestPathBatchOp(BatchOperator, _HasGraphCols):
    """(reference: SingleSourceShortestPathBatchOp.java)"""

    SOURCE_POINT = ParamInfo("sourcePoint", str, optional=False)

    _min_inputs = 1
    _max_inputs = 1

    def _execute_impl(self, t: MTable) -> MTable:
        g = self._graph(t)
        label_list = g.labels.astype(str).tolist()
        source = label_list.index(str(self.get(self.SOURCE_POINT)))
        dist = sssp(g, source, device=self.env.device)
        return MTable({"vertex": g.labels.astype(str),
                       "value": dist.astype(np.float64)}, _VERTEX_DOUBLE)

    def _out_schema(self, in_schema):
        return _VERTEX_DOUBLE


class LouvainBatchOp(BatchOperator, _HasGraphCols):
    """(reference: LouvainBatchOp.java)"""

    _min_inputs = 1
    _max_inputs = 1

    def _execute_impl(self, t: MTable) -> MTable:
        g = self._graph(t)
        comm = louvain(g)
        return MTable({"vertex": g.labels.astype(str),
                       "value": comm.astype(np.int64)}, _VERTEX_LONG)

    def _out_schema(self, in_schema):
        return _VERTEX_LONG


class CommunityDetectionClusterBatchOp(BatchOperator, _HasGraphCols):
    """Label-propagation communities (reference:
    CommunityDetectionClusterBatchOp.java)."""

    MAX_ITER = ParamInfo("maxIter", int, default=50, validator=MinValidator(1))

    _min_inputs = 1
    _max_inputs = 1

    def _execute_impl(self, t: MTable) -> MTable:
        g = self._graph(t)
        comm = label_propagation(g, max_iter=self.get(self.MAX_ITER),
                                 device=self.env.device)
        return MTable({"vertex": g.labels.astype(str),
                       "value": comm.astype(np.int64)}, _VERTEX_LONG)

    def _out_schema(self, in_schema):
        return _VERTEX_LONG


class ModularityCalBatchOp(BatchOperator, _HasGraphCols):
    """Modularity of a partition; ``link_from(edges, vertex_communities)``
    (reference: ModularityCalBatchOp.java)."""

    VERTEX_COL = ParamInfo("vertexCol", str, default="vertex")
    VERTEX_COMMUNITY_COL = ParamInfo("vertexCommunityCol", str, default="value")

    _min_inputs = 2
    _max_inputs = 2

    def _execute_impl(self, edges: MTable, comm_t: MTable) -> MTable:
        g = self._graph(edges)
        label_to_comm = {
            str(v): int(c) for v, c in zip(
                comm_t.col(self.get(self.VERTEX_COL)),
                comm_t.col(self.get(self.VERTEX_COMMUNITY_COL)))}
        comm = np.asarray([label_to_comm[str(v)]
                           for v in g.labels.astype(str)], np.int64)
        q = modularity(g, comm)
        return MTable({"modularity": [q]},
                      TableSchema(["modularity"], [AlinkTypes.DOUBLE]))

    def _out_schema(self, *in_schemas):
        return TableSchema(["modularity"], [AlinkTypes.DOUBLE])


_TRIANGLE_SCHEMA = TableSchema(
    ["node1", "node2", "node3"],
    [AlinkTypes.STRING, AlinkTypes.STRING, AlinkTypes.STRING])


class TriangleListBatchOp(BatchOperator, _HasGraphCols):
    """(reference: TriangleListBatchOp.java)"""

    _min_inputs = 1
    _max_inputs = 1

    def _execute_impl(self, t: MTable) -> MTable:
        g = self._graph(t)
        tris, _ = triangles(g)
        lab = g.labels.astype(str)
        rows = [(lab[a], lab[b], lab[c]) for a, b, c in tris]
        if not rows:
            return MTable({"node1": np.asarray([], object),
                           "node2": np.asarray([], object),
                           "node3": np.asarray([], object)}, _TRIANGLE_SCHEMA)
        return MTable.from_rows(rows, _TRIANGLE_SCHEMA)

    def _out_schema(self, in_schema):
        return _TRIANGLE_SCHEMA


class VertexClusterCoefficientBatchOp(BatchOperator, _HasGraphCols):
    """Per-vertex clustering coefficient (reference:
    VertexClusterCoefficientBatchOp.java)."""

    _min_inputs = 1
    _max_inputs = 1

    def _execute_impl(self, t: MTable) -> MTable:
        g = self._graph(t)
        _, counts = triangles(g)
        adj = g.adjacency_sets()
        deg = np.asarray([len(adj[i]) for i in range(g.num_vertices)])
        possible = deg * (deg - 1) / 2.0
        coef = np.where(possible > 0, counts / np.maximum(possible, 1), 0.0)
        return MTable({"vertex": g.labels.astype(str),
                       "value": coef.astype(np.float64)}, _VERTEX_DOUBLE)

    def _out_schema(self, in_schema):
        return _VERTEX_DOUBLE


class EdgeClusterCoefficientBatchOp(BatchOperator, _HasGraphCols):
    """Per-edge: common neighbors / min(deg)-1 (reference:
    EdgeClusterCoefficientBatchOp.java)."""

    _min_inputs = 1
    _max_inputs = 1

    def _execute_impl(self, t: MTable) -> MTable:
        g = self._graph(t)
        adj = g.adjacency_sets()
        half = len(g.src) // 2
        rows = []
        lab = g.labels.astype(str)
        for a, b in zip(g.src[:half], g.dst[:half]):
            a, b = int(a), int(b)
            cn = len(adj[a] & adj[b])
            denom = min(len(adj[a]), len(adj[b])) - 1
            coef = cn / denom if denom > 0 else 0.0
            rows.append((lab[a], lab[b], float(cn), float(coef)))
        schema = TableSchema(
            ["source", "target", "commonNeighbors", "coefficient"],
            [AlinkTypes.STRING, AlinkTypes.STRING, AlinkTypes.DOUBLE,
             AlinkTypes.DOUBLE])
        return MTable.from_rows(rows, schema)

    def _out_schema(self, in_schema):
        return TableSchema(
            ["source", "target", "commonNeighbors", "coefficient"],
            [AlinkTypes.STRING, AlinkTypes.STRING, AlinkTypes.DOUBLE,
             AlinkTypes.DOUBLE])


class CommonNeighborsBatchOp(BatchOperator, _HasGraphCols):
    """Common neighbors of each input pair (reference:
    CommonNeighborsBatchOp.java)."""

    _min_inputs = 1
    _max_inputs = 1

    def _execute_impl(self, t: MTable) -> MTable:
        g = self._graph(t)
        adj = g.adjacency_sets()
        half = len(g.src) // 2
        lab = g.labels.astype(str)
        rows = []
        for a, b in zip(g.src[:half], g.dst[:half]):
            a, b = int(a), int(b)
            common = sorted(adj[a] & adj[b])
            rows.append((lab[a], lab[b],
                         " ".join(lab[c] for c in common),
                         float(len(common))))
        schema = TableSchema(
            ["source", "target", "neighbors", "cnt"],
            [AlinkTypes.STRING, AlinkTypes.STRING, AlinkTypes.STRING,
             AlinkTypes.DOUBLE])
        return MTable.from_rows(rows, schema)

    def _out_schema(self, in_schema):
        return TableSchema(
            ["source", "target", "neighbors", "cnt"],
            [AlinkTypes.STRING, AlinkTypes.STRING, AlinkTypes.STRING,
             AlinkTypes.DOUBLE])


class MultiSourceShortestPathBatchOp(BatchOperator, _HasGraphCols):
    """Distance to the NEAREST of several sources, plus which root won
    (reference: MultiSourceShortestPathBatchOp.java). Implementation: one
    SSSP run per root with a host-side min-merge — O(|roots|) superstep
    runs; fine for the handful of roots the op is used with."""

    SOURCE_POINTS = ParamInfo("sourcePoints", list, optional=False,
                              aliases=("sourcePoint",))


    _min_inputs = 1
    _max_inputs = 1

    _SCHEMA = TableSchema(["vertex", "value", "root"],
                          [AlinkTypes.STRING, AlinkTypes.DOUBLE,
                           AlinkTypes.STRING])

    def _execute_impl(self, t: MTable) -> MTable:
        g = self._graph(t)
        label_list = g.labels.astype(str).tolist()
        srcs = [label_list.index(str(s))
                for s in self.get(self.SOURCE_POINTS)]
        n = len(g.labels)
        dist = np.full(n, np.inf)
        root = np.full(n, -1, np.int64)
        for s in srcs:
            d = sssp(g, s, device=self.env.device)
            better = d < dist
            dist[better] = d[better]
            root[better] = s
        root_labels = np.asarray(
            [g.labels[r] if r >= 0 else None for r in root], object)
        return MTable({"vertex": g.labels.astype(str),
                       "value": dist.astype(np.float64),
                       "root": root_labels}, self._SCHEMA)

    def _out_schema(self, in_schema):
        return self._SCHEMA


class TreeDepthBatchOp(BatchOperator, _HasGraphCols):
    """Depth of every vertex in a forest of rooted trees (reference:
    TreeDepthBatchOp.java — roots are vertices with no incoming edge;
    depth 0 at the root)."""

    _min_inputs = 1
    _max_inputs = 1

    _SCHEMA = TableSchema(["vertex", "root", "value"],
                          [AlinkTypes.STRING, AlinkTypes.STRING,
                           AlinkTypes.LONG])

    def _execute_impl(self, t: MTable) -> MTable:
        g = self._graph(t, directed=True)
        n = len(g.labels)
        parents = np.bincount(g.dst, minlength=n)
        from ...common.exceptions import AkIllegalDataException

        if (parents > 1).any():
            bad = g.labels[int(np.argmax(parents))]
            raise AkIllegalDataException(
                f"vertex {bad!r} has {int(parents.max())} parents — "
                "TreeDepth needs a forest")
        has_parent = parents > 0
        depth = np.full(n, -1, np.int64)
        root = np.arange(n)
        depth[~has_parent] = 0
        # BFS supersteps over the edge list (vectorized frontier expand)
        for _ in range(n):
            src_known = depth[g.src] >= 0
            cand = g.dst[src_known]
            new = depth[cand] < 0
            if not new.any():
                break
            depth[cand[new]] = depth[g.src[src_known]][new] + 1
            root[cand[new]] = root[g.src[src_known]][new]
        if (depth < 0).any():
            raise AkIllegalDataException(
                "graph contains a cycle or unreachable vertex — TreeDepth "
                "needs a forest")
        return MTable({"vertex": g.labels.astype(str),
                       "root": g.labels[root].astype(str),
                       "value": depth}, self._SCHEMA)

    def _out_schema(self, in_schema):
        return self._SCHEMA


class VertexNeighborSearchBatchOp(BatchOperator, _HasGraphCols):
    """Subgraph within K hops of the given vertices (reference:
    VertexNeighborSearchBatchOp.java — emits the induced edge list)."""

    SOURCES = ParamInfo("sources", list, optional=False,
                        aliases=("vertices",))
    DEPTH = ParamInfo("depth", int, default=1, validator=MinValidator(1))

    _min_inputs = 1
    _max_inputs = 1

    _SCHEMA = TableSchema(["source", "target"],
                          [AlinkTypes.STRING, AlinkTypes.STRING])

    def _execute_impl(self, t: MTable) -> MTable:
        g = self._graph(t)
        label_list = g.labels.astype(str).tolist()
        n = len(g.labels)
        seen = np.zeros(n, bool)
        for s in self.get(self.SOURCES):
            seen[label_list.index(str(s))] = True
        for _ in range(int(self.get(self.DEPTH))):
            frontier = seen[g.src]
            seen[g.dst[frontier]] = True
        half = len(g.src) // 2
        src, dst = g.src[:half], g.dst[:half]
        keep = seen[src] & seen[dst]
        return MTable({"source": g.labels[src[keep]].astype(str),
                       "target": g.labels[dst[keep]].astype(str)},
                      self._SCHEMA)

    def _out_schema(self, in_schema):
        return self._SCHEMA
