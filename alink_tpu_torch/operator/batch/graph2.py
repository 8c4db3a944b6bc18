"""Graph long-tail: node indexing, huge serving variants, SimRank, MDS,
semi-supervised community classification, risk-subgraph expansion.

Capability parity (reference: operator/batch/graph/NodeToIndexBatchOp.java /
IndexToNodeBatchOp.java / NodeIndexerTrainBatchOp.java,
dataproc/HugeIndexerStringPredictBatchOp.java /
HugeMultiIndexerStringPredictBatchOp.java / HugeLookupBatchOp.java,
graph/Node2VecBatchOp.java, huge word2vec/deepwalk/node2vec/metapath2vec
train ops under graph/, similarity/SimrankBatchOp.java +
common/recommendation/SimrankImpl.java, statistics/MdsBatchOp.java,
graph/CommunityDetectionClassifyBatchOp.java,
graph/RiskAlikeBuildGraphBatchOp.java).

Port of ``alink_tpu.operator.batch.graph2``. SimRank's sweeps and classical
MDS run on the session's device in float64 (the reference's float32
products part the card from the CPU; ROADMAP, "Differences by design"):
SimRank's similarities are rounded to float32 before the ranking, as the
reference's float32 matrix holds them. The ``Huge*`` train names ride the
huge-embedding engine, on the card one ``sgns_pull_grads`` launch a step.
Indexing, the huge serving variants, label propagation and the risk
expansion are host copies of the reference's.
"""

from __future__ import annotations

import json
from typing import Dict, List

import numpy as np

from ...common.exceptions import AkIllegalDataException
from ...common.model import model_to_table, table_to_model
from ...common.mtable import AlinkTypes, MTable, TableSchema
from ...common.params import MinValidator, ParamInfo, RangeValidator
from ...graph.engine import _Run
from ...mapper import HasReservedCols, HasSelectedCols
from .base import BatchOperator
from .dataproc import LookupBatchOp
from .feature3 import IndexToStringPredictBatchOp
from .graph import _HasGraphCols
from .huge import (
    DeepWalkEmbeddingBatchOp,
    MetaPath2VecBatchOp,
    Node2VecEmbeddingBatchOp,
    Word2VecTrainBatchOp,
)
from .utils import ModelTrainOpMixin


# ---------------------------------------------------------------------------
# node indexing
# ---------------------------------------------------------------------------


class NodeIndexerTrainBatchOp(ModelTrainOpMixin, BatchOperator,
                              _HasGraphCols):
    """Build ONE shared node→index dictionary from both edge endpoints
    (reference: operator/batch/graph/NodeIndexerTrainBatchOp.java)."""

    _min_inputs = 1
    _max_inputs = 1

    def _static_meta_keys(self, in_schema):
        return {"modelName": "StringIndexerModel"}

    def _execute_impl(self, t: MTable) -> MTable:
        src = np.asarray(t.col(self.get(self.SOURCE_COL)), object)
        dst = np.asarray(t.col(self.get(self.TARGET_COL)), object)
        nodes = sorted({str(v) for v in src} | {str(v) for v in dst})
        # the StringIndexer model format, so Huge indexer serving applies
        meta = {"modelName": "StringIndexerModel",
                "selectedCols": ["node"],
                "tokenMaps": {"node": nodes}}
        return model_to_table(meta, {})


class NodeToIndexBatchOp(BatchOperator, _HasGraphCols):
    """Map BOTH edge endpoint columns through the node dictionary
    (reference: operator/batch/graph/NodeToIndexBatchOp.java)."""

    _min_inputs = 2
    _max_inputs = 2

    def _execute_impl(self, model: MTable, t: MTable) -> MTable:
        meta, _ = table_to_model(model)
        lut = {tok: i for i, tok in enumerate(meta["tokenMaps"]["node"])}
        out = t
        for col in (self.get(self.SOURCE_COL), self.get(self.TARGET_COL)):
            vals = np.asarray(
                [lut.get(str(v), -1) for v in t.col(col)], np.int64)
            out = out.with_column(col, vals, AlinkTypes.LONG)
        return out

    def _out_schema(self, model_schema, in_schema):
        names = list(in_schema.names)
        types = list(in_schema.types)
        for col in (self.get(self.SOURCE_COL), self.get(self.TARGET_COL)):
            types[names.index(col)] = AlinkTypes.LONG
        return TableSchema(names, types)


class IndexToNodeBatchOp(BatchOperator, _HasGraphCols):
    """Inverse of NodeToIndex (reference: operator/batch/graph/
    IndexToNodeBatchOp.java)."""

    _min_inputs = 2
    _max_inputs = 2

    def _execute_impl(self, model: MTable, t: MTable) -> MTable:
        meta, _ = table_to_model(model)
        toks = meta["tokenMaps"]["node"]
        out = t
        for col in (self.get(self.SOURCE_COL), self.get(self.TARGET_COL)):
            ids = np.asarray(t.col(col), np.int64)
            vals = np.asarray(
                [toks[i] if 0 <= i < len(toks) else None for i in ids],
                object)
            out = out.with_column(col, vals, AlinkTypes.STRING)
        return out

    def _out_schema(self, model_schema, in_schema):
        names = list(in_schema.names)
        types = list(in_schema.types)
        for col in (self.get(self.SOURCE_COL), self.get(self.TARGET_COL)):
            types[names.index(col)] = AlinkTypes.STRING
        return TableSchema(names, types)


# ---------------------------------------------------------------------------
# huge serving variants (blocked data flow)
# ---------------------------------------------------------------------------


class HugeIndexerStringPredictBatchOp(IndexToStringPredictBatchOp):
    """Huge-dictionary index→token serving: the inverse dictionary loads
    once, the data streams through in bounded row blocks (reference:
    dataproc/HugeIndexerStringPredictBatchOp.java)."""

    BLOCK_SIZE = ParamInfo("blockSize", int, default=200_000)

    def _execute_impl(self, model: MTable, t: MTable) -> MTable:
        block = max(1, int(self.get(self.BLOCK_SIZE)))
        if t.num_rows <= block:
            return super()._execute_impl(model, t)
        mapper = self._make_mapper(model.schema, t.schema)
        mapper.load_model(model)
        parts = []
        for s in range(0, t.num_rows, block):
            parts.append(mapper.map_table(
                t.slice(s, min(s + block, t.num_rows))))
        return MTable.concat(parts)


class HugeMultiIndexerStringPredictBatchOp(HugeIndexerStringPredictBatchOp):
    """(reference: dataproc/HugeMultiIndexerStringPredictBatchOp.java)"""


class HugeLookupBatchOp(LookupBatchOp):
    """Huge-table lookup join: the mapping dict builds ONCE, only the data
    flows in bounded blocks (reference: dataproc/HugeLookupBatchOp.java)."""

    BLOCK_SIZE = ParamInfo("blockSize", int, default=200_000)

    def _execute_impl(self, model: MTable, t: MTable) -> MTable:
        block = max(1, int(self.get(self.BLOCK_SIZE)))
        lut = self._build_lut(model)
        if t.num_rows <= block:
            return self._probe(model.schema, t, lut)
        parts = []
        for s in range(0, t.num_rows, block):
            parts.append(self._probe(
                model.schema, t.slice(s, min(s + block, t.num_rows)), lut))
        return MTable.concat(parts)


# ---------------------------------------------------------------------------
# huge embedding train names
# ---------------------------------------------------------------------------


class HugeDeepWalkTrainBatchOp(DeepWalkEmbeddingBatchOp):
    """(reference: operator/batch/graph/HugeDeepWalkTrainBatchOp.java —
    walks + model-axis-sharded SGNS, the APS path of the shared trainer)."""


class HugeNode2VecTrainBatchOp(Node2VecEmbeddingBatchOp):
    """(reference: operator/batch/graph/HugeNode2VecTrainBatchOp.java)"""


class Node2VecBatchOp(Node2VecEmbeddingBatchOp):
    """(reference: operator/batch/graph/Node2VecBatchOp.java)"""


class HugeMetaPath2VecTrainBatchOp(MetaPath2VecBatchOp):
    """(reference: operator/batch/graph/HugeMetaPath2VecTrainBatchOp.java)"""


class HugeWord2VecTrainBatchOp(Word2VecTrainBatchOp):
    """(reference: operator/batch/huge/HugeWord2VecTrainBatchOp.java)"""


class HugeLabeledWord2VecTrainBatchOp(Word2VecTrainBatchOp):
    """Word2Vec over typed/labeled node sequences: with a second
    (node, type) input, every token is prefixed ``type<delim>token`` before
    training so same-named nodes of different types get separate embeddings
    (reference: operator/batch/huge/HugeLabeledWord2VecTrainBatchOp.java —
    the labeled metapath walk contract)."""

    TYPE_DELIMITER = ParamInfo("typeDelimiter", str, default="#")

    _min_inputs = 1
    _max_inputs = 2

    def _execute_impl(self, t: MTable, types: MTable = None) -> MTable:
        if types is not None:
            delim = self.get(self.TYPE_DELIMITER)
            type_of = {str(n): str(tp) for n, tp in
                       zip(types.col(types.names[0]),
                           types.col(types.names[1]))}
            sel = self.get(self.SELECTED_COL)
            docs = [
                None if d is None else " ".join(
                    (f"{type_of[tok]}{delim}{tok}" if tok in type_of
                     else tok) for tok in str(d).split())
                for d in t.col(sel)]
            t = t.with_column(sel, np.asarray(docs, object),
                              AlinkTypes.STRING)
        return super()._execute_impl(t)


# ---------------------------------------------------------------------------
# SimRank
# ---------------------------------------------------------------------------


class SimrankBatchOp(BatchOperator):
    """SimRank similarity on the (user, item) bipartite graph — the matrix
    power iteration S_i = C·P^T S_u P with diagonal reset, run as dense
    float64 products on the device (reference: operator/batch/similarity/
    SimrankBatchOp.java + common/recommendation/SimrankImpl.java — the Flink
    implementation's per-pair message passing becomes two dense products
    per sweep). Each sweep is a superstep of the graph engine's accounting
    (``graph.supersteps``; a CUDA event pair inside
    :func:`~alink_tpu_torch.graph.engine.superstep_trace`)."""

    USER_COL = ParamInfo("userCol", str, optional=False)
    ITEM_COL = ParamInfo("itemCol", str, optional=False)
    DECAY_FACTOR = ParamInfo("decayFactor", float, default=0.8,
                             validator=RangeValidator(0.0, 1.0))
    NUM_ITER = ParamInfo("numIter", int, default=5,
                         validator=MinValidator(1))
    TOP_N = ParamInfo("topN", int, default=10, validator=MinValidator(1))

    _min_inputs = 1
    _max_inputs = 1

    def _execute_impl(self, t: MTable) -> MTable:
        import torch

        dev = self.env.device
        users = np.asarray(t.col(self.get(self.USER_COL)))
        items = np.asarray(t.col(self.get(self.ITEM_COL)))
        u_ids, u_inv = np.unique(users.astype(str), return_inverse=True)
        i_ids, i_inv = np.unique(items.astype(str), return_inverse=True)
        nu, ni = len(u_ids), len(i_ids)
        A = torch.zeros((nu, ni), dtype=torch.float64, device=dev)
        A[torch.as_tensor(u_inv, device=dev),
          torch.as_tensor(i_inv, device=dev)] = 1.0
        # column-normalized transition matrices
        Pu = A / torch.clamp(A.sum(0, keepdim=True), min=1.0)  # user→item
        Pi = A.T / torch.clamp(A.sum(1, keepdim=True).T, min=1.0)
        C = float(self.get(self.DECAY_FACTOR))
        Su = torch.eye(nu, dtype=torch.float64, device=dev)
        Si = torch.eye(ni, dtype=torch.float64, device=dev)
        run = _Run("simrank", nu + ni, len(users), A.device)
        for _ in range(int(self.get(self.NUM_ITER))):
            with run.step():
                Su_new = C * (Pi.T @ Si @ Pi)
                Si_new = C * (Pu.T @ Su @ Pu)
                Su = Su_new.fill_diagonal_(1.0)
                Si = Si_new.fill_diagonal_(1.0)
        run.done()
        Si_np = Si.to(torch.float32).cpu().numpy()
        np.fill_diagonal(Si_np, -np.inf)
        k = min(self.get(self.TOP_N), max(ni - 1, 1))
        rows = []
        for i in range(ni):
            order = np.argsort(-Si_np[i])[:k]
            keep = Si_np[i][order] > 0
            top = {str(i_ids[j]): round(float(Si_np[i][j]), 6)
                   for j in order[keep]}
            rows.append((str(i_ids[i]), json.dumps(top)))
        return MTable.from_rows(rows, self._out_schema(t.schema))

    def _out_schema(self, in_schema):
        return TableSchema(["item", "similarities"],
                           [AlinkTypes.STRING, AlinkTypes.STRING])


# ---------------------------------------------------------------------------
# classical MDS
# ---------------------------------------------------------------------------


class MdsBatchOp(BatchOperator, HasSelectedCols, HasReservedCols):
    """Classical multidimensional scaling: double-centered squared-distance
    Gram matrix, top-d eigenvectors as coordinates (reference:
    operator/batch/statistics/MdsBatchOp.java), on the session's device in
    float64: the squared distances through the Gram matrix, the centring as
    means, ``torch.linalg.eigh``."""

    DIM = ParamInfo("dim", int, default=2, validator=MinValidator(1))
    OUTPUT_COL_PREFIX = ParamInfo("outputColPrefix", str, default="mds")

    _min_inputs = 1
    _max_inputs = 1

    def _execute_impl(self, t: MTable) -> MTable:
        import torch

        cols = list(self.get(HasSelectedCols.SELECTED_COLS) or
                    [c for c, tp in zip(t.names, t.schema.types)
                     if AlinkTypes.is_numeric(tp)])
        X = torch.as_tensor(np.array(t.to_numeric_block(cols, np.float64)),
                            device=self.env.device)
        n = X.shape[0]
        # squared distances through the Gram matrix, then the double
        # centring J·D²·J as row, column and grand means
        sq = (X * X).sum(1)
        d2 = torch.clamp(sq[:, None] + sq[None, :] - 2.0 * (X @ X.T),
                         min=0.0)
        B = -0.5 * (d2 - d2.mean(0, keepdim=True) - d2.mean(1, keepdim=True)
                    + d2.mean())
        evals, evecs = torch.linalg.eigh(B)
        evals, evecs = evals.cpu().numpy(), evecs.cpu().numpy()
        order = np.argsort(-evals)
        dim = int(self.get(self.DIM))
        rank = min(dim, n)
        coords = np.zeros((n, dim))  # columns beyond rank stay 0 so the
        # produced table always matches the declared schema
        coords[:, :rank] = evecs[:, order[:rank]] * np.sqrt(
            np.maximum(evals[order[:rank]], 0.0))
        out = t
        prefix = self.get(self.OUTPUT_COL_PREFIX)
        for j in range(dim):
            out = out.with_column(f"{prefix}_{j}", coords[:, j],
                                  AlinkTypes.DOUBLE)
        return out

    def _out_schema(self, in_schema):
        prefix = self.get(self.OUTPUT_COL_PREFIX)
        dim = int(self.get(self.DIM))
        return TableSchema(
            list(in_schema.names) + [f"{prefix}_{j}" for j in range(dim)],
            list(in_schema.types) + [AlinkTypes.DOUBLE] * dim)


# ---------------------------------------------------------------------------
# semi-supervised community classification
# ---------------------------------------------------------------------------


class CommunityDetectionClassifyBatchOp(BatchOperator, _HasGraphCols):
    """Label propagation from SEED labels: inputs (edges, labeled vertices);
    unlabeled vertices take the weighted-majority label of their neighbors
    until convergence (reference: operator/batch/graph/
    CommunityDetectionClassifyBatchOp.java)."""

    VERTEX_COL = ParamInfo("vertexCol", str, default="vertex")
    LABEL_COL = ParamInfo("labelCol", str, default="label")
    MAX_ITER = ParamInfo("maxIter", int, default=20,
                         validator=MinValidator(1))

    _min_inputs = 2
    _max_inputs = 2

    def _execute_impl(self, edges: MTable, labeled: MTable) -> MTable:
        g = self._graph(edges, directed=False)
        n = g.num_vertices
        node_of = {str(v): i for i, v in enumerate(g.labels)}
        seed = np.full(n, -1, np.int64)
        label_vals: List = []
        lab_idx: Dict = {}
        vcol = self.get(self.VERTEX_COL)
        lcol = self.get(self.LABEL_COL)
        for v, lab in zip(labeled.col(vcol), labeled.col(lcol)):
            i = node_of.get(str(v))
            if i is None:
                continue
            if lab not in lab_idx:
                lab_idx[lab] = len(label_vals)
                label_vals.append(lab)
            seed[i] = lab_idx[lab]
        K = len(label_vals)
        if K == 0:
            raise AkIllegalDataException("no seed labels match any vertex")
        labels = seed.copy()
        # weighted-majority propagation as one segment-sum sweep per iter:
        # votes[dst, label(src)] += w for labeled sources, seeds pinned
        for _ in range(int(self.get(self.MAX_ITER))):
            has = labels[g.src] >= 0
            votes = np.zeros((n, K))
            np.add.at(votes,
                      (g.dst[has], labels[g.src[has]]),
                      g.weight[has])
            new = np.where(votes.sum(1) > 0, votes.argmax(1), labels)
            new = np.where(seed >= 0, seed, new)
            if np.array_equal(new, labels):
                break
            labels = new
        rows = [(str(g.labels[i]),
                 label_vals[labels[i]] if labels[i] >= 0 else None)
                for i in range(n)]
        return MTable.from_rows(rows, self._out_schema(None, None))

    def _out_schema(self, *_):
        return TableSchema(["vertex", "label"],
                           [AlinkTypes.STRING, AlinkTypes.STRING])


# ---------------------------------------------------------------------------
# risk-alike subgraph expansion
# ---------------------------------------------------------------------------


class RiskAlikeBuildGraphBatchOp(BatchOperator, _HasGraphCols):
    """Expand the subgraph around seed (risk) vertices by ``expandDegree``
    hops and emit its edges — inputs (seed vertices, edges) (reference:
    operator/batch/graph/RiskAlikeBuildGraphBatchOp.java)."""

    VERTEX_COL = ParamInfo("vertexCol", str, default="vertex")
    EXPAND_DEGREE = ParamInfo("expandDegree", int, default=1,
                              validator=MinValidator(1))

    _min_inputs = 2
    _max_inputs = 2

    def _execute_impl(self, seeds: MTable, edges: MTable) -> MTable:
        src_col = self.get(self.SOURCE_COL)
        dst_col = self.get(self.TARGET_COL)
        src = np.asarray([str(v) for v in edges.col(src_col)], object)
        dst = np.asarray([str(v) for v in edges.col(dst_col)], object)
        frontier = {str(v) for v in seeds.col(self.get(self.VERTEX_COL))}
        keep_nodes = set(frontier)
        for _ in range(int(self.get(self.EXPAND_DEGREE))):
            mask = np.asarray([s in frontier or d in frontier
                               for s, d in zip(src, dst)])
            new_nodes = ({src[i] for i in np.nonzero(mask)[0]} |
                         {dst[i] for i in np.nonzero(mask)[0]})
            frontier = new_nodes - keep_nodes
            keep_nodes |= new_nodes
            if not frontier:
                break
        mask = np.asarray([s in keep_nodes and d in keep_nodes
                           for s, d in zip(src, dst)])
        return edges.filter_mask(mask)

    def _out_schema(self, seed_schema, edge_schema):
        return edge_schema
