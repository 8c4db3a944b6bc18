"""Word2Vec + graph-embedding operators (port of
``alink_tpu.operator.batch.huge``, the reference's nlp/huge ops).

Training runs on the session's device (``self.env.device``) through
``train_embedding``; the model table (word, vec DenseVector) written by
either package serves in the other's ``Word2VecPredictBatchOp``. On the card
every training op launches the ``sgns_block_grads`` kernel once a step
(``sgns_pull_grads``), LINE's order 1 on one tied table.

Capability parity:
- Word2VecTrainBatchOp (reference: operator/batch/nlp/Word2VecTrainBatchOp +
  huge/Word2VecBatchOp via APS) — model table of (word, DenseVector) rows.
- Word2VecPredictBatchOp (reference: operator/common/nlp/Word2VecModelMapper —
  doc -> average of word vectors).
- DeepWalkBatchOp / Node2VecWalkBatchOp (reference: operator/batch/graph/
  DeepWalkBatchOp, Node2VecWalkBatchOp) — emit walks as token sequences.
- DeepWalkEmbeddingBatchOp / Node2VecEmbeddingBatchOp (reference:
  huge/DeepWalkBatchOp, huge/Node2VecBatchOp) — walks + SGNS end to end.
- MetaPathWalkBatchOp / MetaPath2VecBatchOp (reference: operator/batch/graph/
  MetaPathWalkBatchOp, MetaPath2VecBatchOp) — typed walks (+ SGNS).
- LineBatchOp (reference: operator/batch/graph/LineBatchOp) — LINE first or
  second order over edge mini-batches.
"""

from __future__ import annotations

from typing import List

import numpy as np

from ...common.exceptions import AkIllegalDataException
from ...common.linalg import DenseVector
from ...common.mtable import AlinkTypes, MTable, TableSchema
from ...common.params import InValidator, MinValidator, ParamInfo
from ...embedding import (
    SkipGramConfig,
    build_vocab,
    make_pairs,
    node2vec_walks,
    random_walks,
    train_embedding,
)
from ...embedding.walks import build_csr
from ...mapper import HasPredictionCol, HasReservedCols, ModelMapper
from .base import BatchOperator
from .utils import ModelMapBatchOp


class HasWord2VecParams:
    SELECTED_COL = ParamInfo("selectedCol", str, optional=False,
                             desc="segmented text column (space-separated)")
    VECTOR_SIZE = ParamInfo("vectorSize", int, default=100,
                            validator=MinValidator(1))
    WINDOW = ParamInfo("window", int, default=5)
    NEGATIVE = ParamInfo("negative", int, default=5)
    NUM_ITER = ParamInfo("numIter", int, default=3)
    MIN_COUNT = ParamInfo("minCount", int, default=1)
    LEARNING_RATE = ParamInfo("learningRate", float, default=0.025)
    BATCH_SIZE = ParamInfo("batchSize", int, default=1024)
    RANDOM_SEED = ParamInfo("randomSeed", int, default=0)
    WORD_DELIMITER = ParamInfo("wordDelimiter", str, default=" ")
    SHARD_MODEL = ParamInfo(
        "shardModel", bool, default=False,
        desc="force the model-sharded APS engine for this op regardless of "
             "ALINK_HUGE_ENGINE (reference: huge/Word2VecBatchOp); the "
             "knob's default is already 'sharded'")


def _w2v_model_table(vocab, emb: np.ndarray) -> MTable:
    words = [None] * len(vocab)
    for w, i in vocab.items():
        words[i] = w
    vecs = [DenseVector(emb[i]) for i in range(len(words))]
    return MTable(
        {"word": np.asarray(words, object), "vec": np.asarray(vecs, object)},
        TableSchema(["word", "vec"], [AlinkTypes.STRING, AlinkTypes.DENSE_VECTOR]),
    )


class Word2VecTrainBatchOp(BatchOperator, HasWord2VecParams):
    _huge_sgns = True      # plan validator: SGNS op under ALINK_HUGE_ENGINE
    _min_inputs = 1
    _max_inputs = 1

    def _out_schema(self, in_schema: TableSchema) -> TableSchema:
        return TableSchema(["word", "vec"],
                           [AlinkTypes.STRING, AlinkTypes.DENSE_VECTOR])

    def _execute_impl(self, t: MTable) -> MTable:
        delim = self.get(self.WORD_DELIMITER)
        docs = [str(v).split(delim) for v in t.col(self.get(self.SELECTED_COL))]
        vocab, counts = build_vocab(docs, self.get(self.MIN_COUNT))
        if not vocab:
            raise AkIllegalDataException("empty vocabulary")
        cfg = SkipGramConfig(
            dim=self.get(self.VECTOR_SIZE),
            window=self.get(self.WINDOW),
            negatives=self.get(self.NEGATIVE),
            epochs=self.get(self.NUM_ITER),
            batch_size=self.get(self.BATCH_SIZE),
            learning_rate=self.get(self.LEARNING_RATE),
            min_count=self.get(self.MIN_COUNT),
            seed=self.get(self.RANDOM_SEED),
        )
        pairs = make_pairs(docs, vocab, counts, cfg.window, cfg.subsample,
                           cfg.seed)
        emb = train_embedding(
            pairs, len(vocab), counts, cfg, device=self.env.device,
            engine="sharded" if self.get(self.SHARD_MODEL) else None)
        return _w2v_model_table(vocab, emb)


class Word2VecModelMapper(ModelMapper, HasPredictionCol, HasReservedCols):
    """doc -> mean of its word vectors (reference:
    operator/common/nlp/Word2VecModelMapper.java)."""

    SELECTED_COL = ParamInfo("selectedCol", str, optional=False)
    WORD_DELIMITER = ParamInfo("wordDelimiter", str, default=" ")

    def load_model(self, model: MTable):
        self.vecs = {
            str(w): np.asarray(v.data if isinstance(v, DenseVector) else v)
            for w, v in zip(model.col("word"), model.col("vec"))
        }
        self.dim = len(next(iter(self.vecs.values()))) if self.vecs else 0
        return self

    def output_schema(self, input_schema):
        out = self.get(HasPredictionCol.PREDICTION_COL) or "vec"
        return self._append_result_schema(
            input_schema, [out], [AlinkTypes.DENSE_VECTOR]
        )

    def map_table(self, t: MTable) -> MTable:
        sel = self.get(self.SELECTED_COL)
        out = self.get(HasPredictionCol.PREDICTION_COL) or "vec"
        delim = self.get(self.WORD_DELIMITER)
        res = []
        for doc in t.col(sel):
            toks = [self.vecs[w] for w in str(doc).split(delim)
                    if w in self.vecs]
            res.append(
                DenseVector(np.mean(toks, axis=0) if toks
                            else np.zeros(self.dim))
            )
        return self._append_result(
            t, {out: np.asarray(res, object)}, {out: AlinkTypes.DENSE_VECTOR}
        )


class Word2VecPredictBatchOp(ModelMapBatchOp, HasPredictionCol,
                             HasReservedCols):
    mapper_cls = Word2VecModelMapper


# ---------------------------------------------------------------------------
# graph walks + embeddings
# ---------------------------------------------------------------------------


class HasWalkParams:
    SOURCE_COL = ParamInfo("sourceCol", str, optional=False)
    TARGET_COL = ParamInfo("targetCol", str, optional=False)
    WEIGHT_COL = ParamInfo("weightCol", str)
    WALK_NUM = ParamInfo("walkNum", int, default=10)
    WALK_LENGTH = ParamInfo("walkLength", int, default=40)
    IS_TO_UNDIGRAPH = ParamInfo("isToUndigraph", bool, default=True)
    RANDOM_SEED = ParamInfo("randomSeed", int, default=0)
    DELIMITER = ParamInfo("delimiter", str, default=" ")


def _edges_of(op, t: MTable):
    src_raw = [str(v) for v in t.col(op.get(op.SOURCE_COL))]
    dst_raw = [str(v) for v in t.col(op.get(op.TARGET_COL))]
    nodes = sorted(set(src_raw) | set(dst_raw))
    idx = {v: i for i, v in enumerate(nodes)}
    src = np.asarray([idx[v] for v in src_raw])
    dst = np.asarray([idx[v] for v in dst_raw])
    w = None
    if op.get(op.WEIGHT_COL):
        w = np.asarray(t.col(op.get(op.WEIGHT_COL)), np.float32)
    return nodes, src, dst, w


def _walks_table(walks: np.ndarray, nodes: List[str], delim: str) -> MTable:
    out = np.asarray(
        [delim.join(nodes[v] for v in row) for row in walks], object
    )
    return MTable({"path": out}, TableSchema(["path"], [AlinkTypes.STRING]))


class DeepWalkBatchOp(BatchOperator, HasWalkParams):
    """Uniform random walks -> 'path' token strings
    (reference: operator/batch/graph/RandomWalkBatchOp / DeepWalkBatchOp)."""

    _min_inputs = 1
    _max_inputs = 1

    def _out_schema(self, in_schema: TableSchema) -> TableSchema:
        return TableSchema(["path"], [AlinkTypes.STRING])

    def _execute_impl(self, t: MTable) -> MTable:
        nodes, src, dst, w = _edges_of(self, t)
        indptr, indices, weights = build_csr(
            src, dst, w, num_nodes=len(nodes),
            directed=not self.get(self.IS_TO_UNDIGRAPH),
        )
        walks = random_walks(
            indptr, indices, weights,
            num_walks=self.get(self.WALK_NUM),
            walk_length=self.get(self.WALK_LENGTH),
            seed=self.get(self.RANDOM_SEED),
        )
        return _walks_table(walks, nodes, self.get(self.DELIMITER))


class RandomWalkBatchOp(DeepWalkBatchOp):
    """Uniform random walks op under its graph-family name
    (reference: operator/batch/graph/RandomWalkBatchOp.java)."""


class Node2VecWalkBatchOp(BatchOperator, HasWalkParams):
    """(reference: operator/batch/graph/Node2VecWalkBatchOp)"""

    P = ParamInfo("p", float, default=1.0)
    Q = ParamInfo("q", float, default=1.0)

    _min_inputs = 1
    _max_inputs = 1

    def _out_schema(self, in_schema: TableSchema) -> TableSchema:
        return TableSchema(["path"], [AlinkTypes.STRING])

    def _execute_impl(self, t: MTable) -> MTable:
        nodes, src, dst, w = _edges_of(self, t)
        indptr, indices, weights = build_csr(
            src, dst, w, num_nodes=len(nodes),
            directed=not self.get(self.IS_TO_UNDIGRAPH),
        )
        walks = node2vec_walks(
            indptr, indices, weights,
            num_walks=self.get(self.WALK_NUM),
            walk_length=self.get(self.WALK_LENGTH),
            p=self.get(self.P), q=self.get(self.Q),
            seed=self.get(self.RANDOM_SEED),
        )
        return _walks_table(walks, nodes, self.get(self.DELIMITER))


class _WalkEmbeddingBase(BatchOperator, HasWalkParams, HasWord2VecParams):
    """walks + SGNS end-to-end (reference: huge/DeepWalkBatchOp,
    huge/Node2VecBatchOp through ApsEnv)."""

    _huge_sgns = True      # plan validator: SGNS op under ALINK_HUGE_ENGINE

    SELECTED_COL = ParamInfo("selectedCol", str)  # unused; graph input

    _min_inputs = 1
    _max_inputs = 1
    _walk_op_cls = None

    def _out_schema(self, in_schema: TableSchema) -> TableSchema:
        return TableSchema(["word", "vec"],
                           [AlinkTypes.STRING, AlinkTypes.DENSE_VECTOR])

    def _execute_impl(self, t: MTable) -> MTable:
        from .base import TableSourceBatchOp

        walk_op = self._walk_op_cls(self.get_params().clone())
        walks_t = walk_op.link_from(TableSourceBatchOp(t)).collect()
        delim = self.get(self.DELIMITER)
        docs = [str(v).split(delim) for v in walks_t.col("path")]
        vocab, counts = build_vocab(docs, self.get(self.MIN_COUNT))
        cfg = SkipGramConfig(
            dim=self.get(self.VECTOR_SIZE),
            window=self.get(self.WINDOW),
            negatives=self.get(self.NEGATIVE),
            epochs=self.get(self.NUM_ITER),
            batch_size=self.get(self.BATCH_SIZE),
            learning_rate=self.get(self.LEARNING_RATE),
            subsample=0.0,  # walks are already frequency-balanced
            seed=self.get(self.RANDOM_SEED),
        )
        pairs = make_pairs(docs, vocab, counts, cfg.window, 0.0, cfg.seed)
        emb = train_embedding(pairs, len(vocab), counts, cfg,
                              device=self.env.device)
        return _w2v_model_table(vocab, emb)


class DeepWalkEmbeddingBatchOp(_WalkEmbeddingBase):
    _walk_op_cls = DeepWalkBatchOp


class Node2VecEmbeddingBatchOp(_WalkEmbeddingBase):
    _walk_op_cls = Node2VecWalkBatchOp
    P = ParamInfo("p", float, default=1.0)
    Q = ParamInfo("q", float, default=1.0)


class MetaPathWalkBatchOp(BatchOperator, HasWalkParams):
    """Metapath-constrained walks over a heterogeneous graph; second input
    holds (vertex, type) rows (reference:
    operator/batch/graph/MetaPathWalkBatchOp.java)."""

    METAPATH = ParamInfo("metaPath", str, optional=False,
                         desc="type sequence, e.g. 'user-item-user'")
    VERTEX_COL = ParamInfo("vertexCol", str, default="vertex")
    TYPE_COL = ParamInfo("typeCol", str, default="type")

    _min_inputs = 2
    _max_inputs = 2

    def _out_schema(self, *in_schemas) -> TableSchema:
        return TableSchema(["path"], [AlinkTypes.STRING])

    def _execute_impl(self, edges: MTable, types_t: MTable) -> MTable:
        from ...embedding.walks import metapath_walks

        nodes, src, dst, w = _edges_of(self, edges)
        idx = {v: i for i, v in enumerate(nodes)}
        node_types = np.asarray(["?"] * len(nodes), object)
        for v, tp in zip(types_t.col(self.get(self.VERTEX_COL)),
                         types_t.col(self.get(self.TYPE_COL))):
            j = idx.get(str(v))
            if j is not None:
                node_types[j] = str(tp)
        indptr, indices, _ = build_csr(
            src, dst, w, num_nodes=len(nodes),
            directed=not self.get(self.IS_TO_UNDIGRAPH))
        metapath = self.get(self.METAPATH).split("-")
        walks = metapath_walks(
            indptr, indices, node_types, metapath,
            num_walks=self.get(self.WALK_NUM),
            seed=self.get(self.RANDOM_SEED))
        delim = self.get(self.DELIMITER)
        out = np.asarray(
            [delim.join(nodes[v] for v in row if v >= 0) for row in walks],
            object)
        return MTable({"path": out}, TableSchema(["path"],
                                                 [AlinkTypes.STRING]))


class MetaPath2VecBatchOp(BatchOperator, HasWalkParams, HasWord2VecParams):
    """Metapath walks + SGNS end-to-end (reference:
    operator/batch/graph/MetaPath2VecBatchOp.java via APS)."""

    METAPATH = MetaPathWalkBatchOp.METAPATH
    VERTEX_COL = MetaPathWalkBatchOp.VERTEX_COL
    TYPE_COL = MetaPathWalkBatchOp.TYPE_COL
    SELECTED_COL = ParamInfo("selectedCol", str)  # unused; graph input

    _min_inputs = 2
    _max_inputs = 2
    _huge_sgns = True      # plan validator: SGNS op under ALINK_HUGE_ENGINE
    _negatives = None      # tests: a replayed negative stream

    def _out_schema(self, *in_schemas) -> TableSchema:
        return TableSchema(["word", "vec"],
                           [AlinkTypes.STRING, AlinkTypes.DENSE_VECTOR])

    def _execute_impl(self, edges: MTable, types_t: MTable) -> MTable:
        walk_op = MetaPathWalkBatchOp(self.get_params().clone())
        walks_t = walk_op._execute_impl(edges, types_t)
        delim = self.get(self.DELIMITER)
        docs = [str(v).split(delim) for v in walks_t.col("path")]
        vocab, counts = build_vocab(docs, self.get(self.MIN_COUNT))
        cfg = SkipGramConfig(
            dim=self.get(self.VECTOR_SIZE),
            window=self.get(self.WINDOW),
            negatives=self.get(self.NEGATIVE),
            epochs=self.get(self.NUM_ITER),
            batch_size=self.get(self.BATCH_SIZE),
            learning_rate=self.get(self.LEARNING_RATE),
            subsample=0.0,
            seed=self.get(self.RANDOM_SEED),
        )
        pairs = make_pairs(docs, vocab, counts, cfg.window, 0.0, cfg.seed)
        emb = train_embedding(pairs, len(vocab), counts, cfg,
                              device=self.env.device,
                              negatives=self._negatives)
        return _w2v_model_table(vocab, emb)


class LineBatchOp(BatchOperator, HasWalkParams):
    """LINE first/second-order embeddings (reference:
    operator/batch/graph/LineBatchOp.java)."""

    _huge_sgns = True      # plan validator: SGNS op under ALINK_HUGE_ENGINE
    _negatives = None      # tests: a replayed negative stream

    VECTOR_SIZE = ParamInfo("vectorSize", int, default=64)
    ORDER = ParamInfo("order", int, default=2,
                      validator=InValidator(1, 2))
    NUM_STEPS = ParamInfo("numSteps", int, default=2000)
    NEGATIVE = ParamInfo("negative", int, default=5)
    LEARNING_RATE = ParamInfo("learningRate", float, default=0.025)
    BATCH_SIZE = ParamInfo("batchSize", int, default=512,
                           validator=MinValidator(1),
                           desc="per-device edge mini-batch size")

    _min_inputs = 1
    _max_inputs = 1

    def _out_schema(self, in_schema) -> TableSchema:
        return TableSchema(["word", "vec"],
                           [AlinkTypes.STRING, AlinkTypes.DENSE_VECTOR])

    def _execute_impl(self, t: MTable) -> MTable:
        from ...embedding.walks import line_embeddings

        nodes, src, dst, w = _edges_of(self, t)
        if self.get(self.IS_TO_UNDIGRAPH):
            src, dst = (np.concatenate([src, dst]),
                        np.concatenate([dst, src]))
        emb = line_embeddings(
            src, dst, num_nodes=len(nodes),
            dim=self.get(self.VECTOR_SIZE),
            order=self.get(self.ORDER),
            num_negatives=self.get(self.NEGATIVE),
            num_steps=self.get(self.NUM_STEPS),
            batch_size=self.get(self.BATCH_SIZE),
            learning_rate=self.get(self.LEARNING_RATE),
            seed=self.get(self.RANDOM_SEED),
            device=self.env.device, negatives=self._negatives)
        vocab = {v: i for i, v in enumerate(nodes)}
        return _w2v_model_table(vocab, emb)
