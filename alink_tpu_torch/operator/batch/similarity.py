"""Similarity family: string/text similarity + nearest-neighbour search
(port of ``alink_tpu.operator.batch.similarity``).

Capability parity with the reference similarity package (reference:
core/src/main/java/com/alibaba/alink/operator/batch/similarity/
StringSimilarityPairwiseBatchOp.java, TextSimilarityPairwiseBatchOp.java,
StringNearestNeighborTrainBatchOp.java + PredictBatchOp,
VectorNearestNeighborTrainBatchOp.java + PredictBatchOp (KDTree/LSH/brute in
operator/common/similarity/ — Levenshtein/LCS/cosine/Jaccard/SimHash
calculators in similarity/lcs/, SimHashHamming.java).

Vector nearest neighbour (BRUTE) runs on the mapper's device: the training
vectors are staged there once at load, and the queries go in blocks of rows
whose (block, N) distance matrix holds about 2**28 entries, each block's k
smallest distances taken by ``torch.topk`` and ordered as ``lax.top_k``
orders them in the reference (ties to the lower training row, also where a
tie crosses the k-th place). Euclidean distances are ``sqrt(max(‖q‖² −
2q·x + ‖x‖², 0))`` and cosine normalizes with a 1e-12 floor, as the
reference; the norms, products and sums run in float64 over the float32
vectors (each product exact) and the distances are rounded to float32
before the ranking. In float32 the sums' order would show in the last
bit, and that order changes with a GEMM's shape: a query block would part
from the whole (Q, N) matrix, and the card from the CPU. In float64 it
stays far below a float32 rounding, so the blocks give the unblocked
result. LSH draws its hyperplanes from ``np.random.default_rng(0)``, the
reference's planes, and runs on the host as there (each query's Hamming
distances as popcounts of the packed signatures, the candidates by
distance level: the first candidates of the reference's stable argsort);
so do the string metrics (data-dependent dynamic programs).
"""

from __future__ import annotations

import json
from typing import Dict

import numpy as np

from ...common.exceptions import AkIllegalArgumentException
from ...common.linalg import parse_vector
from ...common.model import model_to_table, table_to_model
from ...common.mtable import AlinkTypes, MTable
from ...common.params import InValidator, MinValidator, ParamInfo
from ...mapper import (
    HasOutputCol,
    HasReservedCols,
    HasSelectedCol,
    HasSelectedCols,
    Mapper,
    ModelMapper,
)
from .base import BatchOperator
from .utils import MapBatchOp, ModelMapBatchOp, ModelTrainOpMixin


# ---------------------------------------------------------------------------
# String metrics (host-side; reference: operator/common/similarity/)
# ---------------------------------------------------------------------------

def levenshtein(a, b) -> int:
    """Edit distance over character or token sequences."""
    a, b = list(a), list(b)
    if len(a) < len(b):
        a, b = b, a
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i] + [0] * len(b)
        for j, cb in enumerate(b, 1):
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1,
                         prev[j - 1] + (ca != cb))
        prev = cur
    return prev[-1]


def lcs(a, b) -> int:
    """Longest common subsequence over character or token sequences."""
    a, b = list(a), list(b)
    if not a or not b:
        return 0
    prev = [0] * (len(b) + 1)
    for ca in a:
        cur = [0] * (len(b) + 1)
        for j, cb in enumerate(b, 1):
            cur[j] = prev[j - 1] + 1 if ca == cb else max(prev[j], cur[j - 1])
        prev = cur
    return prev[-1]


def _ngrams(s, n=2):
    toks = list(s)
    if len(toks) < n:
        return [tuple(toks)] if toks else []
    return [tuple(toks[i:i + n]) for i in range(len(toks) - n + 1)]


def _counter_cosine(ca: Dict, cb: Dict) -> float:
    if not ca or not cb:
        return 0.0
    dot = sum(v * cb.get(k, 0) for k, v in ca.items())
    na = np.sqrt(sum(v * v for v in ca.values()))
    nb = np.sqrt(sum(v * v for v in cb.values()))
    return float(dot / (na * nb)) if na > 0 and nb > 0 else 0.0


def _counts(items) -> Dict:
    d: Dict = {}
    for it in items:
        d[it] = d.get(it, 0) + 1
    return d


def _fnv64(s: str) -> int:
    """Deterministic 64-bit FNV-1a (python hash() is salted per process)."""
    h = 0xCBF29CE484222325
    for byte in s.encode("utf-8"):
        h = ((h ^ byte) * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
    return h


def simhash64(items) -> int:
    """64-bit SimHash over hashed features (reference: SimHashHamming.java)."""
    acc = np.zeros(64, np.int64)
    for it in items:
        h = _fnv64(str(it))
        for bit in range(64):
            acc[bit] += 1 if (h >> bit) & 1 else -1
    out = 0
    for bit in range(64):
        if acc[bit] > 0:
            out |= 1 << bit
    return out


def _metric(metric: str, a: str, b: str, text: bool) -> float:
    """One similarity/distance value; ``text`` tokenizes on whitespace
    (reference: TextSimilarityPairwiseBatchOp vs StringSimilarityPairwise)."""
    a = "" if a is None else str(a)
    b = "" if b is None else str(b)
    ta = a.split() if text else list(a)
    tb = b.split() if text else list(b)
    if metric == "LEVENSHTEIN":
        return float(levenshtein(ta, tb))
    if metric == "LEVENSHTEIN_SIM":
        m = max(len(ta), len(tb))
        return 1.0 - levenshtein(ta, tb) / m if m > 0 else 1.0
    if metric == "LCS":
        return float(lcs(ta, tb))
    if metric == "LCS_SIM":
        m = max(len(ta), len(tb))
        return lcs(ta, tb) / m if m > 0 else 1.0
    if metric == "COSINE":
        # char bigrams for strings, word bigrams for text — words are atoms
        return _counter_cosine(_counts(_ngrams(ta)), _counts(_ngrams(tb)))
    if metric == "JACCARD_SIM":
        sa, sb = set(ta), set(tb)
        return len(sa & sb) / len(sa | sb) if sa | sb else 1.0
    if metric == "SIMHASH_HAMMING":
        return float(bin(simhash64(ta) ^ simhash64(tb)).count("1"))
    if metric == "SIMHASH_HAMMING_SIM":
        return 1.0 - bin(simhash64(ta) ^ simhash64(tb)).count("1") / 64.0
    raise AkIllegalArgumentException(f"unknown similarity metric {metric}")


_METRICS = ("LEVENSHTEIN", "LEVENSHTEIN_SIM", "LCS", "LCS_SIM", "COSINE",
            "JACCARD_SIM", "SIMHASH_HAMMING", "SIMHASH_HAMMING_SIM")


class _PairwiseSimilarityMapper(Mapper, HasSelectedCols, HasOutputCol,
                                HasReservedCols):
    METRIC = ParamInfo("metric", str, default="LEVENSHTEIN_SIM",
                       validator=InValidator(*_METRICS))

    text_mode = False

    def output_schema(self, input_schema):
        out = self.get(HasOutputCol.OUTPUT_COL) or "similarity"
        return self._append_result_schema(input_schema, [out],
                                          [AlinkTypes.DOUBLE])

    def map_table(self, t: MTable) -> MTable:
        cols = self.get(HasSelectedCols.SELECTED_COLS)
        if not cols or len(cols) != 2:
            raise AkIllegalArgumentException(
                "pairwise similarity needs selectedCols=[colA, colB]")
        out = self.get(HasOutputCol.OUTPUT_COL) or "similarity"
        metric = self.get(self.METRIC)
        a_vals, b_vals = t.col(cols[0]), t.col(cols[1])
        vals = np.asarray(
            [_metric(metric, a, b, self.text_mode)
             for a, b in zip(a_vals, b_vals)], np.float64)
        return self._append_result(t, {out: vals}, {out: AlinkTypes.DOUBLE})


class StringSimilarityPairwiseMapper(_PairwiseSimilarityMapper):
    text_mode = False


class TextSimilarityPairwiseMapper(_PairwiseSimilarityMapper):
    text_mode = True


class StringSimilarityPairwiseBatchOp(MapBatchOp, HasSelectedCols,
                                      HasOutputCol, HasReservedCols):
    mapper_cls = StringSimilarityPairwiseMapper
    METRIC = _PairwiseSimilarityMapper.METRIC


class TextSimilarityPairwiseBatchOp(MapBatchOp, HasSelectedCols,
                                    HasOutputCol, HasReservedCols):
    mapper_cls = TextSimilarityPairwiseMapper
    METRIC = _PairwiseSimilarityMapper.METRIC


# ---------------------------------------------------------------------------
# String / text nearest neighbour (top-N join against a trained corpus)
# ---------------------------------------------------------------------------

class StringNearestNeighborTrainBatchOp(ModelTrainOpMixin, BatchOperator,
                                        HasSelectedCol):
    """Stores the corpus (id, string) — predict does the scan (reference:
    StringNearestNeighborTrainBatchOp.java)."""

    ID_COL = ParamInfo("idCol", str, optional=False)
    METRIC = ParamInfo("metric", str, default="LEVENSHTEIN_SIM",
                       validator=InValidator(*_METRICS))

    _min_inputs = 1
    _max_inputs = 1

    text_mode = False

    def _execute_impl(self, t: MTable) -> MTable:
        ids = [str(v) for v in t.col(self.get(self.ID_COL))]
        strs = [str(v) for v in t.col(self.get(HasSelectedCol.SELECTED_COL))]
        meta = {
            "modelName": "StringNearestNeighborModel",
            "metric": self.get(self.METRIC),
            "textMode": self.text_mode,
            "ids": ids,
            "corpus": strs,
        }
        return model_to_table(meta, {})

    def _static_meta_keys(self, in_schema):
        return {"modelName": "StringNearestNeighborModel"}


class TextNearestNeighborTrainBatchOp(StringNearestNeighborTrainBatchOp):
    text_mode = True


class StringNearestNeighborModelMapper(ModelMapper, HasSelectedCol,
                                       HasOutputCol, HasReservedCols):
    TOP_N = ParamInfo("topN", int, default=3, validator=MinValidator(1))

    def load_model(self, model: MTable):
        self.meta, _ = table_to_model(model)
        return self

    def output_schema(self, input_schema):
        out = self.get(HasOutputCol.OUTPUT_COL) or "topN"
        return self._append_result_schema(input_schema, [out],
                                          [AlinkTypes.STRING])

    def map_table(self, t: MTable) -> MTable:
        out = self.get(HasOutputCol.OUTPUT_COL) or "topN"
        col = self.get(HasSelectedCol.SELECTED_COL)
        metric = self.meta["metric"]
        text = self.meta["textMode"]
        higher_better = metric.endswith("_SIM") or metric == "COSINE"
        k = int(self.get(self.TOP_N))
        ids, corpus = self.meta["ids"], self.meta["corpus"]
        results = []
        for q in t.col(col):
            scores = [_metric(metric, str(q), c, text) for c in corpus]
            order = np.argsort(scores)
            order = order[::-1] if higher_better else order
            top = [(ids[i], float(scores[i])) for i in order[:k]]
            results.append(json.dumps(dict(top)))
        return self._append_result(
            t, {out: np.asarray(results, object)}, {out: AlinkTypes.STRING})


class StringNearestNeighborPredictBatchOp(ModelMapBatchOp, HasSelectedCol,
                                          HasOutputCol, HasReservedCols):
    mapper_cls = StringNearestNeighborModelMapper
    TOP_N = StringNearestNeighborModelMapper.TOP_N


class TextNearestNeighborPredictBatchOp(StringNearestNeighborPredictBatchOp):
    pass


# ---------------------------------------------------------------------------
# Vector nearest neighbour
# ---------------------------------------------------------------------------

class VectorNearestNeighborTrainBatchOp(ModelTrainOpMixin, BatchOperator,
                                        HasSelectedCol):
    """(reference: VectorNearestNeighborTrainBatchOp.java — stores vectors;
    KDTree/LSH/brute solvers live in the predict mapper)"""

    ID_COL = ParamInfo("idCol", str, optional=False)
    METRIC = ParamInfo("metric", str, default="EUCLIDEAN",
                       validator=InValidator("EUCLIDEAN", "COSINE"))

    _min_inputs = 1
    _max_inputs = 1

    def _execute_impl(self, t: MTable) -> MTable:
        ids = [str(v) for v in t.col(self.get(self.ID_COL))]
        X = np.stack([parse_vector(v).to_dense().data
                      for v in t.col(self.get(HasSelectedCol.SELECTED_COL))])
        meta = {
            "modelName": "VectorNearestNeighborModel",
            "metric": self.get(self.METRIC),
            "ids": ids,
            "dim": int(X.shape[1]),
        }
        return model_to_table(meta, {"X": X.astype(np.float32)})

    def _static_meta_keys(self, in_schema):
        return {"modelName": "VectorNearestNeighborModel"}


class VectorNearestNeighborModelMapper(ModelMapper, HasSelectedCol,
                                       HasOutputCol, HasReservedCols):
    """Blocked brute-force top-N on device; optional LSH prefilter
    (reference: operator/common/similarity/NearestNeighborsMapper + lsh/)."""

    TOP_N = ParamInfo("topN", int, default=3, validator=MinValidator(1))
    SOLVER = ParamInfo("solver", str, default="BRUTE",
                       validator=InValidator("BRUTE", "LSH"))
    NUM_HASH_BITS = ParamInfo("numHashBits", int, default=16)

    # a query block's distance matrix holds about this many float32s
    BLOCK_ELEMENTS = 1 << 28

    def load_model(self, model: MTable):
        self.meta, arrays = table_to_model(model)
        self.X = arrays["X"]
        self._k = min(int(self.get(self.TOP_N)), self.X.shape[0])
        if self.get(self.SOLVER) == "LSH":
            rng = np.random.default_rng(0)
            bits = int(self.get(self.NUM_HASH_BITS))
            self._planes = rng.normal(
                size=(self.X.shape[1], bits)).astype(np.float32)
            self._sigs = (self.X @ self._planes > 0)
            self._packed = np.packbits(self._sigs, axis=1)
        else:
            import torch

            from ...common.env import resolve_device

            self._dev = resolve_device(self.device)
            X = torch.as_tensor(np.ascontiguousarray(self.X, np.float32),
                                device=self._dev).double()
            if self.meta["metric"] == "COSINE":
                X = X / torch.clamp(torch.linalg.norm(X, dim=1, keepdim=True),
                                    min=1e-12)
            else:
                self._xsq = (X * X).sum(1)
            self._X64 = X
        return self

    def topn(self, Q: np.ndarray):
        """The k nearest training rows of each query row (ids, distances),
        on the device, in query blocks."""
        import torch

        n = self.X.shape[0]
        block = max(1, min(len(Q), self.BLOCK_ELEMENTS // max(n, 1)))
        idx_out, d_out = [], []
        for start in range(0, len(Q), block):
            q = torch.as_tensor(Q[start:start + block],
                                device=self._dev).double()
            if self.meta["metric"] == "COSINE":
                q = q / torch.clamp(torch.linalg.norm(q, dim=1, keepdim=True),
                                    min=1e-12)
                d = (q @ self._X64.T).neg_().add_(1.0)
            else:
                # true Euclidean distance in the emitted JSON, matching the
                # reference's EuclideanDistance (clip guards negatives)
                d = (q @ self._X64.T).mul_(-2.0)
                d.add_((q * q).sum(1)[:, None]).add_(self._xsq[None, :])
                d = d.clamp_(min=0.0).sqrt_()
            d = d.float()
            i, v = smallest_k(d, self._k)
            del d
            idx_out.append(i.cpu().numpy())
            d_out.append(v.cpu().numpy())
        return np.concatenate(idx_out), np.concatenate(d_out)

    def output_schema(self, input_schema):
        out = self.get(HasOutputCol.OUTPUT_COL) or "topN"
        return self._append_result_schema(input_schema, [out],
                                          [AlinkTypes.STRING])

    def _nearest_codes(self, code: np.ndarray, n: int) -> np.ndarray:
        """The n training rows nearest ``code`` in Hamming distance, in
        ``np.argsort(ham, kind="stable")[:n]``'s order (distance, then
        row), from the packed signatures' popcounts by distance level."""
        ham = _POPCOUNT[self._packed ^ code].sum(axis=1, dtype=np.int64)
        level = int(np.searchsorted(np.cumsum(np.bincount(ham)), n))
        below = np.flatnonzero(ham < level)
        below = below[np.argsort(ham[below], kind="stable")]
        return np.concatenate(
            [below, np.flatnonzero(ham == level)[:n - len(below)]])

    def query_block(self, col) -> np.ndarray:
        """The query vectors as one float32 block, parsed and stacked."""
        return np.stack([parse_vector(v).to_dense().data for v in col]) \
            .astype(np.float32)

    def results_json(self, idx: np.ndarray, dist: np.ndarray) -> list:
        """One ``{id: distance}`` JSON object a query row."""
        ids = self.meta["ids"]
        return [json.dumps({ids[int(i)]: float(dv)
                            for i, dv in zip(row_i, row_d)})
                for row_i, row_d in zip(idx, dist)]

    def map_table(self, t: MTable) -> MTable:
        out = self.get(HasOutputCol.OUTPUT_COL) or "topN"
        col = self.get(HasSelectedCol.SELECTED_COL)
        Q = self.query_block(t.col(col))
        ids = self.meta["ids"]
        if self.get(self.SOLVER) == "LSH":
            # hamming prefilter: rerank the best bucket candidates exactly
            qs = (Q @ self._planes > 0)
            results = []
            k = int(self.get(self.TOP_N))
            n_cand = min(max(4 * k, 32), self.X.shape[0])
            packed = np.packbits(qs, axis=1)
            for qi in range(Q.shape[0]):
                cand = self._nearest_codes(packed[qi], n_cand)
                d = np.sqrt(np.maximum(
                    ((self.X[cand] - Q[qi]) ** 2).sum(axis=1), 0.0))
                if self.meta["metric"] == "COSINE":
                    xn = self.X[cand] / np.maximum(
                        np.linalg.norm(self.X[cand], axis=1, keepdims=True),
                        1e-12)
                    qn = Q[qi] / max(np.linalg.norm(Q[qi]), 1e-12)
                    d = 1.0 - xn @ qn
                order = np.argsort(d, kind="stable")[:k]
                results.append(json.dumps(
                    {ids[int(cand[i])]: float(d[i]) for i in order}))
        else:
            results = self.results_json(*self.topn(Q))
        return self._append_result(
            t, {out: np.asarray(results, object)}, {out: AlinkTypes.STRING})


_POPCOUNT = np.unpackbits(np.arange(256, dtype=np.uint8)[:, None],
                          axis=1).sum(axis=1).astype(np.uint8)


def smallest_k(d, k: int):
    """The k smallest entries of each row of ``d`` (indices, values), in
    ``lax.top_k``'s order of ``-d``: ascending, equal values by ascending
    index. ``torch.topk`` finds the k; a row where a value equal to its
    k-th crosses the k-th place is sorted whole (stable)."""
    import torch

    vals, idx = torch.topk(d, k, dim=1, largest=False, sorted=True)
    order = torch.argsort(idx, dim=1)
    idx, vals = idx.gather(1, order), vals.gather(1, order)
    order = torch.sort(vals, dim=1, stable=True).indices
    idx, vals = idx.gather(1, order), vals.gather(1, order)
    crossing = ((d <= vals[:, -1:]).sum(1) > k).nonzero().flatten()
    for r in crossing.tolist():
        v, i = torch.sort(d[r], stable=True)
        vals[r], idx[r] = v[:k], i[:k]
    return idx, vals


class VectorNearestNeighborPredictBatchOp(ModelMapBatchOp, HasSelectedCol,
                                          HasOutputCol, HasReservedCols):
    mapper_cls = VectorNearestNeighborModelMapper
    TOP_N = VectorNearestNeighborModelMapper.TOP_N
    SOLVER = VectorNearestNeighborModelMapper.SOLVER
