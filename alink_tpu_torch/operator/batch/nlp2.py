"""NLP/similarity long-tail: NaiveBayesText and approximate nearest
neighbors (SimHash / LSH) (port of ``alink_tpu.operator.batch.nlp2``).

NaiveBayesText's per-class term counts are one product ``Yᵀ·X`` on the
session's device (float32: counts below 2**24 are exact in any order of
addition); the rest is host code, copied.

Capability parity (reference: operator/batch/classification/
NaiveBayesTextTrainBatchOp.java / NaiveBayesTextPredictBatchOp.java;
similarity/StringApproxNearestNeighborTrainBatchOp.java /
StringApproxNearestNeighborPredictBatchOp.java /
TextApproxNearestNeighbor*.java — SimHash+Hamming approximate search;
VectorApproxNearestNeighbor*.java — LSH-prefiltered vector search).
"""

from __future__ import annotations

import json

import numpy as np

from ...common.exceptions import AkIllegalDataException
from ...common.linalg import stack_vectors
from ...common.model import model_to_table, table_to_model
from ...common.mtable import AlinkTypes, MTable
from ...common.params import InValidator, ParamInfo
from ...mapper import (
    HasOutputCol,
    HasPredictionCol,
    HasPredictionDetailCol,
    HasReservedCols,
    HasSelectedCol,
    HasVectorCol,
    ModelMapper,
    detail_json,
    np_labels,
)
from .base import BatchOperator
from .similarity import (
    StringNearestNeighborModelMapper,
    StringNearestNeighborPredictBatchOp,
    StringNearestNeighborTrainBatchOp,
    VectorNearestNeighborPredictBatchOp,
    VectorNearestNeighborTrainBatchOp,
    simhash64,
)
from .utils import ModelMapBatchOp, ModelTrainOpMixin


# ---------------------------------------------------------------------------
# NaiveBayesText — multinomial/bernoulli NB over term-count vectors
# ---------------------------------------------------------------------------


class NaiveBayesTextTrainBatchOp(ModelTrainOpMixin, BatchOperator,
                                 HasVectorCol):
    """Multinomial (or Bernoulli) naive Bayes over a term-count vector
    column — class-conditional log-probabilities via ONE counts matmul on
    the device (reference: operator/batch/classification/
    NaiveBayesTextTrainBatchOp.java; the reference aggregates per-class
    term counts the same way, row-wise on Flink)."""

    LABEL_COL = ParamInfo("labelCol", str, optional=False)
    MODEL_TYPE = ParamInfo("modelType", str, default="Multinomial",
                           validator=InValidator("Multinomial", "Bernoulli"))
    SMOOTHING = ParamInfo("smoothing", float, default=1.0)

    _min_inputs = 1
    _max_inputs = 1

    def _static_meta_keys(self, in_schema):
        return {
            "modelName": "NaiveBayesTextModel",
            "labelType": in_schema.type_of(self.get(self.LABEL_COL)),
        }

    def _execute_impl(self, t: MTable) -> MTable:
        import torch

        from ...common.env import resolve_device

        device = resolve_device(self.env.device)
        vec_col = self.get(HasVectorCol.VECTOR_COL)
        if not vec_col:
            raise AkIllegalDataException(
                "NaiveBayesTextTrainBatchOp needs vectorCol (term counts)")
        label_col = self.get(self.LABEL_COL)
        X = stack_vectors(t.col(vec_col)).astype(np.float32)
        if self.get(self.MODEL_TYPE) == "Bernoulli":
            X = (X > 0).astype(np.float32)
        y_raw = t.col(label_col)
        labels = sorted(set(np.asarray(y_raw).tolist()), key=str)
        lab_to_idx = {v: i for i, v in enumerate(labels)}
        Y = np.eye(len(labels), dtype=np.float32)[
            np.asarray([lab_to_idx[v] for v in y_raw])]
        alpha = float(self.get(self.SMOOTHING))
        # (K, d) per-class term counts in one contraction
        counts = (torch.as_tensor(Y, device=device).T
                  @ torch.as_tensor(X, device=device)).cpu().numpy() + alpha
        if self.get(self.MODEL_TYPE) == "Bernoulli":
            docs = Y.sum(0)[:, None] + 2 * alpha
            logp = np.log(counts / docs)
            log1m = np.log1p(-np.clip(counts / docs, 1e-12, 1 - 1e-12))
        else:
            logp = np.log(counts / counts.sum(1, keepdims=True))
            log1m = np.zeros_like(logp)
        priors = np.log(Y.sum(0) / len(X))
        meta = {
            "modelName": "NaiveBayesTextModel",
            "modelType": self.get(self.MODEL_TYPE),
            "vectorCol": vec_col,
            "labelCol": label_col,
            "labelType": t.schema.type_of(label_col),
            "labels": labels,
            "dim": int(X.shape[1]),
        }
        return model_to_table(meta, {"logp": logp, "log1m": log1m,
                                     "priors": priors})


class NaiveBayesTextModelMapper(ModelMapper, HasPredictionCol,
                                HasPredictionDetailCol, HasReservedCols,
                                HasVectorCol):
    def load_model(self, model: MTable):
        self.meta, a = table_to_model(model)
        self.logp = a["logp"].astype(np.float64)
        self.log1m = a["log1m"].astype(np.float64)
        self.priors = a["priors"].astype(np.float64)
        return self

    def output_schema(self, input_schema):
        names = [self.get(HasPredictionCol.PREDICTION_COL)]
        types = [self.meta.get("labelType", AlinkTypes.STRING)]
        if self.get(HasPredictionDetailCol.PREDICTION_DETAIL_COL):
            names.append(
                self.get(HasPredictionDetailCol.PREDICTION_DETAIL_COL))
            types.append(AlinkTypes.STRING)
        return self._append_result_schema(input_schema, names, types)

    def map_table(self, t: MTable) -> MTable:
        vec_col = (self.get(HasVectorCol.VECTOR_COL) or
                   self.meta["vectorCol"])
        X = stack_vectors(t.col(vec_col),
                          size=self.meta["dim"]).astype(np.float64)
        if self.meta["modelType"] == "Bernoulli":
            Xb = (X > 0).astype(np.float64)
            scores = (Xb @ self.logp.T + (1 - Xb) @ self.log1m.T
                      + self.priors[None, :])
        else:
            scores = X @ self.logp.T + self.priors[None, :]
        # normalized posteriors for the detail column
        m = scores.max(1, keepdims=True)
        probs = np.exp(scores - m)
        probs /= probs.sum(1, keepdims=True)
        idx = scores.argmax(1)
        labels = self.meta["labels"]
        pred = np_labels(labels, self.meta.get("labelType",
                                               AlinkTypes.STRING), idx)
        add = {self.get(HasPredictionCol.PREDICTION_COL): pred}
        types = {self.get(HasPredictionCol.PREDICTION_COL):
                 self.meta.get("labelType", AlinkTypes.STRING)}
        detail_col = self.get(HasPredictionDetailCol.PREDICTION_DETAIL_COL)
        if detail_col:
            add[detail_col] = detail_json(labels, probs)
            types[detail_col] = AlinkTypes.STRING
        return self._append_result(t, add, types)


class NaiveBayesTextPredictBatchOp(ModelMapBatchOp, HasPredictionCol,
                                   HasPredictionDetailCol, HasReservedCols,
                                   HasVectorCol):
    """(reference: operator/batch/classification/
    NaiveBayesTextPredictBatchOp.java)"""

    mapper_cls = NaiveBayesTextModelMapper


# ---------------------------------------------------------------------------
# approximate nearest neighbors
# ---------------------------------------------------------------------------


class StringApproxNearestNeighborTrainBatchOp(
        StringNearestNeighborTrainBatchOp):
    """Approximate string search: the corpus is indexed by 64-bit SimHash
    signatures; queries scan Hamming distances on the packed signatures
    instead of computing the exact pairwise metric (reference:
    similarity/StringApproxNearestNeighborTrainBatchOp.java — the
    SIMHASH_HAMMING family)."""

    METRIC = ParamInfo(
        "metric", str, default="SIMHASH_HAMMING_SIM",
        validator=InValidator("SIMHASH_HAMMING_SIM", "SIMHASH_HAMMING"))

    def _execute_impl(self, t: MTable) -> MTable:
        ids = [str(v) for v in t.col(self.get(self.ID_COL))]
        strs = [str(v) for v in t.col(self.get(HasSelectedCol.SELECTED_COL))]
        sigs = [simhash64(self._items(s)) for s in strs]
        # only ids + signatures serve queries — the raw corpus would
        # multiply model size for nothing at "huge" scale
        meta = {
            "modelName": "StringApproxNearestNeighborModel",
            "metric": self.get(self.METRIC),
            "textMode": self.text_mode,
            "ids": ids,
        }
        return model_to_table(
            meta, {"signatures": np.asarray(sigs, np.uint64)})

    def _items(self, s: str):
        return s.split() if self.text_mode else list(s)

    def _static_meta_keys(self, in_schema):
        return {"modelName": "StringApproxNearestNeighborModel"}


class TextApproxNearestNeighborTrainBatchOp(
        StringApproxNearestNeighborTrainBatchOp):
    """(reference: similarity/TextApproxNearestNeighborTrainBatchOp.java)"""

    text_mode = True


class StringApproxNearestNeighborModelMapper(StringNearestNeighborModelMapper):
    def load_model(self, model: MTable):
        self.meta, a = table_to_model(model)
        self.sigs = a["signatures"].astype(np.uint64)
        return self

    def map_table(self, t: MTable) -> MTable:
        out = self.get(HasOutputCol.OUTPUT_COL) or "topN"
        col = self.get(HasSelectedCol.SELECTED_COL)
        sim_mode = self.meta["metric"].endswith("_SIM")
        text = self.meta["textMode"]
        k = int(self.get(self.TOP_N))
        ids = self.meta["ids"]
        sigs = self.sigs
        results = []
        for q in t.col(col):
            items = str(q).split() if text else list(str(q))
            qs = np.uint64(simhash64(items))
            # vectorized Hamming over the packed signatures
            x = np.bitwise_xor(sigs, qs)
            dist = np.unpackbits(x.view(np.uint8).reshape(len(sigs), 8),
                                 axis=1).sum(1)
            scores = 1.0 - dist / 64.0 if sim_mode else dist.astype(float)
            order = np.argsort(-scores if sim_mode else scores)
            top = [(ids[i], float(scores[i])) for i in order[:k]]
            results.append(json.dumps(dict(top)))
        return self._append_result(
            t, {out: np.asarray(results, object)}, {out: AlinkTypes.STRING})


class StringApproxNearestNeighborPredictBatchOp(
        StringNearestNeighborPredictBatchOp):
    """(reference: similarity/
    StringApproxNearestNeighborPredictBatchOp.java)"""

    mapper_cls = StringApproxNearestNeighborModelMapper


class TextApproxNearestNeighborPredictBatchOp(
        StringApproxNearestNeighborPredictBatchOp):
    """(reference: similarity/TextApproxNearestNeighborPredictBatchOp.java)"""


class VectorApproxNearestNeighborTrainBatchOp(
        VectorNearestNeighborTrainBatchOp):
    """(reference: similarity/VectorApproxNearestNeighborTrainBatchOp.java —
    the LSH-prefiltered vector index; the solver preset is the only
    difference from the exact trainer)."""


class VectorApproxNearestNeighborPredictBatchOp(
        VectorNearestNeighborPredictBatchOp):
    """LSH-prefiltered vector search preset (reference: similarity/
    VectorApproxNearestNeighborPredictBatchOp.java)."""

    def __init__(self, params=None, **kw):
        kw.setdefault("solver", "LSH")
        super().__init__(params, **kw)
