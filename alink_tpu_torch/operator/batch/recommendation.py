"""Recommendation operators: ALS train + serving kernels, ItemCF/UserCF,
Swing, FM and DeepFM recommenders (port of
``alink_tpu.operator.batch.recommendation``).

Capability parity with the reference (reference:
operator/batch/recommendation/AlsTrainBatchOp.java (block ALS via
HugeMfAlsImpl.java:326), AlsRateRecommBatchOp / AlsItemsPerUserRecommBatchOp /
AlsUsersPerItemRecommBatchOp / AlsSimilarItemsRecommBatchOp, ItemCfTrainBatchOp
/ UserCfTrainBatchOp / SwingTrainBatchOp and their *RecommBatchOp serving ops —
all served through the RecommKernel/RecommMapper layer,
operator/common/recommendation/RecommKernel.java).

On the session's device: ALS training (``recommendation.train_als``), the
CF similarity products (``recommendation.interaction_similarity``), FM and
DeepFM training (full-batch autograd under optax's Adam, step for step:
``dl.train.Optimizer``, initial weights from ``np.random.default_rng``),
DeepFM scoring, and the ALS top-K kernels: ``Q·Fᵀ`` in float64 over the
float32 factors, rounded to float32, then the K largest in ``lax.top_k``'s
order (ties to the lower index). The rate kernel, the CF serving loops and
Swing stay on the host, as in the reference (the CF loops run the
reference's ``np.argsort`` on the same float32 scores). The recommendation
column is the reference's JSON format {"object":[...],"rate":[...]}.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional

import numpy as np

from ...common.exceptions import (AkIllegalArgumentException,
                                  AkIllegalDataException)
from ...common.model import model_to_table, table_to_model
from ...common.mtable import AlinkTypes, MTable, TableSchema
from ...common.params import MinValidator, ParamInfo
from ...mapper import HasPredictionCol, HasReservedCols, ModelMapper
from ...recommendation import (
    interaction_similarity,
    swing_similarity,
    train_als,
)
from .base import BatchOperator
from .utils import ModelMapBatchOp, ModelTrainOpMixin


class HasRecommTripleCols:
    USER_COL = ParamInfo("userCol", str, optional=False)
    ITEM_COL = ParamInfo("itemCol", str, optional=False)
    RATE_COL = ParamInfo("rateCol", str)


# ---------------------------------------------------------------------------
# ALS
# ---------------------------------------------------------------------------

class AlsTrainBatchOp(ModelTrainOpMixin, BatchOperator, HasRecommTripleCols):
    """(reference: AlsTrainBatchOp.java → HugeMfAlsImpl block sweeps)"""

    RANK = ParamInfo("rank", int, default=10, validator=MinValidator(1))
    NUM_ITER = ParamInfo("numIter", int, default=10, validator=MinValidator(1))
    LAMBDA = ParamInfo("lambda", float, default=0.1, aliases=("lambda_",))
    IMPLICIT_PREFS = ParamInfo("implicitPrefs", bool, default=False)
    ALPHA = ParamInfo("alpha", float, default=40.0)
    RANDOM_SEED = ParamInfo("randomSeed", int, default=0, aliases=("seed",))

    _min_inputs = 1
    _max_inputs = 1

    def _static_meta_keys(self, in_schema):
        return {
            "modelName": "AlsModel",
            "userCol": self.get(self.USER_COL),
            "itemCol": self.get(self.ITEM_COL),
        }

    def _max_neighbors(self) -> int:
        """Per-entity neighbor-list cap; 0 = uncapped. The ForHotPoint
        variants override this (recommendation2._HotPointMixin)."""
        return 0

    def _extra_meta(self) -> dict:
        return {}

    def _execute_impl(self, t: MTable) -> MTable:
        user_col = self.get(self.USER_COL)
        item_col = self.get(self.ITEM_COL)
        rate_col = self.get(self.RATE_COL)
        rates = (np.asarray(t.col(rate_col), np.float32) if rate_col
                 else np.ones(t.num_rows, np.float32))
        model = train_als(
            np.asarray(t.col(user_col)), np.asarray(t.col(item_col)), rates,
            rank=self.get(self.RANK), num_iter=self.get(self.NUM_ITER),
            lam=self.get(self.LAMBDA),
            implicit=self.get(self.IMPLICIT_PREFS),
            alpha=self.get(self.ALPHA), seed=self.get(self.RANDOM_SEED),
            max_neighbors=self._max_neighbors(),
            device=self.env.device,
        )
        meta = {
            "modelName": "AlsModel",
            "userCol": user_col,
            "itemCol": item_col,
            "rateCol": rate_col,
            "rank": self.get(self.RANK),
            "implicitPrefs": self.get(self.IMPLICIT_PREFS),
            **self._extra_meta(),
        }
        return model_to_table(meta, {
            "userIds": model.user_ids,
            "itemIds": model.item_ids,
            "userFactors": model.user_factors,
            "itemFactors": model.item_factors,
        })


class _AlsRecommMapper(ModelMapper, HasPredictionCol, HasReservedCols):
    """Shared ALS serving state (RecommKernel analog)."""

    USER_COL = ParamInfo("userCol", str)
    ITEM_COL = ParamInfo("itemCol", str)
    K = ParamInfo("k", int, default=10)

    # a query block's score matrix holds at most this many entries
    BLOCK_ELEMENTS = 1 << 26

    def load_model(self, model: MTable):
        self.meta, arrays = table_to_model(model)
        self.user_ids = arrays["userIds"]
        self.item_ids = arrays["itemIds"]
        self.U = arrays["userFactors"].astype(np.float32)
        self.V = arrays["itemFactors"].astype(np.float32)
        self.u_index = {v: i for i, v in enumerate(self.user_ids.tolist())}
        self.i_index = {v: i for i, v in enumerate(self.item_ids.tolist())}
        return self

    def _topk(self, F: np.ndarray, Q: np.ndarray, k: int):
        """``lax.top_k(Q @ F.T, k)`` on the mapper's device: the scores
        summed in float64 over the float32 factors and rounded to float32
        (a query block gives the whole product's scores, the card the
        CPU's), the k largest of each row with ties to the lower index."""
        import torch

        from ...common.env import resolve_device
        from ...recommendation.cf import largest_k

        dev = resolve_device(self.device)
        Ft = torch.as_tensor(np.ascontiguousarray(F, np.float32),
                             device=dev).double()
        block = max(1, self.BLOCK_ELEMENTS // max(F.shape[0], 1))
        scores, idx = [], []
        for s in range(0, len(Q), block):
            q = torch.as_tensor(np.ascontiguousarray(Q[s:s + block],
                                                     np.float32),
                                device=dev).double()
            i, v = largest_k((q @ Ft.T).float(), k)
            scores.append(v.cpu().numpy())
            idx.append(i.cpu().numpy())
        if not scores:
            return np.zeros((0, k), np.float32), np.zeros((0, k), np.int64)
        return np.concatenate(scores), np.concatenate(idx)

    def _lookup(self, col_vals, index) -> np.ndarray:
        # FM trainers store ids as strings (np.unique over astype(str));
        # ALS keeps native dtypes — accept either at serving time
        return np.asarray(
            [index.get(v, index.get(str(v), -1)) for v in col_vals],
            np.int64)

    def _out_col(self) -> str:
        return self.get(HasPredictionCol.PREDICTION_COL) or "recomm"


def _recomm_json(ids: np.ndarray, scores: np.ndarray, valid: bool) -> str:
    if not valid:
        return json.dumps({"object": [], "rate": []})
    return json.dumps({
        "object": [v.item() if hasattr(v, "item") else v for v in ids],
        "rate": [round(float(s), 6) for s in scores],
    })


def _histories(keys: np.ndarray, others: np.ndarray,
               rates: np.ndarray) -> Dict[int, list]:
    """key → [(other, rate), ...] in interaction order (a stable sort by
    key), as Python ints and floats."""
    order = np.argsort(keys, kind="stable")
    ks = np.asarray(keys)[order]
    starts = np.flatnonzero(np.r_[True, ks[1:] != ks[:-1]])
    bounds = np.r_[starts, len(ks)].tolist()
    pairs = list(zip(np.asarray(others)[order].tolist(),
                     np.asarray(rates)[order].tolist()))
    return {k: pairs[a:b] for k, a, b in
            zip(ks[starts].tolist(), bounds[:-1], bounds[1:])}


def adam_fit(init: Dict[str, np.ndarray], loss, lr: float, epochs: int,
             device) -> Dict[str, np.ndarray]:
    """Full-batch training of ``init``'s arrays (float32) on ``device``:
    ``epochs`` steps of optax's ``adam(lr)``, step for step
    (``dl.train.Optimizer``), each on the gradient of ``loss(params)``.
    Returns the trained arrays on the host."""
    import torch

    from ...dl.train import Optimizer

    params = {k: torch.tensor(np.asarray(v, np.float32), device=device,
                              requires_grad=True) for k, v in init.items()}
    opt = Optimizer("adam", lambda _count: lr, params)
    for _ in range(epochs):
        grads = torch.autograd.grad(loss(params), opt.params)
        opt.step(grads)
    return {k: v.detach().cpu().numpy() for k, v in params.items()}


def deepfm_score(p, uu, ii):
    """DeepFM: w0 + bu + bi + <Vu, Vi> + MLP([Vu, Vi]) with one tanh
    layer."""
    import torch

    eu, ei = p["U"][uu], p["V"][ii]
    fm = p["w0"] + p["bu"][uu] + p["bi"][ii] + (eu * ei).sum(-1)
    h = torch.tanh(torch.cat([eu, ei], -1) @ p["W1"] + p["b1"])
    return fm + (h @ p["W2"])[:, 0] + p["b2"][0]


class AlsRateRecommMapper(_AlsRecommMapper):
    def output_schema(self, input_schema: TableSchema) -> TableSchema:
        return self._append_result_schema(
            input_schema, [self._out_col()], [AlinkTypes.DOUBLE]
        )

    def map_table(self, t: MTable) -> MTable:
        u = self._lookup(t.col(self.get(self.USER_COL) or
                               self.meta["userCol"]), self.u_index)
        i = self._lookup(t.col(self.get(self.ITEM_COL) or
                               self.meta["itemCol"]), self.i_index)
        known = (u >= 0) & (i >= 0)
        scores = np.einsum(
            "nk,nk->n", self.U[np.maximum(u, 0)], self.V[np.maximum(i, 0)]
        ).astype(np.float64)
        scores[~known] = np.nan
        out = self._out_col()
        return self._append_result(t, {out: scores}, {out: AlinkTypes.DOUBLE})


class _AlsTopKMapper(_AlsRecommMapper):
    _query_side = "user"  # user -> items | item -> users | item -> items

    def output_schema(self, input_schema: TableSchema) -> TableSchema:
        return self._append_result_schema(
            input_schema, [self._out_col()], [AlinkTypes.STRING]
        )

    def map_table(self, t: MTable) -> MTable:
        k = self.get(self.K)
        if self._query_side == "user":
            col = self.get(self.USER_COL) or self.meta["userCol"]
            q_idx = self._lookup(t.col(col), self.u_index)
            Q, F, obj_ids = self.U, self.V, self.item_ids
        elif self._query_side == "item":
            col = self.get(self.ITEM_COL) or self.meta["itemCol"]
            q_idx = self._lookup(t.col(col), self.i_index)
            Q, F, obj_ids = self.V, self.U, self.user_ids
        else:  # similar items: cosine over item factors
            col = self.get(self.ITEM_COL) or self.meta["itemCol"]
            q_idx = self._lookup(t.col(col), self.i_index)
            Vn = self.V / np.maximum(
                np.linalg.norm(self.V, axis=1, keepdims=True), 1e-12
            )
            Q, F, obj_ids = Vn, Vn, self.item_ids

        kk = min(k + (1 if self._query_side == "similar" else 0), F.shape[0])
        queries = Q[np.maximum(q_idx, 0)]
        scores, idx = self._topk(F, queries.astype(np.float32), kk)
        rows = []
        for r, (si, sc) in enumerate(zip(idx, scores)):
            if q_idx[r] < 0:
                rows.append(_recomm_json(np.empty(0), np.empty(0), False))
                continue
            if self._query_side == "similar":
                keep = si != q_idx[r]
                si, sc = si[keep][:k], sc[keep][:k]
            rows.append(_recomm_json(obj_ids[si], sc, True))
        out = self._out_col()
        return self._append_result(
            t, {out: np.asarray(rows, object)}, {out: AlinkTypes.STRING}
        )


class AlsItemsPerUserRecommMapper(_AlsTopKMapper):
    _query_side = "user"


class AlsUsersPerItemRecommMapper(_AlsTopKMapper):
    _query_side = "item"


class AlsSimilarItemsRecommMapper(_AlsTopKMapper):
    _query_side = "similar"


class _RecommOpBase(ModelMapBatchOp, HasPredictionCol, HasReservedCols):
    USER_COL = _AlsRecommMapper.USER_COL
    ITEM_COL = _AlsRecommMapper.ITEM_COL
    K = _AlsRecommMapper.K


class AlsRateRecommBatchOp(_RecommOpBase):
    mapper_cls = AlsRateRecommMapper


class AlsItemsPerUserRecommBatchOp(_RecommOpBase):
    mapper_cls = AlsItemsPerUserRecommMapper


class AlsUsersPerItemRecommBatchOp(_RecommOpBase):
    mapper_cls = AlsUsersPerItemRecommMapper


class AlsSimilarItemsRecommBatchOp(_RecommOpBase):
    mapper_cls = AlsSimilarItemsRecommMapper


# ---------------------------------------------------------------------------
# ItemCF / UserCF / Swing
# ---------------------------------------------------------------------------

class _CfTrainBase(ModelTrainOpMixin, BatchOperator, HasRecommTripleCols):
    SIMILARITY_TYPE = ParamInfo("similarityType", str, default="cosine")
    MAX_NEIGHBOR = ParamInfo("maxNeighborNumber", int, default=64,
                             aliases=("topK",))

    _min_inputs = 1
    _max_inputs = 1

    _kind = "item"
    _model_name = "ItemCfModel"

    def _static_meta_keys(self, in_schema):
        return {
            "modelName": self._model_name,
            "userCol": self.get(self.USER_COL),
            "itemCol": self.get(self.ITEM_COL),
        }

    def _execute_impl(self, t: MTable) -> MTable:
        user_col = self.get(self.USER_COL)
        item_col = self.get(self.ITEM_COL)
        rate_col = self.get(self.RATE_COL)
        users = np.asarray(t.col(user_col))
        items = np.asarray(t.col(item_col))
        rates = (np.asarray(t.col(rate_col), np.float32) if rate_col
                 else np.ones(t.num_rows, np.float32))
        ids, nbrs, sims, _counts = interaction_similarity(
            users, items, rates, kind=self._kind,
            metric=self.get(self.SIMILARITY_TYPE),
            top_k=self.get(self.MAX_NEIGHBOR), device=self.env.device,
        )
        # interactions are part of the model: serving scores new queries
        # against each user's history (reference: ItemCfRecommKernel)
        u_ids, u_inv = np.unique(users, return_inverse=True)
        i_ids, i_inv = np.unique(items, return_inverse=True)
        meta = {
            "modelName": self._model_name,
            "kind": self._kind,
            "userCol": user_col,
            "itemCol": item_col,
            "rateCol": rate_col,
            "similarityType": self.get(self.SIMILARITY_TYPE),
        }
        return model_to_table(meta, {
            "entityIds": ids,
            "neighbors": nbrs,
            "sims": sims,
            "userIds": u_ids,
            "itemIds": i_ids,
            "interU": u_inv.astype(np.int64),
            "interI": i_inv.astype(np.int64),
            "interR": rates,
        })


class ItemCfTrainBatchOp(_CfTrainBase):
    """(reference: ItemCfTrainBatchOp.java)"""

    _kind = "item"
    _model_name = "ItemCfModel"


class UserCfTrainBatchOp(_CfTrainBase):
    """(reference: UserCfTrainBatchOp.java)"""

    _kind = "user"
    _model_name = "UserCfModel"


class SwingTrainBatchOp(ModelTrainOpMixin, BatchOperator, HasRecommTripleCols):
    """(reference: SwingTrainBatchOp.java)"""

    ALPHA = ParamInfo("alpha", float, default=1.0)
    MAX_NEIGHBOR = ParamInfo("maxNeighborNumber", int, default=64,
                             aliases=("topK",))
    RATE_COL = ParamInfo("rateCol", str)  # unused; API parity

    _min_inputs = 1
    _max_inputs = 1

    def _static_meta_keys(self, in_schema):
        return {"modelName": "SwingModel",
                "itemCol": self.get(self.ITEM_COL)}

    def _execute_impl(self, t: MTable) -> MTable:
        users = np.asarray(t.col(self.get(self.USER_COL)))
        items = np.asarray(t.col(self.get(self.ITEM_COL)))
        ids, nbrs, sims = swing_similarity(
            users, items, alpha=self.get(self.ALPHA),
            top_k=self.get(self.MAX_NEIGHBOR),
        )
        meta = {
            "modelName": "SwingModel",
            "itemCol": self.get(self.ITEM_COL),
            "userCol": self.get(self.USER_COL),
        }
        return model_to_table(
            meta, {"entityIds": ids, "neighbors": nbrs, "sims": sims}
        )


class _CfRecommMapper(ModelMapper, HasPredictionCol, HasReservedCols):
    USER_COL = ParamInfo("userCol", str)
    ITEM_COL = ParamInfo("itemCol", str)
    K = ParamInfo("k", int, default=10)

    def load_model(self, model: MTable):
        self.meta, a = table_to_model(model)
        self.entity_ids = a["entityIds"]
        self.nbrs = a["neighbors"]
        self.sims = a["sims"]
        self.e_index = {v: i for i, v in enumerate(self.entity_ids.tolist())}
        if "userIds" in a:
            self.user_ids = a["userIds"]
            self.item_ids = a["itemIds"]
            self.u_index = {v: i
                            for i, v in enumerate(self.user_ids.tolist())}
            self.i_index = {v: i
                            for i, v in enumerate(self.item_ids.tolist())}
            # per-user and per-item histories, each in interaction order
            self.hist = _histories(a["interU"], a["interI"], a["interR"])
            self.hist_by_item = _histories(a["interI"], a["interU"],
                                           a["interR"])
            # sparse views of the stored top-K lists — O(n·K) memory, never a
            # dense n×n matrix: sim_of[i][j] = sim(i,j); rev[j] = [(i, s)]
            # inverts the lists for column scans
            self.sim_of: List[Dict[int, float]] = []
            self.rev: Dict[int, List] = {}
            for i, (nb, sm) in enumerate(zip(self.nbrs, self.sims)):
                row = {int(j): float(s) for j, s in zip(nb, sm) if s > 0}
                self.sim_of.append(row)
                for j, s in row.items():
                    self.rev.setdefault(j, []).append((i, s))
        return self

    def _columns(self):
        """Entity j's column of the symmetrized similarity, as (rows, sims):
        the rows whose list holds j (``rev[j]``), then j's own entries whose
        row does not hold j — the scores the serving loop adds for j."""
        if getattr(self, "_cols", None) is None:
            self._cols = []
            for j, own in enumerate(self.sim_of):
                pairs = self.rev.get(j, []) + [
                    (i2, s) for i2, s in own.items()
                    if j not in self.sim_of[i2]]
                self._cols.append((np.asarray([q[0] for q in pairs],
                                              np.int64),
                                   np.asarray([q[1] for q in pairs],
                                              np.float64)))
        return self._cols

    def _sim(self, i: int, j: int) -> float:
        # top-K lists are not symmetric: fall back to the other direction
        return self.sim_of[i].get(j) or self.sim_of[j].get(i, 0.0)

    def _out_col(self) -> str:
        return self.get(HasPredictionCol.PREDICTION_COL) or "recomm"


class CfRateRecommMapper(_CfRecommMapper):
    """ItemCf: rate(u,i) = Σ_{j∈I_u} sim(i,j)·r_uj / Σ|sim|;
    UserCf: rate(u,i) = Σ_{v∈U_i} sim(u,v)·r_vi / Σ|sim| (reference:
    ItemCfRecommKernel.rate / UserCfRecommKernel.rate)."""

    def output_schema(self, input_schema: TableSchema) -> TableSchema:
        return self._append_result_schema(
            input_schema, [self._out_col()], [AlinkTypes.DOUBLE]
        )

    def map_table(self, t: MTable) -> MTable:
        ucol = self.get(self.USER_COL) or self.meta["userCol"]
        icol = self.get(self.ITEM_COL) or self.meta["itemCol"]
        user_kind = self.meta.get("kind") == "user"
        out = np.full(t.num_rows, np.nan)
        for r, (uv, iv) in enumerate(zip(t.col(ucol), t.col(icol))):
            u = self.u_index.get(uv, -1)
            i = self.i_index.get(iv, -1)
            if u < 0 or i < 0:
                continue
            if user_kind:
                pairs = self.hist_by_item.get(i, [])
                query = u
            else:
                pairs = self.hist.get(u, [])
                query = i
            num = den = 0.0
            for e, rate in pairs:
                s = self._sim(query, e)
                num += s * rate
                den += abs(s)
            out[r] = num / den if den > 0 else np.nan
        oc = self._out_col()
        return self._append_result(t, {oc: out}, {oc: AlinkTypes.DOUBLE})


class ItemCfItemsPerUserRecommMapper(_CfRecommMapper):
    """Top-K unseen items scored by similarity-weighted history."""

    def output_schema(self, input_schema: TableSchema) -> TableSchema:
        return self._append_result_schema(
            input_schema, [self._out_col()], [AlinkTypes.STRING]
        )

    def map_table(self, t: MTable) -> MTable:
        ucol = self.get(self.USER_COL) or self.meta["userCol"]
        k = self.get(self.K)
        rows = []
        for uv in t.col(ucol):
            u = self.u_index.get(uv, -1)
            if u < 0 or u not in self.hist:
                rows.append(_recomm_json(np.empty(0), np.empty(0), False))
                continue
            # each rated item's column of the symmetrized similarity, scaled
            # by the rating (an exact float64 product, rounded to float32)
            # and added in float32 in history order: the reference's
            # sequential ``scores[i2] += s * rate``, one add at a time
            cols = self._columns()
            seen = [j for j, _ in self.hist[u]]
            idx = np.concatenate([cols[j][0] for j in seen])
            vals = np.concatenate([cols[j][1] * rate
                                   for j, rate in self.hist[u]])
            scores = np.zeros(len(self.item_ids), np.float32)
            np.add.at(scores, idx, vals.astype(np.float32))
            scores[seen] = -np.inf
            top = np.argsort(-scores)[:k]
            top = top[np.isfinite(scores[top]) & (scores[top] > 0)]
            rows.append(_recomm_json(self.item_ids[top], scores[top], True))
        oc = self._out_col()
        return self._append_result(
            t, {oc: np.asarray(rows, object)}, {oc: AlinkTypes.STRING}
        )


class _SimilarItemsMapper(_CfRecommMapper):
    """Top-K neighbors straight from the model's similarity lists (serves
    ItemCf/UserCf/Swing models alike)."""

    def output_schema(self, input_schema: TableSchema) -> TableSchema:
        return self._append_result_schema(
            input_schema, [self._out_col()], [AlinkTypes.STRING]
        )

    def map_table(self, t: MTable) -> MTable:
        col = self.get(self.ITEM_COL) or self.meta["itemCol"]
        k = self.get(self.K)
        rows = []
        for v in t.col(col):
            e = self.e_index.get(v, -1)
            if e < 0:
                rows.append(_recomm_json(np.empty(0), np.empty(0), False))
                continue
            nb, sm = self.nbrs[e][:k], self.sims[e][:k]
            keep = sm > 0
            rows.append(_recomm_json(self.entity_ids[nb[keep]], sm[keep], True))
        oc = self._out_col()
        return self._append_result(
            t, {oc: np.asarray(rows, object)}, {oc: AlinkTypes.STRING}
        )


class ItemCfRateRecommBatchOp(_RecommOpBase):
    mapper_cls = CfRateRecommMapper


class ItemCfItemsPerUserRecommBatchOp(_RecommOpBase):
    mapper_cls = ItemCfItemsPerUserRecommMapper


class ItemCfSimilarItemsRecommBatchOp(_RecommOpBase):
    mapper_cls = _SimilarItemsMapper


class UserCfRateRecommBatchOp(_RecommOpBase):
    mapper_cls = CfRateRecommMapper


class SwingSimilarItemsRecommBatchOp(_RecommOpBase):
    mapper_cls = _SimilarItemsMapper


# ---------------------------------------------------------------------------
# FM recommender (reference: FmRecommTrainBatchOp.java + FmRecommBinary...)
# ---------------------------------------------------------------------------

class FmRecommTrainBatchOp(ModelTrainOpMixin, BatchOperator,
                           HasRecommTripleCols):
    """Factorization-machine recommender on (user, item, rate) triples
    (reference: recommendation/FmRecommTrainBatchOp.java — FM over the
    one-hot user++item design matrix; for that design the FM collapses to
    biased matrix factorization: score = w0 + bu + bi + <Vu, Vi>).

    One full-batch Adam loop over the embedding tables on the device. The
    learned biases are FOLDED into augmented factors (U' = [Vu, bu+w0/2, 1],
    V' = [Vi, 1, bi+w0/2]) so every ALS serving kernel — rate/top-K/similar
    — serves FM models unchanged: <U', V'> reproduces the FM score
    exactly."""

    RANK = ParamInfo("rank", int, default=10, validator=MinValidator(1))
    NUM_EPOCHS = ParamInfo("numEpochs", int, default=30,
                           aliases=("numIter",))
    LEARN_RATE = ParamInfo("learnRate", float, default=0.05)
    LAMBDA = ParamInfo("lambda", float, default=0.01, aliases=("lambda_",))
    RANDOM_SEED = ParamInfo("randomSeed", int, default=0, aliases=("seed",))

    _min_inputs = 1
    _max_inputs = 1

    def _static_meta_keys(self, in_schema):
        return {
            "modelName": "FmRecommModel",
            "userCol": self.get(self.USER_COL),
            "itemCol": self.get(self.ITEM_COL),
        }

    def _execute_impl(self, t: MTable) -> MTable:
        import torch

        user_col = self.get(self.USER_COL)
        item_col = self.get(self.ITEM_COL)
        rate_col = self.get(self.RATE_COL)
        users = np.asarray(t.col(user_col))
        items = np.asarray(t.col(item_col))
        rates = (np.asarray(t.col(rate_col), np.float32) if rate_col
                 else np.ones(t.num_rows, np.float32))
        user_ids, u_idx = np.unique(users.astype(str), return_inverse=True)
        item_ids, i_idx = np.unique(items.astype(str), return_inverse=True)
        nu, ni = len(user_ids), len(item_ids)
        rank = self.get(self.RANK)
        lam = float(self.get(self.LAMBDA))
        lr = float(self.get(self.LEARN_RATE))
        epochs = int(self.get(self.NUM_EPOCHS))

        rng = np.random.default_rng(self.get(self.RANDOM_SEED))
        init = {
            "w0": np.float32(rates.mean()),
            "bu": np.zeros(nu, np.float32),
            "bi": np.zeros(ni, np.float32),
            "U": rng.normal(0, 0.05, (nu, rank)).astype(np.float32),
            "V": rng.normal(0, 0.05, (ni, rank)).astype(np.float32),
        }
        dev = self.env.device
        u_j = torch.as_tensor(u_idx.reshape(-1), device=dev)
        i_j = torch.as_tensor(i_idx.reshape(-1), device=dev)
        r_j = torch.as_tensor(rates, device=dev)

        def loss(p):
            score = (p["w0"] + p["bu"][u_j] + p["bi"][i_j]
                     + (p["U"][u_j] * p["V"][i_j]).sum(-1))
            reg = sum(torch.sum(x * x) for x in
                      (p["bu"], p["bi"], p["U"], p["V"]))
            return torch.mean((score - r_j) ** 2) + lam * reg / len(rates)

        p = adam_fit(init, loss, lr, epochs, dev)
        w0 = float(p["w0"])
        U_aug = np.concatenate(
            [p["U"], (p["bu"] + w0 / 2)[:, None], np.ones((nu, 1))],
            axis=1).astype(np.float32)
        V_aug = np.concatenate(
            [p["V"], np.ones((ni, 1)), (p["bi"] + w0 / 2)[:, None]],
            axis=1).astype(np.float32)
        meta = {
            "modelName": "FmRecommModel",
            "userCol": user_col, "itemCol": item_col, "rateCol": rate_col,
            "rank": rank, "implicitPrefs": False,
        }
        return model_to_table(meta, {
            "userIds": user_ids.astype(object),
            "itemIds": item_ids.astype(object),
            "userFactors": U_aug,
            "itemFactors": V_aug,
        })


# FM serving = the ALS kernels over the augmented factors (see the train
# op's docstring): new public op names, shared mappers.
class FmRateRecommBatchOp(_RecommOpBase):
    """(reference: FmRateRecommBatchOp.java)"""

    mapper_cls = AlsRateRecommMapper


class FmItemsPerUserRecommBatchOp(_RecommOpBase):
    """(reference: FmItemsPerUserRecommBatchOp.java)"""

    mapper_cls = AlsItemsPerUserRecommMapper


class FmUsersPerItemRecommBatchOp(_RecommOpBase):
    """(reference: FmUsersPerItemRecommBatchOp.java)"""

    mapper_cls = AlsUsersPerItemRecommMapper


# ---------------------------------------------------------------------------
# Leave-K-out splitters (reference: dataproc/LeaveKObjectOutBatchOp.java,
# LeaveTopKObjectOutBatchOp.java — recsys train/test protocol)
# ---------------------------------------------------------------------------

class LeaveKObjectOutBatchOp(BatchOperator, HasRecommTripleCols):
    """Per group (user), leave K objects out: MAIN output = the left-out
    test rows, SIDE output 0 = the remaining train rows (reference:
    LeaveKObjectOutBatchOp.java — fraction/k params; we keep k +
    minimum-rows semantics)."""

    K = ParamInfo("k", int, default=1, validator=MinValidator(1))
    MIN_ROWS = ParamInfo("minRows", int, default=2, validator=MinValidator(1),
                         desc="groups smaller than this stay whole in train")
    RANDOM_SEED = ParamInfo("randomSeed", int, default=0, aliases=("seed",))

    _min_inputs = 1
    _max_inputs = 1

    def _pick(self, idx: np.ndarray, rates: Optional[np.ndarray],
              k: int, rng) -> np.ndarray:
        return rng.choice(idx, size=k, replace=False)

    def _execute_impl(self, t: MTable):
        user_col = self.get(self.USER_COL)
        k = int(self.get(self.K))
        min_rows = int(self.get(self.MIN_ROWS))
        rate_col = self.get(self.RATE_COL)
        rng = np.random.default_rng(self.get(self.RANDOM_SEED))
        users = np.asarray(t.col(user_col), object).astype(str)
        rates = (np.asarray(t.col(rate_col), np.float64)
                 if rate_col else None)
        test_mask = np.zeros(t.num_rows, bool)
        _, inv = np.unique(users, return_inverse=True)
        order = np.argsort(inv, kind="stable")
        bounds = np.flatnonzero(np.diff(inv[order])) + 1
        for idx in np.split(order, bounds):
            if len(idx) < min_rows or len(idx) <= k:
                continue
            take = self._pick(idx, rates, k, rng)
            test_mask[take] = True
        return t.filter_mask(test_mask), [t.filter_mask(~test_mask)]

    def _out_schema(self, in_schema):
        return in_schema


class LeaveTopKObjectOutBatchOp(LeaveKObjectOutBatchOp):
    """Leave out the TOP-K rated objects per group (reference:
    LeaveTopKObjectOutBatchOp.java — rateThreshold ordering)."""

    def _pick(self, idx: np.ndarray, rates: Optional[np.ndarray],
              k: int, rng) -> np.ndarray:
        if rates is None:
            raise AkIllegalArgumentException(
                "LeaveTopKObjectOut needs rateCol")
        order = idx[np.argsort(-rates[idx], kind="stable")]
        return order[:k]


# ---------------------------------------------------------------------------
# DeepFM recommender (reference: the easyrec model family in akdl —
# core/src/main/python/akdl/akdl/models/tf/easyrec/; DeepFM = FM scoring +
# an MLP over the concatenated user/item embeddings)
# ---------------------------------------------------------------------------

class DeepFmRecommTrainBatchOp(ModelTrainOpMixin, BatchOperator,
                               HasRecommTripleCols):
    """DeepFM on (user, item, rate) triples: score = w0 + bu + bi +
    <Vu, Vi> + MLP([Vu, Vi]). The nonlinear head means serving has its own
    mapper (unlike the pure-FM op, whose biases fold into ALS kernels)."""

    RANK = ParamInfo("rank", int, default=8, validator=MinValidator(1))
    HIDDEN = ParamInfo("hiddenSize", int, default=32)
    NUM_EPOCHS = ParamInfo("numEpochs", int, default=60, aliases=("numIter",))
    LEARN_RATE = ParamInfo("learnRate", float, default=0.02)
    LAMBDA = ParamInfo("lambda", float, default=0.01, aliases=("lambda_",))
    RANDOM_SEED = ParamInfo("randomSeed", int, default=0, aliases=("seed",))

    _min_inputs = 1
    _max_inputs = 1

    def _static_meta_keys(self, in_schema):
        return {
            "modelName": "DeepFmRecommModel",
            "userCol": self.get(self.USER_COL),
            "itemCol": self.get(self.ITEM_COL),
        }

    def _execute_impl(self, t: MTable) -> MTable:
        import torch

        user_col = self.get(self.USER_COL)
        item_col = self.get(self.ITEM_COL)
        rate_col = self.get(self.RATE_COL)
        users = np.asarray(t.col(user_col)).astype(str)
        items = np.asarray(t.col(item_col)).astype(str)
        rates = (np.asarray(t.col(rate_col), np.float32) if rate_col
                 else np.ones(t.num_rows, np.float32))
        user_ids, u_idx = np.unique(users, return_inverse=True)
        item_ids, i_idx = np.unique(items, return_inverse=True)
        nu, ni = len(user_ids), len(item_ids)
        rank = self.get(self.RANK)
        hidden = self.get(self.HIDDEN)
        lam = float(self.get(self.LAMBDA))

        rng = np.random.default_rng(self.get(self.RANDOM_SEED))
        init = {
            "w0": np.float32(rates.mean()),
            "bu": np.zeros(nu, np.float32),
            "bi": np.zeros(ni, np.float32),
            "U": rng.normal(0, 0.05, (nu, rank)).astype(np.float32),
            "V": rng.normal(0, 0.05, (ni, rank)).astype(np.float32),
            "W1": rng.normal(0, 0.1, (2 * rank, hidden)).astype(np.float32),
            "b1": np.zeros(hidden, np.float32),
            "W2": rng.normal(0, 0.1, (hidden, 1)).astype(np.float32),
            "b2": np.zeros(1, np.float32),
        }
        dev = self.env.device
        u_j = torch.as_tensor(u_idx.reshape(-1), device=dev)
        i_j = torch.as_tensor(i_idx.reshape(-1), device=dev)
        r_j = torch.as_tensor(rates, device=dev)

        def loss(p):
            reg = sum(torch.sum(x * x) for x in
                      (p["bu"], p["bi"], p["U"], p["V"]))
            return (torch.mean((deepfm_score(p, u_j, i_j) - r_j) ** 2)
                    + lam * reg / len(rates))

        p = adam_fit(init, loss, float(self.get(self.LEARN_RATE)),
                     int(self.get(self.NUM_EPOCHS)), dev)
        meta = {
            "modelName": "DeepFmRecommModel",
            "userCol": user_col, "itemCol": item_col, "rateCol": rate_col,
            "rank": rank, "hiddenSize": hidden,
        }
        arrays = {"userIds": user_ids.astype(object),
                  "itemIds": item_ids.astype(object)}
        arrays.update(p)
        return model_to_table(meta, arrays)


class DeepFmRecommMapper(ModelMapper, HasPredictionCol, HasReservedCols):
    """DeepFM serving: one score over (user, item) index pairs on the
    mapper's device."""

    USER_COL = ParamInfo("userCol", str)
    ITEM_COL = ParamInfo("itemCol", str)
    K = ParamInfo("k", int, default=10)

    def load_model(self, model: MTable):
        import torch

        from ...common.env import resolve_device

        self.meta, arrays = table_to_model(model)
        self.user_ids = arrays["userIds"]
        self.item_ids = arrays["itemIds"]
        self.u_index = {v: i for i, v in enumerate(self.user_ids.tolist())}
        self.i_index = {v: i for i, v in enumerate(self.item_ids.tolist())}
        self._dev = resolve_device(self.device)
        self._p = {k: torch.as_tensor(np.asarray(arrays[k], np.float32),
                                      device=self._dev)
                   for k in ("w0", "bu", "bi", "U", "V", "W1", "b1", "W2",
                             "b2")}
        return self

    def _score(self, uu: np.ndarray, ii: np.ndarray) -> np.ndarray:
        import torch

        with torch.no_grad():
            return deepfm_score(
                self._p, torch.as_tensor(uu, device=self._dev),
                torch.as_tensor(ii, device=self._dev)).cpu().numpy()

    def _score_all(self, ui: int) -> np.ndarray:
        """Every item's score for one user (top-K serving)."""
        n = len(self.item_ids)
        return self._score(np.full(n, ui, np.int64), np.arange(n))

    def _out_col(self):
        return self.get(HasPredictionCol.PREDICTION_COL) or "recomm"

    def output_schema(self, input_schema):
        return self._append_result_schema(
            input_schema, [self._out_col()], [AlinkTypes.DOUBLE])

    def _user_col(self) -> str:
        return self.get(self.USER_COL) or self.meta["userCol"]

    def _item_col(self) -> str:
        return self.get(self.ITEM_COL) or self.meta["itemCol"]

    def map_table(self, t: MTable) -> MTable:
        u = np.asarray([self.u_index.get(str(v), -1)
                        for v in t.col(self._user_col())], np.int64)
        i = np.asarray([self.i_index.get(str(v), -1)
                        for v in t.col(self._item_col())], np.int64)
        ok = (u >= 0) & (i >= 0)
        scores = np.full(t.num_rows, np.nan)
        if ok.any():
            s = self._score(np.maximum(u, 0), np.maximum(i, 0))
            scores[ok] = s[ok]
        oc = self._out_col()
        return self._append_result(t, {oc: scores},
                                   {oc: AlinkTypes.DOUBLE})


class DeepFmItemsPerUserRecommMapper(DeepFmRecommMapper):
    def output_schema(self, input_schema):
        return self._append_result_schema(
            input_schema, [self._out_col()], [AlinkTypes.STRING])

    def map_table(self, t: MTable) -> MTable:
        k = int(self.get(self.K))
        rows = []
        for v in t.col(self._user_col()):
            ui = self.u_index.get(str(v), -1)
            if ui < 0:
                rows.append(_recomm_json(np.empty(0), np.empty(0), False))
                continue
            s = self._score_all(ui)
            top = np.argsort(-s)[:k]
            rows.append(_recomm_json(self.item_ids[top], s[top], True))
        oc = self._out_col()
        return self._append_result(t, {oc: np.asarray(rows, object)},
                                   {oc: AlinkTypes.STRING})


class DeepFmRateRecommBatchOp(_RecommOpBase):
    """(reference: easyrec deepfm serving — rate a (user, item) pair)"""

    mapper_cls = DeepFmRecommMapper


class DeepFmItemsPerUserRecommBatchOp(_RecommOpBase):
    """(reference: easyrec deepfm serving — top-K items per user)"""

    mapper_cls = DeepFmItemsPerUserRecommMapper
