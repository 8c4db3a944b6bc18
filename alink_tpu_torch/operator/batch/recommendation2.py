"""Recommendation long-tail: ALS variants (implicit / MF / hot-point),
similar-users serving, UserCf/ItemCf cross-role kernels, vec-dot models,
negative sampling, ranking lists, recommendation re-ranking (port of
``alink_tpu.operator.batch.recommendation2``).

Capability parity (reference: operator/batch/recommendation/
AlsImplicitTrainBatchOp.java, MfAlsBatchOp.java / MfAlsForHotPointBatchOp
.java, AlsForHotPointTrainBatchOp.java, AlsImplicitForHotPointTrainBatchOp
.java, AlsSimilarUsersRecommBatchOp.java, UserCfItemsPerUserRecommBatchOp
.java / UserCfUsersPerItemRecommBatchOp.java / UserCfSimilarUsersRecomm
BatchOp.java, ItemCfUsersPerItemRecommBatchOp.java,
FmRecommBinaryImplicitTrainBatchOp.java, NegativeItemSamplingBatchOp.java,
VecDotModelGeneratorBatchOp.java / VecDotItemsPerUserRecommBatchOp.java,
RankingListBatchOp.java, RecommendationRankingBatchOp.java,
SwingRecommBatchOp.java).

The similar-users kernel takes its top-K on the device as the ALS kernels
do; the rest runs on the host as in the reference. RankingList reproduces,
over numpy, the pandas calls the reference makes: ``groupby(keys,
dropna=False)`` (keys sorted, a missing key its own group, last; float sums
compensated as pandas sums them), ``rank(method="first",
ascending=False)`` within groups, and ``sort_values("score",
ascending=False)`` as pandas' ``nargsort`` runs numpy's quicksort over the
reversed scores.
"""

from __future__ import annotations

import json
from typing import Dict, List

import numpy as np

from ...common.exceptions import (
    AkIllegalArgumentException,
    AkIllegalDataException,
)
from ...common.linalg import parse_vector
from ...common.model import model_to_table, table_to_model
from ...common.mtable import AlinkTypes, MTable, TableSchema
from ...common.params import MinValidator, ParamInfo
from ...mapper import HasPredictionCol, HasReservedCols
from .base import BatchOperator
from .recommendation import (
    AlsItemsPerUserRecommMapper,
    AlsSimilarItemsRecommBatchOp,
    AlsTrainBatchOp,
    FmRecommTrainBatchOp,
    HasRecommTripleCols,
    SwingSimilarItemsRecommBatchOp,
    _AlsTopKMapper,
    _CfRecommMapper,
    _RecommOpBase,
    _SimilarItemsMapper,
    _recomm_json,
)
from .utils import ModelTrainOpMixin


# ---------------------------------------------------------------------------
# ALS trainer variants
# ---------------------------------------------------------------------------


class AlsImplicitTrainBatchOp(AlsTrainBatchOp):
    """ALS with implicit preferences preset (Hu/Koren/Volinsky)
    (reference: recommendation/AlsImplicitTrainBatchOp.java)."""

    def __init__(self, params=None, **kw):
        kw.setdefault("implicitPrefs", True)
        super().__init__(params, **kw)


class _HotPointMixin:
    """Cap per-entity neighbor lists: the padded-rectangle sweep is sized by
    the max degree, so one viral entity inflates every row — subsample hub
    histories (reference: the ForHotPoint family's dedicated hub path).
    Hooks into the base trainer; the sweep itself is unchanged."""

    MAX_NEIGHBOR_NUMBER = ParamInfo(
        "maxNeighborNumber", int, default=512, validator=MinValidator(1),
        desc="cap on ratings per user/item fed to each sweep")

    def _max_neighbors(self) -> int:
        return self.get(self.MAX_NEIGHBOR_NUMBER)

    def _extra_meta(self) -> dict:
        return {"maxNeighborNumber": self.get(self.MAX_NEIGHBOR_NUMBER)}


class AlsForHotPointTrainBatchOp(_HotPointMixin, AlsTrainBatchOp):
    """(reference: recommendation/AlsForHotPointTrainBatchOp.java)"""


class AlsImplicitForHotPointTrainBatchOp(_HotPointMixin,
                                         AlsImplicitTrainBatchOp):
    """(reference: recommendation/AlsImplicitForHotPointTrainBatchOp.java)"""


class MfAlsBatchOp(AlsTrainBatchOp):
    """Matrix-factorization-by-ALS under its mf-family name
    (reference: operator/batch/recommendation/MfAlsBatchOp.java)."""


class MfAlsForHotPointBatchOp(_HotPointMixin, AlsTrainBatchOp):
    """(reference: operator/batch/recommendation/MfAlsForHotPointBatchOp.java)"""


class FmRecommBinaryImplicitTrainBatchOp(FmRecommTrainBatchOp):
    """FM recommender on binary implicit feedback: observed triples with a
    positive rate become label 1, non-positive rates label 0 (so an
    impression-without-click column trains as an explicit negative); without
    a rate column every triple is a positive (reference: recommendation/
    FmRecommBinaryImplicitTrainBatchOp.java)."""

    def _execute_impl(self, t: MTable) -> MTable:
        rate_col = self.get(self.RATE_COL)
        if rate_col:
            binary = t.with_column(
                rate_col,
                (np.asarray(t.col(rate_col), np.float64) > 0
                 ).astype(np.float64),
                AlinkTypes.DOUBLE)
        else:
            binary = t
        return super()._execute_impl(binary)


# ---------------------------------------------------------------------------
# ALS similar-users serving
# ---------------------------------------------------------------------------


class AlsSimilarUsersRecommMapper(_AlsTopKMapper):
    """Top-K nearest users by user-factor COSINE similarity — the same
    normalization the similar-items kernel uses, so hub users with large
    factor norms don't dominate every list; cosine also guarantees the
    query user ranks itself first, making self-exclusion exact (reference:
    recommendation/AlsSimilarUsersRecommBatchOp.java)."""

    def map_table(self, t: MTable) -> MTable:
        col = self.get(self.USER_COL) or self.meta["userCol"]
        k = min(self.get(self.K) + 1, len(self.user_ids))
        q = self._lookup(t.col(col), self.u_index)
        valid = q >= 0
        norms = np.linalg.norm(self.U, axis=1, keepdims=True)
        Un = self.U / np.maximum(norms, 1e-12)
        Q = Un[np.maximum(q, 0)]
        scores, idx = self._topk(Un, Q, k)
        rows = []
        for r in range(t.num_rows):
            if not valid[r]:
                rows.append(_recomm_json(np.empty(0), np.empty(0), False))
                continue
            keep = idx[r] != q[r]  # drop the query user itself
            ids = self.user_ids[idx[r][keep]][: self.get(self.K)]
            sc = scores[r][keep][: self.get(self.K)]
            rows.append(_recomm_json(ids, sc, True))
        oc = self._out_col()
        return self._append_result(
            t, {oc: np.asarray(rows, object)}, {oc: AlinkTypes.STRING})


class AlsSimilarUsersRecommBatchOp(_RecommOpBase):
    mapper_cls = AlsSimilarUsersRecommMapper


# ---------------------------------------------------------------------------
# CF cross-role serving kernels
# ---------------------------------------------------------------------------


class UserCfItemsPerUserRecommMapper(_CfRecommMapper):
    """UserCf top-K items for a user: score(i) = Σ_{v∈sim(u)} sim(u,v)·r_vi
    (reference: UserCfRecommKernel.recommendItemsPerUser)."""

    def output_schema(self, input_schema: TableSchema) -> TableSchema:
        return self._append_result_schema(
            input_schema, [self._out_col()], [AlinkTypes.STRING])

    def map_table(self, t: MTable) -> MTable:
        ucol = self.get(self.USER_COL) or self.meta["userCol"]
        k = self.get(self.K)
        rows = []
        for uv in t.col(ucol):
            u = self.u_index.get(uv, -1)
            if u < 0:
                rows.append(_recomm_json(np.empty(0), np.empty(0), False))
                continue
            scores = np.zeros(len(self.item_ids), np.float32)
            # neighbors of u in BOTH directions of the top-K lists
            sims = dict(self.sim_of[u])
            for v, s in self.rev.get(u, []):
                sims.setdefault(v, s)
            for v, s in sims.items():
                for i, rate in self.hist.get(v, []):
                    scores[i] += s * rate
            seen = [i for i, _ in self.hist.get(u, [])]
            scores[seen] = -np.inf
            top = np.argsort(-scores)[:k]
            top = top[np.isfinite(scores[top]) & (scores[top] > 0)]
            rows.append(_recomm_json(self.item_ids[top], scores[top], True))
        oc = self._out_col()
        return self._append_result(
            t, {oc: np.asarray(rows, object)}, {oc: AlinkTypes.STRING})


class UserCfUsersPerItemRecommMapper(_CfRecommMapper):
    """UserCf top-K users for an item: score(v) = Σ_{v'∈U_i} sim(v,v')·r_v'i
    (reference: UserCfRecommKernel.recommendUsersPerItem)."""

    def output_schema(self, input_schema: TableSchema) -> TableSchema:
        return self._append_result_schema(
            input_schema, [self._out_col()], [AlinkTypes.STRING])

    def map_table(self, t: MTable) -> MTable:
        icol = self.get(self.ITEM_COL) or self.meta["itemCol"]
        k = self.get(self.K)
        rows = []
        for iv in t.col(icol):
            i = self.i_index.get(iv, -1)
            if i < 0:
                rows.append(_recomm_json(np.empty(0), np.empty(0), False))
                continue
            scores = np.zeros(len(self.user_ids), np.float32)
            raters = self.hist_by_item.get(i, [])
            for v2, rate in raters:
                sims = dict(self.sim_of[v2])
                for v, s in self.rev.get(v2, []):
                    sims.setdefault(v, s)
                for v, s in sims.items():
                    scores[v] += s * rate
            scores[[v for v, _ in raters]] = -np.inf
            top = np.argsort(-scores)[:k]
            top = top[np.isfinite(scores[top]) & (scores[top] > 0)]
            rows.append(_recomm_json(self.user_ids[top], scores[top], True))
        oc = self._out_col()
        return self._append_result(
            t, {oc: np.asarray(rows, object)}, {oc: AlinkTypes.STRING})


class _SimilarUsersMapper(_SimilarItemsMapper):
    """Top-K similar USERS from a kind=user CF model — same neighbor lists,
    queried by the user column."""

    def map_table(self, t: MTable) -> MTable:
        col = self.get(self.USER_COL) or self.meta["userCol"]
        k = self.get(self.K)
        rows = []
        for v in t.col(col):
            e = self.e_index.get(v, -1)
            if e < 0:
                rows.append(_recomm_json(np.empty(0), np.empty(0), False))
                continue
            nb, sm = self.nbrs[e][:k], self.sims[e][:k]
            keep = sm > 0
            rows.append(
                _recomm_json(self.entity_ids[nb[keep]], sm[keep], True))
        oc = self._out_col()
        return self._append_result(
            t, {oc: np.asarray(rows, object)}, {oc: AlinkTypes.STRING})


class UserCfItemsPerUserRecommBatchOp(_RecommOpBase):
    mapper_cls = UserCfItemsPerUserRecommMapper


class UserCfUsersPerItemRecommBatchOp(_RecommOpBase):
    mapper_cls = UserCfUsersPerItemRecommMapper


class UserCfSimilarUsersRecommBatchOp(_RecommOpBase):
    mapper_cls = _SimilarUsersMapper


class ItemCfUsersPerItemRecommMapper(_CfRecommMapper):
    """ItemCf top-K users for an item: score(v) = Σ_{j∈I_v} sim(i,j)·r_vj
    (reference: ItemCfRecommKernel.recommendUsersPerItem)."""

    def output_schema(self, input_schema: TableSchema) -> TableSchema:
        return self._append_result_schema(
            input_schema, [self._out_col()], [AlinkTypes.STRING])

    def map_table(self, t: MTable) -> MTable:
        icol = self.get(self.ITEM_COL) or self.meta["itemCol"]
        k = self.get(self.K)
        rows = []
        for iv in t.col(icol):
            i = self.i_index.get(iv, -1)
            if i < 0:
                rows.append(_recomm_json(np.empty(0), np.empty(0), False))
                continue
            sims = dict(self.sim_of[i])
            for j, s in self.rev.get(i, []):
                sims.setdefault(j, s)
            scores = np.zeros(len(self.user_ids), np.float32)
            for j, s in sims.items():
                for v, rate in self.hist_by_item.get(j, []):
                    scores[v] += s * rate
            raters = [v for v, _ in self.hist_by_item.get(i, [])]
            scores[raters] = -np.inf
            top = np.argsort(-scores)[:k]
            top = top[np.isfinite(scores[top]) & (scores[top] > 0)]
            rows.append(_recomm_json(self.user_ids[top], scores[top], True))
        oc = self._out_col()
        return self._append_result(
            t, {oc: np.asarray(rows, object)}, {oc: AlinkTypes.STRING})


class ItemCfUsersPerItemRecommBatchOp(_RecommOpBase):
    mapper_cls = ItemCfUsersPerItemRecommMapper


class SwingRecommBatchOp(SwingSimilarItemsRecommBatchOp):
    """(reference: recommendation/SwingRecommBatchOp.java — swing serves
    similar-items only)."""


# ---------------------------------------------------------------------------
# vec-dot model: user/item embedding tables → ALS-format model
# ---------------------------------------------------------------------------


class VecDotModelGeneratorBatchOp(ModelTrainOpMixin, BatchOperator):
    """Build a dot-product recommender model from precomputed (id, vector)
    tables — users first input, items second; the output is an AlsModel, so
    EVERY ALS serving kernel works on it (reference: recommendation/
    VecDotModelGeneratorBatchOp.java)."""

    USER_ID_COL = ParamInfo("userIdCol", str, default=None)
    USER_VEC_COL = ParamInfo("userVecCol", str, default=None)
    ITEM_ID_COL = ParamInfo("itemIdCol", str, default=None)
    ITEM_VEC_COL = ParamInfo("itemVecCol", str, default=None)

    _min_inputs = 2
    _max_inputs = 2

    def _static_meta_keys(self, in_schema):
        return {"modelName": "AlsModel"}

    @staticmethod
    def _id_vec(t: MTable, id_col, vec_col):
        id_col = id_col or t.names[0]
        vec_col = vec_col or t.names[1]
        ids = np.asarray(t.col(id_col))
        vecs = np.stack([parse_vector(v).to_dense().data
                         for v in t.col(vec_col)]).astype(np.float32)
        return id_col, ids, vecs

    def _execute_impl(self, users: MTable, items: MTable) -> MTable:
        ucol, uid, uvec = self._id_vec(users, self.get(self.USER_ID_COL),
                                       self.get(self.USER_VEC_COL))
        icol, iid, ivec = self._id_vec(items, self.get(self.ITEM_ID_COL),
                                       self.get(self.ITEM_VEC_COL))
        if uvec.shape[1] != ivec.shape[1]:
            raise AkIllegalDataException(
                f"user/item vector dims differ: {uvec.shape[1]} vs "
                f"{ivec.shape[1]}")
        meta = {"modelName": "AlsModel", "userCol": ucol, "itemCol": icol,
                "rateCol": None, "rank": int(uvec.shape[1]),
                "implicitPrefs": False, "source": "vecDot"}
        return model_to_table(meta, {
            "userIds": uid, "itemIds": iid,
            "userFactors": uvec, "itemFactors": ivec,
        })


class VecDotItemsPerUserRecommBatchOp(_RecommOpBase):
    """Top-K items by user·item dot product over the vec-dot model —
    identical serving math to ALS items-per-user (reference:
    recommendation/VecDotItemsPerUserRecommBatchOp.java)."""

    mapper_cls = AlsItemsPerUserRecommMapper


# ---------------------------------------------------------------------------
# negative sampling / ranking list / recommendation re-ranking
# ---------------------------------------------------------------------------


class NegativeItemSamplingBatchOp(BatchOperator):
    """(user, item) positives → labeled table with k random unseen-item
    negatives per positive; like the reference, the first two columns are
    (user, item) unless named explicitly (reference: recommendation/
    NegativeItemSamplingBatchOp.java)."""

    USER_COL = ParamInfo("userCol", str, default=None)
    ITEM_COL = ParamInfo("itemCol", str, default=None)
    SAMPLING_FACTOR = ParamInfo("samplingFactor", int, default=3,
                                validator=MinValidator(1))
    SEED = ParamInfo("randomSeed", int, default=0, aliases=("seed",))

    _min_inputs = 1
    _max_inputs = 1

    def _execute_impl(self, t: MTable) -> MTable:
        ucol = self.get(self.USER_COL) or t.names[0]
        icol = self.get(self.ITEM_COL) or t.names[1]
        users = np.asarray(t.col(ucol))
        items = np.asarray(t.col(icol))
        item_ids = np.unique(items)
        seen = {}
        for u, i in zip(users, items):
            seen.setdefault(u, set()).add(i)
        rng = np.random.default_rng(self.get(self.SEED))
        k = self.get(self.SAMPLING_FACTOR)
        out_u, out_i, out_y = [], [], []
        for u, i in zip(users, items):
            out_u.append(u)
            out_i.append(i)
            out_y.append(1)
            drawn = 0
            tries = 0
            while drawn < k and tries < 20 * k:
                cand = item_ids[rng.integers(len(item_ids))]
                tries += 1
                if cand not in seen[u]:
                    out_u.append(u)
                    out_i.append(cand)
                    out_y.append(0)
                    drawn += 1
        return MTable.from_rows(
            list(zip(out_u, out_i, out_y)),
            TableSchema([ucol, icol, "label"],
                        [t.schema.type_of(ucol), t.schema.type_of(icol),
                         AlinkTypes.LONG]))

    def _out_schema(self, in_schema):
        ucol = self.get(self.USER_COL) or in_schema.names[0]
        icol = self.get(self.ITEM_COL) or in_schema.names[1]
        return TableSchema(
            [ucol, icol, "label"],
            [in_schema.type_of(ucol), in_schema.type_of(icol),
             AlinkTypes.LONG])


class RankingListBatchOp(BatchOperator):
    """Top-N ranking list: count/sum objects (optionally per group) and rank
    (reference: operator/batch/recommendation/RankingListBatchOp.java)."""

    OBJECT_COL = ParamInfo("objectCol", str, optional=False)
    GROUP_COL = ParamInfo("groupCol", str, default=None)
    SCORE_COL = ParamInfo("scoreCol", str, default=None,
                          desc="sum this column; default counts rows")
    TOP_N = ParamInfo("topN", int, default=10, validator=MinValidator(1))

    _min_inputs = 1
    _max_inputs = 1

    def _execute_impl(self, t: MTable) -> MTable:
        obj = self.get(self.OBJECT_COL)
        grp = self.get(self.GROUP_COL)
        score = self.get(self.SCORE_COL)
        n = self.get(self.TOP_N)
        keys = ([grp] if grp else []) + [obj]
        key_vals, codes = zip(*(_factorize(t.col(c)) for c in keys))
        # groups in sorted key order (the last key varies fastest)
        row_order = np.lexsort(codes[::-1])
        sorted_codes = np.stack([c[row_order] for c in codes])
        starts = np.flatnonzero(np.r_[True, (
            sorted_codes[:, 1:] != sorted_codes[:, :-1]).any(0)])
        first = row_order[starts]
        bounds = np.r_[starts, len(row_order)]
        if score:
            from ..sql import _agg_sum  # pandas' group sum

            vals = np.asarray(t.col(score))
            agg_score = np.asarray([_agg_sum(vals[row_order[a:b]]) for a, b
                                    in zip(bounds[:-1], bounds[1:])])
        else:
            agg_score = np.diff(bounds).astype(np.int64)
        agg = {c: _key_values(kv, code[first])
               for c, kv, code in zip(keys, key_vals, codes)}
        if grp:
            g_codes = codes[0][first]
            if (g_codes == len(key_vals[0])).any():
                raise AkIllegalDataException(
                    f"RankingList: groupCol {grp!r} holds a missing value, "
                    "which has no rank")
            rank = np.zeros(len(first), np.int64)
            g_bounds = np.flatnonzero(np.r_[True, g_codes[1:] != g_codes[:-1],
                                            True])
            for a, b in zip(g_bounds[:-1], g_bounds[1:]):
                # rank "first", descending: ties by order of appearance
                order = np.argsort(-agg_score[a:b], kind="stable")
                rank[a + order] = np.arange(1, b - a + 1)
            pick = np.flatnonzero(rank <= n)
            pick = pick[np.lexsort((rank[pick], g_codes[pick]))]
            out = {c: agg[c][pick] for c in keys}
            out.update(rank=rank[pick], score=agg_score[pick])
        else:
            # pandas' nargsort(score, "quicksort", ascending=False)
            idx = np.arange(len(agg_score))
            pick = idx[::-1][agg_score[::-1].argsort(kind="quicksort")][::-1]
            pick = pick[:n]
            out = {obj: agg[obj][pick], "score": agg_score[pick],
                   "rank": np.arange(1, len(pick) + 1, dtype=np.int64)}
        cols = ([grp] if grp else []) + [obj, "rank", "score"]
        types = (([t.schema.type_of(grp)] if grp else [])
                 + [t.schema.type_of(obj), AlinkTypes.LONG,
                    AlinkTypes.DOUBLE])
        return MTable({c: out[c] for c in cols}, TableSchema(cols, types))

    def _out_schema(self, in_schema):
        obj = self.get(self.OBJECT_COL)
        grp = self.get(self.GROUP_COL)
        cols = ([grp] if grp else []) + [obj, "rank", "score"]
        types = (([in_schema.type_of(grp)] if grp else [])
                 + [in_schema.type_of(obj), AlinkTypes.LONG,
                    AlinkTypes.DOUBLE])
        return TableSchema(cols, types)


def _factorize(col):
    """(sorted distinct values, codes) of a key column: missing values
    (None, NaN) take the code ``len(values)``, after every value."""
    from ..sql import _is_missing

    col = np.asarray(col)
    if col.dtype == object:
        miss = np.fromiter((_is_missing(v) for v in col), bool, len(col))
        vals = np.asarray(sorted(set(col[~miss].tolist())), object)
        lut = {v: i for i, v in enumerate(vals.tolist())}
        codes = np.fromiter((len(vals) if m else lut[v] for v, m in
                             zip(col.tolist(), miss)), np.int64, len(col))
        return vals, codes
    miss = np.isnan(col) if col.dtype.kind == "f" else np.zeros(len(col),
                                                                 bool)
    vals, inv = np.unique(col[~miss], return_inverse=True)
    codes = np.full(len(col), len(vals), np.int64)
    codes[~miss] = inv.reshape(-1)
    return vals, codes


def _key_values(vals: np.ndarray, codes: np.ndarray) -> np.ndarray:
    """The key column of the groups: a missing key is NaN, as pandas
    writes it (the column becomes object when it has one)."""
    if (codes < len(vals)).all():
        return vals[codes]
    out = np.empty(len(codes), object)
    ok = codes < len(vals)
    out[ok] = vals[codes[ok]]
    out[~ok] = np.nan
    return out


class RecommendationRankingBatchOp(BatchOperator):
    """Re-rank a recommendation column with a trained pipeline model: each
    candidate joins its row's features, the model scores the pairs, and the
    top-N by score replace the original list (reference: recommendation/
    RecommendationRankingBatchOp.java — PipelineModel rescoring).

    Inputs: (pipeline model table, data). The recomm column holds the
    ``{"object": [...], "rate": [...]}`` JSON the serving kernels emit."""

    RECOMM_COL = ParamInfo("mTableCol", str, optional=False,
                           aliases=("recommCol",))
    OBJECT_COL_NAME = ParamInfo("objectColName", str, default="object",
                                desc="candidate column name fed to the model")
    PREDICTION_SCORE_COL = ParamInfo("predictionScoreCol", str,
                                     default="pred",
                                     desc="model output column to rank by")
    TOP_N = ParamInfo("topN", int, default=10, validator=MinValidator(1))
    OUTPUT_COL = ParamInfo("outputCol", str, default=None)

    _min_inputs = 2
    _max_inputs = 2

    def _execute_impl(self, model_t: MTable, t: MTable) -> MTable:
        from ...pipeline.pipeline import PipelineModel

        pipe = PipelineModel.from_table(model_t)
        rcol = self.get(self.RECOMM_COL)
        obj_col = self.get(self.OBJECT_COL_NAME)
        score_col = self.get(self.PREDICTION_SCORE_COL)
        out_col = self.get(self.OUTPUT_COL) or rcol
        top_n = self.get(self.TOP_N)

        feature_cols = [c for c in t.names if c != rcol]
        feat_arrays = [t.col(c) for c in feature_cols]
        rec_cells = t.col(rcol)
        cand_rows = []
        owners = []
        for i in range(t.num_rows):
            cell = rec_cells[i]
            obj = json.loads(str(cell)) if cell is not None else {}
            base = tuple(a[i] for a in feat_arrays)
            for o in obj.get("object", []):
                cand_rows.append(base + (o,))
                owners.append(i)
        empty = _recomm_json(np.empty(0), np.empty(0), False)
        if not cand_rows:
            # no candidates anywhere: still emit the promised output column
            ranked = np.full(t.num_rows, empty, object)
            return t.with_column(out_col, ranked, AlinkTypes.STRING)
        cand = MTable.from_rows(
            cand_rows,
            TableSchema(feature_cols + [obj_col],
                        [t.schema.type_of(c) for c in feature_cols]
                        + [AlinkTypes.STRING]))
        from .base import TableSourceBatchOp

        scored = pipe.transform(TableSourceBatchOp(cand)).collect()
        if score_col not in scored.names:
            raise AkIllegalArgumentException(
                f"ranking model emitted no {score_col!r} column "
                f"(have {scored.names})")
        scores = np.asarray(scored.col(score_col), np.float64)
        # rank the ORIGINAL candidate ids — pipeline stages (StringIndexer
        # etc.) may have rewritten the object column in place
        objs_arr = np.asarray([r[-1] for r in cand_rows], object)
        owners = np.asarray(owners)
        ranked = np.full(t.num_rows, empty, object)
        # one group-by over the candidate table instead of a per-row scan
        order = np.argsort(owners, kind="stable")
        bounds = np.searchsorted(owners[order],
                                 np.arange(t.num_rows + 1))
        for i in range(t.num_rows):
            grp = order[bounds[i]:bounds[i + 1]]
            if grp.size == 0:
                continue
            s = scores[grp]
            pick = grp[np.argsort(-s)[:top_n]]
            ranked[i] = _recomm_json(objs_arr[pick], scores[pick], True)
        return t.with_column(out_col, ranked, AlinkTypes.STRING)

    def _out_schema(self, model_schema, in_schema):
        out_col = self.get(self.OUTPUT_COL) or self.get(self.RECOMM_COL)
        if out_col in in_schema.names:
            return in_schema
        return TableSchema(list(in_schema.names) + [out_col],
                           list(in_schema.types) + [AlinkTypes.STRING])
