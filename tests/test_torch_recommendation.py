"""Parity of the port's recommendation family (``recommendation/``,
``operator/batch/recommendation.py`` and ``recommendation2.py``) with
``alink_tpu`` on the CPU: the cases of ``tests/test_recommendation.py``,
``tests/test_recommendation2.py`` (without the stream twins) and the FM,
DeepFM and Leave-K-out cases of ``tests/test_longtail.py``, through both
packages on the same seeded tables.

Tolerances:
- ALS: predicted ratings within RATE_ATOL = 2e-4 (the port sums its
  Gramians in float64, the reference in float32; a few sweeps carry the
  float32 noise forward); top-K ids equal except at a position whose score
  lies within TIE_ATOL = 1e-5 of a neighbour's (a near tie either package
  may order either way), rates within RATE_ATOL.
- ItemCF/UserCF cosine similarities within SIM_ATOL = 1e-6 (float64 sums
  rounded to float32 against XLA's float32 sums), their lists equal except
  at near ties (TIE_ATOL); jaccard lists and Swing equal exactly.
- FM and DeepFM: the parameters after one Adam step within 1e-5; after
  training, scores within FM_ATOL = 2e-3 (Adam turns rounding noise into
  steps of the learning rate on near-zero gradients).
- Host code copied from the reference (CF serving loops, RankingList,
  negative sampling, Leave-K-out, vec-dot) gives equal outputs."""

import json

import numpy as np
import pytest

from torch_table_parity import both, reference_session, remove_session, \
    same_table

RATE_ATOL = 2e-4
TIE_ATOL = 1e-5
SIM_ATOL = 1e-6
FM_ATOL = 2e-3


@pytest.fixture(scope="module")
def sid():
    s = reference_session()
    yield s
    remove_session(s)


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("ALINK_TORCH_DEVICE", "cpu")


def _low_rank(n_u=40, n_i=30, k=4, seed=0, keep=0.6):
    rng = np.random.RandomState(seed)
    U = rng.randn(n_u, k) / np.sqrt(k)
    V = rng.randn(n_i, k) / np.sqrt(k)
    mask = rng.rand(n_u, n_i) < keep
    us, is_ = np.nonzero(mask)
    return {"user": us.astype(np.int64), "item": is_.astype(np.int64),
            "rating": (U @ V.T)[us, is_]}


def _triples(n=300, seed=0):
    rng = np.random.default_rng(seed)
    users = rng.integers(0, 20, n).astype(np.int64)
    items = rng.integers(0, 30, n).astype(np.int64)
    return {"u": users, "i": items,
            "r": (5 - np.abs(users % 5 - items % 5)).astype(np.float64)}


def same_recomm(port, ref, col="rec", rate_atol=RATE_ATOL):
    """Recommendation JSON cells: the same ids in the same order, except at
    a position whose reference score is within TIE_ATOL of a neighbour's;
    rates within ``rate_atol``."""
    for a, b in zip(port.col(col), ref.col(col)):
        pa, rb = json.loads(a), json.loads(b)
        assert len(pa["object"]) == len(rb["object"]), (a, b)
        np.testing.assert_allclose(pa["rate"], rb["rate"], atol=rate_atol)
        r = rb["rate"]
        for k, (x, y) in enumerate(zip(pa["object"], rb["object"])):
            if x != y:
                near = [abs(r[k] - r[j]) <= TIE_ATOL for j in (k - 1, k + 1)
                        if 0 <= j < len(r)]
                assert any(near), (k, a, b)


def _als(ops, extra, src, **kw):
    return ops.AlsTrainBatchOp(userCol="user", itemCol="item",
                               rateCol="rating", **kw, **extra).link_from(src)


# -- the core ----------------------------------------------------------------


def test_list_build_equals_the_references_dict_build():
    """The bulk list build gives the reference's rectangles, the hot-point
    cap's draws included (a cap that binds)."""
    from alink_tpu.recommendation import als as R
    from alink_tpu_torch.recommendation import als as P

    rng = np.random.default_rng(3)
    u = rng.integers(0, 30, 2000)
    i = np.minimum(rng.zipf(1.6, 2000), 50) - 1
    r = rng.integers(1, 6, 2000).astype(np.float32)
    for cap in (0, 15):
        by_u = {e: [] for e in range(30)}
        for a, b, v in zip(u, i, r):
            by_u[a].append((b, v))
        rng_r, rng_p = np.random.default_rng(1), np.random.default_rng(1)
        if cap:
            for e, pairs in by_u.items():
                if len(pairs) > cap:
                    pick = rng_r.choice(len(pairs), cap, replace=False)
                    by_u[e] = [pairs[j] for j in pick]
            assert max(np.bincount(u)) > cap
        want = R._pad_lists(by_u, 30)
        got = P.build_lists(u, i, r, 30, cap, rng_p)
        for w, g in zip(want, got):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("kw", [dict(), dict(implicit=True, alpha=40.0),
                                dict(max_neighbors=20)],
                         ids=["explicit", "implicit", "hot-point"])
def test_train_als_matches_the_reference(kw):
    import jax

    from alink_tpu.parallel.mesh import default_mesh
    from alink_tpu.recommendation import train_als as ref_als
    from alink_tpu_torch.recommendation import train_als

    rng = np.random.default_rng(0)
    u = rng.integers(0, 120, 3000)
    i = rng.integers(0, 90, 3000)
    r = rng.integers(1, 6, 3000).astype(np.float32)
    a = ref_als(u, i, r, rank=5, num_iter=5,
                mesh=default_mesh(jax.devices()[:1]), **kw)
    b = train_als(u, i, r, rank=5, num_iter=5, **kw)
    np.testing.assert_array_equal(b.user_ids, a.user_ids)
    np.testing.assert_array_equal(b.item_ids, a.item_ids)
    np.testing.assert_allclose(b.user_factors @ b.item_factors.T,
                               a.user_factors @ a.item_factors.T,
                               atol=RATE_ATOL)


def test_blocked_half_sweep_equals_the_unblocked_one():
    import torch

    from alink_tpu_torch.recommendation import als as P

    rng = np.random.default_rng(2)
    u = rng.integers(0, 200, 4000)
    i = rng.integers(0, 60, 4000)
    r = rng.integers(1, 6, 4000).astype(np.float32)
    ids, rts, mask = P.build_lists(u, i, r, 200)
    args = (torch.as_tensor(ids).long(), torch.as_tensor(rts).double(),
            torch.as_tensor(mask).double(),
            torch.as_tensor(mask.sum(1)).double(),
            torch.as_tensor(rng.standard_normal((60, 8)).astype(np.float32)))
    for implicit in (False, True):
        kw = dict(lam=0.1, implicit=implicit, alpha=40.0)
        whole = P.half_sweep(*args, **kw, rows=200)
        for rows in (1, 7, 64):
            assert torch.equal(P.half_sweep(*args, **kw, rows=rows), whole)


def test_interaction_similarity_matches_the_reference():
    from alink_tpu.recommendation import interaction_similarity as ref_sim
    from alink_tpu_torch.recommendation import interaction_similarity

    rng = np.random.default_rng(0)
    u = rng.integers(0, 120, 3000)
    i = rng.integers(0, 90, 3000)
    r = rng.integers(1, 6, 3000).astype(np.float32)
    for metric in ("cosine", "jaccard"):
        for kind in ("item", "user"):
            a = ref_sim(u, i, r, kind=kind, metric=metric, top_k=8)
            b = interaction_similarity(u, i, r, kind=kind, metric=metric,
                                       top_k=8, chunk=32)
            np.testing.assert_array_equal(b[0], a[0])
            np.testing.assert_array_equal(b[3], a[3])
            np.testing.assert_allclose(b[2], a[2], atol=SIM_ATOL)
            if metric == "jaccard":
                np.testing.assert_array_equal(b[1], a[1])
                np.testing.assert_array_equal(b[2], a[2])
            else:
                for row_b, row_a, s in zip(b[1], a[1], a[2]):
                    for k in np.flatnonzero(row_b != row_a):
                        assert min(abs(s[k] - s[j]) for j in (k - 1, k + 1)
                                   if 0 <= j < len(s)) <= TIE_ATOL


def test_swing_matches_the_reference():
    from alink_tpu.recommendation import swing_similarity as ref_swing
    from alink_tpu_torch.recommendation import swing_similarity

    rng = np.random.default_rng(5)
    u = rng.integers(0, 80, 1500)
    i = rng.integers(0, 40, 1500)
    for cap in (1000, 12):     # 12: the user cap binds
        a = ref_swing(u, i, top_k=10, max_users_per_item=cap)
        b = swing_similarity(u, i, top_k=10, max_users_per_item=cap)
        for x, y in zip(b, a):
            np.testing.assert_array_equal(x, y)


# -- the ops (tests/test_recommendation.py) ---------------------------------


def test_als_rate_on_seen_and_held_out_pairs(sid):
    cols = _low_rank()
    held = {"user": np.repeat(np.arange(41), 31).astype(np.int64),
            "item": np.tile(np.arange(31), 41).astype(np.int64)}
    ref, port = both(sid, cols, lambda ops, extra, src, q: ops
                     .AlsRateRecommBatchOp(predictionCol="p", **extra)
                     .link_from(_als(ops, extra, src, rank=4, numIter=15,
                                     **{"lambda": 0.01}), q), held)
    p, r = np.asarray(port.col("p")), np.asarray(ref.col("p"))
    # unknown users and items (id 40, item 30) give NaN in both
    assert np.isnan(r).sum() == 41 + 31 - 1
    np.testing.assert_array_equal(np.isnan(p), np.isnan(r))
    np.testing.assert_allclose(p, r, atol=RATE_ATOL)


def test_als_implicit_items_per_user(sid):
    rng = np.random.RandomState(1)
    us, is_ = [], []
    for u in range(20):
        for i in range(15):
            if i % 2 == u % 2 and rng.rand() < 0.8:
                us.append(u)
                is_.append(i)
    cols = {"user": np.asarray(us, np.int64), "item": np.asarray(is_, np.int64)}
    q = {"user": np.arange(4, dtype=np.int64)}
    ref, port = both(sid, cols, lambda ops, extra, src, qs: ops
                     .AlsItemsPerUserRecommBatchOp(predictionCol="rec", k=5,
                                                   **extra)
                     .link_from(ops.AlsTrainBatchOp(
                         userCol="user", itemCol="item", rank=4, numIter=10,
                         implicitPrefs=True, alpha=20.0, **{"lambda": 0.05},
                         **extra).link_from(src), qs), q)
    same_recomm(port, ref)


@pytest.mark.parametrize("op", ["AlsItemsPerUserRecommBatchOp",
                                "AlsUsersPerItemRecommBatchOp",
                                "AlsSimilarItemsRecommBatchOp",
                                "AlsSimilarUsersRecommBatchOp"])
def test_als_top_k_ops(sid, op):
    cols = _low_rank(20, 12, 3, seed=2)
    q = {"user": np.asarray([0, 1, 999, 5], np.int64),
         "item": np.asarray([0, 5, 7, 999], np.int64)}
    ref, port = both(sid, cols, lambda ops, extra, src, qs: getattr(ops, op)(
        predictionCol="rec", k=4, **extra).link_from(
        _als(ops, extra, src, rank=3, numIter=5), qs), q)
    same_table(port.select(["user", "item"]), ref.select(["user", "item"]))
    same_recomm(port, ref)
    # the unknown id gives the empty recommendation
    empty = json.dumps({"object": [], "rate": []})
    assert empty in list(ref.col("rec")) and empty in list(port.col("rec"))


def test_als_top_k_ties_go_to_the_lower_index(sid):
    """Items with equal factors tie exactly: both packages list them in
    index order (lax.top_k's rule)."""
    from alink_tpu_torch.common.model import model_to_table

    U = np.asarray([[1.0, 0.0], [0.0, 1.0]], np.float32)
    V = np.asarray([[0.5, 0.5], [1.0, 0.0], [0.5, 0.5], [1.0, 0.0],
                    [0.0, 0.0]], np.float32)
    meta = {"modelName": "AlsModel", "userCol": "user", "itemCol": "item",
            "rateCol": None, "rank": 2, "implicitPrefs": False}
    arrays = {"userIds": np.arange(2, dtype=np.int64),
              "itemIds": np.arange(10, 15, dtype=np.int64),
              "userFactors": U, "itemFactors": V}
    from alink_tpu.common.model import model_to_table as ref_m2t

    q = {"user": np.asarray([0, 1], np.int64)}
    outs = []
    for pkg, m2t in (("alink_tpu", ref_m2t), ("alink_tpu_torch",
                                               model_to_table)):
        import importlib

        B = importlib.import_module(f"{pkg}.operator.batch")
        T = importlib.import_module(f"{pkg}.common.mtable").MTable
        outs.append(B.AlsItemsPerUserRecommBatchOp(
            predictionCol="rec", k=4).link_from(
            B.TableSourceBatchOp(m2t(meta, arrays)),
            B.TableSourceBatchOp(T(dict(q)))).collect())
    ref, port = outs
    assert list(port.col("rec")) == list(ref.col("rec"))
    assert json.loads(port.col("rec")[0])["object"] == [11, 13, 10, 12]


def test_item_cf_ops(sid):
    users = np.concatenate([np.repeat(np.arange(8), 2), [8, 8]])
    items = np.concatenate([np.tile([0, 1], 8), [2, 3]])
    cols = {"u": users.astype(np.int64), "i": items.astype(np.int64),
            "r": np.ones(len(users))}
    q = {"u": np.asarray([0, 0, 8, 77], np.int64),
         "i": np.asarray([1, 2, 0, 1], np.int64)}
    for op in ("ItemCfSimilarItemsRecommBatchOp", "ItemCfRateRecommBatchOp",
               "ItemCfItemsPerUserRecommBatchOp",
               "ItemCfUsersPerItemRecommBatchOp"):
        ref, port = both(sid, cols, lambda ops, extra, src, qs: getattr(
            ops, op)(predictionCol="rec", k=3, itemCol="i", userCol="u",
                     **extra).link_from(ops.ItemCfTrainBatchOp(
                         userCol="u", itemCol="i", rateCol="r", **extra)
                .link_from(src), qs), q)
        same_table(port, ref, rtol=1e-6)


@pytest.mark.parametrize("metric", ["cosine", "jaccard"])
def test_cf_models_equal_the_references(sid, metric):
    from alink_tpu.common.model import table_to_model as r_t2m
    from alink_tpu_torch.common.model import table_to_model as p_t2m

    for train in ("ItemCfTrainBatchOp", "UserCfTrainBatchOp"):
        ref, port = both(sid, _triples(), lambda ops, extra, src: getattr(
            ops, train)(userCol="u", itemCol="i", rateCol="r",
                        similarityType=metric, maxNeighborNumber=6, **extra)
            .link_from(src))
        (pm, pa), (rm, ra) = p_t2m(port), r_t2m(ref)
        assert pm == rm
        for k in ("entityIds", "userIds", "itemIds", "interU", "interI",
                  "interR"):
            np.testing.assert_array_equal(pa[k], ra[k])
        np.testing.assert_allclose(pa["sims"], ra["sims"], atol=SIM_ATOL)
        for row_p, row_r, s in zip(pa["neighbors"], ra["neighbors"],
                                   ra["sims"]):
            for k in np.flatnonzero(row_p != row_r):
                assert min(abs(s[k] - s[j]) for j in (k - 1, k + 1)
                           if 0 <= j < len(s)) <= TIE_ATOL


def test_cf_serving_scores_tie_in_the_references_order(sid):
    """A CF model with tied similarities: the serving loops' numpy argsort
    runs on bit-equal scores, so tied items come out in the reference's
    order."""
    users = np.repeat(np.arange(6), 4)
    items = np.tile([0, 1, 2, 3], 6)
    keep = ~((users == 0) & (items >= 2))
    cols = {"u": users[keep].astype(np.int64),
            "i": items[keep].astype(np.int64)}
    q = {"u": np.asarray([0, 1], np.int64), "i": np.asarray([0, 3],
                                                            np.int64)}
    for train, op in (("ItemCfTrainBatchOp",
                       "ItemCfItemsPerUserRecommBatchOp"),
                      ("UserCfTrainBatchOp",
                       "UserCfItemsPerUserRecommBatchOp"),
                      ("UserCfTrainBatchOp",
                       "UserCfUsersPerItemRecommBatchOp")):
        ref, port = both(sid, cols, lambda ops, extra, src, qs: getattr(
            ops, op)(predictionCol="rec", k=4, userCol="u", itemCol="i",
                     **extra).link_from(getattr(ops, train)(
                         userCol="u", itemCol="i", similarityType="jaccard",
                         **extra).link_from(src), qs), q)
        same_table(port, ref)


def test_item_cf_serving_equals_the_references_on_one_model(sid):
    """The reference's ItemCF model served by both packages: items per
    user equal as JSON text, so the port's bulk float32 accumulation (one
    ``np.add.at`` a user, in history order) adds as the reference's loop
    does and its argsort sees bit-equal scores."""
    import alink_tpu.operator.batch as R
    import alink_tpu_torch.operator.batch as P
    from alink_tpu.common.model import table_to_model
    from alink_tpu.common.mtable import MTable as RT
    from alink_tpu_torch.common.model import model_to_table
    from alink_tpu_torch.common.mtable import MTable as PT

    rng = np.random.default_rng(7)
    n = 4000
    cols = {"u": rng.integers(0, 300, n), "i": rng.integers(0, 80, n),
            "r": rng.random(n) * 5}
    ref_model = R.ItemCfTrainBatchOp(
        userCol="u", itemCol="i", rateCol="r", maxNeighborNumber=12,
        MLEnvironmentId=sid).link_from(R.TableSourceBatchOp(
            RT(dict(cols)))).collect()
    port_model = model_to_table(*table_to_model(ref_model))
    q = {"u": np.arange(310, dtype=np.int64)}
    kw = dict(userCol="u", predictionCol="rec", k=7)
    ref = R.ItemCfItemsPerUserRecommBatchOp(**kw, MLEnvironmentId=sid) \
        .link_from(R.TableSourceBatchOp(ref_model),
                   R.TableSourceBatchOp(RT(dict(q)))).collect()
    port = P.ItemCfItemsPerUserRecommBatchOp(**kw).link_from(
        P.TableSourceBatchOp(port_model),
        P.TableSourceBatchOp(PT(dict(q)))).collect()
    assert list(port.col("rec")) == list(ref.col("rec"))


def test_user_cf_rate_and_cross_role_ops(sid):
    for op in ("UserCfRateRecommBatchOp", "UserCfItemsPerUserRecommBatchOp",
               "UserCfUsersPerItemRecommBatchOp",
               "UserCfSimilarUsersRecommBatchOp"):
        ref, port = both(sid, _triples(), lambda ops, extra, src: getattr(
            ops, op)(userCol="u", itemCol="i", predictionCol="rec", k=3,
                     **extra).link_from(ops.UserCfTrainBatchOp(
                         userCol="u", itemCol="i", rateCol="r", **extra)
                .link_from(src), src))
        if op == "UserCfRateRecommBatchOp":
            same_table(port, ref, rtol=1e-6)
        else:
            same_recomm(port, ref, rate_atol=1e-5)


def test_swing_ops(sid):
    users, items = [], []
    for u in range(6):
        users += [u, u]
        items += [0, 1]
    cols = {"u": np.asarray(users + [6], np.int64),
            "i": np.asarray(items + [2], np.int64)}
    q = {"i": np.asarray([0, 2, 9], np.int64)}
    for op in ("SwingSimilarItemsRecommBatchOp", "SwingRecommBatchOp"):
        ref, port = both(sid, cols, lambda ops, extra, src, qs: getattr(
            ops, op)(predictionCol="rec", k=2, itemCol="i", **extra)
            .link_from(ops.SwingTrainBatchOp(userCol="u", itemCol="i",
                                             **extra).link_from(src), qs), q)
        same_table(port, ref)
        assert json.loads(port.col("rec")[0])["object"] == [1]


# -- the long tail (tests/test_recommendation2.py) --------------------------


def test_als_variants_and_hot_point(sid):
    from alink_tpu.common.model import table_to_model as r_t2m
    from alink_tpu_torch.common.model import table_to_model as p_t2m

    for op, kw in (("AlsImplicitTrainBatchOp", dict(numIter=3, rank=4)),
                   ("AlsForHotPointTrainBatchOp",
                    dict(numIter=2, maxNeighborNumber=8)),
                   ("AlsImplicitForHotPointTrainBatchOp",
                    dict(numIter=2, maxNeighborNumber=8)),
                   ("MfAlsBatchOp", dict(numIter=4)),
                   ("MfAlsForHotPointBatchOp",
                    dict(numIter=3, maxNeighborNumber=5))):
        ref, port = both(sid, _triples(), lambda ops, extra, src: getattr(
            ops, op)(userCol="u", itemCol="i", rateCol="r", **kw, **extra)
            .link_from(src))
        (pm, pa), (rm, ra) = p_t2m(port), r_t2m(ref)
        assert pm == rm, op
        np.testing.assert_allclose(
            pa["userFactors"] @ pa["itemFactors"].T,
            ra["userFactors"] @ ra["itemFactors"].T, atol=RATE_ATOL,
            err_msg=op)


def test_negative_sampling_and_ranking_list(sid):
    cols = _triples(100)
    for build in (
            lambda ops, extra, src: ops.NegativeItemSamplingBatchOp(
                userCol="u", itemCol="i", samplingFactor=2).link_from(src),
            lambda ops, extra, src: ops.RankingListBatchOp(
                objectCol="i", topN=5).link_from(src),
            lambda ops, extra, src: ops.RankingListBatchOp(
                objectCol="i", groupCol="u", topN=2).link_from(src),
            lambda ops, extra, src: ops.RankingListBatchOp(
                objectCol="i", scoreCol="r", topN=7).link_from(src),
            lambda ops, extra, src: ops.RankingListBatchOp(
                objectCol="i", groupCol="u", scoreCol="r",
                topN=3).link_from(src)):
        ref, port = both(sid, cols, build)
        same_table(port, ref)


def test_ranking_list_ties_and_a_missing_object(sid):
    """Tied counts come out in pandas' order, a None object is a group of
    its own (NaN, last), and a float score sums as pandas sums."""
    objs = np.asarray(["b", "a", None, "c", "a", "b", None, "d", "c", "e",
                       "e", "f"], object)
    cols = {"o": objs, "g": np.asarray([1, 2, 1, 2, 1, 2, 1, 2, 1, 2, 1, 2],
                                       np.int64),
            "s": np.asarray([0.1, 0.2, 0.3, 0.1, 0.2, 0.3, 0.1, 1e16, 0.3,
                             -1e16, 0.1, np.nan])}
    for kw in (dict(topN=4), dict(topN=10), dict(groupCol="g", topN=3),
               dict(scoreCol="s", topN=6),
               dict(groupCol="g", scoreCol="s", topN=2)):
        ref, port = both(sid, cols, lambda ops, extra, src: ops
                         .RankingListBatchOp(objectCol="o", **kw)
                         .link_from(src))
        same_table(port, ref)


def test_ranking_list_missing_group_fails_in_both():
    """A missing group value has no rank: the reference's pandas cast
    raises, and so does the port."""
    import alink_tpu.operator.batch as R
    import alink_tpu_torch.operator.batch as P
    from alink_tpu.common.mtable import MTable as RT
    from alink_tpu_torch.common.mtable import MTable as PT

    cols = {"o": np.asarray(["a", "b", "a"], object),
            "g": np.asarray(["x", None, "x"], object)}
    from alink_tpu_torch.common.exceptions import AkIllegalDataException

    for ops, T, exc in ((R, RT, ValueError), (P, PT, AkIllegalDataException)):
        with pytest.raises(exc):
            ops.RankingListBatchOp(objectCol="o", groupCol="g").link_from(
                ops.TableSourceBatchOp(T(dict(cols)))).collect()


def test_vecdot_model_and_serving(sid):
    u = {"uid": np.arange(3, dtype=np.int64),
         "vec": np.asarray(["1 0", "0 1", "1 1"], object)}
    i = {"iid": np.arange(3, dtype=np.int64),
         "vec": np.asarray(["2 0", "0 2", "1 1"], object)}
    q = {"uid": np.asarray([0, 2, 7], np.int64)}
    ref, port = both(sid, u, lambda ops, extra, us, its, qs: ops
                     .VecDotItemsPerUserRecommBatchOp(
                         userCol="uid", predictionCol="rec", k=2, **extra)
                     .link_from(ops.VecDotModelGeneratorBatchOp(**extra)
                                .link_from(us, its), qs), i, q)
    same_table(port, ref)
    assert json.loads(port.col("rec")[0])["object"] == [0, 2]


def test_recommendation_ranking(sid):
    import alink_tpu.pipeline as RP
    import alink_tpu_torch.pipeline as PP
    from alink_tpu.common.mtable import MTable as RT
    from alink_tpu_torch.common.mtable import MTable as PT

    train = {"item": np.asarray([str(i) for i in range(30)], object),
             "y": np.arange(30, dtype=np.float64)}
    models = []
    for P, T, extra in ((RP, RT, dict(MLEnvironmentId=sid)), (PP, PT, {})):
        models.append(P.Pipeline(
            P.StringIndexer(selectedCols=["item"], **extra),
            P.LinearRegression(featureCols=["item"], labelCol="y",
                               predictionCol="pred", **extra),
        ).fit(T(dict(train)))._to_table())
    it = iter(models)
    ref, port = both(sid, _triples(), lambda ops, extra, src: ops
                     .RecommendationRankingBatchOp(
                         mTableCol="rec", objectColName="item",
                         predictionScoreCol="pred", topN=3, **extra)
                     .link_from(ops.TableSourceBatchOp(next(it)),
                                ops.ItemCfItemsPerUserRecommBatchOp(
                                    userCol="u", predictionCol="rec", k=5,
                                    **extra).link_from(
                                    ops.ItemCfTrainBatchOp(
                                        userCol="u", itemCol="i", rateCol="r",
                                        **extra).link_from(src), src)))
    same_recomm(port, ref, rate_atol=1e-5)


# -- FM and DeepFM (tests/test_longtail.py, test_recommendation2.py) --------


def _block_ratings(n, seed=0, p=0.7):
    rng = np.random.default_rng(seed)
    rows = []
    for u in range(n):
        for i in range(n):
            same = (u < n // 2) == (i < n // 2)
            r = (4.0 if same else 1.0) + 0.2 * rng.standard_normal()
            if rng.random() < p:
                rows.append((f"u{u}", f"i{i}", float(r)))
    return {"user": np.asarray([r[0] for r in rows], object),
            "item": np.asarray([r[1] for r in rows], object),
            "rate": np.asarray([r[2] for r in rows])}


@pytest.mark.parametrize("train", ["FmRecommTrainBatchOp",
                                   "DeepFmRecommTrainBatchOp"])
def test_fm_first_adam_step_matches_the_reference(sid, train):
    """One epoch is one full-batch Adam step from numpy's seeded initial
    weights: every parameter within 1e-5 of the reference's."""
    from alink_tpu.common.model import table_to_model as r_t2m
    from alink_tpu_torch.common.model import table_to_model as p_t2m

    ref, port = both(sid, _block_ratings(12), lambda ops, extra, src:
                     getattr(ops, train)(userCol="user", itemCol="item",
                                         rateCol="rate", rank=4, numEpochs=1,
                                         **extra).link_from(src))
    (pm, pa), (rm, ra) = p_t2m(port), r_t2m(ref)
    assert pm == rm
    assert pa.keys() == ra.keys()
    for k in ra:
        if ra[k].dtype.kind in "fc":
            np.testing.assert_allclose(pa[k], ra[k], atol=1e-5, err_msg=k)
        else:
            np.testing.assert_array_equal(pa[k], ra[k])


def test_fm_recommender_end_to_end(sid):
    q = {"user": np.asarray(["u1", "u1", "zz"], object),
         "item": np.asarray(["i2", "i15", "i3"], object)}
    for op in ("FmRateRecommBatchOp", "FmItemsPerUserRecommBatchOp",
               "FmUsersPerItemRecommBatchOp"):
        ref, port = both(sid, _block_ratings(20), lambda ops, extra, src, qs:
                         getattr(ops, op)(userCol="user", itemCol="item",
                                          predictionCol="rec", k=5, **extra)
                         .link_from(ops.FmRecommTrainBatchOp(
                             userCol="user", itemCol="item", rateCol="rate",
                             rank=4, numEpochs=200, learnRate=0.05, **extra)
                             .link_from(src), qs), q)
        if op == "FmRateRecommBatchOp":
            p, r = np.asarray(port.col("rec")), np.asarray(ref.col("rec"))
            np.testing.assert_allclose(p, r, atol=FM_ATOL)
            assert np.isnan(p[2]) and p[0] > p[1] + 1.0
        else:
            same_recomm(port, ref, rate_atol=FM_ATOL)


def test_fm_binary_implicit(sid):
    q = {"u": np.asarray([0, 3, 99], np.int64)}
    ref, port = both(sid, _triples(), lambda ops, extra, src, qs: ops
                     .FmItemsPerUserRecommBatchOp(userCol="u",
                                                  predictionCol="rec", k=3,
                                                  **extra)
                     .link_from(ops.FmRecommBinaryImplicitTrainBatchOp(
                         userCol="u", itemCol="i", rateCol="r", numEpochs=5,
                         **extra).link_from(src), qs), q)
    same_recomm(port, ref, rate_atol=1e-5)


def test_deepfm_recommender(sid):
    q = {"user": np.asarray(["u1", "u1", "zz"], object),
         "item": np.asarray(["i2", "i12", "i1"], object)}
    for op in ("DeepFmRateRecommBatchOp", "DeepFmItemsPerUserRecommBatchOp"):
        ref, port = both(sid, _block_ratings(16, p=0.8), lambda ops, extra,
                         src, qs: getattr(ops, op)(predictionCol="rec", k=4,
                                                   **extra)
                         .link_from(ops.DeepFmRecommTrainBatchOp(
                             userCol="user", itemCol="item", rateCol="rate",
                             rank=4, numEpochs=200, **extra)
                             .link_from(src), qs), q)
        if op == "DeepFmRateRecommBatchOp":
            p, r = np.asarray(port.col("rec")), np.asarray(ref.col("rec"))
            np.testing.assert_allclose(p, r, atol=FM_ATOL)
            assert np.isnan(p[2]) and p[0] > p[1] + 1.0   # unknown → NaN
        else:
            same_recomm(port, ref, rate_atol=FM_ATOL)
            assert json.loads(port.col("rec")[2])["object"] == []


def test_leave_k_object_out(sid):
    rows = [(f"u{u}", f"i{i}", float(i)) for u in range(3) for i in range(5)]
    cols = {"user": np.asarray([r[0] for r in rows], object),
            "item": np.asarray([r[1] for r in rows], object),
            "rate": np.asarray([r[2] for r in rows])}
    for op, kw in (("LeaveKObjectOutBatchOp", dict(k=2, seed=0)),
                   ("LeaveTopKObjectOutBatchOp", dict(k=1))):
        outs = []
        for side in (None, 0):
            def build(ops, extra, src):
                o = getattr(ops, op)(userCol="user", itemCol="item",
                                     rateCol="rate", **kw).link_from(src)
                return o if side is None else o.get_side_output(side)
            outs.append(both(sid, cols, build))
        for ref, port in outs:
            same_table(port, ref)
    assert sorted(outs[0][1].col("item")) == ["i4", "i4", "i4"]
