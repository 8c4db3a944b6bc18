"""Parity of the port's similarity family (``operator/batch/similarity.py``
and nlp2's approximate neighbours) with ``alink_tpu`` on the CPU: the
cases of ``tests/test_similarity.py`` and ``tests/test_nlp_graph2.py``
through both packages on the same tables.

Tolerances: the string metrics, SimHash and LSH are host code copied, and
their outputs are equal. BRUTE vector neighbours: the same ids in the same
order (ties to the lower training row, as ``lax.top_k``), distances within
DIST_RTOL = 1e-5 relative plus DIST_ATOL = 1e-5 (the distance matrix is
float32 products summed in XLA's order in the reference and MKL's here;
a distance near zero is the difference of two float32 squares). The
blocked query route equals the unblocked one exactly."""

import json

import numpy as np
import pytest

from torch_table_parity import both, reference_session, remove_session, \
    same_model, same_table

DIST_RTOL = 1e-5
DIST_ATOL = 1e-5


@pytest.fixture(scope="module")
def sid():
    s = reference_session()
    yield s
    remove_session(s)


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("ALINK_TORCH_DEVICE", "cpu")


def test_levenshtein_lcs_and_simhash_equal_the_reference():
    from alink_tpu.operator.batch import similarity as R
    from alink_tpu_torch.operator.batch import similarity as P

    rng = np.random.default_rng(0)
    words = ["".join(rng.choice(list("abcde"), int(rng.integers(0, 9))))
             for _ in range(40)]
    for a, b in zip(words[:20], words[20:]):
        assert P.levenshtein(a, b) == R.levenshtein(a, b)
        assert P.lcs(a, b) == R.lcs(a, b)
        assert P.simhash64(a) == R.simhash64(a)
    assert P.levenshtein("kitten", "sitting") == 3


PAIRS = {"a": np.asarray(["kitten", "same", "", "the quick brown fox",
                          "alpha beta gamma", None], object),
         "b": np.asarray(["sitting", "same", "abc", "the slow brown fox",
                          "xyz qrs tuv", "x"], object)}


@pytest.mark.parametrize("text", [False, True])
@pytest.mark.parametrize("metric", ["LEVENSHTEIN", "LEVENSHTEIN_SIM", "LCS",
                                    "LCS_SIM", "COSINE", "JACCARD_SIM",
                                    "SIMHASH_HAMMING",
                                    "SIMHASH_HAMMING_SIM"])
def test_pairwise_similarity(sid, metric, text):
    op = ("TextSimilarityPairwiseBatchOp" if text
          else "StringSimilarityPairwiseBatchOp")
    ref, port = both(sid, PAIRS, lambda ops, extra, src: getattr(ops, op)(
        selectedCols=["a", "b"], metric=metric, **extra).link_from(src))
    same_table(port, ref)


@pytest.mark.parametrize("train, predict, metric", [
    ("StringNearestNeighborTrainBatchOp",
     "StringNearestNeighborPredictBatchOp", "LEVENSHTEIN_SIM"),
    ("TextNearestNeighborTrainBatchOp", "TextNearestNeighborPredictBatchOp",
     "JACCARD_SIM"),
    ("StringApproxNearestNeighborTrainBatchOp",
     "StringApproxNearestNeighborPredictBatchOp", "SIMHASH_HAMMING_SIM"),
    ("TextApproxNearestNeighborTrainBatchOp",
     "TextApproxNearestNeighborPredictBatchOp", "SIMHASH_HAMMING"),
])
def test_string_and_text_neighbours(sid, train, predict, metric):
    corpus = {"id": np.asarray(["1", "2", "3", "4"], object),
              "s": np.asarray(["apple pie", "apply pie", "zebra",
                               "hello world"], object)}
    queries = {"s": np.asarray(["appel pie", "hello world!", "zebra"],
                               object)}

    def build(ops, extra, c, q):
        model = getattr(ops, train)(idCol="id", selectedCol="s",
                                    metric=metric, **extra).link_from(c)
        return getattr(ops, predict)(selectedCol="s", topN=2,
                                     **extra).link_from(model, q)

    ref, port = both(sid, corpus, build, queries)
    same_table(port, ref)


def _vector_tables(n=300, d=8, q=40, seed=0):
    """Seeded training and query vectors with exact ties: training rows
    200..209 repeat rows 0..9 (equal distances to every query), and the
    first queries are training rows themselves (distance 0)."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32)
    X[200:210] = X[:10]
    Q = rng.normal(size=(q, d)).astype(np.float32)
    Q[:5] = X[[3, 7, 200, 250, 9]]
    fmt = lambda M: np.asarray([" ".join(repr(float(v)) for v in r)
                                for r in M], object)
    return ({"id": np.asarray([f"v{i}" for i in range(n)], object),
             "vec": fmt(X)}, {"vec": fmt(Q)})


def _neighbours(t):
    return [json.loads(s) for s in t.col("nn")]


def _hold(port, ref):
    for p, r in zip(_neighbours(port), _neighbours(ref)):
        assert list(p) == list(r)
        np.testing.assert_allclose(list(p.values()), list(r.values()),
                                   rtol=DIST_RTOL, atol=DIST_ATOL)


@pytest.mark.parametrize("solver", ["BRUTE", "LSH"])
@pytest.mark.parametrize("metric", ["EUCLIDEAN", "COSINE"])
@pytest.mark.parametrize("approx", [False, True])
def test_vector_neighbours(sid, solver, metric, approx):
    corpus, queries = _vector_tables()
    kind = "Approx" if approx else ""
    params = {} if approx and solver == "LSH" else {"solver": solver}

    def build(ops, extra, c, q):
        model = getattr(ops, f"Vector{kind}NearestNeighborTrainBatchOp")(
            idCol="id", selectedCol="vec", metric=metric,
            **extra).link_from(c)
        return getattr(ops, f"Vector{kind}NearestNeighborPredictBatchOp")(
            selectedCol="vec", outputCol="nn", topN=10, **params,
            **extra).link_from(model, q)

    ref, port = both(sid, corpus, build, queries)
    if solver == "LSH":
        same_table(port, ref)
    else:
        _hold(port, ref)
    first = list(_neighbours(port)[0])
    if metric == "EUCLIDEAN":
        # a query equal to training row 3 (and to nothing else) finds it
        assert first[0] == "v3"
    tied = list(_neighbours(port)[2])
    if solver == "BRUTE":
        # query 2 is row 200 = row 0: the lower row comes first
        assert tied[:2] == ["v0", "v200"]


def test_blocked_queries_equal_the_unblocked(monkeypatch):
    """The query blocks give exactly the one-block result, with a block of
    3 rows (phase 20's 1,000,000 training rows take ~268 a block)."""
    from alink_tpu_torch.common.mtable import MTable
    from alink_tpu_torch.operator.batch import (
        TableSourceBatchOp, VectorNearestNeighborPredictBatchOp,
        VectorNearestNeighborTrainBatchOp)
    from alink_tpu_torch.operator.batch.similarity import \
        VectorNearestNeighborModelMapper as M

    corpus, queries = _vector_tables(seed=1)
    model = VectorNearestNeighborTrainBatchOp(
        idCol="id", selectedCol="vec").link_from(
        TableSourceBatchOp(MTable(corpus)))
    outs = []
    for elements in (M.BLOCK_ELEMENTS, 3 * 300):
        monkeypatch.setattr(M, "BLOCK_ELEMENTS", elements)
        outs.append(VectorNearestNeighborPredictBatchOp(
            selectedCol="vec", outputCol="nn", topN=7).link_from(
            model, TableSourceBatchOp(MTable(queries))).collect())
    assert list(outs[0].col("nn")) == list(outs[1].col("nn"))


def test_smallest_k_orders_ties_as_lax_top_k():
    """Ties inside the k and across the k-th place go to the lower index,
    as ``lax.top_k(-d, k)`` orders them."""
    import jax
    import torch

    from alink_tpu_torch.operator.batch.similarity import smallest_k

    rng = np.random.default_rng(2)
    d = rng.integers(0, 4, size=(64, 50)).astype(np.float32)
    for k in (1, 5, 20):
        idx, vals = smallest_k(torch.as_tensor(d), k)
        neg, want = jax.lax.top_k(-d, k)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(want))
        np.testing.assert_array_equal(vals.numpy(), -np.asarray(neg))


def test_naive_bayes_text(sid):
    from alink_tpu.common.mtable import AlinkTypes, TableSchema

    vecs = ["$4$0:3 1:2", "$4$0:1 1:4", "$4$2:5 3:1", "$4$2:2 3:3", "$4$"]
    cols = {"v": np.asarray(vecs, object),
            "y": np.asarray([0, 0, 1, 1, 1], np.int64)}
    import alink_tpu.operator.batch as R
    import alink_tpu_torch.operator.batch as P
    from alink_tpu.common.mtable import MTable as RT
    from alink_tpu_torch.common.mtable import MTable as PT

    for model_type in ("Multinomial", "Bernoulli"):
        out = []
        for ops, T, extra in ((R, RT, dict(MLEnvironmentId=sid)),
                              (P, PT, {})):
            src = ops.TableSourceBatchOp(T(dict(cols), TableSchema(
                ["v", "y"], [AlinkTypes.SPARSE_VECTOR, AlinkTypes.LONG])))
            m = ops.NaiveBayesTextTrainBatchOp(
                vectorCol="v", labelCol="y", modelType=model_type,
                **extra).link_from(src)
            p = ops.NaiveBayesTextPredictBatchOp(
                predictionCol="p", predictionDetailCol="d",
                **extra).link_from(m, src)
            out.append((m.collect(), p.collect()))
        (rm, rp), (pm, pp) = out
        same_model(pm, rm)
        same_table(pp, rp)
        assert pp.col("p").tolist()[:4] == [0, 0, 1, 1]


def test_lsh_candidates_are_the_stable_argsorts_first():
    """The popcount-by-level candidates equal the reference's
    ``np.argsort(ham, kind="stable")[:n]`` (distance, then row), ties
    across the last level included."""
    from alink_tpu_torch.operator.batch.similarity import \
        VectorNearestNeighborModelMapper as M

    rng = np.random.default_rng(3)
    for bits, rows, n in ((16, 500, 40), (8, 300, 32), (20, 1_000, 1),
                          (16, 30, 30)):
        m = M.__new__(M)
        sigs = rng.random((rows, bits)) < 0.5
        m._packed = np.packbits(sigs, axis=1)
        for _ in range(20):
            q = rng.random(bits) < 0.5
            ham = (q[None, :] != sigs).sum(axis=1)
            want = np.argsort(ham, kind="stable")[:n]
            got = m._nearest_codes(np.packbits(q[None, :], axis=1)[0], n)
            np.testing.assert_array_equal(got, want)
