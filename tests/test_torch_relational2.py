"""Parity of the port's relational long-tail (outer joins, multiset set
operations, AS, exact-size samplers, Print, DataSetWrapper, the random
vector source) with the reference on the CPU: the same rows, samplers
included (both draw from ``numpy.random.default_rng(randomSeed)``)."""

import numpy as np
import pytest

from torch_table_parity import both, same_table


@pytest.fixture(scope="module")
def sid():
    from torch_table_parity import reference_session, remove_session

    s = reference_session()
    yield s
    remove_session(s)


LEFT = {"k": np.asarray([1, 2, 2, 3, 5], np.int64),
        "a": np.asarray(["p", "q", "r", "s", "t"], object)}
RIGHT = {"k2": np.asarray([2, 3, 4], np.int64),
         "b": np.asarray([0.5, 1.5, 2.5])}


@pytest.mark.parametrize("op", ["LeftOuterJoinBatchOp",
                                "RightOuterJoinBatchOp",
                                "FullOuterJoinBatchOp"])
def test_outer_joins(sid, op):
    ref, got = both(sid, LEFT, lambda B, e, a, b: getattr(B, op)(
        "k = k2", "k, a, b", **e).link_from(a, b), RIGHT)
    same_table(got, ref)


MULTI_A = {"x": np.asarray([1, 1, 1, 2, 3, 3], np.int64),
           "y": np.asarray(["u", "u", "u", "v", "w", "w"], object)}
MULTI_B = {"x": np.asarray([1, 1, 3, 4], np.int64),
           "y": np.asarray(["u", "u", "w", "z"], object)}


@pytest.mark.parametrize("op,rows", [("IntersectAllBatchOp", 3),
                                     ("MinusAllBatchOp", 3)])
def test_multiset_ops(sid, op, rows):
    ref, got = both(sid, MULTI_A, lambda B, e, a, b: getattr(B, op)(**e)
                    .link_from(a, b), MULTI_B)
    same_table(got, ref)
    assert got.num_rows == rows


def test_as_renames_positionally(sid):
    ref, got = both(sid, LEFT, lambda B, e, s: B.AsBatchOp(
        clause="key, label", **e).link_from(s))
    same_table(got, ref)
    assert got.names == ["key", "label"]


STRATA = {"g": np.asarray(list("aabbbbcccccc"), object),
          "v": np.arange(12, dtype=np.float64)}


@pytest.mark.parametrize("params", [dict(size=5), dict(size=7,
                                                        withReplacement=True),
                                    dict(size=50, randomSeed=3)])
def test_sample_with_size(sid, params):
    ref, got = both(sid, STRATA, lambda B, e, s: B.SampleWithSizeBatchOp(
        **params, **e).link_from(s))
    same_table(got, ref)


@pytest.mark.parametrize("params", [dict(strataSize=2),
                                    dict(strataSizes="a:1,b:3,c:4",
                                         randomSeed=7)])
def test_stratified_sample_with_size(sid, params):
    ref, got = both(sid, STRATA, lambda B, e, s:
                    B.StratifiedSampleWithSizeBatchOp(
                        strataCol="g", **params, **e).link_from(s))
    same_table(got, ref)


def test_print_passes_through(sid, capsys):
    ref, got = both(sid, LEFT, lambda B, e, s: B.PrintBatchOp(
        numRows=2, **e).link_from(s))
    same_table(got, ref)
    out = capsys.readouterr().out
    assert out.count("p") >= 2


def test_dataset_wrapper(sid):
    ref, got = both(sid, LEFT, lambda B, e, s: B.SelectBatchOp(
        "k, a", **e).link_from(s))
    import alink_tpu_torch.operator.batch as P
    from alink_tpu_torch.common.mtable import MTable

    wrapped = P.DataSetWrapperBatchOp(MTable(dict(LEFT))).collect()
    same_table(wrapped, ref)


@pytest.mark.parametrize("params", [{}, dict(numRows=7, size=[2, 3],
                                             sparsity=0.5, randomSeed=4,
                                             idCol="id", outputCol="v")])
def test_random_vector_source(sid, params):
    import alink_tpu.operator.batch as R
    import alink_tpu_torch.operator.batch as P

    ref = R.RandomVectorSourceBatchOp(**params, MLEnvironmentId=sid) \
        .collect()
    got = P.RandomVectorSourceBatchOp(**params).collect()
    same_table(got, ref)
