"""The statistics operators of the port (``operator/batch/statistics.py``)
and its ``stats`` package held against ``alink_tpu`` on the CPU, with
inputs made by seeded numpy: every op's output table within 1e-9 (both
are float64 host code, so they come out equal), the summary, correlation
and covariance accessors, and the distributions of ``stats/prob.py``."""

import numpy as np
import pytest

TOL = 1e-9


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("ALINK_TORCH_DEVICE", "cpu")


def _cols(seed=0, n=200):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=n)
    b = 0.6 * a + rng.normal(scale=0.5, size=n)
    c = np.round(rng.exponential(2.0, size=n))        # ties for Spearman
    c[::17] = np.nan                                  # missing values
    cat = rng.choice(["x", "y", "z"], size=n).astype(object)
    label = np.where(a + rng.normal(scale=0.8, size=n) > 0, "p",
                     "n").astype(object)
    vec = np.asarray([f"{u} {v} {w}" for u, v, w in
                      np.round(rng.integers(0, 4, (n, 3)), 0)], object)
    return {"a": a, "b": b, "c": c, "cat": cat, "label": label, "vec": vec}


# op -> (params, accessor or None)
OPS = {
    "SummarizerBatchOp": ({}, "collect_summary"),
    "CorrelationBatchOp": ({"selectedCols": ["a", "b"]},
                           "collect_correlation"),
    "CorrelationBatchOp-spearman": ({"selectedCols": ["a", "b", "c"],
                                     "method": "SPEARMAN"}, None),
    "VectorCorrelationBatchOp": ({"selectedCol": "vec"},
                                 "collect_correlation"),
    "ChiSquareTestBatchOp": ({"selectedCols": ["cat", "c"],
                              "labelCol": "label"}, None),
    "VectorChiSquareTestBatchOp": ({"selectedCol": "vec",
                                    "labelCol": "label"}, None),
    "QuantileBatchOp": ({"selectedCols": ["a", "c"], "quantileNum": 10},
                        None),
    "VectorSummarizerBatchOp": ({"selectedCol": "vec"},
                                "collect_vector_summary"),
    "CovarianceBatchOp": ({"selectedCols": ["a", "b"]}, None),
}


def _run(pkg, key):
    import importlib

    ops = importlib.import_module(pkg + ".operator.batch")
    MTable = importlib.import_module(pkg + ".common.mtable").MTable
    params, accessor = OPS[key]
    cols = _cols()
    if key == "CorrelationBatchOp-spearman":
        cols["c"] = np.nan_to_num(cols["c"])
    op = getattr(ops, key.split("-")[0])(**params).link_from(
        ops.TableSourceBatchOp(MTable(cols)))
    return op.collect(), (getattr(op, accessor)() if accessor else None)


def _same_table(got, want):
    assert got.names == want.names
    assert got.schema.types == want.schema.types
    for n in want.names:
        g, w = got.col(n), want.col(n)
        if g.dtype.kind in "OUS":
            assert list(g) == list(w), n
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=TOL, err_msg=n)


@pytest.mark.parametrize("key", list(OPS))
def test_statistics_op_matches_reference(key):
    got, got_acc = _run("alink_tpu_torch", key)
    want, want_acc = _run("alink_tpu", key)
    _same_table(got, want)
    if got_acc is None:
        return
    if hasattr(want_acc, "correlation_matrix"):
        assert got_acc.col_names == want_acc.col_names
        np.testing.assert_allclose(got_acc.correlation_matrix,
                                   want_acc.correlation_matrix, rtol=0,
                                   atol=TOL)
        assert repr(got_acc) == repr(want_acc)
    else:
        assert got_acc.col_names == want_acc.col_names
        assert got_acc.stats.keys() == want_acc.stats.keys()
        for c in want_acc.col_names:
            np.testing.assert_allclose(
                [got_acc.stats[c].get(k, 0.0) for k in want_acc.stats[c]],
                [want_acc.stats[c][k] for k in want_acc.stats[c]],
                rtol=0, atol=TOL)


def test_distributions_match_reference():
    from alink_tpu.stats import prob as R
    from alink_tpu_torch.stats import prob as P

    x = np.linspace(0.05, 30.0, 97)
    np.testing.assert_allclose(P.gammaln(x), R.gammaln(x), rtol=0, atol=TOL)
    for kind, name, args in (
            ("CDF", "chi2", (x, 4)), ("CDF", "normal", (x - 15.0,)),
            ("CDF", "student_t", (x - 15.0, 5)), ("CDF", "f", (x, 3, 7)),
            ("CDF", "gamma", (x, 2.0, 1.5)),
            ("CDF", "beta", (x / 31.0, 2.0, 3.0)),
            ("PDF", "student_t", (x - 15.0, 5)), ("PDF", "gamma", (x, 2.0)),
            ("IDF", "student_t", (x / 31.0, 4)), ("IDF", "f", (x / 31.0, 3,
                                                             7))):
        np.testing.assert_allclose(getattr(getattr(P, kind), name)(*args),
                                   getattr(getattr(R, kind), name)(*args),
                                   rtol=0, atol=TOL, err_msg=kind + name)
    np.testing.assert_allclose(P.IDF.chi2(np.array([0.1, 0.5, 0.95]), 3),
                               R.IDF.chi2(np.array([0.1, 0.5, 0.95]), 3),
                               rtol=0, atol=TOL)
