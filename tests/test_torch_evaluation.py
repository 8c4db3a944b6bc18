"""The evaluation operators of the port (``operator/batch/evaluation.py``)
held against ``alink_tpu`` on the CPU, with inputs made by seeded numpy:
each op's metric row and its ``collect_metrics()`` within 1e-9 (float64
host code in both, so they come out equal), and the binary evaluator's
refusals."""

import json

import numpy as np
import pytest

TOL = 1e-9


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("ALINK_TORCH_DEVICE", "cpu")


def _cols(seed=0, n=300):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 2, n)
    p = np.clip(0.3 * y + rng.uniform(0, 0.7, n), 0, 1).round(3)  # ties
    labels = np.where(y == 1, "yes", "no").astype(object)
    detail = np.asarray([json.dumps({"yes": float(q), "no": float(1 - q)})
                         for q in p], object)
    multi_y = rng.integers(0, 4, n)
    multi_p = np.where(rng.random(n) < 0.7, multi_y, rng.integers(0, 4, n))
    reg_y = rng.normal(size=n)
    items = [f"i{j}" for j in range(8)]
    rel = [",".join(rng.choice(items, rng.integers(0, 4), replace=False))
           for _ in range(n)]
    ranked = [json.dumps(list(rng.permutation(items)[:6])) for _ in range(n)]
    X = rng.normal(size=(n, 3)) + multi_y[:, None]
    return {"label": labels, "detail": detail, "score": p,
            "my": multi_y.astype(str).astype(object),
            "mp": multi_p.astype(str).astype(object),
            "ry": reg_y, "rp": reg_y + rng.normal(scale=0.3, size=n),
            "rel": np.asarray(rel, object), "ranked": np.asarray(ranked,
                                                               object),
            "x0": X[:, 0], "x1": X[:, 1], "x2": X[:, 2],
            "cluster": multi_p.astype(np.int64)}


CASES = {
    "binary-detail": ("EvalBinaryClassBatchOp",
                      dict(labelCol="label", predictionDetailCol="detail")),
    "binary-detail-pos": ("EvalBinaryClassBatchOp",
                          dict(labelCol="label", predictionDetailCol="detail",
                               positiveLabelValueString="yes")),
    "binary-score": ("EvalBinaryClassBatchOp",
                     dict(labelCol="label", predictionScoreCol="score",
                          positiveLabelValueString="yes")),
    "multi": ("EvalMultiClassBatchOp",
              dict(labelCol="my", predictionCol="mp")),
    "regression": ("EvalRegressionBatchOp",
                   dict(labelCol="ry", predictionCol="rp")),
    "cluster": ("EvalClusterBatchOp",
                dict(predictionCol="cluster", featureCols=["x0", "x1", "x2"],
                     labelCol="my")),
    "multilabel": ("EvalMultiLabelBatchOp",
                   dict(labelCol="rel", predictionCol="ranked")),
    "ranking": ("EvalRankingBatchOp",
                dict(labelCol="rel", predictionCol="ranked", k=3)),
}


def _eval(pkg, case):
    import importlib

    ops = importlib.import_module(pkg + ".operator.batch")
    MTable = importlib.import_module(pkg + ".common.mtable").MTable
    name, params = CASES[case]
    op = getattr(ops, name)(**params).link_from(
        ops.TableSourceBatchOp(MTable(_cols())))
    return op.collect(), op.collect_metrics()


def _close(got, want, where):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), where
        for k in want:
            _close(got[k], want[k], f"{where}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _close(g, w, f"{where}[{i}]")
    elif isinstance(want, str):
        assert got == want, where
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL,
                                   err_msg=where)


@pytest.mark.parametrize("case", list(CASES))
def test_eval_op_matches_reference(case):
    got_t, got = _eval("alink_tpu_torch", case)
    want_t, want = _eval("alink_tpu", case)
    assert got_t.names == want_t.names
    assert got_t.schema.types == want_t.schema.types
    _close(got, want, case)
    _close(json.loads(got_t.col("Data")[0]), json.loads(want_t.col("Data")[0]),
           case)
    assert got.__class__.__name__ == "Metrics"
    first = next(iter(want))
    assert getattr(got, first) == got[first]


def test_binary_eval_refusals():
    from alink_tpu_torch.common.exceptions import AkIllegalDataException
    from alink_tpu_torch.common.mtable import MTable
    from alink_tpu_torch.operator.batch import (EvalBinaryClassBatchOp,
                                                TableSourceBatchOp)

    t = TableSourceBatchOp(MTable(_cols()))
    with pytest.raises(AkIllegalDataException, match="positiveLabel"):
        EvalBinaryClassBatchOp(labelCol="label", predictionScoreCol="score") \
            .link_from(t).collect()
    with pytest.raises(AkIllegalDataException, match="predictionDetailCol"):
        EvalBinaryClassBatchOp(labelCol="label").link_from(t).collect()
