"""Parity of the port's finance, table-utility and misc ops
(``operator/batch/finance.py``, ``utils2.py``, ``misc2.py``) with
``alink_tpu`` on the CPU: the cases of ``tests/test_finance.py``, the
group-scorecard, MTable-nesting and model-stream-sink cases of
``tests/test_longtail.py`` and the misc2 case of
``tests/test_reference_parity.py``, through both packages on the same
seeded tables.

Tolerances: the scorecard's binning and WOE are host copies, its logistic
regression runs the port's L-BFGS against the reference's (float32 both,
summed in their own orders): scores within SCORE_ATOL = 1e-2 points on a
600-point scale and weights within 1e-3. PSI, the utilities, the address
parser and the sparse indexer are host copies: equal. SOM's training runs
on the device: its grid coordinates equal."""

import json
import os

import numpy as np
import pytest

from torch_table_parity import both, reference_session, remove_session, \
    same_table

SCORE_ATOL = 1e-2


@pytest.fixture(scope="module")
def sid():
    s = reference_session()
    yield s
    remove_session(s)


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("ALINK_TORCH_DEVICE", "cpu")


def _credit(n=800, seed=0):
    rng = np.random.default_rng(seed)
    income = rng.uniform(0, 10, n)
    debt = rng.uniform(0, 10, n)
    logit = 1.5 - 0.6 * income + 0.5 * debt
    bad = (rng.random(n) < 1 / (1 + np.exp(-logit))).astype(int)
    return {"income": income, "debt": debt,
            "label": np.asarray([str(b) for b in bad], object)}


def _scorecard(ops, extra, src, **kw):
    return ops.ScorecardTrainBatchOp(
        selectedCols=["income", "debt"], labelCol="label",
        positiveLabelValueString="1", **kw, **extra).link_from(src)


def test_scorecard_scores_order_risk(sid):
    ref, port = both(sid, _credit(), lambda ops, extra, src: ops
                     .ScorecardPredictBatchOp(predictionDetailCol="detail",
                                              **extra)
                     .link_from(_scorecard(ops, extra, src, scaledValue=600,
                                           odds=20, pdo=50), src))
    same_table(port.select(["income", "debt", "label"]),
               ref.select(["income", "debt", "label"]))
    s, r = np.asarray(port.col("score")), np.asarray(ref.col("score"))
    np.testing.assert_allclose(s, r, atol=SCORE_ATOL)
    for a, b in zip(port.col("detail"), ref.col("detail")):
        da, db = json.loads(a), json.loads(b)
        assert da.keys() == db.keys() == {"income", "debt"}
        np.testing.assert_allclose(list(da.values()), list(db.values()),
                                   atol=SCORE_ATOL)
    labels = np.asarray(port.col("label"))
    assert s[labels == "0"].mean() > s[labels == "1"].mean() + 10


def test_scorecard_model_and_pdo(sid):
    from alink_tpu.common.model import table_to_model as r_t2m
    from alink_tpu_torch.common.model import table_to_model as p_t2m

    ref, port = both(sid, _credit(seed=1), lambda ops, extra, src:
                     _scorecard(ops, extra, src))
    (pm, pa), (rm, ra) = p_t2m(port), r_t2m(ref)
    assert pm == rm
    assert pm["factor"] == pytest.approx(50 / np.log(2))
    np.testing.assert_allclose(pa["weights"], ra["weights"], atol=1e-3)
    np.testing.assert_allclose(pa["intercept"], ra["intercept"], atol=1e-3)


def test_scorecard_regression_runs_in_float64(monkeypatch):
    """The scorecard's L-BFGS runs in float64 (a difference by design: in
    float32 the card and the CPU stopped 1.1 points apart on 522,911 rows);
    a float64 run stays within float32's noise of the float32 one."""
    from alink_tpu_torch import optim
    from alink_tpu_torch.common.mtable import MTable
    from alink_tpu_torch.operator.batch import (ScorecardTrainBatchOp,
                                                TableSourceBatchOp)

    seen = []
    real = optim.optimize

    def spy(*a, **kw):
        res = real(*a, **kw)
        seen.append((kw.get("float64"), res.weights.dtype))
        return res

    monkeypatch.setattr(optim, "optimize", spy)
    ScorecardTrainBatchOp(selectedCols=["income", "debt"], labelCol="label",
                          positiveLabelValueString="1").link_from(
        TableSourceBatchOp(MTable(_credit()))).collect()
    assert seen == [(True, np.float64)]
    rng = np.random.default_rng(0)
    X = rng.normal(size=(500, 3))
    y = np.where(X @ [1.0, -2.0, 0.5] + rng.logistic(size=500) > 0, 1.0,
                 -1.0)
    w32 = real(optim.logistic_obj(3), X, y, device="cpu").weights
    w64 = real(optim.logistic_obj(3), X, y, device="cpu",
               float64=True).weights
    np.testing.assert_allclose(w64, w32, atol=1e-4)


@pytest.mark.parametrize("op", ["PsiBatchOp", "PSIBatchOp"])
def test_psi_equals_the_reference(sid, op):
    rng = np.random.default_rng(2)
    base = {"x": rng.normal(0, 1, 1000), "z": rng.uniform(0, 1, 1000)}
    same = {"x": rng.normal(0, 1, 1000), "z": rng.uniform(0, 1, 1000)}
    shifted = {"x": rng.normal(1.5, 1, 1000), "z": rng.uniform(0.3, 1, 1000)}
    for test in (same, shifted):
        ref, port = both(sid, base, lambda ops, extra, b, t: getattr(ops, op)(
            selectedCols=["x", "z"], **extra).link_from(b, t), test)
        same_table(port, ref, rtol=0)
    assert port.col("psi")[0] > 0.25


def test_group_scorecard(sid):
    rng = np.random.default_rng(2)
    rows = []
    for g, w in (("A", 3.0), ("B", -3.0)):
        for _ in range(150):
            x = rng.standard_normal()
            rows.append((g, float(x),
                         1 if x * w + 0.3 * rng.standard_normal() > 0 else 0))
    cols = {"grp": np.asarray([r[0] for r in rows] + ["C"], object),
            "x": np.asarray([r[1] for r in rows] + [0.0]),
            "y": np.asarray([r[2] for r in rows] + [1], np.int64)}
    train = {k: v[:-1] for k, v in cols.items()}
    ref, port = both(sid, train, lambda ops, extra, src, t: ops
                     .GroupScorecardPredictBatchOp(groupCol="grp",
                                                   predictionCol="score",
                                                   **extra)
                     .link_from(ops.GroupScorecardTrainBatchOp(
                         groupCol="grp", labelCol="y", selectedCols=["x"],
                         numBuckets=8, **extra).link_from(src), t), cols)
    s, r = np.asarray(port.col("score")), np.asarray(ref.col("score"))
    np.testing.assert_allclose(s, r, atol=SCORE_ATOL)
    assert np.isnan(s[-1])          # an unseen group scores NaN
    x, grp = cols["x"], cols["grp"]
    a = s[(grp == "A") & (x > 1)].mean() - s[(grp == "A") & (x < -1)].mean()
    b = s[(grp == "B") & (x > 1)].mean() - s[(grp == "B") & (x < -1)].mean()
    assert a * b < 0


def test_mtable_nesting_and_sinks(sid, tmp_path):
    cols = {"g": np.asarray(["a", "a", "b"], object),
            "i": np.asarray([1, 2, 3], np.int64),
            "x": np.asarray([1.0, 2.0, 3.0])}
    ref, port = both(sid, cols, lambda ops, extra, src: ops
                     .GroupDataToMTableBatchOp(groupCols="g", outputCol="mt")
                     .link_from(src))
    assert port.names == ref.names and port.num_rows == 2
    for a, b in zip(port.col("mt"), ref.col("mt")):
        same_table(a, b)
    ref, port = both(sid, cols, lambda ops, extra, src: ops
                     .FlattenMTableBatchOp(selectedCol="mt",
                                           schemaStr="i long, x double")
                     .link_from(ops.GroupDataToMTableBatchOp(
                         groupCols=["g"], outputCol="mt").link_from(src)))
    same_table(port, ref)
    for op in ("AppendIdBatchOp", "DummySinkBatchOp"):
        ref, port = both(sid, cols, lambda ops, extra, src: getattr(ops, op)()
                         .link_from(src))
        same_table(port, ref)
    paths = []
    for pkg in ("ref", "port"):
        p = str(tmp_path / f"{pkg}.txt")
        paths.append(p)
    it = iter(paths)
    both(sid, {"g": cols["g"]}, lambda ops, extra, src: ops.TextSinkBatchOp(
        filePath=next(it)).link_from(src))
    texts = [open(p).read() for p in paths]
    assert texts[0] == texts[1] == "a\na\nb\n"


def test_append_model_stream_sink(sid, tmp_path):
    from alink_tpu_torch.common.model import model_to_table
    from alink_tpu_torch.io.ak import read_ak
    from alink_tpu_torch.operator.batch import (
        AppendModelStreamFileSinkBatchOp, TableSourceBatchOp)
    from alink_tpu_torch.operator.stream import FileModelStreamSink, \
        scan_model_dir

    model = model_to_table({"modelName": "M"}, {"w": np.ones(2, np.float32)})
    d = str(tmp_path / "ms")
    AppendModelStreamFileSinkBatchOp(filePath=d).link_from(
        TableSourceBatchOp(model)).collect()
    sink = FileModelStreamSink(d)
    sink.write(model, timestamp=5)
    sink.write(model, timestamp=10 ** 15)
    got = scan_model_dir(d)
    assert len(got) == 3 and got[0][0] == 5 and got[-1][0] == 10 ** 15
    assert scan_model_dir(d, after=5)[0][0] > 5
    assert read_ak(got[0][1]).num_rows == model.num_rows
    assert scan_model_dir(str(tmp_path / "none")) == []
    assert not any(n.endswith(".tmp") for n in os.listdir(d))


def test_misc2_ops(sid):
    addr = {"addr": np.asarray(["浙江省杭州市西湖区文一西路969号", "上海市浦东新区",
                                None, "无后缀"], object)}
    ref, port = both(sid, addr, lambda ops, extra, src: ops
                     .AddressParserBatchOp(selectedCol="addr")
                     .link_from(src))
    same_table(port, ref)
    assert port.col("province")[0] == "浙江省"
    sf = {"f": np.asarray(["age:30,city_sh:1", "age:25,city_bj:1", None,
                           "zz,age:"], object)}
    for kw in ({}, {"minFrequency": 2}):
        ref, port = both(sid, sf, lambda ops, extra, src: ops
                         .SparseFeatureIndexerPredictBatchOp(outputCol="v")
                         .link_from(ops.SparseFeatureIndexerTrainBatchOp(
                             selectedCol="f", **kw).link_from(src), src))
        same_table(port, ref)
    rng = np.random.default_rng(0)
    X = rng.normal(size=(40, 3))
    ref, port = both(sid, {f"f{i}": X[:, i] for i in range(3)},
                     lambda ops, extra, src: ops.SomBatchOp(
                         xdim=2, ydim=2, featureCols=["f0", "f1", "f2"],
                         numIters=10, **extra).link_from(src))
    same_table(port, ref)


def test_base_classes_bind_the_engine():
    from alink_tpu_torch.operator import batch as B

    assert B.BaseSourceBatchOp._max_inputs == 0
    assert B.BaseSinkBatchOp._plan_passthrough
    assert issubclass(B.BaseRecommBatchOp, B.ModelMapBatchOp)
    assert issubclass(B.BaseNearestNeighborTrainBatchOp, B.ModelTrainOpMixin)
