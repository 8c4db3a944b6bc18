"""Parity of the port's AutoDiscovery (``alink_tpu_torch.operator.batch.
insights``) with the reference's on the CPU: the 15 cases of
``tests/test_insights.py``, each run through both packages on the same
seeded columns. The findings must be the same rows in the same order: type,
columns, description and detail equal, scores within 1e-9. The time budget
contract is held on the port's own counter."""

import json

import numpy as np
import pytest

pytestmark = pytest.mark.usefixtures("cpu_device")

SCORE_ATOL = 1e-9


@pytest.fixture
def cpu_device(monkeypatch):
    monkeypatch.setenv("ALINK_TORCH_DEVICE", "cpu")


def _both(cols, **kw):
    import alink_tpu.operator.batch as R
    import alink_tpu_torch.operator.batch as P
    from alink_tpu.common.mtable import MTable as RT
    from alink_tpu_torch.common.mtable import MTable as PT

    return [ops.AutoDiscoveryBatchOp(**kw).link_from(
        ops.TableSourceBatchOp(T(dict(cols)))).collect()
        for ops, T in ((R, RT), (P, PT))]


def _same_findings(port, ref):
    assert port.names == ref.names
    for c in ("type", "columns", "description"):
        assert list(port.col(c)) == list(ref.col(c)), c
    for a, b in zip(port.col("detail"), ref.col("detail")):
        da, db = json.loads(a), json.loads(b)
        assert da.keys() == db.keys()
        for k in db:
            if isinstance(db[k], float):
                assert abs(da[k] - db[k]) <= SCORE_ATOL * max(1, abs(db[k]))
            else:
                assert da[k] == db[k], k
    np.testing.assert_allclose(np.asarray(port.col("score"), float),
                               np.asarray(ref.col("score"), float),
                               rtol=0, atol=SCORE_ATOL)


def _discover(cols, **kw):
    ref, port = _both(cols, **kw)
    _same_findings(port, ref)
    return port


def _kinds(out):
    return list(out.col("type"))


def _descs(out, kind):
    return [d for ty, d in zip(out.col("type"), out.col("description"))
            if ty == kind]


def test_outstanding_no1():
    rng = np.random.default_rng(0)
    seg = np.asarray([f"s{i}" for i in range(10) for _ in range(20)], object)
    sales = rng.uniform(1, 2, 200)
    sales[seg == "s3"] += 40.0
    out = _discover({"seg": seg, "sales": sales}, topN=50)
    assert any("s3" in d for d in _descs(out, "outstanding_no1"))


def test_outstanding_last_negative_extreme():
    rng = np.random.default_rng(7)
    seg = np.asarray([f"s{i}" for i in range(8) for _ in range(25)], object)
    profit = 1.0 + 0.2 * rng.standard_normal(200)
    profit[seg == "s5"] = -30.0
    out = _discover({"seg": seg, "profit": profit}, topN=50)
    assert any("s5" in d for d in _descs(out, "outstanding_last"))


def test_evenness():
    seg = np.asarray(["a", "b", "c", "d"] * 50, object)
    out = _discover({"seg": seg, "v": np.ones(200)}, topN=50)
    assert "evenness" in _kinds(out)


def test_attribution_majority_share():
    seg = np.asarray(["big"] * 150 + ["s1"] * 25 + ["s2"] * 25, object)
    rev = np.where(seg == "big", 10.0, 1.0)
    out = _discover({"seg": seg, "rev": rev}, topN=50)
    assert any("big" in d for d in _descs(out, "attribution"))


def test_change_point_and_trend():
    seg = np.asarray([f"t{i:02d}" for i in range(20) for _ in range(10)],
                     object)
    step = np.where([int(s[1:]) >= 12 for s in seg], 50.0, 1.0)
    rng = np.random.default_rng(1)
    stepv = step + 0.1 * rng.standard_normal(200)
    ramp = np.asarray([float(s[1:]) for s in seg]) \
        + 0.05 * rng.standard_normal(200)
    out = _discover({"t": seg, "step_m": stepv, "ramp_m": ramp}, topN=60)
    assert {"change_point", "trend"} <= set(_kinds(out))
    assert any("t12" in d or "t11" in d
               for d in _descs(out, "change_point") if "step_m" in d)


def test_trend_with_unpadded_numeric_labels():
    rng = np.random.default_rng(8)
    seg = np.asarray([str(m) for m in range(1, 13) for _ in range(15)],
                     object)
    v = np.asarray([float(s) * 5 for s in seg]) \
        + 0.1 * rng.standard_normal(180)
    out = _discover({"month": seg, "v": v}, topN=60)
    assert "rises" in _descs(out, "trend")[0]


def test_seasonality():
    seg = np.asarray([f"t{i:02d}" for i in range(24) for _ in range(5)],
                     object)
    wave = np.asarray([np.sin(2 * np.pi * int(s[1:]) / 4.0) * 10
                       for s in seg])
    out = _discover({"t": seg, "wave": wave}, topN=60)
    assert any(json.loads(det)["period"] == 4 for ty, det in zip(
        out.col("type"), out.col("detail")) if ty == "seasonality")


def test_series_outlier():
    seg = np.asarray([f"s{i:02d}" for i in range(15) for _ in range(10)],
                     object)
    v = np.ones(150)
    v[seg == "s07"] = 90.0
    out = _discover({"seg": seg, "v": v}, topN=60)
    assert {"series_outlier", "outstanding_no1"} & set(_kinds(out))


def test_distribution_skew():
    rng = np.random.default_rng(2)
    out = _discover({"x": np.exp(rng.standard_normal(500) * 1.5)}, topN=50)
    assert "right-skewed" in _descs(out, "distribution")[0]


def test_clustering_2d():
    rng = np.random.default_rng(3)
    a = np.concatenate([rng.normal(-5, 0.3, 100), rng.normal(5, 0.3, 100)])
    b = np.concatenate([rng.normal(-5, 0.3, 100), rng.normal(5, 0.3, 100)])
    out = _discover({"a": a, "b": b}, topN=50)
    assert "clustering_2d" in _kinds(out)


def test_correlation_with_missing_rows():
    """Pearson over the rows without a NaN (the reference's filter): a
    NaN-laden column pair still correlates, and the rows the filter drops
    change r."""
    rng = np.random.default_rng(9)
    a = rng.normal(size=300)
    b = a * 2 + 0.1 * rng.normal(size=300)
    c = rng.normal(size=300)
    b[::7] = np.nan
    c[::11] = np.nan
    out = _discover({"a": a, "b": b, "c": c}, topN=50)
    assert any("a and b" in d for d in _descs(out, "correlation"))


def test_subspace_mining_scaled_by_impact():
    rng = np.random.default_rng(4)
    region = np.asarray(["x"] * 200 + ["y"] * 200, object)
    seg = np.asarray((["c"] * 50 + ["d"] * 150) * 2, object)
    m = rng.standard_normal(400)
    m[(region == "x") & (seg == "c")] += 8.0
    out = _discover({"region": region, "seg": seg, "m": m}, topN=60)
    assert "[region='x']" in " | ".join(out.col("description"))


def test_ranking_decay_diversifies():
    rng = np.random.default_rng(5)
    seg = np.asarray([f"s{i}" for i in range(10) for _ in range(20)], object)
    hot = rng.uniform(1, 2, 200)
    hot[seg == "s0"] += 100.0
    other = np.exp(rng.standard_normal(200) * 2)
    out = _discover({"seg": seg, "hot": hot, "other": other}, topN=10)
    assert len(set(_kinds(out))) >= 3
    assert (np.diff(np.asarray(out.col("score"))) <= 1e-12).all()


def test_detail_column_is_json():
    seg = np.asarray(["a"] * 100 + ["b"] * 100, object)
    out = _discover({"seg": seg, "v": np.where(seg == "a", 10.0, 1.0)},
                    topN=50)
    for det in out.col("detail"):
        json.loads(det)


def test_time_limit_respected():
    import time

    import alink_tpu_torch.operator.batch as P
    from alink_tpu_torch.common.mtable import MTable

    rng = np.random.default_rng(6)
    cols = {f"c{i}": rng.standard_normal(200) for i in range(6)}
    cols["seg"] = np.asarray(["a", "b"] * 100, object)
    t0 = time.monotonic()
    out = P.AutoDiscoveryBatchOp(timeLimitSeconds=0.001, topN=5).link_from(
        P.TableSourceBatchOp(MTable(cols))).collect()
    assert time.monotonic() - t0 < 10.0
    assert out.names == ["type", "columns", "score", "description", "detail"]


def test_time_budget_best_effort_contract():
    """A spent budget returns a valid (here empty, as the reference's)
    findings table and moves the port's counter once; a generous one finds
    the reference's findings and leaves the counter alone."""
    from alink_tpu_torch.common.metrics import metrics

    rng = np.random.default_rng(7)
    cols = {f"c{i}": rng.standard_normal(500) for i in range(12)}
    cols["seg"] = np.asarray([f"s{i % 8}" for i in range(500)], object)
    c0 = metrics.counter("insights.time_budget_exhausted")
    out = _discover(cols, timeLimitSeconds=0.0, topN=20)
    assert out.names == ["type", "columns", "score", "description", "detail"]
    assert metrics.counter("insights.time_budget_exhausted") == c0 + 1
    c1 = metrics.counter("insights.time_budget_exhausted")
    full = _discover(cols, timeLimitSeconds=60.0, topN=20)
    assert full.num_rows > out.num_rows
    assert metrics.counter("insights.time_budget_exhausted") == c1
