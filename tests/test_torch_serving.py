"""The port's online serving tier (``alink_tpu_torch.serving``): the
reference's contracts (``tests/test_serving.py``) re-run on the port, and
the port's servers held against ``alink_tpu``'s on the same saved models.

Port contracts, on a LogisticRegression pipeline fitted by the port (its
scorer pads each block up the bucket ladder, so a row scores the same in
any batch, and served rows equal serial predicts exactly):

- concurrent results equal serial ``LocalPredictor`` predicts;
- after warmup, sustained mixed-size load meets no new shape signature
  (``jit.trace``); warmup is synthesized from the schema when no rows come;
- both shed policies, deadlines, the priority lane, breaker degradation,
  and bad rows that do not trip it;
- hot-swap with a fresh breaker, under traffic, and unload;
- the ``serving.*`` spans and histograms, and the Prometheus series;
- the warmup sidecar: round trip, corrupt, stale, knob off;
- the HTTP surface: load with only a path, predicts, stats, delete, and
  429 for a shed.

The BERT route (a BertClassificationModel pipeline from
data/bert_tiny_sst, attentionBlockSize 16, so the flash kernel's route is
on the path): no new signature after warmup, and every served row within
CROSS_RUNG_ATOL = 1e-5 of its serial predict's probabilities, labels
equal. Not bit-exact on this CPU: MKL's fp32 GEMM at the head's 2 output
columns rounds a row by its position in the batch (odd rows otherwise
than even ones, at one batch shape), so a row served beside others can
differ from its serial predict in the last bit even at the serial
predict's rung. The card's rows at one rung are held bit-exact by
chip_smoke.py phase 14. A precision load quantizes the model once.

Against the JAX package, on the CPU:

- a pipeline fitted by ``alink_tpu`` (LinearRegression then
  LogisticRegression) loaded from one ``.ak`` into both packages'
  ``ModelServer``s with the same warmup rows and requests: labels equal,
  numeric outputs within NUMERIC_ATOL = 1e-5 (float32 products summed in
  another order), detail probabilities within 1e-6; its int8 load passes
  the default band and fails band 0 / tol 0 in both;
- a sidecar written by either package loads in the other;
- the tiny BERT served by both servers within tests/test_torch_bert_serving
  .py's PROB_ATOL = 0.02, labels equal where the reference's margin
  exceeds it; bf16 loads pass the band gate in both. int8: the BERT
  mapper's int8 is weight-only and records no activation range in either
  package; the port's mapper declares so (``INT8_WEIGHT_ONLY``) and its
  server gates the load on the band alone, which it passes, serving
  weight-only int8; the reference's server requires a range and falls
  back to fp32 (``serving.calib_degenerate``), a difference by design
  (ROADMAP).
"""

import csv
import dataclasses
import json
import os
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

SCHEMA = "f0 double, f1 double, f2 double, f3 double"
FEATS = ["f0", "f1", "f2", "f3"]
NUMERIC_ATOL = 1e-5
PROB_ATOL = 0.02
CROSS_RUNG_ATOL = 1e-5
JOIN_S = 60


@pytest.fixture(scope="module", autouse=True)
def _cpu():
    """For the whole module, its module-scoped fixtures included."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("ALINK_TORCH_DEVICE", "cpu")
        mp.delenv("ALINK_ATTN_PALLAS", raising=False)
        mp.delenv("ALINK_SHAPE_BUCKETS", raising=False)
        yield


def _data(seed=0, n_per=60):
    rng = np.random.default_rng(seed)
    X = np.concatenate([rng.normal(c, 0.8, size=(n_per, 4))
                        for c in (0.0, 1.5)])
    y = np.repeat([0, 1], n_per)
    yr = X @ np.array([0.5, -1.0, 2.0, 0.25]) + 1.0
    return X, {**{f"f{i}": X[:, i] for i in range(4)}, "label": y, "y": yr}


def _fit_lr(seed=0):
    from alink_tpu_torch.common.mtable import MTable
    from alink_tpu_torch.operator.batch import TableSourceBatchOp
    from alink_tpu_torch.pipeline import LogisticRegression, Pipeline

    X, cols = _data(seed)
    model = Pipeline(LogisticRegression(
        featureCols=FEATS, labelCol="label", predictionCol="pred",
        predictionDetailCol="detail")).fit(TableSourceBatchOp(MTable(cols)))
    return X, model


@pytest.fixture(scope="module")
def fitted():
    return _fit_lr()


@pytest.fixture(scope="module")
def serial_rows(fitted):
    """Ground truth: serial, uncached-plan, single-row predicts."""
    from alink_tpu_torch.pipeline import LocalPredictor

    X, model = fitted
    lp = LocalPredictor(model, SCHEMA, cache_plan=False)
    return [lp.predict_row(tuple(r)) for r in X]


def _server(**kw):
    from alink_tpu_torch.serving import ModelServer, ServingConfig

    return ModelServer(ServingConfig(**kw))


def _counter(name):
    from alink_tpu_torch.common.metrics import metrics

    return metrics.counter(name)


def _run_threads(fns):
    ths = [threading.Thread(target=f) for f in fns]
    for th in ths:
        th.start()
    for th in ths:
        th.join(timeout=JOIN_S)
        assert not th.is_alive(), "client thread hung"


# ---------------------------------------------------------------------------
# router: parity, batching, no new shapes
# ---------------------------------------------------------------------------


def test_concurrent_results_equal_serial(fitted, serial_rows):
    X, model = fitted
    srv = _server(max_batch_rows=16, flush_deadline_s=0.002)
    try:
        srv.load("parity", model, SCHEMA, warmup_rows=[tuple(X[0])])
        results = {}

        def client(cid):
            return lambda: results.__setitem__(cid, srv.predict_many(
                "parity", [tuple(r) for r in X[cid::4]], timeout=JOIN_S))

        _run_threads([client(i) for i in range(4)])
        for cid in range(4):
            assert results[cid] == serial_rows[cid::4]
        st = srv.stats()["models"][0]
        assert st["completed"] == len(X)
        assert st["batches"] < st["completed"]
    finally:
        srv.close()


def test_no_new_signatures_after_warmup(fitted, serial_rows):
    X, model = fitted
    srv = _server(max_batch_rows=16, flush_deadline_s=0.001)
    try:
        srv.load("steady", model, SCHEMA, warmup_rows=[tuple(X[0])])
        t0 = _counter("jit.trace")
        results = {}

        def client(cid):
            def run():
                results[cid] = [srv.predict_many(
                    "steady", [tuple(r) for r in X[cid::5]], timeout=JOIN_S)
                    for _ in range(3)]
            return run

        _run_threads([client(i) for i in range(5)])
        assert _counter("jit.trace") == t0
        for cid in range(5):
            for out in results[cid]:
                assert out == serial_rows[cid::5]
    finally:
        srv.close()


def test_default_warmup_synthesized_from_schema(fitted):
    X, model = fitted
    srv = _server(max_batch_rows=16, flush_deadline_s=0.001)
    try:
        info = srv.load("dwarm", model, SCHEMA)
        assert info["warmup_source"] == "synthesized"
        assert info["warmup"]["rungs"] == 2
        t0 = _counter("jit.trace")
        srv.predict_many("dwarm", [tuple(r) for r in X[:30]], timeout=JOIN_S)
        assert _counter("jit.trace") == t0
    finally:
        srv.close()


def test_bucket_ladder_covers_every_batch_size():
    from alink_tpu_torch.common.jitcache import bucket_rows
    from alink_tpu_torch.serving import serving_bucket_ladder

    ladder = serving_bucket_ladder(64)
    assert ladder == [8, 16, 24, 32, 40, 48, 56, 64]
    assert all(bucket_rows(n) in ladder for n in range(1, 65))


# ---------------------------------------------------------------------------
# admission control
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("policy", ["reject", "oldest"])
def test_saturation_sheds(fitted, serial_rows, policy):
    """A flood past the queue's high-water mark sheds (counted), and every
    request that is not shed completes equal to its serial row."""
    from alink_tpu_torch.common.exceptions import AkServingOverloadException

    X, model = fitted
    srv = _server(queue_depth=8, max_batch_rows=8, flush_deadline_s=0.05,
                  shed_policy=policy)
    try:
        srv.load("sat", model, SCHEMA, warmup_rows=[tuple(X[0])])
        shed0 = _counter("serving.shed")
        futs, rejected = [], 0
        for i in range(300):
            try:
                futs.append((i % len(X),
                             srv.submit("sat", tuple(X[i % len(X)]))))
            except AkServingOverloadException:
                rejected += 1
        dropped = 0
        for idx, fut in futs:
            try:
                assert fut.result(timeout=JOIN_S) == serial_rows[idx]
            except AkServingOverloadException:
                dropped += 1
        st = srv.stats()["models"][0]
        if policy == "reject":
            assert rejected > 0 and dropped == 0
        else:
            assert rejected == 0 and dropped > 0
        assert st["shed"] == rejected + dropped
        assert _counter("serving.shed") == shed0 + rejected + dropped
        assert st["completed"] == len(futs) - dropped
        assert st["queued"] == 0
    finally:
        srv.close()


def test_deadline_expired_in_queue(fitted):
    from alink_tpu_torch.common.exceptions import AkDeadlineExceededException

    X, model = fitted
    srv = _server(max_batch_rows=4, flush_deadline_s=0.2)
    try:
        srv.load("ddl", model, SCHEMA, warmup_rows=[tuple(X[0])])
        fut = srv.submit("ddl", tuple(X[0]), deadline_s=0.0)
        with pytest.raises(AkDeadlineExceededException):
            fut.result(timeout=JOIN_S)
        assert srv.stats()["models"][0]["deadline_expired"] == 1
    finally:
        srv.close()


def test_priority_lane_pops_first(fitted):
    from alink_tpu_torch.serving.router import PredictFuture, _Request

    X, model = fitted
    srv = _server(max_batch_rows=4, flush_deadline_s=10.0)
    try:
        srv.load("prio", model, SCHEMA)
        entry = srv._entry("prio")
        with entry._cond:
            reqs = [_Request(tuple(X[i]), PredictFuture(None, i % 2 == 0))
                    for i in range(6)]
            for r in reqs:
                (entry._high if r.future.priority else
                 entry._normal).append(r)
            batch = entry._pop_batch_locked()
            assert [r.future.priority for r in batch] == \
                [True] * 3 + [False] * 3
    finally:
        srv.close()


# ---------------------------------------------------------------------------
# breaker, hot-swap, unload
# ---------------------------------------------------------------------------


def _boom_predictor(model):
    from alink_tpu_torch.pipeline import LocalPredictor

    class Boom(LocalPredictor):
        def predict_table(self, t):
            raise RuntimeError("boom")

    return Boom(model, SCHEMA)


def test_breaker_degrades_failing_model_to_fast_rejects(fitted):
    from alink_tpu_torch.common.exceptions import AkCircuitOpenException

    X, model = fitted
    srv = _server(max_batch_rows=4, flush_deadline_s=0.001,
                  breaker_threshold=2, breaker_reset_s=3600.0)
    try:
        srv.load("brk", _boom_predictor(model))
        for _ in range(2):
            with pytest.raises(RuntimeError, match="boom"):
                srv.predict("brk", tuple(X[0]), timeout=30)
        st = srv.stats()["models"][0]
        assert st["breaker_open"] and st["errors"] == 2
        with pytest.raises(AkCircuitOpenException):
            srv.predict("brk", tuple(X[0]), timeout=30)
        assert srv.stats()["models"][0]["breaker_rejected"] >= 1
    finally:
        srv.close()


def test_bad_rows_do_not_trip_the_breaker(fitted, serial_rows):
    from alink_tpu_torch.common.exceptions import AkCircuitOpenException

    X, model = fitted
    srv = _server(max_batch_rows=8, flush_deadline_s=0.05,
                  breaker_threshold=2, breaker_reset_s=3600.0)
    try:
        srv.load("badrows", model, SCHEMA, warmup_rows=[tuple(X[0])])
        for _ in range(3):
            bad = srv.submit("badrows", ("boom", "x", "y", "z"))
            good = srv.submit("badrows", tuple(X[5]))
            with pytest.raises(Exception) as ei:
                bad.result(timeout=30)
            assert not isinstance(ei.value, AkCircuitOpenException)
            assert good.result(timeout=30) == serial_rows[5]
        st = srv.stats()["models"][0]
        assert not st["breaker_open"] and st["bad_rows"] == 3
    finally:
        srv.close()


def test_hot_swap_gets_a_fresh_breaker(fitted, serial_rows):
    X, model = fitted
    srv = _server(max_batch_rows=4, flush_deadline_s=0.001,
                  breaker_threshold=2, breaker_reset_s=3600.0)
    try:
        srv.load("swapbrk", _boom_predictor(model))
        for _ in range(2):
            with pytest.raises(RuntimeError):
                srv.predict("swapbrk", tuple(X[0]), timeout=30)
        assert srv.stats()["models"][0]["breaker_open"]
        srv.load("swapbrk", model, SCHEMA, warmup_rows=[tuple(X[0])])
        assert srv.predict("swapbrk", tuple(X[2]), timeout=30) == \
            serial_rows[2]
        assert not srv.stats()["models"][0]["breaker_open"]
    finally:
        srv.close()


def test_hot_swap_under_traffic_drops_nothing(fitted, serial_rows):
    """Requests racing 3 swaps (the last to a model fitted on other data)
    all complete; rows after the last swap are the new model's."""
    from alink_tpu_torch.pipeline import LocalPredictor

    X, model = fitted
    _, model2 = _fit_lr(seed=4)
    new_rows = [LocalPredictor(model2, SCHEMA, cache_plan=False)
                .predict_row(tuple(r)) for r in X[:8]]
    assert new_rows != serial_rows[:8]
    srv = _server(max_batch_rows=8, flush_deadline_s=0.001)
    try:
        srv.load("swaprace", model, SCHEMA, warmup_rows=[tuple(X[0])])
        stop = threading.Event()
        errors, served = [], []

        def hammer():
            i = 0
            while not stop.is_set():
                try:
                    served.append(srv.predict("swaprace", tuple(X[i % 8]),
                                              timeout=JOIN_S))
                except Exception as e:  # noqa: BLE001 — asserted below
                    errors.append(e)
                i += 1

        ths = [threading.Thread(target=hammer) for _ in range(2)]
        for th in ths:
            th.start()
        for _ in range(2):
            srv.load("swaprace", model, SCHEMA, warmup_rows=[tuple(X[0])])
        srv.load("swaprace", model2, SCHEMA, warmup_rows=[tuple(X[0])])
        stop.set()
        for th in ths:
            th.join(timeout=JOIN_S)
        assert not errors, errors[:3]
        assert served
        assert [srv.predict("swaprace", tuple(r)) for r in X[:8]] == new_rows
    finally:
        srv.close()


def test_hot_swap_and_unload(fitted, serial_rows):
    X, model = fitted
    srv = _server(max_batch_rows=8, flush_deadline_s=0.002)
    try:
        srv.load("swap", model, SCHEMA, warmup_rows=[tuple(X[0])])
        assert srv.predict("swap", tuple(X[1]), timeout=30) == serial_rows[1]
        srv.load("swap", model, SCHEMA, warmup_rows=[tuple(X[0])])
        assert srv.predict("swap", tuple(X[1]), timeout=30) == serial_rows[1]
        assert srv.models() == ["swap"]
        assert srv.unload("swap")
        assert not srv.unload("swap")
        with pytest.raises(Exception):
            srv.predict("swap", tuple(X[1]), timeout=5)
    finally:
        srv.close()


def test_unload_fails_fast_without_drain(fitted):
    from alink_tpu_torch.common.exceptions import AkIllegalStateException

    X, model = fitted
    srv = _server(max_batch_rows=4, flush_deadline_s=10.0)
    try:
        srv.load("nodrain", model, SCHEMA)
        futs = [srv.submit("nodrain", tuple(X[i])) for i in range(3)]
        srv.unload("nodrain", drain=False)
        for f in futs:
            with pytest.raises(AkIllegalStateException):
                f.result(timeout=30)
    finally:
        srv.close()


def test_serving_spans_and_histograms(fitted, monkeypatch):
    from alink_tpu_torch.common.metrics import export_prometheus
    from alink_tpu_torch.common.tracing import tracer
    from alink_tpu_torch.serving import serving_summary

    monkeypatch.setenv("ALINK_TRACING", "on")
    X, model = fitted
    srv = _server(max_batch_rows=8, flush_deadline_s=0.002)
    try:
        srv.load("obs", model, SCHEMA, warmup_rows=[tuple(X[0])])
        srv.predict_many("obs", [tuple(r) for r in X[:10]], timeout=JOIN_S)
        srv.predict("obs", tuple(X[0]), timeout=JOIN_S)
        st = serving_summary(srv)
        for h in ("serving.request_s", "serving.queue_s",
                  "serving.batch_rows"):
            assert st["histograms"][h]["count"] >= 2
            assert st["histograms"][h]["p99"] is not None
        assert "jit.trace" in st["jit"]
        names = {s["name"] for s in tracer.spans()}
        assert {"serving.batch", "serving.warmup",
                "serving.request"} <= names
        # the batch span parents under the synchronous request's trace
        req = [s for s in tracer.spans() if s["name"] == "serving.request"]
        batch = [s for s in tracer.spans(req[-1]["trace_id"])
                 if s["name"] == "serving.batch"]
        assert batch and batch[0]["parent_id"] == req[-1]["span_id"]
        text = export_prometheus()
        for series in ("alink_serving_request_seconds",
                       "alink_serving_batch_rows", "alink_serving_accepted_total",
                       "alink_serving_completed_total"):
            assert series in text
    finally:
        srv.close()


# ---------------------------------------------------------------------------
# the warmup sidecar
# ---------------------------------------------------------------------------


def test_warmup_sidecar_round_trip(fitted, serial_rows, tmp_path):
    from alink_tpu_torch.serving import (load_warmup_spec,
                                         serving_bucket_ladder,
                                         warmup_sidecar_path)

    from alink_tpu_torch.common.jitcache import clear_signatures

    X, model = fitted
    ak = str(tmp_path / "m.ak")
    model.save(ak)
    srv = _server(max_batch_rows=16)
    clear_signatures()      # the sidecar keeps the signatures this load adds
    try:
        info1 = srv.load("live", ak, SCHEMA, warmup_rows=[tuple(X[0])])
        assert info1["warmup_source"] == "caller"
        assert info1["warmup_sidecar"] == warmup_sidecar_path(ak)
        spec = load_warmup_spec(ak)
        assert spec["input_schema"].lower() == SCHEMA
        assert spec["warmup_rows"] == [tuple(map(float, X[0]))]
        assert spec["ladder"] == serving_bucket_ladder(16)
        assert sorted((k, s[0][0][0]) for k, s in spec["kernels"]) == \
            [("linear.score", 8), ("linear.score", 16)]
        info2 = srv.load("replica", ak)
        assert info2["warmup_source"] == "sidecar"
        assert info2["warmup_sidecar"] is None
        t0 = _counter("jit.trace")
        got = [srv.predict("replica", tuple(r)) for r in X[:24]]
        assert _counter("jit.trace") == t0
        assert got == serial_rows[:24]
    finally:
        srv.close()


@pytest.mark.parametrize("case", ["corrupt", "stale", "knob_off",
                                  "no_schema"])
def test_warmup_sidecar_failures(fitted, serial_rows, tmp_path, monkeypatch,
                                 case):
    """A corrupt or stale sidecar reads as absent (counted) and the load
    warms from the schema; the knob off writes none; a path with neither a
    schema nor a sidecar refuses to load."""
    from alink_tpu_torch.common.exceptions import AkIllegalArgumentException
    from alink_tpu_torch.serving import load_warmup_spec, warmup_sidecar_path

    X, model = fitted
    ak = str(tmp_path / "m.ak")
    model.save(ak)
    srv = _server(max_batch_rows=16)
    try:
        if case == "corrupt":
            with open(warmup_sidecar_path(ak), "w") as f:
                f.write('{"version": 1, "warmup_rows": [[')
            e0 = _counter("serving.warmup_spec_errors")
            info = srv.load("m", ak, SCHEMA)
            assert _counter("serving.warmup_spec_errors") == e0 + 1
            assert info["warmup_source"] == "synthesized"
            assert [srv.predict("m", tuple(r)) for r in X[:8]] == \
                serial_rows[:8]
        elif case == "stale":
            srv.load("v1", ak, SCHEMA, warmup_rows=[tuple(X[0])])
            assert load_warmup_spec(ak) is not None
            _fit_lr(seed=9)[1].save(ak)
            s0 = _counter("serving.warmup_spec_stale")
            assert load_warmup_spec(ak) is None
            assert _counter("serving.warmup_spec_stale") == s0 + 1
            assert srv.load("v2", ak, SCHEMA)["warmup_source"] == \
                "synthesized"
        elif case == "knob_off":
            monkeypatch.setenv("ALINK_SERVING_PERSIST_WARMUP", "0")
            info = srv.load("m", ak, SCHEMA, warmup_rows=[tuple(X[0])])
            assert info["warmup_sidecar"] is None
            assert not os.path.exists(warmup_sidecar_path(ak))
        else:
            with pytest.raises(AkIllegalArgumentException):
                srv.load("m", ak)
    finally:
        srv.close()


@pytest.mark.parametrize("mode", ["warn", "error"])
def test_alk111_preflight_matches_reference(fitted, jax_pipeline, monkeypatch,
                                            mode):
    """An int8 load with no real calibration sample (synthesized rows) is
    ALK111 in both packages: a warning counted in the report, or under
    ``error`` with ``recovery=True`` a refused load."""
    import importlib

    X, path = jax_pipeline
    monkeypatch.setenv("ALINK_VALIDATE_PLAN", mode)
    found = {}
    for pkg in ("alink_tpu", "alink_tpu_torch"):
        serving = importlib.import_module(pkg + ".serving")
        exc = importlib.import_module(pkg + ".common.exceptions")
        counters = importlib.import_module(pkg + ".common.metrics").metrics
        n0 = counters.counter("analysis.rule.ALK111")
        srv = serving.ModelServer(serving.ServingConfig(max_batch_rows=8))
        try:
            if mode == "error":
                with pytest.raises(exc.AkPlanValidationException) as ei:
                    srv.load("q", path, SCHEMA, precision="int8",
                             recovery=True, persist_warmup=False)
                found[pkg] = [d.rule for d in ei.value.report.errors()]
            else:
                info = srv.load("q", path, SCHEMA, precision="int8",
                                persist_warmup=False)
                assert info["precision"]["policy"] == "fp32"
                found[pkg] = counters.counter("analysis.rule.ALK111") - n0
        finally:
            srv.close()
    assert found["alink_tpu_torch"] == found["alink_tpu"]
    assert found["alink_tpu"] == (["ALK111"] if mode == "error" else 1)
    from alink_tpu_torch.analysis import last_plan_report

    rep = last_plan_report()
    assert rep["mode"] == mode and rep["by_rule"] == {"ALK111": 1}
    assert rep["diagnostics"][0]["severity"] == (
        "error" if mode == "error" else "warning")


# ---------------------------------------------------------------------------
# HTTP surface
# ---------------------------------------------------------------------------


def _req(port, path, method="GET", body=None, text=False):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", method=method,
        data=None if body is None else json.dumps(body).encode())
    with urllib.request.urlopen(req, timeout=JOIN_S) as r:
        raw = r.read().decode()
    return raw if text else json.loads(raw)


def test_http_serving_round_trip(fitted, serial_rows, tmp_path):
    from alink_tpu_torch.webui import ExperimentStore, WebUIServer

    X, model = fitted
    ak = str(tmp_path / "lr.ak")
    model.save(ak)
    srv = _server(max_batch_rows=8, flush_deadline_s=0.002)
    srv.load("seed", ak, SCHEMA, warmup_rows=[tuple(X[0])])   # the sidecar
    srv.unload("seed")
    web = WebUIServer(port=0, store=ExperimentStore(
        str(tmp_path / "exp.json")), model_server=srv)
    web.start(background=True)
    try:
        out = _req(web.port, "/api/serving/models", "POST",
                   {"name": "lr", "path": ak})
        assert out["model"] == "lr" and out["warmup_source"] == "sidecar"
        got = _req(web.port, "/api/serving/predict/lr", "POST",
                   {"row": list(map(float, X[3]))})
        assert got["row"][4] == serial_rows[3][4]
        assert json.loads(got["row"][5]) == json.loads(serial_rows[3][5])
        many = _req(web.port, "/api/serving/predict/lr", "POST",
                    {"rows": [list(map(float, X[i])) for i in range(6)]})
        assert [r[4] for r in many["rows"]] == \
            [serial_rows[i][4] for i in range(6)]
        st = _req(web.port, "/api/serving")
        assert st["models"][0]["model"] == "lr"
        assert st["models"][0]["completed"] >= 7
        text = _req(web.port, "/metrics", text=True)
        for series in ("serving_request_s", "serving_batch_rows",
                       "serving_completed"):
            assert f"alink_{series}" in text
        assert "BatchOp" in json.dumps(_req(web.port, "/api/ops"))
        assert "traces" in _req(web.port, "/api/traces")
        exp = _req(web.port, "/api/experiments", "POST", {
            "name": "mem", "nodes": [{"id": "a", "op": "MemSourceBatchOp",
                                      "params": {"rows": [[1.0], [2.0]],
                                                 "schemaStr": "x double"}}],
            "edges": []})
        ran = _req(web.port, f"/api/experiments/{exp['id']}/run", "POST",
                   {})
        assert ran["results"]["a"]["table"]["num_rows"] == 2
        assert ran["trace_id"] in {t["trace_id"] for t in
                                   _req(web.port, "/api/traces")["traces"]}
        with pytest.raises(urllib.error.HTTPError) as ei:
            _req(web.port, "/api/analysis")
        assert ei.value.code == 501
        with pytest.raises(urllib.error.HTTPError) as ei:
            _req(web.port, "/api/serving/predict/ghost", "POST",
                 {"row": [1, 2, 3, 4]})
        assert ei.value.code == 400
        assert _req(web.port, "/api/serving/models/lr", "DELETE") == \
            {"unloaded": "lr"}
        with pytest.raises(urllib.error.HTTPError) as ei:
            _req(web.port, "/api/serving/models/lr", "DELETE")
        assert ei.value.code == 404
    finally:
        web.stop()
        srv.close()


def test_http_shed_maps_to_429(fitted, tmp_path):
    from alink_tpu_torch.webui import ExperimentStore, WebUIServer

    X, model = fitted
    srv = _server(queue_depth=1, max_batch_rows=1, flush_deadline_s=5.0)
    srv.load("tiny", model, SCHEMA)
    srv.submit("tiny", tuple(X[0]))
    web = WebUIServer(port=0, store=ExperimentStore(
        str(tmp_path / "exp.json")), model_server=srv)
    web.start(background=True)
    try:
        with pytest.raises(urllib.error.HTTPError) as ei:
            _req(web.port, "/api/serving/predict/tiny", "POST",
                 {"row": list(map(float, X[1]))})
        assert ei.value.code == 429
    finally:
        web.stop()
        srv.close()


# ---------------------------------------------------------------------------
# the BERT route
# ---------------------------------------------------------------------------


def _sst_texts(n):
    path = os.path.join(os.path.dirname(__file__), "..", "data",
                        "sst2_mini.csv")
    with open(path, newline="") as f:
        return [(t,) for t, _ in csv.reader(f)][:n]


def _bert_pipeline(path, seed=0):
    """data/bert_tiny_sst with a seeded 2-label head, as a one-stage
    BertClassificationModel pipeline saved to ``path``."""
    from alink_tpu_torch.common.model import model_to_table
    from alink_tpu_torch.dl.modules import BertConfig, TransformerEncoder
    from alink_tpu_torch.dl.pretrained import (init_from_pretrained,
                                               load_bert_checkpoint,
                                               load_vocab_file)
    from alink_tpu_torch.operator.batch.dl import params_to_bytes
    from alink_tpu_torch.pipeline import BertClassificationModel, PipelineModel

    d = os.path.join(os.path.dirname(__file__), "..", "data",
                     "bert_tiny_sst")
    ck, sub = load_bert_checkpoint(d)
    lower = ck.pop("do_lower_case", True)
    cfg = BertConfig(num_labels=2, pool="cls", attention_block_size=16, **ck)
    tree = init_from_pretrained(TransformerEncoder(cfg), cfg, sub, seed=seed)
    meta = {"modelName": "BertTextModel",
            "bertConfig": {k: v for k, v in dataclasses.asdict(cfg).items()
                           if k != "dtype"},
            "textCol": "text", "textPairCol": None, "labelCol": "label",
            "labelType": "LONG", "labels": [0, 1], "regression": False,
            "maxSeqLength": 32, "vocab": load_vocab_file(d),
            "doLowerCase": lower}
    PipelineModel(BertClassificationModel(
        predictionCol="pred", predictionDetailCol="detail").set_model_data(
        model_to_table(meta, {"params": params_to_bytes(tree)}))).save(path)


@pytest.fixture(scope="module")
def bert(tmp_path_factory):
    from alink_tpu_torch.pipeline import LocalPredictor

    path = str(tmp_path_factory.mktemp("bert") / "bert.ak")
    _bert_pipeline(path)
    texts = _sst_texts(48)
    lp = LocalPredictor(path, "text string")
    return path, texts, [lp.predict_row(r) for r in texts]


def _probs(row):
    d = json.loads(row[-1])
    return np.asarray([d[k] for k in sorted(d)])


def test_bert_serving_meets_no_new_shape_and_holds_serial_rows(bert):
    """Warmup runs both rungs; traffic (single requests, then three
    concurrent clients) then meets no new signature, and every row is its
    serial predict's within CROSS_RUNG_ATOL, label equal."""
    from alink_tpu_torch.common.jitcache import bucket_rows

    path, texts, serial = bert
    srv = _server(max_batch_rows=16, flush_deadline_s=0.005)
    try:
        info = srv.load("bert", path, "text string", warmup_rows=texts[:8])
        assert info["warmup"] == {"rungs": 2, "rows": 24}
        t0 = _counter("jit.trace")
        futs = [(i, srv.submit("bert", texts[i])) for i in range(4)]
        for _, f in futs:
            f.result(timeout=JOIN_S)
        more = {}

        def client(cid):
            return lambda: more.__setitem__(cid, [
                (i, srv.submit("bert", texts[i]))
                for i in range(4 + cid, len(texts), 3)])

        _run_threads([client(c) for c in range(3)])
        futs += [p for c in range(3) for p in more[c]]
        rungs = set()
        for i, f in futs:
            row = f.result(timeout=JOIN_S)
            rungs.add(bucket_rows(f.batch_rows))
            assert row[:2] == serial[i][:2]
            np.testing.assert_allclose(_probs(row), _probs(serial[i]),
                                       rtol=0, atol=CROSS_RUNG_ATOL)
        assert _counter("jit.trace") == t0
        assert 8 in rungs and rungs <= {8, 16}
    finally:
        srv.close()


@pytest.mark.parametrize("policy", ["bf16", "int8"])
def test_bert_precision_load_quantizes_once(bert, policy):
    path, texts, serial = bert
    srv = _server(max_batch_rows=16, flush_deadline_s=0.002)
    try:
        b0 = _counter("dl.served_state_builds")
        info = srv.load("q", path, "text string", warmup_rows=texts[:8],
                        precision=policy)
        assert info["precision"]["policy"] == policy
        assert info["precision"]["band_report"]["ok"]
        got = srv.predict_many("q", texts[8:24], timeout=JOIN_S)
        srv.predict_many("q", texts[24:40], timeout=JOIN_S)
        assert _counter("dl.served_state_builds") == b0 + 1
        assert srv.stats()["models"][0]["precision"] == policy
        for g, w in zip(got, serial[8:24]):
            pg, pw = _probs(g), _probs(w)
            assert np.abs(pg - pw).max() <= 0.05
            if abs(pw[1] - pw[0]) > 0.1:
                assert g[1] == w[1]
    finally:
        srv.close()


def test_int8_without_ranges_falls_back_unless_weight_only(bert,
                                                           monkeypatch):
    """The activation-range requirement holds for every op that does not
    declare its int8 weight-only: with the declaration off, the BERT int8
    load records no range and falls back to fp32, as the reference's
    does, and serves the fp32 rows."""
    from alink_tpu_torch.operator.batch.dl import BertTextModelMapper

    monkeypatch.setattr(BertTextModelMapper, "INT8_WEIGHT_ONLY", False)
    path, texts, serial = bert
    srv = _server(max_batch_rows=8, flush_deadline_s=0.002)
    try:
        info = srv.load("q", path, "text string", warmup_rows=texts[:8],
                        precision="int8", persist_warmup=False)["precision"]
        assert info["policy"] == "fp32" and "no activation" in \
            info["fallback"]
        got = srv.predict_many("q", texts[:8], timeout=JOIN_S)
        for g, w in zip(got, serial[:8]):
            assert g[1] == w[1]
            np.testing.assert_allclose(_probs(g), _probs(w), rtol=0,
                                       atol=CROSS_RUNG_ATOL)
    finally:
        srv.close()


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_pipeline(tmp_path_factory):
    """LinearRegression then LogisticRegression, fitted by alink_tpu and
    saved to .ak."""
    from alink_tpu.common.mtable import MTable
    from alink_tpu.operator.batch import TableSourceBatchOp
    from alink_tpu.pipeline import (LinearRegression, LogisticRegression,
                                    Pipeline)

    X, cols = _data(seed=3)
    model = Pipeline(
        LinearRegression(featureCols=FEATS, labelCol="y",
                         predictionCol="yhat"),
        LogisticRegression(featureCols=FEATS, labelCol="label",
                           predictionCol="pred",
                           predictionDetailCol="detail"),
    ).fit(TableSourceBatchOp(MTable(cols)))
    path = str(tmp_path_factory.mktemp("jaxlr") / "m.ak")
    model.save(path)
    return X, path


def _both_servers(**kw):
    from alink_tpu.serving import ModelServer as RefServer
    from alink_tpu.serving import ServingConfig as RefConfig

    return RefServer(RefConfig(**kw)), _server(**kw)


def _rows_close(got, want, prob_atol):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        assert g[5] == w[5]                                  # the label
        assert g[4] == pytest.approx(w[4], abs=NUMERIC_ATOL)  # yhat
        np.testing.assert_array_equal(np.asarray(g[:4], float),
                                      np.asarray(w[:4], float))
        np.testing.assert_allclose(_probs(g), _probs(w), rtol=0,
                                   atol=prob_atol)


def test_jax_fit_pipeline_serves_alike(jax_pipeline):
    X, path = jax_pipeline
    ref, port = _both_servers(max_batch_rows=16, flush_deadline_s=0.002)
    rows = [tuple(r) for r in X]
    try:
        for srv in (ref, port):
            srv.load("m", path, SCHEMA, warmup_rows=rows[:4],
                     persist_warmup=False)
        want = ref.predict_many("m", rows, timeout=JOIN_S)
        got = port.predict_many("m", rows, timeout=JOIN_S)
        _rows_close(got, want, 1e-6)
        assert port.stats()["models"][0]["completed"] == len(rows)
    finally:
        ref.close()
        port.close()


@pytest.mark.parametrize("band,expect", [(None, "int8"), (0.0, "fp32")])
def test_int8_band_gate_matches_reference(jax_pipeline, band, expect):
    """The default band admits the int8 load in both packages; band 0 /
    tol 0 refuses it in both (the regression column moves), and both
    then serve fp32."""
    X, path = jax_pipeline
    kw = {} if band is None else dict(quant_band=band, quant_tol=band)
    ref, port = _both_servers(max_batch_rows=16, **kw)
    rows = [tuple(r) for r in X[::3]]
    try:
        infos = [srv.load("q", path, SCHEMA, warmup_rows=rows,
                          precision="int8", persist_warmup=False)
                 ["precision"] for srv in (ref, port)]
        for info in infos:
            assert info["policy"] == expect
            assert info["band_report"]["ok"] == (band is None)
        assert infos[1]["band_report"]["agreement"] == \
            infos[0]["band_report"]["agreement"]
        got = port.predict_many("q", [tuple(r) for r in X[:20]],
                                timeout=JOIN_S)
        want = ref.predict_many("q", [tuple(r) for r in X[:20]],
                                timeout=JOIN_S)
        for g, w in zip(got, want):
            assert g[4] == pytest.approx(w[4], abs=2e-3)
    finally:
        ref.close()
        port.close()


@pytest.mark.parametrize("writer", ["alink_tpu", "alink_tpu_torch"])
def test_sidecar_crosses_packages(jax_pipeline, tmp_path, writer):
    import shutil

    X, path = jax_pipeline
    ak = str(tmp_path / "m.ak")
    shutil.copyfile(path, ak)
    ref, port = _both_servers(max_batch_rows=16)
    write, read = (ref, port) if writer == "alink_tpu" else (port, ref)
    rows = [tuple(r) for r in X[:3]]
    try:
        assert write.load("w", ak, SCHEMA, warmup_rows=rows)[
            "warmup_sidecar"] is not None
        info = read.load("r", ak)
        assert info["warmup_source"] == "sidecar"
        assert info["warmup"]["rows"] == 24
        got = read.predict_many("r", [tuple(r) for r in X[:10]],
                                timeout=JOIN_S)
        want = write.predict_many("w", [tuple(r) for r in X[:10]],
                                  timeout=JOIN_S)
        _rows_close(got, want, 1e-6)
    finally:
        ref.close()
        port.close()


def test_tiny_bert_served_alike(bert, tmp_path):
    """The same .ak BERT pipeline in both servers: probabilities within
    PROB_ATOL, labels equal where the reference's margin exceeds it; bf16
    passes the band gate in both; int8 records no activation range in
    either: the port gates its weight-only load on the band, which it
    passes, and the reference falls back to fp32."""
    import shutil

    path, texts, _ = bert
    ak = str(tmp_path / "bert.ak")
    shutil.copyfile(path, ak)
    ref, port = _both_servers(max_batch_rows=8, flush_deadline_s=0.002)
    try:
        for srv in (ref, port):
            srv.load("b", ak, "text string", warmup_rows=texts[:8],
                     persist_warmup=False)
        want = ref.predict_many("b", texts[:24], timeout=JOIN_S)
        got = port.predict_many("b", texts[:24], timeout=JOIN_S)
        for g, w in zip(got, want):
            pg, pw = _probs(g), _probs(w)
            np.testing.assert_allclose(pg, pw, rtol=0, atol=PROB_ATOL)
            if abs(pw[1] - pw[0]) > PROB_ATOL:
                assert g[1] == w[1]
        infos = {}
        for policy in ("bf16", "int8"):
            infos[policy] = [srv.load(
                policy, ak, "text string", warmup_rows=texts[:8],
                precision=policy, persist_warmup=False)["precision"]
                for srv in (ref, port)]
        for info in infos["bf16"]:
            assert info["policy"] == "bf16" and info["band_report"]["ok"]
        ref8, port8 = infos["int8"]
        assert ref8["policy"] == "fp32" and "no activation" in \
            ref8["fallback"]
        assert port8["policy"] == "int8" and port8["band_report"]["ok"]
        assert port8["calib"] == {}
    finally:
        ref.close()
        port.close()


def _model_table(pkg, path):
    import importlib

    pl = importlib.import_module(pkg + ".pipeline")
    return pl.PipelineModel.load(path).stages[0].get_model_data()


def _bert_op_rows(pkg, op_name, model, rows, schema, **params):
    import importlib

    ops = importlib.import_module(pkg + ".operator.batch")
    mt = importlib.import_module(pkg + ".common.mtable")
    return getattr(ops, op_name)(**params).link_from(
        ops.TableSourceBatchOp(model),
        ops.TableSourceBatchOp(mt.MTable.from_rows(rows, schema))
    ).collect().to_rows()


def test_bert_embedding_and_pair_ops_match_reference(bert):
    """BertTextEmbeddingBatchOp's pooled vectors, and the pair classifier's
    predictions on a model that names a pair column, in both packages:
    vectors within EMBED_ATOL = 0.05 (bf16 pooled states through tanh, a
    bf16 ulp 2**-8 of values up to 1, grown over 2 layers), labels equal
    where the reference's margin exceeds PROB_ATOL."""
    path, texts, _ = bert
    rows = [(t, texts[-1 - i][0]) for i, (t,) in enumerate(texts[:12])]
    for pkg in ("alink_tpu", "alink_tpu_torch"):
        assert _model_table(pkg, path).num_rows == \
            _model_table("alink_tpu", path).num_rows
    out = {}
    for pkg in ("alink_tpu", "alink_tpu_torch"):
        model = _model_table(pkg, path)
        emb = _bert_op_rows(pkg, "BertTextEmbeddingBatchOp", model,
                            [r[:1] for r in rows], "text string")
        pair = _bert_op_rows(pkg, "BertTextPairClassifierPredictBatchOp",
                             model, rows, "text string, text2 string",
                             textPairCol="text2", predictionCol="pred",
                             predictionDetailCol="detail")
        out[pkg] = (np.asarray([np.asarray(r[1].data) for r in emb]), pair)
    (e_ref, p_ref), (e_port, p_port) = out["alink_tpu"], \
        out["alink_tpu_torch"]
    assert e_port.shape == e_ref.shape == (12, 128)
    np.testing.assert_allclose(e_port, e_ref, rtol=0, atol=0.05)
    for g, w in zip(p_port, p_ref):
        pg, pw = _probs(g), _probs(w)
        np.testing.assert_allclose(pg, pw, rtol=0, atol=PROB_ATOL)
        if abs(pw[1] - pw[0]) > PROB_ATOL:
            assert g[2] == w[2]


def test_catalog_matches_reference_on_shared_ops():
    """op_info over the operators both packages have: the same ports, and
    each batch operator's parameters a subset of the reference's, with the
    same defaults. (The port's ingest stream ops declare the parameters
    that the reference's read from their batch twins.)"""
    from alink_tpu.common import catalog as ref
    from alink_tpu_torch.common import catalog as port

    ref_ops = {c.__name__: c for cs in ref.list_operators().values()
               for c in cs}
    shared = [(flavor, c) for flavor, cs in port.list_operators().items()
              for c in cs if c.__name__ in ref_ops]
    assert len(shared) >= 90
    for flavor, cls in shared:
        mine, theirs = port.op_info(cls), ref.op_info(ref_ops[cls.__name__])
        assert mine["ports"] == theirs["ports"], cls.__name__
        if flavor == "batch":
            defaults = {p["name"]: p["default"] for p in theirs["params"]}
            for p in mine["params"]:
                assert p["name"] in defaults, (cls.__name__, p["name"])
                assert repr(p["default"]) == repr(defaults[p["name"]]), \
                    (cls.__name__, p["name"])
