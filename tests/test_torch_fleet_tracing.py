"""The fleet's observability plane in the port: cross-process span relay
(``common/tracing.py``'s process identity, export, drain and ingest, and
the Chrome trace's process lanes), the telemetry relay
(``common/telemetry.py``) and the exact histogram merge
(``common/metrics.py``), held against ``alink_tpu`` on the CPU.

Units, both packages on the same inputs: a histogram merge of the same
states gives the same state, bucket for bucket, as the reference's and as
the pooled observations; the labeled Prometheus families print the same
lines; the telemetry deltas of one observation sequence are equal, the sink
merges them to equal labeled states, and both drop the same garbage whole;
the span export, drain and ingest stamp the sender the same way and refuse
the same batches all-or-nothing; a process identity stamps spans and wire
contexts in both. The port's front end stamps its ``fleet.request`` span
into each frame (``None`` with tracing off) and marks failed-over and
expired requests on the stitched tree.

Live: one 2-replica fleet with tracing on gives one stitched
``job_report`` tree per front-door request (the replica's spans under the
front end's, tagged with the replica, in their own Chrome-trace lanes) and
fleet-wide quantiles that are the exact merge of the replicas' relayed
bucket counts (tests/test_torch_fleet.py's shared fleet runs with
tracing off and relays no span). Waits poll on events under generous
deadlines.
"""

import json
import socket
import threading
import time

import numpy as np
import pytest

SCHEMA = "f0 double, f1 double, f2 double, f3 double"
FEATS = ["f0", "f1", "f2", "f3"]
WAIT_S = 90.0
WORKER_ENV = {"OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}
PACKAGES = ("alink_tpu", "alink_tpu_torch")


@pytest.fixture(scope="module", autouse=True)
def _cpu():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("ALINK_TORCH_DEVICE", "cpu")
        mp.setenv("ALINK_TRACING", "on")
        mp.delenv("ALINK_FAULT_SPEC", raising=False)
        yield


def _mod(pkg, name):
    import importlib

    return importlib.import_module(f"{pkg}.{name}")


def _wait(pred, timeout=WAIT_S, interval=0.05):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(interval)
    return False


def _walk(nodes, out=None, depth=0):
    out = [] if out is None else out
    for n in nodes or []:
        out.append((depth, n))
        _walk(n.get("children"), out, depth + 1)
    return out


def _values(seed, n):
    """Latency-like seconds over the whole bucket ladder."""
    rng = np.random.default_rng(seed)
    return [float(v) for v in 10.0 ** rng.uniform(-4.5, 2.0, n)]


# ---------------------------------------------------------------------------
# exact merge, labeled exposition
# ---------------------------------------------------------------------------


def test_histogram_merge_equals_reference_and_pooled():
    parts = [_values(s, n) for s, n in ((1, 40), (2, 7), (3, 90))]
    states = {}
    for pkg in PACKAGES:
        H = _mod(pkg, "common.metrics")._Histogram
        hs = []
        for vals in parts:
            h = H()
            for v in vals:
                h.observe(v)
            hs.append(h)
        merged = H.from_state(json.loads(json.dumps(hs[0].state())))
        for h in hs[1:]:
            merged.merge(H.from_state(h.state()))
        pooled = H()
        for v in sum(parts, []):
            pooled.observe(v)
        assert merged.counts == pooled.counts
        assert merged.count == pooled.count
        assert (merged.min, merged.max) == (pooled.min, pooled.max)
        assert merged.stats()["p99"] == pooled.stats()["p99"]
        states[pkg] = merged.state()
        with pytest.raises(ValueError):
            merged.merge(H([1.0, 2.0]))
        for garbage in ("x", {"buckets": [1], "counts": [1]},
                        {"buckets": [1.0], "counts": ["a", "b"]},
                        {"buckets": [1.0], "counts": [1, -2]}):
            with pytest.raises(ValueError):
                H.from_state(garbage)
    assert states["alink_tpu_torch"] == states["alink_tpu"]


def test_merged_histogram_and_prometheus_families_like_reference():
    texts, merged = {}, {}
    for pkg in PACKAGES:
        m = _mod(pkg, "common.metrics")
        rec = m.StepMetrics()
        rec.observe("serving.request_s", 0.01)
        base = rec.export_prometheus()
        for rid, seed in (("r1", 4), ("r2", 5), ("r1", 6)):
            h = m._Histogram()
            for v in _values(seed, 25):
                h.observe(v)
            rec.merge_histogram("serving.request_s", h.state(), replica=rid)
        merged[pkg] = (rec.merged_histogram("serving.request_s"),
                       rec.merged_histogram("serving.request_s",
                                            include_local=True),
                       rec.labeled_histogram("serving.request_s",
                                             replica="r1"),
                       rec.labeled_histogram("serving.request_s",
                                             replica="nope"))
        out = rec.export_prometheus()
        assert out.count("# TYPE alink_serving_request_seconds "
                         "histogram") == 1
        assert 'alink_serving_request_seconds_count{replica="r2"} 25' in out
        for line in base.splitlines():
            assert line in out
        texts[pkg] = out
    assert merged["alink_tpu_torch"] == merged["alink_tpu"]
    assert merged["alink_tpu"][0]["count"] == 75
    assert texts["alink_tpu_torch"] == texts["alink_tpu"]


def test_export_hook_runs_at_scrape_and_failures_are_counted():
    from alink_tpu_torch.common.metrics import StepMetrics, metrics

    rec = StepMetrics()
    calls = []
    rec.register_export_hook(lambda: (calls.append(1),
                                      rec.set_gauge("g.live", len(calls))))
    rec.register_export_hook(lambda: 1 / 0)
    dropped = metrics.counter("metrics.dropped")
    assert "alink_g_live 1.0" in rec.export_prometheus()
    assert "alink_g_live 2.0" in rec.export_prometheus()
    assert metrics.counter("metrics.dropped") == dropped + 2


# ---------------------------------------------------------------------------
# telemetry relay
# ---------------------------------------------------------------------------


def _telemetry_run(pkg):
    m = _mod(pkg, "common.metrics")
    tele = _mod(pkg, "common.telemetry")
    worker, supervisor = m.StepMetrics(), m.StepMetrics()
    src, sink = tele.TelemetrySource(worker), tele.TelemetrySink(supervisor)
    deltas = []
    for step, seed in enumerate((7, 8, None, 9)):
        if seed is not None:
            worker.incr("serving.requests", step + 1)
            for v in _values(seed, 5 + step):
                worker.observe("serving.request_s", v)
        d = src.delta()
        deltas.append(d)
        if d is not None:
            sink.ingest(json.loads(json.dumps(d)), replica="r1")
    return (deltas, sink.counters_for("r1"),
            supervisor.labeled_histogram("serving.request_s", replica="r1"),
            sink.counter_totals("serving."))


def test_telemetry_deltas_and_sink_equal_reference():
    got = {pkg: _telemetry_run(pkg) for pkg in PACKAGES}
    assert got["alink_tpu_torch"] == got["alink_tpu"]
    deltas, counters, hist, totals = got["alink_tpu_torch"]
    assert deltas[2] is None                       # nothing new: no delta
    assert deltas[1]["counters"] == {"serving.requests": 2}   # a delta
    assert counters == totals == {"serving.requests": 7}
    assert hist["count"] == 5 + 6 + 8


_TELEMETRY_GARBAGE = [
    None, [], {"v": 99, "counters": {}, "hists": {}},
    {"v": 1, "counters": {"x": True}, "hists": {}},
    {"v": 1, "counters": {"x": "nan"}, "hists": {}},
    {"v": 1, "counters": {"n" * 300: 1}, "hists": {}},
    {"v": 1, "counters": {}, "hists": {"h": {"buckets": [1],
                                             "counts": [1]}}},
    {"v": 1, "counters": {"good": 1},
     "hists": {"bad": "garbage", "ok": {"buckets": [1.0], "counts": [0, 1],
                                        "count": 1, "sum": 2.0}}},
    {"v": 1, "hists": {}, "counters": {"k" + "x" * 150 + str(i): 10 ** 250
                                       for i in range(400)}},
]


@pytest.mark.parametrize("payload", _TELEMETRY_GARBAGE)
def test_telemetry_garbage_dropped_whole_like_reference(payload):
    for pkg in PACKAGES:
        m = _mod(pkg, "common.metrics")
        sink = _mod(pkg, "common.telemetry").TelemetrySink(m.StepMetrics())
        with pytest.raises(ValueError):
            sink.ingest(payload, replica="r1")
        assert sink.counters_for("r1") == {}


def test_telemetry_trims_loudly_like_reference():
    trimmed = {}
    for pkg in PACKAGES:
        m = _mod(pkg, "common.metrics")
        tele = _mod(pkg, "common.telemetry")
        rec = m.StepMetrics()
        src = tele.TelemetrySource(rec)
        for i in range(520):
            rec.incr(f"c.{i:04d}")
        d = src.delta()
        assert len(d["counters"]) == tele.MAX_COUNTERS
        trimmed[pkg] = (sorted(d["counters"]),
                        src.delta()["counters"]["telemetry.trimmed"])
    assert trimmed["alink_tpu_torch"] == trimmed["alink_tpu"]
    assert trimmed["alink_tpu"][1] == 8


# ---------------------------------------------------------------------------
# span relay
# ---------------------------------------------------------------------------


def _strip(span):
    return {k: v for k, v in span.items()
            if k not in ("trace_id", "span_id", "t_start", "wall_s",
                         "thread")}


def test_export_drain_ingest_like_reference():
    shapes = {}
    for pkg in PACKAGES:
        tr = _mod(pkg, "common.tracing")
        t = tr.Tracer()
        assert t.drain_export() == []
        t.enable_export()
        t.finish(t.start("relay.unit", rows=3))
        batch = t.drain_export()
        assert len(batch) == 1 and "start_perf" not in batch[0]
        assert t.drain_export() == []
        sink = tr.Tracer()
        assert sink.ingest(batch, proc="r9", pid=4242) == 1
        shapes[pkg] = (_strip(batch[0]), _strip(sink.spans()[0]))
    assert shapes["alink_tpu_torch"] == shapes["alink_tpu"]
    assert shapes["alink_tpu"][1]["proc"] == "r9"
    assert shapes["alink_tpu"][1]["pid"] == 4242


_GOOD = {"trace_id": "t1", "span_id": "s1", "name": "ok.span",
         "t_start": 1.0, "wall_s": 0.5, "parent_id": None}


@pytest.mark.parametrize("batch", [
    "not-a-list", [_GOOD, "not-a-dict"],
    [_GOOD, {"trace_id": "t1", "name": "missing-span-id"}],
    [_GOOD, dict(_GOOD, span_id="s2", t_start="garbage")],
    [_GOOD, dict(_GOOD, span_id="s2", parent_id=123)]])
def test_ingest_refuses_garbage_all_or_nothing_like_reference(batch):
    for pkg in PACKAGES:
        sink = _mod(pkg, "common.tracing").Tracer()
        with pytest.raises(ValueError):
            sink.ingest(batch)
        assert sink.spans() == []
        assert sink.ingest([_GOOD]) == 1


def test_process_identity_stamps_spans_and_wire_context():
    stamped = {}
    for pkg in PACKAGES:
        tr = _mod(pkg, "common.tracing")
        t = tr.Tracer()
        try:
            tr.set_process_identity("r4", pid=999)
            assert tr.process_identity() == "r4"
            with tr.trace_span("id.span") as sp:
                ctx = tr.wire_context()
            d = sp.to_dict()
        finally:
            tr.set_process_identity(None)
        t.finish(tr.Span("t", "s", None, "plain", {}))
        stamped[pkg] = ((d["proc"], d["pid"]), ctx["proc"],
                        "proc" in t.spans()[0], tr.process_identity())
    assert stamped["alink_tpu_torch"] == stamped["alink_tpu"] == (
        ("r4", 999), "r4", False, None)


def test_span_tree_stitches_late_remote_children():
    from alink_tpu_torch.common.tracing import job_report, trace_span, tracer

    with trace_span("late.parent") as sp:
        tid, sid = sp.trace_id, sp.span_id
    tracer.ingest([{"trace_id": tid, "span_id": "rem-1", "parent_id": sid,
                    "name": "late.child", "t_start": time.time(),
                    "wall_s": 0.01}], proc="r1", pid=777)
    rows = _walk(job_report(tid)["tree"])
    assert [(d, n["name"]) for d, n in rows] == [
        (0, "late.parent"), (1, "late.child")]
    child = rows[1][1]
    assert (child["proc"], child["pid"]) == ("r1", 777)
    assert "rel_start_s" in child and "start_perf" not in child


def test_chrome_trace_lanes_per_process():
    from alink_tpu_torch.common.tracing import (chrome_trace, trace_span,
                                                tracer)

    with trace_span("lane.frontdoor") as sp:
        tid, sid = sp.trace_id, sp.span_id
    local = [e for e in chrome_trace(tid)["traceEvents"] if e["ph"] == "X"]
    assert [e["pid"] for e in local] == [1]
    now = time.time()
    for span_id, proc, pid in (("a-1", "r1", 3001), ("b-1", "r2", 3002),
                               ("c-1", "r3", 3001)):
        tracer.ingest([{"trace_id": tid, "span_id": span_id,
                        "parent_id": sid, "name": "lane.batch",
                        "t_start": now, "wall_s": 0.01,
                        "thread": "batcher"}], proc=proc, pid=pid)
    blob = chrome_trace(tid)
    assert blob["traceEvents"][0] == {
        "ph": "M", "pid": 1, "tid": 0, "name": "process_name",
        "args": {"name": "alink_tpu_torch"}}
    xs = [e for e in blob["traceEvents"] if e["ph"] == "X"]
    lanes = {e["pid"] for e in xs}
    assert len(lanes) == 4 and {1, 3001, 3002} <= lanes   # r3: own lane
    names = {e["pid"]: e["args"]["name"] for e in blob["traceEvents"]
             if e["ph"] == "M" and e["name"] == "process_name"}
    assert names[3001] == "r1" and names[3002] == "r2"
    assert sorted(names.values()) == ["alink_tpu_torch", "r1", "r2", "r3"]


# ---------------------------------------------------------------------------
# the front end's spans
# ---------------------------------------------------------------------------


class _FakeReplica:
    def __init__(self, rid, handler):
        from alink_tpu_torch.common.resilience import CircuitBreaker
        from alink_tpu_torch.serving import ReplicaClient

        self.rid, self.handler, self.seen = rid, handler, []
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.bind(("127.0.0.1", 0))
        self._sock.listen(8)
        CircuitBreaker.replace_endpoint(f"fleet:{rid}", failure_threshold=5,
                                        reset_timeout=30.0)
        self.client = ReplicaClient(rid, "127.0.0.1",
                                    self._sock.getsockname()[1])
        threading.Thread(target=self._accept, daemon=True).start()

    def _accept(self):
        from alink_tpu_torch.serving.fleet_frontend import (recv_frame,
                                                            send_frame)

        def serve(conn):
            try:
                while True:
                    op = recv_frame(conn)
                    self.seen.append(op)
                    try:
                        send_frame(conn, self.handler(op))
                    except ConnectionError:
                        conn.close()
                        return
            except (ConnectionError, OSError, EOFError):
                conn.close()

        while True:
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            threading.Thread(target=serve, args=(conn,), daemon=True).start()

    def close(self):
        self._sock.close()
        self.client.close()


def _fleet_request_spans():
    from alink_tpu_torch.common.tracing import tracer

    return [s for s in tracer.spans() if s["name"] == "fleet.request"]


@pytest.mark.parametrize("tracing", ["on", "off"])
def test_frontend_stamps_wire_context(monkeypatch, tracing):
    from alink_tpu_torch.common.tracing import tracer
    from alink_tpu_torch.serving import FleetFrontend

    monkeypatch.setenv("ALINK_TRACING", tracing)
    ok = _FakeReplica(f"fx-ctx-{tracing}", lambda op: {"ok": True,
                                                       "value": "A"})
    try:
        n0 = len(tracer.spans())
        fe = FleetFrontend(lambda: [(ok.rid, ok.client)])
        assert fe.predict("m", (1.0,), timeout=30) == "A"
        op = ok.seen[-1]
        if tracing == "off":
            assert op["trace"] is None and len(tracer.spans()) == n0
            return
        span = _fleet_request_spans()[-1]
        assert op["trace"] == {"trace_id": span["trace_id"],
                               "span_id": span["span_id"]}
    finally:
        ok.close()


def test_failover_and_deadline_outcomes_on_the_tree():
    from alink_tpu_torch.common.exceptions import AkDeadlineExceededException
    from alink_tpu_torch.common.tracing import job_report
    from alink_tpu_torch.serving import FleetFrontend

    def die(op):
        raise ConnectionError("boom")

    dead = _FakeReplica("fx-t-dead", die)
    live = _FakeReplica("fx-t-live", lambda op: {"ok": True, "value": "A"})
    try:
        fe = FleetFrontend(lambda: [(dead.rid, dead.client),
                                    (live.rid, live.client)])
        for _ in range(4):
            assert fe.predict("m", (1.0,), timeout=30) == "A"
        retried = [s for s in _fleet_request_spans()
                   if s["outcome"] == "retried"]
        assert retried
        rep = job_report(retried[-1]["trace_id"])
        assert rep["tree"][0]["outcome"] == "retried" and rep["retries"] >= 1
        with pytest.raises(AkDeadlineExceededException):
            FleetFrontend(lambda: [(live.rid, live.client)]).predict(
                "m", (1.0,), timeout=1e-9)
        span = _fleet_request_spans()[-1]
        assert span["outcome"] == "failed"
        assert "AkDeadlineExceededException" in span["error"]
    finally:
        dead.close()
        live.close()


# ---------------------------------------------------------------------------
# the live fleet
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    """A port-fitted LogisticRegression pipeline, its sidecar, and the
    single-process server's rows."""
    from alink_tpu_torch.common.mtable import MTable
    from alink_tpu_torch.operator.batch import TableSourceBatchOp
    from alink_tpu_torch.pipeline import LogisticRegression, Pipeline
    from alink_tpu_torch.serving import ModelServer

    rng = np.random.default_rng(5)
    X = np.concatenate([rng.normal(c, 0.8, size=(16, 4)) for c in (0, 1.5)])
    cols = {**{f"f{i}": X[:, i] for i in range(4)},
            "label": np.repeat([0, 1], 16)}
    pm = Pipeline(LogisticRegression(
        featureCols=FEATS, labelCol="label", predictionCol="pred",
        predictionDetailCol="detail")).fit(TableSourceBatchOp(MTable(cols)))
    path = str(tmp_path_factory.mktemp("fleet_tracing") / "lr.ak")
    pm.save(path)
    srv = ModelServer()
    srv.load("m", path, SCHEMA, warmup_rows=[tuple(X[0])])
    rows = [tuple(r) for r in X]
    serial = [srv.predict("m", r) for r in rows]
    srv.close()
    return path, rows, serial


def _start(path, replicas, **env):
    from alink_tpu_torch.serving import FleetConfig, ServingFleet

    fleet = ServingFleet(FleetConfig(
        replicas=replicas, heartbeat_s=0.2, heartbeat_timeout_s=10.0,
        worker_env=dict(WORKER_ENV, **env)))
    try:
        fleet.start()
        fleet.load("m", path, SCHEMA)
    except BaseException:
        fleet.stop(drain=False)
        raise
    return fleet


@pytest.fixture(scope="module")
def traced_fleet(model):
    fleet = _start(model[0], 2, ALINK_TRACING="on")
    yield fleet
    fleet.stop()


def test_fleet_stitched_trace(traced_fleet, model):
    from alink_tpu_torch.common.tracing import chrome_trace, job_report

    _, rows, serial = model
    assert traced_fleet.predict("m", rows[0]) == serial[0]
    tid = _fleet_request_spans()[-1]["trace_id"]

    def remote():
        return [n for _, n in _walk(job_report(tid)["tree"])
                if n.get("proc")]

    assert _wait(lambda: {"serving.request", "serving.batch"}
                 <= {n["name"] for n in remote()})
    rep = job_report(tid)
    assert len(rep["tree"]) == 1
    root = rep["tree"][0]
    assert root["name"] == "fleet.request" and root["outcome"] == "ok"
    procs = {n["proc"] for n in remote()}
    assert len(procs) == 1 and procs <= {"r0", "r1"}
    pid = traced_fleet._replicas[procs.pop()].proc.pid
    assert {n["pid"] for n in remote()} == {pid}
    blob = chrome_trace(tid)
    xpids = {e["pid"] for e in blob["traceEvents"] if e["ph"] == "X"}
    assert xpids == {1, pid}


def test_fleet_wide_quantiles_are_exact_merge(traced_fleet, model):
    from alink_tpu_torch.common.metrics import metrics

    _, rows, serial = model

    def merged():
        return metrics.merged_histogram("serving.request_s") or {}

    def parts():
        return {r: metrics.labeled_histogram("serving.request_s", replica=r)
                or {"count": 0, "sum": 0.0} for r in ("r0", "r1")}

    def reading():
        done = {r["replica"]: r["completed"] or 0
                for r in traced_fleet.fleet_summary()["replicas"]}
        return done, {r: p["count"] for r, p in parts().items()}

    def quiesced():
        # relayed deltas trail the requests by about a heartbeat: two
        # readings a few heartbeats apart agree once all has arrived
        first = reading()
        time.sleep(0.6)
        return reading() == first

    assert _wait(quiesced)
    (done0, _), base, bparts = reading(), merged(), parts()
    for r, want in zip(rows[:12], serial[:12]):
        assert traced_fleet.predict("m", r) == want

    def relayed():
        done, counts = reading()
        return all(done[r] - done0[r] == counts[r] - bparts[r]["count"]
                   for r in done) and sum(done.values()) \
            == sum(done0.values()) + 12
    assert _wait(relayed)
    assert _wait(quiesced)
    m, p = merged(), parts()
    assert m["count"] - base.get("count", 0) == 12 == sum(
        p[r]["count"] - bparts[r]["count"] for r in p)
    assert m["sum"] - base.get("sum", 0.0) == pytest.approx(
        sum(p[r]["sum"] - bparts[r]["sum"] for r in p), abs=5e-6)
    out = metrics.export_prometheus()
    assert 'alink_serving_request_seconds_bucket{replica="r0",le=' in out
    assert "alink_fleet_serving_request_s_p50" in out
    summ = traced_fleet.fleet_summary()
    assert summ["fleet_wide"]["serving.request_s"]["count"] == m["count"]
    assert all(summ["replica_counters"][r].get("serving.completed", 0) > 0
               for r in ("r0", "r1"))
