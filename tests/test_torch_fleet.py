"""The port's serving fleet (``alink_tpu_torch.serving.fleet`` and
``fleet_frontend``, with ``common/faults.py``, ``common/elastic.py``'s
``BackpressureController``, ``parallel/distributed.py``'s env scrub and
rule ALK110), held against ``alink_tpu`` on the CPU.

Units, both packages on the same inputs:

- ``FaultSpec``: the replica kinds, ``match=`` on one incarnation, a seeded
  rate schedule that fires at the same calls in both;
- ``_validate_hb_stats`` on the reference's garbage and on a real payload;
  the port's ``launches`` and ``gpu_mem`` blocks (non-negative ints and
  numbers) on garbage of their own;
- the frames (written by either package, read by the other), the error
  codec, and the front end's failover, typed errors, draining redirects,
  deadline and malformed-frame cases against fake replicas on loopback,
  each case run through both packages' front ends with the same outcome;
- ALK110's modes; ``scrub_cluster_env``; ``BackpressureController``'s
  decisions on one scripted signal, equal call for call.

The live fleet: one module-scoped 2-replica fleet serves a LogisticRegression
pipeline fitted by the port (its rows bitwise the single-process
``ModelServer``'s: the scorer pads each block up the bucket ladder) and a
pipeline fitted and saved by ``alink_tpu`` (rows within
tests/test_torch_serving.py's tolerances of the reference's
``LocalPredictor``: labels equal, the regression column within 1e-5,
detail probabilities within 1e-6); no new batch shape after the sidecar
warmup; the summary, the gauges and ``/api/serving``'s ``fleet`` block;
the frame front door; garbage on the control port; a swap and a resync; a
drain under load. Drills, each on a fleet of its own with fast heartbeats:
kill mid-batch (no accepted request lost, the respawn warms from the
sidecar with no new shape), hang (detected, killed, replaced), refuse-health
(unrouted, the data plane still answers), then on the same fleet autoscale
down (the unhealthy replica retired first) and up into the flap breaker,
and a replica asked for a card it cannot reach (the start raises, nothing
is left running). Every wait decides on an event (a state,
a counter, a generation) under a generous deadline; no test bounds a wall
time. Workers run with one intra-op thread.
"""

import json
import pickle
import socket
import threading
import time
import urllib.request

import numpy as np
import pytest

SCHEMA = "f0 double, f1 double, f2 double, f3 double"
FEATS = ["f0", "f1", "f2", "f3"]
NUMERIC_ATOL = 1e-5
PROB_ATOL = 1e-6
WAIT_S = 90.0
WORKER_ENV = {"OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}
PACKAGES = ("alink_tpu", "alink_tpu_torch")


@pytest.fixture(scope="module", autouse=True)
def _cpu():
    """For the whole module: the port on the CPU, in this process and, by
    the env the fleets hand down, in every replica."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("ALINK_TORCH_DEVICE", "cpu")
        mp.delenv("ALINK_VALIDATE_PLAN", raising=False)
        mp.delenv("ALINK_FAULT_SPEC", raising=False)
        mp.delenv("ALINK_SHAPE_BUCKETS", raising=False)
        yield


def _mod(pkg, name):
    import importlib

    return importlib.import_module(f"{pkg}.{name}")


def _counter(name):
    from alink_tpu_torch.common.metrics import metrics

    return metrics.counter(name)


def _wait(pred, timeout=WAIT_S, interval=0.05):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(interval)
    return False


def _fleet(**kw):
    from alink_tpu_torch.serving import FleetConfig, ServingFleet

    env = dict(WORKER_ENV, **kw.pop("worker_env", {}))
    kw.setdefault("heartbeat_s", 0.2)
    kw.setdefault("heartbeat_timeout_s", 10.0)
    kw.setdefault("hang_grace_s", 30.0)
    return ServingFleet(FleetConfig(worker_env=env, **kw))


def _data(seed, n_per=20):
    rng = np.random.default_rng(seed)
    X = np.concatenate([rng.normal(c, 0.8, size=(n_per, 4))
                        for c in (0.0, 1.5)])
    y = np.repeat([0, 1], n_per)
    yr = X @ np.array([0.5, -1.0, 2.0, 0.25]) + 1.0
    return X, {**{f"f{i}": X[:, i] for i in range(4)}, "label": y, "y": yr}


def _probs(row):
    d = json.loads(row[-1])
    return np.asarray([d[k] for k in sorted(d)])


# ---------------------------------------------------------------------------
# models and the shared fleet
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def fitted(tmp_path_factory):
    """A LogisticRegression pipeline fitted by the port, saved to .ak."""
    from alink_tpu_torch.common.mtable import MTable
    from alink_tpu_torch.operator.batch import TableSourceBatchOp
    from alink_tpu_torch.pipeline import LogisticRegression, Pipeline

    X, cols = _data(0)
    model = Pipeline(LogisticRegression(
        featureCols=FEATS, labelCol="label", predictionCol="pred",
        predictionDetailCol="detail")).fit(TableSourceBatchOp(MTable(cols)))
    path = str(tmp_path_factory.mktemp("fleet") / "lr.ak")
    model.save(path)
    return X, path


@pytest.fixture(scope="module")
def serial_rows(fitted):
    """Single-process ground truth: the port's ModelServer, one request at
    a time. Its load writes the warmup sidecar every replica warms from."""
    from alink_tpu_torch.serving import ModelServer

    X, path = fitted
    srv = ModelServer()
    srv.load("m", path, SCHEMA, warmup_rows=[tuple(X[0])])
    rows = [tuple(r) for r in X]
    serial = [srv.predict("m", r) for r in rows]
    srv.close()
    return rows, serial


@pytest.fixture(scope="module")
def jax_model(tmp_path_factory):
    """LinearRegression then LogisticRegression, fitted and saved by
    alink_tpu; the reference LocalPredictor's rows; a sidecar written by
    the port's server."""
    from alink_tpu.common.mtable import MTable
    from alink_tpu.operator.batch import TableSourceBatchOp
    from alink_tpu.pipeline import (LinearRegression, LocalPredictor,
                                    LogisticRegression, Pipeline)
    from alink_tpu_torch.serving import ModelServer

    X, cols = _data(3)
    model = Pipeline(
        LinearRegression(featureCols=FEATS, labelCol="y",
                         predictionCol="yhat"),
        LogisticRegression(featureCols=FEATS, labelCol="label",
                           predictionCol="pred",
                           predictionDetailCol="detail"),
    ).fit(TableSourceBatchOp(MTable(cols)))
    path = str(tmp_path_factory.mktemp("fleet_jax") / "m.ak")
    model.save(path)
    rows = [tuple(r) for r in X]
    lp = LocalPredictor(path, SCHEMA)
    out = lp.predict_table(MTable.from_rows(rows, lp.input_schema))
    want = [tuple(out.get_row(i)) for i in range(out.num_rows)]
    srv = ModelServer()
    srv.load("w", path, SCHEMA, warmup_rows=rows[:4])
    srv.close()
    return rows, path, want


@pytest.fixture(scope="module")
def fleet2(fitted, serial_rows, jax_model):
    """One 2-replica fleet shared by the fault-free tests; its replicas
    record no span (tests/test_torch_fleet_tracing.py traces a fleet)."""
    _, path = fitted
    fleet = _fleet(replicas=2, worker_env={"ALINK_TRACING": "off"})
    fleet.start()
    fleet.load("m", path, SCHEMA)
    fleet.load("jax", jax_model[1], SCHEMA)
    yield fleet
    fleet.stop()


# ---------------------------------------------------------------------------
# units against the reference
# ---------------------------------------------------------------------------


def test_replica_fault_kinds_target_one_incarnation_like_reference():
    labels = ["r0.g1.batch", "r1.g3.batch", "r1.g2.batch", "r1.g2.batch",
              "r1.g2.heartbeat"]
    seen = {}
    for pkg in PACKAGES:
        faults = _mod(pkg, "common.faults")
        spec = faults.FaultSpec.parse(
            "replica:count=1,kinds=kill_mid_batch,match=r1.g2.batch")
        out = []
        for lab in labels:
            try:
                spec.fire("replica", label=lab)
                out.append(None)
            except faults.InjectedReplicaFault as e:
                out.append(e.behavior)
        seen[pkg] = out
        assert faults.REPLICA_BEHAVIORS == (
            "kill_mid_batch", "hang", "refuse_health")
    assert seen["alink_tpu_torch"] == seen["alink_tpu"] == [
        None, None, "kill_mid_batch", None, None]


@pytest.mark.parametrize("spec", [
    "replica:rate=0.3,kinds=hang", "publish:rate=0.5,kinds=crash",
    "io:rate=0.2;replica:count=2,kinds=refuse_health"])
def test_seeded_fault_schedule_equals_reference(spec):
    """The same spec and seed fire at the same calls in both packages
    (a per-point RNG seeded from the seed and the point's name)."""
    fired = {}
    for pkg in PACKAGES:
        faults = _mod(pkg, "common.faults")
        s = faults.FaultSpec.parse(spec, seed=7)
        out = []
        for i in range(60):
            for point in ("replica", "publish", "io"):
                try:
                    s.fire(point, label=f"x{i}")
                    out.append(0)
                except Exception as e:  # noqa: BLE001 — the kind is compared
                    out.append(type(e).__name__)
        fired[pkg] = out
    assert fired["alink_tpu_torch"] == fired["alink_tpu"]
    assert any(fired["alink_tpu"])


@pytest.mark.parametrize("spec", ["replica:count=1,kinds=no_such_behavior",
                                  "replica", "replica:count"])
def test_bad_fault_specs_raise_like_reference(spec):
    for pkg in PACKAGES:
        faults = _mod(pkg, "common.faults")
        exc = _mod(pkg, "common.exceptions")
        with pytest.raises(exc.AkParseErrorException):
            faults.FaultSpec.parse(spec)


def test_env_fault_spec_installs_and_clears(monkeypatch):
    from alink_tpu_torch.common import faults

    monkeypatch.setenv("ALINK_FAULT_SPEC", "publish:count=1,kinds=fatal")
    with pytest.raises(faults.InjectedFatalError):
        faults.maybe_fail("publish", "epoch1.pre_blob")
    faults.maybe_fail("publish", "epoch1.pre_blob")   # count=1: spent
    faults.clear()
    monkeypatch.delenv("ALINK_FAULT_SPEC")
    assert faults.active() is None
    faults.maybe_fail("publish", "epoch1.pre_blob")


_HB_GARBAGE = [
    "not-a-dict",
    {"accepted": "NaN-ish-garbage"},
    {"queue_s": "not-a-dict"},
    {"queue_s": {"count": "x"}},
    {"synced": [1, 2, 3]},
]
_HB_PORT_GARBAGE = [
    {"launches": [12]},
    {"launches": {"flash_block_update": -1}},
    {"launches": {"flash_block_update": 1.5}},
    {"launches": {"flash_block_update": True}},
    {"launches": {3: 1}},
    {"gpu_mem": {"allocated": -5}},
    {"gpu_mem": "lots"},
]


@pytest.mark.parametrize("garbage", _HB_GARBAGE)
def test_validate_hb_stats_rejects_garbage_like_reference(garbage):
    for pkg in PACKAGES:
        fleet = _mod(pkg, "serving.fleet")
        with pytest.raises((ValueError, TypeError)):
            fleet._validate_hb_stats(garbage)


@pytest.mark.parametrize("garbage", _HB_PORT_GARBAGE)
def test_validate_hb_stats_rejects_bad_launches(garbage):
    from alink_tpu_torch.serving.fleet import _validate_hb_stats

    with pytest.raises(ValueError):
        _validate_hb_stats(garbage)


def test_validate_hb_stats_accepts_real_payload_in_both():
    payload = {
        "accepted": 3, "completed": 3, "shed": 0, "queued": 0,
        "jit_trace": 8, "trace_delta": 0, "batches": 2,
        "queue_s": {"count": 3, "sum": 0.01},
        "request_s": {"count": 3, "sum": 0.02, "p50": 0.005},
        "synced": {"m": 1},
        "launches": {"flash_block_update": 24, "tree_histogram": 0},
        "gpu_mem": {"allocated": 1 << 30, "max_allocated": 3 << 30},
    }
    for pkg in PACKAGES:
        out = _mod(pkg, "serving.fleet")._validate_hb_stats(dict(payload))
        assert out == payload


def test_frames_cross_packages_bitwise():
    """A frame written by either package reads back in the other as the
    same objects, numpy scalars included."""
    row = (np.float64(0.1) + np.float64(0.2), np.int64(3), "x", None,
           float("inf"))
    op = {"op": "predict", "name": "m", "row": row, "trace": None}
    for w, r in (PACKAGES, PACKAGES[::-1]):
        a, b = socket.socketpair()
        try:
            _mod(w, "serving.fleet_frontend").send_frame(a, op)
            got = _mod(r, "serving.fleet_frontend").recv_frame(b)
        finally:
            a.close()
            b.close()
        assert pickle.dumps(got) == pickle.dumps(op)
        assert type(got["row"][0]) is np.float64


def test_frame_refuses_torch_tensors_and_oversized_prefix():
    import torch

    from alink_tpu_torch.serving.fleet_frontend import (MAX_FRAME_BYTES,
                                                        recv_frame,
                                                        send_frame)

    a, b = socket.socketpair()
    try:
        with pytest.raises(TypeError, match="torch"):
            send_frame(a, {"op": "predict", "row": (torch.ones(2),)})
        # nothing was sent: the next frame reads clean
        send_frame(a, {"op": "ping"})
        assert recv_frame(b) == {"op": "ping"}
        a.sendall((MAX_FRAME_BYTES + 1).to_bytes(4, "big"))
        with pytest.raises(ConnectionError):
            recv_frame(b)
    finally:
        a.close()
        b.close()


def test_error_codec_like_reference():
    names = ("AkServingOverloadException", "AkCircuitOpenException",
             "AkDeadlineExceededException", "AkIllegalArgumentException",
             "AkIllegalStateException", "AkIllegalOperationException",
             "AkIllegalDataException", "AkExecutionErrorException")
    for pkg in PACKAGES:
        fe = _mod(pkg, "serving.fleet_frontend")
        exc = _mod(pkg, "common.exceptions")
        for n in names:
            wire = fe.encode_error(getattr(exc, n)("why"))
            assert wire["ok"] is False and wire["etype"] == n
            assert type(fe.decode_error(wire)) is getattr(exc, n)
        other = fe.decode_error(fe.encode_error(KeyError("k")))
        assert type(other) is exc.AkExecutionErrorException
        assert "KeyError" in str(other)


class _FakeReplica:
    """In-thread frame-protocol server of one package with a scriptable
    handler, which returns a response dict or raises ``ConnectionError`` to
    slam the connection shut."""

    def __init__(self, pkg, rid, handler):
        self.fe = _mod(pkg, "serving.fleet_frontend")
        self.rid = rid
        self.handler = handler
        self.calls = 0
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.bind(("127.0.0.1", 0))
        self._sock.listen(8)
        _mod(pkg, "common.resilience").CircuitBreaker.replace_endpoint(
            f"fleet:{rid}", failure_threshold=3, reset_timeout=30.0)
        self.client = self.fe.ReplicaClient(rid, "127.0.0.1",
                                            self._sock.getsockname()[1])
        threading.Thread(target=self._accept, daemon=True).start()

    def _accept(self):
        while True:
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            threading.Thread(target=self._serve, args=(conn,),
                             daemon=True).start()

    def _serve(self, conn):
        try:
            while True:
                op = self.fe.recv_frame(conn)
                self.calls += 1
                try:
                    self.fe.send_frame(conn, self.handler(op))
                except ConnectionError:
                    conn.close()
                    return
        except (ConnectionError, OSError, EOFError):
            conn.close()

    def close(self):
        self._sock.close()
        self.client.close()


def _frontend_case(pkg, case):
    """Run one front-end scenario through ``pkg``'s front end; returns what
    the caller saw: the values or the error type's name, the calls each
    fake took, and whether failovers were counted."""
    fe_mod = _mod(pkg, "serving.fleet_frontend")
    exc = _mod(pkg, "common.exceptions")
    metrics = _mod(pkg, "common.metrics").metrics

    def die(op):
        raise ConnectionError("boom")

    handlers = {
        "failover": [die, lambda op: {"ok": True, "value": "A"}],
        "typed": [lambda op: fe_mod.encode_error(
            exc.AkServingOverloadException("queue full"))] * 2,
        "draining": [lambda op: {"ok": False, "etype": fe_mod.DRAINING,
                                 "msg": ""},
                     lambda op: {"ok": True, "value": "B"}],
        "malformed": [lambda op: "not-a-dict",
                      lambda op: {"ok": True, "value": "C"}],
        "none": [],
    }[case]
    fakes = [_FakeReplica(pkg, f"fx-{pkg}-{case}-{i}", h)
             for i, h in enumerate(handlers)]
    before = metrics.counters().get("fleet.failovers", 0)
    try:
        fe = fe_mod.FleetFrontend(lambda: [(f.rid, f.client) for f in fakes])
        out = []
        for _ in range(4 if case != "typed" else 1):
            try:
                out.append(fe.predict("m", (1.0,), timeout=20.0))
            except exc.AkException as e:
                out.append(type(e).__name__)
        failovers = metrics.counters().get("fleet.failovers", 0) - before
        return out, [f.calls for f in fakes], failovers > 0
    finally:
        for f in fakes:
            f.close()


@pytest.mark.parametrize("case,want", [
    ("failover", ["A"] * 4),
    ("typed", ["AkServingOverloadException"]),
    ("draining", ["B"] * 4),
    ("malformed", ["C"] * 4),
    ("none", ["AkServingOverloadException"] * 4),
])
def test_frontend_cases_like_reference(case, want):
    got = {pkg: _frontend_case(pkg, case) for pkg in PACKAGES}
    out, calls, failed_over = got["alink_tpu_torch"]
    assert out == want
    assert got["alink_tpu"][0] == out
    # round robin starts on the same replica in both, so the same fakes
    # take the same calls
    assert got["alink_tpu"][1] == calls
    assert got["alink_tpu"][2] == failed_over
    if case == "typed":
        assert sum(calls) == 1 and not failed_over   # no failover
    if case in ("failover", "malformed"):
        assert calls[0] >= 1 and failed_over


@pytest.mark.parametrize("pkg", PACKAGES)
def test_frontend_deadline_expires_typed(pkg):
    exc = _mod(pkg, "common.exceptions")

    def stall(op):
        time.sleep(2.0)   # past the socket budget: never answers in time
        return {"ok": True, "value": "late"}

    slow = _FakeReplica(pkg, f"fx-{pkg}-slow", stall)
    try:
        fe = _mod(pkg, "serving.fleet_frontend").FleetFrontend(
            lambda: [(slow.rid, slow.client)])
        with pytest.raises((exc.AkDeadlineExceededException,
                            exc.AkServingOverloadException)):
            fe.predict("m", (1.0,), timeout=0.3)
    finally:
        slow.close()


@pytest.mark.parametrize("mode,recovery", [
    ("off", False), ("warn", False), ("warn", True), ("error", True)])
def test_alk110_modes_like_reference(monkeypatch, tmp_path, fitted,
                                     serial_rows, mode, recovery):
    """The same files in both packages: a bare blob has no sidecar (a
    warning, an error with recovery, refused under error), a model whose
    sidecar the serial fixture wrote is clean; ``off`` skips."""
    blob = tmp_path / "bare.ak"
    blob.write_bytes(b"x")
    monkeypatch.setenv("ALINK_VALIDATE_PLAN", mode)
    seen = {}
    for pkg in PACKAGES:
        an = _mod(pkg, "analysis")
        exc = _mod(pkg, "common.exceptions")
        good = an.preflight_fleet_models([("m", fitted[1])],
                                         recovery=recovery)
        if mode == "error":
            with pytest.raises(exc.AkPlanValidationException):
                an.preflight_fleet_models([("m", str(blob))],
                                          recovery=recovery)
            seen[pkg] = ("raised", good.ok)
            continue
        report = an.preflight_fleet_models([("m", str(blob))],
                                           recovery=recovery)
        if mode == "off":
            assert report is None and good is None
            seen[pkg] = None
            continue
        d = report.diagnostics[0]
        seen[pkg] = (report.by_rule(), d.severity, len(report.errors()),
                     good.ok)
    assert seen["alink_tpu_torch"] == seen["alink_tpu"]
    if mode == "warn":
        assert seen["alink_tpu_torch"] == (
            {"ALK110": 1}, "error" if recovery else "warning",
            int(recovery), True)


def test_scrub_cluster_env_like_reference():
    from alink_tpu.parallel.distributed import scrub_cluster_env as ref
    from alink_tpu_torch.parallel.distributed import (CLUSTER_ENV_KEYS,
                                                      scrub_cluster_env)

    env = {"COORDINATOR_ADDRESS": "h:1", "NUM_PROCESSES": "2",
           "PROCESS_ID": "0", "PATH": "/bin", "ALINK_FLEET_REPLICAS": "2",
           "CUDA_VISIBLE_DEVICES": "0"}
    torch_env = {"MASTER_ADDR": "h", "MASTER_PORT": "29500", "RANK": "3",
                 "WORLD_SIZE": "8", "LOCAL_RANK": "3",
                 "LOCAL_WORLD_SIZE": "8", "GROUP_RANK": "0",
                 "TORCHELASTIC_RUN_ID": "job", "TORCHELASTIC_RESTART_COUNT":
                 "1"}
    assert scrub_cluster_env(env) == ref(env) == {
        "PATH": "/bin", "ALINK_FLEET_REPLICAS": "2",
        "CUDA_VISIBLE_DEVICES": "0"}
    assert scrub_cluster_env({**env, **torch_env}) == ref(env)
    assert set(torch_env) - {"TORCHELASTIC_RUN_ID",
                             "TORCHELASTIC_RESTART_COUNT"} \
        <= set(CLUSTER_ENV_KEYS)


@pytest.mark.parametrize("wall", [False, True])
def test_backpressure_controller_decides_like_reference(wall):
    """One scripted signal through both controllers (hysteresis, patience,
    cooldown, bounds, the flap breaker): the same decision at every epoch,
    the same breaker state, the same suppressed-decision count."""
    rng = np.random.default_rng(11)
    sched = list(rng.choice([0.0, 0.2, 1.0, 3.0], size=80))
    decisions, aborted = {}, {}
    for pkg in PACKAGES:
        el = _mod(pkg, "common.elastic")
        metrics = _mod(pkg, "common.metrics").metrics
        a0 = metrics.counters().get("recovery.rescale_aborted", 0)
        kw = {} if wall else {"lag_fn": lambda st: sched[st["epoch"]]}
        ctl = el.BackpressureController(
            0.5, high=1.5, low=0.5, patience=2, cooldown_epochs=1,
            flap_window=12, max_flips=3, **kw)
        p, out = 2, []
        for e in range(len(sched)):
            t = ctl.observe({"epoch": e, "wall_s": sched[e] * 2, "chunks": 2,
                             "parallelism": p, "min_parallelism": 1,
                             "max_parallelism": 8})
            out.append(t)
            p = t or p
        decisions[pkg] = (out, ctl.breaker_open)
        aborted[pkg] = metrics.counters().get(
            "recovery.rescale_aborted", 0) - a0
    assert decisions["alink_tpu_torch"] == decisions["alink_tpu"]
    assert aborted["alink_tpu_torch"] == aborted["alink_tpu"]
    assert any(decisions["alink_tpu"][0])
    el = _mod("alink_tpu_torch", "common.elastic")
    exc = _mod("alink_tpu_torch", "common.exceptions")
    with pytest.raises(exc.AkIllegalArgumentException):
        el.BackpressureController(1.0, high=0.5, low=0.5)


def test_fleet_config_env_knobs(monkeypatch):
    from alink_tpu_torch.serving import FleetConfig

    for k, v in (("REPLICAS", "3"), ("AUTOSCALE", "1"),
                 ("MIN_REPLICAS", "2"), ("MAX_REPLICAS", "8"),
                 ("HEARTBEAT_S", "0.1"), ("HEARTBEAT_TIMEOUT_S", "0.9"),
                 ("HANG_GRACE_S", "2.5"), ("RESPAWN", "0"),
                 ("TARGET_QUEUE_S", "0.2"), ("WORKER_LOG", "/tmp/w")):
        monkeypatch.setenv(f"ALINK_FLEET_{k}", v)
    cfg = FleetConfig.default()
    assert (cfg.replicas, cfg.autoscale, cfg.min_replicas,
            cfg.max_replicas) == (3, True, 2, 8)
    assert (cfg.heartbeat_s, cfg.heartbeat_timeout_s, cfg.hang_grace_s,
            cfg.respawn, cfg.target_queue_s, cfg.worker_log_dir) == \
        (0.1, 0.9, 2.5, False, 0.2, "/tmp/w")


# ---------------------------------------------------------------------------
# the live fleet
# ---------------------------------------------------------------------------


def test_fleet_rows_bitwise_single_process(fleet2, serial_rows):
    rows, serial = serial_rows
    got = [fleet2.predict("m", r) for r in rows]
    assert got == serial
    assert fleet2.predict_many("m", rows[:16]) == serial[:16]
    assert pickle.dumps(got) == pickle.dumps(serial)


def test_fleet_rows_match_reference_local_predictor(fleet2, jax_model):
    """A pipeline alink_tpu fitted and saved, served by the port's fleet,
    against the reference's LocalPredictor on the same rows."""
    rows, _, want = jax_model
    got = fleet2.predict_many("jax", rows)
    got += [fleet2.predict("jax", r) for r in rows[:6]]
    want = want + want[:6]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        assert g[5] == w[5]                                  # the label
        assert g[4] == pytest.approx(w[4], abs=NUMERIC_ATOL)  # yhat
        np.testing.assert_array_equal(np.asarray(g[:4], float),
                                      np.asarray(w[:4], float))
        np.testing.assert_allclose(_probs(g), _probs(w), rtol=0,
                                   atol=PROB_ATOL)


def test_fleet_zero_trace_and_live_heartbeat_payload(fleet2, serial_rows):
    """Traffic after the sidecar warmup meets no new batch shape on either
    replica; the replicas' real heartbeat payloads (kernel launches, the
    batches served) pass the validator of both packages."""
    from alink_tpu.serving.fleet import _validate_hb_stats as ref_validate
    from alink_tpu_torch.native.kernels import KERNELS
    from alink_tpu_torch.serving.fleet import _validate_hb_stats

    rows, serial = serial_rows
    for r, want in zip(rows[:8], serial[:8]):
        assert fleet2.predict("m", r) == want
    before = {r["replica"]: r["batches"] or 0
              for r in fleet2.fleet_summary()["replicas"]}
    fleet2.predict_many("m", rows[8:24])

    def served():
        reps = fleet2.fleet_summary()["replicas"]
        return sum((r["batches"] or 0) - before[r["replica"]]
                   for r in reps) >= 1
    assert _wait(served)
    summary = fleet2.fleet_summary()
    assert summary["states"] == {"ready": 2}
    for r in summary["replicas"]:
        assert r["trace_delta"] == 0 and r["device"] == "cpu"
        assert r["ready_s"] is not None and r["ready_s"] > 0
        assert set(r["launches"]) == set(KERNELS)
        assert all(v == 0 for v in r["launches"].values())   # the CPU
        assert r["gpu_mem"] == {}
    for rep in fleet2._replicas.values():
        payload = dict(rep.hb_stats)
        assert _validate_hb_stats(payload) == payload
        assert ref_validate(payload) == payload


def test_fleet_tracing_off_relays_no_span(fleet2, serial_rows,
                                         monkeypatch):
    """Tracing off in the supervisor and the replicas: the same bits as
    the single-process server, no span recorded, none relayed."""
    from alink_tpu_torch.common.tracing import tracer

    rows, serial = serial_rows
    monkeypatch.setenv("ALINK_TRACING", "off")
    n0 = len(tracer.spans())
    ingested = _counter("fleet.spans_ingested")
    done0 = sum(r["completed"] or 0
                for r in fleet2.fleet_summary()["replicas"])
    assert [fleet2.predict("m", r) for r in rows[:16]] == serial[:16]
    assert fleet2.predict_many("m", rows[:8]) == serial[:8]
    assert _wait(lambda: sum(r["completed"] or 0 for r in
                             fleet2.fleet_summary()["replicas"])
                 >= done0 + 24)
    assert len(tracer.spans()) == n0
    assert _counter("fleet.spans_ingested") == ingested


def test_fleet_load_requires_saved_path(fleet2):
    from alink_tpu_torch.common.exceptions import AkIllegalArgumentException

    with pytest.raises(AkIllegalArgumentException):
        fleet2.load("bad", object())


def test_fleet_summary_gauges_and_webui(fleet2, tmp_path):
    from alink_tpu_torch.common.metrics import metrics
    from alink_tpu_torch.serving import ModelServer, serving_summary
    from alink_tpu_torch.serving.fleet import active_fleet_summary
    from alink_tpu_torch.webui import ExperimentStore, WebUIServer

    assert active_fleet_summary() is not None
    out = serving_summary()
    assert out["fleet"]["states"].get("ready") == 2
    assert set(out["fleet"]["breakers"]) >= {"fleet:r0", "fleet:r1"}
    assert set(out["fleet"]["desired_models"]) == {"m", "jax"}
    text = metrics.export_prometheus()
    assert 'alink_fleet_replicas{state="ready"} 2.0' in text
    assert 'alink_fleet_replicas{state="dead"} 0.0' in text

    srv = ModelServer()
    web = WebUIServer(port=0, store=ExperimentStore(
        str(tmp_path / "exp.json")), model_server=srv)
    web.start(background=True)
    try:
        def get(path):
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{web.port}{path}", timeout=60) as r:
                return r.read().decode()
        api = json.loads(get("/api/serving"))
        scrape = get("/metrics")
    finally:
        web.stop()
        srv.close()
    assert api["fleet"]["states"] == {"ready": 2}
    assert [r["replica"] for r in api["fleet"]["replicas"]] == ["r0", "r1"]
    assert 'alink_fleet_replicas{state="ready"} 2.0' in scrape


def test_frontdoor_serves_frame_protocol(fleet2, serial_rows):
    from alink_tpu_torch.serving.fleet_frontend import recv_frame, send_frame

    rows, serial = serial_rows
    lsn = fleet2.open_frontdoor()
    try:
        sock = socket.create_connection((lsn.host, lsn.port), timeout=30)
        send_frame(sock, {"op": "ping"})
        assert recv_frame(sock) == {"ok": True, "value": True}
        send_frame(sock, {"op": "predict", "name": "m", "row": rows[0]})
        resp = recv_frame(sock)
        assert resp["ok"] and tuple(resp["value"]) == serial[0]
        send_frame(sock, {"op": "predict_many", "name": "m",
                          "rows": rows[:3]})
        assert recv_frame(sock)["value"] == serial[:3]
        send_frame(sock, {"op": "predict", "name": "nope", "row": rows[0]})
        resp = recv_frame(sock)
        assert resp["ok"] is False \
            and resp["etype"] == "AkIllegalArgumentException"
        sock.close()
    finally:
        lsn.close()


def test_control_port_garbage_never_crashes_supervisor(fleet2, serial_rows):
    rows, serial = serial_rows
    before = _counter("fleet.bad_heartbeat")
    addr = ("127.0.0.1", fleet2._control_port)
    for payload in (b"\x00\xffgarbage-bytes\n", b"[1, 2, 3]\n",
                    json.dumps({"t": "hello", "token": "wrong",
                                "rid": "r0", "gen": 1}).encode() + b"\n"):
        s = socket.create_connection(addr, timeout=30)
        s.sendall(payload)
        s.close()
    assert _wait(lambda: _counter("fleet.bad_heartbeat") >= before + 3)
    assert fleet2.replica_states() == {"r0": "ready", "r1": "ready"}
    assert fleet2.predict("m", rows[0]) == serial[0]


def test_fleet_swap_bump_and_resync(fleet2, fitted):
    _, path = fitted
    out = fleet2.load("m2", path, SCHEMA)
    assert all(r["ok"] and r["warmup_source"] == "sidecar"
               for r in out["replicas"].values())
    assert set(out["replicas"]) == {"r0", "r1"}
    seq = out["seq"]
    assert all(r["synced"].get("m2") == seq
               for r in fleet2.fleet_summary()["replicas"])
    # a replica that missed the broadcast re-syncs from the bound source
    rep = fleet2._replicas["r1"]
    rep.synced["m2"] = -1
    pulled = []
    fleet2.bind_model_source("m2", lambda: pulled.append(1) or path)
    resyncs = _counter("fleet.resyncs")
    fleet2._resync_if_stale(rep)
    assert rep.synced["m2"] == seq and pulled == [1]
    assert _counter("fleet.resyncs") == resyncs + 1
    assert fleet2.unload("m2") and not fleet2.has_model("m2")


def test_drain_under_load_completes_all_accepted(fleet2, serial_rows):
    """Decommission r1 while clients are mid-flight: every request
    completes (drained or redirected, never lost); scale_to then restores
    the fleet with a fresh replica that loaded every desired model."""
    rows, serial = serial_rows
    lost, done = [], []
    go = threading.Event()

    def client(cid):
        go.wait(30)
        for i in range(20):
            k = (cid * 20 + i) % len(rows)
            try:
                assert fleet2.predict("m", rows[k], timeout=60) == serial[k]
                done.append(k)
            except Exception as e:  # noqa: BLE001 — every loss is reported
                lost.append(f"{type(e).__name__}: {e}")

    threads = [threading.Thread(target=client, args=(c,)) for c in range(4)]
    drains = _counter("fleet.drains")
    redirects = _counter("fleet.drain_redirects")
    for th in threads:
        th.start()
    go.set()
    assert fleet2.decommission("r1")
    for th in threads:
        th.join(timeout=WAIT_S)
        assert not th.is_alive()
    assert not lost, lost[:3]
    assert len(done) == 80
    assert _counter("fleet.drains") == drains + 1
    assert _counter("fleet.drain_redirects") >= redirects
    assert fleet2.replica_states() == {"r0": "ready"}

    fleet2.scale_to(2)
    states = fleet2.replica_states()
    assert len(states) == 2 and set(states.values()) == {"ready"}
    new = next(r for r in fleet2.fleet_summary()["replicas"]
               if r["replica"] != "r0")
    assert new["replica"] == "r2" and new["gen"] == 3
    assert {ld["model"]: ld["warmup_source"] for ld in new["loads"]} == \
        {"m": "sidecar", "jax": "sidecar"}
    assert [fleet2.predict("m", r) for r in rows[:12]] == serial[:12]


# ---------------------------------------------------------------------------
# drills (their own fleets: faults are armed through worker_env)
# ---------------------------------------------------------------------------


def test_kill_mid_batch_failover_never_loses_requests(fitted, serial_rows):
    """r1's first incarnation dies inside its first batch; every accepted
    request completes bit-identically or sheds with a typed error; the
    respawn (same id, next generation) warms from the sidecar and meets no
    new batch shape under traffic."""
    from alink_tpu_torch.common.exceptions import (
        AkCircuitOpenException, AkDeadlineExceededException,
        AkServingOverloadException)

    _, path = fitted
    rows, serial = serial_rows
    deaths = _counter("fleet.replica_deaths")
    failovers = _counter("fleet.failovers")
    with _fleet(replicas=2, worker_env={
            "ALINK_FAULT_SPEC":
            "replica:count=1,kinds=kill_mid_batch,match=r1.g2.batch"}) \
            as fleet:
        fleet.load("m", path, SCHEMA)
        lost, shed, done = [], [], []

        def client(cid):
            for i in range(12):
                k = (cid * 12 + i) % len(rows)
                try:
                    done.append((k, fleet.predict("m", rows[k], timeout=60)))
                except (AkServingOverloadException, AkCircuitOpenException,
                        AkDeadlineExceededException) as e:
                    shed.append(type(e).__name__)
                except Exception as e:  # noqa: BLE001 — a lost request
                    lost.append(f"{type(e).__name__}: {e}")

        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(4)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=WAIT_S)
            assert not th.is_alive()
        assert not lost, lost[:3]
        assert len(done) + len(shed) == 48
        assert all(serial[k] == v for k, v in done)
        assert _counter("fleet.failovers") > failovers
        # the monitor notices the death on its next pass
        assert _wait(lambda: _counter("fleet.replica_deaths") == deaths + 1)

        def recovered():
            reps = fleet.fleet_summary()["replicas"]
            return [r["gen"] for r in reps] == [1, 3] and all(
                r["state"] == "ready" for r in reps)
        assert _wait(recovered)
        for r in rows[:12]:                      # traffic on the respawn
            fleet.predict("m", r)
        summary = fleet.fleet_summary()
        respawned = summary["replicas"][1]
        assert respawned["replica"] == "r1"
        assert [ld["warmup_source"] for ld in respawned["loads"]] \
            == ["sidecar"]
        assert _wait(lambda: all(
            r["trace_delta"] == 0 and (r["completed"] or 0) > 0
            for r in fleet.fleet_summary()["replicas"]))
        assert summary["counters"]["fleet.respawns"] >= 1
        assert [fleet.predict("m", r) for r in rows[:12]] == serial[:12]


def test_hang_detected_then_replaced(fitted, serial_rows):
    """A hung replica (alive, silent on heartbeats and the data plane) is
    marked unhealthy, killed past the hang grace and respawned, while the
    healthy replica keeps serving."""
    _, path = fitted
    rows, serial = serial_rows
    hung0 = _counter("fleet.hung_killed")
    with _fleet(replicas=2, heartbeat_timeout_s=1.5, hang_grace_s=2.0,
                worker_env={"ALINK_FAULT_SPEC":
                            "replica:count=1,kinds=hang,"
                            "match=r1.g2.heartbeat"}) as fleet:
        fleet.load("m", path, SCHEMA)
        deadline = time.monotonic() + WAIT_S
        while time.monotonic() < deadline:
            assert fleet.predict("m", rows[0], timeout=60) == serial[0]
            if _counter("fleet.hung_killed") > hung0 and \
                    fleet.fleet_summary()["states"].get("ready") == 2:
                break
            time.sleep(0.1)
        assert _counter("fleet.hung_killed") == hung0 + 1
        summary = fleet.fleet_summary()
        assert summary["states"] == {"ready": 2}
        assert summary["replicas"][1]["gen"] == 3


def test_refuse_health_then_autoscale(fitted, serial_rows):
    """refuse_health stops r1's heartbeats only: it goes unhealthy
    (unrouted), is not killed (the grace is long), and its data plane
    still answers. Then a scripted lag schedule through the shared
    controller: idle scales 2 → 1 and retires the unhealthy replica
    first, backlog scales 1 → 2, and the next reversal opens the flap
    breaker, which then holds."""
    _, path = fitted
    rows, serial = serial_rows
    schedule = {1: 0.0, 2: 1.0, 3: 0.0, 4: 0.0}
    up0 = _counter("fleet.autoscale_up")
    down0 = _counter("fleet.autoscale_down")
    with _fleet(replicas=2, heartbeat_timeout_s=1.5, hang_grace_s=3600.0,
                autoscale=True, min_replicas=1, max_replicas=2,
                autoscale_interval_s=3600.0, autoscale_patience=1,
                autoscale_cooldown=0, max_flips=2,
                lag_fn=lambda stats: schedule.get(stats["epoch"], 0.0),
                worker_env={"ALINK_FAULT_SPEC":
                            "replica:count=1,kinds=refuse_health,"
                            "match=r1.g2.heartbeat"}) as fleet:
        fleet.load("m", path, SCHEMA)
        assert _wait(lambda: fleet.replica_states().get("r1")
                     == "unhealthy")
        assert [rid for rid, _ in fleet._routable()] == ["r0"]
        assert [fleet.predict("m", r) for r in rows[:8]] == serial[:8]
        rep = fleet._replicas["r1"]
        assert rep.proc.poll() is None
        resp = rep.client.call({"op": "ping"}, timeout=30.0)
        assert resp["ok"] and resp["value"]["rid"] == "r1"
        resp = rep.client.call({"op": "predict", "name": "m",
                                "row": rows[1], "deadline_s": 30.0},
                               timeout=30.0)
        assert resp["ok"] and resp["value"] == serial[1]

        assert fleet._autoscale_tick() == 1
        assert fleet.replica_states() == {"r0": "ready"}
        assert _counter("fleet.autoscale_down") == down0 + 1
        assert fleet._autoscale_tick() == 2
        states = fleet.replica_states()
        assert states == {"r0": "ready", "r2": "ready"}
        assert _counter("fleet.autoscale_up") == up0 + 1
        assert fleet._autoscale_tick() is None
        assert fleet.fleet_summary()["autoscale"]["breaker_open"]
        assert fleet._autoscale_tick() is None
        assert fleet.replica_states() == states
        assert fleet.predict("m", rows[2]) == serial[2]


def test_replica_without_its_card_fails_start(monkeypatch):
    """Asked for the card on a host without one, the replica reports why
    instead of its ready; the start raises with that reason, respawns
    nothing, and leaves no process or thread behind. It never serves on
    the CPU."""
    from alink_tpu_torch.common.exceptions import AkIllegalStateException

    fleet = _fleet(replicas=1, worker_env={"ALINK_TORCH_DEVICE": "cuda"})
    spawned = _counter("fleet.spawned")
    with pytest.raises(AkIllegalStateException, match="no CUDA device"):
        fleet.start()
    assert _counter("fleet.spawned") == spawned + 1
    assert fleet.replica_states() == {}
    assert fleet._closing and not any(t.is_alive() for t in fleet._threads)
