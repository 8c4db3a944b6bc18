"""The port's epoch recovery runtime (``common/recovery.py``, the checkpoint
tiers of ``operator/stream/checkpoint.py``) and the model-stream publisher at
its barrier, held against ``alink_tpu`` on the CPU: the cases of
``tests/test_recovery.py`` and ``tests/test_modelstream_publish.py`` whose
jobs need no windows (those wait for the port's ``windows.py``).

The drill job: one seeded source (features, a label and a precomputed
score detail) fanned out to three chains — FTRL → a DataHub sink, OnlineFm
→ a base64 encoder of the model tensors → a Kafka sink, and
EvalBinaryClass → a KV sink keyed by window. Checks:
- every crash drill (a mid-stream chunk, the 2PC window, before a
  snapshot, a seeded random schedule) leaves the three sinks bit-identical
  to the port's fault-free run;
- the port's fault-free sinks decode to the reference's fault-free run of
  the same job: FTRL and OnlineFm arrays within RTOL = 1e-5 of their
  largest entry (the packages' float arithmetic differs in the last bits;
  tests/test_torch_online.py), metas equal, the KV eval rows equal;
- the publisher publishes every epoch, a crash at each of its four sites
  republishes bit-identically, and ALK104/ALK109 report as in the
  reference.
"""

import base64
import importlib
import json
import os

import numpy as np
import pytest

RTOL = 1e-5
PACKAGES = ("alink_tpu", "alink_tpu_torch")
SCHEMA = "x0 DOUBLE, x1 DOUBLE"
ROW = [0.3, 0.7]


@pytest.fixture(scope="module", autouse=True)
def _cpu():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("ALINK_TORCH_DEVICE", "cpu")
        mp.delenv("ALINK_FAULT_SPEC", raising=False)
        mp.delenv("ALINK_RETRIES", raising=False)
        mp.delenv("ALINK_MODELSTREAM_KEEP", raising=False)
        mp.delenv("ALINK_MODELSTREAM_MIN_EPOCH_S", raising=False)
        yield


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


P = "alink_tpu_torch"


# ---------------------------------------------------------------------------
# snapshot store, markers, txn targets (both packages, same contract)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pkg", PACKAGES)
def test_snapshot_store_roundtrip_and_retention(pkg, tmp_path):
    store = _mod(pkg, "common.recovery").SnapshotStore(str(tmp_path / "ck"),
                                                       keep=2)
    for e in range(5):
        store.write_snapshot(e, {"source_offset": (e + 1) * 4},
                             {"operators": {"op": {"v": e}}, "sinks": {}})
        store.retain(min_committed_epoch=e)
    assert store.epochs() == [3, 4]
    epoch, manifest, blob = store.load_latest()
    assert epoch == 4 and manifest["source_offset"] == 20
    assert blob["operators"]["op"] == {"v": 4}
    assert sorted(os.listdir(tmp_path / "ck")) == [
        "epoch-000000000003.blob", "epoch-000000000003.json",
        "epoch-000000000004.blob", "epoch-000000000004.json"]


def test_snapshot_files_equal_across_packages(tmp_path):
    """The same snapshot writes the same manifest and blob bytes."""
    data = {}
    for pkg in PACKAGES:
        store = _mod(pkg, "common.recovery").SnapshotStore(
            str(tmp_path / pkg), keep=3)
        store.write_snapshot(2, {"source_offset": 9, "epoch_chunks": 3},
                             {"operators": {"a": [1, 2]}, "sinks": {}})
        store.write_sink_marker("kafka:b/t", 2)
        data[pkg] = {n: open(tmp_path / pkg / n, "rb").read()
                     for n in sorted(os.listdir(tmp_path / pkg))}
    assert data["alink_tpu"] == data[P]


@pytest.mark.parametrize("pkg", PACKAGES)
def test_snapshot_store_skips_crash_debris(pkg, tmp_path):
    store = _mod(pkg, "common.recovery").SnapshotStore(str(tmp_path / "ck"),
                                                       keep=3)
    store.write_snapshot(0, {"source_offset": 4}, {"operators": {"a": 1},
                                                   "sinks": {}})
    store.write_snapshot(1, {"source_offset": 8}, {"operators": {"a": 2},
                                                   "sinks": {}})
    with open(tmp_path / "ck" / "epoch-000000000001.blob", "wb") as f:
        f.write(b"\x00garbage")
    epoch, _, blob = store.load_latest()
    assert epoch == 0 and blob["operators"]["a"] == 1
    with open(tmp_path / "ck" / "epoch-000000000000.json", "w") as f:
        f.write('{"epo')
    assert store.load_latest() is None


def test_sink_marker_roundtrip(tmp_path):
    store = _mod(P, "common.recovery").SnapshotStore(str(tmp_path / "ck"))
    assert store.sink_marker("kafka:b/t") == -1
    store.write_sink_marker("kafka:b/t", 7)
    store.write_sink_marker("kv:m/x", 3)
    assert store.sink_marker("kafka:b/t") == 7
    assert store.sink_marker("kv:m/x") == 3


def test_crash_fault_kind_kills_but_is_restartable():
    faults = _mod(P, "common.faults")
    rec = _mod(P, "common.recovery")
    exc = _mod(P, "common.exceptions")
    spec = faults.FaultSpec.parse("recovery:count=1,kinds=crash,"
                                  "match=pre_commit")
    spec.fire("recovery", label="chunk0")
    with pytest.raises(faults.InjectedCrashError) as ei:
        spec.fire("recovery", label="epoch3.pre_commit")
    assert not exc.is_retryable(ei.value)
    assert rec.is_restartable(ei.value)
    spec.fire("recovery", label="epoch4.pre_commit")  # count spent


@pytest.mark.parametrize("pkg", PACKAGES)
def test_memory_targets_txn_commit_is_idempotent(pkg):
    b = _mod(pkg, "io.kafka").MemoryKafkaBroker.named(f"txn-idem-{pkg}")
    assert b.produce_txn("t", [b"a", b"b"], "sink1", epoch=0)
    assert not b.produce_txn("t", [b"a", b"b"], "sink1", epoch=0)
    assert b.produce_txn("t", [b"c"], "sink1", epoch=1)
    assert not b.produce_txn("t", [b"zzz"], "sink1", epoch=1)
    assert b._topics["t"] == [b"a", b"b", b"c"]
    assert b.txn_epoch("sink1") == 1 and b.txn_epoch("other") == -1
    svc = _mod(pkg, "io.datahub").MemoryDatahubService.named(
        f"txn-idem-{pkg}")
    assert svc.put_records_txn("t", [(1, "a")], "s", epoch=0)
    assert not svc.put_records_txn("t", [(1, "a")], "s", epoch=0)
    assert svc._topics["t"] == [(1, "a")]


def test_job_validation():
    S = _mod(P, "operator.stream")
    rec = _mod(P, "common.recovery")
    exc = _mod(P, "common.exceptions")
    t = _mod(P, "common.mtable").MTable({"v": np.arange(4.0)})
    src = S.TableSourceStreamOp(t)
    sink = S.KafkaSinkStreamOp(bootstrapServers="memory://val", topic="t")
    with pytest.raises(exc.AkIllegalArgumentException):
        rec.RecoverableStreamJob(src, [], checkpoint_dir="/tmp/x")
    with pytest.raises(exc.AkIllegalArgumentException):
        rec.RecoverableStreamJob(src, [([], [])], checkpoint_dir="/tmp/x")
    with pytest.raises(exc.AkIllegalArgumentException):
        rec.RecoverableStreamJob(
            src, [([], [sink]),
                  ([], [S.KafkaSinkStreamOp(bootstrapServers="memory://val",
                                            topic="t")])],
            checkpoint_dir="/tmp/x")
    with pytest.raises(exc.AkIllegalArgumentException):
        rec.RecoverableStreamJob(src, [([], [src])], checkpoint_dir="/tmp/x")
    with pytest.raises(exc.AkIllegalArgumentException):
        rec.run_with_recovery(
            rec.RecoverableStreamJob(src, [([], [sink])], checkpoint_dir="/t"))
    # an op that keeps cross-chunk state without snapshot hooks is refused
    with pytest.raises(exc.AkIllegalArgumentException, match="state_snapshot"):
        rec.RecoverableStreamJob(
            S.TableSourceStreamOp(t),
            [([S.SummarizerStreamOp()], [sink])], checkpoint_dir="/tmp/x")


# ---------------------------------------------------------------------------
# legacy journal tier
# ---------------------------------------------------------------------------


def test_stream_checkpoint_reset_missing_journal_is_noop(tmp_path):
    S = _mod(P, "operator.stream")
    path = str(tmp_path / "job.ckpt")
    ck = S.StreamCheckpoint(path)
    ck.reset()
    ck.ack(4)
    assert ck.last_acked() == 4
    with open(path + ".tmp", "w") as f:
        f.write("stale")
    ck.reset()
    assert ck.last_acked() == -1 and not os.path.exists(path + ".tmp")
    ck.reset()


def test_checkpointed_source_counts_replays_and_restores(tmp_path):
    S = _mod(P, "operator.stream")
    metrics = _mod(P, "common.metrics").metrics
    t = _mod(P, "common.mtable").MTable.from_rows([(i,) for i in range(10)],
                                                  "v long")
    state = str(tmp_path / "job.ckpt")
    S.StreamCheckpoint(state).ack(2)
    r0 = metrics.counter("checkpoint.replayed_chunks")
    s0 = metrics.counter("checkpoint.restores")
    ck = S.StreamCheckpoint(state)
    src = S.CheckpointedSourceStreamOp(S.TableSourceStreamOp(t, chunkSize=2),
                                       ck)
    ack = S.AckCheckpointStreamOp(ck).link_from(src)
    assert [tuple(c.col("v")) for c in ack._stream()] == [(6, 7), (8, 9)]
    assert metrics.counter("checkpoint.replayed_chunks") - r0 == 3
    assert metrics.counter("checkpoint.restores") - s0 == 1
    assert ck.last_acked() == 4


# ---------------------------------------------------------------------------
# the crash-restart drill
# ---------------------------------------------------------------------------


def _b64(t):
    """Model rows with their tensors as base64 of the raw bytes (a Kafka
    JSON message carries no arrays)."""
    return type(t)({
        "key": np.asarray(t.col("key"), object),
        "json": np.asarray(t.col("json"), object),
        "tensor": np.asarray(
            [base64.b64encode(np.ascontiguousarray(a).tobytes()).decode()
             for a in t.col("tensor")], object)})


def _drill_cols(n=200):
    rng = np.random.RandomState(0)
    x0, x1 = rng.rand(n), rng.rand(n)
    label = (rng.rand(n) < 1 / (1 + np.exp(-(3 * x0 - 2 * x1)))) \
        .astype(np.int64)
    score = np.clip(0.5 * x0 + 0.3 * (1 - x1) + 0.2 * rng.rand(n), 0, 1)
    detail = np.asarray([json.dumps({"1": float(s), "0": float(1 - s)})
                         for s in score], object)
    return {"x0": x0, "x1": x1, "label": label, "detail": detail,
            "ys": label.astype(str).astype(object)}


def _drill_job(pkg, tag, ckdir):
    S = _mod(pkg, "operator.stream")
    base = _mod(pkg, "operator.stream.base")
    rec = _mod(pkg, "common.recovery")
    t = _mod(pkg, "common.mtable").MTable(_drill_cols())
    ftrl = S.FtrlTrainStreamOp(featureCols=["x0", "x1"], labelCol="label",
                               modelSaveInterval=5)
    fm = S.OnlineFmTrainStreamOp(featureCols=["x0", "x1"], labelCol="label",
                                 numFactor=3, modelSaveInterval=5)
    ev = S.EvalBinaryClassStreamOp(labelCol="ys", predictionDetailCol="detail",
                                   positiveLabelValueString="1")
    return rec.RecoverableStreamJob(
        source=S.TableSourceStreamOp(t, chunkSize=10),
        chains=[
            ([ftrl], [S.DatahubSinkStreamOp(endpoint=f"memory://dr-{tag}",
                                            topic="m")]),
            ([fm, base._FuncStreamOp(_b64)],
             [S.KafkaSinkStreamOp(bootstrapServers=f"memory://dr-{tag}",
                                  topic="f")]),
            ([ev], [S.KvSinkStreamOp(storeUri=f"memory://dr-{tag}",
                                     keyCol="WindowId")]),
        ],
        checkpoint_dir=ckdir, epoch_chunks=3)


def _drill_outputs(pkg, tag):
    models = [tuple(x.tobytes() if isinstance(x, np.ndarray) else x
                    for x in r)
              for r in _mod(pkg, "io.datahub").MemoryDatahubService.named(
                  f"dr-{tag}")._topics.get("m", [])]
    kafka = list(_mod(pkg, "io.kafka").MemoryKafkaBroker.named(
        f"dr-{tag}")._topics.get("f", []))
    kv = {k: dict(v) for k, v in _mod(pkg, "io.kv").MemoryKvStore._named
          .get(f"dr-{tag}", {}).items() if not k.startswith("__alink_txn__")}
    return models, kafka, kv


def _run_drill(pkg, tag, tmp_path, spec=None, seed=3, attempts=10):
    faults = _mod(pkg, "common.faults")
    rec = _mod(pkg, "common.recovery")
    res = _mod(pkg, "common.resilience")
    faults.clear()
    if spec:
        faults.install(faults.FaultSpec.parse(spec, seed=seed))
    try:
        summary = rec.run_with_recovery(
            lambda: _drill_job(pkg, tag, str(tmp_path / f"ck-{tag}")),
            res.RetryPolicy(max_attempts=attempts, base_delay=0.001))
    finally:
        faults.clear()
    return summary, _drill_outputs(pkg, tag)


@pytest.fixture(scope="module")
def clean(tmp_path_factory):
    base = tmp_path_factory.mktemp("drill-clean")
    return {pkg: _run_drill(pkg, f"clean-{pkg}", base) for pkg in PACKAGES}


def _close(a, b, key):
    assert a.shape == b.shape, key
    if not b.size:      # the meta row's empty tensor
        return
    scale = max(np.abs(b).max(), 1e-30)
    assert np.abs(a - b).max() <= RTOL * scale, (key, np.abs(a - b).max())


def test_clean_drill_matches_reference(clean):
    (sp, (pm, pk, pkv)), (sr, (rm, rk, rkv)) = clean[P], clean["alink_tpu"]
    assert sp["complete"] and sp["epochs"] == sr["epochs"] == 7
    # FTRL models on DataHub: (key, json, tensor bytes) rows
    assert len(pm) == len(rm) == 12
    for a, b in zip(pm, rm):
        assert a[:2] == b[:2]
        _close(np.frombuffer(a[2], np.float32), np.frombuffer(b[2], np.float32),
               a[0])
    # OnlineFm models on Kafka: JSON messages with base64 tensors
    assert len(pk) == len(rk) == 16
    for a, b in zip(pk, rk):
        ja, jb = json.loads(a), json.loads(b)
        assert ja["key"] == jb["key"] and ja["json"] == jb["json"]
        _close(np.frombuffer(base64.b64decode(ja["tensor"]), np.float32),
               np.frombuffer(base64.b64decode(jb["tensor"]), np.float32),
               ja["key"])
    # the cumulative eval's windows in the KV store: equal
    assert pkv == rkv and len(pkv) == 21


@pytest.mark.parametrize("spec,tag", [
    ("recovery:count=1,kinds=crash,match=chunk13", "c-chunk"),
    ("recovery:count=1,kinds=crash,match=epoch2.pre_commit", "c-commit"),
    ("recovery:count=1,kinds=crash,match=epoch4.pre_snapshot", "c-snap"),
    ("recovery:rate=0.04,kinds=crash", "c-rand"),
])
def test_crash_drill_bit_identical(clean, tmp_path, spec, tag):
    rand = tag == "c-rand"
    summary, got = _run_drill(P, tag, tmp_path, spec,
                              seed=4 if rand else 3,
                              attempts=40 if rand else 10)
    assert summary["complete"] is True
    assert got == clean[P][1]
    if tag == "c-chunk":
        assert summary["restored"] and 0 < summary["replayed_chunks"] < 20
    if tag == "c-commit":
        assert summary["restored"] and summary["sink_replays"] == 3
    if tag == "c-snap":
        assert summary["restored"]


def test_fatal_fault_propagates_without_restart(tmp_path):
    faults = _mod(P, "common.faults")
    rec = _mod(P, "common.recovery")
    res = _mod(P, "common.resilience")
    calls = []
    faults.clear()
    faults.install(faults.FaultSpec.parse("recovery:count=1,kinds=fatal"))
    try:
        with pytest.raises(faults.InjectedFatalError):
            rec.run_with_recovery(
                lambda: _drill_job(P, "fatal", str(tmp_path / "ck-f")),
                res.RetryPolicy(max_attempts=10, base_delay=0.001),
                sleep=calls.append)
    finally:
        faults.clear()
    assert calls == []


def test_completed_job_restart_is_noop(tmp_path):
    rec = _mod(P, "common.recovery")
    res = _mod(P, "common.resilience")
    _, first = _run_drill(P, "done", tmp_path)
    summary = rec.run_with_recovery(
        lambda: _drill_job(P, "done", str(tmp_path / "ck-done")),
        res.RetryPolicy(max_attempts=3, base_delay=0.001))
    assert summary["complete"] is True and summary["epochs"] == 0
    assert _drill_outputs(P, "done") == first


def test_retries_off_disables_supervised_restarts(tmp_path, monkeypatch):
    faults = _mod(P, "common.faults")
    rec = _mod(P, "common.recovery")
    res = _mod(P, "common.resilience")
    monkeypatch.setenv("ALINK_RETRIES", "off")
    faults.clear()
    faults.install(faults.FaultSpec.parse(
        "recovery:count=1,kinds=crash,match=chunk3"))
    try:
        with pytest.raises(faults.InjectedCrashError):
            rec.run_with_recovery(
                lambda: _drill_job(P, "roff", str(tmp_path / "ck-roff")),
                res.RetryPolicy(max_attempts=10, base_delay=0.001))
    finally:
        faults.clear()


def _eval_job(ckdir, k, topic_tag):
    S = _mod(P, "operator.stream")
    rec = _mod(P, "common.recovery")
    t = _mod(P, "common.mtable").MTable(
        {k2: v[:40] for k2, v in _drill_cols().items()})
    ev = S.EvalBinaryClassStreamOp(labelCol="ys", predictionDetailCol="detail",
                                   positiveLabelValueString="1")
    sink = S.KafkaSinkStreamOp(bootstrapServers=f"memory://{topic_tag}",
                               topic="t")
    return rec.RecoverableStreamJob(S.TableSourceStreamOp(t, chunkSize=5),
                                    [([ev], [sink])], checkpoint_dir=ckdir,
                                    epoch_chunks=k)


def test_txn_markers_are_job_scoped(tmp_path):
    rec = _mod(P, "common.recovery")
    res = _mod(P, "common.resilience")
    broker = _mod(P, "io.kafka").MemoryKafkaBroker.named("scoped")
    rec.run_with_recovery(lambda: _eval_job(str(tmp_path / "a"), 2, "scoped"),
                          res.RetryPolicy(max_attempts=2, base_delay=0.001))
    n_a = len(broker._topics.get("t", []))
    assert n_a > 0
    rec.run_with_recovery(lambda: _eval_job(str(tmp_path / "b"), 2, "scoped"),
                          res.RetryPolicy(max_attempts=2, base_delay=0.001))
    assert len(broker._topics.get("t", [])) == 2 * n_a


def test_epoch_chunks_change_is_fenced(tmp_path):
    faults = _mod(P, "common.faults")
    rec = _mod(P, "common.recovery")
    res = _mod(P, "common.resilience")
    exc = _mod(P, "common.exceptions")
    faults.clear()
    faults.install(faults.FaultSpec.parse(
        "recovery:count=1,kinds=crash,match=chunk5"))
    try:
        with pytest.raises(faults.InjectedCrashError):
            rec.CheckpointCoordinator(
                _eval_job(str(tmp_path / "ck"), 2, "fence")).run()
    finally:
        faults.clear()
    with pytest.raises(exc.AkIllegalStateException, match="epoch_chunks"):
        rec.run_with_recovery(lambda: _eval_job(str(tmp_path / "ck"), 4,
                                                "fence"),
                              res.RetryPolicy(max_attempts=2,
                                              base_delay=0.001))


def test_recovery_summary_counters(tmp_path):
    rec = _mod(P, "common.recovery")
    _run_drill(P, "sum", tmp_path, "recovery:count=1,kinds=crash,match=chunk13")
    out = rec.recovery_summary()
    assert out.get("recovery.restarts", 0) >= 1
    assert out.get("recovery.epochs", 0) >= 1
    assert out.get("checkpoint.restores", 0) >= 1
    assert out.get("checkpoint.replayed_chunks", 0) >= 1
    assert "recovery.snapshot_s" in out and "recovery.restore_s" in out


def test_exports_match_reference():
    for mod in ("common", "operator.stream"):
        ref, port = _mod("alink_tpu", mod), _mod(P, mod)
        for name in ("RecoverableStreamJob", "run_with_recovery",
                     "CheckpointCoordinator", "SnapshotStore",
                     "TransactionalSink"):
            assert hasattr(port, name) and hasattr(ref, name), (mod, name)
    S = _mod(P, "operator.stream")
    for name in ("FtrlTrainStreamOp", "OnlineFmTrainStreamOp",
                 "EvalBinaryClassStreamOp", "SplitStreamOp",
                 "KafkaSourceStreamOp", "KafkaSinkStreamOp",
                 "DatahubSourceStreamOp", "DatahubSinkStreamOp",
                 "KvSinkStreamOp", "LookupKvStreamOp"):
        assert name in S.__all__
        ref_cls = getattr(_mod("alink_tpu", "operator.stream"), name)
        port_cls = getattr(S, name)
        ref_infos = {n: i.default for n, i in ref_cls.param_infos().items()}
        port_infos = {n: i.default for n, i in port_cls.param_infos().items()}
        assert port_infos == ref_infos, name


# ---------------------------------------------------------------------------
# the model-stream publisher at the barrier
# ---------------------------------------------------------------------------


def _pub_table(n=200, seed=7):
    rng = np.random.RandomState(seed)
    return _mod(P, "common.mtable").MTable({
        "x0": rng.rand(n), "x1": rng.rand(n),
        "label": (rng.rand(n) > 0.5).astype(np.int64)})


def _run_pub_job(base, tag, spec=None, op_factory=None, keep=10):
    S = _mod(P, "operator.stream")
    rec = _mod(P, "common.recovery")
    res = _mod(P, "common.resilience")
    faults = _mod(P, "common.faults")
    from alink_tpu_torch.modelstream import ModelStreamPublisher
    from alink_tpu_torch.serving import ModelServer

    server = ModelServer()
    pub = ModelStreamPublisher(os.path.join(base, f"store-{tag}"),
                               f"m-{tag}", server=server,
                               input_schema=SCHEMA, keep=keep)
    t = _pub_table()
    make = op_factory or (lambda: S.FtrlTrainStreamOp(
        featureCols=["x0", "x1"], labelCol="label", modelSaveInterval=5))

    def job():
        return rec.RecoverableStreamJob(
            source=S.TableSourceStreamOp(t, chunkSize=10),
            chains=[([make()],
                     [S.DatahubSinkStreamOp(endpoint=f"memory://msp-{tag}",
                                            topic="m")])],
            checkpoint_dir=os.path.join(base, f"ck-{tag}"),
            epoch_chunks=4, publishers=[pub])

    faults.clear()
    if spec:
        faults.install(faults.FaultSpec.parse(spec, seed=3))
    try:
        summary = rec.run_with_recovery(
            job, res.RetryPolicy(max_attempts=10, base_delay=0.001))
    finally:
        faults.clear()
    return summary, pub, server


def _blob_bytes(pub):
    return {e: open(pub.store.blob_path(e), "rb").read()
            for e in pub.store.versions()}


@pytest.fixture(scope="module")
def pub_clean(tmp_path_factory):
    base = str(tmp_path_factory.mktemp("pub-clean"))
    summary, pub, server = _run_pub_job(base, "clean")
    out = {"summary": summary, "pub": pub, "blobs": _blob_bytes(pub),
           "served": tuple(server.predict("m-clean", ROW))}
    server.close()
    return out


def test_publish_every_epoch_and_parity(pub_clean):
    from alink_tpu_torch.pipeline import LocalPredictor

    s, pub = pub_clean["summary"], pub_clean["pub"]
    assert s["complete"] and s["epochs"] == 6
    assert pub.store.versions() == list(range(s["epochs"]))
    epoch, manifest = pub.store.latest()
    assert epoch == s["epochs"] - 1 and manifest["epoch"] == epoch
    assert pub_clean["served"] == tuple(LocalPredictor(
        pub.store.blob_path(epoch), SCHEMA).predict_row(ROW))
    assert pub.summary()["swapped_epoch"] == epoch
    assert [p["epoch"] for p in pub.summary()["published"]] == \
        list(range(s["epochs"]))


@pytest.mark.parametrize("site", [
    "epoch0.pre_blob",
    "epoch2.pre_sidecar",
    "epoch3.pre_manifest",
    "epoch1.pre_swap",
    "epoch5.pre_swap",          # the final epoch's complete manifest
])
def test_publish_crash_drill_bit_identical(tmp_path, pub_clean, site):
    tag = site.replace(".", "-")
    summary, pub, server = _run_pub_job(
        str(tmp_path), tag, spec=f"publish:count=1,kinds=crash,match={site}")
    try:
        assert summary["complete"]
        got = _blob_bytes(pub)
        assert sorted(got) == sorted(pub_clean["blobs"])
        for epoch, data in pub_clean["blobs"].items():
            assert got[epoch] == data, (site, epoch)
        epoch, _ = pub.store.latest()
        assert epoch == pub_clean["summary"]["epochs"] - 1
        assert tuple(server.predict(f"m-{tag}", ROW)) == pub_clean["served"]
    finally:
        server.close()


def test_publish_online_fm_parity(tmp_path):
    from alink_tpu_torch.pipeline import LocalPredictor

    S = _mod(P, "operator.stream")
    summary, pub, server = _run_pub_job(
        str(tmp_path), "fm", op_factory=lambda: S.OnlineFmTrainStreamOp(
            featureCols=["x0", "x1"], labelCol="label", numFactor=4,
            modelSaveInterval=5))
    try:
        assert summary["complete"] and pub.store.versions()
        epoch, _ = pub.store.latest()
        assert tuple(server.predict("m-fm", ROW)) == tuple(LocalPredictor(
            pub.store.blob_path(epoch), SCHEMA).predict_row(ROW))
    finally:
        server.close()


def test_publisher_build_validation(tmp_path):
    S = _mod(P, "operator.stream")
    rec = _mod(P, "common.recovery")
    exc = _mod(P, "common.exceptions")
    from alink_tpu_torch.modelstream import ModelStreamPublisher

    pub = ModelStreamPublisher(str(tmp_path / "s"), "m", chain=3)
    with pytest.raises(exc.AkIllegalArgumentException, match="chain 3"):
        rec.RecoverableStreamJob(
            source=S.TableSourceStreamOp(_pub_table(), chunkSize=10),
            chains=[([S.FtrlTrainStreamOp(featureCols=["x0", "x1"],
                                          labelCol="label")],
                     [S.DatahubSinkStreamOp(endpoint="memory://msp-val",
                                            topic="m")])],
            checkpoint_dir=str(tmp_path / "ck"), epoch_chunks=4,
            publishers=[pub])


def _plan_rules(pkg, tmp_path, recovery):
    """ALK104/ALK109 findings on a hookless bound train op, a stateful
    unhooked op and a hooked FTRL op, in one package."""
    S = _mod(pkg, "operator.stream")
    base = _mod(pkg, "operator.stream.base")
    analysis = _mod(pkg, "analysis")
    pub_cls = _mod(pkg, "modelstream").ModelStreamPublisher

    class _NoHooksTrainOp(base.StreamOperator):
        def servable_model(self):  # pragma: no cover - never called
            return None

        def _stream_impl(self, chunks):
            return chunks

    op = _NoHooksTrainOp()
    out = [[(d.rule, d.severity)
            for d in analysis.validate_plan(op).diagnostics]]
    pub_cls(str(tmp_path / f"s-{pkg}"), "m").validate_target(op)
    out.append([(d.rule, d.severity) for d in analysis.validate_plan(
        op, recovery=recovery).diagnostics])
    summ = S.SummarizerStreamOp().link_from(S.TableSourceStreamOp(
        _mod(pkg, "common.mtable").MTable({"v": np.arange(4.0)}),
        chunkSize=3))
    out.append(sorted((d.rule, d.severity) for d in analysis.validate_plan(
        summ, recovery=recovery).diagnostics))
    hooked = S.FtrlTrainStreamOp(featureCols=["x0"], labelCol="label")
    pub_cls(str(tmp_path / f"s2-{pkg}"), "m").validate_target(hooked)
    out.append([(d.rule, d.severity) for d in analysis.validate_plan(
        hooked, recovery=recovery).diagnostics])
    return out


@pytest.mark.parametrize("recovery", [False, True])
def test_stream_plan_rules_alk104_alk109(tmp_path, recovery):
    port = _plan_rules(P, tmp_path, recovery)
    assert port == _plan_rules("alink_tpu", tmp_path, recovery)
    sev = "error" if recovery else "warning"
    assert port[0] == []
    assert port[1] == [("ALK109", sev)]
    # chunkSize=3 is off the bucket_rows ladder: ALK103 beside ALK104
    assert port[2] == [("ALK103", "warning"), ("ALK104", sev)]
    assert port[3] == []


def test_recovery_preflight_reports_before_refusing(tmp_path, monkeypatch):
    """Under ALINK_VALIDATE_PLAN=error the job build raises the structured
    ALK104 report before the per-op refusal."""
    S = _mod(P, "operator.stream")
    rec = _mod(P, "common.recovery")
    exc = _mod(P, "common.exceptions")
    monkeypatch.setenv("ALINK_VALIDATE_PLAN", "error")
    t = _mod(P, "common.mtable").MTable({"v": np.arange(4.0)})
    with pytest.raises(exc.AkPlanValidationException, match="ALK104"):
        rec.RecoverableStreamJob(
            S.TableSourceStreamOp(t, chunkSize=4),
            [([S.SummarizerStreamOp()],
              [S.KafkaSinkStreamOp(bootstrapServers="memory://pf",
                                   topic="t")])],
            checkpoint_dir=str(tmp_path / "ck"))
