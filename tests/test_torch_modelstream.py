"""The port's model-stream store and publisher
(``alink_tpu_torch.modelstream``), held against ``alink_tpu``'s on the CPU.

- The store: the same commits in both packages leave the same files with
  the same manifests; ``latest`` and ``versions``, retention of the last K,
  idempotent republish, torn debris (an orphan blob, a blob whose bytes no
  longer match its manifest, an unreadable manifest) skipped and counted
  once; a ``crash`` at each ``publish`` fault site leaves no version the
  reader surfaces, and the retry commits the same bytes; a path of a scheme
  without a filesystem driver raises, naming the missing driver.
- The publisher with a duck-typed fleet (the reference's own fleet test
  double): it binds its store's newest blob as the fleet's model source
  and counts each replica's swap outcome; both packages count alike.
- The publisher's two halves driven by hand (the coordinators that call
  them at epoch barriers are not ported): a model trained by each package
  is wrapped, committed with its warmup sidecar and swapped into that
  package's ``ModelServer``; the port's served rows equal its
  ``LocalPredictor`` on the committed blob, the reference's
  ``LocalPredictor`` reads the port's blob to the same rows (labels equal,
  probabilities within 1e-6), a second version swaps in with no new batch
  shape, and ``resume`` swaps the newest version into a fresh server; an
  FmModel stream publishes and serves the same way.
"""

import json
import os

import numpy as np
import pytest

SCHEMA = "x0 double, x1 double"
PACKAGES = ("alink_tpu", "alink_tpu_torch")
PROB_ATOL = 1e-6


@pytest.fixture(scope="module", autouse=True)
def _cpu():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("ALINK_TORCH_DEVICE", "cpu")
        mp.delenv("ALINK_FAULT_SPEC", raising=False)
        mp.delenv("ALINK_MODELSTREAM_KEEP", raising=False)
        mp.delenv("ALINK_MODELSTREAM_MIN_EPOCH_S", raising=False)
        yield


def _mod(pkg, name):
    import importlib

    return importlib.import_module(f"{pkg}.{name}")


def _counter(pkg, name):
    return _mod(pkg, "common.metrics").metrics.counter(name)


def _writer(payload):
    def write(path):
        with open(path, "wb") as f:
            f.write(payload)
    return write


def _listing(path):
    out = {}
    for name in sorted(os.listdir(path)):
        with open(os.path.join(path, name), "rb") as f:
            out[name] = f.read()
    return out


# ---------------------------------------------------------------------------
# the store
# ---------------------------------------------------------------------------


def _store_run(pkg, root):
    store = _mod(pkg, "modelstream").ModelStreamStore(root, keep=3)
    torn0 = _counter(pkg, "modelstream.torn_skipped")
    skip0 = _counter(pkg, "modelstream.republish_skipped")
    for epoch in range(5):
        store.publish(epoch, _writer(b"blob-%d" % epoch * 40),
                      write_sidecar=lambda b, s: _writer(b"{}")(s),
                      meta={"model": "m", "final": epoch == 4})
    store.publish(4, _writer(b"other"))          # idempotent by epoch
    after = (store.versions(), store.latest())
    with open(store.blob_path(7), "wb") as f:     # orphan blob
        f.write(b"torn")
    with open(store.blob_path(4), "ab") as f:     # bitrot under a manifest
        f.write(b"rot")
    with open(store.manifest_path(6), "w") as f:  # unreadable manifest
        f.write("{not json")
    torn = store.latest()
    store.latest()                                # counted once per epoch
    return dict(after=after, torn=torn, versions=store.versions(),
                files=_listing(root),
                torn_counted=_counter(pkg, "modelstream.torn_skipped")
                - torn0,
                skipped=_counter(pkg, "modelstream.republish_skipped")
                - skip0)


def test_store_commits_retains_and_skips_torn_like_reference(tmp_path):
    got = {pkg: _store_run(pkg, str(tmp_path / pkg)) for pkg in PACKAGES}
    assert got["alink_tpu_torch"] == got["alink_tpu"]
    run = got["alink_tpu_torch"]
    versions, (epoch, manifest) = run["after"]
    assert versions == [2, 3, 4] and epoch == 4      # keep=3
    assert manifest["blob"] == "v-000000000004.ak" and manifest["meta"] == {
        "model": "m", "final": True}
    assert manifest["sidecar"] == "v-000000000004.ak.warmup.json"
    assert run["files"]["v-000000000004.ak"].startswith(b"blob-4")
    assert not any(n.startswith("v-000000000001") for n in run["files"])
    assert run["torn"][0] == 3                        # 7, 6, 4 skipped
    assert run["torn_counted"] == 3 and run["skipped"] == 1
    assert run["versions"] == [2, 3, 4]


@pytest.mark.parametrize("site", ["pre_blob", "pre_sidecar",
                                  "pre_manifest"])
def test_crash_at_each_publish_site_like_reference(tmp_path, site):
    """A crash at the site leaves nothing the reader surfaces; the retry
    commits the same bytes a fault-free publish writes."""
    seen = {}
    for pkg in PACKAGES:
        faults = _mod(pkg, "common.faults")
        store = _mod(pkg, "modelstream").ModelStreamStore(
            str(tmp_path / pkg), keep=5)
        store.publish(0, _writer(b"v0"))
        faults.install(faults.FaultSpec.parse(
            f"publish:count=1,kinds=crash,match=epoch1.{site}"))
        try:
            with pytest.raises(faults.InjectedCrashError):
                store.publish(1, _writer(b"v1" * 99),
                              write_sidecar=lambda b, s: _writer(b"{}")(s))
        finally:
            faults.clear()
        torn = store.latest()[0]
        store.publish(1, _writer(b"v1" * 99),
                      write_sidecar=lambda b, s: _writer(b"{}")(s))
        seen[pkg] = (torn, store.latest()[0], store.versions(),
                     _listing(str(tmp_path / pkg)))
    assert seen["alink_tpu_torch"] == seen["alink_tpu"]
    assert seen["alink_tpu"][:3] == (0, 1, [0, 1])


def test_store_refuses_other_schemes_and_bad_keep(tmp_path):
    from alink_tpu_torch.common.exceptions import (
        AkIllegalArgumentException, AkPluginNotExistException)
    from alink_tpu_torch.modelstream import ModelStreamStore

    with pytest.raises(AkPluginNotExistException, match="driver"):
        ModelStreamStore("hdfs://nn:8020/models")
    with pytest.raises(AkIllegalArgumentException):
        ModelStreamStore(str(tmp_path / "s"), keep=0)
    with pytest.raises(AkIllegalArgumentException):
        ModelStreamStore("")
    store = ModelStreamStore("file://" + str(tmp_path / "f"))
    assert store.path == str(tmp_path / "f") and store.latest() is None


# ---------------------------------------------------------------------------
# the publisher
# ---------------------------------------------------------------------------


class _FakeFleet:
    """A fleet's duck type: bind_model_source, has_model, load with
    per-replica outcomes (one replica misses the swap)."""

    def __init__(self):
        self.sources, self.loads, self._config = {}, [], None

    def bind_model_source(self, name, resolver):
        self.sources[name] = resolver

    def has_model(self, name):
        return any(call[0] == name for call in self.loads)

    def load(self, name, path, schema, config=None):
        self.loads.append((name, path))
        return {"model": name, "seq": len(self.loads),
                "replicas": {"r0": {"ok": True},
                             "r1": {"ok": False, "error": "x"}}}


def test_publisher_with_duck_typed_fleet_like_reference(tmp_path):
    seen = {}
    for pkg in PACKAGES:
        ms = _mod(pkg, "modelstream")
        fleet = _FakeFleet()
        pub = ms.ModelStreamPublisher(str(tmp_path / pkg), "live",
                                      server=fleet, input_schema=SCHEMA)
        assert fleet.sources["live"]() is None      # nothing committed
        assert not pub._server_has_model()
        ok0 = _counter(pkg, "modelstream.fleet_swap_ok")
        miss0 = _counter(pkg, "modelstream.fleet_swap_missed")
        assert pub.swap_epoch(0) is False           # never committed
        pub.store.publish(0, _writer(b"blob"), meta={"model": "live"})
        assert pub.swap_epoch(0) is True
        assert pub._server_has_model()
        assert fleet.sources["live"]() == pub.store.blob_path(0)
        assert pub.resume() == 0                   # already swapped
        seen[pkg] = ([(n, os.path.basename(p)) for n, p in fleet.loads],
                     _counter(pkg, "modelstream.fleet_swap_ok") - ok0,
                     _counter(pkg, "modelstream.fleet_swap_missed") - miss0,
                     pub.summary()["versions"],
                     pub.summary()["swapped_epoch"])
    assert seen["alink_tpu_torch"] == seen["alink_tpu"] == (
        [("live", "v-000000000000.ak")], 1, 1, [0], 0)


def test_publisher_validates_its_target(tmp_path):
    from alink_tpu_torch.common.exceptions import AkIllegalArgumentException
    from alink_tpu_torch.modelstream import ModelStreamPublisher
    from alink_tpu_torch.serving import ModelServer

    pub = ModelStreamPublisher(str(tmp_path / "s"), "m")
    with pytest.raises(AkIllegalArgumentException, match="servable_model"):
        pub.validate_target(object())
    with pytest.raises(AkIllegalArgumentException, match="keyed"):
        pub.validate_target(object(), keyed=True)

    class Op:
        def servable_model(self):
            return None

    op = Op()
    pub.validate_target(op)
    assert op._modelstream_bound
    unready = _counter("alink_tpu_torch", "modelstream.unready")
    assert pub.publish_epoch(op, 0) is None
    assert _counter("alink_tpu_torch", "modelstream.unready") == unready + 1
    with pytest.raises(AkIllegalArgumentException, match="input_schema"):
        ModelStreamPublisher(str(tmp_path / "s2"), "m", server=ModelServer())


def _lr_table(pkg, seed):
    mt = _mod(pkg, "common.mtable")
    ob = _mod(pkg, "operator.batch")
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(60, 2))
    y = (X @ np.array([1.5, -1.0]) + rng.normal(0, 0.3, 60) > 0)
    return ob.LogisticRegressionTrainBatchOp(
        featureCols=["x0", "x1"], labelCol="label", maxIter=20).link_from(
        ob.TableSourceBatchOp(mt.MTable({"x0": X[:, 0], "x1": X[:, 1],
                                         "label": y.astype(np.int64)}))
    ).collect()


class _TrainOp:
    """A stream-train op's duck type: the model it would serve now."""

    def __init__(self, table):
        self.table = table

    def servable_model(self):
        return self.table


def test_publish_and_swap_into_model_server(tmp_path):
    from alink_tpu.pipeline import LocalPredictor as RefPredictor
    from alink_tpu_torch.common.metrics import metrics
    from alink_tpu_torch.modelstream import (ModelStreamPublisher,
                                             modelstream_summary)
    from alink_tpu_torch.pipeline import LocalPredictor
    from alink_tpu_torch.serving import ModelServer, load_warmup_spec

    rows = [(float(a), float(b)) for a, b in
            np.random.default_rng(9).normal(size=(12, 2))]
    server = ModelServer()
    pub = ModelStreamPublisher(str(tmp_path / "s"), "m", server=server,
                               input_schema=SCHEMA,
                               stage_params={"predictionCol": "pred",
                                             "predictionDetailCol": "d"})
    try:
        op = _TrainOp(_lr_table("alink_tpu_torch", 1))
        pub.validate_target(op)
        blob = pub.publish_epoch(op, 0)
        assert blob == pub.store.blob_path(0)
        assert load_warmup_spec(blob)["input_schema"] == SCHEMA
        assert pub.swap_epoch(0)
        served = server.predict_many("m", rows)
        assert served == [LocalPredictor(blob, SCHEMA).predict_row(r)
                          for r in rows]
        ref = RefPredictor(blob, SCHEMA)
        for got, want in zip(served, (ref.predict_row(r) for r in rows)):
            assert got[:3] == tuple(want[:3])
            d_got, d_want = json.loads(got[3]), json.loads(want[3])
            assert sorted(d_got) == sorted(d_want)
            assert all(abs(d_got[k] - d_want[k]) <= PROB_ATOL
                       for k in d_got)

        trace = metrics.counter("jit.trace")
        delta0 = metrics.counter("modelstream.swap_trace_delta")
        op.table = _lr_table("alink_tpu_torch", 2)
        pub.publish_epoch(op, 1, final=True)
        pub.swap_epoch(1, epoch_t0=0.0)
        assert metrics.counter("jit.trace") == trace
        assert metrics.counter("modelstream.swap_trace_delta") == delta0
        assert server.predict_many("m", rows) == [
            LocalPredictor(pub.store.blob_path(1), SCHEMA).predict_row(r)
            for r in rows]
        summ = pub.summary()
        assert summ["versions"] == [0, 1] and summ["swapped_epoch"] == 1
        assert [p["epoch"] for p in summ["published"]] == [0, 1]
        out = modelstream_summary()
        assert out["counters"]["modelstream.commits"] >= 2
        assert out["swap_s"]["count"] >= 2 and out["lag_s"]["count"] >= 1

        fresh = ModelServer()
        try:
            pub2 = ModelStreamPublisher(str(tmp_path / "s"), "m",
                                        server=fresh, input_schema=SCHEMA)
            assert pub2.resume() == 1
            assert fresh.predict_many("m", rows) == server.predict_many(
                "m", rows)
        finally:
            fresh.close()
    finally:
        server.close()


def test_publisher_refuses_unported_fm_stage(tmp_path):
    """The FM stage is ported: an FmModel stream publishes (wrapped in the
    FmModel stage, as the reference wraps it), swaps into the server and
    serves the rows of its committed blob; the reference's
    ``LocalPredictor`` reads that blob to the same labels."""
    from alink_tpu.pipeline import LocalPredictor as RefPredictor
    from alink_tpu_torch.common.mtable import MTable
    from alink_tpu_torch.modelstream import ModelStreamPublisher
    from alink_tpu_torch.operator.batch import (FmClassifierTrainBatchOp,
                                                TableSourceBatchOp)
    from alink_tpu_torch.pipeline import LocalPredictor
    from alink_tpu_torch.pipeline.pipeline import PipelineModel
    from alink_tpu_torch.serving import ModelServer

    rng = np.random.default_rng(3)
    X = rng.normal(size=(60, 2))
    y = (X @ np.array([1.5, -1.0]) > 0).astype(np.int64)
    table = FmClassifierTrainBatchOp(
        featureCols=["x0", "x1"], labelCol="label", numFactor=2,
        maxIter=10).link_from(TableSourceBatchOp(MTable(
            {"x0": X[:, 0], "x1": X[:, 1], "label": y}))).collect()
    rows = [(float(a), float(b)) for a, b in rng.normal(size=(8, 2))]
    server = ModelServer()
    pub = ModelStreamPublisher(str(tmp_path / "s"), "fm", server=server,
                               input_schema=SCHEMA,
                               stage_params={"predictionCol": "pred"})
    try:
        blob = pub.publish_epoch(_TrainOp(table), 0)
        assert [type(s).__name__ for s in
                PipelineModel.load(blob).stages] == ["FmModel"]
        assert pub.swap_epoch(0)
        served = server.predict_many("fm", rows)
        assert served == [LocalPredictor(blob, SCHEMA).predict_row(r)
                          for r in rows]
        ref = RefPredictor(blob, SCHEMA)
        assert [r[2] for r in served] == [ref.predict_row(r)[2]
                                          for r in rows]
    finally:
        server.close()