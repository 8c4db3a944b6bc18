"""The port's pipelined DAG engine (``alink_tpu_torch.common.executor``),
held against ``alink_tpu``'s on the CPU.

Every DAG of the reference's executor tests runs in both packages through
the same builder: multi-branch exactly-once, diamond, first-failure
propagation with branches in flight, sink-callback errors, re-collectable
after failure, the serial knob, fusion bit-identity, fusion stopping at a
shared intermediate, kernel-chain composition, pass-through columns, the
per-node trace and the fused marks. Results are equal across the packages
and the trace carries the same unit labels. A run's own trace records are
told apart from earlier runs' by identity (the trace is a 4,096-record
ring, so an index into it is not stable).

Port-side: the launch counter of the kernel registry stays exact when
threads launch concurrently; unit retries, defusion, serial degradation and
the sticky-CUDA-error rule; the node phases ``stream_map`` reports; the
plan pre-flight's rules (ALK101, ALK102, ALK103, ALK105, ALK106) give the
reference's codes and severities; and the slice as a whole — the BERT
evaluation DAG of ``chip_smoke.py`` phase 17 at a tiny size (filter,
split, a fused BERT + logistic-regression chain ending in a CSV sink on
``memory://``, a BERT branch on the side output) — gives the reference's
split rows, labels and probabilities within ``PROB_ATOL``, with fusion on,
fusion off and the serial walk exactly equal inside the port.
"""

import importlib
import json
import sys
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest

PROB_ATOL = 0.02   # tests/test_torch_bert_serving.py's bound on probabilities


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("ALINK_TORCH_DEVICE", "cpu")
    monkeypatch.delenv("ALINK_ATTN_PALLAS", raising=False)
    for knob in ("ALINK_DAG_SCHEDULER", "ALINK_DAG_FUSION", "ALINK_RETRIES",
                 "ALINK_VALIDATE_PLAN", "ALINK_FAULT_SPEC"):
        monkeypatch.delenv(knob, raising=False)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The models are tiny: one intra-op thread beats a pool that contends
    with the other test workers' pools."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ns(pkg: str) -> SimpleNamespace:
    mods = {k: importlib.import_module(f"{pkg}.{m}") for k, m in (
        ("batch", "operator.batch"), ("utils", "operator.batch.utils"),
        ("sql", "operator.sql"), ("mapper", "mapper.base"),
        ("metrics", "common.metrics"), ("mtable", "common.mtable"),
        ("faults", "common.faults"), ("env", "common.env"),
        ("analysis", "analysis"))}
    return SimpleNamespace(pkg=pkg, **mods)


PKGS = ("alink_tpu", "alink_tpu_torch")


def _new_records(ns, before):
    seen = {id(r) for r in before}
    return [r for r in ns.metrics.executor_trace() if id(r) not in seen]


def _affine_op(ns, col, out, a, b):
    """A row-wise kernel mapper op: out = col * a + b (fp32 on the device)."""

    class _M(ns.mapper.BlockKernelMapper):
        def kernel(self, schema):
            def fn(X):
                return X * np.float32(a) + np.float32(b)

            return ([col], [out], [ns.mtable.AlinkTypes.DOUBLE], fn)

    class _Op(ns.utils.MapBatchOp):
        mapper_cls = _M

    _Op.__name__ = f"Affine_{out}"
    return _Op()


def _table(ns, n=64, seed=0):
    rng = np.random.RandomState(seed)
    return ns.mtable.MTable({"x": rng.rand(n), "tag": np.asarray(
        [f"r{i}" for i in range(n)], object)})


def _cols(t):
    return {n: list(np.asarray(t.col(n)).tolist()) for n in t.names}


def _both(fn):
    """Run ``fn(ns)`` in each package; return {pkg: result}."""
    return {pkg: fn(_ns(pkg)) for pkg in PKGS}


def _clear_lazy(ns):
    ns.env.MLEnvironmentFactory.get_default().lazy_manager.clear()


# -- satellite: the launch counter ------------------------------------------


class _YieldingSpec:
    """A kernel record whose ``launches`` attribute hands the interpreter
    to another thread between the read and the write of an increment: an
    unlocked ``launches += 1`` loses counts on it."""

    def __init__(self):
        self._n = 0

    @property
    def launches(self):
        return self._n

    @launches.setter
    def launches(self, v):
        time.sleep(0)
        self._n = v


def test_launch_counter_exact_under_concurrent_threads(monkeypatch):
    from alink_tpu_torch.native import kernels

    spec = _YieldingSpec()
    monkeypatch.setitem(kernels.KERNELS, "flash_block_update", spec)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    threads, per = 8, 400
    try:
        workers = [threading.Thread(target=lambda: [
            kernels.count_launch("flash_block_update") for _ in range(per)])
            for _ in range(threads)]
        for w in workers:
            w.start()
        for w in workers:
            w.join()
    finally:
        sys.setswitchinterval(old)
    assert spec.launches == threads * per
    kernels.reset_launches()
    assert spec.launches == 0


# -- concurrent branch scheduling -------------------------------------------


def test_multi_branch_concurrent_and_exactly_once():
    """Two independent branches off one shared source: both run in wall
    clock < the serial sum, and the shared upstream computes exactly once."""
    SLEEP = 0.2

    def run(ns):
        calls = {"n": 0}
        lock = threading.Lock()

        class CountingSource(ns.batch.MemSourceBatchOp):
            def _execute_impl(self):
                with lock:
                    calls["n"] += 1
                return super()._execute_impl()

        src = CountingSource([(float(i),) for i in range(32)], "v double")

        def slow_branch(name):
            def work(t):
                time.sleep(SLEEP)
                return ns.mtable.MTable({name: np.asarray(t.col("v")) * 2.0})

            return src.apply_func(work, out_schema=f"{name} double")

        outs = {}
        before = ns.metrics.executor_trace()
        slow_branch("a").lazy_collect(lambda t: outs.setdefault("a", t))
        slow_branch("b").lazy_collect(lambda t: outs.setdefault("b", t))
        t0 = time.perf_counter()
        src.execute()
        wall = time.perf_counter() - t0
        assert set(outs) == {"a", "b"}
        assert calls["n"] == 1                       # shared upstream: once
        assert wall < 2 * SLEEP * 0.9                # branches overlapped
        labels = sorted(r["op"] for r in _new_records(ns, before))
        return _cols(outs["a"]), _cols(outs["b"]), labels

    got = _both(run)
    assert got["alink_tpu"] == got["alink_tpu_torch"]
    assert got["alink_tpu_torch"][2] == ["CountingSource", "_FuncOp",
                                         "_FuncOp"]


def test_diamond_dag_schedules_all_and_memoizes():
    def run(ns):
        src = ns.batch.TableSourceBatchOp(_table(ns))
        left = src.filter("x <= 0.5")
        right = src.filter("x > 0.5")
        out = ns.sql.UnionAllOp().link_from(left, right).collect()
        assert out.num_rows == 64
        assert left._executed and right._executed and src._executed
        return _cols(out)

    got = _both(run)
    assert got["alink_tpu"] == got["alink_tpu_torch"]


def test_exception_propagates_from_scheduled_branch():
    def run(ns):
        src = ns.batch.TableSourceBatchOp(_table(ns))

        def boom(t):
            raise RuntimeError("branch exploded")

        bad = src.apply_func(boom, out_schema="x double")
        with pytest.raises(RuntimeError, match="branch exploded"):
            bad.collect()

    _both(run)


def test_first_failure_propagates_with_branches_in_flight():
    """A fast-failing branch raises while a slow sibling is mid-flight:
    the original exception propagates unchanged (same instance), the
    in-flight future is drained, and the completed sink still fires."""
    def run(ns):
        src = ns.batch.TableSourceBatchOp(_table(ns))
        marker = RuntimeError("fast branch down")
        slow_done = threading.Event()

        def fail_fast(t):
            raise marker

        def slow(t):
            time.sleep(0.2)
            slow_done.set()
            return t

        bad = src.apply_func(fail_fast, out_schema="x double")
        ok = src.apply_func(slow, out_schema=_table(ns).schema.to_str())
        got = {}
        bad.lazy_collect(lambda t: got.setdefault("bad", t))
        ok.lazy_collect(lambda t: got.setdefault("ok", t))
        try:
            with pytest.raises(RuntimeError) as ei:
                src.execute()
            assert ei.value is marker
            assert slow_done.is_set() and ok._executed
            assert "bad" not in got
            return _cols(got["ok"])
        finally:
            _clear_lazy(ns)

    got = _both(run)
    assert got["alink_tpu"] == got["alink_tpu_torch"]


def test_sink_callback_error_does_not_mask_dag_failure():
    def run(ns):
        src = ns.batch.TableSourceBatchOp(_table(ns))
        marker = RuntimeError("real infrastructure failure")

        def fail(t):
            raise marker

        bad = src.apply_func(fail, out_schema="x double")
        ok1 = src.select(["x"])
        ok2 = src.select(["tag"])
        got = {}
        bad.lazy_collect(lambda t: got.setdefault("bad", t))
        ok1.lazy_collect(lambda t: (_ for _ in ()).throw(ValueError("cb")))
        ok2.lazy_collect(lambda t: got.setdefault("ok2", t))
        before = ns.metrics.metrics.counter("resilience.sink_callback_errors")
        try:
            with pytest.raises(RuntimeError) as ei:
                src.execute()
            assert ei.value is marker
            assert ns.metrics.metrics.counter(
                "resilience.sink_callback_errors") > before
            return _cols(got["ok2"])
        finally:
            _clear_lazy(ns)

    got = _both(run)
    assert got["alink_tpu"] == got["alink_tpu_torch"]


def test_failed_run_leaves_dag_recollectable_without_recompute():
    def run(ns):
        calls = {"src": 0, "flaky": 0}
        lock = threading.Lock()

        class CountingSource(ns.batch.MemSourceBatchOp):
            def _execute_impl(self):
                with lock:
                    calls["src"] += 1
                return super()._execute_impl()

        src = CountingSource([(float(i),) for i in range(16)], "v double")

        def flaky_once(t):
            with lock:
                calls["flaky"] += 1
                n = calls["flaky"]
            if n == 1:
                raise ValueError("transient-looking but fatal")
            return ns.mtable.MTable({"v": np.asarray(t.col("v")) * 2.0})

        good = src.apply_func(
            lambda t: ns.mtable.MTable({"v": np.asarray(t.col("v")) + 1.0}),
            out_schema="v double")
        bad = good.apply_func(flaky_once, out_schema="v double")
        with pytest.raises(ValueError):
            bad.collect()
        assert calls["src"] == 1 and good._executed and not bad._executed
        out = bad.collect()
        assert calls == {"src": 1, "flaky": 2}
        return _cols(out)

    got = _both(run)
    assert got["alink_tpu"] == got["alink_tpu_torch"]
    assert got["alink_tpu_torch"]["v"] == list((np.arange(16) + 1.0) * 2.0)


def test_serial_fallback_knob(monkeypatch):
    monkeypatch.setenv("ALINK_DAG_SCHEDULER", "off")

    def run(ns):
        before = ns.metrics.executor_trace()
        src = ns.batch.TableSourceBatchOp(_table(ns))
        out = src.select(["x"]).filter("x > 0.3").collect()
        assert _new_records(ns, before) == []   # the serial walk: no trace
        return _cols(out)

    got = _both(run)
    assert got["alink_tpu"] == got["alink_tpu_torch"]


# -- mapper-chain fusion -----------------------------------------------------


def _chain(ns, src):
    c1 = _affine_op(ns, "x", "x1", 2.0, 1.0).link_from(src)
    c2 = _affine_op(ns, "x1", "x2", 0.5, -3.0).link_from(c1)
    c3 = _affine_op(ns, "x2", "x3", 4.0, 0.25).link_from(c2)
    return c1, c2, c3


def test_fused_chain_bit_identical_to_node_by_node(monkeypatch):
    def run(ns):
        t = _table(ns, seed=3)
        monkeypatch.setenv("ALINK_DAG_FUSION", "0")
        _, _, tail_a = _chain(ns, ns.batch.TableSourceBatchOp(t))
        unfused = tail_a.collect()
        monkeypatch.setenv("ALINK_DAG_FUSION", "1")
        c1, c2, tail_b = _chain(ns, ns.batch.TableSourceBatchOp(t))
        fused = tail_b.collect()
        assert fused.schema == unfused.schema
        for col in fused.names:
            a, b = fused.col(col), unfused.col(col)
            if a.dtype == object:
                assert list(a) == list(b)
            else:
                np.testing.assert_array_equal(a, b)  # bit-identical
        assert not c1._executed and not c2._executed and tail_b._executed
        return _cols(fused)

    got = _both(run)
    assert got["alink_tpu"] == got["alink_tpu_torch"]


def test_fusion_stops_at_shared_intermediate():
    def run(ns):
        src = ns.batch.TableSourceBatchOp(_table(ns, seed=4))
        c1 = _affine_op(ns, "x", "x1", 2.0, 0.0).link_from(src)
        c2 = _affine_op(ns, "x1", "x2", 3.0, 0.0).link_from(c1)
        side = c1.select(["x1"])
        got = {}
        before = ns.metrics.executor_trace()
        c2.lazy_collect(lambda t: got.setdefault("c2", t))
        side.lazy_collect(lambda t: got.setdefault("side", t))
        src.execute()
        assert c1._executed
        np.testing.assert_array_equal(got["side"].col("x1"),
                                      got["c2"].col("x1"))
        labels = sorted(r["op"] for r in _new_records(ns, before))
        return _cols(got["c2"]), _cols(got["side"]), labels

    got = _both(run)
    assert got["alink_tpu"] == got["alink_tpu_torch"]


def test_fused_mapper_chain_kernels_compose():
    def run(ns):
        t = _table(ns, seed=5)
        ops = [_affine_op(ns, "x", "x1", 2.0, 1.0),
               _affine_op(ns, "x1", "x2", 0.5, -3.0),
               _affine_op(ns, "x2", "x3", 4.0, 0.25)]
        schema = t.schema
        mappers = []
        for op in ops:
            m = op.mapper_cls(schema, op.get_params())
            mappers.append(m)
            schema = m.output_schema(schema)
        seq = t
        for m in mappers:
            seq = m.map_table(seq)
        fused = ns.mapper.FusedMapperChain(mappers).map_table(t)
        assert fused.schema == seq.schema
        for col in ("x1", "x2", "x3"):
            np.testing.assert_array_equal(fused.col(col), seq.col(col))
        return _cols(fused)

    got = _both(run)
    assert got["alink_tpu"] == got["alink_tpu_torch"]


def test_fused_chain_keeps_passthrough_columns():
    def run(ns):
        _, _, tail = _chain(ns, ns.batch.TableSourceBatchOp(_table(ns, seed=6)))
        out = tail.collect()
        assert "tag" in out.names and "x" in out.names
        assert list(out.col("tag")) == [f"r{i}" for i in range(64)]
        return _cols(out)

    got = _both(run)
    assert got["alink_tpu"] == got["alink_tpu_torch"]


def test_kernel_chain_truncates_integer_outputs_as_node_by_node(monkeypatch):
    """A LONG kernel output is truncated toward zero between nodes; the fused
    program replays that on the device, in both packages."""
    def run(ns):
        class _Trunc(ns.mapper.BlockKernelMapper):
            def kernel(self, schema):
                return (["x"], ["k"], [ns.mtable.AlinkTypes.LONG],
                        lambda X: X * np.float32(7.3) - np.float32(3.0))

        class TruncOp(ns.utils.MapBatchOp):
            mapper_cls = _Trunc

        outs = []
        for fusion in ("0", "1"):
            monkeypatch.setenv("ALINK_DAG_FUSION", fusion)
            src = ns.batch.TableSourceBatchOp(_table(ns, seed=9))
            k = TruncOp().link_from(src)
            tail = _affine_op(ns, "k", "y", 0.5, 0.25).link_from(k)
            outs.append(_cols(tail.collect()))
        assert outs[0] == outs[1]
        return outs[1]

    got = _both(run)
    assert got["alink_tpu"] == got["alink_tpu_torch"]


# -- per-node executor trace -------------------------------------------------


def test_executor_records_per_node_trace():
    def run(ns):
        before = ns.metrics.executor_trace()
        src = ns.batch.TableSourceBatchOp(_table(ns, seed=7))
        a = src.select(["x"])
        b = src.filter("x > 0.25")
        got = {}
        a.lazy_collect(lambda t: got.setdefault("a", t))
        b.lazy_collect(lambda t: got.setdefault("b", t))
        src.execute()
        trace = _new_records(ns, before)
        assert len(trace) == 3                       # src + two branches
        assert all("op" in r and "wall_s" in r for r in trace)
        run_rec = ns.metrics.metrics.last("executor.run")
        assert run_rec["nodes"] == 3 and run_rec["units"] == 3
        return sorted(r["op"] for r in trace), _cols(got["b"])

    got = _both(run)
    assert got["alink_tpu"] == got["alink_tpu_torch"]
    port = _ns("alink_tpu_torch")
    rec = port.metrics.executor_trace()[-1]
    # the port's records carry each unit's interval on the perf clock
    assert rec["t1_s"] - rec["t0_s"] == pytest.approx(rec["wall_s"],
                                                      abs=1e-5)


def test_trace_marks_fused_units():
    def run(ns):
        before = ns.metrics.executor_trace()
        _, _, tail = _chain(ns, ns.batch.TableSourceBatchOp(_table(ns, seed=8)))
        tail.collect()
        fused = [r for r in _new_records(ns, before) if r.get("fused")]
        assert len(fused) == 1 and fused[0]["fused"] == 3
        return fused[0]["op"]

    got = _both(run)
    assert got["alink_tpu"] == got["alink_tpu_torch"] \
        == "Affine_x1+Affine_x2+Affine_x3"


# -- resilience ladder ------------------------------------------------------


def _fault_run(ns, spec, build):
    ns.faults.install(ns.faults.FaultSpec.parse(spec))
    try:
        before = ns.metrics.executor_trace()
        out = build(ns).collect()
        return out, _new_records(ns, before)
    finally:
        ns.faults.clear()


def test_transient_unit_fault_retries_to_the_same_result():
    def build(ns):
        src = ns.batch.TableSourceBatchOp(_table(ns, seed=10))
        return src.select(["x", "tag"]).filter("x > 0.4")

    def run(ns):
        clean = _cols(build(ns).collect())
        before = ns.metrics.metrics.counter("resilience.unit_retries")
        out, recs = _fault_run(ns, "unit:count=1,kinds=transient,"
                                   "match=FilterOp", build)
        assert _cols(out) == clean
        assert ns.metrics.metrics.counter(
            "resilience.unit_retries") == before + 1
        filt = [r for r in recs if r["op"] == "FilterOp"]
        return clean, filt[0].get("attempts")

    got = _both(run)
    assert got["alink_tpu"] == got["alink_tpu_torch"]
    assert got["alink_tpu_torch"][1] == 2


def test_fused_unit_fault_defuses_then_retries():
    """A fault at the fused unit's first attempt defuses it; a second one
    (the defused re-run's tap) fails the attempt and the retry runs node
    by node — the same rows as the fault-free fused run."""
    def build(ns):
        return _chain(ns, ns.batch.TableSourceBatchOp(_table(ns, seed=11)))[2]

    def run(ns):
        clean = _cols(build(ns).collect())
        out, recs = _fault_run(ns, "unit:count=2,kinds=transient,"
                                   "match=Affine_x1+", build)
        assert _cols(out) == clean
        rec = [r for r in recs if r.get("fused")][0]
        return clean, rec["op"], rec.get("attempts"), rec.get("defused")

    got = _both(run)
    assert got["alink_tpu"] == got["alink_tpu_torch"]
    assert got["alink_tpu_torch"][2:] == (2, True)


def test_fatal_unit_fault_propagates_unchanged():
    def run(ns):
        with pytest.raises(ns.faults.InjectedFatalError):
            _fault_run(ns, "unit:count=1,kinds=fatal,match=FilterOp",
                       lambda ns: ns.batch.TableSourceBatchOp(
                           _table(ns)).filter("x > 0.5"))

    _both(run)


def test_sticky_cuda_error_is_neither_retried_nor_defused():
    """A sticky CUDA error poisons the context for every branch: the port's
    executor propagates it at the first attempt, fused or not."""
    from alink_tpu_torch.common.metrics import metrics

    ns = _ns("alink_tpu_torch")
    calls = {"n": 0}

    class _Boom(ns.mapper.BlockKernelMapper):
        def kernel(self, schema):
            def fn(X):
                calls["n"] += 1
                raise RuntimeError("CUDA error: an illegal memory access "
                                   "was encountered")

            return (["x1"], ["y"], [ns.mtable.AlinkTypes.DOUBLE], fn)

    class BoomOp(ns.utils.MapBatchOp):
        mapper_cls = _Boom

    src = ns.batch.TableSourceBatchOp(_table(ns))
    tail = BoomOp().link_from(_affine_op(ns, "x", "x1", 1.0, 0.0)
                              .link_from(src))
    defused = metrics.counter("resilience.defused")
    retries = metrics.counter("resilience.unit_retries")
    with pytest.raises(RuntimeError, match="illegal memory access"):
        tail.collect()
    assert calls["n"] == 1
    assert metrics.counter("resilience.defused") == defused
    assert metrics.counter("resilience.unit_retries") == retries


def test_dag_pool_failure_degrades_to_the_serial_walk():
    """A DAG pool that cannot take work (shut down under the session)
    degrades to the serial walk with the same result, on the same device."""
    from concurrent.futures import ThreadPoolExecutor

    from alink_tpu_torch.common.env import MLEnvironment, MLEnvironmentFactory
    from alink_tpu_torch.common.metrics import metrics

    ns = _ns("alink_tpu_torch")
    env = MLEnvironment(device="cpu")
    sid = MLEnvironmentFactory.get_new_environment_id(env)
    try:
        dead = ThreadPoolExecutor(max_workers=1)
        dead.shutdown()
        env._dag_pool = dead
        src = ns.batch.TableSourceBatchOp(_table(ns), MLEnvironmentId=sid)
        a = ns.batch.FirstNBatchOp(size=5, MLEnvironmentId=sid).link_from(src)
        b = ns.batch.ShuffleBatchOp(randomSeed=1,
                                    MLEnvironmentId=sid).link_from(a)
        before = metrics.counter("resilience.degraded_serial")
        out = b.collect()
        assert metrics.counter("resilience.degraded_serial") == before + 1
        assert sorted(out.col("tag")) == [f"r{i}" for i in range(5)]
    finally:
        MLEnvironmentFactory.remove(sid)


def test_session_pools_are_named_and_closed():
    from alink_tpu_torch.common.env import MLEnvironment

    env = MLEnvironment(device="cpu", parallelism=3)
    names = env.dag_pool.submit(
        lambda: threading.current_thread().name).result()
    assert names.startswith("alink-dag")
    assert env.executor.submit(
        lambda: threading.current_thread().name).result().startswith(
        "alink-local")
    assert env.dag_pool._max_workers == 3
    env.close()
    assert env._dag_pool is None and env._pool is None


def test_stream_map_reports_node_phases():
    """``stream_map`` inside a DAG unit adds its transfer and compute seconds
    to the unit's trace record."""
    ns = _ns("alink_tpu_torch")
    from alink_tpu_torch.common.streaming import iter_row_chunks, stream_map

    def streamed(t):
        X = np.asarray(t.col("x"), np.float32)[:, None]
        outs = [r.numpy()[:, 0] for _, r in stream_map(
            lambda a: a * 2, iter_row_chunks([X], 16), device="cpu")]
        return ns.mtable.MTable({"y": np.concatenate(outs).astype(
            np.float64)})

    before = ns.metrics.executor_trace()
    src = ns.batch.TableSourceBatchOp(_table(ns))
    out = src.apply_func(streamed, out_schema="y double").collect()
    np.testing.assert_array_equal(
        out.col("y"), (np.asarray(_table(ns).col("x"), np.float32)
                       * 2).astype(np.float64))
    rec = [r for r in _new_records(ns, before) if r["op"] == "_FuncOp"][0]
    assert rec["transfer_s"] >= 0 and rec["compute_s"] >= 0


def test_device_memory_sample_is_none_without_cuda():
    from alink_tpu_torch.common import profiling

    assert profiling.sample_device_memory() is None
    assert profiling.hbm_watermark()["available"] is False


# -- plan pre-flight ----------------------------------------------------------


def _lr_train(ns, feats, src):
    return ns.batch.LogisticRegressionTrainBatchOp(
        featureCols=feats, labelCol="y", maxIter=3).link_from(src)


def _lr_src(ns):
    return ns.batch.MemSourceBatchOp(
        [(0.1, 1.0, "a", 0), (0.9, 0.2, "b", 1)],
        "f0 double, f1 double, s string, y long")


def _preflight_cases(ns):
    AlinkTypes = ns.mtable.AlinkTypes

    class AffMapper(ns.mapper.BlockKernelMapper):
        def kernel(self, input_schema):
            return ["x"], ["x2"], [AlinkTypes.DOUBLE], lambda X: X * 2.0

    class AffOp(ns.utils.MapBatchOp):
        mapper_cls = AffMapper

    class NonFusableOp(AffOp):
        def _execute_impl(self, t):  # custom body => the executor cannot fuse
            return super()._execute_impl(t)

    handle = open(__file__)

    class UnkeyableMapper(ns.mapper.BlockKernelMapper):
        def kernel(self, input_schema):
            def fn(X):
                _ = handle
                return X + 1.0

            return ["x"], ["y"], [AlinkTypes.DOUBLE], fn

    class UnkeyableOp(ns.utils.MapBatchOp):
        mapper_cls = UnkeyableMapper

    x = ns.batch.MemSourceBatchOp([(1.0,), (2.0,)], "x DOUBLE")
    words = ns.batch.MemSourceBatchOp([("a b c",)], "doc string")
    boom = x.apply_func(lambda t: (_ for _ in ()).throw(ValueError("boom")),
                        name="boom")
    return {
        "clean": _lr_train(ns, ["f0", "f1"], _lr_src(ns)),
        "ALK101": _lr_train(ns, ["f0", "nope"], _lr_src(ns)),
        "ALK102": _lr_train(ns, ["f0", "s"], _lr_src(ns)),
        "ALK103": UnkeyableOp().link_from(x),
        "ALK103-huge": ns.batch.Word2VecTrainBatchOp(
            selectedCol="doc", batchSize=1000, shardModel=True
        ).link_from(words),
        "ALK105": NonFusableOp().link_from(AffOp().link_from(x)),
        "ALK106": boom,
    }, handle


def test_validate_plan_codes_and_severities_match_the_reference():
    def run(ns):
        cases, handle = _preflight_cases(ns)
        try:
            out = {}
            for name, op in cases.items():
                rep = ns.analysis.validate_plan(op)
                out[name] = sorted((d.rule, d.severity)
                                   for d in rep.diagnostics)
            return out
        finally:
            handle.close()

    got = _both(run)
    assert got["alink_tpu"] == got["alink_tpu_torch"]
    assert got["alink_tpu_torch"] == {
        "clean": [], "ALK101": [("ALK101", "error")],
        "ALK102": [("ALK102", "error")], "ALK103": [("ALK103", "warning")],
        "ALK103-huge": [("ALK103", "warning")],
        "ALK105": [("ALK105", "info")], "ALK106": [("ALK106", "info")]}


def test_preflight_modes_error_warn_off(monkeypatch):
    from alink_tpu_torch.analysis import last_plan_report
    from alink_tpu_torch.common.exceptions import AkPlanValidationException
    from alink_tpu_torch.common.metrics import metrics

    ns = _ns("alink_tpu_torch")
    monkeypatch.setenv("ALINK_VALIDATE_PLAN", "error")
    with pytest.raises(AkPlanValidationException, match="ALK101"):
        _lr_train(ns, ["f0", "nope"], _lr_src(ns)).collect()
    monkeypatch.setenv("ALINK_VALIDATE_PLAN", "warn")
    runs = metrics.counter("analysis.plan_runs")
    with pytest.raises(Exception) as ei:
        _lr_train(ns, ["f0", "nope"], _lr_src(ns)).collect()
    assert not isinstance(ei.value, AkPlanValidationException)
    assert metrics.counter("analysis.plan_runs") == runs + 1
    rep = last_plan_report()
    assert rep["mode"] == "warn" and rep["by_rule"] == {"ALK101": 1}
    monkeypatch.setenv("ALINK_VALIDATE_PLAN", "off")
    _lr_src(ns).collect()
    assert metrics.counter("analysis.plan_runs") == runs + 1


def test_pipeline_fit_validates_once(monkeypatch):
    from alink_tpu_torch.analysis import last_plan_report
    from alink_tpu_torch.common.exceptions import AkPlanValidationException
    from alink_tpu_torch.common.metrics import metrics
    from alink_tpu_torch.pipeline import LogisticRegression, Pipeline

    ns = _ns("alink_tpu_torch")
    monkeypatch.setenv("ALINK_VALIDATE_PLAN", "warn")
    runs = metrics.counter("analysis.plan_runs")
    Pipeline(LogisticRegression(featureCols=["f0", "f1"], labelCol="y",
                                predictionCol="p", maxIter=3)
             ).fit(_lr_src(ns))
    assert metrics.counter("analysis.plan_runs") == runs + 1
    assert last_plan_report()["target"] == "Pipeline"
    monkeypatch.setenv("ALINK_VALIDATE_PLAN", "error")
    with pytest.raises(AkPlanValidationException):
        Pipeline(LogisticRegression(featureCols=["f0", "nope"],
                                    labelCol="y", predictionCol="p")
                 ).fit(_lr_src(ns))


# -- the slice as a whole: phase 17's DAG at a tiny size ----------------------

N_SLICE = 40


def _flax_tree(cfg, rng):
    h, inter = cfg.hidden_size, cfg.intermediate_size

    def normal(*shape):
        return (rng.standard_normal(shape) * 0.2).astype(np.float32)

    def dense(i, o):
        return {"kernel": normal(i, o), "bias": normal(o)}

    def norm():
        return {"scale": np.ones(h, np.float32), "bias": np.zeros(h, np.float32)}

    p = {"tok_emb": {"embedding": normal(cfg.vocab_size, h)},
         "pos_emb": {"embedding": normal(cfg.max_position, h)},
         "type_emb": {"embedding": normal(cfg.type_vocab_size, h)},
         "ln_emb": norm()}
    for i in range(cfg.num_layers):
        p[f"layer_{i}"] = {
            "attention": {"qkv": {"kernel": normal(h, 3, h),
                                  "bias": normal(3, h)},
                          "out": dense(h, h)},
            "ln_att": norm(), "mlp_in": dense(h, inter),
            "mlp_out": dense(inter, h), "ln_mlp": norm()}
    p["pooler"] = dense(h, h)
    p["head"] = dense(h, cfg.num_labels)
    return {"params": p}


@pytest.fixture(scope="module")
def slice_inputs(tmp_path_factory):
    """The tiny BERT text classifier (``bertSize="tiny"``, maxSeqLength 32,
    attentionBlockSize 16) with seeded weights, written to ``.ak`` by the
    port (the reference reads the same file), and the seeded rows."""
    import dataclasses

    from alink_tpu_torch.common.model import model_to_table
    from alink_tpu_torch.dl.modules import BertConfig
    from alink_tpu_torch.io.ak import write_ak
    from alink_tpu_torch.operator.batch.dl import params_to_bytes

    rng = np.random.default_rng(0)
    cfg = BertConfig.tiny(vocab_size=60, max_position=32, num_labels=2,
                          attention_block_size=16)
    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + [
        f"w{i}" for i in range(cfg.vocab_size - 5)]
    meta = {"modelName": "BertTextModel",
            "bertConfig": {k: v for k, v in dataclasses.asdict(cfg).items()
                           if k != "dtype"},
            "textCol": "text", "textPairCol": None, "labelCol": "label",
            "labelType": "LONG", "labels": [0, 1], "regression": False,
            "maxSeqLength": 32, "vocab": vocab, "doLowerCase": True}
    path = str(tmp_path_factory.mktemp("slice") / "bert_tiny.ak")
    write_ak(path, model_to_table(meta, {"params": params_to_bytes(
        _flax_tree(cfg, rng))}))
    texts = [" ".join(vocab[j] for j in rng.integers(5, len(vocab), n))
             for n in rng.integers(3, 40, N_SLICE)]
    x1, x2 = rng.random(N_SLICE), rng.standard_normal(N_SLICE)
    rows = [(t, float(a), float(b)) for t, a, b in zip(texts, x1, x2)]
    lr_rows = [(float(a), float(b), int(a + 0.3 * b > 0.5))
               for a, b in zip(rng.random(64), rng.standard_normal(64))]
    return path, rows, lr_rows


def _slice_dag(ns, model_path, rows, lr_rows, csv_path):
    """Phase 17's DAG: filter → split → (BERT → LR → CSV sink) and
    (side output → BERT), triggered by one ``execute()``."""
    b = ns.batch
    src = b.MemSourceBatchOp(rows, "text string, x1 double, x2 double")
    split = b.SplitBatchOp(fraction=0.5, randomSeed=7).link_from(
        src.filter("x1 > 0.1"))
    model = b.AkSourceBatchOp(filePath=model_path)
    lr_model = b.LogisticRegressionTrainBatchOp(
        featureCols=["x1", "x2"], labelCol="y", maxIter=10).link_from(
        b.MemSourceBatchOp(lr_rows, "x1 double, x2 double, y long"))
    bert = b.BertTextClassifierPredictBatchOp(
        predictionCol="pred", predictionDetailCol="detail").link_from(
        model, split)
    lr = b.LogisticRegressionPredictBatchOp(
        predictionCol="lr_pred", predictionDetailCol="lr_detail").link_from(
        lr_model, bert)
    got = {}
    b.CsvSinkBatchOp(filePath=csv_path, overwriteSink=True).link_from(
        lr).lazy_collect(lambda t: got.setdefault("main", t))
    side = b.BertTextClassifierPredictBatchOp(
        predictionCol="pred", predictionDetailCol="detail").link_from(
        model, split.get_side_output(0))
    side.lazy_collect(lambda t: got.setdefault("side", t))
    before = ns.metrics.executor_trace()
    split.execute()
    return got, _new_records(ns, before), bert


def _probs(t, col="detail"):
    return np.asarray([[d[k] for k in sorted(d)] for d in
                       (json.loads(s) for s in t.col(col))])


def test_slice_dag_matches_reference_and_is_exact_across_schedules(
        slice_inputs, monkeypatch):
    path, rows, lr_rows = slice_inputs
    ref = _ns("alink_tpu")
    port = _ns("alink_tpu_torch")
    r_got, _, _ = _slice_dag(ref, path, rows, lr_rows, "memory://s/ref.csv")

    runs = {}
    for label, knobs in (("fused", {}), ("unfused", {"ALINK_DAG_FUSION": "0"}),
                         ("serial", {"ALINK_DAG_SCHEDULER": "off"})):
        for k, v in knobs.items():
            monkeypatch.setenv(k, v)
        runs[label] = _slice_dag(port, path, rows, lr_rows,
                                 f"memory://s/{label}.csv")
        for k in knobs:
            monkeypatch.delenv(k)
    got, recs, bert = runs["fused"]
    # one record per unit; the fused chain is one unit and its BERT node
    # is never materialized
    assert sorted(r["op"] for r in recs) == sorted([
        "MemSourceBatchOp", "FilterOp", "SplitBatchOp", "AkSourceBatchOp",
        "MemSourceBatchOp", "LogisticRegressionTrainBatchOp",
        "BertTextClassifierPredictBatchOp+LogisticRegressionPredictBatchOp",
        "CsvSinkBatchOp", "SideOutputOp", "BertTextClassifierPredictBatchOp"])
    assert not bert._executed
    assert runs["serial"][1] == []
    for other in ("unfused", "serial"):
        for branch in ("main", "side"):
            assert _cols(runs[other][0][branch]) == _cols(got[branch])
    # the same split rows, labels, and probabilities within PROB_ATOL
    for branch in ("main", "side"):
        a, b = r_got[branch], got[branch]
        assert list(a.col("text")) == list(b.col("text"))
        assert a.names == b.names
        np.testing.assert_allclose(_probs(b), _probs(a), atol=PROB_ATOL)
        margin = np.abs(np.diff(_probs(a), axis=1))[:, 0]
        sure = margin > PROB_ATOL
        np.testing.assert_array_equal(np.asarray(b.col("pred"))[sure],
                                      np.asarray(a.col("pred"))[sure])
    np.testing.assert_allclose(_probs(got["main"], "lr_detail"),
                               _probs(r_got["main"], "lr_detail"),
                               atol=PROB_ATOL)
    assert list(got["main"].col("lr_pred")) == list(
        r_got["main"].col("lr_pred"))
    n = sum(1 for r in rows if r[1] > 0.1)
    assert got["main"].num_rows + got["side"].num_rows == n
    assert got["main"].num_rows == round(n * 0.5)
    # the lazy CSV sink wrote the main branch to memory://
    from alink_tpu_torch.io.filesystem import file_open

    with file_open("memory://s/fused.csv") as f:
        lines = f.read().splitlines()
    assert len(lines) == got["main"].num_rows


def test_mappers_on_one_model_table_decode_it_once(slice_inputs,
                                                   monkeypatch):
    """Every ``BertTextModelMapper`` that loads one model table object
    shares one decode, also when two threads load it at once (the second
    waits for the first's decode instead of decoding beside it under the
    interpreter lock): the two predict branches of phase 17's DAG then
    start together. A second table decodes again. Each DAG run decodes
    its model once and still loads it once per BERT op."""
    from alink_tpu_torch.common.metrics import metrics
    from alink_tpu_torch.common.params import Params
    from alink_tpu_torch.io.ak import read_ak
    from alink_tpu_torch.operator.batch import dl

    monkeypatch.setenv("ALINK_TORCH_DEVICE", "cpu")
    path, rows, lr_rows = slice_inputs
    table, other = read_ak(path), read_ak(path)
    n_threads = 16
    started = threading.Barrier(n_threads)
    real_decode = dl.params_from_bytes
    decodes = []

    def slow_decode(buf):
        decodes.append(threading.current_thread().name)
        time.sleep(0.2)      # a decode long enough for the threads to meet
        return real_decode(buf)

    monkeypatch.setattr(dl, "params_from_bytes", slow_decode)

    def load(out, i):
        m = dl.BertTextModelMapper(None, None, Params(predictionCol="p"))
        m.device = "cpu"
        started.wait()
        out[i] = m.load_model(table)

    before = metrics.counter("dl.model_decodes")
    mappers = [None] * n_threads
    threads = [threading.Thread(target=load, args=(mappers, i))
               for i in range(n_threads)]
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
    finally:
        sys.setswitchinterval(switch)
    assert not any(th.is_alive() for th in threads)
    assert len(decodes) == 1
    assert metrics.counter("dl.model_decodes") - before == 1
    assert all(m.model is mappers[0].model for m in mappers)
    assert all(m.tokenizer is mappers[0].tokenizer for m in mappers)
    third = dl.BertTextModelMapper(None, None, Params(predictionCol="p"))
    third.device = "cpu"
    third.load_model(other)
    assert metrics.counter("dl.model_decodes") - before == 2
    assert third.model is not mappers[0].model

    port = _ns("alink_tpu_torch")
    loads = []
    orig = dl.BertTextModelMapper.load_model

    def counted(mapper, model):
        loads.append(threading.current_thread().name)
        return orig(mapper, model)

    monkeypatch.setattr(dl.BertTextModelMapper, "load_model", counted)
    for label, knobs in (("fused", {}), ("unfused", {"ALINK_DAG_FUSION": "0"}),
                         ("serial", {"ALINK_DAG_SCHEDULER": "off"})):
        for k, v in knobs.items():
            monkeypatch.setenv(k, v)
        del loads[:]
        before = metrics.counter("dl.model_decodes")
        _slice_dag(port, path, rows, lr_rows, f"memory://s/once_{label}.csv")
        assert metrics.counter("dl.model_decodes") - before == 1, label
        assert len(loads) == 2, label
        for k in knobs:
            monkeypatch.delenv(k)
