"""The port's local work-splitting engine (``operator/local``): the cases
of ``tests/test_local_engine.py`` (split_work, parallel_apply, the grouped
outlier op on the pool), held against the reference where they compute,
and the engine's contracts: results in order, the first error propagates,
serial inside an ``alink-local`` thread (no nested deadlock), and a
grouped op inside a DAG node (an ``alink-dag`` thread) fanning out to the
pool with the serial result."""

import threading

import numpy as np
import pytest

from torch_table_parity import both, reference_session, remove_session, \
    same_table


@pytest.fixture(scope="module")
def sid():
    s = reference_session()
    yield s
    remove_session(s)


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("ALINK_TORCH_DEVICE", "cpu")


@pytest.mark.parametrize("total,workers", [(10, 3), (2, 4), (1000, 7),
                                           (0, 3), (5, 0)])
def test_split_work_is_the_references(total, workers):
    from alink_tpu.operator.local import split_work as ref_split
    from alink_tpu_torch.operator.local import split_work

    got = split_work(total, workers)
    assert got == ref_split(total, workers)
    sizes = [n for _, n in got]
    assert sum(sizes) == total and max(sizes) - min(sizes) <= 1
    assert all(s + n == s2 for (s, n), (s2, _) in zip(got, got[1:]))


def test_parallel_apply_order_and_errors():
    from alink_tpu_torch.common.env import MLEnvironment
    from alink_tpu_torch.operator.local import parallel_apply

    env = MLEnvironment(parallelism=4)
    try:
        assert parallel_apply(lambda x: x * x, list(range(20)), env=env) == \
            [x * x for x in range(20)]

        def bad(x):
            if x in (3, 17):
                raise ValueError(f"boom {x}")
            return x

        with pytest.raises(ValueError, match="boom 3"):
            parallel_apply(bad, list(range(20)), env=env)
    finally:
        env.close()


def test_parallel_apply_shards_via_split_work(monkeypatch):
    import alink_tpu_torch.operator.local as local_mod
    from alink_tpu_torch.common.env import MLEnvironment

    calls, threads = [], set()
    real = local_mod.split_work

    def spy(total, workers):
        calls.append((total, workers))
        return real(total, workers)

    def fn(x):
        threads.add(threading.current_thread().name)
        return x * 2

    monkeypatch.setattr(local_mod, "split_work", spy)
    env = MLEnvironment(parallelism=3)
    try:
        out = local_mod.parallel_apply(fn, list(range(100)), env=env)
        serial = local_mod.parallel_apply(fn, [1], env=env)
    finally:
        env.close()
    assert out == [x * 2 for x in range(100)] and serial == [2]
    assert calls == [(100, 3)]
    assert any(n.startswith("alink-local") for n in threads)


def test_nested_parallel_apply_runs_serially_on_the_pool():
    """A call from an alink-local thread runs serially there: with one
    pool thread, a nested fan-out would otherwise wait on itself."""
    from alink_tpu_torch.common.env import MLEnvironment
    from alink_tpu_torch.operator.local import parallel_apply

    env = MLEnvironment(parallelism=2)
    seen = []

    def inner(x):
        seen.append(threading.current_thread().name)
        return x + 1

    def outer(xs):
        me = threading.current_thread().name
        out = parallel_apply(inner, xs, env=env)
        assert all(n == me for n in seen[-len(xs):])
        return out

    try:
        got = parallel_apply(outer, [[1, 2, 3], [4, 5, 6], [7, 8]], env=env)
    finally:
        env.close()
    assert got == [[2, 3, 4], [5, 6, 7], [8, 9]]


def _groups(n_groups=12, seed=0):
    rng = np.random.default_rng(seed)
    g, x = [], []
    for k in range(n_groups):
        vals = rng.standard_normal(30)
        vals[0] = 30.0
        g += [f"g{k}"] * 30
        x += list(vals)
    return {"g": np.asarray(g, object), "x": np.asarray(x)}


def test_grouped_outlier_uses_pool_and_matches_the_reference(sid):
    ref, port = both(sid, _groups(), lambda ops, extra, src: ops
                     .KSigmaOutlier4GroupedDataBatchOp(
                         groupCols=["g"], selectedCol="x",
                         predictionCol="flag", predictionDetailCol="d",
                         **extra).link_from(src))
    same_table(port, ref)
    flags = np.asarray(port.col("flag")).reshape(12, 30)
    assert flags[:, 0].all() and not flags[:, 1:].any()


def test_grouped_op_inside_a_dag_node(monkeypatch):
    """The grouped op's collect() runs as a DAG node on an alink-dag
    thread; its groups fan out to alink-local threads and the result is the
    serial walk's (ALINK_DAG_SCHEDULER=off, one-thread session)."""
    from alink_tpu_torch.common.env import MLEnvironment, \
        MLEnvironmentFactory
    from alink_tpu_torch.common.mtable import MTable
    from alink_tpu_torch.operator import batch as B
    from alink_tpu_torch.operator.batch import outlier

    threads = []
    score = outlier.KSigmaOutlierBatchOp._score

    def traced(self, x):
        threads.append(threading.current_thread().name)
        return score(self, x)

    monkeypatch.setattr(outlier.KSigmaOutlierBatchOp, "_score", traced)
    nodes = []
    grouped = outlier.KSigmaOutlier4GroupedDataBatchOp
    execute = grouped._execute_impl

    def node(self, t):
        nodes.append(threading.current_thread().name)
        return execute(self, t)

    monkeypatch.setattr(grouped, "_execute_impl", node)
    cols = _groups(40, seed=1)

    def run(**env):
        src = B.TableSourceBatchOp(MTable(dict(cols)))
        return B.KSigmaOutlier4GroupedDataBatchOp(
            groupCols=["g"], selectedCol="x", predictionCol="flag",
            predictionDetailCol="d", **env).link_from(src).collect()

    pooled = run()
    pool_threads = list(threads)
    threads.clear()
    monkeypatch.setenv("ALINK_DAG_SCHEDULER", "off")
    one = MLEnvironmentFactory.get_new_environment_id(
        MLEnvironment(parallelism=1))
    try:
        serial = run(MLEnvironmentId=one)
    finally:
        MLEnvironmentFactory.remove(one)
    same_table(pooled, serial)
    assert nodes[0].startswith("alink-dag") and nodes[1] != nodes[0]
    assert len(pool_threads) == 40
    if MLEnvironmentFactory.get_default().parallelism > 1:
        assert all(n.startswith("alink-local") for n in pool_threads)
    assert not any(n.startswith("alink-local") for n in threads)
