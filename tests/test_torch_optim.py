"""The optimizer framework of the port (``alink_tpu_torch.optim`` and
``parallel.comqueue``) held against ``alink_tpu`` on the CPU, with inputs
made by seeded numpy.

- Every objective's loss and gradient against ``jax.value_and_grad`` of
  the reference's, within 1e-5 relative (both in float32; the sums run in
  another order).
- ``optimize``, each of the five methods with and without l1/l2, dense and
  (where the reference allows it) sparse, at max_iter 8 on a one-device
  mesh: the same iteration count, weights within 1e-4 of the largest
  weight. Both run in float32; the loss and gradient sums are taken in
  another order (XLA's CPU kernels against torch's), a difference of ~1e-7
  relative that 8 quasi-Newton steps amplify to a few 1e-6 here.
- ``constrained_optimize`` on the reference's own problems
  (tests/test_constrained.py): its assertions, and the reference's weights
  within 1e-3 (12 outer rounds of up to 60 inner steps each).
- ``IterativeComQueue.exec`` and ``exec_host`` against each other and
  against the reference on tests/test_comqueue.py's cases, on one rank.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("ALINK_TORCH_DEVICE", "cpu")


@pytest.fixture(scope="module")
def mesh1():
    from alink_tpu.parallel.mesh import default_mesh

    return default_mesh(jax.devices()[:1])


def _data(seed=0, n=240, d=5):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32)
    w = rng.normal(size=d)
    s = X @ w
    return dict(
        X=X,
        lin=(s + 0.3 * rng.normal(size=n)).astype(np.float32),
        pm=np.where(s + 0.8 * rng.normal(size=n) > 0, 1.0, -1.0)
        .astype(np.float32),
        cls=np.digitize(s + 0.5 * rng.normal(size=n),
                        np.quantile(s, [0.33, 0.66])).astype(np.float32),
        wt=rng.uniform(0.5, 1.5, n).astype(np.float32),
        rng=rng)


def _sparse(seed=0, n=200, dim=50, nnz=6):
    """ELL blocks of both packages over the same seeded cells."""
    from alink_tpu.common.linalg import SparseVector as RSV
    from alink_tpu.common.linalg import to_sparse_block as r_block
    from alink_tpu_torch.common.linalg import SparseVector as PSV
    from alink_tpu_torch.common.linalg import to_sparse_block as p_block

    rng = np.random.default_rng(seed)
    idx = [np.sort(rng.choice(dim, nnz, replace=False)) for _ in range(n)]
    val = [rng.normal(size=nnz) for _ in range(n)]
    rb, rd = r_block([RSV(dim, i, v) for i, v in zip(idx, val)],
                     append_intercept=True)
    pb, pd = p_block([PSV(dim, i, v) for i, v in zip(idx, val)],
                     append_intercept=True)
    assert rd == pd == dim
    np.testing.assert_array_equal(rb.idx, pb.idx)
    np.testing.assert_array_equal(rb.val, pb.val)
    w = rng.normal(size=dim + 1)
    s = np.asarray([(v * w[i]).sum() for i, v in zip(idx, val)]) + w[dim]
    y = np.where(s + 0.5 * rng.normal(size=n) > 0, 1.0, -1.0)
    return rb, pb, dim + 1, y.astype(np.float32)


# name -> (builder args, label kind, feature transform)
OBJECTIVES = {
    "logistic": (lambda m, d: m.logistic_obj(d), "pm"),
    "squared": (lambda m, d: m.squared_obj(d), "lin"),
    "hinge_smooth": (lambda m, d: m.hinge_obj(d), "pm"),
    "hinge_plain": (lambda m, d: m.hinge_obj(d, smooth=False), "pm"),
    "softmax": (lambda m, d: m.softmax_obj(d, 3), "cls"),
    "perceptron": (lambda m, d: m.perceptron_obj(d), "pm"),
    "svr": (lambda m, d: m.svr_obj(d, 0.2), "lin"),
    "aft": (lambda m, d: m.aft_obj(d - 1), "aft"),
    "huber": (lambda m, d: m.huber_obj(d, 0.7), "lin"),
    "fm_binary": (lambda m, d: m.fm_obj(d, 3, "binary"), "pm"),
    "fm_regression": (lambda m, d: m.fm_obj(d, 3, "regression"), "lin"),
    "mlp": (lambda m, d: m.mlp_obj([d, 4, 3]), "cls"),
}


def _close(got, want, rtol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= rtol * scale, (got, want)


@pytest.mark.parametrize("name", sorted(OBJECTIVES))
def test_objective_loss_and_grad_match_reference(name):
    import alink_tpu.optim as R
    import alink_tpu_torch.optim as P

    build, kind = OBJECTIVES[name]
    data = _data(seed=3)
    X, d = data["X"], data["X"].shape[1]
    if kind == "aft":
        # censor indicator rides as the last column; y = log(time)
        X = X.copy()
        X[:, -1] = (data["rng"].random(X.shape[0]) < 0.7).astype(np.float32)
        y = (0.3 * data["lin"]).astype(np.float32)
    else:
        y = data[kind]
    ref, port = build(R, d), build(P, d)
    assert ref.num_params == port.num_params
    w = (0.3 * data["rng"].normal(size=ref.num_params)).astype(np.float32)
    l_ref, g_ref = jax.value_and_grad(ref.local_loss)(
        jnp.asarray(w), jnp.asarray(X), jnp.asarray(y),
        jnp.asarray(data["wt"]))
    g_port, l_port = torch.func.grad_and_value(port.local_loss)(
        torch.from_numpy(w), torch.from_numpy(X), torch.from_numpy(y),
        torch.from_numpy(data["wt"]))
    _close(float(l_port), float(l_ref), 1e-5)
    _close(g_port.numpy(), np.asarray(g_ref), 1e-5)


@pytest.mark.parametrize("name", ["logistic", "softmax"])
def test_sparse_xw_matches_reference_and_dense(name):
    """xw over an ELL block: a gather whose gradient is a scatter-add, equal
    to the reference's and to the dense product of the same rows."""
    import alink_tpu.optim as R
    import alink_tpu_torch.optim as P
    from alink_tpu_torch.common.linalg import SparseBlock

    rb, pb, d, y = _sparse(seed=5)
    if name == "softmax":
        y = (np.arange(y.size) % 3).astype(np.float32)
    ref, port = OBJECTIVES[name][0](R, d), OBJECTIVES[name][0](P, d)
    w = np.random.default_rng(6).normal(size=ref.num_params) \
        .astype(np.float32)
    wt = np.ones(y.size, np.float32)
    l_ref, g_ref = jax.value_and_grad(ref.local_loss)(
        jnp.asarray(w), R.objfunc.SparseBlock(jnp.asarray(rb.idx),
                                              jnp.asarray(rb.val)),
        jnp.asarray(y), jnp.asarray(wt))
    blk = SparseBlock(torch.from_numpy(pb.idx), torch.from_numpy(pb.val))
    g_port, l_port = torch.func.grad_and_value(port.local_loss)(
        torch.from_numpy(w), blk, torch.from_numpy(y), torch.from_numpy(wt))
    _close(float(l_port), float(l_ref), 1e-5)
    _close(g_port.numpy(), np.asarray(g_ref), 1e-5)
    dense = np.zeros((y.size, d), np.float32)
    np.add.at(dense, (np.arange(y.size)[:, None], pb.idx), pb.val)
    g_dense, l_dense = torch.func.grad_and_value(port.local_loss)(
        torch.from_numpy(w), torch.from_numpy(dense), torch.from_numpy(y),
        torch.from_numpy(wt))
    _close(float(l_port), float(l_dense), 1e-5)
    _close(g_port.numpy(), g_dense.numpy(), 1e-5)


METHODS = ["lbfgs", "owlqn", "gd", "sgd", "newton"]


@pytest.mark.parametrize("reg", ["none", "l1l2"])
@pytest.mark.parametrize("method", METHODS)
def test_optimize_dense_matches_reference(mesh1, method, reg):
    import alink_tpu.optim as R
    import alink_tpu_torch.optim as P

    data = _data(seed=1)
    l1, l2 = (0.0, 0.0) if reg == "none" else (0.01, 0.02)
    kw = dict(method=method, max_iter=8, l1=l1, l2=l2)
    ref = R.optimize(R.logistic_obj(5), data["X"], data["pm"],
                     sample_weights=data["wt"], mesh=mesh1, **kw)
    port = P.optimize(P.logistic_obj(5), data["X"], data["pm"],
                      sample_weights=data["wt"], **kw)
    assert port.num_iters == ref.num_iters
    _close(port.weights, ref.weights, 1e-4)
    _close(port.loss, ref.loss, 1e-5)
    assert port.grad_norm == pytest.approx(ref.grad_norm, rel=1e-3, abs=1e-6)


def test_optimize_softmax_l2_vector_matches_reference(mesh1):
    """A per-parameter l2 vector and a multi-class objective."""
    import alink_tpu.optim as R
    import alink_tpu_torch.optim as P

    data = _data(seed=2)
    l2 = np.linspace(0.0, 0.05, 15).astype(np.float32)
    ref = R.optimize(R.softmax_obj(5, 3), data["X"], data["cls"], l2=l2,
                     max_iter=8, mesh=mesh1)
    port = P.optimize(P.softmax_obj(5, 3), data["X"], data["cls"], l2=l2,
                      max_iter=8)
    assert port.num_iters == ref.num_iters
    _close(port.weights, ref.weights, 1e-4)


@pytest.mark.parametrize("reg", ["none", "l1l2"])
@pytest.mark.parametrize("method", ["lbfgs", "owlqn", "gd"])
def test_optimize_sparse_matches_reference(mesh1, method, reg):
    import alink_tpu.optim as R
    import alink_tpu_torch.optim as P

    rb, pb, d, y = _sparse(seed=7)
    l1, l2 = (0.0, 0.0) if reg == "none" else (0.005, 0.01)
    kw = dict(method=method, max_iter=8, l1=l1, l2=l2)
    ref = R.optimize(R.logistic_obj(d), rb, y, mesh=mesh1, **kw)
    port = P.optimize(P.logistic_obj(d), pb, y, **kw)
    assert port.num_iters == ref.num_iters
    _close(port.weights, ref.weights, 1e-4)


@pytest.mark.parametrize("method", ["sgd", "newton"])
def test_optimize_sparse_refuses_sgd_and_newton(method):
    import alink_tpu_torch.optim as P

    _, pb, d, y = _sparse(seed=7)
    with pytest.raises(ValueError, match="sparse"):
        P.optimize(P.logistic_obj(d), pb, y, method=method)


def test_optimize_global_term_matches_reference(mesh1):
    """A data-independent penalty added once to the averaged loss."""
    import alink_tpu.optim as R
    import alink_tpu_torch.optim as P

    data = _data(seed=4)
    target = np.asarray([1.0, -1.0, 0.5, 0.0, 2.0], np.float32)
    ref_obj = R.ObjFunc(R.squared_obj(5).local_loss, 5,
                        lambda w: 0.3 * jnp.sum((w - target) ** 2))
    t_target = torch.from_numpy(target)
    port_obj = P.ObjFunc(P.squared_obj(5).local_loss, 5,
                         lambda w: 0.3 * ((w - t_target) ** 2).sum())
    for method in ("lbfgs", "newton"):
        ref = R.optimize(ref_obj, data["X"], data["lin"], method=method,
                         max_iter=8, mesh=mesh1)
        port = P.optimize(port_obj, data["X"], data["lin"], method=method,
                          max_iter=8)
        assert port.num_iters == ref.num_iters
        _close(port.weights, ref.weights, 1e-4)


def _ls_data(seed=0, n=400, d=4):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32)
    w_true = np.array([1.0, -2.0, 0.5, 3.0], np.float32)
    y = X @ w_true + 0.01 * rng.normal(size=n).astype(np.float32)
    return X, y


def _unit_row(j, d=4):
    A = np.zeros((1, d), np.float32)
    A[0, j] = 1.0
    return A


CONSTRAINED = {
    # the problems of tests/test_constrained.py: (seed, kwargs, check)
    "alm_equality": (0, dict(A_eq=np.ones((1, 4), np.float32),
                             b_eq=np.zeros(1, np.float32)),
                     lambda r: abs(r.weights.sum()) < 1e-3 and r.loss < 1.5),
    "alm_inequality": (1, dict(A_ub=_unit_row(3),
                               b_ub=np.ones(1, np.float32)),
                       lambda r: 0.9 < r.weights[3] <= 1.0 + 1e-3),
    "barrier": (3, dict(A_ub=_unit_row(3), b_ub=np.ones(1, np.float32),
                        method="barrier"),
                lambda r: 0.85 < r.weights[3] <= 1.0 + 1e-2),
}


@pytest.mark.parametrize("case", sorted(CONSTRAINED))
def test_constrained_matches_reference(mesh1, case):
    import alink_tpu.optim as R
    import alink_tpu_torch.optim as P

    seed, kw, check = CONSTRAINED[case]
    X, y = _ls_data(seed)
    port = P.constrained_optimize(P.squared_obj(4), X, y, **kw)
    assert check(port)
    ref = R.constrained_optimize(R.squared_obj(4), X, y, mesh=mesh1, **kw)
    np.testing.assert_allclose(port.weights, ref.weights, atol=1e-3)


def test_constrained_inactive_matches_unconstrained():
    import alink_tpu_torch.optim as P

    X, y = _ls_data(seed=2)
    res_c = P.constrained_optimize(P.squared_obj(4), X, y, A_ub=_unit_row(3),
                                   b_ub=np.asarray([100.0], np.float32))
    res_u = P.optimize(P.squared_obj(4), X, y, max_iter=60)
    np.testing.assert_allclose(res_c.weights, res_u.weights, atol=5e-3)


# -- IterativeComQueue, tests/test_comqueue.py's cases on one rank ----------

def _queue_cases():
    def allreduce(pkg, dev):
        def compute_sum(ctx, state, data):
            local = (data["x"][:, 0] * data["mask"]).sum()
            return {**state, "total": ctx.all_reduce_sum(local),
                    "count": ctx.all_reduce_sum(data["mask"].sum())}

        return (pkg.IterativeComQueue(dev)
                .init_with_partitioned_data(
                    "x", np.arange(20, dtype=np.float32).reshape(-1, 1))
                .init_with_partitioned_data("mask",
                                            np.ones(20, dtype=np.float32))
                .init_with_broadcast_data("total", 0.0)
                .init_with_broadcast_data("count", 0.0)
                .add(compute_sum).set_max_iter(1))

    def converge(pkg, dev):
        def grad_step(ctx, state, data):
            w = state["w"]
            g = ctx.all_reduce_sum((2.0 * (w - data["x"])).sum()) / 16.0
            return {**state, "w": w - 0.25 * g, "g": g}

        return (pkg.IterativeComQueue(dev)
                .init_with_partitioned_data("x",
                                            np.arange(16, dtype=np.float32))
                .init_with_broadcast_data("w", 0.0)
                .init_with_broadcast_data("g", 1.0)
                .add(grad_step)
                .set_compare_criterion(lambda ctx, s: abs(s["g"]) < 1e-4)
                .set_max_iter(100))

    def repeat(pkg, dev):
        return (pkg.IterativeComQueue(dev)
                .init_with_partitioned_data("x",
                                            np.arange(8, dtype=np.float32))
                .init_with_broadcast_data("s", 0.0)
                .add(lambda ctx, st, data: {
                    "s": st["s"] + ctx.all_reduce_sum(data["x"].sum())})
                .set_max_iter(3))

    def close(pkg, dev):
        return (pkg.IterativeComQueue(dev)
                .init_with_partitioned_data("x", np.zeros(8, np.float32))
                .init_with_broadcast_data("s", 0.0)
                .add(lambda ctx, st, data: st)
                .set_max_iter(1)
                .close_with(lambda ctx, st, data: {
                    "n": ctx.all_reduce_sum(data["__mask__"].sum()),
                    "s": st["s"]}))

    return {"allreduce": allreduce, "converge": converge, "repeat": repeat,
            "close": close}


QUEUES = _queue_cases()


@pytest.mark.parametrize("case", sorted(QUEUES))
def test_comqueue_exec_matches_exec_host_and_reference(mesh1, case):
    import alink_tpu.parallel as R
    import alink_tpu_torch.parallel as P

    build = QUEUES[case]
    port = build(P, None).exec()
    host = build(P, None).exec_host()
    ref = build(R, mesh1).exec()
    assert set(port) == set(host) == set(ref)
    for k in ref:
        np.testing.assert_allclose(port[k], ref[k], rtol=1e-6)
        np.testing.assert_array_equal(port[k], host[k])
    if case == "converge":
        assert port["__num_iters__"] < 100
        assert port["w"] == pytest.approx(7.5, abs=1e-3)


def test_comqueue_one_rank_topology_and_mask():
    """On one rank: task 0 of 1, all_gather is the identity, and shard_rows
    pads nothing (19 rows, 19 valid)."""
    from alink_tpu_torch.parallel import ComContext, shard_rows

    ctx = ComContext("data", 0, 1)
    x = torch.arange(3.0)
    assert ctx.task_id == 0
    assert torch.equal(ctx.all_gather(x), x)
    assert ctx.all_gather(x, tiled=False).shape == (1, 3)
    arr, mask = shard_rows(torch.device("cpu"), np.ones((19, 2), np.float32),
                           with_mask=True)
    assert arr.shape == (19, 2) and float(mask.sum()) == 19


def test_comqueue_above_one_rank_raises(monkeypatch):
    from alink_tpu_torch.parallel import ComContext, comqueue

    monkeypatch.setattr(comqueue, "axis_size", lambda axis: 4)
    with pytest.raises(NotImplementedError, match="A3"):
        ComContext("data", 0, 4).all_reduce_sum(torch.ones(1))
    with pytest.raises(NotImplementedError, match="A3"):
        QUEUES["repeat"](comqueue, None).exec()


def test_staging_cache_hits_and_bf16_wire(monkeypatch):
    """The cache serves a second staging of the same read-only block
    without a push; a writable block is pushed on every call and never
    kept; ``auto`` is exact fp32; the explicit bf16 wire rounds on the host
    and upcasts on the device."""
    from alink_tpu_torch.common import staging

    staging.clear_staging_cache()
    dev = torch.device("cpu")
    x = np.random.default_rng(0).normal(size=(64, 8)).astype(np.float32)
    x.setflags(write=False)
    a = staging.stage_replicated(x, dev)
    b = staging.stage_replicated(x, dev)
    st = staging.staging_cache_stats()
    assert a is b and st["hits"] == 1 and st["misses"] == 1
    assert st["wire_bytes_sent"] == x.nbytes and st["resident_entries"] == 1
    assert torch.equal(a, torch.from_numpy(x.copy()))
    w = x.copy()  # writable: its bytes may change between calls
    c, d = staging.stage_replicated(w, dev), staging.stage_replicated(w, dev)
    st = staging.staging_cache_stats()
    assert c is not d and st["uncached"] == 2 and st["resident_entries"] == 1
    assert st["wire_bytes_sent"] == 3 * x.nbytes
    monkeypatch.setenv("ALINK_WIRE_PRECISION", "bf16")
    e = staging.stage_replicated(x, dev)
    assert e.dtype == torch.float32 and e is not a
    assert torch.equal(e, torch.from_numpy(x.copy()).to(torch.bfloat16)
                       .float())
    assert staging.staging_cache_stats()["wire_bytes_saved"] == x.nbytes // 2
    monkeypatch.setenv("ALINK_STAGING_CACHE_BYTES", "0")
    staging.clear_staging_cache()
    staging.stage_replicated(x, dev)
    assert staging.staging_cache_stats()["resident_entries"] == 0


def test_staging_keys_by_identity_of_frozen_blocks():
    """Only a read-only block that owns its memory is cached; its entry
    goes with the block; a read-only view of a writable base and
    ``push_block``'s one-off chunks are pushed and never kept; MTable's
    memoized feature block is such a frozen block."""
    import gc

    from alink_tpu_torch.common import staging
    from alink_tpu_torch.common.mtable import MTable

    staging.clear_staging_cache()
    dev = torch.device("cpu")
    base = np.arange(40, dtype=np.float32).reshape(10, 4)
    view = base.view()
    view.setflags(write=False)
    staging.stage_sharded(view, dev)
    base[0, 0] = -1.0  # the view's bytes change under it
    assert float(staging.stage_sharded(view, dev)[0, 0]) == -1.0
    staging.push_block(base, dev)
    st = staging.staging_cache_stats()
    assert st["uncached"] == 3 and st["resident_entries"] == 0
    t = MTable({"a": np.arange(6.0), "b": np.ones(6)})
    blk = t.to_numeric_block(["a", "b"])
    first = staging.stage_sharded(blk, dev)
    assert staging.stage_sharded(t.to_numeric_block(["a", "b"]), dev) \
        is first
    assert staging.staging_cache_stats()["resident_entries"] == 1
    del t, blk
    gc.collect()
    assert staging.staging_cache_stats()["resident_entries"] == 0
