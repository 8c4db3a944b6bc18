"""Parity of the port's script and UDF ops (``alink_tpu_torch.operator.batch.
script``, ``udf2``) with the reference's on the CPU: ``ScriptContext.dataset``
yields the same batches in the same order for one seed; a torch twin of
``tests/test_script_op.py``'s flax script trains on the context's device; a
least-squares user function over the dataset gives the reference's weights
within 1e-9; the UDF, UDTF, FlatMap and FlattenKObject ops give the
reference's tables; the pandas and R ops raise."""

import numpy as np
import pytest

from torch_table_parity import (both, reference_session, remove_session,
                                same_table)

pytestmark = pytest.mark.usefixtures("cpu_device")


@pytest.fixture
def cpu_device(monkeypatch):
    monkeypatch.setenv("ALINK_TORCH_DEVICE", "cpu")


@pytest.fixture(scope="module")
def sid():
    s = reference_session()
    yield s
    remove_session(s)


def _data(n=256, seed=0):
    rng = np.random.default_rng(seed)
    a, b = rng.normal(size=n), rng.normal(size=n)
    return {"a": a, "b": b, "y": 2.0 * a - 3.0 * b + 0.5,
            "k": np.asarray([f"k{i % 5}" for i in range(n)], object)}


@pytest.mark.parametrize("seed", [0, 11, None])
def test_dataset_batches_equal_the_references(seed):
    from alink_tpu.common.mtable import MTable as RT
    from alink_tpu.operator.batch.script import ScriptContext as RC
    from alink_tpu_torch.common.mtable import MTable as PT
    from alink_tpu_torch.operator.batch.script import ScriptContext as PC

    cols = _data(101)
    ref = RC([RT(dict(cols))], None, {}, 16, 3)
    port = PC([PT(dict(cols))], None, {}, 16, 3)
    kw = dict(shuffle_seed=seed, cols=["a", "k"])
    rb, pb = list(ref.dataset(**kw)), list(port.dataset(**kw))
    assert len(pb) == len(rb) == 3 * 7
    for x, y in zip(pb, rb):
        assert x.keys() == y.keys()
        for k in y:
            np.testing.assert_array_equal(x[k], y[k])


TORCH_SCRIPT = '''
"""User training script: a small torch regressor fitted on the op's
dataset iterator on ctx.mesh's device (the torch twin of the reference's
flax script)."""
import numpy as np
import torch


def main(ctx):
    assert ctx.mesh is not None
    dev = ctx.mesh.device
    lr = float(ctx.user_params.get("lr", 1e-2))
    torch.manual_seed(0)
    net = torch.nn.Sequential(torch.nn.Linear(2, 16), torch.nn.ReLU(),
                              torch.nn.Linear(16, 1)).to(dev)
    opt = torch.optim.Adam(net.parameters(), lr)
    for batch in ctx.dataset(batch_size=32, epochs=40):
        x = torch.as_tensor(np.stack([batch["a"], batch["b"]], 1),
                            dtype=torch.float32, device=dev)
        y = torch.as_tensor(batch["y"], dtype=torch.float32, device=dev)
        loss = ((net(x)[:, 0] - y) ** 2).mean()
        opt.zero_grad()
        loss.backward()
        opt.step()
    t = ctx.table(0)
    xs = torch.as_tensor(np.stack([t.col("a"), t.col("b")], 1),
                         dtype=torch.float32, device=dev)
    with torch.no_grad():
        pred = net(xs)[:, 0].cpu().numpy()
    ctx.output({"a": np.asarray(t.col("a")), "pred": pred})
'''


def test_torch_script_file_trains(tmp_path):
    import alink_tpu_torch.operator.batch as P
    from alink_tpu_torch.common.mtable import MTable

    path = tmp_path / "user_train.py"
    path.write_text(TORCH_SCRIPT)
    cols = _data()
    out = P.TensorFlow2BatchOp(mainScriptFile=str(path),
                               userParams='{"lr": 0.02}').link_from(
        P.TableSourceBatchOp(MTable(dict(cols)))).collect()
    assert out.names == ["a", "pred"]
    truth = 2.0 * cols["a"] - 3.0 * cols["b"] + 0.5
    assert float(np.mean((np.asarray(out.col("pred")) - truth) ** 2)) < 0.1


def _normal_equations(ctx, to_tensor, solve):
    """Least squares accumulated over the context's shuffled batches."""
    xtx, xty = 0.0, 0.0
    for batch in ctx.dataset(batch_size=50, epochs=1, shuffle_seed=3):
        X = to_tensor(np.stack([batch["a"], batch["b"],
                                np.ones(len(batch["a"]))], 1))
        y = to_tensor(batch["y"])
        xtx = xtx + X.T @ X
        xty = xty + X.T @ y
    return solve(xtx, xty)


def test_least_squares_script_matches_the_references(sid):
    import torch

    def ref_main(ctx):
        w = _normal_equations(ctx, np.asarray, np.linalg.solve)
        return {"w": np.asarray(w)}

    def port_main(ctx):
        dev = ctx.mesh.device
        w = _normal_equations(
            ctx, lambda a: torch.as_tensor(a, dtype=torch.float64,
                                           device=dev), torch.linalg.solve)
        return {"w": w.cpu().numpy()}

    cols = _data(1_000, seed=4)
    ref, port = both(sid, cols, lambda ops, extra, src: ops.JaxScriptBatchOp(
        userFn=ref_main if ops.__name__.startswith("alink_tpu.") else
        port_main, outputSchemaStr="w double", **extra).link_from(src))
    np.testing.assert_allclose(port.col("w"), ref.col("w"), rtol=0,
                               atol=1e-9)
    np.testing.assert_allclose(port.col("w"), [2.0, -3.0, 0.5], atol=1e-9)


def test_user_fn_and_output_schema():
    import alink_tpu_torch.operator.batch as P
    from alink_tpu_torch.common.exceptions import AkIllegalArgumentException
    from alink_tpu_torch.common.mtable import MTable

    def main(ctx):
        t = ctx.table(0)
        return {"s": np.asarray(t.col("a")) + np.asarray(t.col("b"))}

    cols = _data(32)
    src = P.TableSourceBatchOp(MTable(dict(cols)))
    out = P.JaxScriptBatchOp(userFn=main, outputSchemaStr="s double"
                             ).link_from(src).collect()
    np.testing.assert_array_equal(out.col("s"), cols["a"] + cols["b"])
    with pytest.raises(AkIllegalArgumentException, match="declares"):
        P.JaxScriptBatchOp(userFn=main, outputSchemaStr="wrong double"
                           ).link_from(src).collect()


def test_legacy_func_shim_names_pandas():
    import alink_tpu_torch.operator.batch as P
    from alink_tpu_torch.common.exceptions import AkPluginNotExistException
    from alink_tpu_torch.common.mtable import MTable

    op = P.TensorFlow2BatchOp(func=lambda df: df).link_from(
        P.TableSourceBatchOp(MTable(dict(_data(8)))))
    with pytest.raises(AkPluginNotExistException, match="pandas"):
        op.collect()


def test_udf_udtf_and_py_fn_ops_match_the_reference(sid, tmp_path):
    cols = {"g": np.asarray(["a", "a", "b"], object),
            "x": np.asarray([1.0, 2.0, 3.0])}
    f = tmp_path / "fn.py"
    f.write_text("def udf(x):\n    return x * 10\n\n"
                 "def udtf(g, x):\n    for i in range(int(x)):\n"
                 "        yield (g + str(i), i * x)\n")
    builds = [
        lambda ops, extra, src: ops.UDFBatchOp(
            func=lambda x: x + 1, selectedCols=["x"], outputCol="y",
            **extra).link_from(src),
        lambda ops, extra, src: ops.PyScalarFnBatchOp(
            func=lambda g, x: f"{g}{x}", selectedCols=["g", "x"],
            outputCol="y", resultType="STRING", **extra).link_from(src),
        lambda ops, extra, src: ops.PyFileScalarFnBatchOp(
            str(f), selectedCols=["x"], outputCol="t", **extra)
        .link_from(src),
        lambda ops, extra, src: ops.UDTFBatchOp(
            func=lambda x: [(x, x * x)] * int(x), selectedCols=["x"],
            outputCols=["p", "q"], resultTypes=["DOUBLE", "DOUBLE"],
            **extra).link_from(src),
        lambda ops, extra, src: ops.PyFileTableFnBatchOp(
            str(f), selectedCols=["g", "x"], outputCols=["w", "v"],
            resultTypes=["STRING", "DOUBLE"], **extra).link_from(src),
        lambda ops, extra, src: ops.FlatMapBatchOp(
            func=lambda g, x: [(g, x), (g.upper(), -x)],
            resultSchemaStr="h string, z double", **extra).link_from(src)]
    for build in builds:
        ref, port = both(sid, cols, build)
        same_table(port, ref, rtol=0)


def test_flat_model_map_and_flatten_k_object_match_the_reference(sid):
    import alink_tpu.operator.batch as R
    import alink_tpu_torch.operator.batch as P
    from alink_tpu.common.mtable import MTable as RT
    from alink_tpu_torch.common.mtable import MTable as PT

    outs = []
    for ops, T, extra in ((R, RT, dict(MLEnvironmentId=sid)), (P, PT, {})):
        model = ops.TableSourceBatchOp(T({"w": np.asarray([2.0, 3.0])}))
        data = ops.TableSourceBatchOp(T({"x": np.asarray([1.0, 5.0])}))
        fm = ops.FlatModelMapBatchOp(
            func=lambda rows, x: [(x * r[0],) for r in rows],
            resultSchemaStr="y double", **extra).link_from(model, data)
        inner = T({"item": np.asarray(["i1", "i2"], object),
                   "score": np.asarray([0.9, 0.8])})
        nested = ops.TableSourceBatchOp(T(
            {"user": np.asarray(["u1", "u2"], object),
             "recs": np.asarray([inner, '[{"item": "i3", "score": 0.5}]'],
                                object)}, "user string, recs MTABLE"))
        fk = ops.FlattenKObjectBatchOp(
            selectedCol="recs", schemaStr="item STRING, score DOUBLE",
            **extra).link_from(nested)
        outs.append((fm.collect(), fk.collect()))
    for port, ref in zip(outs[1], outs[0]):
        same_table(port, ref, rtol=0)


@pytest.mark.parametrize("name,kw", [
    ("PandasUdfBatchOp", {}), ("BasePandasUdfBatchOp", {}),
    ("GroupPandasUdfBatchOp", dict(groupCols=["g"])),
    ("BaseGroupPandasUdfBatchOp", dict(groupCols=["g"]))])
def test_pandas_udf_ops_name_pandas(name, kw):
    import alink_tpu_torch.operator.batch as P
    from alink_tpu_torch.common.exceptions import AkPluginNotExistException
    from alink_tpu_torch.common.mtable import MTable

    op = getattr(P, name)(func=lambda df: df, **kw).link_from(
        P.TableSourceBatchOp(MTable({"g": np.asarray(["a"], object)})))
    with pytest.raises(AkPluginNotExistException, match="pandas"):
        op.collect()


def test_pandas_file_udfs_and_r_ops_raise(tmp_path):
    import alink_tpu_torch.operator.batch as P
    from alink_tpu_torch.common.exceptions import (
        AkPluginNotExistException, AkUnsupportedOperationException)
    from alink_tpu_torch.common.mtable import MTable

    f = tmp_path / "fn.py"
    f.write_text("def udf(df):\n    return df\n")
    src = P.TableSourceBatchOp(MTable({"g": np.asarray(["a"], object)}))
    for op in (P.PandasUdfFileBatchOp(str(f)),
               P.GroupPandasFileUdfBatchOp(str(f), groupCols=["g"])):
        with pytest.raises(AkPluginNotExistException, match="pandas"):
            op.link_from(src).collect()
    for cls in (P.RUdfBatchOp, P.GroupRBatchOp):
        with pytest.raises(AkUnsupportedOperationException, match="R is"):
            cls()
