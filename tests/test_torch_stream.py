"""The port's stream core (``common/streaming.py``, ``operator/stream/``) on
the CPU, held against ``alink_tpu``.

- ``stream_map`` yields in input order, never has more than ``depth``
  transfers in flight ahead of compute, fills ``phases``, and ``split`` hands
  the function a bit-identical batch.
- The foreign-model stream ops with a ``chunkSize`` that does not divide n
  equal the batch op exactly (the same graph on the same rows), and the
  reference's stream op within ATOL = 1e-5 (fp32, another framework's sum
  order).
- The stream core: sources, ``_FuncStreamOp``, ``MapStreamOp``'s
  dispatch/finalize overlap, ``ModelMapStreamOp``'s hot swap and ``_drain``,
  ``CsvSourceStreamOp``, and an empty stream's error.
"""

import numpy as np
import pytest

import torch

ATOL = 1e-5


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("ALINK_TORCH_DEVICE", "cpu")


def test_stream_map_keeps_order_and_depth_and_fills_phases():
    from alink_tpu_torch.common.streaming import iter_row_chunks, stream_map

    X = np.arange(103 * 3, dtype=np.float32).reshape(103, 3)
    pulled, consumed, ahead = [0], [0], []

    def batches():
        for meta, arrays in iter_row_chunks([X], 10):
            pulled[0] += 1
            ahead.append(pulled[0] - consumed[0])
            yield meta, arrays

    def fn(x):
        consumed[0] += 1
        return x.sum(dim=1)

    phases = {}
    out = list(stream_map(fn, batches(), depth=3, phases=phases))
    assert [m for m, _ in out] == [10] * 10 + [3]
    got = torch.cat([r for _, r in out]).numpy()
    np.testing.assert_array_equal(got, X.sum(axis=1))
    # a batch is pulled only while fewer than `depth` wait uncomputed
    assert max(ahead) <= 3 and ahead[:3] == [1, 2, 3]
    assert phases["batches"] == 11
    assert all(phases[k] >= 0 for k in ("transfer_s", "wait_s",
                                         "compute_s"))


@pytest.mark.parametrize("split", [1, 3, 7])
def test_stream_map_split_is_bit_identical(split):
    from alink_tpu_torch.common.streaming import stream_map

    rng = np.random.RandomState(0)
    batches = [(i, [rng.randn(13, 4).astype(np.float32),
                    rng.randint(0, 9, (13,))]) for i in range(4)]
    got = list(stream_map(lambda a, b: (a.clone(), b.clone()), iter(batches),
                          split=split, depth=2))
    for (i, (a, b)), (j, arrays) in zip(got, batches):
        assert i == j
        np.testing.assert_array_equal(a.numpy(), arrays[0])
        np.testing.assert_array_equal(b.numpy(), arrays[1])


def test_stream_depth_knob(monkeypatch):
    from alink_tpu_torch.common.streaming import stream_depth

    assert stream_depth() == 2
    monkeypatch.setenv("ALINK_STREAM_DEPTH", "5")
    assert stream_depth() == 5
    monkeypatch.setenv("ALINK_STREAM_DEPTH", "0")
    assert stream_depth() == 1


def _mlp_pt2(tmp_path):
    import torch.nn as nn

    torch.manual_seed(0)
    model = nn.Sequential(nn.Linear(16, 64), nn.ReLU(),
                          nn.Linear(64, 1)).eval()
    ep = torch.export.export(model, (torch.randn(4, 16),))
    path = str(tmp_path / "m.pt2")
    torch.export.save(ep, path)
    return model, path


def _table(pkg, X):
    import importlib

    mt = importlib.import_module(f"{pkg}.common.mtable")
    return mt.MTable({f"f{i}": X[:, i] for i in range(X.shape[1])})


@pytest.mark.parametrize("n,chunk,bs", [(103, 25, 16), (50, 7, 64)])
def test_torch_stream_op_equals_batch_op_and_reference(tmp_path, n, chunk,
                                                       bs):
    import alink_tpu.operator.stream as ref_stream
    from alink_tpu_torch.operator.batch import (TableSourceBatchOp,
                                                TorchModelPredictBatchOp)
    from alink_tpu_torch.operator.stream import (TableSourceStreamOp,
                                                 TorchModelPredictStreamOp)

    model, path = _mlp_pt2(tmp_path)
    X = np.random.RandomState(1).randn(n, 16)
    kw = dict(modelPath=path, selectedCols=[f"f{i}" for i in range(16)],
              outputCols=["score"], predictBatchSize=bs)
    t = _table("alink_tpu_torch", X)
    stream = TorchModelPredictStreamOp(**kw).link_from(
        TableSourceStreamOp(t, chunkSize=chunk)).collect()
    batch = TorchModelPredictBatchOp(**kw).link_from(
        TableSourceBatchOp(t)).collect()
    ref = ref_stream.TorchModelPredictStreamOp(**kw).link_from(
        ref_stream.TableSourceStreamOp(_table("alink_tpu", X),
                                       chunkSize=chunk)).collect()
    s = np.asarray(stream.col("score"))
    assert stream.num_rows == n and stream.schema == batch.schema
    np.testing.assert_array_equal(s, np.asarray(batch.col("score")))
    np.testing.assert_allclose(s, np.asarray(ref.col("score")), atol=ATOL)
    with torch.no_grad():
        direct = model(torch.from_numpy(X.astype(np.float32))).numpy()[:, 0]
    np.testing.assert_allclose(s, direct, atol=ATOL)


def test_onnx_stream_op_equals_batch_op(tmp_path):
    from alink_tpu_torch.onnx import NodeProto, OnnxGraph, OnnxModel, ValueInfo
    from alink_tpu_torch.onnx.proto import AttributeProto
    from alink_tpu_torch.operator.batch import (OnnxModelPredictBatchOp,
                                                TableSourceBatchOp)
    from alink_tpu_torch.operator.stream import (OnnxModelPredictStreamOp,
                                                 TableSourceStreamOp)

    rng = np.random.RandomState(2)
    W1, b1 = rng.randn(64, 16).astype(np.float32), rng.randn(64)
    W2, b2 = rng.randn(1, 64).astype(np.float32), rng.randn(1)
    tb = AttributeProto("transB", i=1)
    g = OnnxGraph(
        nodes=[NodeProto("Gemm", ["x", "W1", "b1"], ["h"],
                         attrs={"transB": tb}),
               NodeProto("Relu", ["h"], ["r"]),
               NodeProto("Gemm", ["r", "W2", "b2"], ["y"],
                         attrs={"transB": tb})],
        initializers={"W1": W1, "b1": b1.astype(np.float32), "W2": W2,
                      "b2": b2.astype(np.float32)},
        inputs=[ValueInfo("x", 1, (None, 16))],
        outputs=[ValueInfo("y", 1, (None, 1))])
    path = str(tmp_path / "m.onnx")
    OnnxModel(g).save(path)
    X = np.random.RandomState(3).randn(41, 16)
    kw = dict(modelPath=path, selectedCols=[f"f{i}" for i in range(16)],
              outputCols=["score"], predictBatchSize=8)
    t = _table("alink_tpu_torch", X)
    stream = OnnxModelPredictStreamOp(**kw).link_from(
        TableSourceStreamOp(t, chunkSize=12)).collect()
    batch = OnnxModelPredictBatchOp(**kw).link_from(
        TableSourceBatchOp(t)).collect()
    np.testing.assert_array_equal(np.asarray(stream.col("score")),
                                  np.asarray(batch.col("score")))
    want = np.maximum(X.astype(np.float32) @ W1.T + b1, 0) @ W2.T + b2
    np.testing.assert_allclose(np.asarray(stream.col("score")), want[:, 0],
                               rtol=1e-5, atol=1e-3)


def test_stream_core_ops(tmp_path):
    from alink_tpu_torch.common.exceptions import (
        AkIllegalOperationException, AkIllegalStateException)
    from alink_tpu_torch.common.mtable import MTable
    from alink_tpu_torch.operator.stream.base import (CsvSourceStreamOp,
                                                      MapStreamOp,
                                                      ModelMapStreamOp,
                                                      TableSourceStreamOp,
                                                      _FuncStreamOp, _drain)

    t = MTable({"a": np.arange(10.0)})
    sizes = [c.num_rows for c in TableSourceStreamOp(t, numChunks=3)
             ._stream()]
    assert sizes == [3, 3, 3, 1]
    doubled = _FuncStreamOp(lambda c: c.with_column("a", c.col("a") * 2)
                            if c.num_rows > 1 else None).link_from(
        TableSourceStreamOp(t, chunkSize=3)).collect()
    np.testing.assert_array_equal(doubled.col("a"), np.arange(9.0) * 2)
    with pytest.raises(AkIllegalStateException):
        _FuncStreamOp(lambda c: None).link_from(
            TableSourceStreamOp(t)).collect()
    with pytest.raises(AkIllegalOperationException):
        _FuncStreamOp(lambda c: c).link_from(TableSourceStreamOp(t),
                                             TableSourceStreamOp(t))

    class Plus(object):
        calls = []

        def __init__(self, schema, params):
            pass

        def dispatch_table(self, c):
            Plus.calls.append(("d", c.num_rows))
            return c

        def finalize_table(self, c):
            Plus.calls.append(("f", c.num_rows))
            return c.with_column("a", c.col("a") + 1)

    class PlusOp(MapStreamOp):
        mapper_cls = Plus

    out = PlusOp().link_from(TableSourceStreamOp(t, chunkSize=2)).collect()
    np.testing.assert_array_equal(out.col("a"), np.arange(10.0) + 1)
    # three chunks dispatched before the first is finalized
    assert [k for k, _ in Plus.calls[:4]] == ["d", "d", "d", "f"]

    class Scale:
        def __init__(self, model_schema, data_schema, params, k=None):
            self.k = k

        def load_model(self, model):
            return Scale(None, None, None, float(model.col("k")[0]))

        def create_new(self, model):
            return self.load_model(model)

        def map_table(self, c):
            return c.with_column("a", c.col("a") * self.k)

    class ScaleOp(ModelMapStreamOp):
        mapper_cls = Scale

    models = TableSourceStreamOp(MTable({"k": np.asarray([2.0, 3.0])}),
                                 chunkSize=1)
    out = ScaleOp().link_from(models, TableSourceStreamOp(
        t, chunkSize=5)).collect()
    np.testing.assert_array_equal(out.col("a"),
                                  np.r_[np.arange(5.0) * 2,
                                        np.arange(5.0, 10.0) * 3])
    assert _drain(iter([1, 2]), limit=5) == [1, 2]

    path = tmp_path / "x.csv"
    path.write_text("1,a\n2,b\n3,c\n")
    chunks = list(CsvSourceStreamOp(filePath=str(path),
                                    schemaStr="x double, s string",
                                    chunkSize=2)._stream())
    assert [c.num_rows for c in chunks] == [2, 1]
    assert list(chunks[1].col("s")) == ["c"]
