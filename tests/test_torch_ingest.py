"""The port's foreign-model ingest (``alink_tpu_torch/onnx/``: the ONNX codec
and converter, torch.export, the precision policy; the predict ops of
``operator/batch/modelpredict.py``) held against ``alink_tpu`` on the CPU.

- ONNX files written by either package's encoder are byte-identical and load
  in the other; the MLP, the conv graph and the SAME_UPPER/SAME_LOWER pads
  run through both converters on the same seeded inputs within ATOL = 1e-5
  (fp32: the two frameworks sum the products in other orders; measured gaps
  ~1e-7). ceil_mode pools, which the reference ignores (a defect there,
  ROADMAP), are held against torch's own pools at ATOL.
- torch.export: the reference tests' CNN and pooling cases within ATOL of
  both the reference and torch, the CNN at bf16 too; bench.py's ResNet-50
  topology at narrow width within ATOL (relative to the largest logit) of
  the module run in float64.
- The bfloat16 policy: port and reference within BF16_BAND = 0.05 of each
  other and of fp32 (the reference test's band), and different from fp32.
- The op manifests and the aten set are equal; an unsupported op raises the
  same exception class in both packages.
- The ops: a tail that predictBatchSize does not divide, n = 0, the
  outputCols count error, output schemas equal to the reference's.
"""

import numpy as np
import pytest

import torch

ATOL = 1e-5
BF16_BAND = 0.05


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("ALINK_TORCH_DEVICE", "cpu")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(v):
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) \
        else np.asarray(v)


def _pkgs():
    import alink_tpu.onnx as ref
    import alink_tpu_torch.onnx as port

    return ref, port


# -- ONNX ---------------------------------------------------------------------

def _mlp_graph(pkg, rng):
    W1 = rng.randn(4, 8).astype(np.float32)
    b1 = rng.randn(8).astype(np.float32)
    W2 = rng.randn(8, 3).astype(np.float32)
    b2 = rng.randn(3).astype(np.float32)
    return pkg.OnnxGraph(
        nodes=[
            pkg.NodeProto("Gemm", ["x", "W1", "b1"], ["h"]),
            pkg.NodeProto("Relu", ["h"], ["hr"]),
            pkg.NodeProto("Gemm", ["hr", "W2", "b2"], ["logits"]),
            pkg.NodeProto("Softmax", ["logits"], ["probs"]),
        ],
        initializers={"W1": W1, "b1": b1, "W2": W2, "b2": b2},
        inputs=[pkg.ValueInfo("x", 1, (None, 4))],
        outputs=[pkg.ValueInfo("probs", 1, (None, 3))],
    )


def _attr(pkg_name, name, **kw):
    import importlib

    proto = importlib.import_module(f"{pkg_name}.onnx.proto")
    return proto.AttributeProto(name, **kw)


def _conv_graph(pkg, pkg_name, rng, conv_attrs, pool_attrs, pool="MaxPool"):
    W = rng.randn(6, 3, 3, 3).astype(np.float32) * 0.2
    scale = np.abs(rng.randn(6).astype(np.float32)) + 0.5
    bias = rng.randn(6).astype(np.float32)
    mean = rng.randn(6).astype(np.float32) * 0.1
    var = np.abs(rng.randn(6).astype(np.float32)) + 0.5
    a = {k: _attr(pkg_name, k, **v) for k, v in conv_attrs.items()}
    p = {k: _attr(pkg_name, k, **v) for k, v in pool_attrs.items()}
    return pkg.OnnxGraph(
        nodes=[
            pkg.NodeProto("Conv", ["x", "W"], ["c"], attrs=a),
            pkg.NodeProto("BatchNormalization",
                          ["c", "scale", "bias", "mean", "var"], ["bn"]),
            pkg.NodeProto("Relu", ["bn"], ["r"]),
            pkg.NodeProto(pool, ["r"], ["p"], attrs=p),
            pkg.NodeProto("GlobalAveragePool", ["p"], ["gap"]),
            pkg.NodeProto("Flatten", ["gap"], ["y"]),
        ],
        initializers={"W": W, "scale": scale, "bias": bias,
                      "mean": mean, "var": var},
        inputs=[pkg.ValueInfo("x", 1, (None, 3, 9, 9))],
        outputs=[pkg.ValueInfo("y", 1, (None, 6))],
    )


def _write_both(tmp_path, build):
    """The same graph from both packages' encoders: byte-identical files."""
    ref, port = _pkgs()
    paths = {}
    for name, pkg in (("alink_tpu", ref), ("alink_tpu_torch", port)):
        paths[name] = str(tmp_path / f"{name}.onnx")
        pkg.OnnxModel(build(pkg, name)).save(paths[name])
    with open(paths["alink_tpu"], "rb") as a, \
            open(paths["alink_tpu_torch"], "rb") as b:
        assert a.read() == b.read()
    return paths


def _run_crossed(paths, x, out):
    """Each package runs the OTHER package's file; outputs as numpy."""
    ref, port = _pkgs()
    r = ref.OnnxToJax(ref.OnnxModel.load(paths["alink_tpu_torch"])).jitted()
    p = port.OnnxToTorch(port.OnnxModel.load(paths["alink_tpu"])).served()
    return np.asarray(r(x=x)[out]), _np(p(x=x)[out])


def test_onnx_mlp_files_cross_both_ways(tmp_path):
    paths = _write_both(tmp_path,
                        lambda pkg, _: _mlp_graph(pkg, np.random.RandomState(0)))
    _, port = _pkgs()
    m = port.OnnxModel.load(paths["alink_tpu"])
    assert [n.op_type for n in m.graph.nodes] == [
        "Gemm", "Relu", "Gemm", "Softmax"]
    x = np.random.RandomState(1).randn(7, 4).astype(np.float32)
    want, got = _run_crossed(paths, x, "probs")
    np.testing.assert_allclose(got, want, atol=ATOL)


CONV_CASES = {
    "explicit pads": ({"pads": dict(ints=(1, 1, 1, 1)),
                       "strides": dict(ints=(1, 1))},
                      {"kernel_shape": dict(ints=(2, 2)),
                       "strides": dict(ints=(2, 2))}),
    "asymmetric pads": ({"pads": dict(ints=(0, 1, 2, 1)),
                         "strides": dict(ints=(2, 1))},
                        {"kernel_shape": dict(ints=(3, 2)),
                         "pads": dict(ints=(1, 0, 0, 1))}),
    "SAME_UPPER": ({"auto_pad": dict(s=b"SAME_UPPER"),
                    "strides": dict(ints=(2, 2))},
                   {"kernel_shape": dict(ints=(2, 2)),
                    "auto_pad": dict(s=b"SAME_UPPER"),
                    "strides": dict(ints=(2, 2))}),
    "SAME_LOWER": ({"auto_pad": dict(s=b"SAME_LOWER"),
                    "strides": dict(ints=(2, 2))},
                   {"kernel_shape": dict(ints=(3, 3)),
                    "auto_pad": dict(s=b"SAME_LOWER"),
                    "strides": dict(ints=(2, 2))}),
}


@pytest.mark.parametrize("pool", ["MaxPool", "AveragePool"])
@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_onnx_conv_graph_matches_reference(tmp_path, case, pool):
    conv_attrs, pool_attrs = CONV_CASES[case]
    if pool == "AveragePool":
        pool_attrs = dict(pool_attrs, count_include_pad=dict(i=1))
    paths = _write_both(tmp_path, lambda pkg, name: _conv_graph(
        pkg, name, np.random.RandomState(2), conv_attrs, pool_attrs, pool))
    x = np.random.RandomState(3).randn(2, 3, 9, 9).astype(np.float32)
    want, got = _run_crossed(paths, x, "y")
    assert got.shape == want.shape == (2, 6)
    np.testing.assert_allclose(got, want, atol=ATOL)


def _pool_graph(pkg, pkg_name, op, attrs):
    a = {k: _attr(pkg_name, k, **v) for k, v in attrs.items()}
    return pkg.OnnxGraph(
        nodes=[pkg.NodeProto(op, ["x"], ["y"], attrs=a)],
        initializers={},
        inputs=[pkg.ValueInfo("x", 1, (None, 2, 7, 7))],
        outputs=[pkg.ValueInfo("y", 1, None)])


POOL_CASES = [
    # (op, kernel, stride, pads, ceil_mode, count_include_pad)
    ("MaxPool", 3, 2, 0, 1, 0),
    ("MaxPool", 2, 2, 1, 1, 0),
    ("AveragePool", 3, 2, 1, 1, 0),
    ("AveragePool", 3, 2, 1, 1, 1),
    ("AveragePool", 3, 2, 1, 0, 1),
    ("AveragePool", 3, 2, 1, 0, 0),
]


@pytest.mark.parametrize("op,k,s,p,ceil,include", POOL_CASES)
def test_onnx_pools_match_torch(op, k, s, p, ceil, include):
    """ceil_mode and count_include_pad as torch computes them; where ceil
    mode is off the reference agrees too."""
    import torch.nn.functional as F

    ref, port = _pkgs()
    attrs = {"kernel_shape": dict(ints=(k, k)), "strides": dict(ints=(s, s)),
             "pads": dict(ints=(p,) * 4), "ceil_mode": dict(i=ceil)}
    if op == "AveragePool":
        attrs["count_include_pad"] = dict(i=include)
    x = np.random.RandomState(4).randn(2, 2, 7, 7).astype(np.float32)
    g = _pool_graph(port, "alink_tpu_torch", op, attrs)
    got = _np(port.OnnxToTorch(port.OnnxModel(g)).served()(x=x)["y"])
    xt = torch.from_numpy(x)
    if op == "MaxPool":
        want = F.max_pool2d(xt, k, s, p, ceil_mode=bool(ceil)).numpy()
    else:
        want = F.avg_pool2d(xt, k, s, p, ceil_mode=bool(ceil),
                            count_include_pad=bool(include)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL)
    if not ceil:
        rg = _pool_graph(ref, "alink_tpu", op, attrs)
        r = np.asarray(ref.OnnxToJax(ref.OnnxModel(rg)).jitted()(x=x)["y"])
        np.testing.assert_allclose(got, r, atol=ATOL)


def test_onnx_shape_ops_fold_on_host_and_match_reference():
    """Shape → Gather (a negative index) → Concat → Reshape with 0 and −1,
    a negative-step Slice and a reflect Pad: the shape chain folds on the
    host (numpy), the data ops run as tensors; both packages agree."""
    ref, port = _pkgs()

    def graph(pkg, name):
        i64 = lambda *v: np.asarray(v, np.int64)  # noqa: E731
        return pkg.OnnxGraph(
            nodes=[
                pkg.NodeProto("Shape", ["x"], ["s"]),
                pkg.NodeProto("Gather", ["s", "last"], ["d"]),
                pkg.NodeProto("Concat", ["zero", "d", "neg1"], ["shape"],
                              attrs={"axis": _attr(name, "axis", i=0)}),
                pkg.NodeProto("Reshape", ["x", "shape"], ["r"]),
                pkg.NodeProto("Slice", ["r", "st", "en", "ax", "step"],
                              ["sl"]),
                pkg.NodeProto("Pad", ["sl", "pads"], ["y"],
                              attrs={"mode": _attr(name, "mode",
                                                   s=b"reflect")}),
            ],
            initializers={"last": i64(-1), "zero": i64(0), "neg1": i64(-1),
                          "st": i64(-1), "en": i64(-(2 ** 63)),
                          "ax": i64(1), "step": i64(-2),
                          "pads": i64(0, 1, 0, 0, 2, 0, 0, 0)},
            inputs=[pkg.ValueInfo("x", 1, (None, 4, 3))],
            outputs=[pkg.ValueInfo("y", 1, None)])

    x = np.random.RandomState(5).randn(2, 4, 3).astype(np.float32)
    want = np.asarray(ref.OnnxToJax(ref.OnnxModel(graph(ref, "alink_tpu")))
                      .jitted()(x=x)["y"])
    got = _np(port.OnnxToTorch(port.OnnxModel(
        graph(port, "alink_tpu_torch"))).served()(x=x)["y"])
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_op_manifests_and_aten_set_equal():
    from alink_tpu.onnx import torchfx as ref_fx
    from alink_tpu_torch.onnx import torchfx as port_fx

    ref, port = _pkgs()
    assert port.supported_onnx_ops() == ref.supported_onnx_ops()
    ref_fx._ensure_aten_registered()
    port_fx._ensure_aten_registered()
    assert sorted(port_fx._ATEN) == sorted(ref_fx._ATEN)
    assert ref.__all__ == [n.replace("ToTorch", "ToJax").replace(
        "TorchExportToJax", "TorchToJax") for n in port.__all__]


def test_unsupported_ops_raise_the_same_class(tmp_path):
    ref, port = _pkgs()
    paths = _write_both(tmp_path, lambda pkg, _: pkg.OnnxGraph(
        nodes=[pkg.NodeProto("CumSum", ["x", "ax"], ["y"])],
        initializers={"ax": np.asarray(1, np.int64)},
        inputs=[pkg.ValueInfo("x", 1, (None, 3))],
        outputs=[pkg.ValueInfo("y", 1, (None, 3))]))
    x = np.ones((2, 3), np.float32)
    errs = []
    for run in (lambda: ref.load_onnx_fn(paths["alink_tpu"])[0](x=x),
                lambda: port.load_onnx_fn(paths["alink_tpu"])[0](x=x)):
        with pytest.raises(Exception) as e:
            run()
        errs.append(type(e.value).__name__)

    class Cum(torch.nn.Module):
        def forward(self, v):
            return torch.cumsum(v, 1)

    ep = torch.export.export(Cum(), (torch.ones(2, 3),))
    for pkg in (ref, port):
        with pytest.raises(Exception) as e:
            fn, _ = pkg.load_torch_fn(ep)
            fn(x)
        errs.append(type(e.value).__name__)
        with pytest.raises(Exception) as e:
            pkg.load_torch_fn("model.pt")
        errs.append(type(e.value).__name__)
    assert errs == ["AkUnsupportedOperationException"] * 2 + [
        "AkUnsupportedOperationException", "AkIllegalArgumentException"] * 2


# -- torch.export ---------------------------------------------------------------

def test_torch_cnn_matches_reference_and_torch():
    import torch.nn as nn

    ref, port = _pkgs()
    torch.manual_seed(1)
    cnn = nn.Sequential(
        nn.Conv2d(3, 8, 3, stride=2, padding=1), nn.BatchNorm2d(8), nn.ReLU(),
        nn.MaxPool2d(2), nn.Conv2d(8, 16, 3, padding=1, groups=2), nn.ReLU(),
        nn.AdaptiveAvgPool2d(1), nn.Flatten(), nn.Linear(16, 5),
        nn.Softmax(dim=-1),
    ).eval()
    x = torch.randn(2, 3, 16, 16)
    ep = torch.export.export(cnn, (x,))
    got = _np(port.load_torch_fn(ep)[0](x.numpy())[0])
    want = np.asarray(ref.load_torch_fn(ep)[0](x.numpy())[0])
    with torch.no_grad():
        direct = cnn(x).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)
    np.testing.assert_allclose(got, direct, atol=ATOL)
    # bf16: the BatchNorm and the casts by the reference's dtype rules
    got16 = _np(port.load_torch_fn(ep, dtype="bfloat16")[0](x.numpy())[0])
    want16 = np.asarray(ref.load_torch_fn(ep, dtype="bfloat16")[0](
        x.numpy())[0])
    assert got16.dtype == np.float32
    np.testing.assert_allclose(got16, want16, atol=BF16_BAND)
    np.testing.assert_allclose(got16, direct, atol=BF16_BAND)
    assert not np.array_equal(got16, got)


@pytest.mark.parametrize("mod", [
    "AvgPool2d(2, stride=2, padding=1)",
    "AvgPool2d(3, stride=2, padding=1, count_include_pad=False)",
    "MaxPool2d(3, stride=2, ceil_mode=True)",
    "MaxPool2d(3, stride=1, dilation=2)",
])
def test_torch_pooling_semantics_match(mod):
    import torch.nn as nn

    ref, port = _pkgs()
    torch.manual_seed(2)
    m = eval(f"nn.{mod}").eval()
    x = torch.randn(1, 2, 6, 6)
    ep = torch.export.export(m, (x,))
    got = _np(port.load_torch_fn(ep)[0](x.numpy())[0])
    want = np.asarray(ref.load_torch_fn(ep)[0](x.numpy())[0])
    with torch.no_grad():
        direct = m(x).numpy()
    assert got.shape == want.shape == direct.shape
    np.testing.assert_allclose(got, want, atol=ATOL)
    np.testing.assert_allclose(got, direct, atol=ATOL)


def _narrow_resnet50(width=8, classes=10):
    """bench.py's ResNet-50 (stages 3, 4, 6, 3 of bottlenecks; the stem,
    BatchNorm, max pool, adaptive pool and head) at planes width·(1, 2, 4,
    8), default init and BatchNorm statistics drawn from a seed."""
    import torch.nn as nn

    class Bottleneck(nn.Module):
        def __init__(self, cin, planes, stride=1):
            super().__init__()
            cout = planes * 4
            self.conv1 = nn.Conv2d(cin, planes, 1, bias=False)
            self.bn1 = nn.BatchNorm2d(planes)
            self.conv2 = nn.Conv2d(planes, planes, 3, stride=stride,
                                   padding=1, bias=False)
            self.bn2 = nn.BatchNorm2d(planes)
            self.conv3 = nn.Conv2d(planes, cout, 1, bias=False)
            self.bn3 = nn.BatchNorm2d(cout)
            self.relu = nn.ReLU()
            self.down = None
            if stride != 1 or cin != cout:
                self.down = nn.Sequential(
                    nn.Conv2d(cin, cout, 1, stride=stride, bias=False),
                    nn.BatchNorm2d(cout))

        def forward(self, x):
            identity = self.down(x) if self.down is not None else x
            out = self.relu(self.bn1(self.conv1(x)))
            out = self.relu(self.bn2(self.conv2(out)))
            out = self.bn3(self.conv3(out))
            return self.relu(out + identity)

    torch.manual_seed(0)
    layers, cin = [], width
    for planes, blocks, stride in ((width, 3, 1), (2 * width, 4, 2),
                                   (4 * width, 6, 2), (8 * width, 3, 2)):
        for b in range(blocks):
            layers.append(Bottleneck(cin, planes, stride if b == 0 else 1))
            cin = planes * 4
    model = nn.Sequential(
        nn.Conv2d(3, width, 7, stride=2, padding=3, bias=False),
        nn.BatchNorm2d(width), nn.ReLU(), nn.MaxPool2d(3, stride=2, padding=1),
        *layers, nn.AdaptiveAvgPool2d(1), nn.Flatten(),
        nn.Linear(cin, classes)).eval()
    g = torch.Generator().manual_seed(1)
    for m in model.modules():
        if isinstance(m, nn.BatchNorm2d):
            m.running_mean.copy_(0.1 * torch.randn(m.num_features,
                                                   generator=g))
            m.running_var.copy_(0.5 + torch.rand(m.num_features,
                                                 generator=g))
    return model


def test_resnet50_topology_at_narrow_width():
    """bench.py's ResNet-50 through the port's torch.export route against
    the module in float64: fp32 within ATOL of the largest logit."""
    _, port = _pkgs()
    model = _narrow_resnet50()
    x = torch.from_numpy(np.random.RandomState(6).rand(4, 3, 32, 32)
                         .astype(np.float32))
    ep = torch.export.export(model, (x,))
    with torch.no_grad():
        want = model.double()(x.double()).numpy()
    scale = np.abs(want).max()
    got = _np(port.load_torch_fn(ep)[0](x)[0])
    assert got.shape == (4, 10)
    assert np.abs(got - want).max() <= ATOL * scale


# -- the predict ops -------------------------------------------------------------

def _mlp_pt2(tmp_path, d_in=8, hidden=32, d_out=1, seed=0):
    import torch.nn as nn

    torch.manual_seed(seed)
    model = nn.Sequential(nn.Linear(d_in, hidden), nn.ReLU(),
                          nn.LayerNorm(hidden),
                          nn.Linear(hidden, d_out)).eval()
    ep = torch.export.export(model, (torch.randn(4, d_in),))
    path = str(tmp_path / f"mlp{d_out}.pt2")
    torch.export.save(ep, path)
    return model, path


def _ops(pkg_name):
    import importlib

    return (importlib.import_module(f"{pkg_name}.operator.batch"),
            importlib.import_module(f"{pkg_name}.common.mtable"))


def _predict(pkg_name, op_name, X, **params):
    ops, mt = _ops(pkg_name)
    t = mt.MTable({f"f{i}": X[:, i] for i in range(X.shape[1])})
    op = getattr(ops, op_name)(
        selectedCols=[f"f{i}" for i in range(X.shape[1])], **params
    ).link_from(ops.TableSourceBatchOp(t))
    return op.schema, op.collect()


@pytest.mark.parametrize("n,bs", [(10, 4), (3, 8), (0, 4)])
def test_torch_op_tail_and_empty_tables_match_reference(tmp_path, n, bs):
    model, path = _mlp_pt2(tmp_path)
    X = np.random.RandomState(7).randn(n, 8)
    outs = {}
    for pkg in ("alink_tpu", "alink_tpu_torch"):
        schema, out = _predict(pkg, "TorchModelPredictBatchOp", X,
                               modelPath=path, outputCols=["score"],
                               predictBatchSize=bs)
        assert schema.names == [f"f{i}" for i in range(8)] + ["score"]
        assert schema.type_of("score") == "DOUBLE"
        assert out.num_rows == n
        outs[pkg] = np.asarray(out.col("score"), np.float64)
    with torch.no_grad():
        direct = model(torch.from_numpy(X.astype(np.float32))).numpy()[:, 0]
    np.testing.assert_allclose(outs["alink_tpu_torch"], outs["alink_tpu"],
                               atol=ATOL)
    np.testing.assert_allclose(outs["alink_tpu_torch"], direct, atol=ATOL)


def test_onnx_op_schema_and_values_match_reference(tmp_path):
    paths = _write_both(tmp_path,
                        lambda pkg, _: _mlp_graph(pkg, np.random.RandomState(8)))
    X = np.random.RandomState(9).randn(9, 4)
    res = {}
    for pkg in ("alink_tpu", "alink_tpu_torch"):
        schema, out = _predict(pkg, "OnnxModelPredictBatchOp", X,
                               modelPath=paths[pkg], outputCols=["probs"],
                               predictBatchSize=4)
        assert schema.type_of("probs") == "TENSOR"
        res[pkg] = (schema.names, np.stack(list(out.col("probs"))))
    assert res["alink_tpu"][0] == res["alink_tpu_torch"][0]
    np.testing.assert_allclose(res["alink_tpu_torch"][1],
                               res["alink_tpu"][1], atol=ATOL)


def test_output_cols_count_error_in_both(tmp_path):
    _, path = _mlp_pt2(tmp_path)
    X = np.random.RandomState(10).randn(5, 8)
    names = []
    for pkg in ("alink_tpu", "alink_tpu_torch"):
        with pytest.raises(Exception, match="outputCols has 2 names") as e:
            _predict(pkg, "TorchModelPredictBatchOp", X, modelPath=path,
                     outputCols=["a", "b"])
        names.append(type(e.value).__name__)
    assert names == ["AkIllegalArgumentException"] * 2


def test_bfloat16_policy_matches_reference_band(tmp_path):
    """precision="bfloat16" on the torch and ONNX ops: outputs fp32-typed,
    within BF16_BAND of fp32 and of the reference's bf16, and moved off
    fp32 (the policy engaged)."""
    _, path = _mlp_pt2(tmp_path)
    X = np.random.RandomState(11).randn(64, 8)
    onnx_paths = _write_both(
        tmp_path, lambda pkg, _: _mlp_graph(pkg, np.random.RandomState(12)))
    Xo = np.random.RandomState(13).randn(32, 4)
    for op, Xi, kw, col in (
            ("TorchModelPredictBatchOp", X, dict(modelPath=path), "s"),
            ("OnnxModelPredictBatchOp", Xo,
             dict(modelPath=onnx_paths["alink_tpu"], predictBatchSize=8),
             "p")):
        vals = {}
        for pkg in ("alink_tpu", "alink_tpu_torch"):
            for prec in ("float32", "bfloat16"):
                _, out = _predict(pkg, op, Xi, outputCols=[col],
                                  precision=prec, **kw)
                vals[pkg, prec] = np.stack([np.asarray(v, np.float64)
                                            for v in out.col(col)])
        p32, p16 = vals["alink_tpu_torch", "float32"], \
            vals["alink_tpu_torch", "bfloat16"]
        np.testing.assert_allclose(p16, p32, atol=BF16_BAND, rtol=BF16_BAND)
        np.testing.assert_allclose(p16, vals["alink_tpu", "bfloat16"],
                                   atol=BF16_BAND, rtol=BF16_BAND)
        assert not np.array_equal(p16, p32)


def test_stablehlo_ops_raise_in_the_port(tmp_path):
    from alink_tpu_torch.common.exceptions import \
        AkUnsupportedOperationException
    from alink_tpu_torch.common.mtable import MTable
    from alink_tpu_torch.operator.batch import (StableHloModelPredictBatchOp,
                                                TableSourceBatchOp)
    from alink_tpu_torch.operator.stream import (StableHloModelPredictStreamOp,
                                                 TableSourceStreamOp)

    t = MTable({"a": np.zeros(3)})
    with pytest.raises(AkUnsupportedOperationException, match="torch.export"):
        StableHloModelPredictBatchOp(modelPath="m.hlo", selectedCols=["a"]) \
            .link_from(TableSourceBatchOp(t)).collect()
    with pytest.raises(AkUnsupportedOperationException, match="torch.export"):
        StableHloModelPredictStreamOp(modelPath="m.hlo", selectedCols=["a"]) \
            .link_from(TableSourceStreamOp(t, chunkSize=2)).collect()
    with pytest.raises(AkUnsupportedOperationException, match="bfloat16"):
        StableHloModelPredictBatchOp(modelPath="m.hlo", selectedCols=["a"],
                                     precision="bfloat16") \
            .link_from(TableSourceBatchOp(t)).collect()
