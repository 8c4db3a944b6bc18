"""Rules of the port: ``alink_tpu_torch`` imports nothing of JAX, flax,
optax, orbax, msgpack, safetensors, TensorFlow or ``alink_tpu``, at module
level nothing but torch, numpy, scipy and the standard library (its only
dependencies), and its entry points never fall back to the CPU
quietly."""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = r"""
import importlib, pkgutil, sys
import alink_tpu_torch
names = [m.name for m in pkgutil.walk_packages(alink_tpu_torch.__path__,
                                               "alink_tpu_torch.")]
for n in names:
    importlib.import_module(n)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                                    "orbax", "msgpack", "safetensors",
                                    "tensorflow", "alink_tpu"))
print(len(names), ",".join(bad))
print(",".join(names))
"""


def test_port_imports_no_jax_flax_msgpack_or_reference():
    """Every module of the port imported in a fresh interpreter pulls in
    none of the forbidden packages, and chip_smoke.py neither."""
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    first, scanned = out.stdout.strip().split("\n")
    count, bad = first.split(" ", 1) if " " in first else (first, "")
    assert int(count) >= 20
    assert bad == "", f"port pulled in: {bad}"
    # the scan reaches every slice's modules, the tree and embedding
    # slices' included
    assert {"alink_tpu_torch.tree.grow", "alink_tpu_torch.tree.hist_cuda",
            "alink_tpu_torch.tree.binning",
            "alink_tpu_torch.operator.batch.tree",
            "alink_tpu_torch.embedding.skipgram",
            "alink_tpu_torch.embedding.sgns_cuda",
            "alink_tpu_torch.parallel.aps",
            "alink_tpu_torch.operator.batch.huge",
            "alink_tpu_torch.dl.train", "alink_tpu_torch.dl.checkpoint",
            "alink_tpu_torch.dl.pretrain", "alink_tpu_torch.graft_entry",
            "alink_tpu_torch.dl.data", "alink_tpu_torch.dl.pretrained",
            "alink_tpu_torch.operator.batch.dl",
            "alink_tpu_torch.common.staging",
            "alink_tpu_torch.parallel.comqueue",
            "alink_tpu_torch.optim.objfunc",
            "alink_tpu_torch.optim.optimizers",
            "alink_tpu_torch.optim.constrained",
            "alink_tpu_torch.operator.batch.linear",
            "alink_tpu_torch.operator.batch.clustering",
            "alink_tpu_torch.pipeline.base",
            "alink_tpu_torch.pipeline.pipeline",
            "alink_tpu_torch.pipeline.estimators",
            "alink_tpu_torch.pipeline.local_predictor",
            "alink_tpu_torch.common.streaming",
            "alink_tpu_torch.onnx.proto", "alink_tpu_torch.onnx.precision",
            "alink_tpu_torch.onnx.convert", "alink_tpu_torch.onnx.torchfx",
            "alink_tpu_torch.onnx.tfsaved", "alink_tpu_torch.dl.resnet",
            "alink_tpu_torch.operator.batch.modelpredict",
            "alink_tpu_torch.operator.stream.base",
            "alink_tpu_torch.operator.stream.modelpredict",
            "alink_tpu_torch.common.jitcache",
            "alink_tpu_torch.common.metrics",
            "alink_tpu_torch.common.tracing",
            "alink_tpu_torch.common.resilience",
            "alink_tpu_torch.common.catalog",
            "alink_tpu_torch.analysis.plancheck",
            "alink_tpu_torch.analysis.diagnostics",
            "alink_tpu_torch.serving.router",
            "alink_tpu_torch.serving.warmup_store",
            "alink_tpu_torch.webui.server"} \
        <= set(scanned.split(","))
    smoke = subprocess.run(
        [sys.executable, "-c", "import sys, chip_smoke; print(','.join(sorted("
         "m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', "
         "'flax', 'optax', 'orbax', 'msgpack', 'safetensors', 'tensorflow', "
         "'alink_tpu'))))"], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=120)
    assert smoke.returncode == 0 and smoke.stdout.strip() == "", smoke


def _module_level_imports(tree):
    """Root packages imported outside any function or class body (an
    ``if``/``try`` at module level counts as module level)."""
    roots = []
    stack = list(tree.body)
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            continue
        if isinstance(node, ast.Import):
            roots += [a.name.split(".")[0] for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0:
                roots.append(node.module.split(".")[0])
        else:
            stack.extend(ast.iter_child_nodes(node))
    return roots


def test_port_imports_only_torch_numpy_scipy_and_stdlib_at_module_level():
    """Every module of the port imports, at module level, only torch, numpy,
    scipy, the standard library and its own package: a GPU host with
    PyTorch need have nothing else (no pandas: the CSV source reads with
    ``csv``). Lazy imports inside a function, such as
    ``MTable.to_dataframe``'s pandas, stay allowed."""
    allowed = set(sys.stdlib_module_names) | {
        "torch", "numpy", "scipy", "alink_tpu_torch", "__future__"}
    root = os.path.join(REPO, "alink_tpu_torch")
    bad, files = {}, 0
    for dirpath, _, names in os.walk(root):
        for name in names:
            if not name.endswith(".py"):
                continue
            path = os.path.join(dirpath, name)
            with open(path) as f:
                tree = ast.parse(f.read(), path)
            files += 1
            extra = sorted(set(_module_level_imports(tree)) - allowed)
            if extra:
                bad[os.path.relpath(path, REPO)] = extra
    assert files >= 60
    assert bad == {}
    with open(os.path.join(root, "common", "mtable.py")) as f:
        mtable = f.read()
    assert "import pandas" in mtable
    assert "pandas" not in _module_level_imports(ast.parse(mtable))


def test_classical_entry_points_refuse_cpu_without_request(monkeypatch):
    import torch

    from alink_tpu_torch.common.exceptions import AkIllegalStateException
    from alink_tpu_torch.common.mtable import MTable
    from alink_tpu_torch.operator.batch import (KMeansPredictBatchOp,
                                                KMeansTrainBatchOp,
                                                SoftmaxTrainBatchOp,
                                                TableSourceBatchOp)
    from alink_tpu_torch.optim import (constrained_optimize, logistic_obj,
                                       optimize)
    from alink_tpu_torch.parallel import IterativeComQueue
    from alink_tpu_torch.pipeline import KMeans, Pipeline

    monkeypatch.delenv("ALINK_TORCH_DEVICE", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    X = np.random.default_rng(0).normal(size=(40, 3)).astype(np.float32)
    y = np.where(X[:, 0] > 0, 1.0, -1.0).astype(np.float32)
    src = TableSourceBatchOp(MTable({"a": X[:, 0], "b": X[:, 1],
                                     "label": (y > 0).astype(np.int64)}))
    queue = (IterativeComQueue().init_with_partitioned_data("x", X)
             .init_with_broadcast_data("s", 0.0)
             .add(lambda ctx, st, data: st).set_max_iter(1))
    for run in (lambda: optimize(logistic_obj(3), X, y),
                lambda: constrained_optimize(
                    logistic_obj(3), X, y, A_ub=np.ones((1, 3), np.float32),
                    b_ub=np.ones(1, np.float32)),
                queue.exec,
                lambda: KMeansTrainBatchOp(k=2, featureCols=["a", "b"])
                .link_from(src).collect(),
                lambda: SoftmaxTrainBatchOp(featureCols=["a", "b"],
                                            labelCol="label")
                .link_from(src).collect(),
                lambda: Pipeline(KMeans(k=2, featureCols=["a", "b"]))
                .fit(src)):
        with pytest.raises(AkIllegalStateException):
            run()
    # asking for the CPU, either way, runs there
    assert optimize(logistic_obj(3), X, y, device="cpu",
                    max_iter=3).num_iters == 3
    monkeypatch.setenv("ALINK_TORCH_DEVICE", "cpu")
    model = KMeansTrainBatchOp(k=2, featureCols=["a", "b"]).link_from(src)
    out = KMeansPredictBatchOp(predictionCol="c").link_from(
        model, src).collect()
    assert out.num_rows == 40


def test_entry_points_refuse_cpu_without_request(monkeypatch):
    import torch

    from alink_tpu_torch.common.env import MLEnvironment, resolve_device
    from alink_tpu_torch.common.exceptions import AkIllegalStateException
    from alink_tpu_torch.dl.modules import BertConfig, TransformerEncoder
    from alink_tpu_torch.dl.train import predict_model

    monkeypatch.delenv("ALINK_TORCH_DEVICE", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ids = {"input_ids": np.zeros((1, 4), np.int32)}
    model = TransformerEncoder(BertConfig.tiny(dtype=torch.float32))
    with pytest.raises(AkIllegalStateException):
        resolve_device()
    with pytest.raises(AkIllegalStateException):
        MLEnvironment().device
    with pytest.raises(AkIllegalStateException):
        predict_model(model, ids)
    # asking for the CPU, either way, runs there
    assert predict_model(model, ids, device="cpu").shape == (1, 2)
    monkeypatch.setenv("ALINK_TORCH_DEVICE", "cpu")
    assert resolve_device().type == "cpu"
    assert predict_model(model, ids).shape == (1, 2)


@pytest.mark.parametrize("precision,exc", [
    ("int8", None), ("bf16", None), ("fp16", "AkIllegalArgumentException")])
def test_unported_precision_policies_raise(precision, exc):
    """The quantized policies are ported: int8 and bf16 serve (and change
    the logits); an unknown precision raises."""
    import torch

    from alink_tpu_torch.common import exceptions
    from alink_tpu_torch.dl.modules import BertConfig, TransformerEncoder
    from alink_tpu_torch.dl.train import predict_model

    model = TransformerEncoder(BertConfig.tiny(dtype=torch.float32))
    ids = {"input_ids": np.arange(8, dtype=np.int32).reshape(2, 4)}
    if exc is not None:
        with pytest.raises(getattr(exceptions, exc)):
            predict_model(model, ids, device="cpu", precision=precision)
        return
    got = predict_model(model, ids, device="cpu", precision=precision)
    assert got.shape == (2, 2) and np.isfinite(got).all()
    assert not np.array_equal(got, predict_model(model, ids, device="cpu"))


def _tree_table(pkg_mtable):
    rng = np.random.default_rng(0)
    X = rng.random((64, 3))
    return pkg_mtable({"a": X[:, 0], "b": X[:, 1], "c": X[:, 2],
                       "label": (X[:, 0] > 0.5).astype(np.int64)})


def test_tree_entry_points_refuse_cpu_without_request(monkeypatch):
    import torch

    from alink_tpu_torch.common.exceptions import AkIllegalStateException
    from alink_tpu_torch.common.mtable import MTable
    from alink_tpu_torch.operator.batch import (GbdtTrainBatchOp,
                                                RandomForestPredictBatchOp,
                                                RandomForestTrainBatchOp,
                                                TableSourceBatchOp)
    from alink_tpu_torch.tree import train_forest, train_gbdt

    monkeypatch.delenv("ALINK_TORCH_DEVICE", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    X = np.random.default_rng(0).random((32, 3)).astype(np.float32)
    y = (X[:, 0] > 0.5).astype(np.float32)
    kw = dict(task="binary", num_trees=2, depth=2, num_bins=8)
    src = TableSourceBatchOp(_tree_table(MTable))
    for run in (lambda: train_forest(X, y, **kw),
                lambda: train_gbdt(X, y, **kw),
                lambda: RandomForestTrainBatchOp(labelCol="label")
                .link_from(src).collect(),
                lambda: GbdtTrainBatchOp(labelCol="label")
                .link_from(src).collect()):
        with pytest.raises(AkIllegalStateException):
            run()
    # asking for the CPU, either way, runs there
    ens = train_forest(X, y, device="cpu", **kw)
    assert train_gbdt(X, y, device="cpu", **kw).raw_predict(
        X, device="cpu").shape == (32, 1)
    with pytest.raises(AkIllegalStateException):
        ens.raw_predict(X)
    monkeypatch.setenv("ALINK_TORCH_DEVICE", "cpu")
    model = RandomForestTrainBatchOp(labelCol="label", numTrees=2,
                                     maxDepth=2).link_from(src)
    out = RandomForestPredictBatchOp(predictionCol="p").link_from(
        model, src).collect()
    assert out.num_rows == 64


@pytest.mark.parametrize("precision,exc", [
    ("int8", None), ("bf16", None), ("fp16", "AkIllegalArgumentException")])
def test_tree_mapper_unported_precision_policies_raise(monkeypatch,
                                                       precision, exc):
    """The tree mapper serves int8 and bf16 now; an unknown precision
    raises."""
    from alink_tpu_torch.common import exceptions
    from alink_tpu_torch.common.mtable import MTable
    from alink_tpu_torch.operator.batch import (GbdtPredictBatchOp,
                                                GbdtTrainBatchOp,
                                                TableSourceBatchOp)

    monkeypatch.setenv("ALINK_TORCH_DEVICE", "cpu")
    src = TableSourceBatchOp(_tree_table(MTable))
    model = GbdtTrainBatchOp(labelCol="label", numTrees=2,
                             maxDepth=2).link_from(src)
    op = GbdtPredictBatchOp(predictionCol="p", inferencePrecision=precision)
    if exc is not None:
        with pytest.raises(getattr(exceptions, exc)):
            op.link_from(model, src).collect()
        return
    assert op.link_from(model, src).collect().num_rows == 64


def test_embedding_entry_points_refuse_cpu_without_request(monkeypatch):
    import torch

    from alink_tpu_torch.common.exceptions import AkIllegalStateException
    from alink_tpu_torch.common.mtable import MTable
    from alink_tpu_torch.embedding import (SkipGramConfig, train_embedding,
                                           train_skipgram,
                                           train_skipgram_sharded)
    from alink_tpu_torch.operator.batch import (TableSourceBatchOp,
                                                Word2VecTrainBatchOp)

    monkeypatch.delenv("ALINK_TORCH_DEVICE", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pairs = np.asarray([[0, 1], [1, 2], [2, 0]] * 4, np.int32)
    counts = np.asarray([4.0, 4.0, 4.0])
    cfg = SkipGramConfig(dim=4, negatives=2, epochs=1, batch_size=4)
    src = TableSourceBatchOp(MTable({"doc": np.asarray(["a b c"] * 4,
                                                       object)}))
    for run in (lambda: train_skipgram_sharded(pairs, 3, counts, cfg),
                lambda: train_skipgram_sharded(pairs[:0], 3, counts, cfg),
                lambda: train_skipgram(pairs, 3, counts, cfg),
                lambda: train_embedding(pairs, 3, counts, cfg),
                lambda: Word2VecTrainBatchOp(selectedCol="doc")
                .link_from(src).collect()):
        with pytest.raises(AkIllegalStateException):
            run()
    # asking for the CPU, either way, runs there
    table = train_skipgram_sharded(pairs, 3, counts, cfg, device="cpu")
    assert table.array.device.type == "cpu"
    monkeypatch.setenv("ALINK_TORCH_DEVICE", "cpu")
    assert train_embedding(pairs, 3, counts, cfg).shape == (3, 4)


def test_training_entry_points_refuse_cpu_without_request(monkeypatch):
    import torch

    from alink_tpu_torch.common.exceptions import AkIllegalStateException
    from alink_tpu_torch.common.mtable import MTable
    from alink_tpu_torch.dl.modules import BertConfig, TransformerEncoder
    from alink_tpu_torch.dl.pretrain import pretrain_and_save, pretrain_mlm
    from alink_tpu_torch.dl.train import TrainConfig, train_model
    from alink_tpu_torch.graft_entry import entry
    from alink_tpu_torch.operator.batch import (
        BertTextClassifierTrainBatchOp, BertTextPairClassifierTrainBatchOp,
        BertTextRegressorTrainBatchOp, TableSourceBatchOp)

    monkeypatch.delenv("ALINK_TORCH_DEVICE", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    inputs = {"input_ids": np.zeros((4, 6), np.int32)}
    y = np.asarray([0, 1, 0, 1], np.int32)
    tc = TrainConfig(num_epochs=1, batch_size=2)
    src = TableSourceBatchOp(MTable({"text": ["a b", "c d"] * 2,
                                     "pair": ["x", "y"] * 2,
                                     "label": np.asarray([0, 1] * 2)}))
    kw = dict(textCol="text", labelCol="label", bertSize="tiny",
              maxSeqLength=8, numEpochs=1, batchSize=2)
    pre_kw = dict(hidden_size=8, num_layers=1, num_heads=2,
                  intermediate_size=16, max_len=8, epochs=1, batch_size=2)
    for run in (lambda: train_model(
                    TransformerEncoder(BertConfig.tiny(dtype=torch.float32)),
                    inputs, y, tc),
                lambda: BertTextClassifierTrainBatchOp(**kw)
                .link_from(src).collect(),
                lambda: BertTextRegressorTrainBatchOp(**kw)
                .link_from(src).collect(),
                lambda: BertTextPairClassifierTrainBatchOp(
                    textPairCol="pair", **kw).link_from(src).collect(),
                lambda: pretrain_mlm(["a b c", "d e f"], **pre_kw),
                lambda: pretrain_and_save(["a b c", "d e f"],
                                          os.devnull, **pre_kw),
                entry):
        with pytest.raises(AkIllegalStateException):
            run()
    # asking for the CPU, either way, runs there
    state, hist = train_model(
        TransformerEncoder(BertConfig.tiny(dtype=torch.float32)), inputs, y,
        tc, device="cpu")
    assert all(t.device.type == "cpu" for t in state.values())
    _, params, _, hist = pretrain_mlm(["a b c", "d e f"], device="cpu",
                                      **pre_kw)
    assert all(t.device.type == "cpu" for t in params.values())
    monkeypatch.setenv("ALINK_TORCH_DEVICE", "cpu")
    assert BertTextClassifierTrainBatchOp(**kw).link_from(
        src).collect().num_rows > 0
    assert len(pretrain_mlm(["a b c", "d e f"], **pre_kw)[3]) == 1


def test_tensorflow_is_imported_only_inside_require_tf():
    """The SavedModel ingest imports TensorFlow in ``_require_tf`` alone:
    no other function of the port names it, and no module level does."""
    root = os.path.join(REPO, "alink_tpu_torch")
    where = []
    for dirpath, _, names in os.walk(root):
        for name in names:
            if not name.endswith(".py"):
                continue
            path = os.path.join(dirpath, name)
            with open(path) as f:
                tree = ast.parse(f.read(), path)
            assert "tensorflow" not in _module_level_imports(tree)
            for fn in ast.walk(tree):
                if not isinstance(fn, (ast.FunctionDef,
                                       ast.AsyncFunctionDef)):
                    continue
                for node in ast.walk(fn):
                    mods = [a.name for a in node.names] \
                        if isinstance(node, ast.Import) else \
                        [node.module or ""] \
                        if isinstance(node, ast.ImportFrom) else []
                    if any(m.split(".")[0] == "tensorflow" for m in mods):
                        where.append((os.path.relpath(path, REPO), fn.name))
    assert set(where) == {("alink_tpu_torch/onnx/tfsaved.py", "_require_tf"),
                          ("alink_tpu_torch/onnx/tfsaved.py",
                           "load_saved_model_fn")}


def test_ingest_entry_points_refuse_cpu_without_request(monkeypatch,
                                                        tmp_path):
    import torch

    from alink_tpu_torch.common.exceptions import AkIllegalStateException
    from alink_tpu_torch.common.mtable import MTable
    from alink_tpu_torch.common.streaming import stream_map
    from alink_tpu_torch.onnx import (NodeProto, OnnxGraph, OnnxModel,
                                      OnnxToTorch, ValueInfo, load_onnx_fn,
                                      load_torch_fn)
    from alink_tpu_torch.operator.batch import (OnnxModelPredictBatchOp,
                                                TableSourceBatchOp,
                                                TorchModelPredictBatchOp)
    from alink_tpu_torch.operator.stream import (TableSourceStreamOp,
                                                 TorchModelPredictStreamOp)

    model = torch.nn.Linear(3, 1).eval()
    ep = torch.export.export(model, (torch.ones(2, 3),))
    pt2 = str(tmp_path / "m.pt2")
    torch.export.save(ep, pt2)
    onnx = str(tmp_path / "m.onnx")
    OnnxModel(OnnxGraph(
        nodes=[NodeProto("Relu", ["x"], ["y"])], initializers={},
        inputs=[ValueInfo("x", 1, (None, 3))],
        outputs=[ValueInfo("y", 1, (None, 3))])).save(onnx)
    X = np.ones((4, 3))
    t = MTable({"a": X[:, 0], "b": X[:, 1], "c": X[:, 2]})
    kw = dict(selectedCols=["a", "b", "c"], outputCols=["y"])

    monkeypatch.delenv("ALINK_TORCH_DEVICE", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for run in (lambda: load_torch_fn(ep),
                lambda: load_onnx_fn(onnx),
                lambda: OnnxToTorch(OnnxModel.load(onnx)),
                lambda: list(stream_map(lambda a: a, iter([(0, [X])]))),
                lambda: TorchModelPredictBatchOp(modelPath=pt2, **kw)
                .link_from(TableSourceBatchOp(t)).collect(),
                lambda: OnnxModelPredictBatchOp(modelPath=onnx, **kw)
                .link_from(TableSourceBatchOp(t)).collect(),
                lambda: TorchModelPredictStreamOp(modelPath=pt2, **kw)
                .link_from(TableSourceStreamOp(t)).collect()):
        with pytest.raises(AkIllegalStateException):
            run()
    # asking for the CPU, either way, runs there
    out = load_torch_fn(ep, device="cpu")[0](X.astype(np.float32))[0]
    assert out.device.type == "cpu" and out.shape == (4, 1)
    monkeypatch.setenv("ALINK_TORCH_DEVICE", "cpu")
    assert TorchModelPredictStreamOp(modelPath=pt2, **kw).link_from(
        TableSourceStreamOp(t, chunkSize=3)).collect().num_rows == 4
