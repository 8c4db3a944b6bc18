"""Rules of the port: ``alink_tpu_torch`` imports nothing of JAX, flax,
optax, orbax, msgpack, safetensors, TensorFlow or ``alink_tpu``, at module
level nothing but torch, numpy, scipy and the standard library (its only
dependencies), nowhere pandas, pyarrow, fsspec or openpyxl (the card has
none of them), and its entry points never fall back to the CPU
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
                                    "tensorflow", "alink_tpu", "pandas",
                                    "pyarrow", "fsspec", "openpyxl"))
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
            "alink_tpu_torch.serving.fleet",
            "alink_tpu_torch.serving.fleet_frontend",
            "alink_tpu_torch.common.faults",
            "alink_tpu_torch.common.telemetry",
            "alink_tpu_torch.common.elastic",
            "alink_tpu_torch.parallel.distributed",
            "alink_tpu_torch.modelstream.store",
            "alink_tpu_torch.modelstream.publisher",
            "alink_tpu_torch.webui.server",
            "alink_tpu_torch.common.executor",
            "alink_tpu_torch.common.profiling",
            "alink_tpu_torch.io.filesystem",
            "alink_tpu_torch.operator.sql",
            "alink_tpu_torch.operator.sqlengine",
            "alink_tpu_torch.stats.prob", "alink_tpu_torch.stats.summarizer",
            "alink_tpu_torch.operator.batch.statistics",
            "alink_tpu_torch.operator.batch.evaluation",
            "alink_tpu_torch.operator.batch.classification",
            "alink_tpu_torch.operator.batch.regression",
            "alink_tpu_torch.operator.batch.sources",
            "alink_tpu_torch.pipeline.tuning",
            "alink_tpu_torch.io.tfrecord",
            "alink_tpu_torch.operator.batch.clustering2",
            "alink_tpu_torch.operator.batch.dataproc",
            "alink_tpu_torch.operator.batch.feature",
            "alink_tpu_torch.operator.batch.feature2",
            "alink_tpu_torch.operator.batch.feature3",
            "alink_tpu_torch.operator.batch.vector",
            "alink_tpu_torch.operator.batch.vector2",
            "alink_tpu_torch.graph.engine",
            "alink_tpu_torch.operator.batch.graph",
            "alink_tpu_torch.operator.batch.associationrule",
            "alink_tpu_torch.operator.batch.similarity",
            "alink_tpu_torch.operator.batch.feature4",
            "alink_tpu_torch.operator.batch.nlp",
            "alink_tpu_torch.operator.batch.nlp2",
            "alink_tpu_torch.recommendation.als",
            "alink_tpu_torch.recommendation.cf",
            "alink_tpu_torch.outlier.detectors",
            "alink_tpu_torch.operator.local",
            "alink_tpu_torch.operator.stream.modelstream",
            "alink_tpu_torch.operator.batch.recommendation",
            "alink_tpu_torch.operator.batch.recommendation2",
            "alink_tpu_torch.operator.batch.outlier",
            "alink_tpu_torch.operator.batch.utils2",
            "alink_tpu_torch.operator.batch.finance",
            "alink_tpu_torch.operator.batch.misc2"} \
        <= set(scanned.split(","))
    smoke = subprocess.run(
        [sys.executable, "-c", "import sys, chip_smoke; print(','.join(sorted("
         "m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', "
         "'flax', 'optax', 'orbax', 'msgpack', 'safetensors', 'tensorflow', "
         "'alink_tpu'))))"], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=120)
    assert smoke.returncode == 0 and smoke.stdout.strip() == "", smoke


_WORKER_ENTRY = r"""
import runpy, sys
try:
    runpy.run_module("alink_tpu_torch.serving.fleet", run_name="__main__",
                     alter_sys=True)
except SystemExit as e:
    code = e.code
print(code)
print(",".join(sorted(m for m in sys.modules
                      if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                                             "orbax", "msgpack", "safetensors",
                                             "tensorflow", "alink_tpu"))))
"""


def test_fleet_worker_entry_imports_no_jax_or_reference():
    """The fleet's worker entry, run as the supervisor runs it (``python
    -m alink_tpu_torch.serving.fleet``; here without its config, so it
    refuses with exit code 2), pulls in none of the forbidden packages."""
    env = dict(os.environ, PYTHONPATH=REPO)
    env.pop("ALINK_FLEET_WORKER", None)
    out = subprocess.run([sys.executable, "-c", _WORKER_ENTRY], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    code, bad = (out.stdout.strip().split("\n") + [""])[:2]
    assert code == "2" and "ALINK_FLEET_WORKER" in out.stderr
    assert bad == "", f"the worker entry pulled in: {bad}"
    assert "alink_tpu_torch.serving.fleet" in out.stderr


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


def _all_imports(tree):
    """Root packages imported anywhere in the module, function bodies
    included."""
    roots = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots += [a.name.split(".")[0] for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.append(node.module.split(".")[0])
    return roots


def test_port_imports_only_torch_numpy_scipy_and_stdlib_at_module_level():
    """Every module of the port imports, at module level, only torch, numpy,
    scipy, the standard library and its own package: a GPU host with
    PyTorch need have nothing else. Lazy imports inside a function stay
    allowed, except pandas, pyarrow, fsspec and openpyxl, which no module
    imports anywhere (the CSV ops read and write with ``csv``, the SQL ops
    evaluate over numpy, ``memory://`` is the port's own store)."""
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
            banned = sorted(set(_all_imports(tree)) & {
                "pandas", "pyarrow", "fsspec", "openpyxl"})
            if banned:
                bad[os.path.relpath(path, REPO)] = banned
    assert files >= 60
    assert bad == {}


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


def test_graph_text_and_neighbour_entry_points_refuse_cpu_without_request(
        monkeypatch):
    """The graph engine, the graph ops on it, BRUTE vector neighbours,
    NaiveBayesText, TextRank keywords and the constrained trainers run on
    the card: without one they raise unless the CPU is asked for."""
    import json

    import torch

    from alink_tpu_torch.common.exceptions import AkIllegalStateException
    from alink_tpu_torch.common.mtable import AlinkTypes, MTable, TableSchema
    from alink_tpu_torch.graph import MemoryGraph, connected_components, \
        pagerank
    from alink_tpu_torch.operator import batch as B
    from alink_tpu_torch.pipeline import NaiveBayesTextClassifier, Pipeline

    edges = B.TableSourceBatchOp(MTable({
        "source": np.asarray(["a", "b", "c"], object),
        "target": np.asarray(["b", "c", "a"], object)}))
    g = MemoryGraph(3, np.array([0, 1]), np.array([1, 2]))
    vecs = B.TableSourceBatchOp(MTable(
        {"id": np.asarray(["x", "y"], object),
         "v": np.asarray(["1 0", "0 1"], object)},
        TableSchema(["id", "v"], [AlinkTypes.STRING,
                                  AlinkTypes.DENSE_VECTOR])))
    counts = B.TableSourceBatchOp(MTable(
        {"v": np.asarray(["$3$0:1", "$3$2:2"], object),
         "y": np.asarray([0, 1], np.int64)},
        TableSchema(["v", "y"], [AlinkTypes.SPARSE_VECTOR,
                                 AlinkTypes.LONG])))
    docs = B.TableSourceBatchOp(MTable(
        {"t": np.asarray(["graph ranks graph nodes"], object)}))
    rng = np.random.default_rng(0)
    X = rng.normal(size=(40, 2))
    lin = B.TableSourceBatchOp(MTable(
        {"a": X[:, 0], "b": X[:, 1],
         "y": (X[:, 0] + rng.logistic(size=40) > 0).astype(np.int64)}))
    cons = json.dumps({"A_eq": [[0.0, 1.0, 0.0]], "b_eq": [0.0]})
    nn_model = B.VectorNearestNeighborTrainBatchOp(
        idCol="id", selectedCol="v").link_from(vecs)
    runs = [lambda: pagerank(g), lambda: connected_components(g)]
    for op in (B.PageRankBatchOp(), B.ConnectedComponentsBatchOp(),
               B.KCoreBatchOp(k=1),
               B.SingleSourceShortestPathBatchOp(sourcePoint="a"),
               B.MultiSourceShortestPathBatchOp(sourcePoints=["a"]),
               B.CommunityDetectionClusterBatchOp()):
        runs.append(lambda op=op: op.link_from(edges).collect())
    runs += [
        lambda: B.VectorNearestNeighborPredictBatchOp(selectedCol="v")
        .link_from(nn_model, vecs).collect(),
        lambda: B.NaiveBayesTextTrainBatchOp(vectorCol="v", labelCol="y")
        .link_from(counts).collect(),
        lambda: Pipeline(NaiveBayesTextClassifier(
            vectorCol="v", labelCol="y", predictionCol="p")).fit(counts),
        lambda: B.KeywordsExtractionBatchOp(selectedCol="t")
        .link_from(docs).collect(),
        lambda: B.ConstrainedLogisticRegressionTrainBatchOp(
            labelCol="y", featureCols=["a", "b"], constraint=cons)
        .link_from(lin).collect(),
        lambda: B.ConstrainedLinearRegTrainBatchOp(
            labelCol="y", featureCols=["a", "b"], constraint=cons)
        .link_from(lin).collect(),
        lambda: B.ConstrainedDivergenceTrainBatchOp(
            labelCol="y", featureCols=["a", "b"]).link_from(lin).collect(),
    ]
    monkeypatch.delenv("ALINK_TORCH_DEVICE", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for run in runs:
        with pytest.raises(AkIllegalStateException):
            run()
    # the host ops need no card; asking for the CPU runs the rest there
    assert B.LouvainBatchOp().link_from(edges).collect().num_rows == 3
    assert pagerank(g, device="cpu").shape == (3,)
    monkeypatch.setenv("ALINK_TORCH_DEVICE", "cpu")
    for run in runs:
        run()


@pytest.mark.parametrize("module", [
    "graph.engine", "operator.batch.graph", "operator.batch.associationrule",
    "operator.batch.similarity", "operator.batch.feature4",
    "operator.batch.nlp", "operator.batch.nlp2"])
def test_slice16_classes_and_params_are_the_references(module):
    """Every class the reference module defines has a counterpart of the
    same name in the port's module, with the same ParamInfo names,
    defaults and aliases."""
    import importlib
    import inspect

    ref = importlib.import_module(f"alink_tpu.{module}")
    port = importlib.import_module(f"alink_tpu_torch.{module}")

    def params(cls):
        out = {}
        for klass in reversed(cls.__mro__):
            for v in vars(klass).values():
                if type(v).__name__ == "ParamInfo":
                    out[v.name] = (repr(v.default),
                                   tuple(getattr(v, "aliases", ()) or ()))
        return out

    classes = [n for n, c in vars(ref).items() if inspect.isclass(c)
               and c.__module__ == ref.__name__]
    assert classes
    for name in classes:
        assert hasattr(port, name), name
        assert params(getattr(port, name)) == params(getattr(ref, name)), \
            name


def test_recommendation_outlier_and_finance_entry_points_refuse_cpu(
        monkeypatch):
    """ALS, the CF similarity products, FM and DeepFM, the ALS and DeepFM
    serving kernels, the pairwise outlier detectors, the one-class SVM and
    the scorecard's regression run on the card: without one they raise
    unless the CPU is asked for. The host ops need no card."""
    import torch

    from alink_tpu_torch.common.exceptions import AkIllegalStateException
    from alink_tpu_torch.common.mtable import MTable
    from alink_tpu_torch.operator import batch as B
    from alink_tpu_torch.outlier import kde, lof, ocsvm
    from alink_tpu_torch.recommendation import interaction_similarity, \
        train_als

    rng = np.random.default_rng(0)
    u, i = rng.integers(0, 6, 40), rng.integers(0, 5, 40)
    trip = B.TableSourceBatchOp(MTable({"u": u, "i": i,
                                        "r": rng.random(40)}))
    X = rng.normal(size=(30, 2))
    feats = B.TableSourceBatchOp(MTable({"a": X[:, 0], "b": X[:, 1]}))
    credit = B.TableSourceBatchOp(MTable({
        "a": X[:, 0], "y": np.asarray([str(int(v > 0)) for v in X[:, 1]],
                                      object)}))
    rc = dict(userCol="u", itemCol="i", rateCol="r")
    runs = [lambda: train_als(u, i, np.ones(40)),
            lambda: interaction_similarity(u, i),
            lambda: kde(X), lambda: lof(X), lambda: ocsvm(X)]
    for train, kw in ((B.AlsTrainBatchOp, dict(numIter=1)),
                      (B.ItemCfTrainBatchOp, {}),
                      (B.FmRecommTrainBatchOp, dict(numEpochs=1)),
                      (B.DeepFmRecommTrainBatchOp, dict(numEpochs=1))):
        runs.append(lambda t=train, kw=kw: t(**rc, **kw).link_from(trip)
                    .collect())
    for op, kw in ((B.KdeOutlierBatchOp, {}), (B.LofOutlierBatchOp, {}),
                   (B.SosOutlierBatchOp, {}), (B.OcsvmOutlierBatchOp, {}),
                   (B.DbscanOutlierBatchOp, {}),
                   (B.OcsvmModelOutlierTrainBatchOp, {})):
        runs.append(lambda o=op, kw=kw: o(featureCols=["a", "b"], **kw)
                    .link_from(feats).collect())
    runs.append(lambda: B.ScorecardTrainBatchOp(
        selectedCols=["a"], labelCol="y", positiveLabelValueString="1")
        .link_from(credit).collect())
    monkeypatch.setenv("ALINK_TORCH_DEVICE", "cpu")
    als = B.AlsTrainBatchOp(**rc, numIter=1).link_from(trip)
    deepfm = B.DeepFmRecommTrainBatchOp(**rc, numEpochs=1).link_from(trip)
    als.collect()
    deepfm.collect()
    runs += [lambda: B.AlsItemsPerUserRecommBatchOp(userCol="u")
             .link_from(als, trip).collect(),
             lambda: B.DeepFmRateRecommBatchOp().link_from(deepfm, trip)
             .collect()]
    monkeypatch.delenv("ALINK_TORCH_DEVICE")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for run in runs:
        with pytest.raises(AkIllegalStateException):
            run()
    # the host ops need no card
    assert B.HbosOutlierBatchOp(featureCols=["a", "b"]).link_from(
        feats).collect().num_rows == 30
    assert B.RankingListBatchOp(objectCol="i").link_from(
        trip).collect().num_rows == 5
    monkeypatch.setenv("ALINK_TORCH_DEVICE", "cpu")
    for run in runs:
        run()


@pytest.mark.parametrize("module", [
    "recommendation.als", "recommendation.cf", "outlier.detectors",
    "operator.local", "operator.batch.recommendation",
    "operator.batch.recommendation2", "operator.batch.outlier",
    "operator.batch.utils2", "operator.batch.finance",
    "operator.batch.misc2"])
def test_slice17_classes_and_params_are_the_references(module):
    """Every class and public function the reference module defines has a
    counterpart of the same name in the port's module, the classes with
    the same ParamInfo names, defaults and aliases."""
    import importlib
    import inspect

    ref = importlib.import_module(f"alink_tpu.{module}")
    port = importlib.import_module(f"alink_tpu_torch.{module}")

    def params(cls):
        out = {}
        for klass in reversed(cls.__mro__):
            for v in vars(klass).values():
                if type(v).__name__ == "ParamInfo":
                    out[v.name] = (repr(v.default),
                                   tuple(getattr(v, "aliases", ()) or ()))
        return out

    defined = [n for n, c in vars(ref).items()
               if (inspect.isclass(c) or inspect.isfunction(c)
                   and not n.startswith("_"))
               and c.__module__ == ref.__name__]
    assert defined
    for name in defined:
        assert hasattr(port, name), name
        if inspect.isclass(getattr(ref, name)):
            assert params(getattr(port, name)) == \
                params(getattr(ref, name)), name


@pytest.mark.parametrize("module", [
    "operator.batch.timeseries", "operator.batch.timeseries2",
    "operator.batch.windowfe", "operator.batch.relational2",
    "operator.batch.graph2", "operator.batch.huge", "embedding.walks"])
def test_slice18_classes_and_params_are_the_references(module):
    """Every class and public function the reference module defines has a
    counterpart of the same name in the port's module, the classes with
    the same ParamInfo names, defaults and aliases."""
    test_slice17_classes_and_params_are_the_references(module)


SLICE18_MODULES = ("stats/lanefit.py", "operator/batch/timeseries.py",
                   "operator/batch/timeseries2.py",
                   "operator/batch/windowfe.py",
                   "operator/batch/relational2.py",
                   "operator/batch/graph2.py", "operator/batch/huge.py",
                   "embedding/walks.py")


@pytest.mark.parametrize("path", SLICE18_MODULES)
def test_slice18_modules_import_no_pandas_flax_optax_or_msgpack(path):
    """Not at module level and not inside a function either."""
    with open(os.path.join(REPO, "alink_tpu_torch", path)) as f:
        tree = ast.parse(f.read())
    roots = set(_all_imports(tree))
    assert not roots & {"pandas", "flax", "optax", "msgpack", "jax",
                        "alink_tpu", "prophet"}, roots


def test_slice18_entry_points_refuse_cpu_without_request(monkeypatch):
    """The forecasters, SimRank, MDS, LINE and MetaPath2Vec run on the
    card: without one they raise unless the CPU is asked for."""
    import torch

    from alink_tpu_torch.common.exceptions import AkIllegalStateException
    from alink_tpu_torch.common.mtable import MTable
    from alink_tpu_torch.embedding.walks import line_embeddings
    from alink_tpu_torch.operator import batch as B

    y = np.sin(np.arange(40) / 3.0) + np.arange(40) * 0.01
    series = B.TableSourceBatchOp(MTable({"v": y}))
    edges = B.TableSourceBatchOp(MTable({
        "s": np.asarray(["a", "b", "c", "a"], object),
        "t": np.asarray(["b", "c", "a", "c"], object)}))
    types = B.TableSourceBatchOp(MTable({
        "vertex": np.asarray(["a", "b", "c"], object),
        "type": np.asarray(["u", "i", "u"], object)}))
    nets = dict(lookback=6, hiddenSize=4, numEpochs=1, batchSize=8)
    runs = [lambda: line_embeddings(np.array([0, 1]), np.array([1, 2]), 3,
                                    dim=4, num_steps=2)]
    for op in (B.ArimaBatchOp(valueCol="v"),
               B.AutoArimaBatchOp(valueCol="v", maxP=1, maxQ=1, maxD=1),
               B.HoltWintersBatchOp(valueCol="v"),
               B.GarchBatchOp(valueCol="v"),
               B.AutoGarchBatchOp(valueCol="v", maxOrder=1),
               B.DeepARBatchOp(valueCol="v", **nets),
               B.LSTNetBatchOp(valueCol="v", **nets),
               B.TFTBatchOp(valueCol="v", **nets),
               B.DeepARTrainBatchOp(valueCol="v", **nets),
               B.LSTNetTrainBatchOp(valueCol="v", **nets),
               B.MdsBatchOp(selectedCols=["v"])):
        runs.append(lambda op=op: op.link_from(series).collect())
    runs += [
        lambda: B.SimrankBatchOp(userCol="s", itemCol="t")
        .link_from(edges).collect(),
        lambda: B.LineBatchOp(sourceCol="s", targetCol="t", numSteps=2,
                              vectorSize=4).link_from(edges).collect(),
        lambda: B.MetaPath2VecBatchOp(sourceCol="s", targetCol="t",
                                      metaPath="u-i-u", vectorSize=4,
                                      numIter=1).link_from(edges, types)
        .collect()]
    monkeypatch.delenv("ALINK_TORCH_DEVICE", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for run in runs:
        with pytest.raises(AkIllegalStateException):
            run()
    # the host ops need no card
    assert B.ShiftBatchOp(selectedCol="v").link_from(series).collect() \
        .num_rows == 40
    assert B.MetaPathWalkBatchOp(sourceCol="s", targetCol="t", walkNum=1,
                                 metaPath="u-i-u").link_from(
        edges, types).collect().num_rows == 2
    monkeypatch.setenv("ALINK_TORCH_DEVICE", "cpu")
    for run in runs:
        run()


SLICE19 = ("io.kv", "io.hbase", "io.odps", "io.hivecatalog",
           "io.directreader", "operator.batch.connectors",
           "operator.batch.format", "operator.batch.tensorops",
           "operator.batch.modelinfo", "operator.batch.media",
           "operator.batch.insights", "operator.batch.script",
           "operator.batch.udf2", "operator.batch.xgboost",
           "operator.batch.io2")


@pytest.mark.parametrize("module", SLICE19)
def test_slice19_classes_and_params_are_the_references(module):
    """Every class and public function the reference module defines (the
    BERT embedding names io2 re-exports from ``dl.py`` among them) has a
    counterpart of the same name in the port's module, the classes with
    the same ParamInfo names, defaults and aliases."""
    import importlib
    import inspect

    test_slice17_classes_and_params_are_the_references(module)
    ref = importlib.import_module(f"alink_tpu.{module}")
    port = importlib.import_module(f"alink_tpu_torch.{module}")
    public = getattr(ref, "__all__", None)
    if public is not None:
        assert sorted(port.__all__) == sorted(public)
    ref_classes = [n for n, c in vars(ref).items() if inspect.isclass(c)
                   and c.__module__ == ref.__name__]
    for name in ref_classes:
        assert inspect.isclass(getattr(port, name)), name


@pytest.mark.parametrize("module", SLICE19)
def test_slice19_modules_import_no_pandas_or_clients_at_module_level(
        module):
    """pandas nowhere; the optional clients (redis, happybase, pyodps,
    pyhive, xgboost, Pillow) only inside the functions that need them."""
    path = os.path.join(REPO, "alink_tpu_torch", *module.split(".")) + ".py"
    with open(path) as f:
        tree = ast.parse(f.read())
    clients = {"redis", "happybase", "odps", "pyhive", "xgboost", "PIL"}
    assert not set(_module_level_imports(tree)) & (clients | {"pandas"})
    assert not set(_all_imports(tree)) & {
        "pandas", "openpyxl", "jax", "flax", "optax", "alink_tpu"}


def test_slice19_entry_points_refuse_cpu_without_request(monkeypatch):
    """MFCC, AggLookup and AutoDiscovery run on the card: without one they
    raise unless the CPU is asked for. The host ops need no card."""
    import torch

    from alink_tpu_torch.common.exceptions import AkIllegalStateException
    from alink_tpu_torch.common.linalg import DenseVector
    from alink_tpu_torch.common.mtable import MTable
    from alink_tpu_torch.operator import batch as B
    from alink_tpu_torch.operator.batch.media import mfcc, mfcc_batch

    rng = np.random.default_rng(0)
    clip = rng.normal(size=2_000)
    audio = np.empty(2, object)
    audio[:] = [DenseVector(clip), DenseVector(clip[:300])]
    waves = B.TableSourceBatchOp(MTable({"a": audio}, "a DENSE_VECTOR"))
    emb = B.TableSourceBatchOp(MTable(
        {"k": np.asarray(["x", "y"], object),
         "v": np.asarray(["1 0", "0 1"], object)}, "k string, v VECTOR"))
    keys = B.TableSourceBatchOp(MTable(
        {"q": np.asarray(["x,y", "z"], object)}))
    seg = np.asarray(["a", "b", "c"] * 20, object)
    facts = B.TableSourceBatchOp(MTable({"s": seg, "m": rng.normal(size=60),
                                         "n": rng.normal(size=60)}))
    runs = [lambda: mfcc(clip, 16000),
            lambda: mfcc_batch([clip], 16000)]
    for pool in ("NONE", "MEAN"):
        runs.append(lambda p=pool: B.ExtractMfccFeatureBatchOp(
            selectedCol="a", poolingMode=p).link_from(waves).collect())
    for how in ("AVG", "SUM", "MAX", "MIN", "CONCAT"):
        runs.append(lambda h=how: B.AggLookupBatchOp(
            selectedCol="q", handle=h).link_from(emb, keys).collect())
    runs.append(lambda: B.AutoDiscoveryBatchOp().link_from(facts).collect())
    monkeypatch.delenv("ALINK_TORCH_DEVICE", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for run in runs:
        with pytest.raises(AkIllegalStateException):
            run()
    # the host ops need no card
    assert B.ColumnsToTripleBatchOp().link_from(facts).collect() \
        .num_rows == 180
    assert mfcc(clip, 16000, device="cpu").shape == (6, 13)
    monkeypatch.setenv("ALINK_TORCH_DEVICE", "cpu")
    for run in runs:
        run()
