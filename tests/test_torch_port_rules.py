"""Rules of the port: ``alink_tpu_torch`` imports nothing of JAX, flax,
msgpack or ``alink_tpu``, and its entry points never fall back to the CPU
quietly."""

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
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "msgpack",
                                    "alink_tpu"))
print(len(names), ",".join(bad))
print(",".join(names))
"""


def test_port_imports_no_jax_flax_msgpack_or_reference():
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    first, scanned = out.stdout.strip().split("\n")
    count, bad = first.split(" ", 1) if " " in first else (first, "")
    assert int(count) >= 20
    assert bad == "", f"port pulled in: {bad}"
    # the scan reaches every slice's modules, the tree slice's included
    assert {"alink_tpu_torch.tree.grow", "alink_tpu_torch.tree.hist_cuda",
            "alink_tpu_torch.tree.binning",
            "alink_tpu_torch.operator.batch.tree"} <= set(scanned.split(","))


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
    ("int8", "AkUnsupportedOperationException"),
    ("bf16", "AkUnsupportedOperationException"),
    ("fp16", "AkIllegalArgumentException")])
def test_unported_precision_policies_raise(precision, exc):
    import torch

    from alink_tpu_torch.common import exceptions
    from alink_tpu_torch.dl.modules import BertConfig, TransformerEncoder
    from alink_tpu_torch.dl.train import predict_model

    model = TransformerEncoder(BertConfig.tiny(dtype=torch.float32))
    with pytest.raises(getattr(exceptions, exc)):
        predict_model(model, {"input_ids": np.zeros((1, 4), np.int32)},
                      device="cpu", precision=precision)


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
    ("int8", "AkUnsupportedOperationException"),
    ("bf16", "AkUnsupportedOperationException"),
    ("fp16", "AkIllegalArgumentException")])
def test_tree_mapper_unported_precision_policies_raise(monkeypatch,
                                                       precision, exc):
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
    with pytest.raises(getattr(exceptions, exc)):
        op.link_from(model, src).collect()
