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
"""


def test_port_imports_no_jax_flax_msgpack_or_reference():
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    count, bad = out.stdout.strip().split(" ", 1) if " " in \
        out.stdout.strip() else (out.stdout.strip(), "")
    assert int(count) >= 20
    assert bad == "", f"port pulled in: {bad}"


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
