"""The port's ResNet (``dl/resnet.py``) and its flax carry (``dl/convert.py``)
held against ``alink_tpu.dl.resnet`` on the CPU.

``resnet18_like`` from flax's ``init`` (BatchNorm statistics and scales
redrawn from a seed, so that every one of them moves the logits), carried
across with ``resnet_flax_to_torch``:

- fp32 logits within FP32_ATOL = 1e-4 of ``apply`` (the tolerance of the
  reference's own export test, tests/test_ingest.py); measured ~2e-7;
- bf16 logits within BF16_BAND = 2**-7 of the largest logit (one bf16 step
  at its size) of ``apply`` at bf16: both round at the same points (the
  convolutions' outputs and each BatchNorm's fp32 result), so only a
  rounding that a different summation order tips can part them; measured
  ~1e-7;
- the carry round-trips exactly, and ``to_flax``/``from_flax`` pick it;
- the port's serving route for the model, ``torch.export`` → ``.pt2`` →
  ``TorchModelPredictBatchOp``, against the reference's StableHLO route
  (``export_stablehlo`` → ``StableHloModelPredictBatchOp``) on the same
  carried weights and images, at bf16's band, and equal to the module's own
  logits within 1e-6.
"""

import functools

import numpy as np
import pytest

import jax
import torch

FP32_ATOL = 1e-4
BF16_BAND = 2.0 ** -7
CLASSES = 4


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("ALINK_TORCH_DEVICE", "cpu")


@functools.lru_cache(maxsize=None)
def _variables(seed=0):
    """flax init of resnet18_like, then every BatchNorm's statistics, scale
    and bias redrawn from ``seed``. The variables are fp32 at either compute
    dtype (flax's ``param_dtype``), so one init serves both."""
    from alink_tpu.dl.resnet import resnet18_like

    model = resnet18_like(num_classes=CLASSES, dtype=np.float32)
    x0 = np.zeros((1, 8, 8, 3), np.float32)
    v = jax.tree_util.tree_map(np.asarray, jax.jit(model.init)(
        jax.random.PRNGKey(seed), x0))
    rng = np.random.RandomState(seed + 1)

    def redraw(tree):
        out = {}
        for k, val in tree.items():
            if isinstance(val, dict):
                out[k] = redraw(val)
            elif k == "var":
                out[k] = (0.5 + rng.rand(*val.shape)).astype(val.dtype)
            elif k in ("mean", "scale", "bias") and val.ndim == 1:
                out[k] = (rng.randn(*val.shape) * 0.2
                          + (1.0 if k == "scale" else 0.0)).astype(val.dtype)
            else:
                out[k] = val
        return out

    return {k: redraw(t) for k, t in v.items()}


def _ref_model(prec):
    import jax.numpy as jnp

    from alink_tpu.dl.resnet import resnet18_like

    return resnet18_like(num_classes=CLASSES, dtype=jnp.bfloat16
                         if prec == "bfloat16" else np.float32)


def _images(n=6, seed=2):
    return np.random.RandomState(seed).rand(n, 8, 8, 3).astype(np.float32)


@pytest.mark.parametrize("prec", ["float32", "bfloat16"])
def test_resnet18_like_matches_flax(prec):
    from alink_tpu_torch.dl.convert import (from_flax, resnet_flax_to_torch,
                                            resnet_torch_to_flax, to_flax)
    from alink_tpu_torch.dl.resnet import resnet18_like

    ref_model, v = _ref_model(prec), _variables()
    x = _images()
    want = np.asarray(jax.jit(ref_model.apply)(v, x))
    port = resnet18_like(num_classes=CLASSES, dtype=getattr(torch, prec))
    port.load_state_dict(resnet_flax_to_torch(v), strict=True)
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    assert got.dtype == np.float32 and got.shape == (6, CLASSES)
    tol = FP32_ATOL if prec == "float32" else BF16_BAND * np.abs(want).max()
    assert np.abs(got - want).max() <= tol
    back = resnet_torch_to_flax(port.state_dict())
    assert jax.tree_util.tree_all(jax.tree_util.tree_map(
        np.array_equal, back, v))
    assert jax.tree_util.tree_all(jax.tree_util.tree_map(
        np.array_equal, to_flax(port), v))
    assert from_flax(port, v).keys() == port.state_dict().keys()


def test_resnet_block_layout_follows_flax():
    """The flax tree's names and the projection blocks: block 0 projects
    (16 → 64 channels), block 1 projects and strides; the last BatchNorm
    of a block starts from a zero scale, as flax's does."""
    from alink_tpu_torch.dl.resnet import resnet18_like, resnet50

    v = _variables()
    m = resnet18_like(num_classes=CLASSES, dtype=torch.float32)
    assert sorted(v["params"]) == sorted(
        n for n, _ in m.named_children())
    assert m.BottleneckBlock_0.conv_proj is not None
    assert m.BottleneckBlock_1.strides == (2, 2)
    assert torch.count_nonzero(m.BottleneckBlock_0.BatchNorm_2.weight) == 0
    big = resnet50()
    assert big.num_blocks == 16 and big.head.weight.shape == (1000, 2048)
    assert sum(p.numel() for p in big.parameters()) == 25_557_032


def test_pt2_route_matches_reference_stablehlo_route(tmp_path):
    """At bf16, the module's default compute dtype: the .pt2 carries its
    casts as aten ops, which the route runs as they are."""
    from alink_tpu.common.mtable import MTable as RefTable
    from alink_tpu.operator.batch import (StableHloModelPredictBatchOp,
                                          TableSourceBatchOp as RefSource,
                                          export_stablehlo)
    from alink_tpu_torch.common.mtable import MTable
    from alink_tpu_torch.dl.convert import resnet_flax_to_torch
    from alink_tpu_torch.dl.resnet import resnet18_like
    from alink_tpu_torch.operator.batch import (TableSourceBatchOp,
                                                TorchModelPredictBatchOp)

    ref_model, v = _ref_model("bfloat16"), _variables()
    x = _images(seed=4)
    hlo = str(tmp_path / "r.hlo")
    export_stablehlo(lambda a: ref_model.apply(v, a), (x[:4],), hlo)
    imgs = np.empty(len(x), dtype=object)
    imgs[:] = list(x)
    want = np.stack(list(StableHloModelPredictBatchOp(
        modelPath=hlo, selectedCols=["img"], outputCols=["logits"],
        predictBatchSize=4).link_from(RefSource(RefTable({"img": imgs})))
        .collect().col("logits")))

    port = resnet18_like(num_classes=CLASSES)
    port.load_state_dict(resnet_flax_to_torch(v))
    pt2 = str(tmp_path / "r.pt2")
    torch.export.save(torch.export.export(
        port.eval(), (torch.from_numpy(x[:4]),)), pt2)
    got = np.stack(list(TorchModelPredictBatchOp(
        modelPath=pt2, selectedCols=["img"], outputCols=["logits"],
        predictBatchSize=4).link_from(TableSourceBatchOp(MTable(
            {"img": imgs}))).collect().col("logits")))
    with torch.no_grad():
        module = port(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (6, CLASSES)
    assert np.abs(got - want).max() <= BF16_BAND * np.abs(want).max()
    np.testing.assert_allclose(got, module, atol=1e-6)
