"""ResNet (v1.5), the framework's image backbone (port of
``alink_tpu.dl.resnet``; flax modules there, ``nn.Module``s here).

BASELINE config #3 measures ResNet-50 batch inference rows/sec; the reference
serves it as a TF SavedModel through TF-Java (reference:
dl_predictors/predictor-tf/.../TFPredictorServiceImpl.java:139
SavedModelBundle.load). The modules take NHWC input, as the flax ones do, and
keep the flax variable tree's names (``conv_init``, ``bn_init``,
``BottleneckBlock_<i>``, ``Conv_<j>``, ``BatchNorm_<j>``, ``conv_proj``,
``norm_proj``, ``head``), so :func:`~alink_tpu_torch.dl.convert.resnet_flax_to_torch`
carries a flax init across name for name. Inside, activations are NCHW views
of channels-last memory (what the NHWC input already is), which cuDNN's
convolutions take as they are.

Arithmetic, as flax's: convolutions run in ``dtype`` (bf16 by default: input
and kernel cast to it); BatchNorm uses the running statistics at ε 1e-5 and
computes in fp32 — ``(x − mean) · (rsqrt(var + ε) · scale) + bias`` — before
rounding to ``dtype``; the max pool pads ((1, 1), (1, 1)) with −inf; the
global mean accumulates in fp32; the ``head`` is fp32. Parameters are kept
in fp32 and cast to ``dtype`` in the forward, as flax's ``param_dtype``.
The port's serving route for this model is ``torch.export`` → ``.pt2`` →
``TorchModelPredictBatchOp``; the reference exports StableHLO instead.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..onnx.convert import same_pads


def _cast(x, dtype):
    """``x.to(dtype)`` as the aten op itself: ``torch.export`` records
    ``Tensor.to`` with an ``_assert_tensor_metadata`` node, an op outside
    the ingest set (``onnx/torchfx.py``), and this form without it."""
    if x.dtype == dtype:
        return x
    return torch.ops.aten._to_copy.default(x, dtype=dtype)


class Conv(nn.Module):
    """flax ``nn.Conv`` without bias, channels first: weight (O, I, kh, kw).

    flax's default padding is "SAME", which puts the odd pad at the end: a
    3×3 kernel at stride 2 on an even side pads (0, 1). Torch pads
    symmetrically, so such a convolution runs at stride 1 with the kernel's
    own symmetric pad and keeps every s-th output from the first the SAME
    windows start at (the same products; no pad op, which ``torch.export``
    would record as an aten op outside the ingest set)."""

    def __init__(self, cin, cout, kernel, strides=(1, 1), padding=None,
                 dtype=torch.bfloat16):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, *kernel))
        self.strides = tuple(strides)
        self.padding = padding      # explicit symmetric pads, or None: SAME
        self.dtype = dtype
        nn.init.kaiming_normal_(self.weight)

    def forward(self, x):
        w = _cast(self.weight, self.dtype).contiguous(
            memory_format=torch.channels_last)
        x = _cast(x, self.dtype)
        if self.padding is not None:
            return F.conv2d(x, w, None, self.strides,
                            [lo for lo, _ in self.padding])
        kh, kw = self.weight.shape[2:]
        # flax's "SAME" (lax.padtype_to_pads) is ONNX's SAME_UPPER
        pads = same_pads(x.shape[2:], (kh, kw), self.strides, (1, 1), False)
        if all(lo == hi for lo, hi in pads):
            return F.conv2d(x, w, None, self.strides, [pads[0][0],
                                                        pads[1][0]])
        y = F.conv2d(x, w, None, 1, [kh // 2, kw // 2])
        (sh, sw), (lh, lw) = self.strides, (pads[0][0], pads[1][0])
        return y[:, :, kh // 2 - lh::sh, kw // 2 - lw::sw]


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(use_running_average=True, epsilon=1e-5)`` over
    channels (dim 1): fp32 arithmetic, the result in ``dtype``."""

    def __init__(self, features, dtype=torch.bfloat16, zero_scale=False):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(features) if zero_scale
                                   else torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))
        self.dtype = dtype

    def forward(self, x):
        shape = (1, -1, 1, 1)
        mul = torch.rsqrt(self.var + 1e-5) * self.weight
        y = (_cast(x, torch.float32) - self.mean.view(shape)) \
            * mul.view(shape) + self.bias.view(shape)
        return _cast(y, self.dtype)


class BottleneckBlock(nn.Module):
    def __init__(self, cin, filters, strides=(1, 1), dtype=torch.bfloat16):
        super().__init__()
        self.Conv_0 = Conv(cin, filters, (1, 1), dtype=dtype)
        self.BatchNorm_0 = BatchNorm(filters, dtype)
        self.Conv_1 = Conv(filters, filters, (3, 3), strides, dtype=dtype)
        self.BatchNorm_1 = BatchNorm(filters, dtype)
        self.Conv_2 = Conv(filters, filters * 4, (1, 1), dtype=dtype)
        self.BatchNorm_2 = BatchNorm(filters * 4, dtype, zero_scale=True)
        self.strides = tuple(strides)
        if cin != filters * 4 or self.strides != (1, 1):
            self.conv_proj = Conv(cin, filters * 4, (1, 1), strides,
                                  dtype=dtype)
            self.norm_proj = BatchNorm(filters * 4, dtype)
        else:
            self.conv_proj = None

    def forward(self, x):
        residual = x
        y = torch.relu(self.BatchNorm_0(self.Conv_0(x)))
        y = torch.relu(self.BatchNorm_1(self.Conv_1(y)))
        y = self.BatchNorm_2(self.Conv_2(y))
        if self.conv_proj is not None:
            residual = self.norm_proj(self.conv_proj(residual))
        return torch.relu(residual + y)


class ResNet(nn.Module):
    """NHWC images in, fp32 logits out."""

    def __init__(self, stage_sizes: Sequence[int], num_classes: int = 1000,
                 width: int = 64, dtype=torch.bfloat16, in_channels: int = 3):
        super().__init__()
        self.dtype = dtype
        self.conv_init = Conv(in_channels, width, (7, 7), (2, 2),
                              padding=((3, 3), (3, 3)), dtype=dtype)
        self.bn_init = BatchNorm(width, dtype)
        cin, k = width, 0
        for i, block_count in enumerate(stage_sizes):
            for j in range(block_count):
                strides = (2, 2) if i > 0 and j == 0 else (1, 1)
                self.add_module(f"BottleneckBlock_{k}", BottleneckBlock(
                    cin, width * 2 ** i, strides, dtype))
                cin, k = width * 2 ** i * 4, k + 1
        self.num_blocks = k
        self.head = nn.Linear(cin, num_classes)

    def forward(self, x):
        # NHWC in; the NCHW view of it is channels-last in memory
        x = _cast(x, self.dtype).permute(0, 3, 1, 2)
        x = torch.relu(self.bn_init(self.conv_init(x)))
        x = F.max_pool2d(x, 3, 2, 1)
        for k in range(self.num_blocks):
            x = getattr(self, f"BottleneckBlock_{k}")(x)
        x = x.mean(dim=(2, 3))
        return self.head(_cast(x, torch.float32))


def resnet50(num_classes: int = 1000, dtype=torch.bfloat16) -> ResNet:
    return ResNet([3, 4, 6, 3], num_classes, dtype=dtype)


def resnet18_like(num_classes: int = 10, dtype=torch.bfloat16) -> ResNet:
    """Small bottleneck variant for tests (same code path, tiny stages)."""
    return ResNet([1, 1], num_classes, width=16, dtype=dtype)
