"""Batched inference (port of ``predict_model``/``_batched_apply`` of
``alink_tpu/dl/train.py``).

The forward pass is row-wise, so rows are fed in chunks of ``batch_size`` as
they come: the reference pads each chunk up its bucket ladder to reuse
compiled programs, which eager PyTorch does not need. The reference's
training loop and its ``int8``/``bf16`` serving precision policies are not
ported yet.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..common.env import resolve_device
from ..common.exceptions import (AkIllegalArgumentException,
                                 AkUnsupportedOperationException)

FP32, BF16, INT8 = "fp32", "bf16", "int8"
PRECISIONS = (FP32, BF16, INT8)


def resolve_precision(precision) -> Optional[str]:
    """None/""/"fp32" -> None (the parameters as stored); "bf16" and
    "int8" are the reference's quantized-serving policies, not ported yet;
    anything else raises."""
    if precision is None or precision == "":
        return None
    p = str(precision).lower()
    if p not in PRECISIONS:
        raise AkIllegalArgumentException(
            f"unknown precision {precision!r}; choose one of {PRECISIONS}")
    if p != FP32:
        raise AkUnsupportedOperationException(
            f"serving precision {p!r} is not ported yet")
    return None


def _batched_apply(model, inputs: Dict[str, np.ndarray], bs: int,
                   device) -> np.ndarray:
    names = sorted(inputs)
    n = inputs[names[0]].shape[0]
    outs = []
    with torch.inference_mode():
        for s in range(0, n, bs):
            batch = {k: torch.as_tensor(np.asarray(inputs[k][s:s + bs]),
                                        device=device) for k in names}
            outs.append(model(**batch).float().cpu().numpy())
    return np.concatenate(outs, axis=0)


def predict_model(model: torch.nn.Module, inputs: Dict[str, np.ndarray], *,
                  batch_size: int = 256, device=None,
                  precision: Optional[str] = None) -> np.ndarray:
    """Batched inference returning fp32 logits ``(n, out_dim)``.

    ``model`` is moved to ``device`` (default: see
    :func:`~alink_tpu_torch.common.env.resolve_device`) and run in eval mode
    over ``inputs`` (name → ``(n, ...)`` array, the model's keyword
    arguments) in chunks of ``batch_size`` rows."""
    resolve_precision(precision)
    dev = resolve_device(device)
    model = model.to(dev).eval()
    return _batched_apply(model, inputs, batch_size, dev)
