"""The one precision policy of every foreign-model ingest format (port of
``alink_tpu.onnx.precision``).

float32 (``dtype=None``) is the *pinned* path: foreign models carry fp32
semantics, so their products run in full fp32, as the reference pins
``jax.default_matmul_precision("highest")``. On Hopper that means TF32 off
for both cuBLAS matmuls and cuDNN convolutions: PyTorch's
``torch.backends.cudnn.allow_tf32`` is True by default, so a plain fp32
``F.conv2d`` would otherwise run TF32. :func:`pinned_fp32` turns both flags
off around the call and restores them after it, so the settings of BERT's
and the classical paths do not change.

Any other dtype (``bfloat16``) is the serving policy: float weights load in
the compute dtype, float inputs are cast on the device, float outputs come
back as fp32; integer tensors pass through untouched.

Threads. The two TF32 flags are process-wide in PyTorch, not per thread.
:func:`pinned_fp32` counts the pinned calls in flight under a lock: the first
to enter saves the flags and turns TF32 off, the last to leave restores them,
so pinned calls on several threads never restore under one another. A call
on another thread that does not pin runs without TF32 while a pinned call is
in flight (more exact, never less), and a thread that turns TF32 on while a
pinned call runs would reach that call too: set the flags before serving
starts, not during it.

The reference's program cache (``cached_jit``) has no counterpart: the port
runs eager PyTorch ops, with nothing traced to share.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Any, Dict, Optional

import numpy as np
import torch

_pin_lock = threading.Lock()
_pin_depth = 0
_pin_saved = None


@contextmanager
def pinned_fp32():
    """fp32 products without TF32 (cuBLAS and cuDNN) for the duration."""
    global _pin_depth, _pin_saved
    with _pin_lock:
        if _pin_depth == 0:
            _pin_saved = (torch.backends.cuda.matmul.allow_tf32,
                          torch.backends.cudnn.allow_tf32)
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        _pin_depth += 1
    try:
        yield
    finally:
        with _pin_lock:
            _pin_depth -= 1
            if _pin_depth == 0:
                (torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.allow_tf32) = _pin_saved


_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16, "float64": torch.float64}


def resolve_dtype(dtype) -> Optional[torch.dtype]:
    """None or an explicit fp32 request -> None (the pinned fp32 path);
    anything else -> a torch dtype ('bfloat16', torch.bfloat16 and numpy
    dtypes all resolve)."""
    if dtype is None:
        return None
    if not isinstance(dtype, torch.dtype):
        dtype = _DTYPES[str(np.dtype(dtype)) if not isinstance(dtype, str)
                        else dtype]
    return None if dtype == torch.float32 else dtype


def as_tensor(v, device, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """A host array or tensor on ``device``; ``dtype`` casts floats only."""
    if isinstance(v, np.ndarray) and not v.flags.writeable:
        v = v.copy()
    t = torch.as_tensor(v, device=device)
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t


def cast_float_state(state: Dict[str, Any], dtype, device) -> Dict[str, Any]:
    """The float entries of a weight/initializer dict as tensors of ``dtype``
    (None keeps fp32) on ``device``, moved there once at load; integer
    entries stay host numpy arrays (shapes, axes, indices: static)."""
    out = {}
    for k, v in state.items():
        arr = v.detach().cpu().numpy() if isinstance(v, torch.Tensor) \
            else np.asarray(v)
        if np.issubdtype(arr.dtype, np.floating):
            out[k] = as_tensor(arr, device, dtype)
        else:
            out[k] = v
    return out


def _cast_in(v, dtype):
    return v.to(dtype) if isinstance(v, torch.Tensor) and \
        v.is_floating_point() else v


def _cast_out(v):
    return v.float() if isinstance(v, torch.Tensor) and \
        v.is_floating_point() else v


def wrap_positional(fn, dtype):
    """``fn(*tensors) -> list`` under the policy: ``dtype=None`` pins fp32,
    else float inputs cast to ``dtype`` on the device and float outputs
    come back fp32."""
    if dtype is None:
        def pinned(*args):
            with pinned_fp32(), torch.inference_mode():
                return fn(*args)
        return pinned

    def wrapped(*args):
        with torch.inference_mode():
            out = fn(*[_cast_in(a, dtype) for a in args])
            return [_cast_out(o) for o in out]
    return wrapped


def wrap_named(fn, dtype):
    """``fn(**tensors) -> dict`` under the policy (see :func:`wrap_positional`)."""
    if dtype is None:
        def pinned(**inputs):
            with pinned_fp32(), torch.inference_mode():
                return fn(**inputs)
        return pinned

    def wrapped(**inputs):
        with torch.inference_mode():
            out = fn(**{k: _cast_in(v, dtype) for k, v in inputs.items()})
            return {k: _cast_out(v) for k, v in out.items()}
    return wrapped
