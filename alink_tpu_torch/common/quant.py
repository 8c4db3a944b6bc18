"""Post-training quantization for served models: the ``fp32``/``bf16``/``int8``
precision policy (port of ``alink_tpu/common/quant.py``).

Policies (``fp32`` is the identity: precision unset leaves every scoring path
as it was):

- ``int8``: per-channel symmetric int8 weights. The linear score runs
  **static W8A8**: the activation block is quantized with a per-tensor scale
  fixed by a calibration pass over real rows, the product accumulates in
  int32 (:func:`int8_matmul`, ``torch._int_mm`` on the card), and one rescale
  restores fp32 scores. The BERT encoder's parameters and tree leaf values
  run **weight-only**: int8 tensors and their scales are the served state on
  the device, dequantized (``q.float() * s``) inside each forward.
- ``bf16``: weights (and the linear score's activations) rounded through
  bfloat16 and held in fp32 (:func:`bf16_round`); no calibration.

The host-side quantizers are the reference's numpy, so int8 weights and
scales are bitwise the reference's. A policy the code cannot honour raises:
no path serves fp32 in its place.

The policy travels to mappers as stamped op params:

- ``inferencePrecision``: the policy string;
- ``quantCalib``: ``{site: activation absmax}`` fixed by calibration;
- ``quantSite``: the op's site prefix.

Not ported yet: the Naive-Bayes, FM and MLP int8 programs (their operators
come with ROADMAP A4), and ModelServer's quantized load, stamping and band
gate (ROADMAP A9).
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Any, Dict, Optional, Tuple

import numpy as np

from .exceptions import AkIllegalArgumentException, AkIllegalStateException

FP32 = "fp32"
BF16 = "bf16"
INT8 = "int8"
PRECISIONS = (FP32, BF16, INT8)

# op-param keys a mapper reads
PRECISION_KEY = "inferencePrecision"
CALIB_KEY = "quantCalib"
SITE_KEY = "quantSite"

_QMAX = 127.0  # symmetric int8 range; -128 is never produced


def resolve_policy(precision) -> Optional[str]:
    """None/""/"fp32" -> None (the identity policy), "bf16"/"int8" ->
    themselves; anything else raises."""
    if precision is None or precision == "":
        return None
    p = str(precision).lower()
    if p not in PRECISIONS:
        raise AkIllegalArgumentException(
            f"unknown precision {precision!r}; choose one of {PRECISIONS}")
    return None if p == FP32 else p


def policy_of(params) -> Optional[str]:
    """The policy stamped on a mapper's params, or None when unset."""
    if params is None or not params.contains(PRECISION_KEY):
        return None
    return resolve_policy(params.get(PRECISION_KEY))


def site_of(params, default: str) -> str:
    if params is not None and params.contains(SITE_KEY):
        return str(params.get(SITE_KEY))
    return default


def calib_scale(params, site: str) -> float:
    """The calibrated per-tensor activation scale for ``site`` (absmax /
    127). A site calibration never covered raises."""
    calib = params.get(CALIB_KEY) if params is not None \
        and params.contains(CALIB_KEY) else None
    absmax = (calib or {}).get(site)
    if absmax is None or not np.isfinite(absmax) or absmax <= 0.0:
        raise AkIllegalStateException(
            f"int8 inference has no calibrated activation range for site "
            f"{site!r}: the calibration pass did not cover it")
    return float(absmax) / _QMAX


# ---------------------------------------------------------------------------
# weight quantization (host numpy, the reference's arithmetic)
# ---------------------------------------------------------------------------


def quantize_per_channel(w: np.ndarray,
                         axis: int = -1) -> Tuple[np.ndarray, np.ndarray]:
    """Symmetric per-channel int8 quantization of ``w`` along ``axis`` (the
    output-channel axis; a 1-D weight is one channel). Returns ``(wq int8,
    scale f32)`` with ``wq * scale ~= w``; an all-zero channel gets scale 1.0
    so dequantization is exact."""
    w = np.asarray(w, np.float32)
    if w.ndim == 0 or w.size == 0:
        return w.astype(np.int8), np.ones_like(w, np.float32)
    if w.ndim == 1:
        absmax = float(np.max(np.abs(w)))
        scale = np.float32(absmax / _QMAX if absmax > 0.0 else 1.0)
        wq = np.clip(np.round(w / scale), -_QMAX, _QMAX).astype(np.int8)
        return wq, np.asarray(scale, np.float32)
    reduce_axes = tuple(i for i in range(w.ndim) if i != (axis % w.ndim))
    absmax = np.max(np.abs(w), axis=reduce_axes, keepdims=True)
    scale = np.where(absmax > 0.0, absmax / _QMAX, 1.0).astype(np.float32)
    wq = np.clip(np.round(w / scale), -_QMAX, _QMAX).astype(np.int8)
    return wq, np.squeeze(scale, axis=reduce_axes)


def quantize_last_axis(w: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Symmetric int8 with one scale per leading index (reduce over the last
    axis only): tree leaf tables ``(T, K, 2^D)`` get scales ``(T, K)``.
    All-zero rows get scale 1.0."""
    w = np.asarray(w, np.float32)
    absmax = np.max(np.abs(w), axis=-1, keepdims=True)
    scale = np.where(absmax > 0.0, absmax / _QMAX, 1.0).astype(np.float32)
    wq = np.clip(np.round(w / scale), -_QMAX, _QMAX).astype(np.int8)
    return wq, np.squeeze(scale, axis=-1)


def dequantize(wq: np.ndarray, scale: np.ndarray,
               axis: int = -1) -> np.ndarray:
    """Host-side inverse of :func:`quantize_per_channel`."""
    wq = np.asarray(wq, np.float32)
    s = np.asarray(scale, np.float32)
    if wq.ndim >= 2 and s.ndim == 1:
        shape = [1] * wq.ndim
        shape[axis % wq.ndim] = s.shape[0]
        s = s.reshape(shape)
    return wq * s


def quantize_tree(params) -> Tuple[Any, Any]:
    """Weight-only quantization of a nested dict of numpy arrays (a flax
    variables tree): every float leaf with >= 2 dims becomes int8 with a
    per-channel scale along its last axis; 1-D floats and integer leaves
    pass through with scale None. Returns ``(q_tree, scale_tree)`` of the
    same structure."""
    if isinstance(params, dict):
        pairs = {k: quantize_tree(v) for k, v in params.items()}
        return ({k: q for k, (q, _) in pairs.items()},
                {k: s for k, (_, s) in pairs.items()})
    a = np.asarray(params)
    if a.ndim >= 2 and np.issubdtype(a.dtype, np.floating):
        return quantize_per_channel(a, axis=-1)
    return a, None


def bf16_round(a: np.ndarray) -> np.ndarray:
    """The ``bf16`` policy's numerics: round a block through bfloat16
    (round to nearest even, torch's cast) and hand it back as fp32."""
    import torch

    t = torch.from_numpy(np.ascontiguousarray(a, np.float32))
    return t.to(torch.bfloat16).to(torch.float32).numpy()


# ---------------------------------------------------------------------------
# calibration capture
# ---------------------------------------------------------------------------

# Capture is process-wide, not thread-local: the mapper calling observe() may
# run on another thread than the one that opened the context. The gate lock
# serializes calibration passes; the record lock guards merges.
_capture_gate = threading.Lock()
_capture_lock = threading.Lock()
_capture_rec: Optional[Dict[str, float]] = None


@contextmanager
def calibration(record: Dict[str, float]):
    """Activate activation-range capture for the duration of the context:
    mappers predicting inside it merge per-site absmax into ``record``, from
    whatever thread they run on. Outside it :func:`observe` is a no-op."""
    global _capture_rec
    with _capture_gate:
        with _capture_lock:
            _capture_rec = record
        try:
            yield record
        finally:
            with _capture_lock:
                _capture_rec = None


def capturing() -> bool:
    return _capture_rec is not None


def observe(site: str, block) -> None:
    """Record the absmax of one activation block under ``site`` (max-merge
    across blocks). Only active inside :func:`calibration`."""
    if _capture_rec is None:
        return
    a = np.asarray(block)
    m = float(np.max(np.abs(a))) if a.size else 0.0
    if not np.isfinite(m):
        m = float("inf")
    with _capture_lock:
        rec = _capture_rec
        if rec is None:
            return
        prev = rec.get(site)
        rec[site] = m if prev is None else max(prev, m)


def degenerate_sites(calib: Dict[str, float]) -> Dict[str, float]:
    """The calibration sites whose range cannot give a usable scale: zero or
    non-finite. Empty when the ranges are healthy."""
    return {k: v for k, v in (calib or {}).items()
            if not np.isfinite(v) or v <= 0.0}


# ---------------------------------------------------------------------------
# the int8 product and the quantized scorers (torch, on the data's device)
# ---------------------------------------------------------------------------


def int8_matmul_ref(a, b):
    """The plain version of :func:`int8_matmul`: the exact int32 accumulators
    of int8 ``a (m, k) @ b (k, n)``. The product runs in float64, where every
    partial sum is an integer of magnitude at most 127²·k, exact for any k
    below 2^53 / 127² (and the int32 result needs k ≤ 133,144)."""
    import torch

    return torch.matmul(a.to(torch.float64), b.to(torch.float64)).to(
        torch.int32)


def int8_matmul(a, b):
    """int8 ``a (m, k) @ b (k, n)`` -> int32 accumulators.

    On the card this is ``torch._int_mm``, which needs ``m > 16`` and ``k``,
    ``n`` multiples of 8: rows and columns are padded with zeros (which add
    nothing to any accumulator) and the result is cut back. A failed launch
    raises. CPU tensors take :func:`int8_matmul_ref`."""
    import torch

    if a.dtype != torch.int8 or b.dtype != torch.int8:
        raise AkIllegalArgumentException(
            f"int8_matmul takes int8 operands, got {a.dtype} and {b.dtype}")
    if a.device.type != "cuda":
        return int8_matmul_ref(a, b)
    m, k = a.shape
    n = b.shape[1]
    pm, pk, pn = max(17 - m, 0), -k % 8, -n % 8
    if pm or pk:
        a = torch.nn.functional.pad(a, (0, pk, 0, pm))
    if pk or pn:
        b = torch.nn.functional.pad(b, (0, pn, 0, pk))
    return torch._int_mm(a.contiguous(), b.contiguous())[:m, :n]


def quantize_act(X, sx):
    """Static activation quantization: ``clip(round(X / sx), ±127)`` as int8,
    rounding half to even as ``jnp.round`` does. ``sx`` is a 0-dim fp32
    tensor on X's device, so the card divides (a host scalar would make it
    multiply by the reciprocal)."""
    import torch

    return torch.clamp(torch.round(X / sx), -_QMAX, _QMAX).to(torch.int8)


def int8_linear_score(X, wq, b, sw, sx):
    """Static-W8A8 ``X @ w + b``: X (n, d) fp32 quantized by the per-tensor
    scale ``sx`` (0-dim fp32 tensor), ``wq`` (d,) or (d, K) int8 with
    per-channel scales ``sw``, int32 accumulation, one rescale to fp32."""
    vec = wq.dim() == 1
    acc = int8_matmul(quantize_act(X, sx), wq[:, None] if vec else wq)
    if vec:
        acc = acc[:, 0]
    return acc.float() * (sx * sw) + b


def accuracy_band_report(base_rows, cand_rows, out_types,
                         *, band: float, tol: float) -> Dict[str, Any]:
    """Compare a quantized predict against its fp32 baseline. Label-like
    (non-float) columns gate on agreement (disagreement fraction <=
    ``band``); numeric columns on relative deviation (max |Δ| / max(1,
    |base|) <= ``tol``). JSON-detail string columns are skipped. Returns
    ``{"ok", "agreement", "max_rel_diff", "band", "tol", "rows"}``."""
    from .mtable import AlinkTypes

    n = len(base_rows)
    agree_num = agree_den = 0
    max_rel = 0.0
    for bi, ci in zip(base_rows, cand_rows):
        for col, (bv, cv) in enumerate(zip(bi, ci)):
            tp = out_types[col] if col < len(out_types) else None
            numeric = tp in (AlinkTypes.DOUBLE, AlinkTypes.FLOAT) or (
                isinstance(bv, float) and not isinstance(bv, bool))
            if numeric and bv is not None and cv is not None:
                b = float(bv)
                c = float(cv)
                max_rel = max(max_rel, abs(b - c) / max(1.0, abs(b)))
                continue
            if isinstance(bv, str) and bv[:1] in ("{", "["):
                continue
            agree_den += 1
            try:
                agree_num += int(bool(bv == cv))
            except Exception:  # cells whose == is not a truth value
                agree_num += int(str(bv) == str(cv))
    agreement = agree_num / agree_den if agree_den else 1.0
    ok = agreement >= 1.0 - band and max_rel <= tol
    return {"ok": bool(ok), "agreement": round(agreement, 6),
            "max_rel_diff": round(max_rel, 8), "band": band, "tol": tol,
            "rows": n}
