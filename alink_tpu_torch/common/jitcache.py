"""Shape bucketing and the record of the batch shapes the port has run
(port of the parts of ``alink_tpu.common.jitcache`` that the serving tier
needs).

1. **Shape bucketing** — the leading (row) dimension is padded up a bucket
   ladder (:func:`bucket_rows`, env ``ALINK_SHAPE_BUCKETS``, the reference's
   knob and ladder). Padding is applied ONLY on row-wise computations (each
   output row depends only on its input row), where the padded rows are
   sliced off again. On the card it keeps the set of GEMM shapes a server
   meets small and fixed: a batch of 1..64 rows runs at one of 8 shapes,
   all of which the serving warmup has already run.

2. **Shape signatures** — :func:`note_signature` records, per kernel id,
   each distinct set of (shape, dtype) a bucketed path has run, and counts a
   first-seen one in ``jit.trace``. The reference counts traces of a jitted
   program there; eager PyTorch compiles nothing per shape, so here the
   counter counts first-seen shapes, not compilations. It is what the
   serving contract reads: after warmup, sustained mixed-size load meets no
   new signature. :func:`seen_warmup_specs` / :func:`save_warmup_specs` give
   the record in the reference's warmup-spec shapes.

The reference's program cache (``cached_jit``), AOT warmup and persistent
compile cache have no counterpart: nothing here is compiled per shape.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Any, Dict, Iterable, List, Optional, Tuple

import numpy as np

from .env import env_str
from .metrics import metrics

# ---------------------------------------------------------------------------
# Shape bucketing (copied from the reference)
# ---------------------------------------------------------------------------

_BUCKETS_ENV = "ALINK_SHAPE_BUCKETS"
_LINEAR_HEAD = 64       # below this, buckets are multiples of _LINEAR_STEP
_LINEAR_STEP = 8


def _parse_buckets() -> "str | List[int]":
    raw = (env_str(_BUCKETS_ENV, "") or "").strip().lower()
    if raw in ("", "pow2"):
        return "pow2"
    if raw in ("off", "0", "none"):
        return "off"
    try:
        ladder = sorted({int(x) for x in raw.split(",") if x.strip()})
        if ladder and all(s > 0 for s in ladder):
            return ladder
    except ValueError:
        pass
    return "pow2"  # malformed knob must not crash a running job


def bucket_rows(n: int) -> int:
    """Bucketed row count for ``n``: the padded leading dimension every
    bucketed path runs at.

    Default ladder ("pow2 with a linear head"): multiples of 8 up to 64,
    then the next power of two. ``ALINK_SHAPE_BUCKETS`` overrides: ``off``
    disables bucketing, or a comma list (``64,512,4096``) gives an explicit
    ladder (sizes beyond the last round up to a multiple of the last
    rung)."""
    n = int(n)
    spec = _parse_buckets()
    if spec == "off" or n < 0:
        return n
    if isinstance(spec, list):
        for s in spec:
            if n <= s:
                return s
        last = spec[-1]
        return ((n + last - 1) // last) * last
    if n <= _LINEAR_HEAD:
        return max(_LINEAR_STEP,
                   ((n + _LINEAR_STEP - 1) // _LINEAR_STEP) * _LINEAR_STEP)
    return 1 << (n - 1).bit_length()


def bucketing_enabled() -> bool:
    return _parse_buckets() != "off"


def floor_bucket_rows(n: int) -> int:
    """Largest ladder rung <= ``n`` (``n`` itself when bucketing is off or
    ``n`` sits below the smallest rung). Streaming paths size their full
    micro-batches with this so steady chunks ship with ZERO padding and only
    the ragged tail pads up to a (smaller) bucket."""
    n = int(n)
    spec = _parse_buckets()
    if spec == "off" or n <= 0:
        return n
    if isinstance(spec, list):
        best = None
        for s in spec:
            if s <= n:
                best = s
        return best if best is not None else n
    if n < _LINEAR_STEP:
        return n
    if n <= _LINEAR_HEAD:
        return (n // _LINEAR_STEP) * _LINEAR_STEP
    return 1 << (n.bit_length() - 1)


def pad_rows(arr: np.ndarray, target: int) -> np.ndarray:
    """Zero-pad ``arr`` along dim0 to ``target`` rows (no-op if already
    there). Zeros are the safe filler for row-wise computations: the padded
    rows produce rows that the caller slices off; real rows are
    untouched."""
    n = arr.shape[0]
    if target == n:
        return arr
    pad_width = [(0, target - n)] + [(0, 0)] * (arr.ndim - 1)
    return np.pad(arr, pad_width)


# ---------------------------------------------------------------------------
# Shape signatures
# ---------------------------------------------------------------------------

_lock = threading.Lock()
_SIGS: Dict[str, List[tuple]] = {}


def _dtype_name(x) -> str:
    dt = getattr(x, "dtype", None)
    if dt is None:
        return type(x).__name__
    return str(dt).replace("torch.", "")


def note_signature(kernel_id: str, arrays: Iterable[Any]) -> bool:
    """Record that ``kernel_id`` ran on these arrays' shapes and dtypes; a
    first-seen signature counts in ``jit.trace`` (and returns True), a
    repeat in ``jit.signature_hit``."""
    sig = tuple((tuple(int(d) for d in np.shape(a)), _dtype_name(a))
                for a in arrays)
    with _lock:
        seen = _SIGS.setdefault(kernel_id, [])
        new = sig not in seen
        if new:
            seen.append(sig)
    metrics.incr("jit.trace" if new else "jit.signature_hit")
    return new


def seen_warmup_specs(kernel_ids: Optional[Iterable[str]] = None
                      ) -> List[Tuple[str, list]]:
    """``[(kernel_id, [(shape, dtype), ...]), ...]`` for every signature the
    process has run, in the reference's warmup-spec shape (what the serving
    sidecar persists)."""
    wanted = set(kernel_ids) if kernel_ids is not None else None
    with _lock:
        items = [(k, list(v)) for k, v in _SIGS.items()]
    specs: List[Tuple[str, list]] = []
    for kid, sigs in items:
        if wanted is not None and kid not in wanted:
            continue
        for sig in sigs:
            specs.append((kid, [(tuple(s), str(d)) for s, d in sig]))
    return specs


def save_warmup_specs(path: str,
                      specs: Optional[Iterable] = None) -> int:
    """Write warmup specs to ``path`` in the reference's jsonl profile
    format (``{"kernel": id, "args": [[shape, dtype], ...]}`` a line).
    Atomic replace. Returns the number of specs written."""
    items = list(seen_warmup_specs() if specs is None else specs)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        for kernel_id, arg_sigs in items:
            f.write(json.dumps({
                "kernel": kernel_id,
                "args": [[list(s), str(d)] for s, d in arg_sigs],
            }) + "\n")
    os.replace(tmp, path)
    return len(items)


def signature_summary() -> Dict[str, Any]:
    """Signature counts per kernel id, and the share of bucketed calls that
    met an already-seen signature (``hit_rate``, None before any)."""
    with _lock:
        per = {k: len(v) for k, v in _SIGS.items()}
    new = metrics.counter("jit.trace")
    hits = metrics.counter("jit.signature_hit")
    return {"signatures": sum(per.values()), "kernels": per,
            "hit_rate": round(hits / (hits + new), 4) if hits + new
            else None}


def clear_signatures() -> None:
    """Forget every recorded signature (tests)."""
    with _lock:
        _SIGS.clear()
