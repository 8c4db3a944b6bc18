"""Persisted warmup specs — the disk half of zero-cold-start serving (port
of ``alink_tpu.serving.warmup_store``; the same JSON, so a sidecar written
by either package loads in the other).

A serving replica's readiness cost is warmup: :meth:`ModelServer.load`
predicts once at every bucket rung so production traffic meets no new
batch shape. This module persists what the first replica learned as a JSON
sidecar next to the ``.ak`` model (``<model>.ak.warmup.json``):

- the serving ``input_schema`` and the sample ``warmup_rows`` the ladder
  warmup tiles (so ``server.load(name, "model.ak")`` needs no other input),
- the bucket ladder + ``max_batch_rows`` the rows were warmed at,
- the per-kernel shape signatures recorded during warmup
  (``common/jitcache.seen_warmup_specs`` format).

The port compiles nothing at warmup (eager PyTorch; the CUDA kernels are
built once per process), so the sidecar's gain here is the schema and the
rows: a fresh process warms every rung from disk artifacts alone.
Predictions are identical either way — warmup only populates caches.

Corruption-safe: a missing, truncated, or schema-incompatible sidecar reads
as None (counted under ``serving.warmup_spec_errors``) and the caller falls
back to live ladder warmup; a sidecar whose recorded ``model_digest`` no
longer matches the ``.ak`` content (the model was retrained) reads as None
too (``serving.warmup_spec_stale``) so stale inputs never bind to a
different model — while byte-preserving copies keep it valid. Writes are
atomic (tmp + rename); replica loads that warmed FROM a sidecar never
rewrite it (failed writes count under ``serving.warmup_spec_write_errors``).
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..common.metrics import metrics

WARMUP_SIDECAR_SUFFIX = ".warmup.json"
WARMUP_SPEC_VERSION = 1


def warmup_sidecar_path(model_path: str) -> str:
    """The sidecar path for a saved model: ``<model>.ak.warmup.json``."""
    return model_path + WARMUP_SIDECAR_SUFFIX


def _model_digest(model_path: str) -> Optional[str]:
    """Streamed content hash of the model file (None when unreadable).
    One full read per save/load — load happens once per replica, and the
    copy-safety it buys (stat-based stamps break under every rollout tool
    that rewrites mtimes) is the point of the sidecar."""
    import hashlib

    try:
        h = hashlib.blake2b(digest_size=16)
        with open(model_path, "rb") as f:
            for chunk in iter(lambda: f.read(1 << 20), b""):
                h.update(chunk)
        return h.hexdigest()
    except OSError:
        return None


def _json_cell(v) -> Any:
    """A warmup-row cell as a JSON scalar; raises TypeError for cells that
    do not round-trip (vectors/tensors — those models fall back to live
    warmup with caller-provided rows)."""
    if isinstance(v, (bool, int, float, str)) or v is None:
        return v
    if isinstance(v, np.generic):
        return v.item()
    raise TypeError(f"warmup row cell of type {type(v).__name__} does not "
                    "round-trip through JSON")


def save_warmup_spec(model_path: str, *,
                     input_schema: str,
                     warmup_rows: Sequence[Sequence],
                     max_batch_rows: int,
                     ladder: Sequence[int],
                     kernels: Optional[Sequence[Tuple[str, list]]] = None,
                     precision: Optional[Dict[str, Any]] = None,
                     synthetic_rows: bool = False,
                     path: Optional[str] = None,
                     fsync: bool = False) -> Optional[str]:
    """Persist one model's warmup spec next to its ``.ak``. Returns the
    sidecar path, or None when the rows cannot be JSON-persisted (exotic
    cell types) — never raises on content, only on unwritable storage.

    ``precision`` optionally records the serving quantization policy the
    loading replica proved out (``{"policy", "calib", "band"}``) so a
    later load of the same model reproduces the exact quantized serving
    state — same policy, same calibrated activation scales — with no
    re-gating. Readers without the block (or older sidecars)
    see plain fp32 specs; the spec version is unchanged.

    ``synthetic_rows`` marks warmup rows that were SYNTHESIZED (all-zero
    schema probes), not sampled from real inputs — a quantized load must
    never seed activation ranges from them, so readers refuse int8
    calibration off a sidecar carrying this flag."""
    try:
        rows = [[_json_cell(c) for c in row] for row in warmup_rows]
    except TypeError:
        metrics.incr("serving.warmup_spec_skipped")
        return None
    spec: Dict[str, Any] = {
        "version": WARMUP_SPEC_VERSION,
        "model": os.path.basename(model_path),
        # CONTENT fingerprint of the .ak this warmup belongs to: a
        # re-saved model at the same path must invalidate the sidecar
        # (stale schema/rows must never bind to a retrained model), while
        # copy-based rollouts (cp/gsutil/docker ADD — mtimes rewritten)
        # must keep it valid — so hash the bytes, not the stat
        "model_digest": _model_digest(model_path),
        "input_schema": input_schema,
        "warmup_rows": rows,
        "max_batch_rows": int(max_batch_rows),
        "ladder": [int(r) for r in ladder],
        "kernels": [[kid, [[list(map(int, s)), str(d)] for s, d in sigs]]
                    for kid, sigs in (kernels or [])],
    }
    if precision is not None:
        spec["precision"] = precision
    if synthetic_rows:
        spec["synthetic_rows"] = True
    out = path or warmup_sidecar_path(model_path)
    tmp = f"{out}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(spec, f)
        if fsync:
            # the modelstream publisher commits a manifest that names this
            # sidecar — its bytes must be on disk before that rename
            f.flush()
            try:
                os.fsync(f.fileno())
            except OSError:
                metrics.incr("serving.warmup_spec_fsync_errors")
    os.replace(tmp, out)
    metrics.incr("serving.warmup_spec_saved")
    return out


def load_warmup_spec(model_path: str,
                     path: Optional[str] = None) -> Optional[Dict[str, Any]]:
    """Read a model's persisted warmup spec. Returns the spec dict with
    ``kernels`` normalized to the ``[(kernel_id, [(shape, dtype), ...])]``
    shape ``seen_warmup_specs`` returns, or None (missing / corrupt /
    future-versioned — counted, never raised: a bad sidecar must degrade to
    live warmup, not fail a replica rollout)."""
    p = path or warmup_sidecar_path(model_path)
    if not os.path.exists(p):
        return None
    try:
        with open(p) as f:
            spec = json.load(f)
        if not isinstance(spec, dict) or \
                int(spec.get("version", 0)) > WARMUP_SPEC_VERSION:
            raise ValueError(f"unsupported warmup spec: {p}")
        stamp = spec.get("model_digest")
        if stamp is not None and os.path.exists(model_path):
            if _model_digest(model_path) != stamp:
                # the .ak's CONTENT changed since this sidecar was
                # written: its schema/rows describe a DIFFERENT model —
                # stale, not corrupt, and the caller falls back to live
                # warmup
                metrics.incr("serving.warmup_spec_stale")
                return None
        rows = [tuple(r) for r in spec.get("warmup_rows") or []]
        kernels: List[Tuple[str, list]] = []
        for kid, sigs in spec.get("kernels") or []:
            kernels.append((str(kid),
                            [(tuple(int(x) for x in s), str(d))
                             for s, d in sigs]))
        spec["warmup_rows"] = rows
        spec["kernels"] = kernels
        return spec
    except (OSError, ValueError, TypeError, KeyError):
        # the sidecar file EXISTS but failed to parse/validate — a torn or
        # garbage write, distinct from the missing-file path above. Count it
        # on its own so a fleet rollout that keeps "working" via live warmup
        # still surfaces the corruption.
        metrics.incr("serving.warmup_sidecar_corrupt")
        metrics.incr("serving.warmup_spec_errors")
        return None
