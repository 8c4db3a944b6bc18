"""Device-memory watermarks at executor node boundaries (port of the part of
``alink_tpu.common.profiling`` that the DAG executor calls).

:func:`sample_device_memory` reads the caching allocator's counters of
every visible CUDA device (``torch.cuda.memory_allocated`` and
``max_memory_allocated``) and keeps the process-wide peak;
:func:`hbm_watermark` reads it back. On a host without CUDA the first probe
finds no stats, the sampler latches unavailable and every later call is a
cheap no-op returning None. A process that has not touched CUDA yet is not
made to create a context by a sample (it returns None and does not latch).

The sample never synchronizes the device: the allocator's counters are host
state, and a ``torch.cuda.synchronize`` here would serialize the DAG's
concurrent branches.

Knob (env): ``ALINK_PROFILING`` — ``off`` disables sampling (the
reference's knob; any other value samples).

The reference's program-cost registry, roofline attribution and
``/api/profile`` readouts are not ported (ROADMAP A10).
"""

from __future__ import annotations

import sys
import threading
from typing import Any, Dict, Optional

from .env import env_str
from .metrics import metrics


def profiling_enabled() -> bool:
    raw = (env_str("ALINK_PROFILING", "on") or "on").strip().lower()
    return raw not in ("off", "0", "false", "no", "none")


_hbm_lock = threading.Lock()
_hbm: Dict[str, Any] = {"available": None, "peak_bytes": 0,
                        "last_bytes": None, "samples": 0}


def sample_device_memory() -> Optional[int]:
    """Sample the allocator across the visible CUDA devices and update the
    process-wide watermark. Returns total bytes in use, or None where there
    are no stats (no CUDA, or CUDA not yet initialized in this process)."""
    if not profiling_enabled():
        return None
    with _hbm_lock:
        if _hbm["available"] is False:
            return None
    if "torch" not in sys.modules:
        return None
    try:
        import torch

        if not torch.cuda.is_available():
            with _hbm_lock:
                _hbm["available"] = False
            return None
        if not torch.cuda.is_initialized():
            return None
        in_use = peak = 0
        for i in range(torch.cuda.device_count()):
            cur = int(torch.cuda.memory_allocated(i))
            in_use += cur
            peak += int(max(torch.cuda.max_memory_allocated(i), cur))
    except Exception:
        # a transient stats error must not latch sampling off for good —
        # only a clean probe that found no CUDA at all does that
        metrics.incr("profile.hbm_sample_errors")
        return None
    with _hbm_lock:
        _hbm["available"] = True
        _hbm["samples"] += 1
        _hbm["last_bytes"] = in_use
        _hbm["peak_bytes"] = max(_hbm["peak_bytes"], peak, in_use)
    return in_use


def hbm_watermark() -> Dict[str, Any]:
    with _hbm_lock:
        d = dict(_hbm)
    return {
        "available": bool(d["available"]),
        "peak_bytes": d["peak_bytes"] or None,
        "bytes_in_use": d["last_bytes"],
        "samples": d["samples"],
    }
