"""Cross-process telemetry relay — the metric half of the fleet
observability plane (port of ``alink_tpu.common.telemetry``, copied).

A fleet replica (or any worker process) cannot serve its own
``GET /metrics``: the supervisor is the scrape target, so the numbers
must travel. This module is the bounded, garbage-tolerant contract they
travel under, piggybacked on the existing heartbeat control plane:

- :class:`TelemetrySource` (worker side) diffs the process-global
  :data:`~alink_tpu_torch.common.metrics.metrics` recorder against its last
  snapshot and emits a **delta** payload — counter increments plus
  per-histogram bucket-count deltas. Deltas keep each heartbeat O(changed
  metrics) and make the supervisor-side merge idempotent-free simple
  addition. Payloads are bounded (``MAX_HISTS``/``MAX_COUNTERS``, trimmed
  deterministically with the trim COUNTED in ``telemetry.trimmed`` — it
  rides the next delta, so trimming is never silent).
- :class:`TelemetrySink` (supervisor side) validates every payload
  before merging ANY of it (the ``_validate_hb_stats`` discipline: a
  malformed or oversized payload raises ``ValueError`` so the caller can
  count it loudly and drop it whole), then folds histogram deltas into
  the recorder's labeled families (``replica=<id>``) by exact per-bucket
  count sums and counter deltas into per-replica cumulative gauges.

Because every histogram shares the same fixed ``le`` ladder
(``DEFAULT_BUCKETS``), the fleet-wide distribution is the per-bucket SUM
of the per-replica series — ``metrics.merged_histogram(name)`` yields
exact pooled p50/p90/p99, never an average of averages.
"""

from __future__ import annotations

import json
from typing import Any, Dict, Optional, Tuple

from .metrics import StepMetrics, _Histogram, metrics

# one heartbeat's telemetry must stay a small fraction of the control
# plane's line budget; anything bigger is a bug or an attack, not data
MAX_PAYLOAD_BYTES = 128 * 1024
MAX_HISTS = 64
MAX_COUNTERS = 512
_MAX_NAME = 200

TELEMETRY_VERSION = 1


def _hist_delta(cur: Dict[str, Any], prev: Optional[Dict[str, Any]]
                ) -> Optional[Dict[str, Any]]:
    """Bucket-count delta between two states of the SAME histogram, or
    the full state when there is no comparable previous one (first
    heartbeat, or the histogram was recreated with different buckets).
    None when nothing changed."""
    if prev is None or list(prev["buckets"]) != list(cur["buckets"]):
        return dict(cur) if cur["count"] else None
    if cur["count"] == prev["count"]:
        return None
    return {
        "buckets": list(cur["buckets"]),
        "counts": [a - b for a, b in zip(cur["counts"], prev["counts"])],
        "count": cur["count"] - prev["count"],
        "sum": cur["sum"] - prev["sum"],
        # window min/max are unrecoverable from cumulative state; the
        # cumulative ones merge monotonically on the sink side
        "min": cur["min"],
        "max": cur["max"],
    }


class TelemetrySource:
    """Worker-side delta snapshotter over a :class:`StepMetrics`
    recorder (the process-global one by default). Call :meth:`delta`
    once per heartbeat; it returns ``None`` when nothing changed."""

    def __init__(self, recorder: Optional[StepMetrics] = None):
        self._rec = recorder or metrics
        self._prev_counters: Dict[str, int] = {}
        self._prev_hists: Dict[str, Dict[str, Any]] = {}

    def delta(self) -> Optional[Dict[str, Any]]:
        counters = self._rec.counters()
        hstates = self._rec.histogram_states()
        dc: Dict[str, int] = {}
        for k in sorted(counters):
            d = counters[k] - self._prev_counters.get(k, 0)
            if d:
                dc[k] = d
        dh: Dict[str, Dict[str, Any]] = {}
        for name in sorted(hstates):
            d = _hist_delta(hstates[name], self._prev_hists.get(name))
            if d is not None:
                dh[name] = d
        self._prev_counters = counters
        self._prev_hists = hstates
        trimmed = 0
        if len(dh) > MAX_HISTS:
            for name in sorted(dh)[MAX_HISTS:]:
                del dh[name]
                trimmed += 1
        if len(dc) > MAX_COUNTERS:
            for name in sorted(dc)[MAX_COUNTERS:]:
                del dc[name]
                trimmed += 1
        if trimmed:
            self._rec.incr("telemetry.trimmed", trimmed)
        if not dc and not dh:
            return None
        return {"v": TELEMETRY_VERSION, "counters": dc, "hists": dh}


def validate_telemetry(payload: Any) -> Tuple[Dict[str, int],
                                              Dict[str, Any]]:
    """Shape-check a wire telemetry payload, returning the (counters,
    hists) pair. Raises ``ValueError`` on anything malformed or
    oversized — the caller counts the drop (``fleet.bad_telemetry``);
    nothing is ever merged from a payload that fails here."""
    if not isinstance(payload, dict):
        raise ValueError("telemetry payload is not a dict")
    if payload.get("v") != TELEMETRY_VERSION:
        raise ValueError(f"telemetry version {payload.get('v')!r} "
                         f"(expected {TELEMETRY_VERSION})")
    try:
        nbytes = len(json.dumps(payload))
    except (TypeError, ValueError):
        raise ValueError("telemetry payload is not JSON-serializable")
    if nbytes > MAX_PAYLOAD_BYTES:
        raise ValueError(f"telemetry payload oversized ({nbytes} bytes "
                         f"> {MAX_PAYLOAD_BYTES})")
    counters = payload.get("counters", {})
    hists = payload.get("hists", {})
    if not isinstance(counters, dict) or not isinstance(hists, dict):
        raise ValueError("telemetry counters/hists are not dicts")
    if len(counters) > MAX_COUNTERS or len(hists) > MAX_HISTS:
        raise ValueError("telemetry payload exceeds name caps")
    for k, v in counters.items():
        if not isinstance(k, str) or len(k) > _MAX_NAME \
                or not isinstance(v, int) or isinstance(v, bool):
            raise ValueError(f"bad counter delta {k!r}={v!r}")
    for k, st in hists.items():
        if not isinstance(k, str) or len(k) > _MAX_NAME:
            raise ValueError(f"bad histogram name {k!r}")
        _Histogram.from_state(st)  # raises ValueError on garbage
    return counters, hists


class TelemetrySink:
    """Supervisor-side accumulator: validated payloads merge into the
    recorder under a ``replica`` label; per-replica counter totals stay
    queryable for ``fleet_summary()``."""

    def __init__(self, recorder: Optional[StepMetrics] = None):
        self._rec = recorder or metrics
        self._counters: Dict[str, Dict[str, int]] = {}

    def ingest(self, payload: Any, replica: str) -> None:
        """Validate-then-merge; raises ``ValueError`` (nothing merged)
        on garbage."""
        counters, hists = validate_telemetry(payload)
        cum = self._counters.setdefault(str(replica), {})
        for name, d in counters.items():
            cum[name] = cum.get(name, 0) + d
        for name, st in hists.items():
            self._rec.merge_histogram(name, st, replica=str(replica))

    def counters_for(self, replica: str) -> Dict[str, int]:
        return dict(self._counters.get(str(replica), {}))

    def counter_totals(self, prefix: str = "") -> Dict[str, int]:
        """Fleet-wide counter sums across every replica seen."""
        out: Dict[str, int] = {}
        for cum in self._counters.values():
            for name, v in cum.items():
                if name.startswith(prefix):
                    out[name] = out.get(name, 0) + v
        return out

    def forget(self, replica: str) -> None:
        """Drop a replica's cumulative counter view (it died for good);
        its histogram contributions are history and stay merged."""
        self._counters.pop(str(replica), None)
