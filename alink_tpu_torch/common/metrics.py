"""Structured step metrics + profiling hooks (port of
``alink_tpu.common.metrics``).

The recorder is the reference's, copied: named series, timers,
fixed-bucket histograms (the same ``le`` edges, so the same quantiles),
counters, gauges, the labeled histogram families that other processes'
states merge into (``merge_histogram``: exact per-bucket count sums, so a
fleet's quantiles are the quantiles of the union), export hooks, and the
Prometheus text exposition with the same series names.
:func:`profile_trace` writes a ``torch.profiler`` Chrome trace where the
reference starts ``jax.profiler``. The executor's node-phase accounting is
the reference's: the DAG executor opens ``node_phase_context`` on the
thread running a unit, lower layers add their seconds with
``add_node_phase`` (``stream_map``'s ``transfer_s``/``compute_s``), and
``executor_trace`` reads the per-unit records back.

Usage:
    from alink_tpu_torch.common.metrics import metrics, timed, profile_trace

    with timed("gbdt.train"):
        ...
    metrics.record("bert.step", step=i, loss=l, samples_per_sec=sps)
    metrics.observe("stream.chunk_s", dt)   # fixed-bucket histogram
    with profile_trace("build/trace"):      # Chrome trace via torch.profiler
        train()
    metrics.summary()                   # {'gbdt.train': {...}, ...}
    metrics.export_prometheus()         # text exposition for GET /metrics

Thread-safety: the serving batchers, transfer streams, and callers all
record concurrently, so EVERY mutation of series/timers/histograms happens
under ``_data_lock`` (counters keep their own ``_counter_lock`` — they are
hit from signal paths that must never contend with bulk recording).
"""

from __future__ import annotations

import bisect
import contextlib
import json
import logging
import re
import threading
import time
from collections import defaultdict
from typing import Any, Dict, List, Optional, Sequence

logger = logging.getLogger("alink_tpu_torch.metrics")

# Fixed histogram ladder (seconds): µs-scale dispatches up to minute-scale
# epochs. Fixed buckets keep observe() O(log n), lock-cheap, and make every
# exported histogram mergeable across processes (same `le` edges).
DEFAULT_BUCKETS = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
)


class _Histogram:
    """Fixed-bucket histogram: per-bucket counts plus count/sum/min/max.
    Quantiles are estimated by linear interpolation inside the bucket the
    target rank falls in (the Prometheus client convention)."""

    __slots__ = ("buckets", "counts", "count", "sum", "min", "max")

    def __init__(self, buckets: Sequence[float] = DEFAULT_BUCKETS):
        self.buckets = tuple(sorted(float(b) for b in buckets))
        self.counts = [0] * (len(self.buckets) + 1)  # [-1] is +Inf
        self.count = 0
        self.sum = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None

    def observe(self, value: float) -> None:
        v = float(value)
        self.counts[bisect.bisect_left(self.buckets, v)] += 1
        self.count += 1
        self.sum += v
        self.min = v if self.min is None else min(self.min, v)
        self.max = v if self.max is None else max(self.max, v)

    def quantile(self, q: float) -> Optional[float]:
        if not self.count:
            return None
        target = q * self.count
        cum = 0.0
        lo = 0.0
        for i, edge in enumerate(self.buckets):
            nxt = cum + self.counts[i]
            if nxt >= target:
                frac = (target - cum) / max(self.counts[i], 1)
                est = lo + frac * (edge - lo)
                return min(max(est, self.min), self.max)
            cum = nxt
            lo = edge
        return self.max  # rank lands in the +Inf bucket

    def stats(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {
            "count": self.count,
            "sum": round(self.sum, 6),
            "min": self.min,
            "max": self.max,
            "mean": round(self.sum / self.count, 6) if self.count else None,
        }
        for q, label in ((0.5, "p50"), (0.9, "p90"), (0.99, "p99")):
            v = self.quantile(q)
            out[label] = round(v, 6) if v is not None else None
        return out

    def snapshot(self) -> "_Histogram":
        h = _Histogram(self.buckets)
        h.counts = list(self.counts)
        h.count, h.sum, h.min, h.max = (self.count, self.sum,
                                        self.min, self.max)
        return h

    def state(self) -> Dict[str, Any]:
        """JSON-serializable full state — the unit the cross-process
        telemetry relay ships. Same ``le`` edges on both sides make the
        merge a per-bucket count sum, i.e. EXACT (fleet-wide quantiles
        are quantiles of the true pooled distribution, not averages of
        per-replica quantiles)."""
        return {"buckets": list(self.buckets), "counts": list(self.counts),
                "count": self.count, "sum": self.sum,
                "min": self.min, "max": self.max}

    @classmethod
    def from_state(cls, state: Any) -> "_Histogram":
        """Rebuild from :meth:`state` output; raises ``ValueError`` on any
        malformed shape (wire payloads are untrusted — the caller counts
        and drops)."""
        if not isinstance(state, dict):
            raise ValueError("histogram state is not a dict")
        buckets = state.get("buckets")
        counts = state.get("counts")
        if not isinstance(buckets, (list, tuple)) \
                or not isinstance(counts, (list, tuple)) \
                or len(counts) != len(buckets) + 1:
            raise ValueError("histogram state buckets/counts mismatch")
        try:
            h = cls([float(b) for b in buckets])
            h.counts = [int(c) for c in counts]
            h.count = int(state.get("count", 0))
            h.sum = float(state.get("sum", 0.0))
            mn, mx = state.get("min"), state.get("max")
            h.min = float(mn) if mn is not None else None
            h.max = float(mx) if mx is not None else None
        except (TypeError, ValueError):
            raise ValueError("histogram state fields are not numeric")
        if any(c < 0 for c in h.counts) or h.count < 0:
            raise ValueError("histogram state counts are negative")
        return h

    def merge(self, other: "_Histogram") -> None:
        """Exact in-place merge: per-bucket count sum. Raises
        ``ValueError`` on differing bucket edges — summing misaligned
        buckets would fabricate a distribution."""
        if other.buckets != self.buckets:
            raise ValueError("cannot merge histograms with different "
                             f"buckets ({len(self.buckets)} vs "
                             f"{len(other.buckets)} edges)")
        self.counts = [a + b for a, b in zip(self.counts, other.counts)]
        self.count += other.count
        self.sum += other.sum
        for attr, pick in (("min", min), ("max", max)):
            o = getattr(other, attr)
            if o is not None:
                mine = getattr(self, attr)
                setattr(self, attr, o if mine is None else pick(mine, o))


def _prom_name(name: str, *, seconds: bool = False) -> str:
    """Stable ``alink_`` exposition name: dots/dashes to underscores,
    ``*_s`` second-suffixed sources become ``*_seconds``."""
    if seconds and name.endswith("_s"):
        name = name[:-2]
    s = re.sub(r"[^a-zA-Z0-9_]", "_", name)
    if s and s[0].isdigit():
        s = "_" + s
    return "alink_" + s + ("_seconds" if seconds else "")


def _prom_float(v: float) -> str:
    return repr(round(float(v), 9))


def _prom_label_value(v: str) -> str:
    return str(v).replace("\\", r"\\").replace('"', r'\"').replace("\n", r"\n")


class StepMetrics:
    """In-process metric streams: named series of {step, **values} dicts,
    aggregated timers, fixed-bucket histograms, and monotonic counters. One
    global instance (``metrics``) serves the whole session; algorithms
    record cheaply, callers read ``series``/``counters``/``histogram``/
    ``summary`` or export the lot as Prometheus text exposition."""

    def __init__(self):
        self._series: Dict[str, List[Dict[str, Any]]] = defaultdict(list)
        self._timers: Dict[str, List[float]] = defaultdict(list)
        self._hists: Dict[str, _Histogram] = {}
        # merged-in histograms of other processes (fleet replicas), one
        # series per label set, kept apart from this process's own
        self._labeled_hists: Dict[str, Dict[tuple, _Histogram]] = {}
        self._export_hooks: List[Any] = []
        self._gauges: Dict[str, Dict[tuple, float]] = {}
        self._counters: Dict[str, int] = defaultdict(int)
        self._counter_lock = threading.Lock()
        # one lock for series+timers+histograms: executor pool threads,
        # transfer streams, and recovery chains record concurrently, and
        # list.append / del-slice / defaultdict-materialize interleavings
        # without it silently lose or duplicate records
        self._data_lock = threading.Lock()
        self.enabled = True

    def record(self, name: str, **values):
        if self.enabled:
            with self._data_lock:
                self._series[name].append(dict(values))

    def record_bounded(self, name: str, limit: int, **values):
        """record() with a ring bound — high-frequency series (the executor
        emits per-node records on every collect/execute) must not grow
        without bound in long-lived serving processes."""
        if self.enabled:
            with self._data_lock:
                s = self._series[name]
                s.append(dict(values))
                if len(s) > limit:
                    del s[: len(s) - limit]

    def add_time(self, name: str, seconds: float):
        if self.enabled:
            with self._data_lock:
                self._timers[name].append(seconds)

    def observe(self, name: str, value: float,
                buckets: Optional[Sequence[float]] = None):
        """Record ``value`` into the fixed-bucket histogram ``name``
        (created on first observe; ``buckets`` only applies then). Unlike
        timers — which keep every sample — a histogram is O(buckets)
        memory forever, which is what latency *distributions* on hot paths
        (per-node wall, transfer seconds, chunk latency) need in a
        long-lived serving process."""
        if self.enabled:
            with self._data_lock:
                h = self._hists.get(name)
                if h is None:
                    h = self._hists[name] = _Histogram(
                        buckets or DEFAULT_BUCKETS)
                h.observe(value)

    def set_gauge(self, name: str, value: float, **labels):
        """Last-write-wins gauge, optionally labeled (one series per label
        set). Gauges are for readout surfaces that recompute a current
        value — per-kernel cost figures, watermarks — where a counter or
        timer history would be the wrong shape."""
        key = tuple(sorted((str(k), str(v)) for k, v in labels.items()))
        with self._data_lock:
            self._gauges.setdefault(name, {})[key] = float(value)

    def gauge(self, name: str, **labels) -> Optional[float]:
        key = tuple(sorted((str(k), str(v)) for k, v in labels.items()))
        with self._data_lock:
            return self._gauges.get(name, {}).get(key)

    def register_export_hook(self, fn):
        """Register a callable invoked at the top of every
        ``export_prometheus()`` — the mechanism for a subsystem to refresh
        its gauges exactly when a scraper looks. Hook failures are counted
        (``metrics.dropped``), never raised into the exposition."""
        if fn not in self._export_hooks:
            self._export_hooks.append(fn)

    def incr(self, name: str, n: int = 1):
        """Monotonic event counter (retries, dead-letter drops, defusions).
        Counters count even while recording is disabled — they are the
        signal that something went wrong, which is exactly when a metrics
        blackout must not hide it."""
        with self._counter_lock:
            self._counters[name] += n

    def counter(self, name: str) -> int:
        with self._counter_lock:
            return self._counters.get(name, 0)

    def counters(self, prefix: str = "") -> Dict[str, int]:
        with self._counter_lock:
            return {k: v for k, v in self._counters.items()
                    if k.startswith(prefix)}

    def series(self, name: str) -> List[Dict[str, Any]]:
        with self._data_lock:
            return list(self._series.get(name, []))

    def last(self, name: str) -> Optional[Dict[str, Any]]:
        with self._data_lock:
            s = self._series.get(name)
            return dict(s[-1]) if s else None

    def timer_stats(self, name: str) -> Optional[Dict[str, float]]:
        with self._data_lock:
            ts = list(self._timers.get(name) or ())
        if not ts:
            return None
        return {"count": len(ts), "total_s": sum(ts),
                "mean_s": sum(ts) / len(ts), "max_s": max(ts)}

    def histogram(self, name: str) -> Optional[Dict[str, Any]]:
        """count/sum/min/max/mean plus p50/p90/p99 estimates for one
        histogram, or None if it was never observed."""
        with self._data_lock:
            h = self._hists.get(name)
            h = h.snapshot() if h is not None else None
        return h.stats() if h is not None else None

    def histogram_names(self) -> List[str]:
        with self._data_lock:
            return sorted(self._hists)

    def histogram_states(self) -> Dict[str, Dict[str, Any]]:
        """Raw serializable state (buckets and counts) of every
        histogram."""
        with self._data_lock:
            return {n: h.state() for n, h in self._hists.items()}

    def merge_histogram(self, name: str, state: Any, **labels) -> None:
        """Merge a serialized histogram state delta (from another
        process's :meth:`histogram_states`) into the labeled family
        ``name`` — per-bucket count sums, so the labeled series stays an
        exact histogram of that sender's observations. Raises
        ``ValueError`` on malformed state or bucket-edge mismatch; the
        caller decides how loudly to drop."""
        incoming = _Histogram.from_state(state)
        key = tuple(sorted((str(k), str(v)) for k, v in labels.items()))
        with self._data_lock:
            fam = self._labeled_hists.setdefault(name, {})
            h = fam.get(key)
            if h is None:
                fam[key] = incoming
            else:
                h.merge(incoming)

    def labeled_histogram(self, name: str, **labels
                          ) -> Optional[Dict[str, Any]]:
        key = tuple(sorted((str(k), str(v)) for k, v in labels.items()))
        with self._data_lock:
            h = self._labeled_hists.get(name, {}).get(key)
            h = h.snapshot() if h is not None else None
        return h.stats() if h is not None else None

    def merged_histogram(self, name: str, include_local: bool = False
                         ) -> Optional[Dict[str, Any]]:
        """Stats of the EXACT merge of every labeled series of ``name``
        (optionally folding in the local unlabeled histogram): bucket
        counts sum across senders, so p50/p90/p99 are quantiles of the
        pooled distribution — never averaged averages. None when nothing
        was ever merged."""
        with self._data_lock:
            parts = [h.snapshot()
                     for h in self._labeled_hists.get(name, {}).values()]
            if include_local and name in self._hists:
                parts.append(self._hists[name].snapshot())
        if not parts:
            return None
        out = parts[0]
        for h in parts[1:]:
            out.merge(h)
        return out.stats()

    def summary(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        with self._data_lock:
            timer_names = list(self._timers)
            series_snap = {n: (len(s), s[-1] if s else None)
                           for n, s in self._series.items()}
            hist_snap = {n: h.snapshot() for n, h in self._hists.items()}
        for name in timer_names:
            out[name] = self.timer_stats(name)
        for name, (points, last) in series_snap.items():
            out.setdefault(name, {})
            out[name] = {**(out[name] or {}), "points": points, "last": last}
        for name, h in hist_snap.items():
            out.setdefault(name, {})
            out[name] = {**(out[name] or {}), "histogram": h.stats()}
        for name, v in self.counters().items():
            out.setdefault(name, {})
            out[name] = {**(out[name] or {}), "count": v}
        return out

    def to_json(self) -> str:
        return json.dumps(self.summary(), default=str)

    def export_prometheus(self) -> str:
        """Text exposition (Prometheus format 0.0.4) of every counter
        (``alink_*_total``), timer (``alink_*_seconds`` count+sum summary),
        and histogram (``alink_*_seconds`` with cumulative ``le`` buckets).
        Names are stable ``alink_``-prefixed translations of the in-process
        dotted names; a name claimed by an earlier family is skipped rather
        than emitted twice (exposition must not repeat a metric)."""
        for hook in list(self._export_hooks):
            try:
                hook()
            except Exception as e:
                _count_drop("export_hook", e)

        lines: List[str] = []
        seen: set = set()

        for name, v in sorted(self.counters().items()):
            m = _prom_name(name) + "_total"
            if m in seen:
                continue
            seen.add(m)
            lines.append(f"# TYPE {m} counter")
            lines.append(f"{m} {v}")

        with self._data_lock:
            timers = {n: (len(ts), sum(ts))
                      for n, ts in self._timers.items() if ts}
            hists = {n: h.snapshot() for n, h in self._hists.items()}
            lhists = {n: {k: h.snapshot() for k, h in fam.items()}
                      for n, fam in self._labeled_hists.items()}
            gauges = {n: dict(vals) for n, vals in self._gauges.items()}

        for name, vals in sorted(gauges.items()):
            m = _prom_name(name)
            if m in seen:
                continue
            seen.add(m)
            lines.append(f"# TYPE {m} gauge")
            for lkey, v in sorted(vals.items()):
                lbl = ("{" + ",".join(
                    f'{k}="{_prom_label_value(x)}"' for k, x in lkey) + "}"
                    if lkey else "")
                lines.append(f"{m}{lbl} {_prom_float(v)}")

        # one exposition family per histogram name: the local unlabeled
        # series first, then every labeled (e.g. replica="r1") series —
        # a single # TYPE header covers them all, as the format requires
        fams: Dict[str, List[tuple]] = {}
        for name, h in hists.items():
            fams.setdefault(name, []).append(((), h))
        for name, fam in lhists.items():
            for lkey, h in sorted(fam.items()):
                fams.setdefault(name, []).append((lkey, h))
        for name, series in sorted(fams.items()):
            m = _prom_name(name, seconds=True)
            if m in seen:
                continue
            seen.add(m)
            lines.append(f"# TYPE {m} histogram")
            for lkey, h in series:
                base = [f'{k}="{_prom_label_value(x)}"' for k, x in lkey]
                sfx = "{" + ",".join(base) + "}" if base else ""
                cum = 0
                for edge, c in zip(h.buckets, h.counts):
                    cum += c
                    lbl = ",".join(base + [f'le="{_prom_float(edge)}"'])
                    lines.append(f"{m}_bucket{{{lbl}}} {cum}")
                cum += h.counts[-1]
                lbl = ",".join(base + ['le="+Inf"'])
                lines.append(f"{m}_bucket{{{lbl}}} {cum}")
                lines.append(f"{m}_sum{sfx} {_prom_float(h.sum)}")
                lines.append(f"{m}_count{sfx} {cum}")

        for name, (count, total) in sorted(timers.items()):
            m = _prom_name(name, seconds=True)
            if m in seen:
                continue
            seen.add(m)
            lines.append(f"# TYPE {m} summary")
            lines.append(f"{m}_count {count}")
            lines.append(f"{m}_sum {_prom_float(total)}")
        return "\n".join(lines) + "\n"

    def reset(self):
        global _drop_logged
        with self._data_lock:
            self._series.clear()
            self._timers.clear()
            self._hists.clear()
            self._labeled_hists.clear()
            self._gauges.clear()
        with self._counter_lock:
            self._counters.clear()
        # re-arm the first-drop debug log: after a reset the operator is
        # looking at a fresh window and the next drop is news again
        _drop_logged = False


metrics = StepMetrics()


def export_prometheus() -> str:
    """Module-level convenience over the global recorder — the function the
    package root exports and ``GET /metrics`` serves."""
    return metrics.export_prometheus()


# ---------------------------------------------------------------------------
# Executor node-phase accounting
# ---------------------------------------------------------------------------
# The DAG executor opens a per-node context on the thread running the node;
# lower layers (device streaming) add transfer/compute seconds into whatever
# node is active without knowing about the executor. No-op when no node
# context is open (direct op calls, tests).

_node_ctx = threading.local()


@contextlib.contextmanager
def node_phase_context(phases: Dict[str, float]):
    prev = getattr(_node_ctx, "phases", None)
    _node_ctx.phases = phases
    try:
        yield phases
    finally:
        _node_ctx.phases = prev


def add_node_phase(key: str, seconds: float):
    phases = getattr(_node_ctx, "phases", None)
    if phases is not None:
        phases[key] = phases.get(key, 0.0) + seconds


def executor_trace() -> List[Dict[str, Any]]:
    """Per-unit records of the last executed DAGs: one dict per unit with
    ``op``/``wall_s`` plus any phases (``transfer_s``, ``compute_s``,
    ``fused``) the unit reported, and ``t0_s``/``t1_s`` (its interval on
    the ``time.perf_counter`` clock)."""
    return metrics.series("executor.node")


@contextlib.contextmanager
def timed(name: str, recorder: Optional[StepMetrics] = None):
    """Wall-clock timer context; feeds the global recorder by default."""
    rec = recorder or metrics
    t0 = time.perf_counter()
    try:
        yield
    finally:
        rec.add_time(name, time.perf_counter() - t0)


_drop_logged = False


def _count_drop(where: str, exc: BaseException):
    """A failure inside the metrics/profiling machinery itself must not
    abort the measured code — but it must not vanish either: count it in
    ``metrics.dropped`` and log the first occurrence at debug."""
    global _drop_logged
    metrics.incr("metrics.dropped")
    if not _drop_logged:
        _drop_logged = True
        logger.debug("metrics drop at %s: %r (further drops counted in "
                     "the 'metrics.dropped' counter only)", where, exc)


@contextlib.contextmanager
def profile_trace(log_dir: str, *, activities=None):
    """``torch.profiler`` trace context: on exit the trace is written to
    ``log_dir/trace.json`` (Chrome trace format; chrome://tracing or
    ui.perfetto.dev). CPU activity always, CUDA activity when a card is
    present. No-op fallback if the profiler cannot start (e.g. one is
    already running); start/stop failures are counted in
    ``metrics.dropped``, never raised."""
    import os

    import torch

    prof = None
    try:
        if activities is None:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=activities)
        prof.__enter__()
    except Exception as e:
        prof = None
        _count_drop("profile_trace.start", e)
    try:
        yield prof
    finally:
        if prof is not None:
            try:
                prof.__exit__(None, None, None)
                os.makedirs(log_dir, exist_ok=True)
                prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
            except Exception as e:
                _count_drop("profile_trace.stop", e)
