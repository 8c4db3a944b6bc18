"""Job-scoped span tracing — the Dapper-style correlation layer (port of
``alink_tpu.common.tracing``, copied but for :func:`job_report`'s cache
and analysis blocks, which read the port's own modules).

- :func:`trace_span` — context-managed span: trace id / span id / parent id,
  wall time, per-phase seconds, and an outcome (``ok`` / ``retried`` /
  ``failed`` / ``defused``). Spans nest through a thread-local;
  :func:`capture_context` + :func:`attach_context` carry the parent across
  explicit thread handoffs (the serving batcher thread re-attaches the
  submitting request's span), and :func:`wire_context` /
  :func:`adopt_context` carry it across a process boundary.
- :class:`Tracer` — process-wide finished-span sink: a bounded in-memory
  ring (``ALINK_TRACE_RING``, default 4096 spans) plus an optional append-
  only JSONL event log (``ALINK_TRACE_LOG=<path>``; one JSON object per
  finished span).
- :func:`job_report` — one dict per job run: the span tree, the phase
  split, retries absorbed, outcome counts, and the shape-signature and
  staging-cache hit rates; :func:`chrome_trace` — the ring as a
  chrome://tracing / Perfetto JSON object.

Everything is gated behind ``ALINK_TRACING`` (default **on**; ``off``
restores zero-span execution), read per span open. Tracing NEVER changes
results.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
import uuid
from collections import deque
from typing import Any, Dict, List, Optional

from .env import env_flag, env_float, env_int, env_str
from .metrics import metrics

_RING_DEFAULT = 4096

# span ids carry a per-process random prefix: a span parented under
# another process's (adopt_context) must never alias two processes'
# counters into one parent link
_SPAN_PREFIX = uuid.uuid4().hex[:6]
_span_ids = itertools.count(1)

def tracing_enabled() -> bool:
    """``ALINK_TRACING=off`` disables span recording entirely (the
    histogram/counter layer in ``common/metrics.py`` stays on — it predates
    tracing and other readouts depend on it)."""
    return env_flag("ALINK_TRACING", default=True)


class Span:
    """One traced unit of work. Mutable while open; callers may set
    ``outcome`` explicitly (``defused``), add ``phases`` seconds, or attach
    ``attrs``; everything else is filled by the tracer."""

    __slots__ = ("trace_id", "span_id", "parent_id", "name", "t_start",
                 "start_perf", "wall_s", "phases", "outcome", "retries",
                 "attrs", "thread", "error")

    def __init__(self, trace_id: str, span_id: str, parent_id: Optional[str],
                 name: str, attrs: Dict[str, Any]):
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.name = name
        self.t_start = time.time()
        self.start_perf = time.perf_counter()
        self.wall_s: float = 0.0
        self.phases: Dict[str, float] = {}
        self.outcome: Optional[str] = None
        self.retries = 0
        self.attrs = attrs
        self.thread = threading.current_thread().name
        self.error: Optional[str] = None

    def to_dict(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "name": self.name,
            "t_start": round(self.t_start, 6),
            "start_perf": self.start_perf,
            "wall_s": round(self.wall_s, 6),
            "outcome": self.outcome,
            "thread": self.thread,
        }
        if self.phases:
            d["phases"] = {k: round(v, 6) if isinstance(v, float) else v
                           for k, v in self.phases.items()}
        if self.retries:
            d["retries"] = self.retries
        if self.attrs:
            d["attrs"] = self.attrs
        if self.error:
            d["error"] = self.error
        return d


_ctx = threading.local()


def current_span() -> Optional[Span]:
    return getattr(_ctx, "span", None)


def capture_context() -> Optional[Span]:
    """The active span — the token a thread handoff carries so work on the
    other thread parents correctly AND feeds the span's retry accounting
    (:func:`note_retry` on a transfer thread must mark the owning span).
    None when no span is open (or tracing is off): attaching None is a
    no-op."""
    return current_span()


@contextlib.contextmanager
def attach_context(token: Optional[Span]):
    """Install a captured span as this thread's span parent for the
    duration (executor pool workers, transfer streams, recovery chains).
    Restores the previous context on exit — pool threads are reused."""
    if token is None:
        yield
        return
    prev = getattr(_ctx, "span", None)
    _ctx.span = token
    try:
        yield
    finally:
        _ctx.span = prev


class _RemoteParent:
    """A wire-adopted parent token: quacks enough like a :class:`Span`
    (trace id, span id, retry counter) for :meth:`Tracer.start` and
    :func:`note_retry` to treat it as the active parent, without being a
    recordable span itself — the real span lives in the origin process."""

    __slots__ = ("trace_id", "span_id", "proc", "retries")

    def __init__(self, trace_id: str, span_id: str, proc: Optional[str]):
        self.trace_id = trace_id
        self.span_id = span_id
        self.proc = proc
        self.retries = 0


_CTX_MAX_ID = 128  # a wire id longer than this is garbage, not a trace


def wire_context() -> Optional[Dict[str, Any]]:
    """The active span as a serializable wire token — trace id, parent
    span id, origin process identity — the thing a frame-protocol request
    carries so the receiving process can parent its spans under the
    caller's. ``None`` when no span is open (or tracing is off): stamping
    ``None`` into a request is the defined old-client shape and adopting
    it is a no-op."""
    sp = current_span()
    if sp is None:
        return None
    ctx: Dict[str, Any] = {"trace_id": sp.trace_id, "span_id": sp.span_id}
    origin = getattr(sp, "proc", None)
    if origin is not None:
        ctx["proc"] = origin
    return ctx


@contextlib.contextmanager
def adopt_context(ctx: Optional[Dict[str, Any]]):
    """Install a :func:`wire_context` token received over the wire as
    this thread's span parent for the duration — the receive-side half of
    the cross-process contract. ``None`` (old client / tracing off at the
    origin) and malformed tokens are tolerated: the block runs untraced-
    parented (its spans become local roots — the orphan-span fallback a
    rolling-restart mix relies on), with garbage counted in
    ``trace.bad_wire_context``."""
    if ctx is None or not tracing_enabled():
        yield
        return
    tid = ctx.get("trace_id") if isinstance(ctx, dict) else None
    sid = ctx.get("span_id") if isinstance(ctx, dict) else None
    if not (isinstance(tid, str) and 0 < len(tid) <= _CTX_MAX_ID
            and isinstance(sid, str) and 0 < len(sid) <= _CTX_MAX_ID):
        metrics.incr("trace.bad_wire_context")
        yield
        return
    proc = ctx.get("proc")
    token = _RemoteParent(tid, sid,
                          str(proc) if isinstance(proc, str) else None)
    prev = getattr(_ctx, "span", None)
    _ctx.span = token
    try:
        yield
    finally:
        _ctx.span = prev


class Tracer:
    """Process-wide finished-span sink: bounded ring + optional JSONL log."""

    def __init__(self):
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=max(16, env_int(
            "ALINK_TRACE_RING", _RING_DEFAULT)))
        self._log_lock = threading.Lock()
        self._log_path: Optional[str] = None
        self._log_file = None
        self._log_bytes = 0
        self._log_rotated = False

    # -- span lifecycle ------------------------------------------------------
    def start(self, name: str, **attrs) -> Span:
        parent = current_span()
        if parent is None:
            trace_id = uuid.uuid4().hex[:16]
            parent_id = None
        else:
            trace_id = parent.trace_id
            parent_id = parent.span_id
        span_id = f"{_SPAN_PREFIX}-{next(_span_ids):x}"
        return Span(trace_id, span_id, parent_id, name,
                    {k: v for k, v in attrs.items() if v is not None})

    def finish(self, span: Span) -> None:
        span.wall_s = time.perf_counter() - span.start_perf
        if span.outcome is None:
            span.outcome = "retried" if span.retries else "ok"
        metrics.incr("trace.spans")
        metrics.observe("trace.span_s", span.wall_s)
        d = span.to_dict()
        with self._lock:
            self._ring.append(d)
        self._log(span)

    @staticmethod
    def _max_log_bytes() -> int:
        """``ALINK_TRACE_LOG_MAX_MB`` caps the JSONL event log. 0 / unset =
        unbounded (the pre-cap behavior)."""
        mb = env_float("ALINK_TRACE_LOG_MAX_MB", 0.0) or 0.0
        return int(mb * 1024 * 1024) if mb > 0 else 0

    def _log(self, span: Span) -> None:
        path = env_str("ALINK_TRACE_LOG")
        if not path:
            return
        rec = span.to_dict()
        rec.pop("start_perf", None)  # process-local; meaningless in a file
        line = json.dumps(rec, default=str) + "\n"
        nbytes = len(line.encode("utf-8"))
        try:
            with self._log_lock:
                if self._log_file is None or self._log_path != path:
                    if self._log_file is not None:
                        self._log_file.close()
                    self._log_file = open(path, "a")
                    self._log_path = path
                    self._log_rotated = False
                    try:
                        self._log_bytes = os.path.getsize(path)
                    except OSError:
                        self._log_bytes = 0
                cap = self._max_log_bytes()
                if cap and self._log_bytes + nbytes > cap:
                    # rotate ONCE per path: keep a .1 of the filled log and
                    # start fresh; when the fresh file fills too, drop (and
                    # count) further events — a long-lived serving process
                    # must never grow the log without bound
                    if self._log_rotated:
                        metrics.incr("trace.log_dropped")
                        return
                    self._log_file.close()
                    os.replace(path, path + ".1")
                    self._log_file = open(path, "w")
                    self._log_bytes = 0
                    self._log_rotated = True
                    metrics.incr("trace.log_rotated")
                self._log_file.write(line)
                self._log_file.flush()
                self._log_bytes += nbytes
        except OSError:
            metrics.incr("trace.log_errors")

    # -- readouts ------------------------------------------------------------
    def spans(self, trace_id: Optional[str] = None) -> List[Dict[str, Any]]:
        """Finished spans (dicts), oldest first; filtered to one trace when
        ``trace_id`` is given."""
        with self._lock:
            out = list(self._ring)
        if trace_id is not None:
            out = [s for s in out if s["trace_id"] == trace_id]
        return out

    def last_trace_id(self) -> Optional[str]:
        """Trace id of the most recently finished ROOT span (a root is a
        span with no parent — one per job run)."""
        with self._lock:
            for s in reversed(self._ring):
                if s["parent_id"] is None:
                    return s["trace_id"]
        return None

    def traces(self, limit: int = 50) -> List[Dict[str, Any]]:
        """Most-recent-first summaries of the traces still in the ring:
        trace id, root span name, wall, span count, worst outcome."""
        with self._lock:
            spans = list(self._ring)
        by_trace: Dict[str, List[Dict[str, Any]]] = {}
        order: List[str] = []
        for s in spans:
            if s["trace_id"] not in by_trace:
                order.append(s["trace_id"])
            by_trace.setdefault(s["trace_id"], []).append(s)
        out = []
        for tid in reversed(order):
            ss = by_trace[tid]
            root = next((s for s in ss if s["parent_id"] is None), None)
            bad = next((s["outcome"] for s in ss
                        if s["outcome"] == "failed"), None)
            out.append({
                "trace_id": tid,
                "root": root["name"] if root else ss[0]["name"],
                "t_start": (root or ss[0])["t_start"],
                "wall_s": (root or ss[0])["wall_s"],
                "spans": len(ss),
                "outcome": bad or (root["outcome"] if root else "ok"),
            })
            if len(out) >= limit:
                break
        return out

    def clear(self) -> None:
        with self._lock:
            self._ring = deque(maxlen=max(16, env_int(
                "ALINK_TRACE_RING", _RING_DEFAULT)))
        with self._log_lock:
            if self._log_file is not None:
                self._log_file.close()
                self._log_file = None
                self._log_path = None
            self._log_bytes = 0
            self._log_rotated = False


tracer = Tracer()


@contextlib.contextmanager
def trace_span(name: str, **attrs):
    """Open a span around a block::

        with trace_span("kmeans.fit", rows=n) as sp:
            ...

    Yields the open :class:`Span` (set ``sp.outcome``/``sp.phases``/
    ``sp.attrs`` freely) or ``None`` when tracing is off — callers must
    guard attribute access with ``if sp is not None``. An exception marks
    the span ``failed`` (error type + message recorded) and propagates
    unchanged. Spans opened on the same thread nest automatically; use
    :func:`capture_context`/:func:`attach_context` across threads."""
    if not tracing_enabled():
        yield None
        return
    span = tracer.start(name, **attrs)
    prev = getattr(_ctx, "span", None)
    _ctx.span = span
    try:
        yield span
    except BaseException as e:
        span.outcome = "failed"
        span.error = f"{type(e).__name__}: {e}"[:200]
        raise
    finally:
        _ctx.span = prev
        tracer.finish(span)


def note_retry() -> None:
    """Called by the resilience layer on every retry sleep: bumps the
    active span's retry count so the span's outcome reads ``retried`` even
    though the call ultimately succeeded. No-op outside a span."""
    sp = current_span()
    if sp is not None:
        sp.retries += 1


# ---------------------------------------------------------------------------
# Job report
# ---------------------------------------------------------------------------


def _span_tree(spans: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    by_id = {s["span_id"]: dict(s, children=[]) for s in spans}
    roots: List[Dict[str, Any]] = []
    for s in by_id.values():
        parent = by_id.get(s["parent_id"]) if s["parent_id"] else None
        if parent is not None:
            parent["children"].append(s)
        else:
            roots.append(s)
    # rel time base: perf_counter (sub-µs, immune to clock steps)
    base = min((s["start_perf"] for s in by_id.values()), default=0.0)
    for s in by_id.values():
        s["rel_start_s"] = round(s.pop("start_perf") - base, 6)
    for s in by_id.values():
        s["children"].sort(key=lambda c: c["rel_start_s"])
    roots.sort(key=lambda c: c["rel_start_s"])
    return roots


def _train_block() -> Optional[Dict[str, Any]]:
    """The DL training loop's hot-path readout (None when no train ran
    this process): the ``train.step_s`` / ``train.feed_wait_s`` /
    ``train.accum_flush_s`` histograms plus every ``train.*`` counter —
    the observatory sees the training loop like every other hot path.
    Built from the metrics recorder directly so ``job_report`` never
    imports the dl stack."""
    from .metrics import metrics

    out: Dict[str, Any] = {}
    for name in ("train.step_s", "train.feed_wait_s",
                 "train.accum_flush_s"):
        st = metrics.histogram(name)
        if st is not None:
            out[name.split(".", 1)[1]] = st
    counters = metrics.counters("train.")
    if counters:
        out["counters"] = counters
    return out or None


def job_report(trace_id: Optional[str] = None) -> Dict[str, Any]:
    """One dict per job run: the DAG-shaped span tree plus the aggregate
    split an operator wants first.

    ``trace_id=None`` reports the most recently finished root span's trace.
    Returns ``{"error": ...}`` when the trace is unknown (or tracing was
    off), never raises — this feeds an HTTP endpoint."""
    if trace_id is None:
        trace_id = tracer.last_trace_id()
        if trace_id is None:
            return {"error": "no traces recorded "
                             "(is ALINK_TRACING off?)"}
    spans = tracer.spans(trace_id)
    if not spans:
        return {"error": f"unknown trace {trace_id!r}"}
    totals: Dict[str, float] = {}
    outcomes: Dict[str, int] = {}
    retries = 0
    for s in spans:
        outcomes[s["outcome"]] = outcomes.get(s["outcome"], 0) + 1
        retries += s.get("retries", 0)
        for k, v in (s.get("phases") or {}).items():
            if k.endswith("_s") and isinstance(v, (int, float)):
                totals[k] = round(totals.get(k, 0.0) + v, 6)
    tree = _span_tree(spans)
    root = tree[0] if tree else None
    caches: Dict[str, Any] = {}
    try:
        from .jitcache import signature_summary

        sig = signature_summary()
        caches["programs"] = {"hit_rate": sig["hit_rate"],
                              "cached": sig["signatures"]}
    except Exception:
        pass
    try:
        from .staging import staging_cache_stats

        st = staging_cache_stats()
        hits, misses = st.get("hits", 0), st.get("misses", 0)
        caches["staging"] = {
            "hit_rate": round(hits / (hits + misses), 4)
            if hits + misses else None,
            "wire_bytes_sent": st.get("wire_bytes_sent"),
        }
    except Exception:
        pass
    # no per-kernel cost table in the port yet (the reference's
    # common/profiling.py, ROADMAP A10): the block stays, empty
    profile: Dict[str, Any] = {}
    try:
        # last pre-flight report (None when the validator never ran —
        # ALINK_VALIDATE_PLAN=off)
        from ..analysis import last_plan_report

        analysis: Optional[Dict[str, Any]] = last_plan_report()
    except Exception:
        analysis = None
    return {
        "trace_id": trace_id,
        "profile": profile,
        "train": _train_block(),
        "analysis": analysis,
        "root": None if root is None else
        {"name": root["name"], "wall_s": root["wall_s"],
         "outcome": root["outcome"]},
        "spans": [{k: v for k, v in s.items() if k != "start_perf"}
                  for s in spans],
        "tree": tree,
        "totals": totals,
        "retries": retries,
        "outcomes": outcomes,
        "caches": caches,
    }


def chrome_trace(trace_id: Optional[str] = None) -> Dict[str, Any]:
    """The span ring as a chrome://tracing / Perfetto JSON object (trace
    event format). ``trace_id=None`` exports every finished span in the
    ring — one waterfall across jobs; pass an id to cut one job out.

    Each span becomes one complete ("X") event with its phases, attrs,
    outcome, and span/parent ids under ``args``; threads map to stable
    integer tids with thread_name metadata so the waterfall groups by the
    thread that ran the work (the serving batchers, the callers). Load
    the file via ui.perfetto.dev or chrome://tracing."""
    spans = tracer.spans(trace_id)
    events: List[Dict[str, Any]] = [{
        "ph": "M", "pid": 1, "tid": 0, "name": "process_name",
        "args": {"name": "alink_tpu_torch"},
    }]
    tids: Dict[str, int] = {}
    for s in spans:
        thread = s.get("thread") or "?"
        tid = tids.get(thread)
        if tid is None:
            tids[thread] = tid = len(tids) + 1
            events.append({"ph": "M", "pid": 1, "tid": tid,
                           "name": "thread_name",
                           "args": {"name": thread}})
        args: Dict[str, Any] = {
            "trace_id": s["trace_id"], "span_id": s["span_id"],
            "parent_id": s.get("parent_id"), "outcome": s.get("outcome"),
        }
        for key in ("phases", "attrs", "retries", "error"):
            if s.get(key):
                args[key] = s[key]
        events.append({
            "ph": "X", "pid": 1, "tid": tid,
            "name": s["name"],
            "cat": s.get("outcome") or "ok",
            "ts": round(s["t_start"] * 1e6, 3),
            "dur": round(max(s.get("wall_s") or 0.0, 0.0) * 1e6, 3),
            "args": args,
        })
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def write_chrome_trace(path: str, trace_id: Optional[str] = None) -> int:
    """Write :func:`chrome_trace` to ``path``; returns the span count."""
    blob = chrome_trace(trace_id)
    with open(path, "w", encoding="utf-8") as f:
        json.dump(blob, f)
        f.write("\n")
    # metadata events (process + one per thread) don't count as spans
    return sum(1 for e in blob["traceEvents"] if e["ph"] == "X")
