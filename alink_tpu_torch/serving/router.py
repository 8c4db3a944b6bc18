"""Concurrent request router + dynamic micro-batcher over LocalPredictor
(port of ``alink_tpu.serving.router``). Each replica of a
:class:`~alink_tpu_torch.serving.fleet.ServingFleet` runs one
:class:`ModelServer`.

One :class:`ModelServer` owns N loaded models. Each model gets:

- a **bounded two-lane queue** (normal + priority) with admission control:
  past the high-water mark new requests are shed with
  :class:`~alink_tpu_torch.common.exceptions.AkServingOverloadException`
  (``shed_policy="reject"``) or the oldest queued normal-lane request is
  dropped to admit the new one (``shed_policy="oldest"``);
- a **batcher thread** that coalesces waiting requests into micro-batches of
  up to ``max_batch_rows`` rows (snapped onto the ``bucket_rows`` ladder, so
  full batches ship with zero padding), flushing a partial batch once the
  oldest queued request has waited ``flush_deadline_s``. Ragged batches pad
  up the ladder inside the row-wise computations — after
  :meth:`ModelServer.load` warmup, sustained mixed-size load meets **no new
  batch shape** (``jit.trace``, ``common/jitcache.py``, does not move);
- a **circuit breaker** (shared ``serving:<model>`` endpoint registry entry):
  consecutive batch failures open it and queued requests degrade to fast
  :class:`~alink_tpu_torch.common.exceptions.AkCircuitOpenException`
  rejects until the reset timeout half-opens it for a probe batch;
- **per-request deadlines**: a request whose deadline expires while queued
  completes with :class:`AkDeadlineExceededException` instead of occupying
  batch rows.

The batcher runs the predictor on the device its operators run on (the
session's, cuda unless the caller asked for the CPU); it never picks one
itself. A batch that fails — a CUDA error included — fails its requests'
futures with that error and feeds the breaker; nothing is swallowed.

Instrumentation (all exported at ``GET /metrics``): ``serving.request`` /
``serving.batch`` spans, ``serving.queue_s`` / ``serving.request_s`` /
``serving.batch_rows`` histograms (p50/p90/p99), and ``serving.*`` counters
(accepted / shed / completed / errors / deadline_expired / breaker_rejected).

Results equal serial ``LocalPredictor`` predicts: batching only changes the
leading dimension of row-wise computations, each padded up the bucket
ladder. A serial predict runs at the smallest rung (8 rows); a batched row
may run at a larger one, where a library GEMM on the card may choose
another reduction split than at 8 rows (ROADMAP "Differences by design").
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque
from dataclasses import dataclass, replace
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ..common.env import env_flag, env_float, env_int, env_str
from ..common.exceptions import (
    AkCircuitOpenException,
    AkDeadlineExceededException,
    AkIllegalArgumentException,
    AkIllegalStateException,
    AkServingOverloadException,
)
from ..common.jitcache import bucket_rows, seen_warmup_specs
from ..common.metrics import metrics
from ..common.mtable import MTable, TableSchema
from ..common.resilience import CircuitBreaker
from ..common.tracing import attach_context, capture_context, trace_span
from ..pipeline.local_predictor import LocalPredictor
from ..pipeline.pipeline import PipelineModel
from .warmup_store import load_warmup_spec, save_warmup_spec

logger = logging.getLogger("alink_tpu_torch.serving")

_ROW_BUCKETS = (1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0, 256.0,
                512.0, 1024.0, 2048.0, 4096.0)


def _schema_zero_rows(schema: TableSchema) -> Optional[List[tuple]]:
    """One zero/empty sample row derived from a primitive-typed input
    schema (the default AOT-warmup input when the caller provides none).
    Returns None when any column type cannot be synthesized — vector/
    tensor/mtable inputs need real sample rows."""
    from ..common.mtable import AlinkTypes

    row = []
    for tp in schema.types:
        if AlinkTypes.is_numeric(tp):  # numeric incl. BOOLEAN
            row.append(0)
        elif tp == AlinkTypes.STRING:
            row.append("")
        else:
            return None
    return [tuple(row)]


def serving_bucket_ladder(max_rows: int) -> List[int]:
    """Every bucket rung a batch of 1..max_rows can pad to — the shape set
    :meth:`ModelServer.load` warms so no production batch size is new."""
    rungs = sorted({bucket_rows(n) for n in range(1, max(int(max_rows), 1) + 1)})
    return rungs


@dataclass(frozen=True)
class ServingConfig:
    """Per-model serving knobs (env defaults: ``ALINK_SERVING_*``).

    - ``queue_depth`` — bounded queue high-water mark; requests past it shed.
    - ``max_batch_rows`` — micro-batch row cap; snapped UP onto the
      ``bucket_rows`` ladder at load so full batches ship unpadded.
    - ``flush_deadline_s`` — max time the oldest queued request waits for a
      fuller batch before a partial batch flushes.
    - ``default_timeout_s`` — synchronous ``predict`` wait budget.
    - ``shed_policy`` — ``"reject"`` (shed the arriving request) or
      ``"oldest"`` (drop the oldest queued normal-lane request instead).
    - ``breaker_threshold`` / ``breaker_reset_s`` — consecutive batch
      failures that open the model's circuit, and the half-open probe delay.
    - ``precision`` — inference precision policy (``"fp32"`` | ``"bf16"`` |
      ``"int8"``). Opt-in and never silent: ``"fp32"`` (the default) leaves
      every scoring path byte-identical to an unquantized server; ``"int8"``
      requires a real calibration sample and passes an accuracy-band gate
      or the load falls back to fp32 with a counted reason.
    - ``quant_band`` / ``quant_tol`` — the accuracy band a quantized load
      must stay inside versus its fp32 baseline: label-like output columns
      may disagree on at most ``quant_band`` of the gate rows, numeric
      output columns may deviate relatively by at most ``quant_tol``.
    """

    queue_depth: int = 256
    max_batch_rows: int = 64
    flush_deadline_s: float = 0.005
    default_timeout_s: float = 30.0
    shed_policy: str = "reject"
    breaker_threshold: int = 5
    breaker_reset_s: float = 30.0
    precision: str = "fp32"
    quant_band: float = 0.005
    quant_tol: float = 0.05

    @classmethod
    def default(cls) -> "ServingConfig":
        shed = (env_str("ALINK_SERVING_SHED_POLICY", "reject")
                or "reject").lower()
        return cls(
            queue_depth=max(1, env_int("ALINK_SERVING_QUEUE_DEPTH", 256)),
            max_batch_rows=max(1, env_int("ALINK_SERVING_MAX_BATCH_ROWS", 64)),
            flush_deadline_s=env_float("ALINK_SERVING_FLUSH_DEADLINE_S",
                                       0.005),
            default_timeout_s=env_float("ALINK_SERVING_TIMEOUT_S", 30.0),
            shed_policy=shed if shed in ("reject", "oldest") else "reject",
            breaker_threshold=max(
                1, env_int("ALINK_SERVING_BREAKER_THRESHOLD", 5)),
            breaker_reset_s=env_float("ALINK_SERVING_BREAKER_RESET_S", 30.0),
            precision=(env_str("ALINK_SERVING_PRECISION", "fp32")
                       or "fp32").lower(),
            quant_band=env_float("ALINK_SERVING_QUANT_BAND", 0.005),
            quant_tol=env_float("ALINK_SERVING_QUANT_TOL", 0.05),
        )


class PredictFuture:
    """Completion handle for one submitted request. ``result(timeout)``
    blocks for the row tuple or raises the request's failure; ``done()`` is
    a non-blocking poll. ``batch_rows`` is the row count of the batch the
    request was served in (None until then): its rung,
    ``bucket_rows(batch_rows)``, is the batch shape its row ran at."""

    __slots__ = ("_event", "_row", "_error", "enqueued_at", "deadline",
                 "priority", "batch_rows")

    def __init__(self, deadline: Optional[float], priority: bool):
        self._event = threading.Event()
        self._row: Optional[Tuple] = None
        self._error: Optional[BaseException] = None
        self.enqueued_at = time.perf_counter()
        self.deadline = deadline          # absolute monotonic, or None
        self.priority = priority
        self.batch_rows: Optional[int] = None

    def _complete(self, row: Optional[Tuple], error: Optional[BaseException]):
        self._row = row
        self._error = error
        self._event.set()

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None) -> Tuple:
        if not self._event.wait(timeout):
            raise AkDeadlineExceededException(
                f"predict result not ready within {timeout}s")
        if self._error is not None:
            raise self._error
        return self._row


class _Request:
    __slots__ = ("row", "future", "ctx")

    def __init__(self, row: Sequence, future: PredictFuture):
        self.row = tuple(row)
        self.future = future
        # the submitter's open span (None with tracing off): the batcher
        # thread re-attaches it so the coalesced ``serving.batch`` span
        # lands in the same trace as the request that triggered it
        self.ctx = capture_context()


class _ModelEntry:
    """One loaded model: predictor + two-lane bounded queue + batcher."""

    def __init__(self, name: str, predictor: LocalPredictor,
                 config: ServingConfig, precision: str = "fp32"):
        self.name = name
        self.predictor = predictor
        self.precision = precision  # the EFFECTIVE policy after gating
        # snap the batch cap onto the ladder: full batches ship unpadded
        self.config = replace(config,
                              max_batch_rows=bucket_rows(config.max_batch_rows))
        # a FRESH registry breaker per load: a hot-swapped model must not
        # inherit (or keep feeding, while the old entry drains) the retired
        # entry's failure history, and reload config takes effect
        self.breaker = CircuitBreaker.replace_endpoint(
            f"serving:{name}", failure_threshold=config.breaker_threshold,
            reset_timeout=config.breaker_reset_s)
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._high: deque = deque()
        self._normal: deque = deque()
        self._draining = False
        # stats (under _lock)
        self.accepted = 0
        self.shed = 0
        self.completed = 0
        self.errors = 0
        self.bad_rows = 0
        self.expired = 0
        self.breaker_rejected = 0
        self.batches = 0
        self.rows_total = 0
        self.loaded_at = time.time()
        self._thread = threading.Thread(
            target=self._batcher, name=f"alink-serving-{name}", daemon=True)
        self._thread.start()

    # -- admission -----------------------------------------------------------
    def submit(self, row: Sequence, *, priority: bool = False,
               deadline_s: Optional[float] = None) -> PredictFuture:
        deadline = (time.perf_counter() + deadline_s
                    if deadline_s is not None else None)
        fut = PredictFuture(deadline, priority)
        req = _Request(row, fut)
        shed_req: Optional[_Request] = None
        with self._cond:
            if self._draining:
                raise AkIllegalStateException(
                    f"model {self.name!r} is unloaded")
            depth = len(self._high) + len(self._normal)
            if depth >= self.config.queue_depth:
                if self.config.shed_policy == "oldest" and self._normal:
                    shed_req = self._normal.popleft()
                else:
                    self.shed += 1
                    metrics.incr("serving.shed")
                    raise AkServingOverloadException(
                        f"model {self.name!r} queue full "
                        f"({depth}/{self.config.queue_depth}); shed")
                self.shed += 1
                metrics.incr("serving.shed")
            (self._high if priority else self._normal).append(req)
            self.accepted += 1
            metrics.incr("serving.accepted")
            self._cond.notify()
        if shed_req is not None:
            shed_req.future._complete(None, AkServingOverloadException(
                f"model {self.name!r} queue full; dropped for a newer "
                f"request (shed_policy=oldest)"))
        return fut

    def queue_depth(self) -> int:
        with self._lock:
            return len(self._high) + len(self._normal)

    # -- batching ------------------------------------------------------------
    def _oldest_enqueued(self) -> Optional[float]:
        heads = [q[0].future.enqueued_at for q in (self._high, self._normal)
                 if q]
        return min(heads) if heads else None

    def _pop_batch_locked(self) -> List[_Request]:
        batch: List[_Request] = []
        cap = self.config.max_batch_rows
        while len(batch) < cap and (self._high or self._normal):
            q = self._high if self._high else self._normal
            batch.append(q.popleft())
        return batch

    def _batcher(self) -> None:
        while True:
            with self._cond:
                while not (self._high or self._normal):
                    if self._draining:
                        return
                    self._cond.wait(0.1)
                # let the batch fill until the oldest waiter's flush deadline
                flush_at = (self._oldest_enqueued()
                            + self.config.flush_deadline_s)
                while (len(self._high) + len(self._normal)
                       < self.config.max_batch_rows):
                    rem = flush_at - time.perf_counter()
                    if rem <= 0 or self._draining:
                        break
                    self._cond.wait(rem)
                batch = self._pop_batch_locked()
                self.batches += 1
            try:
                self._run_batch(batch)
            except BaseException as e:
                # the batcher is the model's ONLY service thread: an escape
                # from any unguarded edge must fail the batch, not kill the
                # thread (which would silently hang all future requests)
                metrics.incr("serving.batcher_errors")
                for req in batch:
                    if not req.future.done():
                        self._finish(req, None, e)

    def _run_batch(self, batch: List[_Request]) -> None:
        now = time.perf_counter()
        live: List[_Request] = []
        for req in batch:
            fut = req.future
            metrics.observe("serving.queue_s", now - fut.enqueued_at)
            if fut.deadline is not None and now > fut.deadline:
                with self._lock:
                    self.expired += 1
                metrics.incr("serving.deadline_expired")
                self._finish(req, None, AkDeadlineExceededException(
                    f"request deadline expired after "
                    f"{now - fut.enqueued_at:.3f}s in queue"))
                continue
            live.append(req)
        if not live:
            return
        try:
            self.breaker.before_call()
        except AkCircuitOpenException as e:
            with self._lock:
                self.breaker_rejected += len(live)
            metrics.incr("serving.breaker_rejected", len(live))
            for req in live:
                self._finish(req, None, e)
            return
        live, t = self._build_batch_table(live)
        if not live:
            self.breaker.release_probe()  # no health verdict this round
            return
        n = len(live)
        metrics.observe("serving.batch_rows", float(n), buckets=_ROW_BUCKETS)
        # parent the batch span under the oldest live request's trace —
        # a coalesced batch belongs to many traces; Dapper convention is
        # to follow the request that opened it
        ctx = next((r.ctx for r in live if r.ctx is not None), None)
        try:
            with attach_context(ctx), \
                    trace_span("serving.batch", model=self.name, rows=n):
                out = self.predictor.predict_table(t)
                if out.num_rows != n:
                    raise AkIllegalStateException(
                        f"model {self.name!r} returned {out.num_rows} rows "
                        f"for a {n}-row batch; serving requires row-wise "
                        f"pipelines (one output row per input row)")
        except BaseException as e:
            # every EXECUTION failure feeds the breaker: a model failing
            # batch after batch is unhealthy regardless of error taxonomy,
            # and degradation to fast rejects is the graceful mode.
            # (Malformed rows were already rejected per-request above and
            # never reach here — one bad client cannot open the circuit.)
            self.breaker.record_failure()
            with self._lock:
                self.errors += n
            metrics.incr("serving.errors", n)
            for req in live:
                self._finish(req, None, e)
            return
        self.breaker.record_success()
        with self._lock:
            self.completed += n
            self.rows_total += n
        metrics.incr("serving.completed", n)
        for i, req in enumerate(live):
            req.future.batch_rows = n
            self._finish(req, out.get_row(i), None)

    def _build_batch_table(self, live: List[_Request]
                           ) -> Tuple[List[_Request], Optional[MTable]]:
        """Coalesce rows into one MTable. Rows that cannot build against the
        input schema are CALLER errors: each is rejected individually (the
        rest of the batch proceeds) and none of them feed the breaker — a
        bad client must not co-fail innocent requests or 503 a healthy
        model."""
        try:
            return live, MTable.from_rows([r.row for r in live],
                                          self.predictor.input_schema)
        except Exception:
            good: List[_Request] = []
            for req in live:
                try:
                    MTable.from_rows([req.row], self.predictor.input_schema)
                    good.append(req)
                except Exception as e:
                    with self._lock:
                        self.bad_rows += 1
                    metrics.incr("serving.bad_rows")
                    self._finish(req, None, AkIllegalArgumentException(
                        f"row does not fit input schema: {e}"))
            if not good:
                return [], None
            return good, MTable.from_rows([r.row for r in good],
                                          self.predictor.input_schema)

    def _finish(self, req: _Request, row: Optional[Tuple],
                error: Optional[BaseException]) -> None:
        metrics.observe("serving.request_s",
                        time.perf_counter() - req.future.enqueued_at)
        req.future._complete(row, error)

    # -- lifecycle -----------------------------------------------------------
    def shutdown(self, drain: bool = True) -> None:
        """Stop admitting; the batcher finishes queued work (``drain=True``)
        or fails it fast, then exits."""
        with self._cond:
            self._draining = True
            if not drain:
                doomed = list(self._high) + list(self._normal)
                self._high.clear()
                self._normal.clear()
            else:
                doomed = []
            self._cond.notify_all()
        for req in doomed:
            req.future._complete(None, AkIllegalStateException(
                f"model {self.name!r} unloaded"))
        self._thread.join(timeout=30.0)

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            d = {
                "model": self.name,
                "queued": len(self._high) + len(self._normal),
                "queue_depth": self.config.queue_depth,
                "max_batch_rows": self.config.max_batch_rows,
                "accepted": self.accepted,
                "completed": self.completed,
                "shed": self.shed,
                "errors": self.errors,
                "bad_rows": self.bad_rows,
                "deadline_expired": self.expired,
                "breaker_rejected": self.breaker_rejected,
                "batches": self.batches,
                "rows": self.rows_total,
                "breaker_open": self.breaker.is_open,
                "loaded_at": self.loaded_at,
                "precision": self.precision,
            }
        d["batch_fill"] = (
            round(d["rows"] / (d["batches"] * d["max_batch_rows"]), 4)
            if d["batches"] else None)
        return d


def _load_predict(predictor, t):
    """A predict the server runs for itself while loading (calibration, the
    accuracy gate, warmup): the load's own pre-flight (ALK111) has run, and
    these plan walks must not replace its report (``collect()`` runs the
    opt-in plan pre-flight)."""
    from ..analysis.plancheck import suppress_preflight

    with suppress_preflight():
        return predictor.predict_table(t)


class ModelServer:
    """The serving front end: load/warmup/evict models, route requests.

    ::

        server = ModelServer()
        server.load("iris", "/models/iris.ak", "f0 double, f1 double, ...",
                    warmup_rows=[[5.1, 3.5, 1.4, 0.2]])
        row = server.predict("iris", [5.1, 3.5, 1.4, 0.2])   # sync
        fut = server.submit("iris", [6.2, 2.9, 4.3, 1.3])    # async
        ...
        fut.result(timeout=1.0)
        server.unload("iris")
    """

    def __init__(self, config: Optional[ServingConfig] = None):
        self._config = config or ServingConfig.default()
        self._lock = threading.Lock()
        self._entries: Dict[str, _ModelEntry] = {}
        # monotone load ticket: concurrent load() calls on the same name
        # must resolve last-writer-wins by CALL order, not by whichever
        # warmup finishes last (a slow stale load must never clobber a
        # newer entry at install time)
        self._load_seq = 0

    # -- model lifecycle -----------------------------------------------------
    def load(self, name: str, model: "PipelineModel | LocalPredictor | str",
             input_schema: "TableSchema | str | None" = None, *,
             config: Optional[ServingConfig] = None,
             warmup_rows: Optional[Sequence[Sequence]] = None,
             persist_warmup: Optional[bool] = None,
             precision: Optional[str] = None,
             recovery: bool = False) -> Dict[str, Any]:
        """Load (or hot-swap) ``name``. ``model`` is a PipelineModel, a saved
        ``.ak`` path, or a ready LocalPredictor. ``warmup_rows`` (sample
        input rows) drives AOT warmup: every bucket rung up to
        ``max_batch_rows`` is predicted once before the model starts taking
        traffic, so steady-state load meets no new batch shape. Hot-swap is
        safe: the old entry keeps serving until the new one (warmup
        included) is ready, then drains and retires.

        Zero cold start: when ``model`` is an ``.ak`` path, a warmup
        sidecar (``<model>.ak.warmup.json``) persisted by a previous
        replica supplies the sample rows — and the ``input_schema``, when
        the caller omits it — so a fresh process warms from disk artifacts
        instead of needing live inputs.
        After a successful live warmup the sidecar is (re)written for the
        next replica (``persist_warmup``, default on, env
        ``ALINK_SERVING_PERSIST_WARMUP``). Predictions are bit-identical
        whichever side warmed — warmup only populates caches.

        ``precision`` opts the load into a quantized serving policy
        (``"int8"`` | ``"bf16"``; unset falls through to
        ``config.precision``, then to the sidecar's proven policy). An
        int8 load calibrates activation ranges over REAL warmup rows
        (synthetic zero rows are refused), then must pass the
        ``quant_band``/``quant_tol`` accuracy gate against its own fp32
        baseline — a failing gate refuses loudly and serves fp32 with a
        counted reason (``serving.precision_fallback``). An explicit
        ``precision="fp32"`` blocks sidecar policy adoption AND rolls the
        sidecar's precision block back on its rewrite (last-writer-wins),
        so later respawns serve fp32 again. ``recovery``
        marks respawn/recovery loads: plan rule ALK111 escalates from
        warning to error severity there."""
        cfg = config or self._config
        with self._lock:
            self._load_seq += 1
            load_seq = self._load_seq
        if persist_warmup is None:
            persist_warmup = env_flag("ALINK_SERVING_PERSIST_WARMUP", True)
        model_path = model if isinstance(model, str) else None
        sidecar = load_warmup_spec(model_path) if model_path else None
        source = "caller" if warmup_rows else None
        if isinstance(model, LocalPredictor):
            predictor = model
        else:
            if input_schema is None and sidecar is not None:
                input_schema = sidecar.get("input_schema")
            if input_schema is None:
                raise AkIllegalArgumentException(
                    "input_schema is required when loading from a "
                    "PipelineModel or path with no warmup sidecar")
            predictor = LocalPredictor(model, input_schema)
        warm = {"rungs": 0, "rows": 0}
        if not warmup_rows and sidecar is not None and \
                sidecar.get("warmup_rows"):
            warmup_rows = sidecar["warmup_rows"]
            source = "sidecar"
        synthesized = False
        if not warmup_rows:
            # the no-new-shapes-after-warmup contract must not silently
            # evaporate when the caller omits sample rows: synthesize a
            # zero/empty row from the input schema (primitive columns only
            # — exotic input types need real sample rows)
            warmup_rows = _schema_zero_rows(predictor.input_schema)
            synthesized = warmup_rows is not None
            source = "synthesized" if synthesized else None
        warmed = False
        kernels_before = {(kid, tuple(sigs))
                          for kid, sigs in seen_warmup_specs()} \
            if model_path and persist_warmup else set()
        # ---- precision policy (before warmup: the ladder must run the
        # QUANTIZED state) ---------------------------------------------------
        prec_requested = precision if precision is not None else (
            cfg.precision if cfg.precision and cfg.precision != "fp32"
            else None)
        adopted = False
        if precision is None and prec_requested is None \
                and sidecar is not None \
                and (sidecar.get("precision") or {}).get("policy"):
            # a respawning replica adopts the policy a previous replica
            # proved out (an explicit precision="fp32" arg blocks this)
            prec_requested = sidecar["precision"]["policy"]
            adopted = True
            metrics.incr("serving.precision_sidecar_adopted")
            logger.info("serving: model %r adopting precision=%s from "
                        "warmup sidecar", name, prec_requested)
        policy, prec_info = self._setup_precision(
            name, predictor, prec_requested, warmup_rows, source, cfg,
            sidecar, recovery=recovery)
        if adopted and prec_info is not None:
            prec_info["adopted_from_sidecar"] = True
        if warmup_rows:
            try:
                warm = self._warmup(predictor, warmup_rows,
                                    bucket_rows(cfg.max_batch_rows))
                warmed = True
            except Exception:
                if source == "caller":
                    raise  # caller-provided rows failing is a load error
                metrics.incr("serving.warmup_errors")
                if source == "sidecar":
                    # bad sidecar rows must not be WORSE than no sidecar:
                    # retry the synthesized-zero-row path before degrading
                    # to lazy warm-on-first-traffic
                    rows = _schema_zero_rows(predictor.input_schema)
                    if rows:
                        try:
                            warm = self._warmup(
                                predictor, rows,
                                bucket_rows(cfg.max_batch_rows))
                            warmed = True
                            warmup_rows = rows
                            source = "synthesized"
                        except Exception:
                            metrics.incr("serving.warmup_errors")
        else:
            metrics.incr("serving.warmup_skipped")
        prec_block = None
        if policy is not None:
            prec_block = {"policy": policy,
                          "calib": (prec_info or {}).get("calib"),
                          "band": {"band": cfg.quant_band,
                                   "tol": cfg.quant_tol}}
        # a sidecar whose precision block no longer matches the effective
        # policy (first quantized load, or a gated-out policy) must be
        # rewritten even for sidecar-sourced warmups — respawns reproduce
        # THIS load's quantized program from the sidecar alone
        precision_stale = sidecar is not None and \
            sidecar.get("precision") != prec_block
        sidecar_written = None
        if warmed and model_path and persist_warmup \
                and (source != "sidecar" or precision_stale):
            # a sidecar-sourced warmup would rewrite byte-identical content
            # — skipping keeps replica loads read-only against the model
            # store (the expected production rollout shape)
            # persist what this load learned so the NEXT replica (a fresh
            # process) warms from disk: the rows, the ladder they warmed,
            # and the kernel shape specs this warmup newly registered
            kernels = [
                (kid, list(sigs)) for kid, sigs in
                ((k, tuple(s)) for k, s in seen_warmup_specs())
                if (kid, sigs) not in kernels_before
            ]
            if sidecar is not None:
                # an already-warm process re-load sees an empty delta —
                # merging keeps the first replica's kernel specs intact
                have = {(k, tuple(s)) for k, s in kernels}
                kernels.extend(
                    (k, list(s)) for k, s in sidecar.get("kernels") or []
                    if (k, tuple(s)) not in have)
            try:
                sidecar_written = save_warmup_spec(
                    model_path,
                    input_schema=predictor.input_schema.to_str(),
                    warmup_rows=warmup_rows,
                    max_batch_rows=bucket_rows(cfg.max_batch_rows),
                    ladder=serving_bucket_ladder(
                        bucket_rows(cfg.max_batch_rows)),
                    kernels=kernels,
                    precision=prec_block,
                    # preserve the marker across precision-block rewrites
                    # of a synthetic-rows sidecar
                    synthetic_rows=(source == "synthesized"
                                    or (source == "sidecar"
                                        and bool((sidecar or {})
                                                 .get("synthetic_rows")))))
            except OSError:
                # read-only model store: the replica still serves, the
                # next one just warms live again (counted apart from
                # corruption so a healthy read-only fleet stays
                # distinguishable on dashboards)
                metrics.incr("serving.warmup_spec_write_errors")
        entry = _ModelEntry(name, predictor, cfg,
                            precision=policy or "fp32")
        entry._load_seq = load_seq
        stale = old = None
        with self._lock:
            cur = self._entries.get(name)
            if cur is not None and getattr(cur, "_load_seq", 0) > load_seq:
                # a load that STARTED after this one has already installed:
                # swapping now would move the served weights backwards.
                # Last-writer-wins is by load-call order, so this entry
                # loses the race and retires unused.
                stale = entry
            else:
                old = cur
                self._entries[name] = entry
        if stale is not None:
            stale.shutdown(drain=True)
            metrics.incr("serving.load_superseded")
            return {"model": name, "warmup": warm,
                    "warmup_source": source if warmed else None,
                    "warmup_sidecar": sidecar_written,
                    "superseded": True,
                    "precision": prec_info or {"policy": "fp32"},
                    "max_batch_rows": entry.config.max_batch_rows}
        if old is not None:
            old.shutdown(drain=True)
        metrics.incr("serving.models_loaded")
        return {"model": name, "warmup": warm,
                "warmup_source": source if warmed else None,
                "warmup_sidecar": sidecar_written,
                "precision": prec_info or {"policy": "fp32"},
                "max_batch_rows": entry.config.max_batch_rows}

    @staticmethod
    def _strip_precision(predictor: LocalPredictor) -> None:
        """Remove stamped precision/calibration params from the cached plan
        — the fp32-fallback path must serve EXACTLY today's unquantized
        numerics (the site prefixes stay: they are inert metadata)."""
        from ..common import quant

        plan = getattr(predictor, "_plan", None)
        if not plan:
            return
        for op in plan[2]:
            p = op.get_params()
            for key in (quant.PRECISION_KEY, quant.CALIB_KEY):
                if p.contains(key):
                    p.remove(key)

    def _setup_precision(self, name: str, predictor: LocalPredictor,
                         requested: Optional[str],
                         warmup_rows: Optional[Sequence[Sequence]],
                         source: Optional[str], cfg: ServingConfig,
                         sidecar: Optional[Dict[str, Any]], *,
                         recovery: bool = False
                         ) -> Tuple[Optional[str], Optional[Dict[str, Any]]]:
        """Resolve and apply the quantization policy for one load.

        int8: calibrate per-site activation ranges with an fp32 predict
        over REAL warmup rows (or reuse the sidecar's proven calibration —
        deterministic respawns), stamp ``inferencePrecision``/
        ``quantCalib``/``quantSite`` onto the cached plan's op params, and
        gate the quantized predict against the fp32 baseline inside the
        ``quant_band``/``quant_tol`` accuracy band. Every refusal path is
        loud: a counted reason, a warning log, and a guaranteed-clean fp32
        fallback. Returns ``(effective_policy_or_None, info_or_None)``."""
        from ..common import quant

        policy = quant.resolve_policy(requested)
        if policy is None:
            return None, None
        metrics.incr("serving.precision_loads")
        info: Dict[str, Any] = {"policy": policy,
                                "requested": str(requested)}
        # sidecar rows count as real only when they were SAMPLED, not
        # synthesized schema probes a previous replica persisted
        real_sample = bool(warmup_rows) and (
            source == "caller"
            or (source == "sidecar"
                and not (sidecar or {}).get("synthetic_rows")))
        side_prec = (sidecar or {}).get("precision") or {}
        side_calib = side_prec.get("calib") \
            if side_prec.get("policy") == policy else None

        def _fallback(reason: str, counter: str):
            metrics.incr(counter)
            metrics.incr("serving.precision_fallback")
            self._strip_precision(predictor)
            logger.warning(
                "serving: model %r requested precision=%s but %s — "
                "REFUSING the quantized load and serving fp32",
                name, policy, reason)
            info.update(policy="fp32", fallback=reason)
            return None, info

        # plan rule ALK111: a quantized load with no real calibration
        # sample or a disabled accuracy band serves unproven numerics —
        # warn (error in recovery mode / error validation mode)
        from ..analysis.plancheck import preflight_quantized_load

        preflight_quantized_load(
            name, policy=policy,
            real_sample=real_sample or bool(side_calib),
            band_enabled=cfg.quant_band >= 0.0 and cfg.quant_tol >= 0.0,
            recovery=recovery, where="serving.load")

        if not getattr(predictor, "_cache_plan", False):
            return _fallback(
                "the predictor does not cache its transform plan "
                "(precision policies ride stamped plan params)",
                "serving.precision_plan_uncached")

        with predictor._plan_lock:
            if predictor._plan is None:
                predictor._plan = predictor._build_plan()
            ops = list(predictor._plan[2])
        # deterministic DFS order -> stable per-op calibration sites
        # across replicas and respawns; the model-name prefix keeps
        # concurrent fp32 traffic from other models out of this record
        # (capture is process-wide, so it cannot be scoped by thread)
        site_prefix = f"{name}:op"
        for i, op in enumerate(ops):
            op.get_params().set(quant.SITE_KEY, f"{site_prefix}{i}")

        calib: Optional[Dict[str, float]] = None
        base_rows = gate_rows = None
        if policy == quant.INT8:
            if side_calib and not quant.degenerate_sites(side_calib):
                # deterministic respawn: reuse the proven calibration and
                # skip the gate the first replica already passed. Sites are
                # model-name-prefixed, so REKEY them onto this load's name
                # (a second serving name over the same .ak adopts the same
                # proven ranges; op order is deterministic DFS, so indices
                # line up) — an unkeyable site falls through to live
                # calibration instead of stamping ranges no site will find
                calib = {}
                for k, v in side_calib.items():
                    cut = str(k).rfind(":op")
                    if cut < 0:
                        calib = None
                        break
                    calib[f"{name}{str(k)[cut:]}"] = float(v)
            if calib:
                metrics.incr("serving.calib_reused_sidecar")
                info["calib_source"] = "sidecar"
            elif not real_sample:
                return _fallback(
                    "its calibration sample is synthetic or absent "
                    "(all-zero rows must never seed activation ranges)",
                    "serving.calib_skipped_synthetic")
            else:
                gate_rows = [tuple(r) for r in warmup_rows]
                t = MTable.from_rows(gate_rows, predictor.input_schema)
                rec: Dict[str, float] = {}
                with quant.calibration(rec):
                    base_out = _load_predict(predictor, t)
                base_rows = [base_out.get_row(i)
                             for i in range(base_out.num_rows)]
                rec = {k: v for k, v in rec.items()
                       if k.startswith(site_prefix)}
                if not rec and not any(
                        getattr(getattr(op, "mapper_cls", None),
                                "INT8_WEIGHT_ONLY", False) for op in ops):
                    # an op whose int8 policy is weight-only reads no
                    # activation range: its load is proven by the band gate
                    return _fallback(
                        "the calibration predict recorded no activation "
                        "ranges (no quantizable op observed its input)",
                        "serving.calib_degenerate")
                bad = quant.degenerate_sites(rec)
                if bad:
                    return _fallback(
                        f"calibration produced degenerate activation "
                        f"ranges at {sorted(bad)} (zero or non-finite)",
                        "serving.calib_degenerate")
                calib = rec
                info["calib_source"] = "live"
            info["calib"] = dict(calib)
        elif real_sample and cfg.quant_band >= 0.0 and cfg.quant_tol >= 0.0:
            # bf16 needs no calibration but still proves its band when a
            # real sample exists
            gate_rows = [tuple(r) for r in warmup_rows]
            t = MTable.from_rows(gate_rows, predictor.input_schema)
            base_out = _load_predict(predictor, t)
            base_rows = [base_out.get_row(i)
                         for i in range(base_out.num_rows)]

        for op in ops:
            p = op.get_params()
            if calib is not None:
                p.set(quant.CALIB_KEY, dict(calib))
            p.set(quant.PRECISION_KEY, policy)

        if base_rows is not None and cfg.quant_band >= 0.0 \
                and cfg.quant_tol >= 0.0:
            t = MTable.from_rows(gate_rows, predictor.input_schema)
            try:
                q_out = _load_predict(predictor, t)
            except Exception as e:
                return _fallback(f"the quantized predict failed: {e}",
                                 "serving.band_gate_failed")
            report = quant.accuracy_band_report(
                base_rows,
                [q_out.get_row(i) for i in range(q_out.num_rows)],
                list(q_out.schema.types),
                band=cfg.quant_band, tol=cfg.quant_tol)
            info["band_report"] = report
            if not report["ok"]:
                return _fallback(
                    f"it failed its accuracy band "
                    f"(agreement={report['agreement']}, "
                    f"max_rel_diff={report['max_rel_diff']}, "
                    f"band={report['band']}, tol={report['tol']})",
                    "serving.band_gate_failed")
        logger.info("serving: model %r serving precision=%s", name, policy)
        return policy, info

    @staticmethod
    def _warmup(predictor: LocalPredictor,
                rows: Sequence[Sequence], max_rows: int) -> Dict[str, int]:
        """Predict once at every ladder rung <= the batch cap (tiling the
        sample rows), so every batch shape the batcher can emit has run
        before traffic: the model is decoded, the quantized state built,
        the allocator's blocks and the library's GEMM choices warm, driven
        through the real predict path."""
        base = [tuple(r) for r in rows]
        total = 0
        rungs = serving_bucket_ladder(max_rows)
        with trace_span("serving.warmup", rungs=len(rungs)):
            for rung in rungs:
                tiled = (base * (rung // len(base) + 1))[:rung]
                _load_predict(predictor,
                              MTable.from_rows(tiled, predictor.input_schema))
                total += rung
        metrics.incr("serving.warmup_rungs", len(rungs))
        return {"rungs": len(rungs), "rows": total}

    def unload(self, name: str, drain: bool = True) -> bool:
        with self._lock:
            entry = self._entries.pop(name, None)
        if entry is None:
            return False
        entry.shutdown(drain=drain)
        metrics.incr("serving.models_unloaded")
        return True

    def close(self) -> None:
        with self._lock:
            entries = list(self._entries.values())
            self._entries.clear()
        for e in entries:
            e.shutdown(drain=True)

    def models(self) -> List[str]:
        with self._lock:
            return sorted(self._entries)

    def _entry(self, name: str) -> _ModelEntry:
        with self._lock:
            entry = self._entries.get(name)
        if entry is None:
            raise AkIllegalArgumentException(f"no model loaded as {name!r}")
        return entry

    # -- request path --------------------------------------------------------
    def submit(self, name: str, row: Sequence, *, priority: bool = False,
               deadline_s: Optional[float] = None) -> PredictFuture:
        """Enqueue one request; returns a :class:`PredictFuture`. Raises
        :class:`AkServingOverloadException` immediately when shed."""
        # hot-swap race: a resolved entry may start draining between the
        # lookup and the submit — re-resolve and route to its replacement
        # instead of surfacing "unloaded" for a model that is still served
        for _ in range(8):
            try:
                return self._entry(name).submit(row, priority=priority,
                                                deadline_s=deadline_s)
            except AkIllegalStateException:
                continue
        return self._entry(name).submit(row, priority=priority,
                                        deadline_s=deadline_s)

    def predict(self, name: str, row: Sequence, *,
                timeout: Optional[float] = None,
                priority: bool = False) -> Tuple:
        """Synchronous predict: submit + wait, traced as one
        ``serving.request`` span."""
        budget = timeout if timeout is not None else \
            self._entry(name).config.default_timeout_s
        with trace_span("serving.request", model=name):
            fut = self.submit(name, row, priority=priority,
                              deadline_s=budget)
            return fut.result(budget)

    def predict_many(self, name: str, rows: Sequence[Sequence], *,
                     timeout: Optional[float] = None,
                     priority: bool = False) -> List[Tuple]:
        """Submit a row set as individual requests (they coalesce in the
        batcher with everyone else's traffic) and wait for all. All-or-
        nothing: if any row sheds, the already-accepted rows are drained
        (their results read and discarded — no orphaned futures occupying
        the queue) before the overload error propagates."""
        budget = timeout if timeout is not None else \
            self._entry(name).config.default_timeout_s
        futs: List[PredictFuture] = []
        try:
            for r in rows:
                futs.append(self.submit(name, r, priority=priority,
                                        deadline_s=budget))
        except AkServingOverloadException:
            for f in futs:
                try:
                    f.result(budget)
                except Exception:
                    pass
            raise
        return [f.result(budget) for f in futs]

    # -- readouts ------------------------------------------------------------
    def stats(self) -> Dict[str, Any]:
        with self._lock:
            entries = list(self._entries.values())
        return {
            "models": [e.stats() for e in entries],
            "histograms": {
                h: metrics.histogram(h)
                for h in ("serving.request_s", "serving.queue_s",
                          "serving.batch_rows")
                if metrics.histogram(h) is not None
            },
            "counters": metrics.counters("serving."),
        }


# ---------------------------------------------------------------------------
# Process-wide default server (the WebUI's serving surface)
# ---------------------------------------------------------------------------

_default_lock = threading.Lock()
_default_server: Optional[ModelServer] = None


def default_server() -> ModelServer:
    """The process-wide :class:`ModelServer` the WebUI endpoints route to."""
    global _default_server
    with _default_lock:
        if _default_server is None:
            _default_server = ModelServer()
        return _default_server


def serving_summary(server: Optional[ModelServer] = None) -> Dict[str, Any]:
    """One-call readout: per-model stats, latency histograms, ``serving.*``
    counters, and the shape-signature counters (``jit.trace``: first-seen
    batch shapes). Reads the given server, defaulting to the process-wide
    one (empty stats if none was ever created). When a
    :class:`~alink_tpu_torch.serving.fleet.ServingFleet` is live in this
    process, its summary joins in as the ``fleet`` block."""
    if server is None:
        server = _default_server
    out = server.stats() if server is not None else \
        {"models": [], "histograms": {}, "counters": metrics.counters("serving.")}
    out["jit"] = {k: v for k, v in metrics.counters("jit.").items()
                  if k in ("jit.trace", "jit.compile")}
    try:
        # lazy import: fleet imports this module; the join must not cycle
        from .fleet import active_fleet_summary

        fleet_block = active_fleet_summary()
    except Exception:
        metrics.incr("serving.summary_fleet_errors")
        fleet_block = None
    if fleet_block is not None:
        out["fleet"] = fleet_block
    return out
