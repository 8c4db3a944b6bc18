"""ModelStreamPublisher — the stream-train → serve loop (port of
``alink_tpu.modelstream.publisher``).

At each epoch barrier of a recovering/elastic stream-training job (every
chain quiescent, operator state exactly the epoch snapshot's), the
publisher asks its bound train op for a servable model
(``op.servable_model()``), wraps it into a ``PipelineModel``, commits it
to a :class:`~alink_tpu_torch.modelstream.store.ModelStreamStore` (blob →
warmup sidecar → manifest, the manifest rename being the atomic point),
and hot-swaps the committed version into a live :class:`ModelServer` —
or, when ``server`` is a :class:`~alink_tpu_torch.serving.ServingFleet`,
broadcasts it into every replica (per-replica outcomes counted as
``modelstream.fleet_swap_ok``/``fleet_swap_missed``; a replica that
misses the swap re-syncs from ``store.latest()`` at health-recheck via
the bound model source) — continuously, under traffic, with bounded
staleness
(``ALINK_MODELSTREAM_MIN_EPOCH_S`` rate-limits publishes; ``0`` publishes
every epoch).

Crash-safety contract (drilled via the ``publish`` fault point's
``pre_blob``/``pre_sidecar``/``pre_manifest``/``pre_swap`` sites):

- the store publish runs BEFORE the training snapshot commits, so a crash
  anywhere in it rewinds to the previous epoch snapshot; deterministic
  retraining republishes the same epoch bit-identically over the debris;
- a crash after the manifest rename leaves the version fully durable —
  restart-resume (:meth:`resume`) swaps ``store.latest()`` into the
  server and republishing is idempotent by epoch;
- a consumer can never observe a torn model: the server only ever loads
  blobs whose manifest committed.

Swaps are zero-trace after the first load: a new version of the same
model meets only the batch shapes the first one's warmup ran (pinned by
the ``modelstream.swap_trace_delta`` counter staying 0).

The coordinators that call :meth:`ModelStreamPublisher.publish_epoch` and
:meth:`~ModelStreamPublisher.swap_epoch` at their epoch barriers
(``common/recovery.py``'s ``RecoverableStreamJob`` and
``common/elastic.ElasticStreamJob``) wait for ROADMAP A7; until then a
caller drives the two halves itself.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Sequence

from ..common.env import env_float
from ..common.exceptions import AkIllegalArgumentException
from ..common.faults import maybe_fail
from ..common.metrics import metrics
from ..common.tracing import trace_span
from .store import ModelStreamStore

# event→servable staleness: sub-second epochs up to minutes-stale models
_LAG_BUCKETS = (0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
                120.0, 300.0)


class ModelStreamPublisher:
    """Publish the model trained by ``chains[chain][ops][op_index]`` of a
    :class:`RecoverableStreamJob` / :class:`ElasticStreamJob` at every
    epoch barrier, and hot-swap it into ``server`` under ``name``.

    ``input_schema`` is the serving input schema (required when a server
    is attached — it rides the warmup sidecar so replicas warm from
    disk); ``warmup_rows`` optionally overrides the synthesized zero-row
    warmup sample; ``stage_params`` parameterizes the predict stage the
    model table is wrapped into (default ``predictionCol="pred"``).
    """

    def __init__(self, path: str, name: str, *,
                 server=None, chain: int = 0, op_index: int = 0,
                 input_schema=None,
                 warmup_rows: Optional[Sequence[Sequence]] = None,
                 stage_params: Optional[Dict[str, Any]] = None,
                 serving_config=None,
                 keep: Optional[int] = None,
                 min_epoch_s: Optional[float] = None):
        self.store = ModelStreamStore(path, keep=keep)
        self.name = name
        self.server = server
        self.chain = int(chain)
        self.op_index = int(op_index)
        if hasattr(input_schema, "to_str"):
            input_schema = input_schema.to_str()
        if server is not None and input_schema is None:
            raise AkIllegalArgumentException(
                "ModelStreamPublisher needs input_schema when a server is "
                "attached (it rides the warmup sidecar each swap consumes)")
        self.input_schema = input_schema
        self.warmup_rows = [tuple(r) for r in warmup_rows] \
            if warmup_rows else None
        if server is not None and hasattr(server, "bind_model_source"):
            # fleet target: a replica that missed a broadcast swap (or a
            # fresh respawn) re-syncs from the newest committed store
            # version at its next health-recheck
            server.bind_model_source(name, self._latest_blob)
        self.stage_params = dict(stage_params or {"predictionCol": "pred"})
        self.serving_config = serving_config
        self.min_epoch_s = float(min_epoch_s) if min_epoch_s is not None \
            else (env_float("ALINK_MODELSTREAM_MIN_EPOCH_S", 0.0) or 0.0)
        self._last_pub_t: Optional[float] = None
        self._swapped_epoch: Optional[int] = None
        self._first_swap_done = False
        self._publish_log: List[Dict[str, Any]] = []

    # -- job-build validation ------------------------------------------------
    def validate_target(self, op, *, keyed: bool = False) -> None:
        """Called by the job at build time with the op this publisher is
        bound to. Stamps the op for the ALK109 pre-flight rule and refuses
        shapes the barrier hook cannot serve."""
        if keyed:
            raise AkIllegalArgumentException(
                "ModelStreamPublisher requires a global (non-keyed) train "
                f"chain; chain {self.chain} is keyed — its model state is "
                "split across partitions at the barrier")
        if not hasattr(op, "servable_model"):
            raise AkIllegalArgumentException(
                f"{type(op).__name__} has no servable_model() — it cannot "
                "feed a ModelStreamPublisher")
        op._modelstream_bound = True

    # -- epoch-barrier protocol (driven by the coordinators) -----------------
    def publish_epoch(self, op, epoch: int, *, final: bool = False
                      ) -> Optional[str]:
        """Store-side publish for ``epoch`` — blob, sidecar, manifest, in
        that order, each behind its ``publish`` fault site. Runs BEFORE
        the epoch's training snapshot commits (chains parked), so any
        crash here rewinds training to the previous snapshot and the
        deterministic retrain republishes bit-identically. Returns the
        committed blob path, or None when skipped (throttled / model not
        ready yet)."""
        now = time.perf_counter()
        if self.min_epoch_s > 0 and not final \
                and self._last_pub_t is not None \
                and (now - self._last_pub_t) < self.min_epoch_s:
            metrics.incr("modelstream.throttled")
            return None
        model = op.servable_model()
        if model is None:
            metrics.incr("modelstream.unready")
            return None
        with trace_span("modelstream.publish", epoch=epoch,
                        model=self.name):
            fresh = not self.store.committed(epoch)
            pm = self._wrap(model)
            blob = self.store.publish(
                epoch, pm.save,
                write_sidecar=self._write_sidecar
                if self.input_schema is not None else None,
                meta={"model": self.name, "final": bool(final)})
        if fresh:
            metrics.incr("modelstream.publishes")
            self._publish_log.append({"epoch": int(epoch),
                                      "final": bool(final)})
        self._last_pub_t = time.perf_counter()
        return blob

    def swap_epoch(self, epoch: int, epoch_t0: Optional[float] = None
                   ) -> bool:
        """Serve-side swap, run AFTER the epoch's snapshot manifest
        committed. No-op when ``epoch`` was never committed to the store
        (throttled or unready at publish time)."""
        if not self.store.committed(epoch):
            return False
        maybe_fail("publish", label=f"epoch{epoch}.pre_swap")
        self._swap(epoch)
        if epoch_t0 is not None:
            metrics.observe("modelstream.lag_s",
                            time.perf_counter() - epoch_t0,
                            buckets=_LAG_BUCKETS)
        return True

    def resume(self) -> Optional[int]:
        """Heal after a restart: swap the newest committed version into
        the server (covers a crash at ``pre_swap`` — version durable, swap
        never ran — including on the job's final epoch). Idempotent."""
        latest = self.store.latest()
        if latest is None:
            return None
        epoch, _ = latest
        if self._swapped_epoch is None or self._swapped_epoch < epoch \
                or not self._server_has_model():
            self._swap(epoch)
            metrics.incr("modelstream.resumes")
        return epoch

    # -- internals -----------------------------------------------------------
    def _latest_blob(self) -> Optional[str]:
        latest = self.store.latest()
        return self.store.blob_path(latest[0]) if latest else None

    def _server_has_model(self) -> bool:
        if self.server is None:
            return True
        if hasattr(self.server, "has_model"):
            return bool(self.server.has_model(self.name))
        return self.name in getattr(self.server, "_entries", {})

    def _wrap(self, model_table):
        """Wrap a raw model table into the PipelineModel its ``modelName``
        names — the exact artifact ``PipelineModel.load``/``LocalPredictor``
        consume, so served-vs-local parity is definitional."""
        from ..common.model import table_to_model
        from ..pipeline.estimators import FmModel, LinearModel
        from ..pipeline.pipeline import PipelineModel

        meta, _ = table_to_model(model_table)
        model_name = meta.get("modelName")
        cls = {"LinearModel": LinearModel, "FmModel": FmModel}.get(
            str(model_name))
        if cls is None:
            raise AkIllegalArgumentException(
                f"no servable pipeline stage for modelName={model_name!r}")
        stage = cls(**self.stage_params)
        stage.set_model_data(model_table)
        return PipelineModel(stage)

    def _write_sidecar(self, blob_path: str, sidecar_path: str) -> None:
        from ..common.jitcache import bucket_rows
        from ..common.mtable import TableSchema
        from ..serving.router import (ServingConfig, _schema_zero_rows,
                                      serving_bucket_ladder)
        from ..serving.warmup_store import save_warmup_spec

        rows = self.warmup_rows
        if not rows:
            rows = _schema_zero_rows(
                TableSchema.parse(self.input_schema)) or []
        cfg = self.serving_config or \
            (self.server._config if self.server is not None
             else ServingConfig.default())
        mbr = bucket_rows(cfg.max_batch_rows)
        save_warmup_spec(blob_path,
                         input_schema=self.input_schema,
                         warmup_rows=rows,
                         max_batch_rows=mbr,
                         ladder=serving_bucket_ladder(mbr),
                         synthetic_rows=not bool(self.warmup_rows),
                         path=sidecar_path,
                         fsync=True)

    def _swap(self, epoch: int) -> None:
        self._swapped_epoch = int(epoch)
        if self.server is None:
            return
        blob = self.store.blob_path(epoch)
        before = metrics.counter("jit.trace")
        t0 = time.perf_counter()
        with trace_span("modelstream.swap", epoch=epoch, model=self.name):
            out = self.server.load(self.name, blob, self.input_schema,
                                   config=self.serving_config)
        metrics.add_time("modelstream.swap_s", time.perf_counter() - t0)
        if isinstance(out, dict) and "replicas" in out:
            # fleet-wide broadcast: per-replica outcome accounting; a
            # replica that missed it re-syncs from the bound store source
            for rep_out in out["replicas"].values():
                metrics.incr("modelstream.fleet_swap_ok"
                             if rep_out.get("ok")
                             else "modelstream.fleet_swap_missed")
        delta = metrics.counter("jit.trace") - before
        if self._first_swap_done and delta:
            # traces during a hot-swap mean the ladder keys were NOT
            # shared across versions — the zero-trace contract broke
            metrics.incr("modelstream.swap_trace_delta", delta)
        self._first_swap_done = True

    # -- readout -------------------------------------------------------------
    def summary(self) -> Dict[str, Any]:
        latest = self.store.latest()
        return {
            "model": self.name,
            "store": self.store.path,
            "versions": self.store.versions(),
            "latest_epoch": latest[0] if latest else None,
            "swapped_epoch": self._swapped_epoch,
            "published": list(self._publish_log),
        }


def modelstream_summary() -> Dict[str, Any]:
    """One-call readout of the publish loop's counters/latencies (the
    ``recovery_summary()``/``serving_summary()`` convention)."""
    out: Dict[str, Any] = {"counters": metrics.counters("modelstream.")}
    lag = metrics.histogram("modelstream.lag_s")
    if lag:
        out["lag_s"] = lag
    swap = metrics.timer_stats("modelstream.swap_s")
    if swap:
        out["swap_s"] = swap
    return out
