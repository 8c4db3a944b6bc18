"""Fault-tolerant multi-process serving fleet (port of
``alink_tpu.serving.fleet``).

A :class:`ServingFleet` supervises N worker processes, each running a full
:class:`~alink_tpu_torch.serving.router.ModelServer` behind a real loopback
socket, and routes predicts through the failover front-end
(``fleet_frontend.py``). The fleet keeps serving when individual replicas
die:

- **health**: every worker streams heartbeats over a control socket;
  a silent replica goes ``unhealthy`` (unrouted), a hung-but-alive one is
  killed and replaced, per-replica ``fleet:<rid>`` circuit breakers gate
  routing on top of state. Corrupt heartbeat bytes mark the sender
  unhealthy and count ``fleet.bad_heartbeat`` — they never crash the
  supervisor.
- **failover**: a predict accepted by the front-end either returns a
  result or a typed shed error. A replica dying mid-batch surfaces as a
  transport error and the request re-dispatches to a healthy replica
  under a :class:`RetryPolicy`, original deadline still honored.
- **respawn**: a dead replica respawns with the same id and warms from
  the ``.ak.warmup.json`` sidecar — never from live traffic — so the
  zero-trace steady-state contract holds across replica generations
  (plan rule ALK110 refuses fleet loads that would break it).
- **drain**: decommission stops routing, lets the worker finish every
  accepted request (``server.close()`` drains its queues), then exits.
- **hot-swap**: :meth:`ServingFleet.load` broadcasts one committed model
  version into every replica with per-replica outcome counting; a
  replica that misses a swap (dead / unhealthy at broadcast) re-syncs to
  the newest desired version — via a bound model source, e.g. the model
  stream store's ``latest()`` — at health-recheck or respawn.
- **autoscale**: live ``serving.queue_s`` pressure aggregated from
  replica heartbeats feeds a
  :class:`~alink_tpu_torch.common.elastic.BackpressureController` (hysteresis
  + cooldown + flap breaker); decisions spawn or drain replicas between
  ``min_replicas`` and ``max_replicas``.

Chaos drills are deterministic: the ``replica`` fault point
(``common/faults.py``) with kinds ``kill_mid_batch``/``hang``/
``refuse_health`` is tapped inside the worker (labels ``<rid>.g<gen>.batch``
and ``<rid>.g<gen>.heartbeat``), injected per-replica via ``worker_env``.
The generation qualifier lets a drill target one incarnation — a respawned
replica (new gen, fresh fault counters) no longer matches, so the fleet
actually recovers instead of re-killing every respawn.

Knobs (env): ``ALINK_FLEET_REPLICAS``, ``ALINK_FLEET_AUTOSCALE``,
``ALINK_FLEET_MIN_REPLICAS`` / ``ALINK_FLEET_MAX_REPLICAS``,
``ALINK_FLEET_HEARTBEAT_S`` / ``ALINK_FLEET_HEARTBEAT_TIMEOUT_S`` /
``ALINK_FLEET_HANG_GRACE_S``, ``ALINK_FLEET_RESPAWN``,
``ALINK_FLEET_TARGET_QUEUE_S``, ``ALINK_FLEET_WORKER_LOG``.

Observability: ``fleet.replicas{state=…}`` gauges (refreshed at every
``GET /metrics`` export), ``fleet.failovers`` / ``fleet.respawns`` /
``fleet.drains`` / ``fleet.bad_heartbeat`` counters, the front-end's
``fleet.request_s`` histogram, per-replica latency gauges from heartbeat
stats, and a ``fleet`` block joined into ``serving_summary()`` (the
WebUI's ``GET /api/serving``).

This file doubles as the worker entry point: the supervisor spawns
``python -m alink_tpu_torch.serving.fleet`` (``subprocess.Popen``, a fresh
interpreter: a process that has initialised CUDA is never forked) with the
worker's config in the ``ALINK_FLEET_WORKER`` env var (cluster topology
knobs scrubbed — a replica must never try to join a training pod).

Device, with no fallback: each replica is a process with its own CUDA
context and its own copy of the weights; it resolves its device as every
entry point of the port does (``common/env.resolve_device``: the card,
unless ``ALINK_TORCH_DEVICE=cpu``, which reaches the workers through their
env). A worker asked for the card that cannot reach it reports the error
instead of its ready, and the supervisor's start raises; it never serves
on the CPU. On the card the supervisor builds the kernels once before it
spawns anything and hands every replica the library's path
(``native/kernels.py``), so no replica compiles or waits on the build
directory's lock. A replica's kernel launch counters live in its own
process: its heartbeat stats carry them (``launches``, beside ``batches``
and ``gpu_mem``), and :meth:`ServingFleet.fleet_summary` shows them.
"""

from __future__ import annotations

import dataclasses
import json
import os
import secrets
import socket
import subprocess
import sys
import threading
import time
import weakref
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from ..common import faults
from ..common.elastic import BackpressureController
from ..common.env import env_flag, env_float, env_int, env_raw, env_str
from ..common.exceptions import (
    AkIllegalArgumentException,
    AkIllegalStateException,
)
from ..common.metrics import metrics
from ..common.resilience import CircuitBreaker, RetryPolicy
from ..common.telemetry import TelemetrySink, TelemetrySource
from ..common.tracing import (
    adopt_context,
    attach_context,
    capture_context,
    set_process_identity,
    tracer,
    wire_context,
)
from .fleet_frontend import (
    DRAINING,
    FleetFrontend,
    FrontendListener,
    ReplicaClient,
    encode_error,
    recv_frame,
    send_frame,
)
from ..native.kernels import launches as kernel_launches
from .router import ModelServer, ServingConfig

import logging

logger = logging.getLogger("alink_tpu_torch.fleet")

_STATES = ("starting", "ready", "unhealthy", "draining", "dead")


@dataclass(frozen=True)
class FleetConfig:
    """Fleet supervisor knobs (env defaults: ``ALINK_FLEET_*``).

    - ``replicas`` — initial worker-process count.
    - ``autoscale`` / ``min_replicas`` / ``max_replicas`` — enable the
      backpressure-driven autoscaler and its bounds.
    - ``heartbeat_s`` / ``heartbeat_timeout_s`` / ``hang_grace_s`` —
      worker heartbeat period; silence past the timeout marks a replica
      unhealthy; silence past the grace (while the process is alive)
      kills and replaces it.
    - ``respawn`` — bring dead replicas back (same id, fresh breaker,
      sidecar warmup). Off, a death just shrinks the fleet.
    - ``target_queue_s`` — queue-wait the autoscaler holds the fleet to.
    - ``lag_fn`` — external pressure signal override (tests inject a
      scripted backlog schedule here).
    - ``worker_env`` — extra env for workers only (chaos drills inject
      per-replica ``ALINK_FAULT_SPEC`` through this).
    - ``worker_log_dir`` — directory for per-replica stdout/stderr logs
      (default: discarded).
    - ``ready_timeout_s`` — how long a replica may take from spawn to
      ready (process start, imports, CUDA context, model loads and their
      sidecar warmup).
    """

    replicas: int = 2
    autoscale: bool = False
    min_replicas: int = 1
    max_replicas: int = 4
    heartbeat_s: float = 0.5
    heartbeat_timeout_s: float = 2.5
    hang_grace_s: float = 6.0
    respawn: bool = True
    ready_timeout_s: float = 180.0
    drain_timeout_s: float = 30.0
    swap_timeout_s: float = 120.0
    target_queue_s: float = 0.05
    autoscale_interval_s: float = 2.0
    autoscale_patience: int = 2
    autoscale_cooldown: int = 2
    flap_window: int = 16
    max_flips: int = 4
    serving: Optional[ServingConfig] = None
    retry: Optional[RetryPolicy] = None
    lag_fn: Optional[Callable[[Dict[str, Any]], float]] = None
    worker_env: Optional[Dict[str, str]] = None
    worker_log_dir: Optional[str] = None
    bind_host: str = "127.0.0.1"

    @classmethod
    def default(cls) -> "FleetConfig":
        return cls(
            replicas=max(1, env_int("ALINK_FLEET_REPLICAS", 2)),
            autoscale=env_flag("ALINK_FLEET_AUTOSCALE", False),
            min_replicas=max(1, env_int("ALINK_FLEET_MIN_REPLICAS", 1)),
            max_replicas=max(1, env_int("ALINK_FLEET_MAX_REPLICAS", 4)),
            heartbeat_s=env_float("ALINK_FLEET_HEARTBEAT_S", 0.5),
            heartbeat_timeout_s=env_float(
                "ALINK_FLEET_HEARTBEAT_TIMEOUT_S", 2.5),
            hang_grace_s=env_float("ALINK_FLEET_HANG_GRACE_S", 6.0),
            respawn=env_flag("ALINK_FLEET_RESPAWN", True),
            target_queue_s=env_float("ALINK_FLEET_TARGET_QUEUE_S", 0.05),
            worker_log_dir=env_str("ALINK_FLEET_WORKER_LOG", None),
        )


class _Replica:
    """Supervisor-side record of one worker process (one generation —
    a respawn builds a fresh record under the same replica id)."""

    __slots__ = ("rid", "gen", "proc", "log_fh", "state", "client",
                 "data_port", "last_hb", "hb_stats", "ready_info",
                 "ready_trace", "trace_delta", "synced", "spawned_at",
                 "conn", "ready_s", "device", "boot_error")

    def __init__(self, rid: str, gen: int, proc: subprocess.Popen,
                 log_fh=None):
        self.rid = rid
        self.gen = gen
        self.proc = proc
        self.log_fh = log_fh
        self.state = "starting"
        self.client: Optional[ReplicaClient] = None
        self.data_port: Optional[int] = None
        self.last_hb: Optional[float] = None
        self.hb_stats: Dict[str, Any] = {}
        self.ready_info: Any = None
        self.ready_trace = 0
        self.trace_delta: Optional[int] = None
        self.synced: Dict[str, int] = {}
        self.spawned_at = time.monotonic()
        self.conn: Optional[socket.socket] = None
        self.ready_s: Optional[float] = None
        self.device: Optional[str] = None
        # set when the worker reported that it cannot serve at all (its
        # device unreachable): never respawned, start() raises with it
        self.boot_error: Optional[str] = None


def _validate_hb_stats(stats: Any) -> Dict[str, Any]:
    """Shape-check one heartbeat stats payload. Anything that does not
    look like a stats dict raises — the caller counts it as a bad
    heartbeat (a replica streaming garbage is unhealthy by definition)."""
    if not isinstance(stats, dict):
        raise ValueError(f"heartbeat stats is {type(stats).__name__}, "
                         "not a dict")
    for key in ("accepted", "completed", "shed", "queued", "jit_trace"):
        if key in stats:
            float(stats[key])  # raises on garbage
    for hist in ("queue_s", "request_s"):
        h = stats.get(hist)
        if h is not None:
            if not isinstance(h, dict):
                raise ValueError(f"heartbeat {hist} is not a dict")
            float(h.get("count") or 0)
            float(h.get("sum") or 0)
    synced = stats.get("synced")
    if synced is not None and not isinstance(synced, dict):
        raise ValueError("heartbeat synced is not a dict")
    for key, kind in (("launches", int), ("gpu_mem", (int, float))):
        block = stats.get(key)
        if block is None:
            continue
        if not isinstance(block, dict):
            raise ValueError(f"heartbeat {key} is not a dict")
        for name, v in block.items():
            if not isinstance(name, str) or isinstance(v, bool) \
                    or not isinstance(v, kind) or v < 0:
                raise ValueError(f"heartbeat {key} entry {name!r}={v!r} "
                                 "is not a non-negative number")
    return stats


class ServingFleet:
    """Supervisor for N :class:`ModelServer` worker processes with
    failover routing, health-driven respawn, graceful drain, fleet-wide
    hot-swap, and backpressure autoscaling. See the module docstring for
    the full contract.

    ::

        fleet = ServingFleet(FleetConfig(replicas=2)).start()
        fleet.load("iris", "/models/iris.ak")       # broadcast to all
        row = fleet.predict("iris", [5.1, 3.5, 1.4, 0.2])
        fleet.stop()
    """

    def __init__(self, config: Optional[FleetConfig] = None, *,
                 replicas: Optional[int] = None):
        cfg = config or FleetConfig.default()
        if replicas is not None:
            cfg = dataclasses.replace(cfg, replicas=max(1, int(replicas)))
        self._cfg = cfg
        self._config = cfg.serving or ServingConfig.default()
        self._token = secrets.token_hex(16)
        self._lock = threading.RLock()
        self._replicas: Dict[str, _Replica] = {}
        self._desired: Dict[str, Dict[str, Any]] = {}
        self._model_sources: Dict[str, Callable[[], Optional[str]]] = {}
        self._next_idx = 0
        self._gen = 0
        self._swap_seq = 0
        self._started = False
        self._closing = False
        self._control_sock: Optional[socket.socket] = None
        self._control_port: Optional[int] = None
        self._threads: List[threading.Thread] = []
        self._frontend = FleetFrontend(
            self._routable,
            retry=cfg.retry or RetryPolicy(
                max_attempts=max(3, cfg.replicas + 1),
                base_delay=0.01, max_delay=0.25))
        self._controller: Optional[BackpressureController] = None
        if cfg.autoscale:
            self._controller = BackpressureController(
                target_chunk_s=max(cfg.target_queue_s, 1e-6),
                high=1.5, low=0.5,
                patience=cfg.autoscale_patience,
                cooldown_epochs=cfg.autoscale_cooldown,
                scale_factor=2,
                flap_window=cfg.flap_window,
                max_flips=cfg.max_flips,
                lag_fn=cfg.lag_fn or self._queue_lag)
        self._as_epoch = 0
        # start the interval clock now: the first tick lands a full
        # interval after boot, not on the monitor's first pass (a fleet
        # with no traffic yet has no meaningful pressure signal)
        self._last_as_tick = time.time()
        self._prev_queue = (0.0, 0.0)
        # replica metric deltas merge here under a replica label;
        # fleet-wide quantiles come out exact (bucket-count sums)
        self._telemetry = TelemetrySink()

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "ServingFleet":
        """Open the control plane, spawn the initial replicas, and block
        until all of them report ready (models warmed)."""
        if self._started:
            return self
        srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        srv.bind((self._cfg.bind_host, 0))
        srv.listen(64)
        self._control_sock = srv
        self._control_port = srv.getsockname()[1]
        self._started = True
        self._kernels_lib = self._prebuild_kernels()
        acceptor = threading.Thread(target=self._accept_control,
                                    name="alink-fleet-control", daemon=True)
        acceptor.start()
        monitor = threading.Thread(target=self._monitor,
                                   name="alink-fleet-monitor", daemon=True)
        monitor.start()
        self._threads = [acceptor, monitor]
        rids = []
        for _ in range(self._cfg.replicas):
            rids.append(self._next_rid())
        try:
            for rid in rids:
                self._spawn(rid)
            self._wait_ready(rids, self._cfg.ready_timeout_s)
        except BaseException:
            # a fleet that never came up leaves no process or thread behind
            self.stop(drain=False)
            raise
        _register_fleet(self)
        return self

    def __enter__(self) -> "ServingFleet":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def stop(self, *, drain: bool = True) -> None:
        """Decommission every replica (graceful drain by default) and
        shut the control plane down."""
        with self._lock:
            if self._closing:
                return
            self._closing = True
            rids = list(self._replicas)
        _unregister_fleet(self)
        for rid in rids:
            self.decommission(rid, force=not drain)
        if self._control_sock is not None:
            try:
                # shutdown wakes the acceptor blocked in accept(), which a
                # close from this thread alone does not
                self._control_sock.shutdown(socket.SHUT_RDWR)
                self._control_sock.close()
            except OSError:
                metrics.incr("fleet.control_close_errors")
        for t in self._threads:
            t.join(timeout=5.0)

    def _worker_env(self) -> Dict[str, str]:
        from ..parallel.distributed import scrub_cluster_env

        env = scrub_cluster_env(dict(os.environ))
        env.update(self._cfg.worker_env or {})
        return env

    def _prebuild_kernels(self) -> Optional[str]:
        """On the card, build (or find up to date) the kernel library once
        in this process, before any replica starts, and return its path
        for the replicas to load. None when the replicas are asked for
        the CPU, or for a card this process cannot see: they then resolve
        their device themselves, and a replica that cannot reach the card
        fails its start."""
        from ..common.env import DEVICE_ENV
        from ..native import kernels

        want = (self._worker_env().get(DEVICE_ENV) or "cuda").strip()
        if not want.startswith("cuda"):
            return None
        import torch

        if not torch.cuda.is_available():
            return None
        return kernels.build()

    def _next_rid(self) -> str:
        with self._lock:
            rid = f"r{self._next_idx}"
            self._next_idx += 1
            return rid

    # -- spawning ------------------------------------------------------------
    def _spawn(self, rid: str, *, respawn: bool = False) -> _Replica:
        from ..native.kernels import PREBUILT_ENV

        with self._lock:
            self._gen += 1
            gen = self._gen
            models = [
                {"name": n, "path": d["path"], "schema": d["schema"],
                 "config": d["config"], "seq": d["seq"]}
                for n, d in self._desired.items()
            ]
        wcfg = {
            "rid": rid, "gen": gen, "token": self._token,
            "control_host": self._cfg.bind_host,
            "control_port": self._control_port,
            "heartbeat_s": self._cfg.heartbeat_s,
            "serving": dataclasses.asdict(self._cfg.serving)
            if self._cfg.serving else None,
            "models": models,
            # a respawned replica's boot loads are recovery loads: an
            # unproven quantized policy escalates ALK111 to error there
            "recovery": bool(respawn),
        }
        env = self._worker_env()
        env["ALINK_FLEET_WORKER"] = json.dumps(wcfg)
        if self._kernels_lib:
            env[PREBUILT_ENV] = self._kernels_lib
        # the worker must import alink_tpu_torch from wherever THIS process
        # did, independent of the supervisor's cwd
        pkg_root = os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))))
        prev_pp = env.get("PYTHONPATH")
        env["PYTHONPATH"] = pkg_root + (
            os.pathsep + prev_pp if prev_pp else "")
        log_fh = None
        if self._cfg.worker_log_dir:
            os.makedirs(self._cfg.worker_log_dir, exist_ok=True)
            log_fh = open(os.path.join(self._cfg.worker_log_dir,
                                       f"{rid}-g{gen}.log"), "ab")
        proc = subprocess.Popen(
            [sys.executable, "-m", "alink_tpu_torch.serving.fleet"],
            env=env,
            stdin=subprocess.DEVNULL,
            stdout=log_fh if log_fh is not None else subprocess.DEVNULL,
            stderr=subprocess.STDOUT if log_fh is not None
            else subprocess.DEVNULL,
        )
        rep = _Replica(rid, gen, proc, log_fh)
        # a fresh breaker per generation: the respawned process must not
        # inherit the dead one's failure history
        CircuitBreaker.replace_endpoint(
            f"fleet:{rid}", failure_threshold=3,
            reset_timeout=max(1.0, self._cfg.heartbeat_timeout_s))
        with self._lock:
            self._replicas[rid] = rep
        metrics.incr("fleet.spawned")
        return rep

    def _wait_ready(self, rids: Sequence[str], timeout: float) -> None:
        deadline = time.monotonic() + timeout
        states: Dict[str, str] = {}
        while time.monotonic() < deadline:
            with self._lock:
                reps = [self._replicas[rid] for rid in rids
                        if rid in self._replicas]
            states = {rep.rid: rep.state for rep in reps}
            failed = [rep for rep in reps if rep.boot_error]
            if failed:
                raise AkIllegalStateException(
                    "fleet replica(s) cannot serve: " + "; ".join(
                        f"{rep.rid}: {rep.boot_error}" for rep in failed))
            if states and all(s == "ready" for s in states.values()):
                return
            time.sleep(0.05)
        raise AkIllegalStateException(
            f"fleet replicas not ready within {timeout}s: {states}")

    # -- control plane -------------------------------------------------------
    def _accept_control(self) -> None:
        while not self._closing:
            try:
                conn, _ = self._control_sock.accept()
            except OSError:
                return  # listener closed
            threading.Thread(target=self._control_reader, args=(conn,),
                             daemon=True).start()

    def _control_reader(self, conn: socket.socket) -> None:
        """Read newline-delimited JSON from one worker. Any corrupt line
        counts ``fleet.bad_heartbeat`` and marks the sender unhealthy —
        the supervisor thread itself must survive arbitrary garbage."""
        rep: Optional[_Replica] = None
        try:
            reader = conn.makefile("rb")
            for line in reader:
                try:
                    msg = json.loads(line.decode("utf-8"))
                    if not isinstance(msg, dict):
                        raise ValueError("control message is not an object")
                except Exception:
                    metrics.incr("fleet.bad_heartbeat")
                    if rep is None:
                        return  # unauthenticated garbage: drop the conn
                    self._mark_unhealthy(rep, "corrupt heartbeat")
                    continue
                if rep is None:
                    rep = self._bind_hello(conn, msg)
                    if rep is None:
                        return
                    continue
                try:
                    self._handle_msg(rep, msg)
                except Exception:
                    metrics.incr("fleet.bad_heartbeat")
                    self._mark_unhealthy(rep, "malformed stats payload")
        except (OSError, ValueError):
            metrics.incr("fleet.control_disconnects")
        finally:
            conn.close()

    def _bind_hello(self, conn: socket.socket,
                    msg: Dict[str, Any]) -> Optional[_Replica]:
        if msg.get("t") != "hello" or msg.get("token") != self._token:
            metrics.incr("fleet.bad_heartbeat")
            return None
        with self._lock:
            rep = self._replicas.get(msg.get("rid"))
        if rep is None or rep.gen != msg.get("gen"):
            metrics.incr("fleet.stale_hello")
            return None  # a previous generation raced its own respawn
        rep.conn = conn
        return rep

    def _handle_msg(self, rep: _Replica, msg: Dict[str, Any]) -> None:
        t = msg.get("t")
        if t == "ready":
            port = msg.get("data_port")
            if not isinstance(port, int):
                raise ValueError("ready without a data port")
            rep.client = ReplicaClient(rep.rid, self._cfg.bind_host, port)
            rep.data_port = port
            rep.ready_s = time.monotonic() - rep.spawned_at
            rep.device = str(msg.get("device"))
            rep.hb_stats = _validate_hb_stats(msg.get("stats") or {})
            rep.ready_info = msg.get("loads")
            rep.ready_trace = int(msg.get("jit_trace") or 0)
            rep.synced = dict(msg.get("synced") or {})
            rep.trace_delta = 0
            rep.last_hb = time.monotonic()
            self._resync_if_stale(rep)
            with self._lock:
                if rep.state == "starting":
                    rep.state = "ready"
            logger.info("fleet replica %s (gen %d, pid %d) ready",
                        rep.rid, rep.gen, rep.proc.pid)
        elif t == "hb":
            stats = _validate_hb_stats(msg.get("stats"))
            rep.hb_stats = stats
            rep.last_hb = time.monotonic()
            self._ingest_telemetry(rep, msg)
            if "trace_delta" in stats:
                # worker-computed, re-based after every model (re)load so
                # only traces provoked by live traffic count
                rep.trace_delta = int(stats["trace_delta"])
            elif "jit_trace" in stats:
                rep.trace_delta = int(stats["jit_trace"]) - rep.ready_trace
            if isinstance(stats.get("synced"), dict):
                rep.synced = dict(stats["synced"])
            recover = False
            with self._lock:
                if rep.state == "unhealthy":
                    rep.state = "ready"
                    recover = True
            if recover:
                metrics.incr("fleet.recovered")
                self._resync_if_stale(rep)
        elif t == "failed":
            rep.boot_error = str(msg.get("error"))[:2000]
            metrics.incr("fleet.boot_failures")
            logger.error("fleet replica %s cannot serve: %s", rep.rid,
                         rep.boot_error)
        else:
            raise ValueError(f"unknown control message {t!r}")

    def _ingest_telemetry(self, rep: _Replica, msg: Dict[str, Any]) -> None:
        """Merge the heartbeat's piggybacked telemetry delta and finished
        span batch. Garbage is dropped WHOLE and counted loudly
        (``fleet.bad_telemetry``) — never half-merged, never silently
        truncated — and does not poison the heartbeat itself: a replica
        with a telemetry bug is still serving."""
        tele = msg.get("telemetry")
        if tele is not None:
            try:
                self._telemetry.ingest(tele, replica=rep.rid)
            except ValueError as e:
                metrics.incr("fleet.bad_telemetry")
                logger.warning("dropped telemetry from %s: %s", rep.rid, e)
        spans = msg.get("spans")
        if spans is not None:
            try:
                n = tracer.ingest(spans, proc=rep.rid, pid=rep.proc.pid)
                if n:
                    metrics.incr("fleet.spans_ingested", n)
            except ValueError as e:
                metrics.incr("fleet.bad_telemetry")
                logger.warning("dropped span batch from %s: %s",
                               rep.rid, e)

    def _mark_unhealthy(self, rep: _Replica, why: str) -> None:
        with self._lock:
            if rep.state != "ready":
                return
            rep.state = "unhealthy"
        metrics.incr("fleet.unhealthy")
        logger.warning("fleet replica %s marked unhealthy: %s",
                       rep.rid, why)

    # -- health monitor ------------------------------------------------------
    def _monitor(self) -> None:
        cfg = self._cfg
        while not self._closing:
            time.sleep(min(cfg.heartbeat_s, 0.25))
            now = time.monotonic()
            with self._lock:
                reps = list(self._replicas.values())
            for rep in reps:
                if rep.state in ("draining", "dead"):
                    continue
                if rep.proc.poll() is not None:
                    self._on_death(rep)
                    continue
                if rep.last_hb is None:
                    if (rep.state == "starting"
                            and now - rep.spawned_at > cfg.ready_timeout_s):
                        logger.warning("fleet replica %s never became "
                                       "ready; killing it", rep.rid)
                        rep.proc.kill()
                    continue
                silent_s = now - rep.last_hb
                if rep.state == "ready" \
                        and silent_s > cfg.heartbeat_timeout_s:
                    self._mark_unhealthy(
                        rep, f"no heartbeat for {silent_s:.1f}s")
                elif rep.state == "unhealthy" \
                        and silent_s > cfg.hang_grace_s:
                    # alive but silent past the grace: hung — replace it
                    metrics.incr("fleet.hung_killed")
                    logger.warning("fleet replica %s hung (silent "
                                   "%.1fs); killing for respawn",
                                   rep.rid, silent_s)
                    rep.proc.kill()
            if (self._controller is not None and not self._closing
                    and now - self._last_as_tick
                    >= cfg.autoscale_interval_s):
                self._last_as_tick = now
                try:
                    self._autoscale_tick()
                except Exception:
                    metrics.incr("fleet.autoscale_errors")

    def _on_death(self, rep: _Replica) -> None:
        with self._lock:
            if rep.state == "dead":
                return
            was = rep.state
            rep.state = "dead"
            current = self._replicas.get(rep.rid) is rep
        metrics.incr("fleet.replica_deaths")
        if rep.client is not None:
            rep.client.close()
        logger.warning("fleet replica %s (gen %d) died with rc=%s",
                       rep.rid, rep.gen, rep.proc.returncode)
        if (self._closing or was == "draining" or not current
                or not self._cfg.respawn or rep.boot_error):
            return
        metrics.incr("fleet.respawns")
        self._spawn(rep.rid, respawn=True)

    # -- model lifecycle -----------------------------------------------------
    def load(self, name: str, model: str,
             input_schema=None, *, config: Optional[ServingConfig] = None,
             precision: Optional[str] = None) -> Dict[str, Any]:
        """Broadcast one committed model version into every replica
        (fleet-wide hot-swap). ``model`` must be a saved ``.ak`` path —
        workers are separate processes and load from the shared store,
        warming from the ``.ak.warmup.json`` sidecar. ``precision``
        overlays the serving precision policy (``"int8"``/``"bf16"``)
        onto every replica's load — each worker calibrates/gates
        independently (or adopts the sidecar's proven block) and refuses
        to fp32 on its own counted terms. Per-replica outcomes are
        counted (``fleet.swap_ok`` / ``fleet.swap_failed``) and returned;
        a replica that misses the swap re-syncs at its next
        health-recheck or respawn."""
        if not isinstance(model, str):
            raise AkIllegalArgumentException(
                "fleet load requires a saved .ak model path (workers are "
                "separate processes); save the PipelineModel first")
        from ..analysis.plancheck import preflight_fleet_models

        preflight_fleet_models([(name, model)],
                               recovery=self._cfg.respawn,
                               where="fleet.load")
        schema_str = input_schema.to_str() \
            if hasattr(input_schema, "to_str") else input_schema
        cfg_dict = dataclasses.asdict(config) if config is not None else (
            dataclasses.asdict(self._cfg.serving)
            if self._cfg.serving else None)
        if precision is not None:
            base = cfg_dict if cfg_dict is not None \
                else dataclasses.asdict(ServingConfig.default())
            cfg_dict = {**base, "precision": str(precision)}
        with self._lock:
            self._swap_seq += 1
            seq = self._swap_seq
            self._desired[name] = {"path": model, "schema": schema_str,
                                   "config": cfg_dict, "seq": seq}
            targets = [rep for rep in self._replicas.values()
                       if rep.client is not None
                       and rep.state in ("ready", "unhealthy")]
        outcomes: Dict[str, Dict[str, Any]] = {}
        out_lock = threading.Lock()
        # carry the caller's span (e.g. modelstream.swap) onto the
        # broadcast threads so every replica-side load lands in the
        # publish trace
        ctx = capture_context()

        def _swap_one(rep: _Replica) -> None:
            try:
                with attach_context(ctx):
                    resp = rep.client.call(
                        {"op": "load", "name": name, "path": model,
                         "schema": schema_str, "config": cfg_dict,
                         "seq": seq, "trace": wire_context()},
                        timeout=self._cfg.swap_timeout_s)
                if resp.get("ok"):
                    rep.synced[name] = seq
                    metrics.incr("fleet.swap_ok")
                    info = resp.get("value") or {}
                    out = {"ok": True,
                           "warmup_source": info.get("warmup_source"),
                           "precision": (info.get("precision")
                                         or {}).get("policy")}
                else:
                    metrics.incr("fleet.swap_failed")
                    out = {"ok": False, "error": resp.get("msg")}
            except Exception as e:
                metrics.incr("fleet.swap_failed")
                out = {"ok": False, "error": repr(e)}
            with out_lock:
                outcomes[rep.rid] = out

        threads = [threading.Thread(target=_swap_one, args=(rep,),
                                    daemon=True) for rep in targets]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=self._cfg.swap_timeout_s + 5.0)
        metrics.incr("fleet.swaps")
        return {"model": name, "seq": seq, "replicas": outcomes}

    def bind_model_source(self, name: str,
                          resolver: Callable[[], Optional[str]]) -> None:
        """Register where a re-syncing replica pulls ``name``'s newest
        committed blob from (e.g. ``lambda: store.blob_path(epoch)`` off
        ``store.latest()``). Without a source, re-sync uses the last
        broadcast path."""
        with self._lock:
            self._model_sources[name] = resolver

    def has_model(self, name: str) -> bool:
        with self._lock:
            return name in self._desired

    def models(self) -> List[str]:
        with self._lock:
            return sorted(self._desired)

    def unload(self, name: str) -> bool:
        with self._lock:
            known = self._desired.pop(name, None) is not None
            self._model_sources.pop(name, None)
            targets = [rep for rep in self._replicas.values()
                       if rep.client is not None and rep.state == "ready"]
        for rep in targets:
            try:
                rep.client.call({"op": "unload", "name": name,
                                 "trace": wire_context()},
                                timeout=self._cfg.swap_timeout_s)
                rep.synced.pop(name, None)
            except Exception:
                metrics.incr("fleet.swap_failed")
        return known

    def _resync_if_stale(self, rep: _Replica) -> None:
        """Bring a recovering/ready replica up to the newest desired
        version of every model it missed a swap for."""
        if rep.client is None:
            return
        with self._lock:
            desired = {n: dict(d) for n, d in self._desired.items()}
            sources = dict(self._model_sources)
        for name, d in desired.items():
            if rep.synced.get(name, -1) >= d["seq"]:
                continue
            path = d["path"]
            resolver = sources.get(name)
            if resolver is not None:
                try:
                    latest = resolver()
                    if latest:
                        path = latest
                except Exception:
                    metrics.incr("fleet.source_errors")
            try:
                resp = rep.client.call(
                    {"op": "load", "name": name, "path": path,
                     "schema": d["schema"], "config": d["config"],
                     "seq": d["seq"], "resync": True,
                     "trace": wire_context()},
                    timeout=self._cfg.swap_timeout_s)
            except Exception:
                metrics.incr("fleet.swap_failed")
                continue
            if resp.get("ok"):
                rep.synced[name] = d["seq"]
                metrics.incr("fleet.resyncs")
            else:
                metrics.incr("fleet.swap_failed")

    # -- scaling / decommission ----------------------------------------------
    def decommission(self, rid: str, *, force: bool = False) -> bool:
        """Gracefully retire one replica: stop routing to it, let it
        finish every accepted request, then reap the process. ``force``
        skips the drain (used by ``stop(drain=False)``)."""
        with self._lock:
            rep = self._replicas.get(rid)
            if rep is None:
                return False
            already_dead = rep.state == "dead"
            rep.state = "draining" if not already_dead else "dead"
        if not already_dead:
            metrics.incr("fleet.drains")
            if not force and rep.client is not None:
                try:
                    rep.client.call({"op": "drain",
                                     "trace": wire_context()},
                                    timeout=self._cfg.drain_timeout_s)
                except Exception:
                    metrics.incr("fleet.drain_errors")
        try:
            rep.proc.wait(timeout=2.0 if force or already_dead else 15.0)
        except subprocess.TimeoutExpired:
            rep.proc.kill()
            rep.proc.wait(timeout=10.0)
        if rep.client is not None:
            rep.client.close()
        if rep.log_fh is not None:
            rep.log_fh.close()
        with self._lock:
            if self._replicas.get(rid) is rep:
                del self._replicas[rid]
            rep.state = "dead"
        return True

    def scale_to(self, n: int) -> int:
        """Spawn or drain replicas until the live count is ``n`` (new
        replicas come up with every desired model, sidecar-warmed).
        Returns the resulting target count."""
        n = max(1, int(n))
        with self._lock:
            live = sorted(
                (rep for rep in self._replicas.values()
                 if rep.state in ("starting", "ready", "unhealthy")),
                key=lambda r: r.rid)
            cur = len(live)
            new_rids: List[str] = []
            victims: List[str] = []
            if n > cur:
                new_rids = [self._next_rid() for _ in range(n - cur)]
            elif n < cur:
                # retire unhealthy replicas first, then the newest ready
                order = sorted(live, key=lambda r: (r.state == "ready",
                                                    r.rid))
                victims = [r.rid for r in order[: cur - n]]
        spawned = [self._spawn(rid) for rid in new_rids]
        for rid in victims:
            self.decommission(rid)
        if spawned:
            try:
                self._wait_ready([r.rid for r in spawned],
                                 self._cfg.ready_timeout_s)
            except AkIllegalStateException:
                metrics.incr("fleet.scale_ready_timeouts")
        return n

    def _queue_lag(self, stats: Dict[str, Any]) -> float:
        """Live backpressure signal: mean queue wait across replica
        heartbeats over the last tick, in excess of the target."""
        with self._lock:
            hbs = [rep.hb_stats for rep in self._replicas.values()
                   if rep.state == "ready" and rep.hb_stats]
        tot_sum = sum(float((h.get("queue_s") or {}).get("sum") or 0.0)
                      for h in hbs)
        tot_cnt = sum(float((h.get("queue_s") or {}).get("count") or 0.0)
                      for h in hbs)
        d_sum = tot_sum - self._prev_queue[0]
        d_cnt = tot_cnt - self._prev_queue[1]
        self._prev_queue = (tot_sum, tot_cnt)
        if d_cnt <= 0:
            return 0.0
        return max(0.0, d_sum / d_cnt - self._cfg.target_queue_s)

    def _autoscale_tick(self) -> Optional[int]:
        """One autoscale evaluation: feed the live pressure signal to the
        BackpressureController; act on its decision. Called periodically
        by the monitor; tests drive it directly with a scripted
        ``lag_fn``. Returns the new target count, or None."""
        ctl = self._controller
        if ctl is None:
            return None
        with self._lock:
            n = len([rep for rep in self._replicas.values()
                     if rep.state in ("starting", "ready", "unhealthy")])
        self._as_epoch += 1
        target = ctl.observe({
            "epoch": self._as_epoch, "wall_s": 0.0, "chunks": 1,
            "parallelism": max(1, n),
            "min_parallelism": self._cfg.min_replicas,
            "max_parallelism": self._cfg.max_replicas,
        })
        if target is None or target == n:
            return None
        metrics.incr("fleet.autoscale_up" if target > n
                     else "fleet.autoscale_down")
        logger.info("fleet autoscale: %d -> %d replicas", n, target)
        self.scale_to(target)
        return target

    # -- request path --------------------------------------------------------
    def _routable(self) -> List[Tuple[str, ReplicaClient]]:
        with self._lock:
            return sorted(
                (rep.rid, rep.client) for rep in self._replicas.values()
                if rep.state == "ready" and rep.client is not None)

    def predict(self, name: str, row: Sequence, *,
                timeout: Optional[float] = None) -> Tuple:
        budget = timeout if timeout is not None \
            else self._config.default_timeout_s
        return self._frontend.predict(name, row, timeout=budget)

    def predict_many(self, name: str, rows: Sequence[Sequence], *,
                     timeout: Optional[float] = None) -> List[Tuple]:
        budget = timeout if timeout is not None \
            else self._config.default_timeout_s
        return self._frontend.predict_many(name, rows, timeout=budget)

    def open_frontdoor(self, *, port: int = 0) -> FrontendListener:
        """Expose the fleet on one stable external socket (the frame
        protocol's front door) — clients keep one address while replicas
        churn behind it."""
        return FrontendListener(self._frontend, host=self._cfg.bind_host,
                                port=port,
                                default_timeout_s=self._config.
                                default_timeout_s)

    # -- readouts ------------------------------------------------------------
    def replica_states(self) -> Dict[str, str]:
        with self._lock:
            return {rid: rep.state
                    for rid, rep in sorted(self._replicas.items())}

    def fleet_summary(self) -> Dict[str, Any]:
        """One-call readout: per-replica state/health/latency, state
        counts, breaker states, desired model versions, autoscale state,
        and every ``fleet.*`` counter (joined into ``serving_summary()``
        → ``GET /api/serving``)."""
        now = time.monotonic()
        with self._lock:
            reps = sorted(self._replicas.values(), key=lambda r: r.rid)
            desired = {n: d["seq"] for n, d in self._desired.items()}
        replicas = []
        states: Dict[str, int] = {}
        for rep in reps:
            states[rep.state] = states.get(rep.state, 0) + 1
            hb = rep.hb_stats
            replicas.append({
                "replica": rep.rid,
                "gen": rep.gen,
                "state": rep.state,
                "pid": rep.proc.pid,
                "device": rep.device,
                "ready_s": rep.ready_s,
                "hb_age_s": round(now - rep.last_hb, 3)
                if rep.last_hb is not None else None,
                "trace_delta": rep.trace_delta,
                "synced": dict(rep.synced),
                "loads": rep.ready_info,
                "queued": hb.get("queued"),
                "accepted": hb.get("accepted"),
                "completed": hb.get("completed"),
                "shed": hb.get("shed"),
                "batches": hb.get("batches"),
                "launches": hb.get("launches"),
                "gpu_mem": hb.get("gpu_mem"),
                "request_s": hb.get("request_s"),
            })
        ctl = self._controller
        # fleet-wide distributions: EXACT merges of the per-replica
        # bucket counts relayed over heartbeats (p99 of the pooled
        # distribution, not an average of per-replica p99s)
        fleet_wide: Dict[str, Any] = {}
        for h in ("serving.request_s", "serving.queue_s"):
            merged = metrics.merged_histogram(h)
            if merged is not None:
                fleet_wide[h] = merged
        return {
            "replicas": replicas,
            "states": states,
            "desired_models": desired,
            "breakers": CircuitBreaker.endpoint_states("fleet:"),
            "counters": metrics.counters("fleet."),
            "histograms": {
                h: metrics.histogram(h)
                for h in ("fleet.request_s",)
                if metrics.histogram(h) is not None
            },
            "fleet_wide": fleet_wide,
            "replica_counters": {
                rep.rid: self._telemetry.counters_for(rep.rid)
                for rep in reps
            },
            "autoscale": {
                "enabled": ctl is not None,
                "min_replicas": self._cfg.min_replicas,
                "max_replicas": self._cfg.max_replicas,
                "breaker_open": ctl.breaker_open if ctl else False,
            },
        }

    def _refresh_gauges(self) -> None:
        """Export-hook body: refresh the ``fleet.replicas{state=…}``
        gauges and per-replica latency gauges exactly when a scraper
        looks."""
        with self._lock:
            reps = list(self._replicas.values())
        counts = {s: 0 for s in _STATES}
        for rep in reps:
            counts[rep.state] = counts.get(rep.state, 0) + 1
        for state, n in counts.items():
            metrics.set_gauge("fleet.replicas", float(n), state=state)
        for rep in reps:
            req = (rep.hb_stats or {}).get("request_s") or {}
            for q in ("p50", "p99"):
                if req.get(q) is not None:
                    metrics.set_gauge(f"fleet.replica_request_s_{q}",
                                      float(req[q]), replica=rep.rid)
            if rep.hb_stats.get("queued") is not None:
                metrics.set_gauge("fleet.replica_queued",
                                  float(rep.hb_stats["queued"]),
                                  replica=rep.rid)
        # fleet-wide quantile gauges off the exact bucket merge — the
        # labeled per-replica histogram series export alongside them
        merged = metrics.merged_histogram("serving.request_s")
        if merged:
            for q in ("p50", "p90", "p99"):
                if merged.get(q) is not None:
                    metrics.set_gauge(f"fleet.serving_request_s_{q}",
                                      float(merged[q]))


# ---------------------------------------------------------------------------
# Process-wide fleet registry (the WebUI / serving_summary surface)
# ---------------------------------------------------------------------------

_fleets_lock = threading.Lock()
_fleets: "weakref.WeakSet[ServingFleet]" = weakref.WeakSet()
_hook_registered = False


def _register_fleet(fleet: ServingFleet) -> None:
    global _hook_registered
    with _fleets_lock:
        _fleets.add(fleet)
        if not _hook_registered:
            metrics.register_export_hook(_refresh_fleet_gauges)
            _hook_registered = True


def _unregister_fleet(fleet: ServingFleet) -> None:
    with _fleets_lock:
        _fleets.discard(fleet)


def _live_fleets() -> List[ServingFleet]:
    with _fleets_lock:
        return [f for f in list(_fleets)
                if f._started and not f._closing]


def _refresh_fleet_gauges() -> None:
    for fleet in _live_fleets():
        fleet._refresh_gauges()


def active_fleet_summary() -> Optional[Dict[str, Any]]:
    """The fleet block ``serving_summary()`` joins in: the live fleet's
    summary (or ``{"fleets": [...]}`` when several run in one process),
    None when no fleet is active."""
    live = _live_fleets()
    if not live:
        return None
    if len(live) == 1:
        return live[0].fleet_summary()
    return {"fleets": [f.fleet_summary() for f in live]}


# ---------------------------------------------------------------------------
# Worker process
# ---------------------------------------------------------------------------


class _WorkerRuntime:
    """The replica side: a ModelServer behind a loopback data socket,
    heartbeating to the supervisor. Translates injected
    :class:`~alink_tpu_torch.common.faults.InjectedReplicaFault` behaviors
    into real process-level misbehavior for chaos drills."""

    def __init__(self, cfg: Dict[str, Any]):
        self.rid: str = cfg["rid"]
        self.gen: int = int(cfg.get("gen") or 0)
        self.token: str = cfg["token"]
        self.heartbeat_s = float(cfg.get("heartbeat_s") or 0.5)
        self.control_addr = (cfg["control_host"], int(cfg["control_port"]))
        sdict = cfg.get("serving")
        self.serving_cfg = ServingConfig(**sdict) if sdict \
            else ServingConfig.default()
        self.server = ModelServer(self.serving_cfg)
        self.models: List[Dict[str, Any]] = cfg.get("models") or []
        self.recovery: bool = bool(cfg.get("recovery"))
        self._synced: Dict[str, int] = {}
        self._synced_lock = threading.Lock()
        self._hung = threading.Event()
        self._refuse = threading.Event()
        self._draining = threading.Event()
        self._active = 0
        self._active_lock = threading.Lock()
        self._idle = threading.Condition(self._active_lock)
        self._csock: Optional[socket.socket] = None
        self._send_lock = threading.Lock()
        self._trace_base = 0
        self._device = None
        self._ppid = os.getppid()
        # observability plane: every span finished here is tagged with
        # this replica's identity and queued (bounded) for the heartbeat
        # relay; metric deltas ride the same channel
        set_process_identity(self.rid)
        tracer.enable_export()
        self._telemetry_src = TelemetrySource()

    # -- wire helpers --------------------------------------------------------
    def _send_line(self, msg: Dict[str, Any]) -> None:
        data = (json.dumps(msg) + "\n").encode("utf-8")
        with self._send_lock:
            self._csock.sendall(data)

    # -- fault acting --------------------------------------------------------
    def _act_out(self, behavior: str) -> None:
        if behavior == "kill_mid_batch":
            # die NOW, with requests in flight on other handler threads —
            # exactly what a SIGKILL mid-batch looks like to the fleet
            os._exit(17)
        if behavior == "hang":
            self._hung.set()
            while not self._orphaned():
                time.sleep(1.0)
            os._exit(0)
        if behavior == "refuse_health":
            self._refuse.set()

    def _tap(self, label: str) -> None:
        try:
            faults.maybe_fail("replica", label)
        except faults.InjectedReplicaFault as e:
            self._act_out(e.behavior)

    # -- data plane ----------------------------------------------------------
    def _accept_loop(self, lsock: socket.socket) -> None:
        while True:
            try:
                conn, _ = lsock.accept()
            except OSError:
                return
            threading.Thread(target=self._serve_conn, args=(conn,),
                             daemon=True).start()

    def _serve_conn(self, conn: socket.socket) -> None:
        try:
            while True:
                op = recv_frame(conn)
                send_frame(conn, self._dispatch(op))
        except (ConnectionError, OSError, EOFError):
            metrics.incr("fleet.worker_disconnects")
        finally:
            conn.close()

    def _dispatch(self, op: Dict[str, Any]) -> Dict[str, Any]:
        if self._hung.is_set():
            time.sleep(3600.0)  # black hole: the caller's socket times out
        kind = op.get("op")
        if kind in ("predict", "predict_many"):
            if self._draining.is_set():
                return {"ok": False, "etype": DRAINING,
                        "msg": f"replica {self.rid} is draining"}
            with self._active_lock:
                self._active += 1
            try:
                self._tap(f"{self.rid}.g{self.gen}.batch")
                # the frontend's wire context parents this replica's
                # serving.request/serving.batch spans — one stitched
                # trace per frontdoor request. None/garbage tolerated
                # (old frontends): spans become local roots instead.
                with adopt_context(op.get("trace")):
                    if kind == "predict":
                        val = self.server.predict(
                            op["name"], op["row"],
                            timeout=op.get("deadline_s"))
                    else:
                        val = self.server.predict_many(
                            op["name"], op["rows"],
                            timeout=op.get("deadline_s"))
                return {"ok": True, "value": val}
            except BaseException as e:
                return encode_error(e)
            finally:
                with self._active_lock:
                    self._active -= 1
                    self._idle.notify_all()
        if kind == "load":
            try:
                cdict = op.get("config")
                scfg = ServingConfig(**cdict) if cdict else self.serving_cfg
                with adopt_context(op.get("trace")):
                    info = self.server.load(op["name"], op["path"],
                                            op.get("schema"), config=scfg,
                                            recovery=bool(op.get("resync")))
                with self._synced_lock:
                    self._synced[op["name"]] = int(op.get("seq") or 0)
                # re-base the zero-trace pin: load-time warmup traces are
                # the sanctioned ones; only traffic after them must not
                self._trace_base = metrics.counter("jit.trace")
                return {"ok": True, "value": info}
            except BaseException as e:
                return encode_error(e)
        if kind == "unload":
            try:
                ok = self.server.unload(op["name"])
                with self._synced_lock:
                    self._synced.pop(op["name"], None)
                return {"ok": True, "value": ok}
            except BaseException as e:
                return encode_error(e)
        if kind == "stats":
            return {"ok": True, "value": self._stats_payload()}
        if kind == "ping":
            return {"ok": True, "value": {"rid": self.rid,
                                          "pid": os.getpid()}}
        if kind == "drain":
            return self._drain()
        if kind == "shutdown":
            threading.Timer(0.1, os._exit, args=(0,)).start()
            return {"ok": True, "value": True}
        return encode_error(
            AkIllegalArgumentException(f"unknown fleet op {kind!r}"))

    def _drain(self) -> Dict[str, Any]:
        """Stop admitting, finish every in-flight request, then exit."""
        self._draining.set()
        deadline = time.monotonic() + 60.0
        with self._idle:
            # this handler thread is not itself counted in _active
            while self._active > 0 and time.monotonic() < deadline:
                self._idle.wait(0.2)
        self.server.close()  # drains queued requests, joins batchers
        # reply first, then exit — the ack must reach the supervisor
        threading.Timer(0.25, os._exit, args=(0,)).start()
        return {"ok": True, "value": True}

    # -- heartbeats ----------------------------------------------------------
    def _stats_payload(self) -> Dict[str, Any]:
        st = self.server.stats()
        agg = {"queued": 0, "accepted": 0, "completed": 0, "shed": 0,
               "errors": 0}
        for m in st["models"]:
            for k in agg:
                agg[k] += int(m.get(k) or 0)
        q = metrics.histogram("serving.queue_s") or {}
        r = metrics.histogram("serving.request_s") or {}
        trace = metrics.counter("jit.trace")
        with self._synced_lock:
            synced = dict(self._synced)
        return {
            **agg,
            # batches of the models loaded now (a swapped-out entry's
            # batches leave with it), and this process's kernel launches:
            # on the card every served BERT batch launches the flash
            # kernel once per layer
            "batches": sum(int(m.get("batches") or 0) for m in st["models"]),
            "launches": kernel_launches(),
            "gpu_mem": self._gpu_mem(),
            "queue_s": {"count": q.get("count", 0),
                        "sum": q.get("sum", 0.0)},
            "request_s": {k: r[k]
                          for k in ("count", "sum", "p50", "p90", "p99")
                          if r.get(k) is not None},
            "jit_trace": trace,
            "trace_delta": trace - self._trace_base,
            "synced": synced,
            "pid": os.getpid(),
        }

    def _gpu_mem(self) -> Dict[str, int]:
        """This process's device memory (bytes) on the card; empty on the
        CPU."""
        if self._device is None or self._device.type != "cuda":
            return {}
        import torch

        return {"allocated": int(torch.cuda.memory_allocated(self._device)),
                "max_allocated": int(
                    torch.cuda.max_memory_allocated(self._device)),
                "reserved": int(torch.cuda.memory_reserved(self._device))}

    def _open_device(self):
        """The device this replica serves on, resolved as every entry
        point resolves it, with its CUDA context made and the kernels
        loaded before any model: a replica that cannot serve on the device
        it was asked for must fail here, not fall back."""
        from ..common.env import resolve_device
        from ..native import kernels

        dev = resolve_device()
        if dev.type == "cuda":
            import torch

            if dev.index is not None:
                torch.cuda.set_device(dev)
            torch.zeros(1, device=dev)   # the context, now
            kernels.build()
        return dev

    def _orphaned(self) -> bool:
        """The supervisor process is gone (this replica was re-parented)."""
        return os.getppid() != self._ppid

    # -- main ----------------------------------------------------------------
    def run(self) -> int:
        try:
            self._device = self._open_device()
        except Exception as e:
            # tell the supervisor why, then exit: it raises at start and
            # never respawns a replica that cannot reach its device
            self._csock = socket.create_connection(self.control_addr,
                                                   timeout=10.0)
            self._send_line({"t": "hello", "rid": self.rid, "gen": self.gen,
                             "token": self.token, "pid": os.getpid()})
            self._send_line({"t": "failed",
                             "error": f"{type(e).__name__}: {e}"})
            self._csock.close()
            return 3
        lsock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        lsock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        lsock.bind((self.control_addr[0], 0))
        lsock.listen(64)
        data_port = lsock.getsockname()[1]
        threading.Thread(target=self._accept_loop, args=(lsock,),
                         daemon=True).start()
        loads = []
        for m in self.models:
            try:
                cdict = m.get("config")
                scfg = ServingConfig(**cdict) if cdict else self.serving_cfg
                info = self.server.load(m["name"], m["path"],
                                        m.get("schema"), config=scfg,
                                        recovery=self.recovery)
                with self._synced_lock:
                    self._synced[m["name"]] = int(m.get("seq") or 0)
                loads.append({"model": m["name"], "ok": True,
                              "warmup_source": info.get("warmup_source"),
                              "precision": (info.get("precision")
                                            or {}).get("policy")})
            except Exception as e:
                metrics.incr("fleet.worker_load_errors")
                loads.append({"model": m["name"], "ok": False,
                              "error": str(e)})
        self._csock = socket.create_connection(self.control_addr,
                                               timeout=10.0)
        # everything after this line must add ZERO traces: the baseline
        # the supervisor pins trace_delta == 0 against
        self._trace_base = metrics.counter("jit.trace")
        self._send_line({"t": "hello", "rid": self.rid, "gen": self.gen,
                         "token": self.token, "pid": os.getpid()})
        with self._synced_lock:
            synced = dict(self._synced)
        self._send_line({"t": "ready", "data_port": data_port,
                         "loads": loads, "jit_trace": self._trace_base,
                         "synced": synced, "pid": os.getpid(),
                         "device": str(self._device),
                         "stats": self._stats_payload()})
        while not self._draining.is_set():
            time.sleep(self.heartbeat_s)
            if self._orphaned():
                os._exit(0)
            if self._hung.is_set() or self._refuse.is_set():
                break  # heartbeat silence; the data plane decides the rest
            try:
                faults.maybe_fail(
                    "replica", f"{self.rid}.g{self.gen}.heartbeat")
            except faults.InjectedReplicaFault as e:
                if e.behavior in ("hang", "refuse_health"):
                    self._act_out(e.behavior)
                    break
                os._exit(23)  # kill_mid_batch at the heartbeat label
            try:
                hb: Dict[str, Any] = {"t": "hb",
                                      "stats": self._stats_payload()}
                # piggyback bounded telemetry deltas and finished-span
                # batches — absent keys mean "nothing new", so idle
                # heartbeats stay as small as before
                tele = self._telemetry_src.delta()
                if tele is not None:
                    hb["telemetry"] = tele
                spans = tracer.drain_export()
                if spans:
                    hb["spans"] = spans
                self._send_line(hb)
            except OSError:
                # supervisor is gone — an orphan replica must not outlive
                # its fleet (the batcher threads would keep it alive)
                os._exit(0)
        # hung / health-refusing / draining: stay alive for the data
        # plane (or the supervisor's kill) — handlers run on daemon
        # threads off this one — but never outlive the supervisor
        while not self._orphaned():
            time.sleep(1.0)
        os._exit(0)


def worker_main() -> int:
    """Entry point for ``python -m alink_tpu_torch.serving.fleet`` (spawned
    by the supervisor; config in ``ALINK_FLEET_WORKER``)."""
    raw = env_raw("ALINK_FLEET_WORKER")
    if not raw:
        sys.stderr.write(
            "alink_tpu_torch.serving.fleet is the fleet worker entry point "
            "and "
            "expects its config in ALINK_FLEET_WORKER; use "
            "ServingFleet to launch a fleet.\n")
        return 2
    cfg = json.loads(raw)
    return _WorkerRuntime(cfg).run()


if __name__ == "__main__":  # pragma: no cover — exercised via subprocess
    raise SystemExit(worker_main())
