"""Deterministic fault injection for resilience testing (port of
``alink_tpu.common.faults``, copied).

The seeded chaos tap the runtime layers consult at named injection points,
shipped as a *public* testing utility so user pipelines can be certified
under fault the same way the framework's own suite is.

Injection points wired into the port:

- ``publish``   — the continuous-serving publish sequence
  (``modelstream/``), labels ``epochN.pre_blob`` (before the model blob
  lands), ``epochN.pre_sidecar`` (blob durable, warmup sidecar not yet
  written), ``epochN.pre_manifest`` (blob + sidecar durable, manifest —
  the atomic commit point — not yet renamed), ``epochN.pre_swap``
  (version committed, the server hot-swap not yet run).
  ``publish:count=1,kinds=crash,match=pre_manifest`` kills the job exactly
  once with a fully-written-but-uncommitted version on disk.
- ``replica``   — the serving-fleet worker processes (``serving/fleet.py``),
  labels ``<replica>.g<gen>.batch`` (tapped inside the worker's predict
  handling, between accept and reply) and ``<replica>.g<gen>.heartbeat``
  (the worker's heartbeat loop). The generation qualifier lets a drill
  target one incarnation: fault counters are per-process, so a spec
  matching the bare replica id would re-fire in every respawn.
  Uses the replica-specific kinds below:
  ``kill_mid_batch`` (the worker process dies with requests in flight —
  the front-end must re-dispatch them to a healthy replica),
  ``hang`` (the worker stops answering heartbeats AND data-plane calls
  while staying alive — the supervisor must declare it unhealthy and
  replace it), ``refuse_health`` (heartbeats stop but the data plane
  still answers — exercises health-based routing without a real death).
  ``replica:count=1,kinds=kill_mid_batch,match=r1.g2.batch`` kills the
  first incarnation of replica r1 exactly once, mid-load,
  deterministically; its respawn (a later generation) serves normally.

The reference's other points (``unit`` in the DAG executor, ``transfer``
in ``stream_map``, ``io`` in the connectors, ``recovery`` and ``rescale``
in the epoch runtime) are tapped by modules the port has not taken yet
(ROADMAP A1 and A7); the grammar and the tap already serve them.

Spec grammar (``ALINK_FAULT_SPEC``)::

    point:key=value[,key=value...][;point:...]

    unit:rate=0.3,kinds=transient;io:count=2

- ``rate=F``   — each call at the point fails with probability *F*, drawn
  from a per-point RNG seeded by ``ALINK_FAULT_SEED`` (default 0): the
  same spec + seed replays the exact same fault schedule.
- ``count=N``  — the first *N* calls at the point fail, then all pass
  (takes precedence over ``rate``).
- ``match=S``  — only calls whose *label* contains substring *S* are
  eligible (others pass untouched and consume neither count nor RNG
  draws). Lets a drill target one deterministic site — e.g.
  ``publish:count=1,kinds=crash,match=pre_manifest`` kills the job
  exactly once, between the sidecar and the manifest.
- ``kinds``    — ``transient`` (raises :class:`InjectedFaultError`, which
  the taxonomy classifies retryable), ``fatal`` (raises
  :class:`InjectedFatalError`, never retried), or ``crash`` (raises
  :class:`InjectedCrashError` — a process-kill stand-in: NOT retryable by
  the inner retry layers, so it takes the whole job down, but a
  supervised restart loop classifies it restartable and resumes from
  the last epoch snapshot).
  The ``replica`` point additionally accepts
  ``kill_mid_batch``/``hang``/``refuse_health`` (raises
  :class:`InjectedReplicaFault` carrying the behavior — the fleet worker
  runtime translates it into the corresponding process-level misbehavior
  instead of a plain exception).

Usage::

    from alink_tpu_torch.common import faults

    faults.install(faults.FaultSpec.parse("unit:rate=0.3", seed=7))
    try:
        op.collect()          # completes despite injected unit faults
    finally:
        faults.clear()

or externally: ``ALINK_FAULT_SPEC='io:count=2' python job.py``.

Injected faults are counted per point (``faults.injected.<point>``) in
``common/metrics.py`` so a run under injection reports how much fault
pressure it actually absorbed.
"""

from __future__ import annotations

import threading
import zlib
from random import Random
from typing import Dict, Optional

from .env import env_int, env_str
from .exceptions import AkException, AkRetryableException
from .metrics import metrics


class InjectedFaultError(AkRetryableException):
    """Synthetic *transient* fault — classified retryable by the taxonomy."""

    code = "AK_INJECTED_FAULT"


class InjectedFatalError(AkException):
    """Synthetic *fatal* fault — never retried; must propagate unchanged."""

    code = "AK_INJECTED_FATAL"


class InjectedCrashError(AkException):
    """Synthetic *crash* fault — models the process dying mid-job.

    Deliberately NOT an :class:`AkRetryableException`: in-process retry
    layers (``with_retries``, the DAG executor) must let it kill the job,
    exactly as a real SIGKILL would. Only a supervised restart loop
    treats it as restartable — a fresh job instance resumes from the last
    snapshot."""

    code = "AK_INJECTED_CRASH"


#: Replica-misbehavior kinds accepted at the ``replica`` point. Unlike the
#: generic kinds these do not map to the retry taxonomy — the fleet worker
#: runtime catches :class:`InjectedReplicaFault` and *acts out* the
#: behavior (process exit / freeze / heartbeat silence).
REPLICA_BEHAVIORS = ("kill_mid_batch", "hang", "refuse_health")


class InjectedReplicaFault(AkException):
    """Synthetic replica misbehavior for serving-fleet chaos drills.

    Carries the requested behavior in :attr:`behavior`; raised by the
    injection tap and translated by ``serving/fleet.py``'s worker runtime
    into the real thing (``kill_mid_batch`` → ``os._exit`` with requests
    in flight, ``hang`` → stop heartbeating and stall the data plane,
    ``refuse_health`` → stop heartbeating only). If one escapes outside a
    fleet worker it propagates as a plain fatal error."""

    code = "AK_INJECTED_REPLICA_FAULT"

    def __init__(self, behavior: str, message: str = ""):
        super().__init__(message or f"injected replica fault: {behavior}")
        self.behavior = behavior


class _Rule:
    __slots__ = ("rate", "count", "kind", "match", "_rng", "_calls",
                 "_fired")

    def __init__(self, rate: float = 0.0, count: int = 0,
                 kind: str = "transient", seed: int = 0, point: str = "",
                 match: str = ""):
        self.rate = rate
        self.count = count
        self.kind = kind
        self.match = match
        # per-point stream: independent of call order at *other* points, so
        # adding a branch to a DAG does not reshuffle every fault schedule
        self._rng = Random(seed ^ zlib.crc32(point.encode()))
        self._calls = 0
        self._fired = 0

    def should_fire(self) -> bool:
        self._calls += 1
        if self.count > 0:
            if self._fired < self.count:
                self._fired += 1
                return True
            return False
        if self.rate > 0.0 and self._rng.random() < self.rate:
            self._fired += 1
            return True
        return False


class FaultSpec:
    """A parsed, seeded fault schedule. Thread-safe: DAG units fire from
    pool workers concurrently."""

    def __init__(self, rules: Dict[str, _Rule], seed: int = 0,
                 source: str = ""):
        self._rules = rules
        self.seed = seed
        self.source = source
        self._lock = threading.Lock()

    @classmethod
    def parse(cls, spec: str, seed: int = 0) -> "FaultSpec":
        from .exceptions import AkParseErrorException

        rules: Dict[str, _Rule] = {}
        for part in spec.split(";"):
            part = part.strip()
            if not part:
                continue
            point, sep, body = part.partition(":")
            point = point.strip()
            if not sep or not point:
                raise AkParseErrorException(
                    f"bad fault spec segment {part!r} "
                    f"(want point:key=value,...)")
            kw: Dict[str, str] = {}
            for item in body.split(","):
                item = item.strip()
                if not item:
                    continue
                k, sep2, v = item.partition("=")
                if not sep2:
                    raise AkParseErrorException(
                        f"bad fault spec item {item!r} in segment {part!r}")
                kw[k.strip()] = v.strip()
            kind = kw.get("kinds", kw.get("kind", "transient"))
            if kind not in ("transient", "fatal", "crash") \
                    and kind not in REPLICA_BEHAVIORS:
                raise AkParseErrorException(
                    f"fault kind must be transient|fatal|crash or one of "
                    f"{'|'.join(REPLICA_BEHAVIORS)}, got {kind!r}")
            try:
                rate = float(kw.get("rate", "0"))
                count = int(kw.get("count", "0"))
            except ValueError as e:
                raise AkParseErrorException(
                    f"bad rate/count in fault spec segment {part!r}") from e
            rules[point] = _Rule(rate=rate, count=count, kind=kind,
                                 seed=seed, point=point,
                                 match=kw.get("match", ""))
        return cls(rules, seed=seed, source=spec)

    def fire(self, point: str, label: str = "") -> None:
        rule = self._rules.get(point)
        if rule is None:
            return
        if rule.match and rule.match not in (label or ""):
            return  # non-matching calls consume neither count nor RNG
        with self._lock:
            fire = rule.should_fire()
            kind = rule.kind
        if not fire:
            return
        metrics.incr(f"faults.injected.{point}")
        where = f"{point}:{label}" if label else point
        if kind == "fatal":
            raise InjectedFatalError(f"injected fatal fault at {where}")
        if kind == "crash":
            raise InjectedCrashError(f"injected crash at {where}")
        if kind in REPLICA_BEHAVIORS:
            raise InjectedReplicaFault(
                kind, f"injected replica fault ({kind}) at {where}")
        raise InjectedFaultError(f"injected transient fault at {where}")

    def __repr__(self):
        return f"FaultSpec({self.source!r}, seed={self.seed})"


# ---------------------------------------------------------------------------
# Active-spec management
# ---------------------------------------------------------------------------

_installed: Optional[FaultSpec] = None
# (env string, seed) -> parsed spec; env specs keep rule state across calls
# so count=N semantics hold process-wide
_env_cache: Dict[tuple, FaultSpec] = {}
_state_lock = threading.Lock()


def install(spec: Optional[FaultSpec]) -> None:
    """Programmatically activate a spec (tests); overrides the env spec."""
    global _installed
    with _state_lock:
        _installed = spec


def clear() -> None:
    """Deactivate injection and forget cached env specs (their count state
    is meaningless once the env changes)."""
    global _installed
    with _state_lock:
        _installed = None
        _env_cache.clear()


def active() -> Optional[FaultSpec]:
    # lock-free fast path: the tap sits on hot paths (every H2D transfer
    # submission, every DAG unit attempt, every connector poll) and must
    # not serialize transfer threads on a global mutex when injection is
    # off. Reading `_installed` and probing the env knob are plain dict
    # lookups; the lock is only taken once a spec is actually configured.
    spec = _installed
    if spec is not None:
        return spec
    env = env_str("ALINK_FAULT_SPEC")
    if env is None:
        return None
    env = env.strip()
    seed = env_int("ALINK_FAULT_SEED", 0)
    key = (env, seed)
    with _state_lock:
        spec = _env_cache.get(key)
        if spec is None:
            spec = _env_cache[key] = FaultSpec.parse(env, seed=seed)
        return spec


def maybe_fail(point: str, label: str = "") -> None:
    """The injection tap. A no-op (two lock-free dict lookups) when no
    spec is active — cheap enough to leave in every production code path."""
    spec = active()
    if spec is not None:
        spec.fire(point, label)
