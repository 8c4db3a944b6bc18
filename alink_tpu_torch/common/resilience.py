"""Retry policy engine, circuit breaker, and dead-letter buffer (port of
``alink_tpu.common.resilience``, copied: the same policies, registry and
counters).

The reference platform inherits fault tolerance from Flink (checkpointed
sources, task retry, operator-state recovery — see
``operator/stream/checkpoint.py``'s survey notes). This runtime has no
Flink under it, so transient-failure handling is a first-class layer:

- :class:`RetryPolicy` + :func:`with_retries` — exponential backoff with
  full jitter and a per-call deadline budget. Classification is delegated
  to :func:`~alink_tpu_torch.common.exceptions.is_retryable` so the
  transient/fatal decision is made once, centrally.
- :class:`CircuitBreaker` — per-endpoint failure accounting: after a burst
  of consecutive failures the endpoint is "open" and calls fail fast with
  :class:`~alink_tpu_torch.common.exceptions.AkCircuitOpenException` until a
  reset timeout half-opens it for a probe. Stops a dead connector from
  stalling every chunk for its full retry budget.
- :class:`DeadLetterBuffer` — bounded buffer for malformed ingest rows,
  opt-in via ``ALINK_DEAD_LETTER=on``: one poison message must not abort a
  long-running streaming job, but silently discarding it is worse, so
  drops are counted (``resilience.dead_letter``) and the payloads stay
  inspectable.

Knobs (env):

- ``ALINK_RETRIES=off``           — disable retries framework-wide
  (restore fail-fast-on-first-error semantics everywhere).
- ``ALINK_RETRY_MAX_ATTEMPTS``    — default policy attempt budget (3).
- ``ALINK_RETRY_DEADLINE_S``      — default per-call wall budget (none).
- ``ALINK_DEAD_LETTER=on``        — route malformed ingest rows to the
  dead-letter buffer instead of raising.
- ``ALINK_DEAD_LETTER_LIMIT``     — buffer bound (1024; oldest evicted).

Every retry/degradation/dead-letter event lands in ``common/metrics.py``
counters (``resilience.*``); :func:`resilience_summary` is the one-call
readout.
"""

from __future__ import annotations

import logging
import random
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

from .env import env_flag, env_float, env_int
from .exceptions import AkCircuitOpenException, is_retryable
from .metrics import metrics

logger = logging.getLogger("alink_tpu_torch.resilience")

_RETRY_TRACE_LIMIT = 512  # ring bound on the per-retry trace series


def retries_enabled() -> bool:
    """``ALINK_RETRIES=off`` restores fail-fast behavior everywhere: no
    retries, no fused-chain defusion, no serial degradation."""
    return env_flag("ALINK_RETRIES", default=True)


@dataclass(frozen=True)
class RetryPolicy:
    """Exponential backoff with full jitter (delay for attempt *k* is
    uniform in ``[0, min(max_delay, base_delay * multiplier**k)]``) under
    two budgets: ``max_attempts`` total tries and an optional ``deadline``
    of wall seconds for the whole call (attempts + sleeps)."""

    max_attempts: int = 3
    base_delay: float = 0.05
    multiplier: float = 2.0
    max_delay: float = 2.0
    jitter: bool = True
    deadline: Optional[float] = None

    @classmethod
    def default(cls) -> "RetryPolicy":
        """The framework-wide policy, env-overridable per job."""
        return cls(
            max_attempts=max(1, env_int("ALINK_RETRY_MAX_ATTEMPTS", 3)),
            deadline=env_float("ALINK_RETRY_DEADLINE_S", None),
        )

    def delay(self, attempt: int, rng: Optional[random.Random] = None
              ) -> float:
        cap = min(self.max_delay, self.base_delay * self.multiplier ** attempt)
        if not self.jitter:
            return cap
        return (rng or _rng).uniform(0.0, cap)


# module-level RNG for jitter; seeded so backoff schedules are reproducible
# within a process (fault-injection tests rely on deterministic replay)
_rng = random.Random(0x5EED)


def with_retries(
    fn: Callable[[], Any],
    policy: Optional[RetryPolicy] = None,
    *,
    classify: Callable[[BaseException], bool] = is_retryable,
    name: str = "call",
    counter: Optional[str] = None,
    breaker: Optional["CircuitBreaker"] = None,
    sleep: Callable[[float], None] = time.sleep,
) -> Any:
    """Run ``fn()`` under ``policy`` (default: :meth:`RetryPolicy.default`).

    Only exceptions ``classify`` deems transient are retried; everything
    else propagates unchanged from the failing attempt. ``counter`` names
    an extra per-layer metrics counter bumped on each retry (the shared
    ``resilience.retries`` counter always counts). ``breaker``, when
    given, is consulted before every attempt and fed the outcome. With
    ``ALINK_RETRIES=off`` this is exactly ``fn()`` — one attempt, no
    breaker bookkeeping, today's fail-fast semantics."""
    if not retries_enabled():
        return fn()
    policy = policy or RetryPolicy.default()
    start = time.monotonic()
    attempt = 0
    while True:
        if breaker is not None:
            breaker.before_call()
        try:
            out = fn()
        except BaseException as exc:
            # only transient failures feed the breaker: they signal service
            # health. A deterministic user error ("table not found") must
            # not open a shared endpoint breaker and mask itself behind
            # AkCircuitOpenException for every other caller.
            # ...but a non-retryable failure must still release a held
            # half-open probe slot, or one bad table name during the probe
            # window pins the breaker open forever.
            if breaker is not None and not isinstance(
                    exc, AkCircuitOpenException):
                if classify(exc):
                    breaker.record_failure()
                else:
                    breaker.release_probe()
            attempt += 1
            if attempt >= policy.max_attempts or not classify(exc):
                raise
            d = policy.delay(attempt - 1)
            if (policy.deadline is not None
                    and time.monotonic() - start + d > policy.deadline):
                metrics.incr("resilience.deadline_exceeded")
                raise
            metrics.incr("resilience.retries")
            if counter:
                metrics.incr(counter)
            # the active trace span (the DAG unit, transfer batch, or
            # recovery epoch this call ran under) reads as `retried`
            from .tracing import note_retry

            note_retry()
            metrics.record_bounded(
                "resilience.retry", _RETRY_TRACE_LIMIT, call=name,
                attempt=attempt, error=type(exc).__name__,
                delay_s=round(d, 4))
            logger.debug("retrying %s (attempt %d/%d) after %s: %r",
                         name, attempt + 1, policy.max_attempts,
                         f"{d:.3f}s", exc)
            sleep(d)
        else:
            if breaker is not None:
                breaker.record_success()
            return out


class CircuitBreaker:
    """Consecutive-failure breaker with a half-open probe.

    Closed: calls pass, failures count. Open (after ``failure_threshold``
    consecutive failures): :meth:`before_call` raises
    :class:`AkCircuitOpenException` without touching the endpoint. After
    ``reset_timeout`` seconds one probe call is let through (half-open);
    its success closes the breaker, its failure re-opens it."""

    def __init__(self, failure_threshold: int = 5,
                 reset_timeout: float = 30.0, name: str = "",
                 clock: Callable[[], float] = time.monotonic):
        self.failure_threshold = max(1, failure_threshold)
        self.reset_timeout = reset_timeout
        self.name = name
        self._clock = clock
        self._lock = threading.Lock()
        self._failures = 0
        self._opened_at: Optional[float] = None
        self._probing = False

    def before_call(self) -> None:
        with self._lock:
            if self._opened_at is None:
                return
            if (self._clock() - self._opened_at >= self.reset_timeout
                    and not self._probing):
                self._probing = True  # half-open: exactly one probe through
                return
            raise AkCircuitOpenException(
                f"circuit open for {self.name or 'endpoint'} "
                f"({self._failures} consecutive failures; retry after "
                f"{self.reset_timeout}s)")

    def record_success(self) -> None:
        with self._lock:
            self._failures = 0
            self._opened_at = None
            self._probing = False

    def release_probe(self) -> None:
        """The in-flight half-open probe ended without a health verdict
        (e.g. a non-retryable user error): free the probe slot so the next
        caller past the reset timeout can probe again."""
        with self._lock:
            self._probing = False

    def record_failure(self) -> None:
        with self._lock:
            self._failures += 1
            self._probing = False
            if self._failures >= self.failure_threshold:
                if self._opened_at is None:
                    metrics.incr("resilience.breaker_open")
                    logger.warning(
                        "circuit breaker OPEN for %s after %d consecutive "
                        "failures", self.name or "endpoint", self._failures)
                self._opened_at = self._clock()

    @property
    def is_open(self) -> bool:
        with self._lock:
            return self._opened_at is not None

    # -- per-endpoint registry ---------------------------------------------
    _registry: Dict[str, "CircuitBreaker"] = {}
    _registry_lock = threading.Lock()

    @classmethod
    def for_endpoint(cls, key: str, **kwargs) -> "CircuitBreaker":
        """One shared breaker per endpoint key (e.g. ``odps:<project>``,
        ``hbase:<host:port>``) so every op hitting a dead service trips the
        same breaker."""
        with cls._registry_lock:
            b = cls._registry.get(key)
            if b is None:
                b = cls._registry[key] = cls(name=key, **kwargs)
            return b

    @classmethod
    def replace_endpoint(cls, key: str, **kwargs) -> "CircuitBreaker":
        """Install a FRESH breaker under ``key`` and return it. For
        endpoints whose backing resource was replaced (a hot-swapped
        serving model): the new resource must not inherit the retired
        one's failure history, and callers still holding the old breaker
        object keep feeding it in isolation."""
        with cls._registry_lock:
            b = cls._registry[key] = cls(name=key, **kwargs)
            return b

    @classmethod
    def reset_all(cls) -> None:
        with cls._registry_lock:
            cls._registry.clear()

    @classmethod
    def endpoint_states(cls, prefix: str = "") -> Dict[str, str]:
        """``{key: "open"|"closed"}`` for registered endpoints matching
        ``prefix`` — the fleet summary surfaces its ``fleet:<replica>``
        breakers through this without holding breaker internals."""
        with cls._registry_lock:
            items = [(k, b) for k, b in cls._registry.items()
                     if k.startswith(prefix)]
        return {k: ("open" if b.is_open else "closed") for k, b in items}


# ---------------------------------------------------------------------------
# Dead-letter buffer
# ---------------------------------------------------------------------------


def dead_letter_enabled() -> bool:
    return env_flag("ALINK_DEAD_LETTER", default=False)


def _dead_letter_limit() -> int:
    return max(1, env_int("ALINK_DEAD_LETTER_LIMIT", 1024))


class DeadLetterBuffer:
    """Bounded in-process buffer of rejected ingest payloads. Every add
    bumps the ``resilience.dead_letter`` counter; the buffer keeps the most
    recent ``ALINK_DEAD_LETTER_LIMIT`` records for inspection (source,
    truncated payload repr, error)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._buf: deque = deque(maxlen=_dead_letter_limit())

    def add(self, source: str, payload: Any, error: BaseException) -> None:
        metrics.incr("resilience.dead_letter")
        rec = {
            "source": source,
            "payload": repr(payload)[:512],
            "error": f"{type(error).__name__}: {error}"[:256],
        }
        with self._lock:
            if self._buf.maxlen != _dead_letter_limit():
                self._buf = deque(self._buf, maxlen=_dead_letter_limit())
            self._buf.append(rec)
        logger.debug("dead-lettered row from %s: %s", source, rec["error"])

    def records(self) -> List[Dict[str, str]]:
        with self._lock:
            return list(self._buf)

    def drain(self) -> List[Dict[str, str]]:
        with self._lock:
            out = list(self._buf)
            self._buf.clear()
            return out

    def clear(self) -> None:
        with self._lock:
            self._buf.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._buf)


dead_letters = DeadLetterBuffer()


def resilience_summary() -> Dict[str, Any]:
    """One-call readout of every resilience counter: retries by layer,
    defusions, serial degradations, breaker trips, dead-letter volume,
    injected faults."""
    out: Dict[str, Any] = dict(metrics.counters("resilience."))
    out.update(metrics.counters("faults."))
    dropped = metrics.counter("metrics.dropped")
    if dropped:
        out["metrics.dropped"] = dropped
    out["dead_letter_buffered"] = len(dead_letters)
    return out
