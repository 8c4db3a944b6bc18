"""Backpressure-driven scaling decisions (port of the part of
``alink_tpu.common.elastic`` that the serving fleet's autoscaler runs:
:class:`BackpressureController`, copied).

The reference's elastic streaming job (``ElasticStreamJob``,
``ElasticCoordinator``, key groups and keyed-state redistribution) drives
the same controller at epoch barriers; it waits for ROADMAP A7.
"""

from __future__ import annotations

import logging
from typing import Any, Callable, Dict, List, Optional, Tuple

from .exceptions import AkIllegalArgumentException
from .metrics import metrics

logger = logging.getLogger("alink_tpu_torch.elastic")


class BackpressureController:
    """Turns the epoch-level backpressure signal into rescale decisions.

    Signal: seconds-per-chunk this epoch vs ``target_chunk_s`` — the
    arrival interval the stream must keep up with (a live source's poll
    period; for drills, a calibrated baseline). The derived
    ``stream.lag_s`` gauge (seconds fallen behind per epoch) exports at
    ``GET /metrics``.

    Decision rules, in order:

    - hysteresis band: ratio in ``(low, high)`` resets both streaks — no
      decision. ``ratio >= high`` for ``patience`` consecutive epochs →
      scale OUT (×``scale_factor``); ``ratio <= low`` for ``patience``
      epochs → scale IN (÷``scale_factor``).
    - cooldown: no new decision within ``cooldown_epochs`` of the last one
      (a rescale changes the signal; judging the new parallelism on
      pre-rescale epochs would thrash).
    - flap breaker: more than ``max_flips`` direction reversals inside
      ``flap_window`` epochs opens the breaker for the rest of the run —
      the job degrades to fixed parallelism (each suppressed decision
      counts ``recovery.rescale_aborted``) instead of oscillating.

    ``lag_fn(stats)`` overrides the wall-clock signal with an external
    one — a real deployment's queue depth, or a scripted schedule in
    deterministic tests.
    """

    def __init__(self, target_chunk_s: float, *, high: float = 1.5,
                 low: float = 0.5, patience: int = 2,
                 cooldown_epochs: int = 2, scale_factor: int = 2,
                 flap_window: int = 16, max_flips: int = 4,
                 lag_fn: Optional[Callable[[Dict[str, Any]], float]] = None):
        if not (0 <= low < high):
            raise AkIllegalArgumentException(
                f"need 0 <= low < high, got low={low} high={high}")
        self.target_chunk_s = float(target_chunk_s)
        self.high, self.low = float(high), float(low)
        self.patience = max(1, int(patience))
        self.cooldown_epochs = max(0, int(cooldown_epochs))
        self.scale_factor = max(2, int(scale_factor))
        self.flap_window = max(1, int(flap_window))
        self.max_flips = max(1, int(max_flips))
        self.lag_fn = lag_fn
        self.breaker_open = False
        self._hot = 0
        self._cold = 0
        self._last_decision_epoch: Optional[int] = None
        self._decisions: List[Tuple[int, int]] = []  # (epoch, direction)

    def lag_seconds(self, stats: Dict[str, Any]) -> float:
        if self.lag_fn is not None:
            return float(self.lag_fn(stats))
        chunks = max(1, int(stats.get("chunks") or 1))
        return max(0.0, float(stats["wall_s"])
                   - self.target_chunk_s * chunks)

    def observe(self, stats: Dict[str, Any]) -> Optional[int]:
        """Feed one epoch's stats ({epoch, wall_s, chunks, parallelism});
        returns a target parallelism, or None for no change."""
        epoch = int(stats["epoch"])
        p = int(stats["parallelism"])
        lag = self.lag_seconds(stats)
        metrics.set_gauge("stream.lag_s", lag)
        chunks = max(1, int(stats.get("chunks") or 1))
        if self.lag_fn is not None:
            # an injected signal expresses pressure directly as lag
            ratio = 1.0 + lag / max(self.target_chunk_s * chunks, 1e-9) \
                if lag > 0 else 0.0
        else:
            per_chunk = float(stats["wall_s"]) / chunks
            ratio = per_chunk / self.target_chunk_s \
                if self.target_chunk_s > 0 else 0.0
        if ratio >= self.high:
            self._hot += 1
            self._cold = 0
        elif ratio <= self.low:
            self._cold += 1
            self._hot = 0
        else:
            self._hot = self._cold = 0
        direction = 0
        if self._hot >= self.patience:
            direction = 1
        elif self._cold >= self.patience:
            direction = -1
        if direction == 0:
            return None
        if self.breaker_open:
            metrics.incr("recovery.rescale_aborted")
            return None
        if (self._last_decision_epoch is not None
                and epoch - self._last_decision_epoch
                < self.cooldown_epochs):
            return None  # cooldown: streaks keep counting, decision waits
        target = p * self.scale_factor if direction > 0 \
            else max(1, p // self.scale_factor)
        # respect the job's parallelism bounds (the coordinator passes
        # them in the stats) BEFORE recording anything: a decision the
        # bounds reduce to a no-op must not pollute the flap history
        lo = int(stats.get("min_parallelism") or 1)
        hi = int(stats.get("max_parallelism") or (1 << 30))
        target = min(max(target, lo), hi)
        if target == p:
            # already at the floor: a no-op "decision" must not feed the
            # flap history or the aborted counter — an idle job parked at
            # min parallelism is healthy, not thrashing
            self._hot = self._cold = 0
            return None
        recent = [d for e, d in self._decisions
                  if epoch - e <= self.flap_window] + [direction]
        flips = sum(1 for a, b in zip(recent, recent[1:]) if a != b)
        if flips >= self.max_flips:
            self.breaker_open = True
            metrics.incr("recovery.rescale_aborted")
            logger.warning(
                "backpressure breaker OPEN: %d direction flips within %d "
                "epochs — degrading to fixed parallelism %d",
                flips, self.flap_window, p)
            return None
        self._decisions.append((epoch, direction))
        # only the flap window's suffix is ever read — a long-lived job
        # must not grow the history without bound
        if len(self._decisions) > 4 * self.max_flips:
            del self._decisions[:-4 * self.max_flips]
        self._last_decision_epoch = epoch
        self._hot = self._cold = 0
        return target
