"""Mid-training checkpoint/resume and retry-based failure recovery (port of
``alink_tpu/dl/checkpoint.py``).

A checkpoint is one ``torch.save`` file per step, ``step_<N>.pt`` under the
run's directory, holding the parameters (a host state dict), the optimizer
state (:meth:`~alink_tpu_torch.dl.train.Optimizer.state_dict`) and
``extra`` (progress counters). The reference writes orbax checkpoints; the
format differs by design (the port carries no orbax), and the two packages
do not read each other's. Retention, ``latest_step``, ``restore_latest``
and ``run_with_retries`` keep the reference's contract.
"""

from __future__ import annotations

import os
import re
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from ..common.env import env_int

_STEP_FILE = re.compile(r"^step_(\d+)\.pt$")


class TrainCheckpointManager:
    """One training run's checkpoints in ``directory``.

    Retention is bounded: only the last ``max_to_keep`` checkpoints stay on
    disk (older steps are pruned at save time). ``max_to_keep=None`` reads
    ``ALINK_CKPT_KEEP`` (default 3); a value <= 0 keeps every checkpoint."""

    def __init__(self, directory: str, max_to_keep: "int | None" = None):
        if max_to_keep is None:
            max_to_keep = env_int("ALINK_CKPT_KEEP", 3)
        self.max_to_keep = max_to_keep if max_to_keep > 0 else None
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{int(step)}.pt")

    def save(self, step: int, params, opt_state, extra: Dict[str, Any]):
        """Persists the training state at ``step`` (written to a temporary
        file, then renamed); prunes past the retention bound. Each save
        counts in ``train.ckpt_saves``."""
        from ..common.metrics import metrics

        tmp = self._path(step) + ".tmp"
        torch.save({"params": params, "opt_state": opt_state,
                    "extra": dict(extra)}, tmp)
        os.replace(tmp, self._path(step))
        if self.max_to_keep is not None:
            for old in self.all_steps()[:-self.max_to_keep]:
                os.remove(self._path(old))
        metrics.incr("train.ckpt_saves")

    def all_steps(self) -> List[int]:
        """The step numbers retained on disk, ascending."""
        return sorted(int(m.group(1)) for f in os.listdir(self.directory)
                      if (m := _STEP_FILE.match(f)))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore_latest(self) -> Optional[Tuple[Any, Any, Dict[str, Any]]]:
        """``(params, opt_state, extra)`` of the newest checkpoint, on the
        host, or None when there is none (``torch.load`` restores the saved
        structure: the reference's structure targets are not needed, and
        every ``extra`` key round-trips, such as the pretraining loop's
        ``mid_epoch``, ``next_batch`` and ``step``)."""
        step = self.latest_step()
        if step is None:
            return None
        state = torch.load(self._path(step), map_location="cpu",
                           weights_only=True)
        return state["params"], state["opt_state"], state["extra"]


def run_with_retries(fn: Callable[[], Any], retries: int = 3,
                     on_failure: Optional[Callable[[Exception, int], None]]
                     = None) -> Any:
    """Run ``fn``, retrying on failure (reference: ApsEnv.java RETRY_TIMES).
    With checkpointing on, a retried attempt resumes from the latest
    persisted state rather than from scratch."""
    for attempt in range(retries + 1):
        try:
            return fn()
        except Exception as e:  # noqa: BLE001 — the recovery boundary
            if on_failure is not None:
                on_failure(e, attempt)
            if attempt == retries:
                raise
