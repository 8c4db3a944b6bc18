"""Pre-flight checks of the port (port of the part of
``alink_tpu.analysis.plancheck`` that the serving tier calls): the
validation mode, the last report, rule ALK110's pre-flight of a model
entering a serving fleet, and rule ALK111's pre-flight of a quantized
serving load. The reference's DAG validator (``validate_plan``,
ALK101–ALK109) waits for ROADMAP A10.
"""

from __future__ import annotations

import logging
import threading
from typing import Any, Dict, Optional, Sequence

from ..common.env import env_str
from ..common.metrics import metrics
from .diagnostics import ERROR, Report

logger = logging.getLogger("alink_tpu_torch.analysis")

_VALIDATE_ENV = "ALINK_VALIDATE_PLAN"
_MODES = ("off", "warn", "error")


def validation_mode() -> str:
    """``ALINK_VALIDATE_PLAN``: ``off`` (default — validation is opt-in),
    ``warn`` (log + count diagnostics, never fail), or ``error`` (raise on
    error-severity diagnostics). Unrecognized values read as ``off``."""
    raw = (env_str(_VALIDATE_ENV, "off") or "off").strip().lower()
    return raw if raw in _MODES else "off"


_report_lock = threading.Lock()
_last_report: Optional[Dict[str, Any]] = None
def last_plan_report() -> Optional[Dict[str, Any]]:
    """The most recent pre-flight's report dict (None before any run) —
    what ``job_report()["analysis"]`` surfaces."""
    with _report_lock:
        return dict(_last_report) if _last_report is not None else None


def _record_report(report: Report, mode: str) -> None:
    global _last_report
    metrics.incr("analysis.plan_runs")
    for d in report.diagnostics:
        metrics.incr(f"analysis.plan_{d.severity}s")
        metrics.incr(f"analysis.rule.{d.rule}")
    with _report_lock:
        _last_report = {"mode": mode, **report.to_dict()}


def preflight_quantized_load(name: str, *, policy: str, real_sample: bool,
                             band_enabled: bool, recovery: bool = False,
                             where: str = "serving.load"
                             ) -> Optional[Report]:
    """Pre-flight for quantized serving loads (**ALK111**): a load
    requesting a quantization policy with no real calibration sample
    (caller/sidecar rows — synthesized zero rows never count) or with the
    accuracy band disabled serves numerics nothing has proven. Warning
    severity by default; ``recovery=True`` (respawn/recovery loads)
    escalates to error, refusing the load under
    ``ALINK_VALIDATE_PLAN=error``. ``off`` skips, findings are counted, a
    validator crash is counted and never propagated."""
    from ..common.exceptions import AkPlanValidationException

    mode = validation_mode()
    if mode == "off":
        return None
    report = Report(engine="plan", target="ModelServer")
    try:
        problems = []
        if not real_sample:
            problems.append("no real calibration sample (caller or "
                            "sidecar rows)")
        if not band_enabled:
            problems.append("the accuracy-band gate is disabled")
        if problems:
            report.add(
                "ALK111",
                f"model {name!r} requests precision={policy} with "
                f"{' and '.join(problems)} — the quantized numerics "
                "would serve unproven",
                where=f"serving:{name}",
                severity=ERROR if recovery else "",
                hint="pass real warmup_rows to ModelServer.load (they "
                     "seed calibration AND the accuracy gate), or keep "
                     "quant_band/quant_tol >= 0")
    except Exception as e:
        metrics.incr("analysis.validator_errors")
        logger.debug("quantized-load pre-flight failed at %s: %r", where, e)
        return None
    _record_report(report, mode)
    if report.diagnostics:
        logger.warning("plan validation (%s, %s):\n%s",
                       where, mode, report.render())
    if mode == "error" and report.errors():
        raise AkPlanValidationException(report)
    return report


def preflight_fleet_models(models: Sequence, *, recovery: bool = False,
                           where: str = "fleet.load"
                           ) -> Optional[Report]:
    """Pre-flight for models entering a serving fleet (**ALK110**):
    each ``(name, path)`` must carry a readable ``.ak.warmup.json``
    sidecar, or a respawned replica would silently fall back to
    trace-on-first-traffic bring-up. Warning severity by default;
    ``recovery=True`` (a fleet that respawns replicas — the production
    shape) escalates to error, refusing the load under
    ``ALINK_VALIDATE_PLAN=error``. Same conventions as
    :func:`preflight_quantized_load`: ``off`` skips, findings are counted,
    a validator crash is counted and never propagated."""
    from ..common.exceptions import AkPlanValidationException

    mode = validation_mode()
    if mode == "off":
        return None
    report = Report(engine="plan", target="ServingFleet")
    try:
        from ..serving.warmup_store import load_warmup_spec

        for name, path in models:
            spec = load_warmup_spec(path) if isinstance(path, str) else None
            if spec is None:
                report.add(
                    "ALK110",
                    f"model {name!r} ({path}) has no readable warmup "
                    "sidecar — a respawned replica would warm from live "
                    "traffic instead of disk, tracing on its first "
                    "requests",
                    where=f"fleet:{name}",
                    severity=ERROR if recovery else "",
                    hint="persist one by loading the model through "
                         "ModelServer.load(..., persist_warmup=True) "
                         "once, or write it with "
                         "serving.save_warmup_spec()")
    except Exception as e:
        metrics.incr("analysis.validator_errors")
        logger.debug("fleet pre-flight failed at %s: %r", where, e)
        return None
    _record_report(report, mode)
    if report.diagnostics:
        logger.warning("plan validation (%s, %s):\n%s",
                       where, mode, report.render())
    if mode == "error" and report.errors():
        raise AkPlanValidationException(report)
    return report
