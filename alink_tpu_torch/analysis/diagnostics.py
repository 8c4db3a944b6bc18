"""Diagnostic/report model of the static-analysis layer (port of the part of
``alink_tpu.analysis.diagnostics`` that the plan rules need: ALK101–ALK106,
ALK109, ALK110, ALK111). The report dict keeps the reference's keys
and ordering (severity, then rule); the source linter's file:line locations
come back with its rules (ROADMAP A10).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List

ERROR = "error"
WARNING = "warning"
INFO = "info"

_SEV_ORDER = {ERROR: 0, WARNING: 1, INFO: 2}

# rule id -> (default severity, one-line description), the reference's
# entries for the rules the port checks
RULES: Dict[str, tuple] = {
    "ALK101": (ERROR,
               "a column named by selectedCols/featureCols/labelCol/... is "
               "absent from the upstream schema"),
    "ALK102": (ERROR,
               "a column feeding a numeric kernel has a non-numeric type "
               "(e.g. STRING in featureCols)"),
    "ALK103": (WARNING,
               "shape or key hazard: a batch size off the bucket_rows "
               "ladder, or a block-kernel closure capturing state that "
               "cannot be content-keyed"),
    "ALK104": (WARNING,
               "stateful stream op without state_snapshot/state_restore "
               "hooks — the recovery coordinator refuses it at job build"),
    "ALK105": (INFO,
               "a non-fusable op interrupts a linear mapper chain — the run "
               "splits into multiple device programs with host round trips "
               "between them"),
    "ALK106": (INFO,
               "static output schema could not be derived for a node; "
               "downstream schema checks were skipped"),
    "ALK109": (WARNING,
               "stream-train op bound to a ModelStreamPublisher without "
               "state_snapshot/state_restore hooks — after a crash the "
               "retrain diverges from the published version history, so "
               "the republish-bit-identical contract cannot hold"),
    "ALK110": (WARNING,
               "model loaded into a serving fleet without a readable "
               ".ak.warmup.json sidecar — a respawned replica would fall "
               "back to trace-on-first-traffic bring-up, breaking the "
               "fleet's zero-trace steady-state contract (error severity "
               "when the fleet respawns replicas)"),
    "ALK111": (WARNING,
               "quantized serving load without a real calibration sample "
               "or with the accuracy band disabled — int8/bf16 numerics "
               "would serve with nothing proving them against the fp32 "
               "baseline (error severity for respawn/recovery loads)"),
}


@dataclass
class Diagnostic:
    """One finding: a stable rule id, where, what, and how to fix it."""

    rule: str
    message: str
    where: str = ""
    severity: str = ""
    hint: str = ""

    def __post_init__(self):
        if not self.severity:
            self.severity = RULES.get(self.rule, (WARNING, ""))[0]

    def to_dict(self) -> Dict[str, Any]:
        return {"rule": self.rule, "severity": self.severity,
                "location": self.where, "message": self.message,
                "hint": self.hint}

    def __str__(self) -> str:
        body = f"{self.where}: {self.message}" if self.where \
            else self.message
        return f"{self.rule} [{self.severity}] {body}" + (
            f"  (fix: {self.hint})" if self.hint else "")


@dataclass
class Report:
    """The diagnostics of one engine run."""

    engine: str = "plan"
    target: str = ""
    diagnostics: List[Diagnostic] = field(default_factory=list)

    def add(self, rule: str, message: str, **kw) -> Diagnostic:
        d = Diagnostic(rule, message, **kw)
        self.diagnostics.append(d)
        return d

    def errors(self) -> List[Diagnostic]:
        return [d for d in self.diagnostics if d.severity == ERROR]

    def warnings(self) -> List[Diagnostic]:
        return [d for d in self.diagnostics if d.severity == WARNING]

    def infos(self) -> List[Diagnostic]:
        return [d for d in self.diagnostics if d.severity == INFO]

    def sorted(self) -> List[Diagnostic]:
        return sorted(self.diagnostics,
                      key=lambda d: (_SEV_ORDER.get(d.severity, 9), d.rule,
                                     d.where))

    @property
    def ok(self) -> bool:
        return not self.diagnostics

    def by_rule(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for d in self.diagnostics:
            out[d.rule] = out.get(d.rule, 0) + 1
        return out

    def to_dict(self) -> Dict[str, Any]:
        by_rule = self.by_rule()
        return {
            "engine": self.engine,
            "target": self.target,
            "counts": {"total": len(self.diagnostics),
                       "error": len(self.errors()),
                       "warning": len(self.warnings()),
                       "info": len(self.infos())},
            "by_rule": by_rule,
            "diagnostics": [d.to_dict() for d in self.sorted()],
        }

    def render(self) -> str:
        if self.ok:
            return f"{self.engine}: clean ({self.target})" if self.target \
                else f"{self.engine}: clean"
        return "\n".join([str(d) for d in self.sorted()]
                         + [f"{len(self.diagnostics)} finding(s): "
                            f"{len(self.errors())} error(s), "
                            f"{len(self.warnings())} warning(s), "
                            f"{len(self.infos())} info(s)"])
