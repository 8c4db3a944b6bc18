"""Diagnostic/report model of the static-analysis layer (port of the part of
``alink_tpu.analysis.diagnostics`` that rule ALK111 needs). The report dict
keeps the reference's keys for what it carries; the file:line locations,
the info severity and the ordering of the source linter's findings come
back with the other rules of ROADMAP A10.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List

ERROR = "error"
WARNING = "warning"

# rule id -> (default severity, one-line description), the reference's
# entries for the rules the port checks
RULES: Dict[str, tuple] = {
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

    def to_dict(self) -> Dict[str, Any]:
        by_rule: Dict[str, int] = {}
        for d in self.diagnostics:
            by_rule[d.rule] = by_rule.get(d.rule, 0) + 1
        return {
            "engine": self.engine,
            "target": self.target,
            "counts": {"total": len(self.diagnostics),
                       "error": len(self.errors()),
                       "warning": len(self.diagnostics) - len(self.errors())},
            "by_rule": by_rule,
            "diagnostics": [d.to_dict() for d in self.diagnostics],
        }

    def render(self) -> str:
        return "\n".join([str(d) for d in self.diagnostics]
                         + [f"{len(self.diagnostics)} finding(s), "
                            f"{len(self.errors())} error(s)"])
