"""Static analysis layer of the port (``alink_tpu.analysis``): the
diagnostic model and the quantized-load pre-flight, rule ALK111. The plan
validator's other rules and the source linter wait for ROADMAP A10."""

from .diagnostics import ERROR, RULES, WARNING, Diagnostic, Report  # noqa: F401
from .plancheck import (  # noqa: F401
    last_plan_report,
    preflight_quantized_load,
    validation_mode,
)
