"""Static analysis layer of the port (``alink_tpu.analysis``): the
diagnostic model, the plan validator for batch DAGs and pipelines
(``validate_plan``/``preflight``: ALK101–ALK103, ALK105, ALK106), the
fleet-model pre-flight (ALK110) and the quantized-load pre-flight (ALK111).
The stream rules (ALK104, ALK107, ALK109) wait for ROADMAP A7; the source
linter for A10."""

from .diagnostics import (  # noqa: F401
    ERROR, INFO, RULES, WARNING, Diagnostic, Report)
from .plancheck import (  # noqa: F401
    last_plan_report,
    preflight,
    preflight_fleet_models,
    preflight_quantized_load,
    suppress_preflight,
    validate_plan,
    validation_mode,
)
