"""Exception hierarchy with error-code semantics.

A copy of ``alink_tpu.common.exceptions``: the port keeps its own, so that it imports nothing
of the JAX package.

Capability parity with the reference's ``common/exceptions`` package
(``AkIllegalOperationException`` etc., reference: core/src/main/java/com/alibaba/alink/
common/exceptions/), re-expressed as a small Python hierarchy.

On top of the reference's code taxonomy this module adds the
retryable/fatal classification the resilience layer
(``common/resilience.py``) keys every policy decision on: the reference
delegates transient-failure handling to Flink's task-retry machinery,
while here :func:`is_retryable` is the single place that decides whether
an error is worth another attempt — framework code never pattern-matches
exception text at call sites.
"""

from __future__ import annotations


class AkException(Exception):
    """Base for all framework errors; carries a stable error code."""

    code = "AK_ERROR"

    def __init__(self, message: str = ""):
        super().__init__(f"[{self.code}] {message}")
        self.message = message


class AkIllegalArgumentException(AkException, ValueError):
    code = "AK_ILLEGAL_ARGUMENT"


class AkIllegalOperationException(AkException):
    code = "AK_ILLEGAL_OPERATION"


class AkIllegalDataException(AkException):
    code = "AK_ILLEGAL_DATA"


class AkIllegalStateException(AkException):
    code = "AK_ILLEGAL_STATE"


class AkColumnNotFoundException(AkException, KeyError):
    code = "AK_COLUMN_NOT_FOUND"


class AkUnsupportedOperationException(AkException, NotImplementedError):
    code = "AK_UNSUPPORTED_OPERATION"


class AkExecutionErrorException(AkException):
    """Analog of AkFlinkExecutionErrorException: failure while running the DAG."""

    code = "AK_EXECUTION_ERROR"


class AkUnclassifiedErrorException(AkException):
    code = "AK_UNCLASSIFIED"


class AkParseErrorException(AkException):
    code = "AK_PARSE_ERROR"


class AkPluginNotExistException(AkException):
    code = "AK_PLUGIN_NOT_EXIST"


class AkRetryableException(AkException):
    """Transient by contract: callers may retry under a
    :class:`~alink_tpu.common.resilience.RetryPolicy`. Connectors raise (or
    wrap into) this for timeouts, throttling, and flaky transport."""

    code = "AK_RETRYABLE"


class AkCircuitOpenException(AkRetryableException):
    """A circuit breaker is open for the target endpoint: the call was
    rejected without being attempted. Retryable — the breaker half-opens
    after its reset timeout."""

    code = "AK_CIRCUIT_OPEN"


class AkServingOverloadException(AkRetryableException):
    """The serving tier shed this request at admission: the target model's
    bounded queue is past its high-water mark. Retryable by contract —
    the client should back off and resubmit (HTTP surface: 429)."""

    code = "AK_SERVING_OVERLOAD"


class AkPlanValidationException(AkIllegalOperationException):
    """The pre-flight plan validator (``ALINK_VALIDATE_PLAN=error``) found
    error-severity diagnostics: the deferred DAG would fail (or silently
    misbehave) once a kernel traces. ``.report`` carries the structured
    :class:`~alink_tpu.analysis.diagnostics.Report`."""

    code = "AK_PLAN_VALIDATION"

    def __init__(self, report):
        self.report = report
        errors = report.errors() if hasattr(report, "errors") else []
        summary = "; ".join(str(d) for d in errors[:5]) or str(report)
        super().__init__(
            f"plan validation failed ({len(errors)} error(s)): {summary}")


class AkDeadlineExceededException(AkException):
    """The caller's deadline expired before the work completed. NOT
    retryable — the budget is spent; resubmitting with a fresh deadline is
    a caller decision (HTTP surface: 504)."""

    code = "AK_DEADLINE_EXCEEDED"


# OSError subclasses that signal a *state* problem, not a transient one —
# retrying "file not found" only burns the deadline budget
_NON_TRANSIENT_OS = (
    FileNotFoundError, PermissionError, IsADirectoryError,
    NotADirectoryError, FileExistsError,
)

# status keywords XLA/jax runtime errors carry when the device, transfer
# tunnel, or compile service hiccuped (vs. genuine program errors like
# INVALID_ARGUMENT shape mismatches)
_TRANSIENT_XLA_MARKERS = (
    "RESOURCE_EXHAUSTED", "UNAVAILABLE", "DEADLINE_EXCEEDED", "ABORTED",
    "CANCELLED", "CONNECTION RESET", "SOCKET CLOSED", "TRANSFER",
)


# PyTorch raises no XlaRuntimeError: its device errors are RuntimeErrors
# (torch.OutOfMemoryError, torch.AcceleratorError) whose messages carry the
# CUDA error. Out of memory is the XLA RESOURCE_EXHAUSTED of the card: the
# allocation may fit once other work frees memory. These errors are sticky
# instead: the CUDA context is unusable after them, and every later call in
# the process fails, so a retry cannot succeed.
_STICKY_CUDA_MARKERS = (
    "ILLEGAL MEMORY ACCESS", "ILLEGAL ADDRESS", "DEVICE-SIDE ASSERT",
    "UNSPECIFIED LAUNCH FAILURE", "ILLEGAL INSTRUCTION", "MISALIGNED ADDRESS",
    "HARDWARE STACK ERROR", "UNCORRECTABLE ECC ERROR", "LAUNCH TIMED OUT",
)
_TRANSIENT_CUDA_MARKERS = ("OUT OF MEMORY",)


def _torch_device_retryable(exc: BaseException) -> "bool | None":
    """True for a PyTorch out-of-memory error, False for a sticky CUDA
    error, None for anything else (the types are looked up by name: they
    moved between torch releases)."""
    if not isinstance(exc, RuntimeError):
        return None
    import torch

    msg = str(exc).upper()
    if any(m in msg for m in _STICKY_CUDA_MARKERS):
        return False
    oom = tuple(t for t in (getattr(torch, "OutOfMemoryError", None),
                            getattr(torch.cuda, "OutOfMemoryError", None))
                if isinstance(t, type))
    if (oom and isinstance(exc, oom)) \
            or any(m in msg for m in _TRANSIENT_CUDA_MARKERS):
        return True
    return None


def mark_retryable(exc: BaseException) -> BaseException:
    """Tag any exception instance as retryable without changing its type
    (for call sites that know a specific library error is transient)."""
    exc.__alink_retryable__ = True  # type: ignore[attr-defined]
    return exc


def is_retryable(exc: BaseException) -> bool:
    """Central transient/fatal classification. True for errors worth a
    backed-off retry: explicit :class:`AkRetryableException`, exceptions
    tagged via :func:`mark_retryable`, connector client errors that declare
    themselves retriable (kafka-python's ``KafkaError.retriable``),
    timeouts/connection drops/transient OS errors, XLA runtime errors
    whose status marks a device/transfer hiccup, and PyTorch's out-of-memory
    errors (the card's ``RESOURCE_EXHAUSTED``). Everything else — in
    particular every other classified ``Ak*`` error, and a sticky CUDA
    error such as an illegal memory access — is fatal."""
    if isinstance(exc, AkRetryableException):
        return True
    if getattr(exc, "__alink_retryable__", False):
        return True
    if getattr(exc, "retriable", False):  # kafka-python KafkaError contract
        return True
    if isinstance(exc, AkException):
        return False  # deliberately classified: arguments, state, data, ...
    if isinstance(exc, (KeyboardInterrupt, SystemExit, GeneratorExit)):
        return False
    if isinstance(exc, (TimeoutError, ConnectionError)):
        return True
    if isinstance(exc, OSError):
        return not isinstance(exc, _NON_TRANSIENT_OS)
    # concurrent.futures.TimeoutError stopped aliasing the builtin only on
    # old interpreters; match by name to stay version-agnostic, and catch
    # XLA runtime faults (jaxlib raises XlaRuntimeError for both program
    # bugs and infrastructure hiccups — only the latter statuses retry)
    name = type(exc).__name__
    if name == "TimeoutError":
        return True
    if name == "XlaRuntimeError":
        msg = str(exc).upper()
        return any(m in msg for m in _TRANSIENT_XLA_MARKERS)
    return bool(_torch_device_retryable(exc))


class AkPreconditions:
    """Guard helpers mirroring the reference's AkPreconditions."""

    @staticmethod
    def check_state(condition: bool, message: str = "illegal state"):
        if not condition:
            raise AkIllegalStateException(message)

    @staticmethod
    def check_argument(condition: bool, message: str = "illegal argument"):
        if not condition:
            raise AkIllegalArgumentException(message)

    @staticmethod
    def check_not_null(value, message: str = "value is null"):
        if value is None:
            raise AkIllegalArgumentException(message)
        return value
