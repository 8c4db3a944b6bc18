"""Serving precision policies (the request-parsing part of
``alink_tpu/common/quant.py``).

The reference serves a model at ``fp32``, ``bf16`` or ``int8``, chosen by the
``inferencePrecision`` op parameter. The port serves fp32 only: the quantized
policies raise until they are ported (ROADMAP A2, A9).
"""

from __future__ import annotations

from typing import Optional

from .exceptions import (AkIllegalArgumentException,
                         AkUnsupportedOperationException)

FP32, BF16, INT8 = "fp32", "bf16", "int8"
PRECISIONS = (FP32, BF16, INT8)

# the op parameter a mapper reads its policy from
PRECISION_KEY = "inferencePrecision"


def resolve_precision(precision) -> Optional[str]:
    """None/""/"fp32" -> None (the parameters as stored); "bf16" and
    "int8" are the reference's quantized-serving policies, not ported yet;
    anything else raises."""
    if precision is None or precision == "":
        return None
    p = str(precision).lower()
    if p not in PRECISIONS:
        raise AkIllegalArgumentException(
            f"unknown precision {precision!r}; choose one of {PRECISIONS}")
    if p != FP32:
        raise AkUnsupportedOperationException(
            f"serving precision {p!r} is not ported yet")
    return None


def policy_of(params) -> Optional[str]:
    """The policy stamped on a mapper's params (see
    :func:`resolve_precision`), None when unset."""
    if params is None or not params.contains(PRECISION_KEY):
        return None
    return resolve_precision(params.get(PRECISION_KEY))
