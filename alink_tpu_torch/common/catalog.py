"""Reflection catalog of the port's public operators (port of
``alink_tpu.common.catalog``: ``list_operators``, ``params_of``,
``port_specs``, ``op_info``; the docs and stub generators are not ported).

Capability parity with the reference's operator metadata stack (reference:
core/src/main/java/com/alibaba/alink/common/annotation/
PublicOperatorUtils.java:24-62, PortSpec.java / InputPorts / OutputPorts).
Operators are Python classes, so the catalog reflects over the live
registry; port specs derive from the operator contracts themselves
(_min_inputs/_max_inputs, ModelTrainOpMixin, ModelMapBatchOp). The WebUI's
``/api/ops`` endpoints read it.
"""

from __future__ import annotations

import inspect
from typing import Dict, List

from .params import ParamInfo


def _op_modules():
    from ..operator import batch as batch_mod
    from ..operator import stream as stream_mod

    return {"batch": batch_mod, "stream": stream_mod}


def list_operators() -> Dict[str, List[type]]:
    """Public operator classes by flavor (reference:
    PublicOperatorUtils.listOperators)."""
    out: Dict[str, List[type]] = {}
    for flavor, mod in _op_modules().items():
        ops = []
        for name in sorted(dir(mod)):
            obj = getattr(mod, name)
            if (inspect.isclass(obj) and name.endswith(("Op",))
                    and not name.startswith("_")):
                ops.append(obj)
        out[flavor] = ops
    return out


def params_of(cls: type) -> List[ParamInfo]:
    """All ParamInfo descriptors reachable on the class (incl. mixins),
    deduped by param name."""
    seen: Dict[str, ParamInfo] = {}
    for klass in cls.__mro__:
        for attr, v in vars(klass).items():
            if isinstance(v, ParamInfo) and v.name not in seen:
                seen[v.name] = v
    return sorted(seen.values(), key=lambda p: p.name)


def port_specs(cls: type) -> Dict[str, List[str]]:
    """Input/output port types derived from the operator contract
    (reference: @InputPorts/@OutputPorts/@PortSpec annotations)."""
    from ..operator.batch.utils import ModelMapBatchOp, ModelTrainOpMixin

    min_in = getattr(cls, "_min_inputs", 1) or 0
    max_in = getattr(cls, "_max_inputs", 1)  # None = unbounded
    if issubclass(cls, ModelMapBatchOp):
        inputs = ["MODEL", "DATA"]
    elif max_in == 0:
        inputs = []
    else:
        inputs = ["DATA"] * max(min_in, 1)
        if max_in is None:
            inputs.append("DATA*")
        elif max_in > min_in:
            inputs.append(f"... up to {max_in}")
    outputs = ["MODEL" if issubclass(cls, ModelTrainOpMixin) else "DATA"]
    return {"inputs": inputs, "outputs": outputs}


def op_info(cls: type) -> Dict:
    """Structured metadata for one operator — the WebUI-form / docs payload."""
    ps = []
    for p in params_of(cls):
        ps.append({
            "name": p.name,
            "type": getattr(p.value_type, "__name__", str(p.value_type)),
            "optional": bool(p.optional or p.has_default),
            "default": p.default if p.has_default else None,
            "aliases": list(p.aliases),
            "desc": p.desc or "",
        })
    doc = inspect.getdoc(cls) or ""
    return {
        "name": cls.__name__,
        "module": cls.__module__,
        "doc": doc,
        "ports": port_specs(cls),
        "params": ps,
    }
