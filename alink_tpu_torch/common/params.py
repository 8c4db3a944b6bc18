"""Typed parameter system.

A copy of ``alink_tpu.common.params``: the port keeps its own, so that it imports nothing
of the JAX package.

Capability parity with the reference's ``params/`` tree (1,130 ``HasXxx`` interfaces of
``ParamInfo<T>`` constants with defaults, validators, and aliases — e.g.
reference: core/src/main/java/com/alibaba/alink/params/shared/linear/HasL1.java:14-24,
params/validators/MinValidator.java), collapsed into Python descriptors:

- :class:`ParamInfo` — a typed, named parameter with optional default, validator, alias list
  and human descriptions (``name_cn``/``name_en`` kept for docs/WebUI parity).
- :class:`Params` — a validated key→value bag with alias resolution and JSON round-trip.
- :class:`WithParams` — mixin giving operators/pipeline-stages ``get``/``set`` and
  fluent ``set_<name>`` accessors.

Unlike the Java reference there is no codegen: ParamInfo descriptors declared on an
operator class (or inherited mixin classes, mirroring the HasXxx interfaces) are
discovered by reflection over the MRO.
"""

from __future__ import annotations

import json
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, Tuple, Type

from .exceptions import AkIllegalArgumentException

# ---------------------------------------------------------------------------
# Validators (reference: params/validators/)
# ---------------------------------------------------------------------------


class Validator:
    def validate(self, value) -> bool:  # pragma: no cover - interface
        return True

    def describe(self) -> str:
        return "any"

    def check(self, name: str, value):
        if not self.validate(value):
            raise AkIllegalArgumentException(
                f"param '{name}' value {value!r} violates constraint: {self.describe()}"
            )


class MinValidator(Validator):
    def __init__(self, min_value, inclusive: bool = True):
        self.min_value, self.inclusive = min_value, inclusive

    def validate(self, value):
        return value >= self.min_value if self.inclusive else value > self.min_value

    def describe(self):
        return f">{'=' if self.inclusive else ''} {self.min_value}"


class MaxValidator(Validator):
    def __init__(self, max_value, inclusive: bool = True):
        self.max_value, self.inclusive = max_value, inclusive

    def validate(self, value):
        return value <= self.max_value if self.inclusive else value < self.max_value

    def describe(self):
        return f"<{'=' if self.inclusive else ''} {self.max_value}"


class RangeValidator(Validator):
    def __init__(self, lo, hi, left_inclusive=True, right_inclusive=True):
        self.lo, self.hi = lo, hi
        self.left_inclusive, self.right_inclusive = left_inclusive, right_inclusive

    def validate(self, value):
        ok_lo = value >= self.lo if self.left_inclusive else value > self.lo
        ok_hi = value <= self.hi if self.right_inclusive else value < self.hi
        return ok_lo and ok_hi

    def describe(self):
        l = "[" if self.left_inclusive else "("
        r = "]" if self.right_inclusive else ")"
        return f"in {l}{self.lo}, {self.hi}{r}"


class InValidator(Validator):
    """Value must be one of an allowed set (reference: ParamValidators.inArray)."""

    def __init__(self, *allowed):
        self.allowed = allowed

    def validate(self, value):
        return value in self.allowed

    def describe(self):
        return f"one of {list(self.allowed)}"


class ArrayLengthValidator(Validator):
    def __init__(self, min_len=0, max_len=None):
        self.min_len, self.max_len = min_len, max_len

    def validate(self, value):
        n = len(value)
        return n >= self.min_len and (self.max_len is None or n <= self.max_len)

    def describe(self):
        return f"length in [{self.min_len}, {self.max_len or 'inf'}]"


class NotNullValidator(Validator):
    def validate(self, value):
        return value is not None

    def describe(self):
        return "not null"


# ---------------------------------------------------------------------------
# ParamInfo
# ---------------------------------------------------------------------------

_UNSET = object()


class ParamInfo:
    """A typed parameter definition (reference: ParamInfoFactory chain,
    e.g. params/shared/linear/HasL1.java:14-24).

    Declared as plain UPPER_CASE class attributes on :class:`WithParams`
    subclasses; value reads go through ``WithParams.__getattr__``
    (``op.l1``), while ``LR.L1`` is the ParamInfo itself.
    """

    def __init__(
        self,
        name: str,
        value_type: Optional[type] = None,
        *,
        desc: str = "",
        has_default: bool = False,
        default: Any = _UNSET,
        optional: bool = True,
        validator: Optional[Validator] = None,
        aliases: Sequence[str] = (),
        name_cn: str = "",
    ):
        self.name = name
        self.value_type = value_type
        self.desc = desc
        self.has_default = has_default or default is not _UNSET
        self.default = None if default is _UNSET else default
        self.optional = optional
        self.validator = validator
        self.aliases = tuple(aliases)
        self.name_cn = name_cn

    def validate(self, value):
        if value is None:
            if not self.optional and not self.has_default:
                raise AkIllegalArgumentException(f"param '{self.name}' must not be None")
            return
        if self.value_type is not None and self.value_type in (int, float, str, bool):
            if self.value_type is float and isinstance(value, int):
                pass  # int→float widening ok
            elif not isinstance(value, self.value_type) or (
                self.value_type is not bool and isinstance(value, bool)
            ):
                raise AkIllegalArgumentException(
                    f"param '{self.name}' expects {self.value_type.__name__}, "
                    f"got {type(value).__name__}: {value!r}"
                )
        if self.validator is not None:
            self.validator.check(self.name, value)

    def __repr__(self):
        return f"ParamInfo({self.name!r})"


# ---------------------------------------------------------------------------
# Params bag
# ---------------------------------------------------------------------------


class Params:
    """Validated parameter bag with alias resolution and JSON round-trip
    (reference: org.apache.flink.ml.api.misc.param.Params as used throughout)."""

    def __init__(self, **kwargs):
        self._map: Dict[str, Any] = {}
        for k, v in kwargs.items():
            self._map[k] = v

    # -- core --------------------------------------------------------------
    def set(self, info: "ParamInfo | str", value) -> "Params":
        if isinstance(info, ParamInfo):
            info.validate(value)
            self._map[info.name] = value
        else:
            self._map[info] = value
        return self

    def get(self, info: "ParamInfo | str"):
        if isinstance(info, ParamInfo):
            for key in (info.name, *info.aliases):
                if key in self._map:
                    return self._map[key]
            if info.has_default:
                return info.default
            if info.optional:
                return None
            raise AkIllegalArgumentException(f"required param '{info.name}' is not set")
        return self._map[info]

    def contains(self, info: "ParamInfo | str") -> bool:
        if isinstance(info, ParamInfo):
            return any(k in self._map for k in (info.name, *info.aliases))
        return info in self._map

    def remove(self, info: "ParamInfo | str"):
        if isinstance(info, ParamInfo):
            for key in (info.name, *info.aliases):
                self._map.pop(key, None)
        else:
            self._map.pop(info, None)
        return self

    def merge(self, other: "Params") -> "Params":
        self._map.update(other._map)
        return self

    def clone(self) -> "Params":
        p = Params()
        p._map = dict(self._map)
        return p

    def keys(self):
        return self._map.keys()

    def items(self) -> Iterator[Tuple[str, Any]]:
        return iter(self._map.items())

    def __len__(self):
        return len(self._map)

    def __eq__(self, other):
        return isinstance(other, Params) and self._map == other._map

    def __repr__(self):
        return f"Params({self._map})"

    # -- json --------------------------------------------------------------
    def to_json(self) -> str:
        return json.dumps(self._map, sort_keys=True, default=str)

    @staticmethod
    def from_json(s: str) -> "Params":
        p = Params()
        p._map = json.loads(s)
        return p


# ---------------------------------------------------------------------------
# WithParams mixin
# ---------------------------------------------------------------------------


def _camel(name: str) -> str:
    parts = name.split("_")
    return parts[0] + "".join(w.title() for w in parts[1:])


class WithParams:
    """Mixin: fluent typed params on operators and pipeline stages.

    ``op.set(LR.MAX_ITER, 50)``, ``op.set_max_iter(50)`` (snake_case of the
    ParamInfo name), and ``op.get(LR.MAX_ITER)`` / ``op.max_iter`` all work.
    """

    def __init__(self, params: Optional[Params] = None, **kwargs):
        self._params = params.clone() if params is not None else Params()
        for k, v in kwargs.items():
            info = type(self)._resolve_info(k)
            if info is not None:
                self._params.set(info, v)
            else:
                self._params.set(k, v)

    # -- reflection over declared ParamInfo attributes --------------------
    @classmethod
    def param_infos(cls) -> Dict[str, ParamInfo]:
        cached = cls.__dict__.get("_param_infos_cache")
        if cached is not None:
            return cached
        out: Dict[str, ParamInfo] = {}
        for klass in reversed(cls.__mro__):
            for v in vars(klass).values():
                if isinstance(v, ParamInfo):
                    out.setdefault(v.name, v)
        cls._param_infos_cache = out
        return out

    @classmethod
    def _resolve_info(cls, key: str) -> Optional[ParamInfo]:
        cache = cls.__dict__.get("_resolve_cache")
        if cache is None:
            cache = cls._resolve_cache = {}
        if key in cache:
            return cache[key]
        infos = cls.param_infos()
        info = infos.get(key) or infos.get(_camel(key))
        if info is None:
            for i in infos.values():
                if key in i.aliases or _camel(key) in i.aliases:
                    info = i
                    break
        cache[key] = info
        return info

    def get_params(self) -> Params:
        return self._params

    def set(self, info: "ParamInfo | str", value):
        self._params.set(info, value)
        return self

    def get(self, info: "ParamInfo | str"):
        return self._params.get(info)

    def __getattr__(self, attr: str):
        # fluent setters: set_xxx / setXxx
        if attr.startswith("set_") or (attr.startswith("set") and attr[3:4].isupper()):
            raw = attr[4:] if attr.startswith("set_") else attr[3].lower() + attr[4:]
            info = type(self)._resolve_info(raw)
            if info is not None:
                def setter(value, _info=info):
                    self._params.set(_info, value)
                    return self
                return setter
        # value access by snake_case param name
        info = type(self)._resolve_info(attr)
        if info is not None:
            return self._params.get(info)
        raise AttributeError(f"{type(self).__name__} has no attribute {attr!r}")


def copy_param_infos(source_cls: type, target_cls: type) -> None:
    """Surface every ParamInfo of ``source_cls``'s MRO on ``target_cls``
    (shared by the stream-twin factories and alias ops so param-surfacing
    semantics live in one place)."""
    for klass in source_cls.__mro__:
        for attr, v in vars(klass).items():
            if isinstance(v, ParamInfo) and not hasattr(target_cls, attr):
                setattr(target_cls, attr, v)
