"""Lazy evaluation of deferred sinks.

A copy of ``alink_tpu.common.lazy``: the port keeps its own, so that it imports nothing
of the JAX package.

Capability parity with the reference's lazy subsystem (reference:
core/src/main/java/com/alibaba/alink/common/lazy/LazyObjectsManager.java,
LazyEvaluation.java; trigger at operator/batch/BatchOperator.java:688-725):
``lazyPrint``/``lazyCollect`` register callbacks against an operator's future
result; one ``execute()`` evaluates the whole pending DAG and fires every
callback. Here evaluation is pull-based host execution rather than one Flink
job, but the user-visible contract (nothing runs until execute/collect; all
pending lazy sinks fire together) is identical.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List


class LazyEvaluation:
    """A future-like holder with callbacks (reference: common/lazy/LazyEvaluation.java)."""

    def __init__(self):
        self._value: Any = None
        self._filled = False
        self._callbacks: List[Callable[[Any], None]] = []

    def add_callback(self, cb: Callable[[Any], None]):
        if self._filled:
            cb(self._value)
        else:
            self._callbacks.append(cb)

    def add_value(self, value):
        self._value = value
        self._filled = True
        for cb in self._callbacks:
            cb(value)
        self._callbacks.clear()

    @property
    def value(self):
        if not self._filled:
            raise RuntimeError("lazy value not yet evaluated")
        return self._value


class LazyObjectsManager:
    """Per-session registry of pending lazy sinks keyed by operator identity
    (reference: common/lazy/LazyObjectsManager.java)."""

    def __init__(self):
        self._lazy_ops: Dict[int, Any] = {}
        self._evals: Dict[int, LazyEvaluation] = {}

    def gen_lazy(self, op) -> LazyEvaluation:
        key = id(op)
        if key not in self._evals:
            self._evals[key] = LazyEvaluation()
            self._lazy_ops[key] = op
        return self._evals[key]

    def pending_ops(self) -> List[Any]:
        return list(self._lazy_ops.values())

    def fill(self, op, value):
        key = id(op)
        if key in self._evals:
            self._evals[key].add_value(value)
            del self._evals[key]
            del self._lazy_ops[key]

    def clear(self):
        self._evals.clear()
        self._lazy_ops.clear()
