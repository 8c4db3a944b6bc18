"""Operator DAG API (port of ``alink_tpu.operator.base``).

Capability parity with the reference's operator layer (reference:
core/src/main/java/com/alibaba/alink/operator/AlgoOperator.java:29,
operator/batch/BatchOperator.java:67 — ``link``/``linkFrom`` DAG building,
deferred execution triggered by ``execute``/``collect``, lazy sinks).

The DAG is a host-side graph of Python operator nodes over columnar
:class:`MTable` values. Evaluation is pull-based, depth-first and memoized
per node (``_executed`` under the node's ``_eval_lock``), so a shared upstream
runs once. The reference's pipelined DAG executor, plan pre-flight and SQL
sugar are not ported yet; ``collect``/``execute`` evaluate serially.
"""

from __future__ import annotations

import threading
from typing import Callable, List, Optional, Sequence

from ..common.env import MLEnvironmentFactory
from ..common.exceptions import AkIllegalOperationException
from ..common.mtable import MTable, TableSchema
from ..common.params import ParamInfo, WithParams


class AlgoOperator(WithParams):
    """Base of Batch operators: a DAG node producing one output table and
    optional side-output tables."""

    ML_ENVIRONMENT_ID = ParamInfo(
        "MLEnvironmentId", int, default=0, desc="session id of the MLEnvironment"
    )

    def __init__(self, params=None, **kwargs):
        super().__init__(params, **kwargs)
        self._inputs: List[AlgoOperator] = []
        self._output: Optional[MTable] = None
        self._side_tables: List[MTable] = []
        self._executed = False
        # per-op lock: two sinks evaluated from two threads may reach a
        # shared upstream; DAG acyclicity keeps the lock order deadlock-free
        self._eval_lock = threading.RLock()

    # -- environment -------------------------------------------------------
    @property
    def env(self):
        return MLEnvironmentFactory.get(self.get(AlgoOperator.ML_ENVIRONMENT_ID))

    # -- DAG building ------------------------------------------------------
    def link_from(self, *inputs: "AlgoOperator") -> "AlgoOperator":
        self.check_op_size(len(inputs))
        self._inputs = list(inputs)
        self._executed = False
        self._output = None
        return self

    linkFrom = link_from

    def link(self, next_op: "AlgoOperator") -> "AlgoOperator":
        return next_op.link_from(self)

    # number of expected inputs; None = variadic
    _min_inputs: Optional[int] = None
    _max_inputs: Optional[int] = None

    def check_op_size(self, n: int):
        lo = self._min_inputs
        hi = self._max_inputs
        if lo is not None and n < lo:
            raise AkIllegalOperationException(
                f"{type(self).__name__} expects >= {lo} inputs, got {n}"
            )
        if hi is not None and n > hi:
            raise AkIllegalOperationException(
                f"{type(self).__name__} expects <= {hi} inputs, got {n}"
            )

    # -- execution ---------------------------------------------------------
    def _execute_impl(self, *inputs: MTable):
        """Compute this node. Return an MTable, or (MTable, [side MTables])."""
        raise NotImplementedError(type(self).__name__)

    def _evaluate(self) -> MTable:
        """Serial, memoized pull-evaluation of this node (and recursively its
        upstreams)."""
        with self._eval_lock:
            if not self._executed:
                ins = [op._evaluate() for op in self._inputs]
                result = self._execute_impl(*ins)
                if isinstance(result, tuple):
                    self._output, sides = result
                    self._side_tables = list(sides)
                else:
                    self._output = result
                    self._side_tables = []
                self._executed = True
            return self._output

    def _flush_lazy(self, extra_roots: Sequence["AlgoOperator"] = ()):
        """Evaluate ``extra_roots`` and every pending lazy sink of the
        session, then fire the sinks' callbacks. A sink whose evaluation
        fails stays pending, so a later ``execute`` retries it."""
        mgr = self.env.lazy_manager
        for op in list(extra_roots):
            op._evaluate()
        for op in mgr.pending_ops():
            mgr.fill(op, op._evaluate())

    # -- static schema derivation ------------------------------------------
    # Accessing ``op.schema`` on an unexecuted chain must never run the job.
    def _out_schema(self, *in_schemas: TableSchema) -> TableSchema:
        """Static output schema given the input schemas.

        Default: probe ``_execute_impl`` with zero-row, correctly-typed
        inputs. Ops whose empty-input execution is expensive, impossible
        (trainers), or side-effectful (sinks) MUST override."""
        key = tuple(s.to_str() for s in in_schemas)
        cached = getattr(self, "_probe_cache", None)
        if cached is not None and cached[0] == key:
            return cached[1]
        empties = [MTable.empty(s) for s in in_schemas]
        try:
            result = self._execute_impl(*empties)
        except Exception as e:
            raise AkIllegalOperationException(
                f"{type(self).__name__} cannot derive a static schema "
                f"(zero-row probe failed: {e!r}); override _out_schema"
            ) from e
        out = (result[0] if isinstance(result, tuple) else result).schema
        self._probe_cache = (key, out)
        return out

    def _static_schema(self) -> TableSchema:
        if self._executed:
            return self._output.schema
        return self._out_schema(*[op._static_schema() for op in self._inputs])

    def _static_model_meta(self) -> "dict | None":
        """Meta dict of the model table this op will produce, derivable
        without executing; None = this op does not statically declare model
        meta."""
        if self._executed and self._output is not None:
            from ..common.model import MODEL_SCHEMA, table_to_model

            if self._output.schema == MODEL_SCHEMA:
                return table_to_model(self._output)[0]
        return None

    @property
    def schema(self) -> TableSchema:
        return self._static_schema()

    def collect(self) -> MTable:
        self._flush_lazy(extra_roots=[self])
        return self._evaluate()

    # -- lazy sinks --------------------------------------------------------
    def lazy_collect(self, *callbacks: Callable[[MTable], None]) -> "AlgoOperator":
        lazy = self.env.lazy_manager.gen_lazy(self)
        for cb in callbacks:
            lazy.add_callback(cb)
        return self

    def execute(self):
        """Force all pending lazy sinks in this session (reference:
        BatchOperator.execute → triggerLazyEvaluation, BatchOperator.java:316-330)."""
        self._flush_lazy()

    def __repr__(self):
        state = "executed" if self._executed else "deferred"
        return f"{type(self).__name__}({state})"


class TableSourceOp(AlgoOperator):
    """Wrap an existing MTable as a source node (reference:
    operator/batch/source/TableSourceBatchOp.java)."""

    _max_inputs = 0

    def __init__(self, table: MTable, **kwargs):
        super().__init__(**kwargs)
        self._table = table

    def _execute_impl(self) -> MTable:
        return self._table

    def _out_schema(self) -> TableSchema:
        return self._table.schema

    def _static_model_meta(self):
        from ..common.model import MODEL_SCHEMA, table_to_model

        if self._table.schema == MODEL_SCHEMA:
            return table_to_model(self._table)[0]
        return None
