"""Operator DAG API (port of ``alink_tpu.operator.base``).

Capability parity with the reference's operator layer (reference:
core/src/main/java/com/alibaba/alink/operator/AlgoOperator.java:29,
operator/batch/BatchOperator.java:67 — ``link``/``linkFrom`` DAG building,
deferred execution triggered by ``execute``/``collect``, lazy sinks).

The DAG is a host-side graph of Python operator nodes over columnar
:class:`MTable` values, memoized per node (``_executed`` under the node's
``_eval_lock``), so a shared upstream runs once. ``collect``/``execute``
hand the whole pending DAG — the roots and every pending lazy sink of the
session — to the pipelined engine (``common/executor.run_dag``): independent
branches run concurrently on the session's DAG pool, linear mapper runs
fuse, failed units retry, and each unit is traced. The opt-in plan
pre-flight (``ALINK_VALIDATE_PLAN``, ``analysis.preflight``) runs first.
Side outputs (``get_side_output``) and the SQL sugar (``select``,
``filter``/``where``, ``group_by``, ...) are the reference's; the
reference's ``collect_to_dataframe`` is left out (it needs pandas).
"""

from __future__ import annotations

import threading
from typing import Callable, List, Optional, Sequence

from ..common.env import MLEnvironmentFactory
from ..common.exceptions import (AkIllegalArgumentException,
                                 AkIllegalOperationException)
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
        upstreams). The pipelined engine (common/executor.py) schedules whole
        sub-DAGs and then reads results back through this same method, so the
        exactly-once contract lives in one place."""
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

    def _set_result(self, table: MTable, sides: Sequence[MTable] = ()):
        """Install an externally computed result (fused mapper chains write
        the chain tail this way), preserving the memoization contract."""
        with self._eval_lock:
            if not self._executed:
                self._output = table
                self._side_tables = list(sides)
                self._executed = True

    def _flush_lazy(self, extra_roots: Sequence["AlgoOperator"] = ()):
        """Run ``extra_roots`` and every pending lazy sink of the session as
        one DAG job (``common/executor.run_dag``), then fire the sinks'
        callbacks."""
        from ..common.executor import run_dag

        mgr = self.env.lazy_manager
        pending = list(mgr.pending_ops())
        roots = list(extra_roots) + pending
        if roots:
            # opt-in pre-flight (ALINK_VALIDATE_PLAN=warn|error): propagate
            # static schemas over the whole deferred DAG before any node
            # runs; `error` raises on error-severity diagnostics, `warn`
            # logs + counts them and never changes results
            from ..analysis import preflight

            preflight(roots, where="execute")
        try:
            run_dag(self.env, roots)
        except BaseException:
            # on a failed run, sinks whose branches DID complete still fire
            # and clear, while failed branches stay pending — a later
            # execute()/collect() re-plans only the unfinished sub-DAG. A
            # raising sink callback must not mask the run's failure (or
            # starve its sibling sinks): callback errors are counted and the
            # original exception propagates unchanged.
            from ..common.metrics import metrics

            for op in pending:
                if op._executed:
                    try:
                        mgr.fill(op, op._evaluate())
                    except Exception:
                        metrics.incr("resilience.sink_callback_errors")
            raise
        for op in pending:
            mgr.fill(op, op._evaluate())

    # -- results -----------------------------------------------------------
    def get_output_table(self) -> MTable:
        return self._evaluate()

    def get_side_output(self, index: int) -> "AlgoOperator":
        return SideOutputOp(self, index)

    def get_side_output_count(self) -> int:
        self._evaluate()
        return len(self._side_tables)

    # -- static schema derivation ------------------------------------------
    # Accessing ``op.schema`` on an unexecuted chain must never run the job.
    def _out_schema(self, *in_schemas: TableSchema) -> TableSchema:
        """Static output schema given the input schemas.

        Default: probe ``_execute_impl`` with zero-row, correctly-typed
        inputs. Ops whose empty-input execution is expensive, impossible
        (trainers), or side-effectful (sinks) MUST override."""
        return self._schema_probe(*in_schemas)[0]

    def _side_schemas(self, *in_schemas: TableSchema) -> List[TableSchema]:
        """Static schemas of the side outputs (same probe strategy)."""
        return self._schema_probe(*in_schemas)[1]

    def _schema_probe(self, *in_schemas: TableSchema):
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
        if isinstance(result, tuple):
            main, sides = result
            out = (main.schema, [s.schema for s in sides])
        else:
            out = (result.schema, [])
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

    def get_col_names(self) -> List[str]:
        return self.schema.names

    def get_col_types(self) -> List[str]:
        return list(self.schema.types)

    def collect(self) -> MTable:
        self._flush_lazy(extra_roots=[self])
        return self._evaluate()

    def first_n(self, n: int) -> MTable:
        return self.collect().head(n)

    def print(self, n: int = 20, title: Optional[str] = None) -> "AlgoOperator":
        t = self.collect()
        if title:
            print(title)
        print(t.to_display_string(max_rows=n))
        return self

    # -- lazy sinks --------------------------------------------------------
    def lazy_collect(self, *callbacks: Callable[[MTable], None]) -> "AlgoOperator":
        lazy = self.env.lazy_manager.gen_lazy(self)
        for cb in callbacks:
            lazy.add_callback(cb)
        return self

    def lazy_print(self, n: int = 20, title: Optional[str] = None) -> "AlgoOperator":
        def _print(t: MTable):
            if title:
                print(title)
            print(t.to_display_string(max_rows=n))

        return self.lazy_collect(_print)

    def execute(self):
        """Force all pending lazy sinks in this session (reference:
        BatchOperator.execute → triggerLazyEvaluation, BatchOperator.java:316-330)."""
        self._flush_lazy()

    # -- SQL-ish sugar (reference: AlgoOperator select/filter/groupBy/orderBy) --
    def select(self, fields: "str | Sequence[str]") -> "AlgoOperator":
        from .sql import SelectOp

        return SelectOp(fields).link_from(self)

    def filter(self, predicate: str) -> "AlgoOperator":
        from .sql import FilterOp

        return FilterOp(predicate).link_from(self)

    where = filter

    def distinct(self) -> "AlgoOperator":
        from .sql import DistinctOp

        return DistinctOp().link_from(self)

    def order_by(self, field: str, limit: Optional[int] = None, ascending: bool = True):
        from .sql import OrderByOp

        return OrderByOp(field, limit, ascending).link_from(self)

    orderBy = order_by

    def group_by(self, group_cols: str, select_clause: str) -> "AlgoOperator":
        from .sql import GroupByOp

        return GroupByOp(group_cols, select_clause).link_from(self)

    groupBy = group_by

    def sample(self, ratio: float, seed: int = 0) -> "AlgoOperator":
        from .sql import SampleOp

        return SampleOp(ratio, seed).link_from(self)

    def rename(self, mapping) -> "AlgoOperator":
        from .sql import RenameOp

        return RenameOp(mapping).link_from(self)

    def apply_func(
        self,
        fn: Callable[[MTable], MTable],
        name: str = "apply_func",
        out_schema: "TableSchema | str | None" = None,
    ) -> "AlgoOperator":
        """Escape hatch: arbitrary MTable→MTable host function as a DAG node
        (reference: udf/udtf ops). ``out_schema`` declares the result schema
        for static derivation (like the reference's UDF result types)."""
        return _FuncOp(fn, name, out_schema).link_from(self)

    def __repr__(self):
        state = "executed" if self._executed else "deferred"
        return f"{type(self).__name__}({state})"


class SideOutputOp(AlgoOperator):
    """Materialized view of a parent's i-th side output
    (reference: BatchOperator.getSideOutput)."""

    def __init__(self, parent: AlgoOperator, index: int):
        super().__init__()
        self._parent = parent
        self._index = index
        self._inputs = [parent]

    def _execute_impl(self, parent_out: MTable) -> MTable:
        sides = self._parent._side_tables
        if self._index >= len(sides):
            raise AkIllegalArgumentException(
                f"side output {self._index} out of range ({len(sides)} available)"
            )
        return sides[self._index]

    def _static_schema(self) -> TableSchema:
        # bypass the parent's *main* schema: only the side schemas are needed
        if self._executed:
            return self._output.schema
        if self._parent._executed:
            return self._parent._side_tables[self._index].schema
        grand = [op._static_schema() for op in self._parent._inputs]
        sides = self._parent._side_schemas(*grand)
        if self._index >= len(sides):
            raise AkIllegalArgumentException(
                f"side output {self._index} out of range ({len(sides)} declared)"
            )
        return sides[self._index]


class _FuncOp(AlgoOperator):
    _min_inputs = 1

    def __init__(self, fn, name, out_schema: "TableSchema | str | None" = None):
        super().__init__()
        self._fn = fn
        self._name = name
        if isinstance(out_schema, str):
            out_schema = TableSchema.parse(out_schema)
        self._declared_schema = out_schema

    def _execute_impl(self, *inputs: MTable) -> MTable:
        return self._fn(*inputs)

    def _out_schema(self, *in_schemas: TableSchema) -> TableSchema:
        if self._declared_schema is not None:
            return self._declared_schema
        # UDFs without a declared schema fall back to the zero-row probe
        return super()._out_schema(*in_schemas)


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
