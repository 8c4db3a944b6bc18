"""UDF long-tail: capitalized aliases, Py*Fn names, pandas UDFs, file-loaded
UDFs, gated R UDFs, FlatMap family, FlattenKObject (port of
``alink_tpu.operator.batch.udf2``; host code).

Capability parity (reference: operator/batch/utils/UDFBatchOp.java /
UDTFBatchOp.java; PyScalarFnBatchOp.java / PyTableFnBatchOp.java /
PyFileScalarFnBatchOp.java / PyFileTableFnBatchOp.java (BasePyScalarFn/
BasePyTableFn); PandasUdfBatchOp.java / PandasUdfFileBatchOp.java /
GroupPandasUdfBatchOp.java / GroupPandasFileUdfBatchOp.java
(BasePandasUdf/BaseGroupPandasUdf); RUdfBatchOp.java / GroupRBatchOp.java;
FlatMapBatchOp.java / FlatModelMapBatchOp.java; recommendation/
FlattenKObjectBatchOp.java).

Python-first collapse: the reference tunnels Python through a PyCalcRunner
worker process; here UDFs are in-process callables, so the Py*Fn names are
the SAME machinery as UDF/UDTF. The *File* variants load the callable from
a .py file (the reference's user-script path). R is not available in this
runtime: the R ops raise with guidance, matching the reference's
missing-plugin behavior.

The pandas UDF ops keep the reference's names and params, but their
contract is ``pd.DataFrame`` in and out, and the port imports no pandas:
they raise :class:`AkPluginNotExistException` naming it when they run.
"""

from __future__ import annotations

import importlib.util
import os
from typing import Callable, Iterator, List, Optional

import numpy as np

from ...common.exceptions import (
    AkIllegalArgumentException,
    AkPluginNotExistException,
    AkUnsupportedOperationException,
)
from ...common.mtable import AlinkTypes, MTable, TableSchema
from ...common.params import ParamInfo
from ...mapper import (
    HasOutputCol,
    HasOutputCols,
    HasReservedCols,
    HasSelectedCol,
    HasSelectedCols,
)
from .base import BatchOperator
from .vector import UdfBatchOp, UdtfBatchOp


class UDFBatchOp(UdfBatchOp):
    """(reference: operator/batch/utils/UDFBatchOp.java)"""


class UDTFBatchOp(UdtfBatchOp):
    """(reference: operator/batch/utils/UDTFBatchOp.java)"""


class PyScalarFnBatchOp(UdfBatchOp):
    """Scalar Python function op — in-process (reference:
    operator/batch/utils/PyScalarFnBatchOp.java via BasePyScalarFnBatchOp;
    the Flink-side python worker collapses to a direct call)."""


class BasePyScalarFnBatchOp(UdfBatchOp):
    """(reference: operator/batch/utils/BasePyScalarFnBatchOp.java)"""


class PyTableFnBatchOp(UdtfBatchOp):
    """(reference: operator/batch/utils/PyTableFnBatchOp.java)"""


class BasePyTableFnBatchOp(UdtfBatchOp):
    """(reference: operator/batch/utils/BasePyTableFnBatchOp.java)"""


def _load_callable(path: str, name: str) -> Callable:
    if not os.path.exists(path):
        raise AkIllegalArgumentException(f"no such python file: {path}")
    spec = importlib.util.spec_from_file_location("_alink_user_fn", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    if not hasattr(mod, name):
        raise AkIllegalArgumentException(
            f"{path} does not define {name!r}")
    return getattr(mod, name)


class PyFileScalarFnBatchOp(UdfBatchOp):
    """Scalar UDF loaded from a user .py file (reference:
    operator/batch/utils/PyFileScalarFnBatchOp.java)."""

    def __init__(self, file_path: str = None, func_name: str = "udf",
                 params=None, **kw):
        path = file_path or kw.pop("filePath", None)
        name = kw.pop("funcName", func_name)
        super().__init__(func=_load_callable(path, name), params=params, **kw)


class PyFileTableFnBatchOp(UdtfBatchOp):
    """(reference: operator/batch/utils/PyFileTableFnBatchOp.java)"""

    def __init__(self, file_path: str = None, func_name: str = "udtf",
                 params=None, **kw):
        path = file_path or kw.pop("filePath", None)
        name = kw.pop("funcName", func_name)
        super().__init__(func=_load_callable(path, name), params=params, **kw)


def _no_pandas(op: str):
    raise AkPluginNotExistException(
        f"{op} hands the table to its function as a DataFrame of the "
        "'pandas' package, which the port does not depend on; "
        "UdfBatchOp/UdtfBatchOp and FlatMapBatchOp take plain callables")


class PandasUdfBatchOp(BatchOperator, HasReservedCols):
    """Whole-table pandas function: ``func(pd.DataFrame) -> pd.DataFrame``
    (reference: operator/batch/utils/PandasUdfBatchOp.java via
    BasePandasUdfBatchOp; gated: see the module docstring)."""

    RESULT_SCHEMA_STR = ParamInfo("resultSchemaStr", str, default=None,
                                  aliases=("schemaStr",))

    _min_inputs = 1
    _max_inputs = 1

    def __init__(self, func: Callable = None, params=None, **kw):
        super().__init__(params, **kw)
        if func is None:
            raise AkIllegalArgumentException("PandasUdfBatchOp needs func")
        self.func = func

    def _execute_impl(self, t: MTable) -> MTable:
        _no_pandas(type(self).__name__)

    def _out_schema(self, in_schema):
        declared = self.get(self.RESULT_SCHEMA_STR)
        if declared:
            return TableSchema.parse(declared)
        return in_schema


class BasePandasUdfBatchOp(PandasUdfBatchOp):
    """(reference: operator/batch/utils/BasePandasUdfBatchOp.java)"""


class GroupPandasUdfBatchOp(PandasUdfBatchOp):
    """Group-wise pandas apply: ``func`` runs once per group of
    ``groupCols`` (reference: operator/batch/utils/
    GroupPandasUdfBatchOp.java via BaseGroupPandasUdfBatchOp)."""

    GROUP_COLS = ParamInfo("groupCols", list, optional=False)



class BaseGroupPandasUdfBatchOp(GroupPandasUdfBatchOp):
    """(reference: operator/batch/utils/BaseGroupPandasUdfBatchOp.java)"""


class PandasUdfFileBatchOp(PandasUdfBatchOp):
    """(reference: operator/batch/utils/PandasUdfFileBatchOp.java)"""

    def __init__(self, file_path: str = None, func_name: str = "udf",
                 params=None, **kw):
        path = file_path or kw.pop("filePath", None)
        name = kw.pop("funcName", func_name)
        super().__init__(func=_load_callable(path, name), params=params, **kw)


class GroupPandasFileUdfBatchOp(GroupPandasUdfBatchOp):
    """(reference: operator/batch/utils/GroupPandasFileUdfBatchOp.java)"""

    def __init__(self, file_path: str = None, func_name: str = "udf",
                 params=None, **kw):
        path = file_path or kw.pop("filePath", None)
        name = kw.pop("funcName", func_name)
        super().__init__(func=_load_callable(path, name), params=params, **kw)


def _no_r(*_a, **_k):
    raise AkUnsupportedOperationException(
        "R is not available in this runtime. The reference's R UDF ops run "
        "user R scripts through an R worker process; install an R bridge "
        "(e.g. rpy2) and wrap it as a plain python callable in "
        "UdfBatchOp/PandasUdfBatchOp instead.")


class RUdfBatchOp(BatchOperator):
    """Gated: R runtime absent (reference: operator/batch/utils/
    RUdfBatchOp.java — requires the R plugin)."""

    _min_inputs = 1
    _max_inputs = 1

    def __init__(self, *a, **kw):
        _no_r()


class GroupRBatchOp(BatchOperator):
    """Gated: R runtime absent (reference: operator/batch/utils/
    GroupRBatchOp.java)."""

    _min_inputs = 1
    _max_inputs = 1

    def __init__(self, *a, **kw):
        _no_r()


class FlatMapBatchOp(BatchOperator, HasSelectedCols, HasReservedCols):
    """Row → rows flat map with a declared output schema (reference:
    operator/batch/utils/FlatMapBatchOp.java)."""

    RESULT_SCHEMA_STR = ParamInfo("resultSchemaStr", str, optional=False,
                                  aliases=("schemaStr",))

    _min_inputs = 1
    _max_inputs = 1

    def __init__(self, func: Callable = None, params=None, **kw):
        super().__init__(params, **kw)
        if func is None:
            raise AkIllegalArgumentException("FlatMapBatchOp needs func")
        self.func = func

    def _execute_impl(self, t: MTable) -> MTable:
        cols = list(self.get(HasSelectedCols.SELECTED_COLS) or t.names)
        arrays = [t.col(c) for c in cols]
        out_rows = []
        for vals in zip(*arrays):
            for row in self.func(*vals):
                out_rows.append(tuple(row))
        return MTable.from_rows(out_rows, self._out_schema(t.schema))

    def _out_schema(self, in_schema):
        return TableSchema.parse(self.get(self.RESULT_SCHEMA_STR))


class FlatModelMapBatchOp(FlatMapBatchOp):
    """FlatMap with a leading model-table input: ``func(model_rows, *vals)``
    (reference: operator/batch/utils/FlatModelMapBatchOp.java)."""

    _min_inputs = 2
    _max_inputs = 2

    def _execute_impl(self, model: MTable, t: MTable) -> MTable:
        model_rows = list(model.rows())
        cols = list(self.get(HasSelectedCols.SELECTED_COLS) or t.names)
        arrays = [t.col(c) for c in cols]
        out_rows = []
        for vals in zip(*arrays):
            for row in self.func(model_rows, *vals):
                out_rows.append(tuple(row))
        return MTable.from_rows(out_rows, self._out_schema(t.schema))


class FlattenKObjectBatchOp(BatchOperator, HasSelectedCol, HasReservedCols):
    """Flatten a nested-MTable (or JSON-list) column into rows — the inverse
    of LeaveKObjectOut grouping (reference: operator/batch/recommendation/
    FlattenKObjectBatchOp.java)."""

    OUTPUT_COLS = ParamInfo("outputCols", list, default=None)
    SCHEMA_STR = ParamInfo("schemaStr", str, default=None,
                           desc="schema of the nested tables (enables "
                                "static schema derivation)")
    RESERVED_COLS = HasReservedCols.RESERVED_COLS

    _min_inputs = 1
    _max_inputs = 1

    def _execute_impl(self, t: MTable) -> MTable:
        import json as _json

        sel = self.get(HasSelectedCol.SELECTED_COL)
        reserved = [c for c in (self.get(self.RESERVED_COLS) or t.names)
                    if c != sel]
        declared = self.get(self.SCHEMA_STR)
        inner_schema: Optional[TableSchema] = (
            TableSchema.parse(declared) if declared else None)
        out_rows = []
        for i in range(t.num_rows):
            cell = t.col(sel)[i]
            if cell is None:
                continue
            if isinstance(cell, MTable):
                sub = (cell.select(list(inner_schema.names))
                       if inner_schema is not None else cell)
                if inner_schema is None:
                    inner_schema = sub.schema
                rows_iter = sub.rows()
            else:
                obj = _json.loads(str(cell))
                if isinstance(obj, dict):
                    obj = [obj]
                if not obj:
                    continue
                if inner_schema is None:
                    keys = list(obj[0].keys())
                    inner_schema = TableSchema(
                        keys, [AlinkTypes.STRING] * len(keys))
                rows_iter = [tuple(o.get(k) for k in inner_schema.names)
                             for o in obj]
            base = tuple(t.col(c)[i] for c in reserved)
            for r in rows_iter:
                out_rows.append(base + tuple(r))
        if inner_schema is None:
            raise AkIllegalArgumentException(
                f"column {sel!r} holds no nested tables; declare schemaStr "
                "to allow an empty result")
        names = reserved + list(inner_schema.names)
        types = ([t.schema.type_of(c) for c in reserved]
                 + list(inner_schema.types))
        return MTable.from_rows(out_rows, TableSchema(names, types))

    def _out_schema(self, in_schema):
        declared = self.get(self.SCHEMA_STR)
        if not declared:
            raise AkIllegalArgumentException(
                "FlattenKObjectBatchOp: declare schemaStr for static schema "
                "derivation (the nested layout is data-dependent)")
        sel = self.get(HasSelectedCol.SELECTED_COL)
        inner = TableSchema.parse(declared)
        reserved = [c for c in (self.get(self.RESERVED_COLS) or
                                in_schema.names) if c != sel]
        return TableSchema(
            reserved + list(inner.names),
            [in_schema.type_of(c) for c in reserved] + list(inner.types))
