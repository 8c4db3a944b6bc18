"""Table utility ops: id append, MTable-cell nesting/flattening, sinks
(port of ``alink_tpu.operator.batch.utils2``; all on the host).

Capability parity with the reference's utils/dataproc helpers (reference:
operator/batch/dataproc/AppendIdBatchOp.java,
operator/batch/dataproc/FlattenMTableBatchOp.java (MTable cell → rows),
operator/batch/dataproc/GroupDataToMTableBatchOp.java / ToMTableBatchOp
(rows → MTable cells — the carrier the fe/grouped ops use),
operator/batch/sink/TextSinkBatchOp.java, DummySinkBatchOp.java,
AppendModelStreamFileSinkBatchOp.java)."""

from __future__ import annotations

from typing import List

import numpy as np

from ...common.exceptions import AkIllegalArgumentException
from ...common.mtable import AlinkTypes, MTable, TableSchema
from ...common.params import ParamInfo
from ...mapper import HasReservedCols, HasSelectedCols
from .base import BatchOperator


def coerce_group_cols(value) -> List[str]:
    """groupCols accepts a list or a comma string (the convention the
    grouped-outlier ops established)."""
    if isinstance(value, (list, tuple)):
        return [str(c).strip() for c in value]
    return [c.strip() for c in str(value).split(",") if c.strip()]


def group_row_indices(t: MTable, group_cols: List[str]):
    """key tuple -> row indices, first-seen order (shared by every
    grouped op so the grouping semantics live in one place)."""
    keys = list(zip(*[np.asarray(t.col(c), object) for c in group_cols]))
    index: dict = {}
    order: List[tuple] = []
    for r, k in enumerate(keys):
        if k not in index:
            index[k] = []
            order.append(k)
        index[k].append(r)
    return index, order


class AppendIdBatchOp(BatchOperator):
    """Add a monotonically increasing id column (reference:
    AppendIdBatchOp.java)."""

    ID_COL = ParamInfo("idCol", str, default="append_id")

    _min_inputs = 1
    _max_inputs = 1

    def _execute_impl(self, t: MTable) -> MTable:
        return t.with_column(self.get(self.ID_COL),
                             np.arange(t.num_rows, dtype=np.int64),
                             AlinkTypes.LONG)

    def _out_schema(self, in_schema):
        return TableSchema(
            list(in_schema.names) + [self.get(self.ID_COL)],
            list(in_schema.types) + [AlinkTypes.LONG])


class GroupDataToMTableBatchOp(BatchOperator):
    """Group rows into per-key MTable cells — the carrier used by the
    grouped/fe subsystems (reference: GroupDataToMTableBatchOp.java;
    GenerateFeatureUtil.group2MTables)."""

    GROUP_COLS = ParamInfo("groupCols", list, optional=False)
    OUTPUT_COL = ParamInfo("outputCol", str, default="mtable")

    _min_inputs = 1
    _max_inputs = 1

    def _execute_impl(self, t: MTable) -> MTable:
        group_cols = coerce_group_cols(self.get(self.GROUP_COLS))
        out_col = self.get(self.OUTPUT_COL)
        index, order = group_row_indices(t, group_cols)
        data_cols = [c for c in t.names if c not in group_cols]
        rows = []
        for k in order:
            sub = t.take(np.asarray(index[k])).select(data_cols)
            rows.append(tuple(k) + (sub,))
        return MTable.from_rows(rows, TableSchema(
            group_cols + [out_col],
            [t.schema.type_of(c) for c in group_cols]
            + [AlinkTypes.MTABLE]))

    def _out_schema(self, in_schema):
        group_cols = coerce_group_cols(self.get(self.GROUP_COLS))
        return TableSchema(
            group_cols + [self.get(self.OUTPUT_COL)],
            [in_schema.type_of(c) for c in group_cols]
            + [AlinkTypes.MTABLE])


class FlattenMTableBatchOp(BatchOperator):
    """Explode MTable cells back into rows, repeating the outer columns
    (reference: FlattenMTableBatchOp.java)."""

    SELECTED_COL = ParamInfo("selectedCol", str, optional=False)
    SCHEMA_STR = ParamInfo("schemaStr", str, optional=False,
                           aliases=("schema",),
                           desc="schema of the nested tables")

    _min_inputs = 1
    _max_inputs = 1

    def _execute_impl(self, t: MTable) -> MTable:
        col = self.get(self.SELECTED_COL)
        inner_schema = TableSchema.parse(self.get(self.SCHEMA_STR))
        outer = [c for c in t.names if c != col]
        rows: List[tuple] = []
        nulls = tuple(None for _ in inner_schema.names)
        for i, cell in enumerate(t.col(col)):
            prefix = tuple(t.col(c)[i] for c in outer)
            if cell is None or not isinstance(cell, MTable):
                # keep the outer row (nulled inner cols) — silent row loss
                # would mask upstream data bugs
                rows.append(prefix + nulls)
                continue
            sub = cell.select(list(inner_schema.names))
            for r in sub.rows():
                rows.append(prefix + tuple(r))
        return MTable.from_rows(rows, TableSchema(
            outer + list(inner_schema.names),
            [t.schema.type_of(c) for c in outer]
            + list(inner_schema.types)))

    def _out_schema(self, in_schema):
        col = self.get(self.SELECTED_COL)
        inner_schema = TableSchema.parse(self.get(self.SCHEMA_STR))
        outer = [c for c in in_schema.names if c != col]
        return TableSchema(
            outer + list(inner_schema.names),
            [in_schema.type_of(c) for c in outer]
            + list(inner_schema.types))


class TextSinkBatchOp(BatchOperator):
    """One line per row, tab-free single-column write (reference:
    TextSinkBatchOp.java — the table must have exactly one STRING col)."""

    FILE_PATH = ParamInfo("filePath", str, optional=False)
    OVERWRITE_SINK = ParamInfo("overwriteSink", bool, default=False)

    _min_inputs = 1
    _max_inputs = 1

    def _execute_impl(self, t: MTable) -> MTable:
        from ...io.filesystem import file_open, get_file_system

        if t.num_cols != 1:
            raise AkIllegalArgumentException(
                f"TextSink expects exactly one column, got {t.names}")
        path = self.get(self.FILE_PATH)
        if get_file_system(path).exists(path) \
                and not self.get(self.OVERWRITE_SINK):
            raise AkIllegalArgumentException(
                f"sink path {path} exists; set overwriteSink=True")
        with file_open(path, "w") as f:
            for (v,) in t.rows():
                f.write(("" if v is None else str(v)) + "\n")
        return t

    def _out_schema(self, in_schema):
        return in_schema


class DummySinkBatchOp(BatchOperator):
    """Swallow the input (forces evaluation; reference:
    DummySinkBatchOp.java)."""

    _min_inputs = 1
    _max_inputs = 1

    def _execute_impl(self, t: MTable) -> MTable:
        return t

    def _out_schema(self, in_schema):
        return in_schema


class AppendModelStreamFileSinkBatchOp(BatchOperator):
    """Land a batch-trained model into a model-stream directory so running
    stream predictors hot-swap onto it (reference:
    AppendModelStreamFileSinkBatchOp.java)."""

    FILE_PATH = ParamInfo("filePath", str, optional=False,
                          desc="model stream DIRECTORY")

    _min_inputs = 1
    _max_inputs = 1

    def _execute_impl(self, t: MTable) -> MTable:
        from ..stream.modelstream import FileModelStreamSink

        FileModelStreamSink(self.get(self.FILE_PATH)).write(t)
        return t

    def _out_schema(self, in_schema):
        return in_schema
