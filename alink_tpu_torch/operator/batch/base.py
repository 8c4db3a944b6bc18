"""BatchOperator + batch sources and sink (port of
``alink_tpu.operator.batch.base``).

Capability parity with reference operator/batch/BatchOperator.java:67 and
operator/batch/source/AkSourceBatchOp.java, MemSourceBatchOp.java,
CsvSourceBatchOp.java, sink/AkSinkBatchOp.java.
"""

from __future__ import annotations

import csv
import os

import numpy as np

from ...common.exceptions import AkIllegalArgumentException
from ...common.mtable import AlinkTypes, MTable, TableSchema
from ...common.params import ParamInfo
from ..base import AlgoOperator, TableSourceOp


class BatchOperator(AlgoOperator):
    """Bounded-data operator (reference: operator/batch/BatchOperator.java)."""


class TableSourceBatchOp(TableSourceOp, BatchOperator):
    pass


class MemSourceBatchOp(BatchOperator):
    """In-memory rows source (reference: operator/batch/source/MemSourceBatchOp.java)."""

    _max_inputs = 0

    def __init__(self, rows, schema: "str | TableSchema", **kwargs):
        super().__init__(**kwargs)
        self._table = MTable.from_rows(rows, schema)

    def _execute_impl(self) -> MTable:
        return self._table

    def _out_schema(self) -> TableSchema:
        return self._table.schema


def _object_column(values) -> np.ndarray:
    out = np.empty(len(values), dtype=object)
    for i, v in enumerate(values):
        out[i] = v
    return out


def _csv_column(cells, type_tag: str) -> np.ndarray:
    """One CSV column as the reference's pandas read leaves it before
    ``MTable`` casts it to the schema: numbers parsed, empty cells NaN,
    strings as an object column, vectors through the vector codec."""
    if AlinkTypes.is_vector(type_tag):
        from ...common.linalg import parse_vector

        return _object_column([parse_vector(v) for v in cells])
    if type_tag in (AlinkTypes.LONG, AlinkTypes.INT) and all(cells):
        return np.asarray([int(v) for v in cells], np.int64)
    if type_tag == AlinkTypes.BOOLEAN:
        return np.asarray([v.lower() == "true" for v in cells], np.bool_)
    if AlinkTypes.is_numeric(type_tag):
        return np.asarray([float(v) if v else np.nan for v in cells],
                          np.float64)
    return _object_column([v if v else np.nan for v in cells])


class CsvSourceBatchOp(BatchOperator):
    """CSV file source (reference: operator/batch/source/CsvSourceBatchOp.java).

    Read with the standard library's ``csv`` module (the reference reads
    through pandas, which is not among the port's dependencies); the schema
    string drives the column types. Blank lines are skipped, as pandas
    skips them."""

    FILE_PATH = ParamInfo("filePath", str, optional=False)
    SCHEMA_STR = ParamInfo("schemaStr", str, optional=False, aliases=("schema",))
    FIELD_DELIMITER = ParamInfo("fieldDelimiter", str, default=",")
    IGNORE_FIRST_LINE = ParamInfo("ignoreFirstLine", bool, default=False)
    QUOTE_CHAR = ParamInfo("quoteChar", str, default='"')

    _max_inputs = 0

    def _execute_impl(self) -> MTable:
        from ...io.ak import file_open

        schema = TableSchema.parse(self.get(self.SCHEMA_STR))
        with file_open(self.get(self.FILE_PATH)) as f:
            rows = [r for r in csv.reader(
                f, delimiter=self.get(self.FIELD_DELIMITER),
                quotechar=self.get(self.QUOTE_CHAR), skipinitialspace=True)
                if r]
        if self.get(self.IGNORE_FIRST_LINE):
            rows = rows[1:]
        width = len(schema.names)
        for i, r in enumerate(rows):
            if len(r) != width:
                raise AkIllegalArgumentException(
                    f"CSV row {i} has {len(r)} fields; the schema has {width}")
        cols = {n: _csv_column([r[j] for r in rows], t) for j, (n, t) in
                enumerate(zip(schema.names, schema.types))}
        return MTable(cols, schema)

    def _out_schema(self) -> TableSchema:
        return TableSchema.parse(self.get(self.SCHEMA_STR))


class AkSourceBatchOp(BatchOperator):
    """.ak-file source (reference: AkSourceBatchOp.java; format at
    common/io/filesystem/AkUtils.java:52-110)."""

    FILE_PATH = ParamInfo("filePath", str, optional=False)

    _max_inputs = 0

    def _execute_impl(self) -> MTable:
        from ...io.ak import read_ak

        return read_ak(self.get(self.FILE_PATH))

    def _out_schema(self) -> TableSchema:
        from ...io.ak import read_ak_meta

        return TableSchema.parse(read_ak_meta(self.get(self.FILE_PATH))["schema"])

    def _static_model_meta(self):
        from ...common.model import MODEL_SCHEMA, table_to_model
        from ...io.ak import read_ak, read_ak_meta

        path = self.get(self.FILE_PATH)
        cached = getattr(self, "_meta_cache", None)
        if cached is not None and cached[0] == path:
            return cached[1]
        header = read_ak_meta(path)
        meta = None
        if TableSchema.parse(header["schema"]) == MODEL_SCHEMA:
            meta = table_to_model(read_ak(path))[0]
        self._meta_cache = (path, meta)
        return meta


class AkSinkBatchOp(BatchOperator):
    FILE_PATH = ParamInfo("filePath", str, optional=False)
    OVERWRITE_SINK = ParamInfo("overwriteSink", bool, default=False)

    _min_inputs = 1
    _max_inputs = 1

    def _execute_impl(self, t: MTable) -> MTable:
        from ...io.ak import write_ak

        path = self.get(self.FILE_PATH)
        if os.path.exists(path) and not self.get(self.OVERWRITE_SINK):
            raise AkIllegalArgumentException(
                f"sink path {path} exists; set overwriteSink=True"
            )
        write_ak(path, t)
        return t

    def _out_schema(self, in_schema: TableSchema) -> TableSchema:
        return in_schema  # never probe: a sink must not write on schema access
