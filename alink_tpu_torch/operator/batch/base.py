"""BatchOperator + batch sources and sink (port of
``alink_tpu.operator.batch.base``).

Capability parity with reference operator/batch/BatchOperator.java:67,
operator/batch/source/AkSourceBatchOp.java, MemSourceBatchOp.java,
CsvSourceBatchOp.java, RandomTableSourceBatchOp.java, NumSeqSourceBatchOp,
sink/AkSinkBatchOp.java, CsvSinkBatchOp.java and dataproc/SplitBatchOp.java.
Every file op opens its path through the scheme-dispatched filesystem
(``io/filesystem.py``), so ``memory://`` and registered schemes work as
local paths do.
"""

from __future__ import annotations

import csv
import io

import numpy as np

from ...common.exceptions import AkIllegalArgumentException
from ...common.mtable import AlinkTypes, MTable, TableSchema
from ...common.params import MinValidator, ParamInfo, RangeValidator
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
        from ...io.filesystem import file_open

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


class RandomTableSourceBatchOp(BatchOperator):
    """Random numeric table (reference: operator/batch/source/RandomTableSourceBatchOp.java)."""

    NUM_ROWS = ParamInfo("numRows", int, optional=False, validator=MinValidator(1))
    NUM_COLS = ParamInfo("numCols", int, optional=False, validator=MinValidator(1))
    ID_COL = ParamInfo("idCol", str, default=None)
    OUTPUT_COLS = ParamInfo("outputCols", list, default=None)
    SEED = ParamInfo("seed", int, default=0)

    _max_inputs = 0

    def _execute_impl(self) -> MTable:
        n, d = self.get(self.NUM_ROWS), self.get(self.NUM_COLS)
        rng = np.random.default_rng(self.get(self.SEED))
        names = self.get(self.OUTPUT_COLS) or [f"col{i}" for i in range(d)]
        cols = {name: rng.random(n) for name in names}
        if self.get(self.ID_COL):
            cols = {self.get(self.ID_COL): np.arange(n, dtype=np.int64), **cols}
        return MTable(cols)

    def _out_schema(self) -> TableSchema:
        d = self.get(self.NUM_COLS)
        names = self.get(self.OUTPUT_COLS) or [f"col{i}" for i in range(d)]
        types = [AlinkTypes.DOUBLE] * len(names)
        if self.get(self.ID_COL):
            names = [self.get(self.ID_COL)] + list(names)
            types = [AlinkTypes.LONG] + types
        return TableSchema(names, types)


class NumSeqSourceBatchOp(BatchOperator):
    """Integer sequence source (reference: NumSeqSourceBatchOp.java)."""

    _max_inputs = 0

    def __init__(self, from_: int, to: int, col_name: str = "num", **kwargs):
        super().__init__(**kwargs)
        self._from, self._to, self._col = from_, to, col_name

    def _execute_impl(self) -> MTable:
        return MTable({self._col: np.arange(self._from, self._to + 1, dtype=np.int64)})

    def _out_schema(self) -> TableSchema:
        return TableSchema([self._col], [AlinkTypes.LONG])


def _csv_cell(v) -> str:
    """One cell as the reference's ``DataFrame.to_csv`` writes it: missing
    values empty, numpy scalars through their own ``str`` (the shortest
    round-trip form), anything else (strings, vectors) through ``str``."""
    if v is None:
        return ""
    if isinstance(v, (float, np.floating)) and v != v:
        return ""
    return str(v)


class CsvSinkBatchOp(BatchOperator):
    """CSV sink (reference: operator/batch/sink/CsvSinkBatchOp.java).

    Written with the standard library's ``csv`` module in the reference's
    layout (``to_csv(index=False, header=False)``: minimal quoting, ``\n``
    line ends); pandas is not among the port's dependencies."""

    FILE_PATH = ParamInfo("filePath", str, optional=False)
    FIELD_DELIMITER = ParamInfo("fieldDelimiter", str, default=",")
    OVERWRITE_SINK = ParamInfo("overwriteSink", bool, default=False)

    _min_inputs = 1
    _max_inputs = 1

    def _execute_impl(self, t: MTable) -> MTable:
        from ...io.filesystem import file_open, get_file_system

        path = self.get(self.FILE_PATH)
        if get_file_system(path).exists(path) \
                and not self.get(self.OVERWRITE_SINK):
            raise AkIllegalArgumentException(
                f"sink path {path} exists; set overwriteSink=True"
            )
        buf = io.StringIO()
        w = csv.writer(buf, delimiter=self.get(self.FIELD_DELIMITER),
                       lineterminator="\n")
        cols = [t.col(n) for n in t.names]
        for i in range(t.num_rows):
            w.writerow([_csv_cell(c[i]) for c in cols])
        with file_open(path, "w") as f:
            f.write(buf.getvalue())
        return t

    def _out_schema(self, in_schema: TableSchema) -> TableSchema:
        return in_schema  # never probe: a sink must not write on schema access


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
        from ...io.filesystem import get_file_system

        path = self.get(self.FILE_PATH)
        if get_file_system(path).exists(path) \
                and not self.get(self.OVERWRITE_SINK):
            raise AkIllegalArgumentException(
                f"sink path {path} exists; set overwriteSink=True"
            )
        write_ak(path, t)
        return t

    def _out_schema(self, in_schema: TableSchema) -> TableSchema:
        return in_schema  # never probe: a sink must not write on schema access


class SplitBatchOp(BatchOperator):
    """Random split; main output = fraction, side output 0 = rest
    (reference: operator/batch/dataproc/SplitBatchOp.java)."""

    FRACTION = ParamInfo(
        "fraction", float, optional=False, validator=RangeValidator(0.0, 1.0)
    )
    SEED = ParamInfo("randomSeed", int, default=0, aliases=("seed",))

    _min_inputs = 1
    _max_inputs = 1

    def _execute_impl(self, t: MTable):
        # exact-count split (the reference takes exactly round(fraction*n)
        # rows, not a per-row bernoulli); the same generator and draws as
        # the reference, so both packages pick the same rows
        rng = np.random.default_rng(self.get(self.SEED))
        n = t.num_rows
        k = int(round(n * self.get(self.FRACTION)))
        mask = np.zeros(n, bool)
        mask[rng.choice(n, size=k, replace=False)] = True
        return t.filter_mask(mask), [t.filter_mask(~mask)]


class ShuffleBatchOp(BatchOperator):
    SEED = ParamInfo("randomSeed", int, default=0, aliases=("seed",))

    _min_inputs = 1
    _max_inputs = 1

    def _execute_impl(self, t: MTable) -> MTable:
        return t.shuffle(seed=self.get(self.SEED))


class FirstNBatchOp(BatchOperator):
    SIZE = ParamInfo("size", int, optional=False, validator=MinValidator(1))

    _min_inputs = 1
    _max_inputs = 1

    def _execute_impl(self, t: MTable) -> MTable:
        return t.head(self.get(self.SIZE))
