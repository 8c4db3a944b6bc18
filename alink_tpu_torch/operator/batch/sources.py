"""Source/sink breadth: LibSvm, TFRecord, Text, TSV (port of
``alink_tpu.operator.batch.sources``).

Capability parity with the reference IO ops (reference:
core/src/main/java/com/alibaba/alink/operator/batch/source/
LibSvmSourceBatchOp.java (+ common/io/dummy LibSvm parsers),
TFRecordDatasetSourceBatchOp.java (+ common/dl/data/TFRecordReader.java),
ParquetSourceBatchOp.java (connectors/connector-parquet),
TextSourceBatchOp.java, TsvSourceBatchOp.java; sink counterparts under
operator/batch/sink/).

Every file goes through :func:`~...io.filesystem.file_open`, so any
registered scheme (``memory://`` included) works. The Parquet and Xls
ops keep the reference's names and params but raise
:class:`~...common.exceptions.AkPluginNotExistException`: they need
pyarrow (with pandas) and openpyxl, which the port does not depend on.
"""

from __future__ import annotations

from typing import List

import numpy as np

from ...common.exceptions import AkPluginNotExistException
from ...common.linalg import SparseVector, parse_vector
from ...common.mtable import AlinkTypes, MTable, TableSchema
from ...common.params import ParamInfo
from ...io.filesystem import file_open
from .base import BatchOperator

_LIBSVM_SCHEMA = TableSchema(["label", "features"],
                             [AlinkTypes.DOUBLE, AlinkTypes.SPARSE_VECTOR])


class LibSvmSourceBatchOp(BatchOperator):
    """(label, sparse features) from LibSVM text (reference:
    LibSvmSourceBatchOp.java; startIndex handles 0/1-based feature ids).
    The sparse vectors stay sparse — they parse into SparseVector cells."""

    FILE_PATH = ParamInfo("filePath", str, optional=False)
    START_INDEX = ParamInfo("startIndex", int, default=1)

    _max_inputs = 0

    def _execute_impl(self) -> MTable:
        start = int(self.get(self.START_INDEX))
        labels: List[float] = []
        vecs: List[SparseVector] = []
        max_dim = 0
        parsed = []
        with file_open(self.get(self.FILE_PATH)) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                parts = line.split()
                labels.append(float(parts[0]))
                idx, vals = [], []
                for kv in parts[1:]:
                    k, v = kv.split(":")
                    idx.append(int(k) - start)
                    vals.append(float(v))
                parsed.append((idx, vals))
                if idx:
                    max_dim = max(max_dim, max(idx) + 1)
        for idx, vals in parsed:
            vecs.append(SparseVector(max_dim, idx, vals))
        return MTable(
            {"label": np.asarray(labels, np.float64),
             "features": np.asarray(vecs, object)}, _LIBSVM_SCHEMA)

    def _out_schema(self) -> TableSchema:
        return _LIBSVM_SCHEMA


class LibSvmSinkBatchOp(BatchOperator):
    """(reference: LibSvmSinkBatchOp.java)"""

    FILE_PATH = ParamInfo("filePath", str, optional=False)
    LABEL_COL = ParamInfo("labelCol", str, optional=False)
    VECTOR_COL = ParamInfo("vectorCol", str, optional=False)
    START_INDEX = ParamInfo("startIndex", int, default=1)

    _min_inputs = 1
    _max_inputs = 1

    def _execute_impl(self, t: MTable) -> MTable:
        start = int(self.get(self.START_INDEX))
        with file_open(self.get(self.FILE_PATH), "w") as f:
            for label, vec in zip(t.col(self.get(self.LABEL_COL)),
                                  t.col(self.get(self.VECTOR_COL))):
                v = parse_vector(vec)
                sv = v if isinstance(v, SparseVector) else None
                if sv is None:
                    dense = v.to_dense().data
                    items = [(i, x) for i, x in enumerate(dense) if x != 0]
                else:
                    items = list(zip(sv.indices.tolist(), sv.values.tolist()))
                body = " ".join(f"{int(i) + start}:{format(x, 'g')}"
                                for i, x in items)
                f.write(f"{format(float(label), 'g')} {body}\n")
        return t

    def _out_schema(self, in_schema):
        return in_schema


class TFRecordSourceBatchOp(BatchOperator):
    """tf.Example TFRecord file source (reference:
    TFRecordDatasetSourceBatchOp.java). schemaStr drives the per-column
    feature-kind mapping; vectors read from float lists."""

    FILE_PATH = ParamInfo("filePath", str, optional=False)
    SCHEMA_STR = ParamInfo("schemaStr", str, optional=False,
                           aliases=("schema",))

    _max_inputs = 0

    def _execute_impl(self) -> MTable:
        from ...common.linalg import DenseVector
        from ...io.tfrecord import decode_example, read_records

        schema = TableSchema.parse(self.get(self.SCHEMA_STR))
        rows = []
        for payload in read_records(self.get(self.FILE_PATH)):
            ex = decode_example(payload)
            row = []
            for n, tp in zip(schema.names, schema.types):
                kind, vals = ex.get(n, ("bytes", []))
                if AlinkTypes.is_vector(tp):
                    row.append(DenseVector(vals))
                elif tp == AlinkTypes.STRING:
                    row.append(vals[0].decode("utf-8") if vals else None)
                elif tp in (AlinkTypes.LONG, AlinkTypes.INT):
                    row.append(int(vals[0]) if vals else None)
                else:
                    row.append(float(vals[0]) if vals else None)
            rows.append(tuple(row))
        return MTable.from_rows(rows, schema)

    def _out_schema(self) -> TableSchema:
        return TableSchema.parse(self.get(self.SCHEMA_STR))


class TFRecordSinkBatchOp(BatchOperator):
    """(reference: TFRecordDatasetSinkBatchOp.java + ExampleCodingV2)"""

    FILE_PATH = ParamInfo("filePath", str, optional=False)

    _min_inputs = 1
    _max_inputs = 1

    def _execute_impl(self, t: MTable) -> MTable:
        from ...io.tfrecord import encode_example, write_records

        payloads = []
        for row in t.rows():
            features = {}
            for n, tp, v in zip(t.names, t.schema.types, row):
                if AlinkTypes.is_vector(tp):
                    features[n] = ("float", list(parse_vector(v).to_dense().data))
                elif tp == AlinkTypes.STRING:
                    features[n] = ("bytes", [] if v is None else [str(v)])
                elif tp in (AlinkTypes.LONG, AlinkTypes.INT,
                            AlinkTypes.BOOLEAN):
                    features[n] = ("int64", [] if v is None else [int(v)])
                else:
                    features[n] = ("float", [] if v is None else [float(v)])
            payloads.append(encode_example(features))
        write_records(self.get(self.FILE_PATH), payloads)
        return t

    def _out_schema(self, in_schema):
        return in_schema


def _missing_plugin(op: str, package: str, why: str):
    raise AkPluginNotExistException(
        f"{op} needs the {package!r} package ({why}), which the port does "
        f"not depend on")


class ParquetSourceBatchOp(BatchOperator):
    """(reference: ParquetSourceBatchOp.java via connector-parquet; the
    reference reads through pyarrow and pandas)"""

    FILE_PATH = ParamInfo("filePath", str, optional=False)

    _max_inputs = 0

    def _execute_impl(self) -> MTable:
        _missing_plugin("ParquetSource", "pyarrow", "with pandas, the "
                        "connector-parquet plugin analog")

    def _out_schema(self) -> TableSchema:
        _missing_plugin("ParquetSource", "pyarrow", "with pandas, the "
                        "connector-parquet plugin analog")


class ParquetSinkBatchOp(BatchOperator):
    FILE_PATH = ParamInfo("filePath", str, optional=False)

    _min_inputs = 1
    _max_inputs = 1

    def _execute_impl(self, t: MTable) -> MTable:
        _missing_plugin("ParquetSink", "pyarrow", "with pandas, the "
                        "connector-parquet plugin analog")

    def _out_schema(self, in_schema):
        return in_schema


_TEXT_SCHEMA = TableSchema(["text"], [AlinkTypes.STRING])


class TextSourceBatchOp(BatchOperator):
    """One STRING column per line (reference: TextSourceBatchOp.java)."""

    FILE_PATH = ParamInfo("filePath", str, optional=False)
    TEXT_COL = ParamInfo("textCol", str, default="text")

    _max_inputs = 0

    def _execute_impl(self) -> MTable:
        with file_open(self.get(self.FILE_PATH)) as f:
            lines = [line.rstrip("\n") for line in f]
        col = self.get(self.TEXT_COL)
        return MTable({col: np.asarray(lines, object)},
                      TableSchema([col], [AlinkTypes.STRING]))

    def _out_schema(self) -> TableSchema:
        return TableSchema([self.get(self.TEXT_COL)], [AlinkTypes.STRING])


class TsvSourceBatchOp(BatchOperator):
    """Tab-separated, no quoting (reference: TsvSourceBatchOp.java)."""

    FILE_PATH = ParamInfo("filePath", str, optional=False)
    SCHEMA_STR = ParamInfo("schemaStr", str, optional=False,
                           aliases=("schema",))

    _max_inputs = 0

    def _execute_impl(self) -> MTable:
        schema = TableSchema.parse(self.get(self.SCHEMA_STR))
        rows = []
        with file_open(self.get(self.FILE_PATH)) as f:
            for line in f:
                line = line.rstrip("\n")
                if not line:
                    continue
                rows.append(tuple(line.split("\t")))
        return MTable.from_rows(rows, schema)

    def _out_schema(self) -> TableSchema:
        return TableSchema.parse(self.get(self.SCHEMA_STR))


class TsvSinkBatchOp(BatchOperator):
    FILE_PATH = ParamInfo("filePath", str, optional=False)

    _min_inputs = 1
    _max_inputs = 1

    def _execute_impl(self, t: MTable) -> MTable:
        with file_open(self.get(self.FILE_PATH), "w") as f:
            for row in t.rows():
                f.write("\t".join("" if v is None else str(v)
                                  for v in row) + "\n")
        return t

    def _out_schema(self, in_schema):
        return in_schema


class XlsSourceBatchOp(BatchOperator):
    """Excel sheet source, plugin-gated on openpyxl (reference:
    XlsSourceBatchOp.java via connectors/connector-xls)."""

    FILE_PATH = ParamInfo("filePath", str, optional=False)
    SCHEMA_STR = ParamInfo("schemaStr", str, optional=False,
                           aliases=("schema",))
    SHEET_NAME = ParamInfo("sheetName", str, default=None)
    IGNORE_FIRST_LINE = ParamInfo("ignoreFirstLine", bool, default=False)

    _max_inputs = 0

    def _execute_impl(self) -> MTable:
        _missing_plugin("XlsSource", "openpyxl",
                        "the connector-xls plugin analog")

    def _out_schema(self) -> TableSchema:
        return TableSchema.parse(self.get(self.SCHEMA_STR))
