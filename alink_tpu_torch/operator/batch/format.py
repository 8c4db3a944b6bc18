"""Format conversion op family: Columns/Csv/Json/Kv/Vector/Triple ↔ (port
of ``alink_tpu.operator.batch.format``; host code, the reference's strings
byte for byte).

Capability parity with the reference's format subsystem (reference:
operator/batch/dataproc/format/*.java — 30+ XToY ops over
operator/common/dataproc/format/FormatTransMapper.java, params at
params/dataproc/format/: csvCol/jsonCol/kvCol/vectorCol, schemaStr,
csvFieldDelimiter, colDelimiter/valDelimiter, handleInvalid).

Re-design: ONE mapper parameterized by (from, to) — every row lowers to an
ordered (key, value) list, then renders into the target format. The pair
ops are metaprogrammed real classes (like the stream-twin registry), and
because they're plain Mappers the stream twins generate automatically.
Triple ops (row-expanding / grouping) are separate batch operators."""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Tuple

import numpy as np

from ...common.exceptions import (
    AkIllegalArgumentException,
    AkIllegalDataException,
)
from ...common.linalg import SparseVector, parse_vector
from ...common.mtable import AlinkTypes, MTable, TableSchema
from ...common.params import InValidator, ParamInfo
from ...mapper import HasReservedCols, HasSelectedCols, Mapper
from .base import BatchOperator
from .utils import MapBatchOp

FORMATS = ("Columns", "Csv", "Json", "Kv", "Vector")


class HasFormatParams(HasSelectedCols, HasReservedCols):
    # from/to side columns (only the relevant ones are read per pair)
    CSV_COL = ParamInfo("csvCol", str, default="csv")
    JSON_COL = ParamInfo("jsonCol", str, default="json")
    KV_COL = ParamInfo("kvCol", str, default="kv")
    VECTOR_COL = ParamInfo("vectorCol", str, default="vec")
    SCHEMA_STR = ParamInfo("schemaStr", str, default=None,
                           aliases=("schema",),
                           desc="fields inside csv strings / output columns")
    CSV_FIELD_DELIMITER = ParamInfo("csvFieldDelimiter", str, default=",")
    COL_DELIMITER = ParamInfo("colDelimiter", str, default=",")
    VAL_DELIMITER = ParamInfo("valDelimiter", str, default=":")
    VECTOR_SIZE = ParamInfo("vectorSize", int, default=-1)
    HANDLE_INVALID = ParamInfo("handleInvalid", str, default="ERROR",
                               validator=InValidator("ERROR", "SKIP"))


def _scalar(v):
    if isinstance(v, (np.integer,)):
        return int(v)
    if isinstance(v, (np.floating,)):
        return float(v)
    if isinstance(v, (np.bool_,)):
        return bool(v)
    return v


class _FormatMapper(Mapper, HasFormatParams):
    """from_format/to_format class attrs drive extraction + rendering."""

    from_format: str = ""
    to_format: str = ""

    # -- field extraction (per row -> ordered (key, value) pairs) ----------
    def _in_schema_fields(self, input_schema: TableSchema):
        if self.from_format == "Columns":
            cols = list(self.get(HasSelectedCols.SELECTED_COLS)
                        or input_schema.names)
            return cols, [input_schema.type_of(c) for c in cols]
        if self.from_format == "Csv":
            spec = self.get(self.SCHEMA_STR)
            if not spec:
                raise AkIllegalArgumentException(
                    "CsvTo* needs schemaStr describing the csv fields")
            sub = TableSchema.parse(spec)
            return list(sub.names), list(sub.types)
        return None, None  # json/kv/vector discover keys per row

    def _extract(self, t: MTable) -> List[List[Tuple[str, object]]]:
        ff = self.from_format
        n = t.num_rows
        if ff == "Columns":
            cols = list(self.get(HasSelectedCols.SELECTED_COLS) or t.names)
            arrays = [t.col(c) for c in cols]
            return [[(c, _scalar(a[i])) for c, a in zip(cols, arrays)]
                    for i in range(n)]
        if ff == "Csv":
            names, types = self._in_schema_fields(t.schema)
            delim = self.get(self.CSV_FIELD_DELIMITER)
            out = []
            for s in t.col(self.get(self.CSV_COL)):
                parts = ("" if s is None else str(s)).split(delim)
                row = []
                for name, tp, raw in zip(names, types, parts):
                    row.append((name, self._parse_cell(raw, tp)))
                out.append(row)
            return out
        if ff == "Json":
            out = []
            for s in t.col(self.get(self.JSON_COL)):
                obj = json.loads(s) if s else {}
                out.append([(k, v) for k, v in obj.items()])
            return out
        if ff == "Kv":
            cd = self.get(self.COL_DELIMITER)
            vd = self.get(self.VAL_DELIMITER)
            out = []
            for s in t.col(self.get(self.KV_COL)):
                row = []
                for pair in ("" if s is None else str(s)).split(cd):
                    if not pair:
                        continue
                    k, _, v = pair.partition(vd)
                    row.append((k, self._parse_cell(v, None)))
                out.append(row)
            return out
        if ff == "Vector":
            out = []
            for s in t.col(self.get(self.VECTOR_COL)):
                v = parse_vector(s)
                if isinstance(v, SparseVector):
                    out.append([(str(int(i)), float(x))
                                for i, x in zip(v.indices, v.values)])
                else:
                    out.append([(str(i), float(x))
                                for i, x in enumerate(v.data)])
            return out
        raise AkIllegalArgumentException(self.from_format)

    def _parse_cell(self, raw: Optional[str], tp: Optional[str]):
        """handleInvalid-aware typed parse: ERROR raises the framework
        exception, SKIP nulls the cell."""
        try:
            return self._parse_typed(raw, tp)
        except (TypeError, ValueError) as e:
            if self.get(self.HANDLE_INVALID) == "SKIP":
                return None
            raise AkIllegalDataException(
                f"cannot parse {raw!r} as {tp or 'a number/string'} "
                "(handleInvalid=SKIP to null bad cells)") from e

    @staticmethod
    def _parse_typed(raw: Optional[str], tp: Optional[str]):
        if raw is None or raw == "":
            return None
        if tp in (AlinkTypes.DOUBLE, AlinkTypes.FLOAT):
            return float(raw)
        if tp in (AlinkTypes.LONG, AlinkTypes.INT):
            return int(raw)
        if tp == AlinkTypes.BOOLEAN:
            return str(raw).lower() in ("1", "true")
        if tp is None:  # kv values: numeric when they parse
            try:
                f = float(raw)
                return int(f) if f.is_integer() and "." not in raw else f
            except ValueError:
                return raw
        return raw

    # -- rendering ----------------------------------------------------------
    def _out_fields(self) -> Tuple[List[str], List[str]]:
        tf = self.to_format
        if tf == "Columns":
            spec = self.get(self.SCHEMA_STR)
            if not spec:
                raise AkIllegalArgumentException(
                    "*ToColumns needs schemaStr for the output columns")
            sub = TableSchema.parse(spec)
            return list(sub.names), list(sub.types)
        col = {"Csv": self.get(self.CSV_COL),
               "Json": self.get(self.JSON_COL),
               "Kv": self.get(self.KV_COL),
               "Vector": self.get(self.VECTOR_COL)}[tf]
        tp = (AlinkTypes.VECTOR if tf == "Vector" else AlinkTypes.STRING)
        return [col], [tp]

    def _render(self, rows: List[List[Tuple[str, object]]]
                ) -> Dict[str, np.ndarray]:
        tf = self.to_format
        names, types = self._out_fields()
        if tf == "Columns":
            cols: Dict[str, list] = {nm: [] for nm in names}
            for row in rows:
                d = dict(row)
                for nm in names:
                    cols[nm].append(d.get(nm))
            out = {}
            for nm, tp in zip(names, types):
                vals = cols[nm]
                if tp in (AlinkTypes.DOUBLE, AlinkTypes.FLOAT):
                    out[nm] = np.asarray(
                        [np.nan if v is None else float(v) for v in vals])
                elif tp in (AlinkTypes.LONG, AlinkTypes.INT) \
                        and all(v is not None for v in vals):
                    out[nm] = np.asarray([int(v) for v in vals], np.int64)
                else:
                    out[nm] = np.asarray(vals, object)
            return out
        name = names[0]
        if tf == "Csv":
            delim = self.get(self.CSV_FIELD_DELIMITER)
            spec = self.get(self.SCHEMA_STR)
            if spec:
                order = TableSchema.parse(spec).names
                cells = []
                for r in rows:
                    d = dict(r)
                    cells.append(delim.join(
                        "" if d.get(k) is None else str(d.get(k))
                        for k in order))
            else:
                cells = [delim.join("" if v is None else str(v)
                                    for _, v in r) for r in rows]
            return {name: np.asarray(cells, object)}
        if tf == "Json":
            return {name: np.asarray(
                [json.dumps(dict(r)) for r in rows], object)}
        if tf == "Kv":
            cd = self.get(self.COL_DELIMITER)
            vd = self.get(self.VAL_DELIMITER)
            return {name: np.asarray(
                [cd.join(f"{k}{vd}{v}" for k, v in r if v is not None)
                 for r in rows], object)}
        if tf == "Vector":
            size = int(self.get(self.VECTOR_SIZE))
            vecs = np.empty(len(rows), object)
            for i, r in enumerate(rows):
                try:
                    items = [(int(k), float(v)) for k, v in r
                             if v is not None]
                except (TypeError, ValueError) as e:
                    if self.get(self.HANDLE_INVALID) == "SKIP":
                        vecs[i] = None
                        continue
                    raise AkIllegalDataException(
                        f"non-numeric key/value {r!r} cannot become a "
                        "vector (handleInvalid=SKIP to null them)") from e
                dim = size if size > 0 else (
                    max((k for k, _ in items), default=-1) + 1)
                vecs[i] = SparseVector(
                    dim, np.asarray([k for k, _ in items], np.int64),
                    np.asarray([v for _, v in items], np.float64))
            return {name: vecs}
        raise AkIllegalArgumentException(tf)

    # -- Mapper surface ------------------------------------------------------
    def output_schema(self, input_schema: TableSchema) -> TableSchema:
        names, types = self._out_fields()
        return self._append_result_schema(input_schema, names, types)

    def map_table(self, t: MTable) -> MTable:
        rows = self._extract(t)
        out_cols = self._render(rows)
        names, types = self._out_fields()
        return self._append_result(
            t, out_cols, dict(zip(names, types)))


# (Columns, Vector) pairs are NOT generated here: the dedicated
# ColumnsToVectorBatchOp / VectorToColumnsBatchOp in batch/vector.py carry
# the reference semantics (column VALUES assemble positionally into a
# vector), which differs from this family's key=index mapping
_SKIP_PAIRS = {("Columns", "Vector"), ("Vector", "Columns")}


def _make_pair_ops():
    batch_ops: Dict[str, type] = {}
    mappers: Dict[str, type] = {}
    for src in FORMATS:
        for dst in FORMATS:
            if src == dst or (src, dst) in _SKIP_PAIRS:
                continue
            mname = f"{src}To{dst}Mapper"
            mapper = type(mname, (_FormatMapper,), {
                "from_format": src, "to_format": dst,
                "__module__": __name__,
                "__doc__": f"{src} → {dst} row format conversion "
                           f"(reference: dataproc/format/"
                           f"{src}To{dst}BatchOp.java)"})
            opname = f"{src}To{dst}BatchOp"
            op = type(opname, (MapBatchOp, HasFormatParams), {
                "mapper_cls": mapper,
                "__module__": __name__,
                "__doc__": mapper.__doc__})
            mappers[mname] = mapper
            batch_ops[opname] = op
    return mappers, batch_ops


_MAPPERS, _PAIR_OPS = _make_pair_ops()
globals().update(_MAPPERS)
globals().update(_PAIR_OPS)

__all__ = sorted(_PAIR_OPS) + [
    "AnyToTripleBatchOp", "TripleToAnyBatchOp",
    "ColumnsToTripleBatchOp", "TripleToColumnsBatchOp",
]


class AnyToTripleBatchOp(BatchOperator, HasFormatParams):
    """Row-expand any supported format into (rowId, column, value) triples
    (reference: dataproc/format/AnyToTripleBatchOp.java,
    ColumnsToTripleBatchOp.java — the long/tidy representation)."""

    FROM_FORMAT = ParamInfo("fromFormat", str, default="Columns",
                            validator=InValidator(*FORMATS))
    TRIPLE_ROW_COL = ParamInfo("tripleRowCol", str, default="row")
    TRIPLE_COLUMN_COL = ParamInfo("tripleColumnCol", str, default="column")
    TRIPLE_VALUE_COL = ParamInfo("tripleValueCol", str, default="value")

    _min_inputs = 1
    _max_inputs = 1

    def _execute_impl(self, t: MTable) -> MTable:
        src = self.get(self.FROM_FORMAT)
        # any mapper with this from_format serves: _extract ignores the
        # to side (Json->Json does not exist in the pair registry)
        dst = "Json" if src != "Json" else "Kv"
        mapper_cls = _MAPPERS[f"{src}To{dst}Mapper"]
        mapper = mapper_cls(t.schema, self.get_params().clone())
        rows = mapper._extract(t)
        rc = self.get(self.TRIPLE_ROW_COL)
        cc = self.get(self.TRIPLE_COLUMN_COL)
        vc = self.get(self.TRIPLE_VALUE_COL)
        out = []
        for i, r in enumerate(rows):
            for k, v in r:
                out.append((i, str(k), None if v is None else str(v)))
        return MTable.from_rows(out, TableSchema(
            [rc, cc, vc],
            [AlinkTypes.LONG, AlinkTypes.STRING, AlinkTypes.STRING]))

    def _out_schema(self, in_schema):
        return TableSchema(
            [self.get(self.TRIPLE_ROW_COL),
             self.get(self.TRIPLE_COLUMN_COL),
             self.get(self.TRIPLE_VALUE_COL)],
            [AlinkTypes.LONG, AlinkTypes.STRING, AlinkTypes.STRING])


class ColumnsToTripleBatchOp(AnyToTripleBatchOp):
    """(reference: ColumnsToTripleBatchOp.java)"""


class TripleToAnyBatchOp(BatchOperator, HasFormatParams):
    """Group (rowId, column, value) triples back into rows of the target
    format (reference: TripleToColumnsBatchOp.java family)."""

    TO_FORMAT = ParamInfo("toFormat", str, default="Columns",
                          validator=InValidator(*FORMATS))
    TRIPLE_ROW_COL = ParamInfo("tripleRowCol", str, default="row")
    TRIPLE_COLUMN_COL = ParamInfo("tripleColumnCol", str, default="column")
    TRIPLE_VALUE_COL = ParamInfo("tripleValueCol", str, default="value")

    _min_inputs = 1
    _max_inputs = 1

    def _execute_impl(self, t: MTable) -> MTable:
        rid = np.asarray(t.col(self.get(self.TRIPLE_ROW_COL)))
        col = np.asarray(t.col(self.get(self.TRIPLE_COLUMN_COL)), object)
        val = np.asarray(t.col(self.get(self.TRIPLE_VALUE_COL)), object)
        order: List = []
        idx_of: Dict = {}
        grouped: List[List[Tuple[str, object]]] = []
        for i in range(t.num_rows):
            r = rid[i]
            if r not in idx_of:
                idx_of[r] = len(order)
                order.append(r)
                grouped.append([])
            grouped[idx_of[r]].append(
                (str(col[i]), _FormatMapper._parse_typed(
                    None if val[i] is None else str(val[i]), None)))
        to = self.get(self.TO_FORMAT)
        mapper_cls = _MAPPERS[f"JsonTo{to}Mapper" if to != "Json"
                              else "KvToJsonMapper"]
        mapper = mapper_cls(None, self.get_params().clone())
        out_cols = mapper._render(grouped)
        names, types = mapper._out_fields()
        return MTable(dict(out_cols), TableSchema(names, types))

    def _out_schema(self, in_schema):
        to = self.get(self.TO_FORMAT)
        mapper_cls = _MAPPERS[f"JsonTo{to}Mapper" if to != "Json"
                              else "KvToJsonMapper"]
        names, types = mapper_cls(
            None, self.get_params().clone())._out_fields()
        return TableSchema(names, types)


class TripleToColumnsBatchOp(TripleToAnyBatchOp):
    """(reference: TripleToColumnsBatchOp.java)"""


class CsvToTripleBatchOp(AnyToTripleBatchOp):
    """(reference: dataproc/format/CsvToTripleBatchOp.java)"""

    def __init__(self, params=None, **kw):
        kw.setdefault("fromFormat", "Csv")
        super().__init__(params, **kw)


class JsonToTripleBatchOp(AnyToTripleBatchOp):
    """(reference: dataproc/format/JsonToTripleBatchOp.java)"""

    def __init__(self, params=None, **kw):
        kw.setdefault("fromFormat", "Json")
        super().__init__(params, **kw)


class KvToTripleBatchOp(AnyToTripleBatchOp):
    """(reference: dataproc/format/KvToTripleBatchOp.java)"""

    def __init__(self, params=None, **kw):
        kw.setdefault("fromFormat", "Kv")
        super().__init__(params, **kw)


class VectorToTripleBatchOp(AnyToTripleBatchOp):
    """(reference: dataproc/format/VectorToTripleBatchOp.java)"""

    def __init__(self, params=None, **kw):
        kw.setdefault("fromFormat", "Vector")
        super().__init__(params, **kw)


class TripleToCsvBatchOp(TripleToAnyBatchOp):
    """(reference: dataproc/format/TripleToCsvBatchOp.java)"""

    def __init__(self, params=None, **kw):
        kw.setdefault("toFormat", "Csv")
        super().__init__(params, **kw)


class TripleToJsonBatchOp(TripleToAnyBatchOp):
    """(reference: dataproc/format/TripleToJsonBatchOp.java)"""

    def __init__(self, params=None, **kw):
        kw.setdefault("toFormat", "Json")
        super().__init__(params, **kw)


class TripleToKvBatchOp(TripleToAnyBatchOp):
    """(reference: dataproc/format/TripleToKvBatchOp.java)"""

    def __init__(self, params=None, **kw):
        kw.setdefault("toFormat", "Kv")
        super().__init__(params, **kw)


class TripleToVectorBatchOp(TripleToAnyBatchOp):
    """(reference: dataproc/format/TripleToVectorBatchOp.java)"""

    def __init__(self, params=None, **kw):
        kw.setdefault("toFormat", "Vector")
        super().__init__(params, **kw)


__all__ += [
    "CsvToTripleBatchOp", "JsonToTripleBatchOp", "KvToTripleBatchOp",
    "VectorToTripleBatchOp", "TripleToCsvBatchOp", "TripleToJsonBatchOp",
    "TripleToKvBatchOp", "TripleToVectorBatchOp",
]
