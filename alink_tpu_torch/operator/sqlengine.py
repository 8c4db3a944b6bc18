"""Full SQL-string engine + JDBC source/sink + catalog, on stdlib sqlite3
(port of ``alink_tpu.operator.sqlengine``, copied).

Capability parity with the reference's local SQL stack (reference:
core/src/main/java/com/alibaba/alink/operator/common/sql/
MTableCalciteSqlExecutor.java, CalciteSelectMapper.java,
operator/local/sql/CalciteFunctionCompiler.java — Apache Calcite evaluates
arbitrary SQL over in-memory tables without Flink; common/io/catalog/
BaseCatalog.java + JDBC catalog family (Derby/MySql/Sqlite);
connectors/connector-jdbc).

Re-design: sqlite3 is the embedded SQL engine (the Calcite role): MTables
register as in-memory tables, the query string runs as-is, the result reads
back columnar. Vector/tensor cells travel as their string codecs. The JDBC
ops speak any sqlite database file — the catalog lists/reads/writes tables
with schema derivation from the DB metadata."""

from __future__ import annotations

import sqlite3
from typing import Dict, List, Sequence

import numpy as np

from ..common.exceptions import AkIllegalArgumentException
from ..common.linalg import format_vector, parse_vector
from ..common.mtable import AlinkTypes, MTable, TableSchema
from ..common.params import ParamInfo


def _to_sql_value(v, type_tag: str):
    if v is None:
        return None
    if AlinkTypes.is_vector(type_tag):
        return format_vector(parse_vector(v))
    if isinstance(v, (np.floating,)):
        v = float(v)
        return None if v != v else v  # NaN -> NULL
    if isinstance(v, (np.integer,)):
        return int(v)
    if isinstance(v, (np.bool_,)):
        return bool(v)
    if isinstance(v, float) and v != v:
        return None
    return v


def register_mtable(conn: sqlite3.Connection, name: str, t: MTable):
    """CREATE + bulk INSERT an MTable as a sqlite table."""
    decls = []
    for n, tp in zip(t.names, t.schema.types):
        if tp in (AlinkTypes.DOUBLE, AlinkTypes.FLOAT):
            decl = "REAL"
        elif tp in (AlinkTypes.LONG, AlinkTypes.INT, AlinkTypes.BOOLEAN):
            decl = "INTEGER"
        else:
            decl = "TEXT"
        decls.append(f'"{n}" {decl}')
    conn.execute(f'CREATE TABLE "{name}" ({", ".join(decls)})')
    rows = [
        tuple(_to_sql_value(v, tp)
              for v, tp in zip(row, t.schema.types))
        for row in t.rows()
    ]
    ph = ", ".join("?" * len(t.names))
    conn.executemany(f'INSERT INTO "{name}" VALUES ({ph})', rows)


def _result_to_mtable(cursor: sqlite3.Cursor) -> MTable:
    names = [d[0] for d in cursor.description]
    rows = cursor.fetchall()
    cols: Dict[str, np.ndarray] = {}
    types: List[str] = []
    for j, n in enumerate(names):
        vals = [r[j] for r in rows]
        non_null = [v for v in vals if v is not None]
        if non_null and all(isinstance(v, int) and not isinstance(v, bool)
                            for v in non_null):
            if any(v is None for v in vals):
                cols[n] = np.asarray(
                    [np.nan if v is None else float(v) for v in vals])
                types.append(AlinkTypes.DOUBLE)
            else:
                cols[n] = np.asarray(vals, np.int64)
                types.append(AlinkTypes.LONG)
        elif non_null and all(isinstance(v, (int, float))
                              and not isinstance(v, bool)
                              for v in non_null):
            cols[n] = np.asarray(
                [np.nan if v is None else float(v) for v in vals])
            types.append(AlinkTypes.DOUBLE)
        else:
            cols[n] = np.asarray(vals, object)
            types.append(AlinkTypes.STRING)
    if not rows:
        cols = {n: np.asarray([], object) for n in names}
        types = [AlinkTypes.STRING] * len(names)
    return MTable(cols, TableSchema(names, types))


def _register_inputs(conn: sqlite3.Connection, tables: Sequence[MTable]):
    """The one place encoding the op-input naming contract: input i is
    ``t{i}``; ``t`` aliases ``t0``."""
    for i, t in enumerate(tables):
        register_mtable(conn, f"t{i}", t)
    if tables:
        conn.execute("CREATE TEMP VIEW t AS SELECT * FROM t0")


def sql_query(query: str, tables: Dict[str, MTable]) -> MTable:
    """Run one SQL statement over named MTables (the Calcite-executor
    analog)."""
    conn = sqlite3.connect(":memory:")
    try:
        for name, t in tables.items():
            register_mtable(conn, name, t)
        cur = conn.execute(query)
        return _result_to_mtable(cur)
    finally:
        conn.close()


# -- operators ---------------------------------------------------------------

from .batch.base import BatchOperator  # noqa: E402 (op layer import)


class SqlQueryBatchOp(BatchOperator):
    """Arbitrary SQL over the inputs; input i registers as table ``t{i}``
    (and ``t`` aliases ``t0``). (reference: the FullOuterJoin/select SQL ops
    routed through MTableCalciteSqlExecutor)."""

    QUERY = ParamInfo("query", str, optional=False, aliases=("sql",))

    _min_inputs = 1
    _max_inputs = None

    def _execute_impl(self, *tables: MTable) -> MTable:
        q = self.get(self.QUERY)
        conn = sqlite3.connect(":memory:")
        try:
            _register_inputs(conn, tables)
            return _result_to_mtable(conn.execute(q))
        finally:
            conn.close()

    def _out_schema(self, *in_schemas) -> TableSchema:
        # probe the query over ONE dummy typed row per input; when the
        # query's predicate filters that row (zero-row results carry no
        # sqlite value types), fall back to declared-type metadata from a
        # temp view over the same query (PRAGMA table_info) plus the
        # registered input column types — never the value of the dummy row
        def dummy(schema: TableSchema) -> MTable:
            cols = {}
            for n, tp in zip(schema.names, schema.types):
                if tp in (AlinkTypes.DOUBLE, AlinkTypes.FLOAT):
                    cols[n] = np.asarray([0.0])
                elif tp in (AlinkTypes.LONG, AlinkTypes.INT,
                            AlinkTypes.BOOLEAN):
                    cols[n] = np.asarray([0], np.int64)
                elif AlinkTypes.is_vector(tp):
                    cols[n] = np.asarray(["0.0"], object)
                else:
                    cols[n] = np.asarray([""], object)
            return MTable(cols, TableSchema(
                list(schema.names),
                [tp if not AlinkTypes.is_vector(tp) else AlinkTypes.STRING
                 for tp in schema.types]))

        probed = self._execute_impl(*[dummy(s) for s in in_schemas])
        if probed.num_rows > 0:
            return probed.schema
        # name → declared type across all inputs (later inputs don't shadow)
        by_name: Dict[str, str] = {}
        for s in in_schemas:
            for n, tp in zip(s.names, s.types):
                by_name.setdefault(n, tp)
        conn = sqlite3.connect(":memory:")
        try:
            _register_inputs(conn, [dummy(s) for s in in_schemas])
            conn.execute(
                f"CREATE TEMP VIEW __probe AS {self.get(self.QUERY)}")
            decl = {"REAL": AlinkTypes.DOUBLE, "INTEGER": AlinkTypes.LONG,
                    "TEXT": AlinkTypes.STRING}
            names, types = [], []
            for row in conn.execute("PRAGMA table_info(__probe)"):
                col, dtype = row[1], (row[2] or "").upper()
                names.append(col)
                types.append(decl.get(dtype) or by_name.get(col)
                             or AlinkTypes.STRING)
            return TableSchema(names, types)
        finally:
            conn.close()


class JdbcSourceBatchOp(BatchOperator):
    """Read a table (or query) from a sqlite database file (reference:
    connectors/connector-jdbc source; the sqlite driver plays the JDBC
    role)."""

    DB_PATH = ParamInfo("dbPath", str, optional=False, aliases=("url",))
    TABLE_NAME = ParamInfo("tableName", str)
    QUERY = ParamInfo("query", str)

    _max_inputs = 0

    def _execute_impl(self) -> MTable:
        q = self.get(self.QUERY)
        table = self.get(self.TABLE_NAME)
        if not q and not table:
            raise AkIllegalArgumentException(
                "JdbcSource needs tableName or query")
        q = q or f'SELECT * FROM "{table}"'
        conn = sqlite3.connect(self.get(self.DB_PATH))
        try:
            return _result_to_mtable(conn.execute(q))
        finally:
            conn.close()


class JdbcSinkBatchOp(BatchOperator):
    """Write the input table into a sqlite database file."""

    DB_PATH = ParamInfo("dbPath", str, optional=False, aliases=("url",))
    TABLE_NAME = ParamInfo("tableName", str, optional=False)
    OVERWRITE = ParamInfo("overwrite", bool, default=True)

    _min_inputs = 1
    _max_inputs = 1

    def _execute_impl(self, t: MTable) -> MTable:
        conn = sqlite3.connect(self.get(self.DB_PATH))
        try:
            name = self.get(self.TABLE_NAME)
            if self.get(self.OVERWRITE):
                conn.execute(f'DROP TABLE IF EXISTS "{name}"')
            register_mtable(conn, name, t)
            conn.commit()
        finally:
            conn.close()
        return t

    def _out_schema(self, in_schema):
        return in_schema


class SqliteCatalog:
    """Catalog over one sqlite database (reference:
    common/io/catalog/BaseCatalog.java + the Derby/MySql/Sqlite JDBC
    catalogs loaded through catalog/plugin classloaders)."""

    def __init__(self, db_path: str):
        self.db_path = db_path

    def list_tables(self) -> List[str]:
        conn = sqlite3.connect(self.db_path)
        try:
            cur = conn.execute(
                "SELECT name FROM sqlite_master WHERE type='table' "
                "ORDER BY name")
            return [r[0] for r in cur.fetchall()]
        finally:
            conn.close()

    def get_table_schema(self, name: str) -> TableSchema:
        conn = sqlite3.connect(self.db_path)
        try:
            cur = conn.execute(f'PRAGMA table_info("{name}")')
            names, types = [], []
            for _, col, decl, *_ in cur.fetchall():
                names.append(col)
                decl = (decl or "").upper()
                if "INT" in decl:
                    types.append(AlinkTypes.LONG)
                elif any(k in decl for k in ("REAL", "FLOA", "DOUB")):
                    types.append(AlinkTypes.DOUBLE)
                else:
                    types.append(AlinkTypes.STRING)
            if not names:
                raise AkIllegalArgumentException(f"no such table {name!r}")
            return TableSchema(names, types)
        finally:
            conn.close()

    def read_table(self, name: str) -> MTable:
        conn = sqlite3.connect(self.db_path)
        try:
            return _result_to_mtable(conn.execute(f'SELECT * FROM "{name}"'))
        finally:
            conn.close()

    def write_table(self, name: str, t: MTable, overwrite: bool = True):
        conn = sqlite3.connect(self.db_path)
        try:
            if overwrite:
                conn.execute(f'DROP TABLE IF EXISTS "{name}"')
            register_mtable(conn, name, t)
            conn.commit()
        finally:
            conn.close()

    def drop_table(self, name: str):
        conn = sqlite3.connect(self.db_path)
        try:
            conn.execute(f'DROP TABLE IF EXISTS "{name}"')
            conn.commit()
        finally:
            conn.close()
