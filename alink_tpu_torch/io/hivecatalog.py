"""Hive / ODPS catalog adapters behind the catalog contract (port of
``alink_tpu.io.hivecatalog``; host code).

Capability parity with the reference's external catalogs (reference:
core/src/main/java/com/alibaba/alink/common/io/catalog/HiveCatalog.java,
OdpsCatalog.java, both loaded through catalog plugin classloaders —
CatalogSourceBatchOp/CatalogSinkBatchOp route by catalog object).

Here the route key is the catalog URL scheme: ``hive://host:port/database``
opens :class:`HiveCatalog` over HiveServer2 (plugin-gated on `pyhive`);
``odps://`` opens :class:`alink_tpu_torch.io.odps.OdpsCatalog` (plugin-gated on
`pyodps`); plain paths stay on the built-in sqlite catalog. The adapter speaks the exact contract
``SqliteCatalog`` does — list_tables / get_table_schema / read_table /
write_table — so every catalog consumer (ops, WebUI, SQL engine) works
against Hive unchanged. Tests inject a DB-API connection double via
``connection=`` to exercise SQL generation + type mapping offline.
"""

from __future__ import annotations

from typing import Any, List, Optional

import numpy as np

from ..common.exceptions import (AkIllegalArgumentException,
                                 AkPluginNotExistException)
from ..common.mtable import AlinkTypes, MTable, TableSchema

_HIVE_TO_ALINK = {
    "tinyint": AlinkTypes.LONG, "smallint": AlinkTypes.LONG,
    "int": AlinkTypes.LONG, "integer": AlinkTypes.LONG,
    "bigint": AlinkTypes.LONG,
    "float": AlinkTypes.DOUBLE, "double": AlinkTypes.DOUBLE,
    "decimal": AlinkTypes.DOUBLE,
    "boolean": AlinkTypes.BOOLEAN,
    "string": AlinkTypes.STRING, "varchar": AlinkTypes.STRING,
    "char": AlinkTypes.STRING, "timestamp": AlinkTypes.STRING,
    "date": AlinkTypes.STRING, "binary": AlinkTypes.STRING,
}

_ALINK_TO_HIVE = {
    AlinkTypes.LONG: "BIGINT", AlinkTypes.INT: "INT",
    AlinkTypes.DOUBLE: "DOUBLE", AlinkTypes.FLOAT: "FLOAT",
    AlinkTypes.BOOLEAN: "BOOLEAN", AlinkTypes.STRING: "STRING",
}


class HiveCatalog:
    """HiveServer2-backed catalog (reference: HiveCatalog.java)."""

    def __init__(self, host: Optional[str] = None, port: int = 10000,
                 database: str = "default", connection: Any = None):
        if connection is not None:
            self._conn = connection
        else:
            try:
                from pyhive import hive
            except ImportError as e:
                raise AkPluginNotExistException(
                    "hive:// catalogs need the 'pyhive' package (the "
                    "reference ships hive catalogs as plugin jars): "
                    "pip install 'pyhive[hive]'"
                ) from e
            self._conn = hive.connect(host=host, port=port,
                                      database=database)
        self.database = database

    @staticmethod
    def from_url(url: str, connection: Any = None) -> "HiveCatalog":
        """``hive://host:port/database`` (port/database optional)."""
        rest = url[len("hive://"):]
        hostport, _, db = rest.partition("/")
        host, _, port = hostport.partition(":")
        return HiveCatalog(host=host or "localhost",
                           port=int(port or 10000),
                           database=db or "default",
                           connection=connection)

    # -- catalog contract (same as SqliteCatalog) ---------------------------
    def list_tables(self) -> List[str]:
        cur = self._conn.cursor()
        cur.execute("SHOW TABLES")
        return sorted(r[0] for r in cur.fetchall())

    def get_table_schema(self, name: str) -> TableSchema:
        cur = self._conn.cursor()
        cur.execute(f"DESCRIBE `{name}`")
        names, types = [], []
        for row in cur.fetchall():
            col, decl = row[0], (row[1] or "")
            if not col or col.startswith("#"):  # partition-info section
                break
            names.append(col)
            base = decl.split("(")[0].strip().lower()
            types.append(_HIVE_TO_ALINK.get(base, AlinkTypes.STRING))
        if not names:
            raise AkIllegalArgumentException(
                f"hive table {name!r} not found or empty schema")
        return TableSchema(names, types)

    def read_table(self, name: str) -> MTable:
        schema = self.get_table_schema(name)
        cur = self._conn.cursor()
        cur.execute(f"SELECT * FROM `{name}`")
        rows = cur.fetchall()
        cols = {}
        out_types = []
        for i, (n, tp) in enumerate(zip(schema.names, schema.types)):
            vals = [r[i] for r in rows]
            if tp == AlinkTypes.DOUBLE:
                cols[n] = np.asarray(
                    [np.nan if v is None else float(v) for v in vals])
                out_types.append(tp)
            elif tp == AlinkTypes.LONG:
                # nullable ints are DOUBLE+NaN framework-wide (same rule as
                # the sqlite result reader) — 0 would be indistinguishable
                # from a real zero
                if any(v is None for v in vals):
                    cols[n] = np.asarray(
                        [np.nan if v is None else float(v) for v in vals])
                    out_types.append(AlinkTypes.DOUBLE)
                else:
                    cols[n] = np.asarray([int(v) for v in vals], np.int64)
                    out_types.append(tp)
            else:
                cols[n] = np.asarray(vals, object)
                out_types.append(tp)
        return MTable(cols, TableSchema(schema.names, out_types))

    def write_table(self, name: str, t: MTable) -> None:
        decls = ", ".join(
            f"`{n}` {_ALINK_TO_HIVE.get(t.schema.type_of(n), 'STRING')}"
            for n in t.names)
        cur = self._conn.cursor()
        cur.execute(f"CREATE TABLE IF NOT EXISTS `{name}` ({decls})")
        if t.num_rows == 0:
            return
        # chunked multi-row VALUES inserts (HiveServer2 supports them since
        # 0.14); one statement for the whole table would build an unbounded
        # SQL string and trip thrift frame limits
        CHUNK = 500
        all_rows = list(t.rows())
        for s in range(0, len(all_rows), CHUNK):
            part = all_rows[s:s + CHUNK]
            placeholders = ", ".join(
                "(" + ", ".join(["%s"] * len(t.names)) + ")"
                for _ in range(len(part)))
            flat: List[Any] = []
            for row in part:
                for v in row:
                    if isinstance(v, (np.integer,)):
                        v = int(v)
                    elif isinstance(v, (np.floating,)):
                        v = float(v)
                    elif isinstance(v, (np.bool_,)):
                        v = bool(v)
                    flat.append(v)
            cur.execute(
                f"INSERT INTO `{name}` VALUES {placeholders}", tuple(flat))

    def close(self) -> None:
        close = getattr(self._conn, "close", None)
        if close:
            close()


def open_catalog(url_or_path: str, connection: Any = None):
    """Scheme-routed catalog resolution used by CatalogSource/SinkBatchOp."""
    if url_or_path.startswith("hive://"):
        return HiveCatalog.from_url(url_or_path, connection=connection)
    if url_or_path.startswith("odps://"):
        from .odps import OdpsCatalog

        return OdpsCatalog.from_url(url_or_path, client=connection)
    if url_or_path.startswith("datahub://"):
        raise AkPluginNotExistException(
            "datahub:// is a streaming bus, not a table catalog — use "
            "DatahubSourceStreamOp / DatahubSinkStreamOp (reference: "
            "connectors/connector-datahub); the wire client is gated on "
            "the 'pydatahub' package")
    from ..operator.sqlengine import SqliteCatalog

    return SqliteCatalog(url_or_path)
