"""HBase connector: a real thrift-gateway client behind the KV contract
(port of ``alink_tpu.io.hbase``; host code).

Capability parity with the reference's HBase plugin (reference:
core/src/main/java/com/alibaba/alink/common/io/hbase/HBase.java — the client
contract mirrored by :class:`HBaseClient`;
connectors/connector-hbase/.../HBaseFactoryImpl.java — the pluggable
implementation; params/io/HBaseConfigParams.java — zookeeperQuorum/timeout).

The wire client is `happybase` (HBase's thrift gateway), plugin-gated the
same way the reference gates its connector jar: constructing a client
without the package raises :class:`AkPluginNotExistException` naming it.
Tests inject a connection double via ``connection=`` (or the module-level
``connection_factory`` hook), which exercises every row/family/qualifier
encoding path without a live cluster.
"""

from __future__ import annotations

import json
from typing import Any, Callable, Dict, List, Optional, Sequence

from ..common.exceptions import (AkIllegalArgumentException,
                                 AkPluginNotExistException)
from ..common.faults import maybe_fail
from ..common.resilience import CircuitBreaker, with_retries
from .kv import KvStore

# test / embedding hook: callable(host, port, timeout_ms) -> happybase-like
# Connection. When None, the real happybase package is required.
connection_factory: Optional[Callable[[str, int, Optional[int]], Any]] = None


def _default_connection(host: str, port: int, timeout_ms: Optional[int]):
    try:
        import happybase
    except ImportError as e:
        raise AkPluginNotExistException(
            "HBase ops need the 'happybase' package (thrift gateway client "
            "— the reference ships connector-hbase as a plugin jar): "
            "pip install happybase, and point the op at the HBase thrift "
            "server (thriftHost/thriftPort or zookeeperQuorum)."
        ) from e
    kw = {"port": port}
    if timeout_ms is not None:
        kw["timeout"] = timeout_ms
    return happybase.Connection(host, **kw)


class HBaseClient:
    """The reference's HBase.java contract: createTable / set / getColumn /
    getFamilyColumns / getRow, plus batched multi-row gets (the lookup ops'
    hot path — one thrift round trip per table scan, not per row)."""

    def __init__(self, thrift_host: Optional[str] = None,
                 thrift_port: int = 9090,
                 zookeeper_quorum: Optional[str] = None,
                 timeout_ms: Optional[int] = None,
                 connection: Any = None):
        if connection is not None:
            self._conn = connection
            breaker_key = None  # injected double: private breaker, no
            #                     cross-test / cross-instance coupling
        else:
            host = thrift_host
            if not host and zookeeper_quorum:
                # reference connects via zookeeper; the thrift gateway
                # conventionally runs alongside the first quorum host
                host = zookeeper_quorum.split(",")[0].split(":")[0]
            if not host:
                raise AkIllegalArgumentException(
                    "HBase needs a non-empty thriftHost or zookeeperQuorum")
            factory = connection_factory or _default_connection
            self._conn = factory(host, thrift_port, timeout_ms)
            breaker_key = f"hbase:{host}:{thrift_port}"
        self._breaker = (CircuitBreaker(name="hbase:injected")
                         if breaker_key is None
                         else CircuitBreaker.for_endpoint(breaker_key))

    def _call(self, name: str, fn):
        """Thrift round trip under retry + per-gateway breaker; the ``io``
        injection point fires before every attempt. Gets are idempotent;
        puts are last-writer-wins per cell, so a retried put converges."""
        def attempt():
            maybe_fail("io", label=name)
            return fn()

        return with_retries(attempt, name=name, breaker=self._breaker,
                            counter="resilience.io_retries")

    # -- reference HBase.java surface --------------------------------------
    def create_table(self, table: str, *families: str) -> None:
        self._conn.create_table(table, {f: dict() for f in families})

    def set(self, table: str, row_key: str, family: str,
            data: Dict[str, bytes]) -> None:
        cells = {f"{family}:{q}".encode(): v for q, v in data.items()}
        self._call("hbase.put",
                   lambda: self._conn.table(table).put(row_key.encode(),
                                                       cells))

    def get_column(self, table: str, row_key: str, family: str,
                   column: str) -> Optional[bytes]:
        cell = f"{family}:{column}".encode()
        row = self._call("hbase.get", lambda: self._conn.table(table).row(
            row_key.encode(), columns=[cell]))
        return row.get(cell)

    def get_family_columns(self, table: str, row_key: str,
                           family: str) -> Dict[str, bytes]:
        row = self._call("hbase.get", lambda: self._conn.table(table).row(
            row_key.encode(), columns=[family.encode()]))
        return {k.decode().split(":", 1)[1]: v for k, v in row.items()}

    def get_row(self, table: str, row_key: str) -> Dict[str, Dict[str, bytes]]:
        row = self._call("hbase.get",
                         lambda: self._conn.table(table).row(
                             row_key.encode()))
        out: Dict[str, Dict[str, bytes]] = {}
        for k, v in row.items():
            fam, qual = k.decode().split(":", 1)
            out.setdefault(fam, {})[qual] = v
        return out

    def get_rows(self, table: str, row_keys: Sequence[str],
                 family: str) -> List[Dict[str, bytes]]:
        """Batched lookup: one thrift call for all keys, order preserved,
        misses as empty dicts."""
        def fetch():
            tbl = self._conn.table(table)
            return dict(tbl.rows([k.encode() for k in row_keys],
                                 columns=[family.encode()]))

        got = self._call("hbase.mget", fetch)
        out = []
        for k in row_keys:
            row = got.get(k.encode(), {})
            out.append(
                {c.decode().split(":", 1)[1]: v for c, v in row.items()})
        return out

    def close(self) -> None:
        close = getattr(self._conn, "close", None)
        if close:
            close()


class HBaseKvStore(KvStore):
    """`hbase://host:port/table?family=cf` behind the shared KV contract the
    lookup/sink ops speak. Values are stored one qualifier per field; reads
    decode JSON scalars when they parse, raw strings otherwise."""

    def __init__(self, uri: Optional[str] = None, *,
                 client: Optional[HBaseClient] = None,
                 table: Optional[str] = None, family: str = "cf"):
        if client is not None:
            self._client, self._table, self._family = client, table, family
        else:
            if not uri or not uri.startswith("hbase://"):
                raise AkIllegalArgumentException(
                    f"bad hbase uri {uri!r} (want "
                    f"hbase://host:port/table?family=cf)")
            rest = uri[len("hbase://"):]
            hostport, _, tail = rest.partition("/")
            table, _, query = tail.partition("?")
            family = "cf"
            for kv in query.split("&"):
                if kv.startswith("family="):
                    family = kv.split("=", 1)[1]
            host, _, port = hostport.partition(":")
            if not host:
                raise AkIllegalArgumentException(
                    f"hbase uri {uri!r} names no host")
            if not table:
                raise AkIllegalArgumentException(
                    f"hbase uri {uri!r} names no table")
            self._client = HBaseClient(
                thrift_host=host, thrift_port=int(port or 9090))
            self._table, self._family = table, family
        if not self._table:
            raise AkIllegalArgumentException("HBase store needs a table")

    @staticmethod
    def _decode(raw: Dict[str, bytes]) -> Optional[dict]:
        if not raw:
            return None
        out = {}
        for q, v in raw.items():
            s = v.decode("utf-8", "replace")
            try:
                out[q] = json.loads(s)
            except (ValueError, TypeError):
                out[q] = s
        return out

    def get(self, key: str) -> Optional[dict]:
        return self._decode(
            self._client.get_family_columns(self._table, key, self._family))

    def mget(self, keys: Sequence[str]) -> List[Optional[dict]]:
        rows = self._client.get_rows(self._table, list(keys), self._family)
        return [self._decode(r) for r in rows]

    def set(self, key: str, value: dict) -> None:
        data = {q: json.dumps(v).encode() for q, v in value.items()}
        self._client.set(self._table, key, self._family, data)

    def close(self) -> None:
        self._client.close()
