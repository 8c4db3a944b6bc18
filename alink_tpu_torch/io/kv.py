"""Key-value store connectors: Redis/HBase-style lookup + sink backends
(port of ``alink_tpu.io.kv``; host code, as in the reference).

Capability parity with the reference's KV serving edges (reference:
operator/batch/dataproc/LookupRedisBatchOp.java, LookupHBaseBatchOp.java
(rowkey → column family values), connectors/connector-redis RedisSink,
catalog family common/io/catalog/BaseCatalog.java for metadata stores).

Design: lookups are host-side row decoration around the device
compute path, so the connector is a :class:`KvStore` interface with
scheme-dispatched backends: ``memory://<name>`` (process-global dict store
— the test double and single-process cache), ``redis://host:port/db``
(plugin-gated on the redis package, exactly like the reference's connector
jars). Values travel as JSON objects keyed by output column."""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Sequence

from ..common.exceptions import (
    AkIllegalArgumentException,
    AkPluginNotExistException,
)


class KvStore:
    """get/mget/set over string keys; values are JSON-encodable dicts."""

    def get(self, key: str) -> Optional[dict]:
        raise NotImplementedError

    def mget(self, keys: Sequence[str]) -> List[Optional[dict]]:
        return [self.get(k) for k in keys]

    def mget_raw(self, keys: Sequence[str]) -> List[Optional[str]]:
        """The stored values as RAW strings (plain-string Redis semantics —
        LookupRedisStringBatchOp). Default: the wire JSON, with single-field
        rows collapsed to their value's string form."""
        out: List[Optional[str]] = []
        for h in self.mget(keys):
            if h is None:
                out.append(None)
            elif isinstance(h, dict) and len(h) == 1:
                v = next(iter(h.values()))
                out.append(None if v is None else str(v))
            else:
                out.append(json.dumps(h))
        return out

    def set(self, key: str, value: dict) -> None:
        raise NotImplementedError

    def close(self) -> None:
        pass


class MemoryKvStore(KvStore):
    """Process-global named stores (``memory://<name>``)."""

    _named: Dict[str, Dict[str, dict]] = {}

    def __init__(self, name: str):
        self._data = self._named.setdefault(name, {})

    def get(self, key: str) -> Optional[dict]:
        return self._data.get(key)

    def set(self, key: str, value: dict) -> None:
        self._data[key] = dict(value)


class RedisKvStore(KvStore):
    """redis:// backend, plugin-gated (reference: connector-redis)."""

    def __init__(self, uri: str):
        try:
            import redis
        except ImportError as e:
            raise AkPluginNotExistException(
                "redis:// KV ops need the 'redis' package (the "
                "connector-redis plugin analog): pip install redis") from e
        self._client = redis.Redis.from_url(uri)

    def get(self, key: str) -> Optional[dict]:
        raw = self._client.get(key)
        return None if raw is None else json.loads(raw)

    def mget(self, keys: Sequence[str]) -> List[Optional[dict]]:
        out = []
        for raw in self._client.mget(list(keys)):
            out.append(None if raw is None else json.loads(raw))
        return out

    def mget_raw(self, keys: Sequence[str]) -> List[Optional[str]]:
        # TRUE raw GET — plain-string values stored by other writers
        return [None if raw is None else
                (raw.decode() if isinstance(raw, bytes) else str(raw))
                for raw in self._client.mget(list(keys))]

    def set(self, key: str, value: dict) -> None:
        self._client.set(key, json.dumps(value))

    def close(self) -> None:
        self._client.close()


def open_kv_store(uri: str) -> KvStore:
    if uri.startswith("memory://"):
        return MemoryKvStore(uri[len("memory://"):])
    if uri.startswith(("redis://", "rediss://", "unix://")):
        return RedisKvStore(uri)
    if uri.startswith("hbase://"):
        from .hbase import HBaseKvStore  # plugin-gated on happybase

        return HBaseKvStore(uri)
    raise AkIllegalArgumentException(
        f"unsupported KV store uri '{uri}' (memory:// / redis:// / "
        f"hbase://host:port/table?family=cf)")


def __getattr__(name):
    # the op classes live in the operator layer; keep this import path
    # working for users who reach for alink_tpu_torch.io.kv directly
    if name in ("LookupKvBatchOp", "KvSinkBatchOp"):
        from ..operator.batch.connectors import (  # noqa: PLC0415
            KvSinkBatchOp,
            LookupKvBatchOp,
        )

        return {"LookupKvBatchOp": LookupKvBatchOp,
                "KvSinkBatchOp": KvSinkBatchOp}[name]
    raise AttributeError(name)
