"""Kafka stream connector: topic source/sink for the micro-batch runtime
(port of ``alink_tpu.io.kafka``, copied).

Capability parity with the reference's Kafka connector (reference:
connectors/connector-kafka/ — KafkaSourceBuilder/KafkaSinkBuilder over
flink-connector-kafka; operator/stream/source/KafkaSourceStreamOp.java with
bootstrapServers/topic/groupId/startupMode properties; sink counterpart
KafkaSinkStreamOp.java serializing rows as CSV or JSON messages).

Design: Kafka is host-side IO — no device work — so the connector's
job is to turn a topic into the micro-batch MTable chunks every stream op
consumes (and back). The client library (kafka-python) is plugin-gated
exactly like the reference's connector jars: constructing the op without it
raises actionable guidance. Tests (and single-process demos) run against
:class:`MemoryKafkaBroker`, an in-process broker speaking the same
consumer/producer protocol surface the ops use — the MiniCluster analog for
the messaging edge.
"""

from __future__ import annotations

import csv
import io
import json
import threading
import time
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..common.exceptions import AkPluginNotExistException
from ..common.mtable import MTable, TableSchema
from ..common.resilience import CircuitBreaker, with_retries


# -- in-process broker (test double / demo transport) -------------------------


class _MemoryConsumer:
    def __init__(self, broker: "MemoryKafkaBroker", topic: str,
                 start_offset: int):
        self._broker, self._topic = broker, topic
        self._offset = start_offset

    def poll_batch(self, max_records: int, timeout_ms: int) -> List[bytes]:
        deadline = time.monotonic() + timeout_ms / 1000.0
        while True:
            log = self._broker._topics.get(self._topic, [])
            if self._offset < len(log):
                out = log[self._offset:self._offset + max_records]
                self._offset += len(out)
                return list(out)
            if time.monotonic() >= deadline:
                return []
            time.sleep(0.005)

    def close(self):
        pass


class MemoryKafkaBroker:
    """Append-only per-topic logs with offset-tracking consumers — the
    embedded-broker test double (the reference tests Kafka ops against an
    embedded KafkaServer the same way)."""

    _named: Dict[str, "MemoryKafkaBroker"] = {}

    def __init__(self):
        self._topics: Dict[str, List[bytes]] = {}
        self._txn_epochs: Dict[str, int] = {}
        self._txn_lock = threading.Lock()

    @classmethod
    def named(cls, name: str) -> "MemoryKafkaBroker":
        """Process-global broker registry, so ops in different threads of
        one demo share a broker by ``bootstrapServers='memory://<name>'``."""
        if name not in cls._named:
            cls._named[name] = cls()
        return cls._named[name]

    def produce(self, topic: str, payload: bytes):
        self._topics.setdefault(topic, []).append(bytes(payload))

    # -- transactional produce (the Kafka-transactions analog) ---------------
    def produce_txn(self, topic: str, payloads: Sequence[bytes],
                    txn_key: str, epoch: int) -> bool:
        """Atomically append ``payloads`` AND record ``epoch`` as committed
        for ``txn_key`` — one lock, so a crash can never land between the
        data and the commit marker. Idempotent: an epoch at or below the
        recorded one is a no-op (the exactly-once replay path re-offers
        committed epochs after a crash). Returns True if appended."""
        with self._txn_lock:
            if self._txn_epochs.get(txn_key, -1) >= epoch:
                return False
            self._topics.setdefault(topic, []).extend(
                bytes(p) for p in payloads)
            self._txn_epochs[txn_key] = int(epoch)
            return True

    def txn_epoch(self, txn_key: str) -> int:
        """Last epoch committed under ``txn_key``, or -1."""
        with self._txn_lock:
            return self._txn_epochs.get(txn_key, -1)

    def consumer(self, topic: str, startup_mode: str = "EARLIEST"
                 ) -> _MemoryConsumer:
        start = 0
        if startup_mode == "LATEST":
            start = len(self._topics.get(topic, []))
        return _MemoryConsumer(self, topic, start)

    def end_offset(self, topic: str) -> int:
        return len(self._topics.get(topic, []))


# -- kafka-python adapters (the plugin path) ----------------------------------


def _require_kafka():
    try:
        import kafka  # noqa: F401 — kafka-python

        return kafka
    except ImportError as e:
        raise AkPluginNotExistException(
            "Kafka ops need the 'kafka-python' package (the connector-kafka "
            "plugin analog): pip install kafka-python") from e


class _KafkaPythonConsumer:
    def __init__(self, servers: str, topic: str, group_id: Optional[str],
                 startup_mode: str):
        kafka = _require_kafka()
        # broker bootstrap is the flakiest moment of a consumer's life
        # (NoBrokersAvailable during a rolling restart is routine): retry
        # under the central policy behind a per-cluster breaker.
        # kafka-python errors carry `.retriable`, which is_retryable honors.
        self._consumer = with_retries(
            lambda: kafka.KafkaConsumer(
                topic,
                bootstrap_servers=servers.split(","),
                group_id=group_id,
                auto_offset_reset=(
                    "earliest" if startup_mode == "EARLIEST" else "latest"),
                enable_auto_commit=True,
            ),
            name="kafka.connect",
            breaker=CircuitBreaker.for_endpoint(f"kafka:{servers}"),
            counter="resilience.io_retries")

    def poll_batch(self, max_records: int, timeout_ms: int) -> List[bytes]:
        polled = self._consumer.poll(
            timeout_ms=timeout_ms, max_records=max_records)
        out: List[bytes] = []
        for records in polled.values():
            out.extend(r.value for r in records)
        return out

    def close(self):
        self._consumer.close()


def _open_consumer(servers: str, topic: str, group_id: Optional[str],
                   startup_mode: str):
    if servers.startswith("memory://"):
        return MemoryKafkaBroker.named(
            servers[len("memory://"):]).consumer(topic, startup_mode)
    return _KafkaPythonConsumer(servers, topic, group_id, startup_mode)


class _MemoryProducer:
    def __init__(self, broker: "MemoryKafkaBroker"):
        self._broker = broker

    def send(self, topic: str, payload: bytes):
        self._broker.produce(topic, payload)

    def flush(self):
        pass

    def close(self):
        pass


class _KafkaPythonProducer:
    def __init__(self, servers: str):
        kafka = _require_kafka()
        self._producer = with_retries(
            lambda: kafka.KafkaProducer(
                bootstrap_servers=servers.split(",")),
            name="kafka.connect",
            breaker=CircuitBreaker.for_endpoint(f"kafka:{servers}"),
            counter="resilience.io_retries")

    def send(self, topic: str, payload: bytes):
        self._producer.send(topic, payload)

    def flush(self):
        # kafka-python buffers sends in memory; an unflushed short stream
        # would silently lose its tail on process exit
        self._producer.flush()

    def close(self):
        self._producer.close()


def _open_producer(servers: str):
    if servers.startswith("memory://"):
        return _MemoryProducer(MemoryKafkaBroker.named(
            servers[len("memory://"):]))
    return _KafkaPythonProducer(servers)


# -- message codecs -----------------------------------------------------------


def _decode_rows(payloads: Sequence[bytes], schema: TableSchema,
                 fmt: str, delimiter: str) -> MTable:
    from ..common.exceptions import AkIllegalDataException
    from ..common.mtable import AlinkTypes

    numeric = [AlinkTypes.is_numeric(tp) or tp == AlinkTypes.BOOLEAN
               for tp in schema.types]
    int_cols = [tp in (AlinkTypes.LONG, AlinkTypes.INT)
                for tp in schema.types]
    rows = []
    for p in payloads:
        text = p.decode("utf-8")
        if fmt == "JSON":
            obj = json.loads(text)
            row = tuple(obj.get(n) for n in schema.names)
        else:  # CSV — proper quoting so delimiter-bearing fields survive;
            # empty numeric fields are NULLs (the sink writes None as "")
            parsed = next(csv.reader([text], delimiter=delimiter))
            row = tuple(
                None if (v == "" and num) else v
                for v, num in zip(parsed, numeric))
        for v, is_int, name in zip(row, int_cols, schema.names):
            if v is None and is_int:
                # integer columns have no NULL representation (nullable
                # numerics are DOUBLE+NaN framework-wide)
                raise AkIllegalDataException(
                    f"NULL in integer column '{name}' of a Kafka message; "
                    "declare the column as double to carry NULLs as NaN")
        rows.append(row)
    return MTable.from_rows(rows, schema)


def _encode_row(names: Sequence[str], row: Sequence, fmt: str,
                delimiter: str) -> bytes:
    if fmt == "JSON":
        def clean(v):
            if isinstance(v, (np.integer,)):
                return int(v)
            if isinstance(v, (np.floating,)):
                return float(v)
            if isinstance(v, (np.bool_,)):
                return bool(v)
            return v

        return json.dumps({n: clean(v) for n, v in zip(names, row)}
                          ).encode("utf-8")
    buf = io.StringIO()
    csv.writer(buf, delimiter=delimiter, lineterminator="").writerow(
        ["" if v is None else v for v in row])
    return buf.getvalue().encode("utf-8")


def __getattr__(name):
    # the op classes live in the operator layer; keep this import path
    # working for users who reach for alink_tpu_torch.io.kafka directly
    if name in ("KafkaSourceStreamOp", "KafkaSinkStreamOp"):
        from ..operator.stream.connectors import (  # noqa: PLC0415
            KafkaSinkStreamOp,
            KafkaSourceStreamOp,
        )

        return {"KafkaSourceStreamOp": KafkaSourceStreamOp,
                "KafkaSinkStreamOp": KafkaSinkStreamOp}[name]
    raise AttributeError(name)
