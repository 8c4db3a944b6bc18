"""Stream fault tolerance: epoch recovery runtime + legacy offset journal
(port of ``alink_tpu.operator.stream.checkpoint``, copied).

Capability parity with the reference's streaming resilience (reference:
operator/stream/StreamOperator.java:220 ``setCheckPointConf`` — Flink
checkpointing of source offsets + operator state via asynchronous barrier
snapshotting, Carbone et al. 2015; online-learning jobs additionally
re-seed from the last emitted model snapshot, FtrlTrainStreamOp.java:67).

Design for the micro-batch runtime — two tiers:

1. **Epoch recovery runtime** (``common/recovery.py``, re-exported here):
   the platform's END-TO-END EXACTLY-ONCE tier. A
   :class:`~alink_tpu_torch.common.recovery.CheckpointCoordinator` cuts the
   stream into epochs of N source chunks and, at each quiescent barrier,
   atomically persists a snapshot manifest — source offset, per-operator
   state blobs (``StreamOperator.state_snapshot()``: FTRL/OnlineFm
   accumulators, open window buffers, cumulative eval counters), and
   per-sink committed epochs — then publishes every transactional sink's
   staged epoch. MULTI-SINK epoch contract: the manifest is one atomic
   commit point covering ALL sinks; each sink records its own committed
   epoch (in the target itself when it supports transactions, else a
   marker file), uncommitted epochs replay idempotently from the staged
   blob on restart, and the coordinator acks — retains snapshots by —
   the MINIMUM committed epoch across sinks. Fan-out pipelines therefore
   checkpoint correctly: a fast sink can never journal past a slow one,
   which retires the old single-consumer restriction of this module.
   ``run_with_recovery(job_factory, restart_policy)`` supervises the job:
   crashes (including the injected ``crash`` fault kind) restart from the
   latest snapshot, and the recovered run is bit-identical to a
   fault-free run.

2. **Legacy offset journal** (this module): :class:`StreamCheckpoint` +
   :class:`CheckpointedSourceStreamOp` + :class:`AckCheckpointStreamOp`
   journal only the last sink-acked chunk id — AT-LEAST-ONCE source
   replay with no operator state, still the right tool for a single
   stateless map/sink chain where replaying a chunk is harmless. The ack
   op keeps its 1-in-1-out alignment contract and must feed exactly one
   consumer; anything needing several sinks or stateful operators should
   use the epoch runtime above instead.

Without either tier the runtime is AT-MOST-ONCE per chunk (a crash loses
the in-flight chunk) — that default contract is documented here rather
than hidden.
"""

from __future__ import annotations

import json
import logging
from typing import Iterator

from ...common.metrics import metrics
from ...common.mtable import MTable, TableSchema
# re-exported so stream users find the exactly-once tier where the
# reference keeps its checkpoint configuration
from ...common.recovery import (  # noqa: F401
    CheckpointCoordinator,
    RecoverableStreamJob,
    SnapshotStore,
    TransactionalSink,
    _durable_write,
    run_with_recovery,
)
from ...io.filesystem import file_open, get_file_system
from .base import StreamOperator

logger = logging.getLogger("alink_tpu_torch.checkpoint")


class StreamCheckpoint:
    """Durable chunk-offset journal on any filesystem scheme (the Flink
    checkpoint-store analog, one json file per stream job)."""

    def __init__(self, state_path: str):
        self.path = state_path
        self._fs = get_file_system(state_path)
        parent = state_path.rsplit("/", 1)[0] if "/" in state_path else "."
        self._fs.makedirs(parent)

    def last_acked(self) -> int:
        """The last durably acked chunk id, or -1 for "no checkpoint".

        This runs on exactly the restart-after-crash path, so it must
        survive what crashes leave behind: a journal truncated mid-write or
        corrupted reads as "no checkpoint" (full at-least-once replay —
        always safe, never lossy) instead of crashing the resuming job,
        and a stale ``.tmp`` from an interrupted :meth:`ack` is removed."""
        tmp = self.path + ".tmp"
        try:
            if self._fs.exists(tmp):
                self._fs.delete(tmp)
        except OSError as e:
            logger.warning("could not clean stale checkpoint tmp %s: %s",
                           tmp, e)
        if not self._fs.exists(self.path):
            return -1
        try:
            with file_open(self.path) as f:
                return int(json.load(f).get("last_acked", -1))
        except (ValueError, TypeError, KeyError, AttributeError,
                OSError) as e:
            # json.JSONDecodeError is a ValueError; int(None) a TypeError;
            # a valid-JSON-but-non-dict journal ('[1]', '3') an AttributeError
            logger.warning(
                "unreadable checkpoint journal %s (%s: %s) — treating as "
                "no checkpoint; the stream replays from the beginning "
                "(at-least-once)", self.path, type(e).__name__, e)
            return -1

    def ack(self, chunk_id: int) -> None:
        """Durably journal ``chunk_id``: the tmp file is flushed AND fsynced
        before the rename (the shared write-tmp→fsync→rename sequence the
        snapshot store uses), so an ack that returned survives power loss —
        rename-without-fsync can leave a zero-length journal on crash,
        which would silently replay the whole stream."""
        _durable_write(self._fs, self.path,
                       json.dumps({"last_acked": int(chunk_id)}).encode())

    def reset(self) -> None:
        """Clear the journal (full replay on next run). Never raises when
        there is nothing to clear — resetting a job that has not run yet
        is a no-op, not an error — and also clears a stale ``.tmp``."""
        for path in (self.path, self.path + ".tmp"):
            try:
                if self._fs.exists(path):
                    self._fs.delete(path)
            except OSError as e:
                logger.warning("checkpoint reset could not delete %s: %s",
                               path, e)


class CheckpointedSourceStreamOp(StreamOperator):
    """Wrap any stream source with replay-on-restart: chunks whose ids are
    already acked (by :class:`AckCheckpointStreamOp` downstream) are
    re-read from the source but NOT re-emitted. Each skipped chunk counts
    in the ``checkpoint.replayed_chunks`` metric and a resume-from-journal
    in ``checkpoint.restores`` — replay volume is an operational signal
    (how much work every crash costs), not something to do silently."""

    _max_inputs = 0

    def __init__(self, inner: StreamOperator, checkpoint: StreamCheckpoint,
                 params=None, **kwargs):
        super().__init__(params, **kwargs)
        self._inner = inner
        self._checkpoint = checkpoint

    def _stream_impl(self) -> Iterator[MTable]:
        start = self._checkpoint.last_acked() + 1
        if start > 0:
            metrics.incr("checkpoint.restores")
        for i, chunk in enumerate(self._inner._stream()):
            if i < start:
                # replayed and already processed — skip, but count it
                metrics.incr("checkpoint.replayed_chunks")
                continue
            yield chunk

    def _out_schema(self) -> TableSchema:
        return self._inner._out_schema()


class AckCheckpointStreamOp(StreamOperator):
    """Pass-through that acknowledges each chunk AFTER downstream-of-source
    processing reached it; place it at the end of the pipeline with ONE
    consumer (see the module's legacy-tier contract — multi-sink pipelines
    belong on the epoch recovery runtime)."""

    _min_inputs = 1
    _max_inputs = 1

    def __init__(self, checkpoint: StreamCheckpoint, params=None, **kwargs):
        super().__init__(params, **kwargs)
        self._checkpoint = checkpoint

    def _stream_impl(self, it: Iterator[MTable]) -> Iterator[MTable]:
        chunk_id = self._checkpoint.last_acked()
        for chunk in it:
            chunk_id += 1
            yield chunk
            self._checkpoint.ack(chunk_id)

    def _out_schema(self, in_schema: TableSchema) -> TableSchema:
        return in_schema
