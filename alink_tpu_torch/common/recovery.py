"""Epoch-based exactly-once stream recovery runtime (port of
``alink_tpu.common.recovery``, copied).

The reference platform gets streaming fault tolerance from Flink's
asynchronous barrier snapshotting (``StreamOperator.setCheckPointConf`` —
source offsets PLUS operator state, per Carbone et al., *Lightweight
Asynchronous Snapshots for Distributed Dataflows*, 2015). An offset
journal alone (``operator/stream/checkpoint.StreamCheckpoint``) records
only a sink-acked chunk offset: a crash loses all
stateful-operator progress (FTRL/OnlineFm accumulators, open window
buffers), replay double-emits into sinks, and the single-consumer ack
contract forbids multi-sink pipelines. This module closes that gap with
the micro-batch analog of barrier snapshotting plus MillWheel-style
idempotent per-epoch sink commits (Akidau et al., 2013):

- :class:`SnapshotStore` — durable snapshot manifests on the pluggable
  filesystem abstraction: per epoch, a JSON manifest (source offset,
  per-sink committed epoch, blob checksum) plus a pickled state blob
  (operator states, staged sink payloads). The manifest rename is the
  atomic commit point; the last K snapshots are retained.
- :class:`TransactionalSink` — wraps a connector sink implementing the
  ``_txn_*`` protocol (``KvSinkStreamOp``, ``KafkaSinkStreamOp``,
  ``DatahubSinkStreamOp``) in stage→commit: outputs stage in memory
  during the epoch, persist in the snapshot blob at the barrier, and only
  publish to the real target AFTER the manifest commits. A crash between
  manifest and publish replays the staged payload idempotently on
  restart (memory:// targets commit data + epoch marker atomically —
  true exactly-once; wire targets without transactions fall back to a
  marker file, leaving an explicit publish→marker at-least-once window).
- :class:`CheckpointCoordinator` — cuts the stream into epochs of
  ``epoch_chunks`` source chunks. Each chain of operators runs in its own
  thread against a shared, budget-gated source reader; when every chain
  has drained the epoch and is parked at the budget gate, there is no
  in-flight data anywhere — all progress lives in operator instance
  state — so the coordinator snapshots ``state_snapshot()`` of every
  stateful op consistently, writes the manifest, then commits all sinks.
  Because the manifest covers EVERY sink atomically, the old
  single-consumer restriction is gone: the coordinator acks (retains
  snapshots by) the minimum committed epoch across all sinks.
- :func:`run_with_recovery` — the supervised restart driver: builds a
  fresh job from a factory, and on a restartable failure (the
  ``is_retryable`` taxonomy plus the injected ``crash`` kind) restarts it
  from the latest snapshot under a :class:`RetryPolicy` backoff budget.

Headline invariant (CI-pinned in ``tests/test_recovery.py``): a
crash-injected supervised run of a stateful multi-sink pipeline produces
sink output **bit-identical** to the fault-free run, with operator state
restored mid-stream rather than replayed from chunk 0.

Requirements on the job: the source must be deterministically replayable
(same chunks in the same order on every run — table/file sources, or bus
sources re-read from a fixed offset), and the job factory must build
fresh operator instances per attempt (generators are one-shot).
"""

from __future__ import annotations

import json
import logging
import os
import pickle
import threading
import time
import zlib
from typing import (Any, Callable, Dict, Iterator, List, Optional, Sequence,
                    Tuple)

from .exceptions import (AkIllegalArgumentException, AkIllegalStateException,
                         is_retryable)
from .faults import InjectedCrashError, maybe_fail
from .metrics import metrics
from .resilience import RetryPolicy, retries_enabled, with_retries
from .tracing import attach_context, capture_context, trace_span

logger = logging.getLogger("alink_tpu_torch.recovery")

_END = object()  # source-exhausted sentinel inside the shared reader


class _RescaleInterrupt(BaseException):
    """Raised inside parked chain generators when the elastic coordinator
    tears a generation down at a quiescent epoch barrier (rescale). A
    BaseException on purpose: it must unwind straight through operator
    generators — skipping their end-of-stream flush code — and through any
    ``except Exception`` an op might hold, exactly like GeneratorExit."""


# ---------------------------------------------------------------------------
# Durable snapshot store
# ---------------------------------------------------------------------------


def _durable_write(fs, path: str, data: bytes) -> None:
    """Write-tmp → flush → fsync → rename: the bytes are on disk before the
    name exists, so a reader never sees a half-written file and a rename
    that survived power loss implies the payload did too."""
    tmp = path + ".tmp"
    f = fs.open(tmp, "wb")
    try:
        f.write(data)
        f.flush()
        try:
            os.fsync(f.fileno())
        except (AttributeError, OSError, ValueError):
            pass  # remote stores: durability is the store's close contract
    finally:
        f.close()
    fs.rename(tmp, path)


class SnapshotStore:
    """Per-epoch snapshot manifests + state blobs + per-sink commit markers
    in one checkpoint directory (any ``scheme://`` the filesystem layer
    speaks). Layout::

        <dir>/epoch-000000000007.json   # manifest (atomic commit point)
        <dir>/epoch-000000000007.blob   # pickled operator + staged state
        <dir>/sink-1a2b3c4d.commit      # fallback per-sink committed epoch
    """

    def __init__(self, ckpt_dir: str, keep: int = 3):
        from ..io.filesystem import get_file_system

        self.dir = str(ckpt_dir).rstrip("/")
        self.keep = max(1, int(keep))
        self._fs = get_file_system(self.dir)
        self._fs.makedirs(self.dir)

    # -- paths ---------------------------------------------------------------
    def _manifest_path(self, epoch: int) -> str:
        return self._fs.join(self.dir, f"epoch-{epoch:012d}.json")

    def _blob_path(self, epoch: int) -> str:
        return self._fs.join(self.dir, f"epoch-{epoch:012d}.blob")

    def _marker_path(self, sink_id: str) -> str:
        tag = f"{zlib.crc32(sink_id.encode()):08x}"
        return self._fs.join(self.dir, f"sink-{tag}.commit")

    # -- snapshots -----------------------------------------------------------
    def epochs(self) -> List[int]:
        try:
            names = self._fs.listdir(self.dir)
        except OSError:
            return []
        out = []
        for n in names:
            if n.startswith("epoch-") and n.endswith(".json"):
                try:
                    out.append(int(n[len("epoch-"):-len(".json")]))
                except ValueError:
                    continue
        return sorted(out)

    def write_snapshot(self, epoch: int, manifest: Dict[str, Any],
                       blob: Dict[str, Any]) -> None:
        """Blob first, then the manifest referencing it — the manifest
        rename is the epoch's atomic commit point."""
        data = pickle.dumps(blob, protocol=pickle.HIGHEST_PROTOCOL)
        _durable_write(self._fs, self._blob_path(epoch), data)
        m = dict(manifest)
        m["epoch"] = int(epoch)
        m["blob_crc32"] = zlib.crc32(data)
        m["blob_bytes"] = len(data)
        _durable_write(self._fs, self._manifest_path(epoch),
                       json.dumps(m, default=str).encode())

    def read_manifest(self, epoch: int) -> Dict[str, Any]:
        f = self._fs.open(self._manifest_path(epoch), "rb")
        try:
            m = json.loads(f.read().decode())
        finally:
            f.close()
        if not isinstance(m, dict) or m.get("epoch") != epoch:
            raise AkIllegalStateException(
                f"snapshot manifest for epoch {epoch} is malformed")
        return m

    def read_blob(self, epoch: int,
                  manifest: Optional[Dict[str, Any]] = None
                  ) -> Dict[str, Any]:
        f = self._fs.open(self._blob_path(epoch), "rb")
        try:
            data = f.read()
        finally:
            f.close()
        if manifest is not None and \
                manifest.get("blob_crc32") != zlib.crc32(data):
            raise AkIllegalStateException(
                f"snapshot blob for epoch {epoch} fails its checksum")
        return pickle.loads(data)

    def load_latest(self) -> Optional[Tuple[int, Dict[str, Any],
                                            Dict[str, Any]]]:
        """Newest fully-readable snapshot as (epoch, manifest, blob), or
        None. Crash debris — a manifest without its blob, a truncated
        file, a checksum mismatch — is skipped with a warning and the next
        older snapshot is tried: restart must never be wedged by exactly
        the garbage a crash produces."""
        for epoch in reversed(self.epochs()):
            try:
                manifest = self.read_manifest(epoch)
                blob = self.read_blob(epoch, manifest)
                return epoch, manifest, blob
            except Exception as e:
                logger.warning(
                    "snapshot epoch %d unreadable (%s: %s) — trying the "
                    "previous one", epoch, type(e).__name__, e)
        return None

    def retain(self, min_committed_epoch: int) -> None:
        """Keep the newest ``keep`` snapshots; older ones are deleted only
        once every sink has committed past them (the coordinator acks the
        MINIMUM committed epoch across sinks, so a lagging sink pins the
        snapshots its uncommitted epochs still need)."""
        eps = self.epochs()
        for e in eps[:-self.keep]:
            if e < min_committed_epoch:
                for path in (self._blob_path(e), self._manifest_path(e)):
                    try:
                        self._fs.delete(path)
                    except OSError as exc:
                        logger.warning("could not prune snapshot %s: %s",
                                       path, exc)

    # -- sink commit markers -------------------------------------------------
    def write_sink_marker(self, sink_id: str, epoch: int) -> None:
        _durable_write(
            self._fs, self._marker_path(sink_id),
            json.dumps({"sink_id": sink_id, "epoch": int(epoch)}).encode())

    def sink_marker(self, sink_id: str) -> int:
        path = self._marker_path(sink_id)
        try:
            if not self._fs.exists(path):
                return -1
            f = self._fs.open(path, "rb")
            try:
                rec = json.loads(f.read().decode())
            finally:
                f.close()
            if not isinstance(rec, dict) or rec.get("sink_id") != sink_id:
                return -1
            return int(rec.get("epoch", -1))
        except (OSError, ValueError, TypeError) as e:
            logger.warning("unreadable sink marker for %s (%s) — treating "
                           "as never-committed (idempotent replay)",
                           sink_id, e)
            return -1


# ---------------------------------------------------------------------------
# Transactional sinks
# ---------------------------------------------------------------------------


class TransactionalSink:
    """Stage→commit adapter over a connector sink op implementing the
    ``_txn_*`` protocol (``txn_sink_id``, ``_txn_open``, ``_txn_commit``,
    ``_txn_committed_epoch``, ``_txn_close``)."""

    def __init__(self, op, scope: str = ""):
        for attr in ("txn_sink_id", "_txn_open", "_txn_commit",
                     "_txn_committed_epoch", "_txn_close"):
            if not hasattr(op, attr):
                raise AkIllegalArgumentException(
                    f"{type(op).__name__} is not epoch-transactional (no "
                    f"{attr}); use KvSinkStreamOp / KafkaSinkStreamOp / "
                    "DatahubSinkStreamOp or implement the _txn_* protocol")
        self.op = op
        self.sink_id: str = op.txn_sink_id()
        # target-side commit markers are keyed by (job, sink): epoch
        # numbers restart at 0 for every job, so a marker keyed by the
        # target alone would let job A's epoch 9 silently swallow job B's
        # epochs 0..9 on a shared broker/store. The scope (the job's
        # checkpoint dir) is stable across restarts and distinct per job.
        self.scope = scope
        self._staged: List[Any] = []
        self._handle = None
        self._opened = False

    @property
    def txn_key(self) -> str:
        return f"{self.scope}::{self.sink_id}" if self.scope \
            else self.sink_id

    # staging happens on the owning chain thread; the coordinator only
    # reads it while every chain is parked at the epoch barrier
    def stage(self, chunk) -> None:
        self._staged.append(chunk)

    def staged(self) -> List[Any]:
        return list(self._staged)

    def clear_staged(self) -> None:
        self._staged = []

    @property
    def handle(self):
        if not self._opened:
            self._handle = self.op._txn_open()
            self._opened = True
        return self._handle

    def committed_epoch(self, store: SnapshotStore) -> int:
        """Target-side committed epoch when the target supports it (the
        exactly-once path), else the coordinator's marker file."""
        target = self.op._txn_committed_epoch(self.handle, self.txn_key)
        return store.sink_marker(self.sink_id) if target is None \
            else int(target)

    def commit(self, epoch: int, chunks: Sequence[Any],
               store: SnapshotStore) -> None:
        mode = with_retries(
            lambda: self.op._txn_commit(self.handle, epoch, list(chunks),
                                        self.txn_key),
            name=f"txn.{self.sink_id}", counter="resilience.io_retries")
        if mode != "target":
            # marker-file fallback ONLY for targets without their own
            # transactional marker; "target" sinks committed data + epoch
            # atomically and a second durable write would be pure overhead
            store.write_sink_marker(self.sink_id, epoch)
        metrics.incr("recovery.sink_commits")

    def close(self) -> None:
        if self._opened:
            try:
                self.op._txn_close(self._handle)
            except Exception as e:
                logger.warning("sink %s close failed: %s", self.sink_id, e)
            self._opened = False
            self._handle = None


# ---------------------------------------------------------------------------
# Job topology
# ---------------------------------------------------------------------------


class RecoverableStreamJob:
    """A recoverable topology: ONE deterministically-replayable source
    fanning out to one or more linear operator chains, each feeding one or
    more transactional sinks::

        job = RecoverableStreamJob(
            source=TableSourceStreamOp(t, chunkSize=32),
            chains=[
                ([TumbleTimeWindowStreamOp(...)], [kafka_sink]),
                ([FtrlTrainStreamOp(...)],        [datahub_sink]),
            ],
            checkpoint_dir="/jobs/ck/my-job", epoch_chunks=4)

    Restart requires the same topology (chains/ops in the same order) —
    operator state is keyed by position in it."""

    def __init__(self, source, chains: Sequence[Tuple[Sequence[Any],
                                                      Sequence[Any]]],
                 checkpoint_dir: str, epoch_chunks: int = 1,
                 keep_snapshots: int = 3, publishers: Sequence[Any] = ()):
        if not chains:
            raise AkIllegalArgumentException("job needs >= 1 chain")
        if getattr(source, "_max_inputs", None) != 0:
            raise AkIllegalArgumentException(
                f"{type(source).__name__} is not a source op (it takes "
                "inputs); a recoverable job starts from one replayable "
                "source")
        self.source = source
        self.checkpoint_dir = checkpoint_dir
        self.epoch_chunks = max(1, int(epoch_chunks))
        self.keep_snapshots = keep_snapshots
        chains = [(list(ops), list(sinks)) for ops, sinks in chains]
        # modelstream publishers ride the epoch barrier: bind each to its
        # chain op now (stamping feeds the ALK109 pre-flight rule below)
        self.publishers = list(publishers or [])
        for pub in self.publishers:
            if not (0 <= pub.chain < len(chains)) or \
                    not (0 <= pub.op_index < len(chains[pub.chain][0])):
                raise AkIllegalArgumentException(
                    f"publisher {pub.name!r} binds chain {pub.chain} op "
                    f"{pub.op_index}, which this job does not have")
            pub.validate_target(chains[pub.chain][0][pub.op_index])
        # opt-in pre-flight with recovery escalation: under
        # ALINK_VALIDATE_PLAN, missing-snapshot-hook (ALK104) reads as an
        # ERROR here — the structured report lands before the hard
        # per-op refusals below raise their first bare message
        from ..analysis import preflight

        preflight([source] + [op for ops, _ in chains for op in ops],
                  where="recovery.build", recovery=True)
        self.chains: List[Tuple[List[Any], List[TransactionalSink]]] = []
        seen_ops: set = set()
        seen_sinks: set = set()
        for ops, sinks in chains:
            ops = list(ops)
            for op in ops:
                if getattr(op, "_min_inputs", None) != 1 or \
                        getattr(op, "_max_inputs", None) != 1:
                    raise AkIllegalArgumentException(
                        f"{type(op).__name__} is not a single-input stream "
                        "op; recoverable chains are linear (fan out via "
                        "multiple chains/sinks instead)")
                if getattr(op, "_stateful_unhooked", False):
                    raise AkIllegalArgumentException(
                        f"{type(op).__name__} keeps cross-chunk state "
                        "without state_snapshot/state_restore hooks; "
                        "restoring it as stateless would silently break "
                        "exactly-once. Use a hooked operator (windows, "
                        "FTRL/OnlineFm, eval streams) or add the hooks.")
                if id(op) in seen_ops:
                    raise AkIllegalArgumentException(
                        "the same operator instance appears twice in the "
                        "job; chains must not share operator state")
                seen_ops.add(id(op))
            if not sinks:
                raise AkIllegalArgumentException("each chain needs >= 1 sink")
            tsinks = [s if isinstance(s, TransactionalSink)
                      else TransactionalSink(s, scope=self.checkpoint_dir)
                      for s in sinks]
            for s in tsinks:
                if not s.scope:
                    s.scope = self.checkpoint_dir
                if s.sink_id in seen_sinks:
                    raise AkIllegalArgumentException(
                        f"duplicate sink {s.sink_id!r}; every sink needs a "
                        "distinct target (its committed-epoch marker is "
                        "keyed by it)")
                seen_sinks.add(s.sink_id)
            self.chains.append((ops, tsinks))

    def iter_ops(self) -> Iterator[Tuple[str, Any]]:
        """(stable state key, op) for every chain operator."""
        for ci, (ops, _) in enumerate(self.chains):
            for oi, op in enumerate(ops):
                yield f"chain{ci}.op{oi}.{type(op).__name__}", op

    def all_sinks(self) -> List[TransactionalSink]:
        return [s for _, sinks in self.chains for s in sinks]


# ---------------------------------------------------------------------------
# Shared budget-gated source reader (the epoch barrier)
# ---------------------------------------------------------------------------


class _SharedSourceReader:
    """Fans ONE source iterator out to N chain consumers with an epoch
    budget gate. A consumer asking for a chunk beyond the budget parks on
    the condition; when every consumer is parked (or finished) the stream
    is quiescent — no in-flight data exists anywhere in the synchronous
    generator chains — and the coordinator may snapshot. Chunks below
    ``skip_before`` (already covered by the restored snapshot) are pulled
    from the replaying source but never delivered."""

    def __init__(self, inner: Iterator, n_consumers: int, skip_before: int):
        self._inner = inner
        self._cv = threading.Condition()
        self._buf: Dict[int, Any] = {}
        self._next_abs = 0
        self._budget = 0
        self._end: Optional[int] = None  # abs source length once exhausted
        self._skip = int(skip_before)
        self._pos = [int(skip_before)] * n_consumers
        self._done = [False] * n_consumers
        self._waiting: List[Optional[int]] = [None] * n_consumers
        self._error: Optional[BaseException] = None
        self._interrupted = False
        self.replayed = 0

    @property
    def end(self) -> Optional[int]:
        with self._cv:
            return self._end

    def set_budget(self, budget: int) -> None:
        with self._cv:
            self._budget = max(self._budget, int(budget))
            self._cv.notify_all()

    def fail(self, exc: BaseException) -> None:
        with self._cv:
            if self._error is None:
                self._error = exc
            self._cv.notify_all()

    def mark_done(self, cid: int) -> None:
        with self._cv:
            if cid < len(self._done):
                self._done[cid] = True
                self._waiting[cid] = None
            self._cv.notify_all()

    # -- elastic generation teardown/rebuild (rescale at a barrier) --------
    def interrupt(self) -> None:
        """Unwind every parked consumer with :class:`_RescaleInterrupt`.
        Only called while all consumers are quiescent at an epoch barrier;
        the workers exit without running their chains' end-of-stream
        flush, and :meth:`resize` re-arms the reader for the new set."""
        with self._cv:
            self._interrupted = True
            self._cv.notify_all()

    def resize(self, n_consumers: int, pos: int) -> None:
        """Re-arm for a new consumer generation, every consumer starting
        at absolute chunk ``pos`` (the committed epoch boundary). The
        source iterator, delivered-chunk accounting, and budget carry
        over untouched."""
        with self._cv:
            self._interrupted = False
            self._pos = [int(pos)] * n_consumers
            self._done = [False] * n_consumers
            self._waiting: List[Optional[int]] = [None] * n_consumers
            for k in [k for k in self._buf if k < pos]:
                del self._buf[k]

    def _pull_to(self, idx: int) -> None:  # lock held
        while self._end is None and self._next_abs <= idx:
            try:
                chunk = next(self._inner)
            except StopIteration:
                self._end = self._next_abs
                self._cv.notify_all()
                return
            i = self._next_abs
            self._next_abs += 1
            if i < self._skip:
                # replayed-and-skipped: covered by the restored snapshot
                self.replayed += 1
                metrics.incr("checkpoint.replayed_chunks")
                continue
            self._buf[i] = chunk

    def get(self, cid: int, idx: int):
        with self._cv:
            while True:
                if self._interrupted:
                    raise _RescaleInterrupt()
                if self._error is not None:
                    raise self._error
                if self._end is not None and idx >= self._end:
                    return _END
                if idx < self._budget:
                    self._pull_to(idx)
                    if self._error is not None:
                        raise self._error
                    if self._end is not None and idx >= self._end:
                        return _END
                    chunk = self._buf[idx]
                    self._waiting[cid] = None
                    self._pos[cid] = idx + 1
                    active = [p for p, d in zip(self._pos, self._done)
                              if not d]
                    low = min(active) if active else self._next_abs
                    for k in [k for k in self._buf if k < low]:
                        del self._buf[k]
                    return chunk
                self._waiting[cid] = idx
                self._cv.notify_all()
                self._cv.wait()

    def wait_barrier(self, budget: int) -> None:
        """Block until every consumer is finished or parked wanting a chunk
        at/after ``budget`` (re-raising the first chain error)."""
        with self._cv:
            while True:
                if self._error is not None:
                    raise self._error
                if all(d or (w is not None and w >= budget)
                       for d, w in zip(self._done, self._waiting)):
                    return
                self._cv.wait()

    def all_done(self) -> bool:
        with self._cv:
            return all(self._done)


# ---------------------------------------------------------------------------
# Coordinator
# ---------------------------------------------------------------------------


class CheckpointCoordinator:
    """Drives a :class:`RecoverableStreamJob` under epoch snapshotting.

    Per epoch: release ``epoch_chunks`` source chunks → wait for the
    barrier (all chains quiescent) → ``maybe_fail('recovery', ...)`` crash
    tap → snapshot operator state + staged sink payloads → manifest
    (atomic commit point) → crash tap → publish every sink → prune
    snapshots past the minimum committed epoch."""

    def __init__(self, job: RecoverableStreamJob,
                 store: Optional[SnapshotStore] = None):
        self.job = job
        self.store = store or SnapshotStore(job.checkpoint_dir,
                                            keep=job.keep_snapshots)

    # -- restore -------------------------------------------------------------
    def _fence_manifest(self, manifest: Dict[str, Any]) -> None:
        """Refuse a snapshot cut under a different job configuration
        (overridable: the elastic coordinator adds key-space fences and
        reads the manifest's parallelism here)."""
        if manifest.get("epoch_chunks") != self.job.epoch_chunks:
            # epoch numbering and budgets assume one uniform epoch size for
            # the job's whole life; resuming with a different size would
            # re-deliver (or skip) chunks the restored state already covers
            raise AkIllegalStateException(
                f"snapshot was cut with epoch_chunks="
                f"{manifest.get('epoch_chunks')} but the job was rebuilt "
                f"with epoch_chunks={self.job.epoch_chunks}; restart with "
                "the original value")

    def _apply_operator_states(self, blob: Dict[str, Any]) -> None:
        """Re-seed fresh operator instances from the snapshot blob
        (overridable: the elastic coordinator defers this to its
        generation build, where instances exist per partition)."""
        op_states = blob.get("operators", {})
        ops = dict(self.job.iter_ops())
        for key, state in op_states.items():
            if key not in ops:
                raise AkIllegalStateException(
                    f"snapshot state for {key!r} has no matching operator; "
                    "restart needs the same job topology")
            ops[key].state_restore(state)

    def _restore(self, summary: Dict[str, Any]) -> Tuple[int, int]:
        """Apply the latest snapshot; returns (first epoch to run, source
        chunk offset to resume from — the manifest's persisted offset, the
        one source of truth for what the restored state already covers)."""
        loaded = self.store.load_latest()
        if loaded is None:
            return 0, 0
        t0 = time.perf_counter()
        epoch, manifest, blob = loaded
        self._fence_manifest(manifest)
        metrics.incr("checkpoint.restores")
        summary["restored"] = True
        summary["restored_epoch"] = epoch
        # idempotent replay of uncommitted sink epochs: the manifest is the
        # commit point, so a sink whose own committed epoch lags it missed
        # its publish — re-offer the staged payload (atomic targets dedupe
        # by epoch; KV puts are idempotent; marker-file targets re-publish)
        staged_by_sink = blob.get("sinks", {})
        for sink in self.job.all_sinks():
            if sink.committed_epoch(self.store) < epoch:
                sink.commit(epoch, staged_by_sink.get(sink.sink_id, []),
                            self.store)
                metrics.incr("recovery.sink_replays")
                summary["sink_replays"] += 1
        next_offset = int(manifest["source_offset"])
        if manifest.get("complete"):
            summary["complete"] = True
            return epoch + 1, next_offset
        self._apply_operator_states(blob)
        metrics.add_time("recovery.restore_s", time.perf_counter() - t0)
        return epoch + 1, next_offset

    # -- modelstream publishers ----------------------------------------------
    def _live_op(self, chain: int, op_index: int):
        """Resolve the live operator instance a publisher is bound to
        (overridable: the elastic coordinator resolves through its current
        generation's runners)."""
        return self.job.chains[chain][0][op_index]

    def _publish_epoch(self, epoch: int, final: bool) -> None:
        """Store-side model publish for every bound publisher. Runs at the
        barrier BEFORE the epoch snapshot commits: a crash anywhere inside
        rewinds training to the previous snapshot, and the deterministic
        retrain republishes this epoch bit-identically over any debris."""
        for pub in getattr(self.job, "publishers", ()):
            pub.publish_epoch(self._live_op(pub.chain, pub.op_index),
                              epoch, final=final)

    def _swap_published(self, epoch: int, epoch_t0: float) -> None:
        """Serve-side hot-swap AFTER the epoch snapshot committed — the
        server only ever loads versions that are durable on both sides."""
        for pub in getattr(self.job, "publishers", ()):
            pub.swap_epoch(epoch, epoch_t0)

    def _resume_publishers(self) -> None:
        """Post-restore healing: a crash between a version's manifest
        commit and its hot-swap (the ``pre_swap`` window, including on the
        final epoch's complete-path) leaves the store ahead of the server
        — swap the newest committed version back in."""
        for pub in getattr(self.job, "publishers", ()):
            pub.resume()

    # -- epoch cut -----------------------------------------------------------
    def _gather_op_states(self) -> Dict[str, Any]:
        """Per-logical-op snapshot payloads for the epoch blob
        (overridable: the elastic coordinator stores key-range-partitioned
        parts instead of one blob per op)."""
        op_states: Dict[str, Any] = {}
        for key, op in self.job.iter_ops():
            snap = op.state_snapshot()
            if snap is not None:
                op_states[key] = snap
        return op_states

    def _manifest_extra(self) -> Dict[str, Any]:
        """Extra manifest fields (overridable: the elastic coordinator
        records parallelism / key-space config here)."""
        return {}

    def _cut_epoch(self, epoch: int, next_offset: int, final: bool,
                   op_states: Optional[Dict[str, Any]] = None) -> None:
        with trace_span("recovery.epoch", epoch=epoch) as sp:
            t0 = time.perf_counter()
            maybe_fail("recovery", label=f"epoch{epoch}.pre_snapshot")
            if op_states is None:
                op_states = self._gather_op_states()
            sinks = self.job.all_sinks()
            staged = {s.sink_id: s.staged() for s in sinks}
            manifest = {
                "source_offset": int(next_offset),
                "epoch_chunks": self.job.epoch_chunks,
                "complete": bool(final),
                "sinks": {s.sink_id:
                          {"committed": s.committed_epoch(self.store)}
                          for s in sinks},
            }
            manifest.update(self._manifest_extra())
            self.store.write_snapshot(
                epoch, manifest, {"operators": op_states, "sinks": staged})
            dt_snap = time.perf_counter() - t0
            metrics.add_time("recovery.snapshot_s", dt_snap)
            metrics.observe("recovery.snapshot_epoch_s", dt_snap)
            maybe_fail("recovery", label=f"epoch{epoch}.pre_commit")
            t1 = time.perf_counter()
            for s in sinks:
                s.commit(epoch, s.staged(), self.store)
                s.clear_staged()
            dt_commit = time.perf_counter() - t1
            metrics.add_time("recovery.commit_s", dt_commit)
            metrics.observe("recovery.commit_epoch_s", dt_commit)
            if sp is not None:
                sp.phases["snapshot_s"] = dt_snap
                sp.phases["commit_s"] = dt_commit
        # every sink just committed `epoch`, so the min committed epoch —
        # the coordinator's ack floor — IS `epoch`; re-probing each sink's
        # marker here would be a redundant durable-store round per epoch
        self.store.retain(epoch)
        metrics.incr("recovery.epochs")

    # -- run -----------------------------------------------------------------
    def run(self) -> Dict[str, Any]:
        # the restore path already opens sink handles (replay + committed-
        # epoch probes), so handle cleanup must cover it too — a failed
        # restore attempt under the supervisor must not leak wire producers
        try:
            with trace_span("recovery.run",
                            checkpoint_dir=self.job.checkpoint_dir) as sp:
                out = self._run_inner()
                if sp is not None:
                    sp.attrs["epochs"] = out.get("epochs")
                    sp.attrs["restored"] = out.get("restored")
                return out
        finally:
            for s in self.job.all_sinks():
                s.close()

    def _run_inner(self) -> Dict[str, Any]:
        job = self.job
        summary: Dict[str, Any] = {
            "complete": False, "restored": False, "epochs": 0,
            "sink_replays": 0, "replayed_chunks": 0,
        }
        start_epoch, start_offset = self._restore(summary)
        self._resume_publishers()
        if summary["complete"]:
            return summary  # finished in a previous attempt; sinks healed
        k = job.epoch_chunks
        # raw _stream_impl(), NOT _stream(): the tee sibling _stream() keeps
        # for later consumers would retain every chunk for the whole run —
        # the reader is the single consumer and prunes to one epoch
        reader = _SharedSourceReader(job.source._stream_impl(),
                                     n_consumers=len(job.chains),
                                     skip_before=start_offset)
        threads: List[threading.Thread] = []
        ctx = capture_context()  # chain spans parent to recovery.run even
        for ci, (ops, sinks) in enumerate(job.chains):  # on their threads
            it: Iterator = self._consume(reader, ci, start_offset)
            for op in ops:
                it = op._stream_impl(it)
            t = threading.Thread(
                target=self._run_chain, args=(reader, ci, it, sinks, ctx),
                name=f"alink-recovery-chain{ci}", daemon=True)
            threads.append(t)
        for t in threads:
            t.start()
        epoch = start_epoch
        try:
            while True:
                t_ep = time.perf_counter()
                budget = (epoch + 1) * k
                reader.set_budget(budget)
                reader.wait_barrier(budget)
                final = reader.end is not None and reader.all_done()
                next_offset = budget if reader.end is None \
                    else min(budget, reader.end)
                self._publish_epoch(epoch, final)
                self._cut_epoch(epoch, next_offset, final)
                self._swap_published(epoch, t_ep)
                summary["epochs"] += 1
                epoch += 1
                if final:
                    break
        except BaseException as exc:
            reader.fail(exc)  # unblock parked chains so threads exit
            raise
        finally:
            for t in threads:
                t.join(timeout=60)
            summary["replayed_chunks"] = reader.replayed
        summary["complete"] = True
        summary["source_chunks"] = reader.end
        summary["final_epoch"] = epoch - 1
        return summary

    @staticmethod
    def _consume(reader: _SharedSourceReader, cid: int,
                 start: int) -> Iterator:
        idx = start
        while True:
            chunk = reader.get(cid, idx)
            if chunk is _END:
                return
            maybe_fail("recovery", label=f"chunk{idx}")
            yield chunk
            idx += 1

    @staticmethod
    def _run_chain(reader: _SharedSourceReader, cid: int, it: Iterator,
                   sinks: Sequence[TransactionalSink], ctx=None) -> None:
        try:
            with attach_context(ctx):
                with trace_span(f"recovery.chain{cid}") as sp:
                    n = 0
                    for out in it:
                        n += 1
                        for s in sinks:
                            s.stage(out)
                    if sp is not None:
                        sp.attrs["chunks_out"] = n
        except BaseException as exc:
            reader.fail(exc)
        finally:
            reader.mark_done(cid)


# ---------------------------------------------------------------------------
# Supervised restart driver
# ---------------------------------------------------------------------------


def is_restartable(exc: BaseException) -> bool:
    """The supervisor's classification: everything the retry taxonomy deems
    transient, plus injected crashes (a stand-in for the process dying —
    fatal in-process, restartable under supervision)."""
    return is_retryable(exc) or isinstance(exc, InjectedCrashError)


def run_with_recovery(
    job_factory: Callable[[], RecoverableStreamJob],
    restart_policy: Optional[RetryPolicy] = None,
    *,
    classify: Callable[[BaseException], bool] = is_restartable,
    sleep: Callable[[float], None] = time.sleep,
) -> Dict[str, Any]:
    """Run a recoverable job under supervision: on a restartable failure,
    build a FRESH job from ``job_factory`` (generators are one-shot) and
    resume it from the latest epoch snapshot, under ``restart_policy``'s
    attempt/backoff budget (default: :meth:`RetryPolicy.default`).
    Non-restartable errors propagate unchanged from the failing attempt.
    ``ALINK_RETRIES=off`` (the framework-wide fail-fast switch) disables
    restarts here too, and the policy's ``deadline`` bounds the whole
    supervised run's wall clock — no restart starts past it."""
    if not callable(job_factory):
        raise AkIllegalArgumentException(
            "run_with_recovery needs a job FACTORY (fresh operator "
            "instances per attempt), not a job instance")
    policy = restart_policy or RetryPolicy.default()
    start = time.monotonic()
    attempt = 0
    while True:
        try:
            job = job_factory()
            # jobs pick their coordinator: ElasticStreamJob routes to the
            # rescale-capable ElasticCoordinator (common/elastic.py)
            coord_cls = getattr(job, "_coordinator_cls",
                                None) or CheckpointCoordinator
            return coord_cls(job).run()
        except BaseException as exc:
            attempt += 1
            if not retries_enabled() or attempt >= policy.max_attempts \
                    or not classify(exc):
                raise
            d = policy.delay(attempt - 1)
            if (policy.deadline is not None
                    and time.monotonic() - start + d > policy.deadline):
                metrics.incr("resilience.deadline_exceeded")
                raise
            metrics.incr("recovery.restarts")
            logger.warning(
                "stream job died (%s: %s); restarting from the last epoch "
                "snapshot in %.3fs (attempt %d/%d)", type(exc).__name__,
                exc, d, attempt + 1, policy.max_attempts)
            sleep(d)


def recovery_summary() -> Dict[str, Any]:
    """One-call readout of the recovery counters (the BENCH ``recovery``
    extra): epochs committed, restarts absorbed, sink commits/replays,
    chunks replayed-and-skipped, snapshot/commit time."""
    out: Dict[str, Any] = dict(metrics.counters("recovery."))
    out.update(metrics.counters("checkpoint."))
    for timer in ("recovery.snapshot_s", "recovery.commit_s",
                  "recovery.restore_s"):
        stats = metrics.timer_stats(timer)
        if stats:
            out[timer] = stats
    return out
