"""Stream operator runtime — micro-batch streaming (port of the core of
``alink_tpu.operator.stream.base``).

Capability parity with the reference's stream layer (reference:
core/src/main/java/com/alibaba/alink/operator/stream/StreamOperator.java:39 —
link/linkFrom DAG + deferred StreamExecutionEnvironment.execute).

The reference's per-record Flink streams become BOUNDED MICRO-BATCH streams:
a stream is an iterator of MTable chunks; operators transform chunk
iterators; ``collect()`` drives the sink to exhaustion. Each micro-batch is
one batched device call instead of a per-row loop.

Ported: ``StreamOperator`` (link, link_from, collect with its pre-flight,
``_stream_impl``), the checkpoint hooks (``state_snapshot``/``state_restore``,
``_stateful_unhooked``) that the epoch recovery runtime
(``common/recovery.py``) drives, the keyed-state hooks (``set_key_context``,
``elastic_keyed``, ``state_partition``/``state_merge``) with
``GlobalElasticStateMixin`` and ``CumulativeEvalStateMixin``,
``TableSourceStreamOp``, ``_FuncStreamOp``, ``MapStreamOp`` (depth-3
dispatch/finalize overlap across chunks), ``ModelMapStreamOp``, ``_drain``,
``CsvSourceStreamOp`` and ``make_per_chunk_twin``. ``collect`` keeps the
reference's ``stream.collect`` span and ``stream.chunk_s`` histogram. The
elastic job that calls the keyed-state hooks is ROADMAP A7's next part.
"""

from __future__ import annotations

import itertools
import time
from typing import Callable, Iterator, List, Optional

import numpy as np

from ...common.exceptions import (
    AkIllegalOperationException,
    AkIllegalStateException,
)
from ...common.metrics import metrics
from ...common.mtable import MTable
from ...common.params import ParamInfo, WithParams
from ...common.tracing import trace_span


class StreamOperator(WithParams):
    """A node in a micro-batch stream DAG."""

    def __init__(self, params=None, **kwargs):
        super().__init__(params, **kwargs)
        self._inputs: List[StreamOperator] = []
        self._iter: Optional[Iterator[MTable]] = None

    _min_inputs: Optional[int] = None
    _max_inputs: Optional[int] = None

    # -- DAG ---------------------------------------------------------------
    def link_from(self, *inputs: "StreamOperator") -> "StreamOperator":
        lo, hi = self._min_inputs, self._max_inputs
        if lo is not None and len(inputs) < lo:
            raise AkIllegalOperationException(
                f"{type(self).__name__} expects >= {lo} inputs"
            )
        if hi is not None and len(inputs) > hi:
            raise AkIllegalOperationException(
                f"{type(self).__name__} expects <= {hi} inputs"
            )
        self._inputs = list(inputs)
        return self

    linkFrom = link_from

    def link(self, next_op: "StreamOperator") -> "StreamOperator":
        return next_op.link_from(self)

    # -- to implement ------------------------------------------------------
    def _stream_impl(self, *inputs: Iterator[MTable]) -> Iterator[MTable]:
        raise NotImplementedError(type(self).__name__)

    # -- operator-state checkpointing (epoch recovery runtime) -------------
    # Stateful stream ops keep their cross-chunk state on the instance (not
    # in generator locals) and override these two hooks so the
    # CheckpointCoordinator (common/recovery.py) can cut a consistent
    # snapshot at epoch barriers and re-seed a FRESH instance mid-stream on
    # restart. Contract: state_snapshot() is only called while the
    # operator's generator is suspended between chunks (the coordinator
    # quiesces every chain first), and must return a picklable object whose
    # restore makes the resumed stream byte-identical to an uninterrupted
    # run; device arrays are materialized to host numpy. state_restore()
    # is called on a fresh instance BEFORE its generator first runs.

    # Ops that keep cross-chunk state in generator locals WITHOUT the
    # snapshot hooks set this True: the recovery runtime refuses them at
    # job-build time (restoring them as stateless would silently break the
    # exactly-once invariant mid-stream — an error is the honest answer).
    _stateful_unhooked = False

    def state_snapshot(self) -> Optional[dict]:
        """Picklable cross-chunk state, or None for stateless ops."""
        return None

    def state_restore(self, state: dict) -> None:
        raise AkIllegalOperationException(
            f"{type(self).__name__} does not support operator-state "
            "restore (no state_snapshot/state_restore override)")

    # -- keyed-state partitioning (elastic rescaling, common/elastic.py) ----
    # The elastic runtime shards the key space [0, num_key_groups) into
    # contiguous hash ranges, one per parallel partition (Flink's key-group
    # design: the key group is the atom of state redistribution, so results
    # are invariant to the parallelism that happens to host it). Stateful
    # ops opt in by setting ``_elastic_hooks = True`` and implementing
    # state_partition/state_merge; ops whose state is keyed by the job's
    # key column additionally report True from ``_elastic_keyed_impl`` so
    # the runtime routes rows by hash instead of pinning the whole chain.

    # True on ops implementing the partition/merge hooks below (directly or
    # via GlobalElasticStateMixin); the elastic job refuses stateful ops
    # without them (plan-time analog: rule ALK107).
    _elastic_hooks = False

    # (key_col, num_key_groups) installed by the elastic runtime before any
    # data flows; None under the plain/recovery runtimes (single key group).
    _key_ctx = None
    _elastic_pin = 0

    def set_key_context(self, key_col: Optional[str], num_key_groups: int,
                        pin_group: int = 0) -> None:
        """Called by the elastic runtime on fresh instances: ``key_col`` is
        the routing column for keyed chains (None for pinned/global
        chains), ``pin_group`` the key group a global op's whole state
        rides with."""
        self._key_ctx = (key_col, int(num_key_groups)) if key_col else None
        self._elastic_pin = int(pin_group)

    def elastic_keyed(self, key_col: str) -> bool:
        """Can this op's rows be routed by hash(``key_col``) with per-key
        semantics preserved? Stateless ops trivially can; stateful ops
        answer via ``_elastic_keyed_impl`` (windows: yes iff the key
        column is one of their group columns; global accumulators: no)."""
        if type(self).state_snapshot is StreamOperator.state_snapshot:
            return True
        return bool(self._elastic_keyed_impl(key_col))

    def _elastic_keyed_impl(self, key_col: str) -> bool:
        return False

    def state_partition(self, key_ranges) -> List[Optional[dict]]:
        """Split the current state into one blob per ``[lo, hi)`` key-group
        range (None for ranges this op holds nothing in). Called only
        while the operator is quiescent at an epoch barrier. Invariant:
        ``state_merge(state_partition(ranges))`` on a fresh instance must
        reproduce the state bit-for-bit."""
        raise AkIllegalOperationException(
            f"{type(self).__name__} has no keyed-state hooks "
            "(state_partition/state_merge); it cannot run under elastic "
            "parallelism")

    def state_merge(self, blobs) -> None:
        """Adopt the union of ``blobs`` (disjoint key-range parts produced
        by state_partition, possibly from several old instances) as this
        fresh instance's state. An empty list is a no-op."""
        raise AkIllegalOperationException(
            f"{type(self).__name__} has no keyed-state hooks "
            "(state_partition/state_merge); it cannot run under elastic "
            "parallelism")

    # -- wiring ------------------------------------------------------------
    def _stream(self) -> Iterator[MTable]:
        """The operator's (shareable) output iterator; tee'd per consumer."""
        if self._iter is None:
            ins = [op._stream() for op in self._inputs]
            self._iter = self._stream_impl(*ins)
        self._iter, out = itertools.tee(self._iter)
        return out

    # -- results -----------------------------------------------------------
    def collect(self) -> MTable:
        """Run the stream to exhaustion and concatenate all micro-batches.

        Each chunk's end-to-end latency (source pull through this
        operator's transform) lands in the ``stream.chunk_s`` histogram;
        the whole drain is one ``stream.collect`` span."""
        from ...analysis import preflight

        preflight(self, where="stream.collect")
        chunks = []
        with trace_span("stream.collect", op=type(self).__name__) as sp:
            t_prev = time.perf_counter()
            for chunk in self._stream():
                now = time.perf_counter()
                metrics.observe("stream.chunk_s", now - t_prev)
                t_prev = now
                chunks.append(chunk)
            if sp is not None:
                sp.attrs["chunks"] = len(chunks)
            if not chunks:   # inside the span: a failed collect records so
                raise AkIllegalStateException("stream produced no data")
            return MTable.concat(chunks)

    def print(self, n: int = 20) -> "StreamOperator":
        t = self.collect()
        print(t.to_display_string(max_rows=n))
        return self


class GlobalElasticStateMixin:
    """Keyed-state hooks for ops whose cross-chunk state is GLOBAL — one
    accumulator over the whole stream (FTRL/OnlineFm device state,
    cumulative eval counters, the legacy single-session window). The state
    cannot be split by key hash, so the whole blob rides ONE key group
    (``_elastic_pin``, chosen per chain by the elastic job): at any
    parallelism exactly one partition owns that group, rows reach it in
    source order, and a rescale MOVES the state to the new owner instead
    of splitting it — the degenerate but exact case of hash-range
    redistribution (Flink's max-parallelism-1 operator analog)."""

    _elastic_hooks = True

    def _elastic_keyed_impl(self, key_col: str) -> bool:
        return False

    def state_partition(self, key_ranges) -> List[Optional[dict]]:
        pin = int(getattr(self, "_elastic_pin", 0) or 0)
        blobs: List[Optional[dict]] = [None] * len(key_ranges)
        for i, (lo, hi) in enumerate(key_ranges):
            if lo <= pin < hi:
                blobs[i] = self.state_snapshot()
        return blobs

    def state_merge(self, blobs) -> None:
        live = [b for b in blobs if b is not None]
        if not live:
            return
        if len(live) > 1:
            raise AkIllegalStateException(
                f"{type(self).__name__} holds global (unkeyed) state; a "
                f"merge of {len(live)} non-empty parts means two "
                "partitions owned it at once — the redistribution is "
                "corrupt")
        self.state_restore(live[0])


class CumulativeEvalStateMixin(GlobalElasticStateMixin):
    """Shared snapshot/restore hooks for cumulative eval streams: a window
    counter plus per-series row history (series names in ``_eval_series``).
    History compacts to one array per series at snapshot time — exact
    cumulative metrics (AUC, macro-F1, R²) need the full score history, no
    sketch preserves them bit-exactly, so the snapshot is inherently
    O(rows seen); bound the stream (or window the eval) if the checkpoint
    tax on a very long run matters more than exact cumulative metrics."""

    _eval_series: tuple = ()

    def _eval_state(self) -> dict:
        st = getattr(self, "_estate", None)
        if st is None:
            st = self._estate = {k: [] for k in self._eval_series}
            st["window"] = 0
        return st

    def state_snapshot(self) -> dict:
        st = self._eval_state()
        out = {"window": st["window"]}
        for k in self._eval_series:
            out[k] = [np.concatenate(st[k])] if st[k] else []
        return out

    def state_restore(self, state: dict) -> None:
        st = {"window": state["window"]}
        for k in self._eval_series:
            st[k] = list(state[k])
        self._estate = st


class TableSourceStreamOp(StreamOperator):
    """Emit an MTable as micro-batches (reference:
    operator/stream/source/TableSourceStreamOp + MemSourceStreamOp)."""

    _max_inputs = 0

    NUM_CHUNKS = ParamInfo("numChunks", int, default=10)
    CHUNK_SIZE = ParamInfo("chunkSize", int, default=0,
                           desc="rows per micro-batch; 0 = numChunks split")

    def __init__(self, table: MTable, params=None, **kwargs):
        super().__init__(params, **kwargs)
        self._table = table

    def _stream_impl(self) -> Iterator[MTable]:
        n = self._table.num_rows
        cs = self.get(self.CHUNK_SIZE)
        if cs <= 0:
            cs = max(1, n // max(1, self.get(self.NUM_CHUNKS)))
        for s in range(0, n, cs):
            yield self._table.slice(s, min(s + cs, n))


class _FuncStreamOp(StreamOperator):
    """Per-micro-batch function op."""

    _min_inputs = 1
    _max_inputs = 1

    def __init__(self, fn: Callable[[MTable], Optional[MTable]], params=None,
                 **kwargs):
        super().__init__(params, **kwargs)
        self._fn = fn

    def _stream_impl(self, it: Iterator[MTable]) -> Iterator[MTable]:
        for chunk in it:
            out = self._fn(chunk)
            if out is not None:
                yield out


class MapStreamOp(StreamOperator):
    """Wrap a stateless Mapper over every micro-batch (reference:
    operator/stream/utils mapper stream ops). The mapper runs on the port's
    default device (``common/env.resolve_device``)."""

    _min_inputs = 1
    _max_inputs = 1

    mapper_cls = None

    # the async-dispatch queue carries in-flight batches across chunk
    # boundaries; until it snapshots, recovery must refuse this op
    _stateful_unhooked = True

    # micro-batches kept in flight when the mapper supports async dispatch
    # (the card computes chunk i while chunk i+1's transfer is under way)
    _pipeline_depth = 3

    def _stream_impl(self, it: Iterator[MTable]) -> Iterator[MTable]:
        from collections import deque

        mapper = None
        q: deque = deque()
        for chunk in it:
            if mapper is None:
                mapper = self.mapper_cls(chunk.schema, self.get_params())
            if hasattr(mapper, "dispatch_table"):
                q.append(mapper.dispatch_table(chunk))
                if len(q) >= self._pipeline_depth:
                    yield mapper.finalize_table(q.popleft())
            else:
                yield mapper.map_table(chunk)
        while q:
            yield mapper.finalize_table(q.popleft())


class ModelMapStreamOp(StreamOperator):
    """Batch-trained model + data stream -> predictions, with model hot-swap
    when the first input is itself a stream of models (reference:
    operator/batch/utils/ModelMapStreamOp + ModelStreamModelMapperAdapter —
    common/mapper/ModelMapper.java:71-76 createNew hot swap)."""

    _min_inputs = 2
    _max_inputs = 2

    mapper_cls = None

    def __init__(self, model=None, params=None, **kwargs):
        super().__init__(params, **kwargs)
        self._model = model  # static MTable model (or None: first input is models)

    def _stream_impl(self, *ins: Iterator[MTable]) -> Iterator[MTable]:
        model_it, data_it = ins
        mapper = None
        if self._model is not None:
            mapper = self.mapper_cls(
                self._model.schema, None, self.get_params()
            ).load_model(self._model)
        pending_models = model_it
        for chunk in data_it:
            # hot-swap: drain any newly arrived model snapshots
            for model in _drain(pending_models):
                if mapper is None:
                    mapper = self.mapper_cls(
                        model.schema, chunk.schema, self.get_params()
                    ).load_model(model)
                else:
                    mapper = mapper.create_new(model)
            if mapper is None:
                continue  # no model yet — reference drops records too
            yield mapper.map_table(chunk)


def _drain(it: Iterator[MTable], limit: int = 1) -> List[MTable]:
    """Take up to `limit` ready items from a model stream (micro-batch streams
    are synchronous, so 'ready' = next item if any)."""
    out = []
    for _ in range(limit):
        try:
            out.append(next(it))
        except StopIteration:
            break
    return out


class CsvSourceStreamOp(StreamOperator):
    """CSV file as a micro-batch stream (reference:
    operator/stream/source/CsvSourceStreamOp.java)."""

    FILE_PATH = ParamInfo("filePath", str, optional=False)
    SCHEMA_STR = ParamInfo("schemaStr", str, optional=False,
                           aliases=("schema",))
    FIELD_DELIMITER = ParamInfo("fieldDelimiter", str, default=",")
    IGNORE_FIRST_LINE = ParamInfo("ignoreFirstLine", bool, default=False)
    QUOTE_CHAR = ParamInfo("quoteChar", str, default='"')
    CHUNK_SIZE = ParamInfo("chunkSize", int, default=1024)

    _max_inputs = 0

    def _stream_impl(self) -> Iterator[MTable]:
        from ..batch.base import CsvSourceBatchOp

        # forward ALL params so batch-reader options are never dropped
        table = CsvSourceBatchOp(self.get_params().clone())._execute_impl()
        cs = max(1, self.get(self.CHUNK_SIZE))
        for s in range(0, table.num_rows, cs):
            yield table.slice(s, min(s + cs, table.num_rows))


def make_per_chunk_twin(batch_cls, name: str, doc: str) -> type:
    """Factory for stream twins that re-run a batch op per micro-batch
    (shared by the outlier and timeseries twin registries so the
    param-copy / execution semantics cannot drift)."""
    from ...common.params import copy_param_infos

    def _stream_impl(self, it: Iterator[MTable]) -> Iterator[MTable]:
        for chunk in it:
            op = batch_cls(self.get_params().clone())
            yield op._execute_impl(chunk)

    cls = type(name, (StreamOperator,), {
        "_min_inputs": 1,
        "_max_inputs": 1,
        "_stream_impl": _stream_impl,
        "__doc__": doc,
        "__module__": batch_cls.__module__,
    })
    copy_param_infos(batch_cls, cls)
    return cls
