"""Stream operator runtime — micro-batch streaming (port of the core of
``alink_tpu.operator.stream.base``).

Capability parity with the reference's stream layer (reference:
core/src/main/java/com/alibaba/alink/operator/stream/StreamOperator.java:39 —
link/linkFrom DAG + deferred StreamExecutionEnvironment.execute).

The reference's per-record Flink streams become BOUNDED MICRO-BATCH streams:
a stream is an iterator of MTable chunks; operators transform chunk
iterators; ``collect()`` drives the sink to exhaustion. Each micro-batch is
one batched device call instead of a per-row loop.

Ported: ``StreamOperator`` (link, link_from, collect, ``_stream_impl``),
``TableSourceStreamOp``, ``_FuncStreamOp``, ``MapStreamOp`` (depth-3
dispatch/finalize overlap across chunks), ``ModelMapStreamOp``, ``_drain``
and ``CsvSourceStreamOp``. Not yet (ROADMAP A7): the checkpoint hooks
(``state_snapshot``/``state_restore``), the elastic keyed-state hooks and
``GlobalElasticStateMixin``/``CumulativeEvalStateMixin``,
``make_per_chunk_twin``, and ``collect``'s pre-flight (A10). ``collect``
keeps the reference's ``stream.collect`` span and ``stream.chunk_s``
histogram.
"""

from __future__ import annotations

import itertools
import time
from typing import Callable, Iterator, List, Optional

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
