"""Stream relational/control ops + in-memory and generated stream sources
(port of ``alink_tpu.operator.stream.relational``).

Capability parity (reference: operator/stream/sql/SelectStreamOp.java,
FilterStreamOp.java, WhereStreamOp.java, AsStreamOp.java,
UnionAllStreamOp.java; dataproc/SampleStreamOp.java,
StratifiedSampleStreamOp.java, RebalanceStreamOp.java, SplitStreamOp.java,
AppendIdStreamOp.java, SpeedControlStreamOp.java; utils/PrintStreamOp.java;
source/MemSourceStreamOp.java, NumSeqSourceStreamOp.java,
RandomTableSourceStreamOp.java, RandomVectorSourceStreamOp.java).

Each op transforms the micro-batch iterator; per-chunk relational work
reuses the SAME AlgoOperator implementations the batch twins run, so
semantics cannot drift between the two layers.
"""

from __future__ import annotations

import itertools
import time
from typing import Iterator, List, Optional

import numpy as np

from ...common.exceptions import AkIllegalArgumentException
from ...common.mtable import AlinkTypes, MTable, TableSchema
from ...common.params import MinValidator, ParamInfo, RangeValidator
from .base import StreamOperator, TableSourceStreamOp


class _PerChunkSqlStreamOp(StreamOperator):
    """Apply a sql.AlgoOperator to every micro-batch."""

    _min_inputs = 1
    _max_inputs = 1

    def __init__(self, clause: str = None, params=None, **kw):
        if clause is not None:
            kw.setdefault("clause", clause)
        super().__init__(params, **kw)

    CLAUSE = ParamInfo("clause", str, optional=False,
                       aliases=("fields", "predicate"))

    def _make_inner(self):
        raise NotImplementedError

    def _stream_impl(self, it: Iterator[MTable]) -> Iterator[MTable]:
        inner = self._make_inner()
        for chunk in it:
            out = inner._execute_impl(chunk)
            if out.num_rows:
                yield out


class SelectStreamOp(_PerChunkSqlStreamOp):
    """(reference: operator/stream/sql/SelectStreamOp.java)"""

    def _make_inner(self):
        from ..sql import SelectOp

        return SelectOp(self.get(self.CLAUSE))


class FilterStreamOp(_PerChunkSqlStreamOp):
    """(reference: operator/stream/sql/FilterStreamOp.java)"""

    def _make_inner(self):
        from ..sql import FilterOp

        return FilterOp(self.get(self.CLAUSE))


class WhereStreamOp(FilterStreamOp):
    """(reference: operator/stream/sql/WhereStreamOp.java)"""


class AsStreamOp(_PerChunkSqlStreamOp):
    """Rename all columns positionally (reference:
    operator/stream/sql/AsStreamOp.java)."""

    def _stream_impl(self, it: Iterator[MTable]) -> Iterator[MTable]:
        names = [c.strip() for c in self.get(self.CLAUSE).split(",")
                 if c.strip()]
        for chunk in it:
            if len(names) != len(chunk.names):
                raise AkIllegalArgumentException(
                    f"AS clause has {len(names)} names for "
                    f"{len(chunk.names)} cols")
            yield chunk.rename(dict(zip(chunk.names, names)))


class UnionAllStreamOp(StreamOperator):
    """Interleave several streams round-robin (reference:
    operator/stream/sql/UnionAllStreamOp.java)."""

    _min_inputs = 1

    def _stream_impl(self, *ins: Iterator[MTable]) -> Iterator[MTable]:
        actives = list(ins)
        while actives:
            nxt = []
            for it in actives:
                try:
                    yield next(it)
                    nxt.append(it)
                except StopIteration:
                    pass
            actives = nxt


class SampleStreamOp(StreamOperator):
    """Bernoulli sample per micro-batch (reference:
    operator/stream/dataproc/SampleStreamOp.java)."""

    # the Bernoulli RNG stream is cross-chunk state; restarting it at the
    # seed mid-stream would sample different rows, so the recovery
    # runtime refuses it until the RNG state snapshots
    _stateful_unhooked = True

    RATIO = ParamInfo("ratio", float, optional=False,
                      validator=RangeValidator(0.0, 1.0))
    SEED = ParamInfo("randomSeed", int, default=0, aliases=("seed",))

    _min_inputs = 1
    _max_inputs = 1

    def _stream_impl(self, it: Iterator[MTable]) -> Iterator[MTable]:
        rng = np.random.default_rng(self.get(self.SEED))
        ratio = self.get(self.RATIO)
        for chunk in it:
            mask = rng.random(chunk.num_rows) < ratio
            out = chunk.filter_mask(mask)
            if out.num_rows:
                yield out


class StratifiedSampleStreamOp(StreamOperator):
    """Per-stratum Bernoulli sampling per micro-batch (reference:
    operator/stream/dataproc/StratifiedSampleStreamOp.java)."""

    STRATA_COL = ParamInfo("strataCol", str, optional=False)
    STRATA_RATIO = ParamInfo("strataRatio", float, default=-1.0)
    STRATA_RATIOS = ParamInfo("strataRatios", str, default=None,
                              desc="'v1:0.1,v2:0.5'")
    SEED = ParamInfo("randomSeed", int, default=0, aliases=("seed",))

    _min_inputs = 1
    _max_inputs = 1

    def _stream_impl(self, it: Iterator[MTable]) -> Iterator[MTable]:
        rng = np.random.default_rng(self.get(self.SEED))
        ratios = {}
        if self.get(self.STRATA_RATIOS):
            for part in self.get(self.STRATA_RATIOS).split(","):
                k, v = part.split(":")
                ratios[k.strip()] = float(v)
        default = float(self.get(self.STRATA_RATIO))
        scol = self.get(self.STRATA_COL)
        for chunk in it:
            col = np.asarray(chunk.col(scol), object).astype(str)
            r = np.asarray([ratios.get(v, default) for v in col])
            if (r < 0).any():
                bad = sorted(set(col[np.asarray(r) < 0]))
                raise AkIllegalArgumentException(
                    f"no ratio declared for strata {bad}")
            out = chunk.filter_mask(rng.random(chunk.num_rows) < r)
            if out.num_rows:
                yield out


class SplitStreamOp(StreamOperator):
    """Random split per chunk; main output = fraction (reference:
    operator/stream/dataproc/SplitStreamOp.java). The complement is
    available via :meth:`complement` as a second stream."""

    FRACTION = ParamInfo("fraction", float, optional=False,
                         validator=RangeValidator(0.0, 1.0))
    SEED = ParamInfo("randomSeed", int, default=0, aliases=("seed",))

    _min_inputs = 1
    _max_inputs = 1

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self._rest: List[MTable] = []
        self._keep_rest = False  # only buffer when complement() is consumed

    def _stream_impl(self, it: Iterator[MTable]) -> Iterator[MTable]:
        rng = np.random.default_rng(self.get(self.SEED))
        frac = self.get(self.FRACTION)
        self._rest.clear()
        for chunk in it:
            mask = rng.random(chunk.num_rows) < frac
            if self._keep_rest:
                self._rest.append(chunk.filter_mask(~mask))
            out = chunk.filter_mask(mask)
            if out.num_rows:
                yield out

    def complement(self) -> "StreamOperator":
        """Side-output stream of the held-out rows (drains after the main).
        Must be requested BEFORE the main stream runs — the held-out chunks
        are only buffered once a complement consumer exists (unbounded
        streams would otherwise leak memory)."""
        parent = self
        parent._keep_rest = True

        class _Complement(StreamOperator):
            _max_inputs = 0

            def _stream_impl(self) -> Iterator[MTable]:
                for t in parent._rest:
                    if t.num_rows:
                        yield t

        return _Complement()


class RebalanceStreamOp(StreamOperator):
    """Re-chunk the stream into even micro-batches (reference:
    operator/stream/dataproc/RebalanceStreamOp.java — round-robin
    repartitioning)."""

    CHUNK_SIZE = ParamInfo("chunkSize", int, default=256,
                           validator=MinValidator(1))

    _min_inputs = 1
    _max_inputs = 1

    def _stream_impl(self, it: Iterator[MTable]) -> Iterator[MTable]:
        size = self.get(self.CHUNK_SIZE)
        buf: List[MTable] = []
        have = 0
        for chunk in it:
            buf.append(chunk)
            have += chunk.num_rows
            while have >= size:
                t = MTable.concat(buf)
                yield t.slice(0, size)
                rest = t.slice(size, t.num_rows)
                buf = [rest] if rest.num_rows else []
                have = rest.num_rows
        if have:
            yield MTable.concat(buf)


class SpeedControlStreamOp(StreamOperator):
    """Throttle the stream: sleep ``timeInterval`` seconds between chunks
    (reference: operator/stream/dataproc/SpeedControlStreamOp.java)."""

    TIME_INTERVAL = ParamInfo("timeInterval", float, default=0.0,
                              aliases=("interval",))

    _min_inputs = 1
    _max_inputs = 1

    def _stream_impl(self, it: Iterator[MTable]) -> Iterator[MTable]:
        dt = float(self.get(self.TIME_INTERVAL))
        first = True
        for chunk in it:
            if not first and dt > 0:
                time.sleep(dt)
            first = False
            yield chunk


class AppendIdStreamOp(StreamOperator):
    """Monotonic id across the whole stream (reference:
    operator/stream/dataproc/AppendIdStreamOp.java)."""

    ID_COL = ParamInfo("idCol", str, default="append_id")

    _min_inputs = 1
    _max_inputs = 1

    def _stream_impl(self, it: Iterator[MTable]) -> Iterator[MTable]:
        start = 0
        name = self.get(self.ID_COL)
        for chunk in it:
            ids = np.arange(start, start + chunk.num_rows, dtype=np.int64)
            start += chunk.num_rows
            yield chunk.with_column(name, ids, AlinkTypes.LONG)


class PrintStreamOp(StreamOperator):
    """Print each micro-batch, pass through (reference:
    operator/stream/utils/PrintStreamOp.java)."""

    NUM_ROWS = ParamInfo("numRows", int, default=20)

    _min_inputs = 1
    _max_inputs = 1

    def _stream_impl(self, it: Iterator[MTable]) -> Iterator[MTable]:
        for chunk in it:
            print(chunk.to_display_string(max_rows=self.get(self.NUM_ROWS)))
            yield chunk


class MemSourceStreamOp(TableSourceStreamOp):
    """In-memory rows as a stream (reference:
    operator/stream/source/MemSourceStreamOp.java)."""

    def __init__(self, rows, schema, params=None, **kw):
        t = rows if isinstance(rows, MTable) else MTable.from_rows(
            rows, schema if isinstance(schema, TableSchema)
            else TableSchema.parse(schema))
        super().__init__(t, params, **kw)


class NumSeqSourceStreamOp(StreamOperator):
    """LONG sequence [from, to] as a stream (reference:
    operator/stream/source/NumSeqSourceStreamOp.java)."""

    # primary name is fromIndex ('from' is a Python keyword and cannot be a
    # kwarg); the reference's 'from' still works via params dict / alias
    FROM = ParamInfo("fromIndex", int, default=0, aliases=("from", "start"))
    TO = ParamInfo("to", int, optional=False, aliases=("toIndex", "end"))
    OUTPUT_COL = ParamInfo("outputCol", str, default="num")
    CHUNK_SIZE = ParamInfo("chunkSize", int, default=256,
                           validator=MinValidator(1))

    _max_inputs = 0

    def _stream_impl(self) -> Iterator[MTable]:
        lo, hi = self.get(self.FROM), self.get(self.TO)
        cs = self.get(self.CHUNK_SIZE)
        name = self.get(self.OUTPUT_COL)
        schema = TableSchema([name], [AlinkTypes.LONG])
        for s in range(lo, hi + 1, cs):
            vals = np.arange(s, min(s + cs, hi + 1), dtype=np.int64)
            yield MTable({name: vals}, schema)


class RandomTableSourceStreamOp(StreamOperator):
    """Random numeric table stream (reference:
    operator/stream/source/RandomTableSourceStreamOp.java)."""

    NUM_COLS = ParamInfo("numCols", int, default=4,
                         validator=MinValidator(1))
    MAX_ROWS = ParamInfo("maxRows", int, default=1000,
                         aliases=("numRows",), validator=MinValidator(1))
    CHUNK_SIZE = ParamInfo("chunkSize", int, default=256,
                           validator=MinValidator(1))
    ID_COL = ParamInfo("idCol", str, default=None)
    OUTPUT_COL_CONFS = ParamInfo("outputColConfs", str, default=None,
                                 desc="ignored: uniform(0,1) columns")
    SEED = ParamInfo("randomSeed", int, default=0, aliases=("seed",))

    _max_inputs = 0

    def _stream_impl(self) -> Iterator[MTable]:
        rng = np.random.default_rng(self.get(self.SEED))
        d = self.get(self.NUM_COLS)
        total = self.get(self.MAX_ROWS)
        cs = self.get(self.CHUNK_SIZE)
        id_col = self.get(self.ID_COL)
        names = ([id_col] if id_col else []) + [f"col{i}" for i in range(d)]
        types = (([AlinkTypes.LONG] if id_col else [])
                 + [AlinkTypes.DOUBLE] * d)
        schema = TableSchema(names, types)
        emitted = 0
        while emitted < total:
            n = min(cs, total - emitted)
            cols = {}
            if id_col:
                cols[id_col] = np.arange(emitted, emitted + n,
                                         dtype=np.int64)
            for i in range(d):
                cols[f"col{i}"] = rng.random(n)
            emitted += n
            yield MTable(cols, schema)


class RandomVectorSourceStreamOp(StreamOperator):
    """Random dense-vector stream (reference:
    operator/stream/source/RandomVectorSourceStreamOp.java)."""

    NUM_ROWS = ParamInfo("numRows", int, default=100,
                         aliases=("maxRows",), validator=MinValidator(1))
    SIZE = ParamInfo("size", list, default=[3])
    SPARSITY = ParamInfo("sparsity", float, default=1.0,
                         validator=RangeValidator(0.0, 1.0))
    ID_COL = ParamInfo("idCol", str, default="alink_id")
    OUTPUT_COL = ParamInfo("outputCol", str, default="vec")
    CHUNK_SIZE = ParamInfo("chunkSize", int, default=256,
                           validator=MinValidator(1))
    SEED = ParamInfo("randomSeed", int, default=0, aliases=("seed",))

    _max_inputs = 0

    def _stream_impl(self) -> Iterator[MTable]:
        from ..batch.relational2 import RandomVectorSourceBatchOp

        table = RandomVectorSourceBatchOp(
            numRows=self.get(self.NUM_ROWS), size=self.get(self.SIZE),
            sparsity=self.get(self.SPARSITY), idCol=self.get(self.ID_COL),
            outputCol=self.get(self.OUTPUT_COL),
            randomSeed=self.get(self.SEED))._execute_impl()
        cs = self.get(self.CHUNK_SIZE)
        for s in range(0, table.num_rows, cs):
            yield table.slice(s, min(s + cs, table.num_rows))
