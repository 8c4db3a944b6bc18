"""Relational long-tail: outer joins, multiset set-ops, exact-size samples,
rename, print, wrappers (port of ``alink_tpu.operator.batch.relational2``).

Capability parity (reference: operator/batch/sql/LeftOuterJoinBatchOp.java,
RightOuterJoinBatchOp.java, FullOuterJoinBatchOp.java,
IntersectAllBatchOp.java, MinusAllBatchOp.java, AsBatchOp.java,
dataproc/SampleWithSizeBatchOp.java, StratifiedSampleWithSizeBatchOp.java,
utils/PrintBatchOp.java, utils/DataSetWrapperBatchOp.java,
source/RandomVectorSourceBatchOp.java).

Host operators, copies of the reference's: the joins run on the port's
``JoinBatchOp``, the multiset ops count rows in a ``Counter``, and the
samplers and the random source draw from the reference's numpy streams
(``default_rng(randomSeed)``), so the rows are the same.
"""

from __future__ import annotations

from typing import List

import numpy as np

from ...common.exceptions import AkIllegalArgumentException
from ...common.linalg import DenseVector
from ...common.mtable import AlinkTypes, MTable, TableSchema
from ...common.params import MinValidator, ParamInfo, RangeValidator
from .base import BatchOperator, TableSourceBatchOp
from . import JoinBatchOp


class LeftOuterJoinBatchOp(JoinBatchOp):
    """(reference: operator/batch/sql/LeftOuterJoinBatchOp.java)"""

    def __init__(self, join_predicate: str = None, select_clause: str = "*",
                 **kw):
        kw.pop("how", None)
        pred = join_predicate or kw.pop("joinPredicate", None)
        super().__init__(pred, select_clause, how="left", **kw)


class RightOuterJoinBatchOp(JoinBatchOp):
    """(reference: operator/batch/sql/RightOuterJoinBatchOp.java)"""

    def __init__(self, join_predicate: str = None, select_clause: str = "*",
                 **kw):
        kw.pop("how", None)
        pred = join_predicate or kw.pop("joinPredicate", None)
        super().__init__(pred, select_clause, how="right", **kw)


class FullOuterJoinBatchOp(JoinBatchOp):
    """(reference: operator/batch/sql/FullOuterJoinBatchOp.java)"""

    def __init__(self, join_predicate: str = None, select_clause: str = "*",
                 **kw):
        kw.pop("how", None)
        pred = join_predicate or kw.pop("joinPredicate", None)
        super().__init__(pred, select_clause, how="full", **kw)


class IntersectAllBatchOp(BatchOperator):
    """INTERSECT ALL: keep min(count_left, count_right) copies of each row
    (reference: operator/batch/sql/IntersectAllBatchOp.java)."""

    _min_inputs = 2
    _max_inputs = 2

    def _execute_impl(self, a: MTable, b: MTable) -> MTable:
        from collections import Counter

        rows_b = Counter(tuple(r) for r in b.rows())
        keep = np.zeros(a.num_rows, bool)
        for i, r in enumerate(a.rows()):
            k = tuple(r)
            if rows_b.get(k, 0) > 0:
                rows_b[k] -= 1
                keep[i] = True
        return a.filter_mask(keep)

    def _out_schema(self, a, b):
        return a


class MinusAllBatchOp(BatchOperator):
    """EXCEPT ALL: subtract per-occurrence counts (reference:
    operator/batch/sql/MinusAllBatchOp.java)."""

    _min_inputs = 2
    _max_inputs = 2

    def _execute_impl(self, a: MTable, b: MTable) -> MTable:
        from collections import Counter

        rows_b = Counter(tuple(r) for r in b.rows())
        keep = np.ones(a.num_rows, bool)
        for i, r in enumerate(a.rows()):
            k = tuple(r)
            if rows_b.get(k, 0) > 0:
                rows_b[k] -= 1
                keep[i] = False
        return a.filter_mask(keep)

    def _out_schema(self, a, b):
        return a


class AsBatchOp(BatchOperator):
    """Rename ALL columns positionally: ``as("a, b, c")`` (reference:
    operator/batch/sql/AsBatchOp.java)."""

    CLAUSE = ParamInfo("clause", str, optional=False, aliases=("fields",))

    _min_inputs = 1
    _max_inputs = 1

    def _names(self):
        return [c.strip() for c in self.get(self.CLAUSE).split(",")
                if c.strip()]

    def _execute_impl(self, t: MTable) -> MTable:
        names = self._names()
        if len(names) != len(t.names):
            raise AkIllegalArgumentException(
                f"AS clause has {len(names)} names for {len(t.names)} cols")
        return t.rename(dict(zip(t.names, names)))

    def _out_schema(self, in_schema):
        return TableSchema(self._names(), list(in_schema.types))


class SampleWithSizeBatchOp(BatchOperator):
    """Exact-size random sample, with or without replacement (reference:
    operator/batch/dataproc/SampleWithSizeBatchOp.java)."""

    SIZE = ParamInfo("size", int, optional=False,
                     aliases=("sampleSize", "numSamples"),
                     validator=MinValidator(1))
    WITH_REPLACEMENT = ParamInfo("withReplacement", bool, default=False)
    SEED = ParamInfo("randomSeed", int, default=0, aliases=("seed",))

    _min_inputs = 1
    _max_inputs = 1

    def _execute_impl(self, t: MTable) -> MTable:
        rng = np.random.default_rng(self.get(self.SEED))
        k = int(self.get(self.SIZE))
        n = t.num_rows
        if self.get(self.WITH_REPLACEMENT):
            idx = rng.integers(0, n, size=k)
        else:
            idx = rng.permutation(n)[:min(k, n)]
        return t.take(np.sort(idx))

    def _out_schema(self, in_schema):
        return in_schema


class StratifiedSampleWithSizeBatchOp(BatchOperator):
    """Exact per-stratum sample sizes: ``strataSizes="a:10,b:20"``
    (reference: operator/batch/dataproc/
    StratifiedSampleWithSizeBatchOp.java)."""

    STRATA_COL = ParamInfo("strataCol", str, optional=False)
    STRATA_SIZE = ParamInfo("strataSize", int, default=-1,
                            desc="uniform per-stratum size when >0")
    STRATA_SIZES = ParamInfo("strataSizes", str, default=None,
                             desc="per-value sizes 'v1:n1,v2:n2'")
    SEED = ParamInfo("randomSeed", int, default=0, aliases=("seed",))

    _min_inputs = 1
    _max_inputs = 1

    def _execute_impl(self, t: MTable) -> MTable:
        rng = np.random.default_rng(self.get(self.SEED))
        col = np.asarray(t.col(self.get(self.STRATA_COL)), object).astype(str)
        sizes = {}
        if self.get(self.STRATA_SIZES):
            for part in self.get(self.STRATA_SIZES).split(","):
                k, v = part.split(":")
                sizes[k.strip()] = int(v)
        default = int(self.get(self.STRATA_SIZE))
        picks: List[np.ndarray] = []
        for val in np.unique(col):
            rows = np.nonzero(col == val)[0]
            k = sizes.get(str(val), default)
            if k < 0:
                raise AkIllegalArgumentException(
                    f"no size declared for stratum {val!r}")
            picks.append(rng.permutation(rows)[:min(k, rows.size)])
        idx = np.sort(np.concatenate(picks)) if picks else np.asarray([], int)
        return t.take(idx)

    def _out_schema(self, in_schema):
        return in_schema


class PrintBatchOp(BatchOperator):
    """Print rows and pass the table through (reference:
    operator/batch/utils/PrintBatchOp.java)."""

    NUM_ROWS = ParamInfo("numRows", int, default=20)

    _min_inputs = 1
    _max_inputs = 1

    def _execute_impl(self, t: MTable) -> MTable:
        print(t.to_display_string(max_rows=self.get(self.NUM_ROWS)))
        return t

    def _out_schema(self, in_schema):
        return in_schema


class DataSetWrapperBatchOp(TableSourceBatchOp):
    """Wrap an in-memory MTable as an operator (reference:
    operator/batch/utils/DataSetWrapperBatchOp.java — the DataSet→op
    bridge; here MTable IS the dataset)."""


class RandomVectorSourceBatchOp(BatchOperator):
    """Random dense-vector table (reference:
    operator/batch/source/RandomVectorSourceBatchOp.java)."""

    NUM_ROWS = ParamInfo("numRows", int, default=100,
                         validator=MinValidator(1))
    SIZE = ParamInfo("size", list, default=[3],
                     desc="vector dims, e.g. [8]")
    SPARSITY = ParamInfo("sparsity", float, default=1.0,
                         validator=RangeValidator(0.0, 1.0))
    ID_COL = ParamInfo("idCol", str, default="alink_id")
    OUTPUT_COL = ParamInfo("outputCol", str, default="vec")
    SEED = ParamInfo("randomSeed", int, default=0, aliases=("seed",))

    _max_inputs = 0

    def _execute_impl(self) -> MTable:
        rng = np.random.default_rng(self.get(self.SEED))
        n = self.get(self.NUM_ROWS)
        dims = int(np.prod([int(s) for s in self.get(self.SIZE)]))
        vals = rng.random((n, dims))
        mask = rng.random((n, dims)) < self.get(self.SPARSITY)
        vecs = np.empty(n, object)
        for i in range(n):
            vecs[i] = DenseVector(np.where(mask[i], vals[i], 0.0))
        return MTable(
            {self.get(self.ID_COL): np.arange(n, dtype=np.int64),
             self.get(self.OUTPUT_COL): vecs},
            self._out_schema())

    def _out_schema(self) -> TableSchema:
        return TableSchema(
            [self.get(self.ID_COL), self.get(self.OUTPUT_COL)],
            [AlinkTypes.LONG, AlinkTypes.DENSE_VECTOR])
