"""LocalOperator family + the host work-splitting engine (port of
``alink_tpu.operator.local``).

Capability parity with the reference's local engine (reference:
operator/local/LocalOperator.java + AlinkLocalSession.java:20-45 — a fixed
thread pool plus ``DefaultDistributedInfo`` work splitting so local ops
exploit every core without a cluster;
common/io/directreader/DefaultDistributedInfo.java).

Batch execution is already in-process and pull-based, so LocalOperator
shares the batch implementations; what this module adds is the thread-pool
half: :func:`split_work` (the DefaultDistributedInfo analog) and
:func:`parallel_apply`, which fan embarrassingly parallel host-side work —
per-group model fits, per-group outlier scoring, file shards — across the
session executor (``alink-local`` threads). A call made from one of those
threads runs serially, so nested calls cannot deadlock the pool; DAG nodes
run on their own ``alink-dag`` pool and fan out here as any caller does.
The ``*LocalOp`` name table of the reference's ``generated.py`` is not
ported (ROADMAP A7)."""

from __future__ import annotations

import threading
from typing import Callable, List, Sequence, Tuple, TypeVar

from ..batch import (
    BatchOperator as _BatchOperator,
    CsvSourceBatchOp as _CsvSource,
    MemSourceBatchOp as _MemSource,
    TableSourceBatchOp as _TableSource,
)

T = TypeVar("T")
R = TypeVar("R")


def split_work(total: int, num_workers: int) -> List[Tuple[int, int]]:
    """(start, length) per worker, remainder spread over the first workers
    (reference: DefaultDistributedInfo.java — the same rounding so shard
    sizes differ by at most 1)."""
    num_workers = max(1, num_workers)
    base, extra = divmod(total, num_workers)
    out = []
    start = 0
    for w in range(num_workers):
        n = base + (1 if w < extra else 0)
        out.append((start, n))
        start += n
    return out


def parallel_apply(fn: Callable[[T], R], items: Sequence[T],
                   env=None, min_items: int = 2) -> List[R]:
    """Run ``fn`` over ``items`` on the session thread pool, preserving
    order. Serial below ``min_items`` (or with a 1-thread pool) so small
    jobs skip the pool overhead. Exceptions propagate from the first
    failing item, matching the serial contract."""
    items = list(items)
    if len(items) < min_items:
        return [fn(x) for x in items]
    # already on a pool worker (nested parallel_apply / lazy flush): run
    # serial — blocking on the same pool from inside it deadlocks once all
    # workers wait on queued inner tasks
    if threading.current_thread().name.startswith("alink-local"):
        return [fn(x) for x in items]
    if env is None:
        from ...common.env import MLEnvironmentFactory

        env = MLEnvironmentFactory.get_default()
    if env.parallelism <= 1:
        return [fn(x) for x in items]
    # one future PER SHARD, not per item: split_work balances the items
    # across the pool and a big grouped job submits parallelism futures
    # instead of thousands
    shards = [se for se in split_work(len(items), env.parallelism)
              if se[1] > 0]

    def run_shard(se):
        start, length = se
        return [fn(x) for x in items[start:start + length]]

    futures = [env.executor.submit(run_shard, se) for se in shards]
    out: List[R] = []
    for f in futures:
        out.extend(f.result())
    return out


class LocalOperator(_BatchOperator):
    pass


class MemSourceLocalOp(_MemSource, LocalOperator):
    pass


class CsvSourceLocalOp(_CsvSource, LocalOperator):
    pass


class TableSourceLocalOp(_TableSource, LocalOperator):
    pass
