"""Pipelined DAG execution engine under the deferred-operator API (port of
``alink_tpu.common.executor``).

The operator layer builds a host-side DAG (``link``/``linkFrom``) and defers
work to ``execute()``/``collect()``. This module schedules it:

1. **Concurrent branch scheduling** — the pending sub-DAG is collected once,
   in-degrees are counted, and every ready unit is dispatched onto the
   session's DAG thread pool (``MLEnvironment.dag_pool``, threads
   ``alink-dag``), so independent branches run concurrently. Node tasks go
   through ``op._evaluate()``, whose ``_executed``/``_eval_lock`` pair keeps
   shared upstreams exactly-once even when external threads race the
   scheduler. On one card the branches share the default CUDA stream, so
   their device work serializes; what overlaps is host work (tokenizing,
   model decode, staging) and one branch's host work with another's kernels.
2. **Mapper-chain fusion** — maximal linear runs of row-wise mapper ops
   (MapBatchOp / ModelMapBatchOp with a single in-graph consumer per link)
   collapse into ONE scheduled unit run as a
   :class:`~alink_tpu_torch.mapper.base.FusedMapperChain`: intermediate DAG
   nodes are never materialized, and consecutive mappers that expose a
   torch block kernel compose into one program over one staged block (one
   host→device copy and one device→host copy for the whole run). Outputs are
   bit-identical to node-by-node execution.
3. **Per-node trace** — every unit records its wall time, its interval on
   the ``time.perf_counter`` clock (``t0_s``/``t1_s``), the device memory in
   use after it (``hbm_bytes``, ``common/profiling.py``; absent on the CPU)
   and whatever phases the lower layers report (``transfer_s``/
   ``compute_s`` from ``common/streaming.py``) into ``common/metrics.py``
   (``executor_trace``). A unit's wall is honest because every node ends in
   a host ``MTable``, whose device-to-host copy waits for its kernels.
4. **Fault tolerance** — failed units are retried under the central
   :class:`~alink_tpu_torch.common.resilience.RetryPolicy` when the error
   is transient (``is_retryable``); this is safe because ``_executed`` is
   only set on success, so a retry re-runs exactly the failed work.
   Degradation ladder: a fused chain that fails *defuses* and re-runs node
   by node before its failure counts as an attempt, and a DAG-pool failure
   (shutdown/exhaustion) falls back to the serial recursive walk. Both stay
   on the session's device. A sticky CUDA error is neither retried nor
   defused: it poisons the context for every branch, so it propagates at
   once. A run that ultimately fails propagates the first failure
   unchanged, drains in-flight branches, and leaves the DAG re-collectable:
   a later ``collect()`` re-plans only the unfinished sub-DAG. The ``unit``
   fault-injection point (``common/faults.py``) fires at the start of every
   attempt.

Knobs (env), the reference's:

- ``ALINK_DAG_SCHEDULER=off`` — fall back to the serial recursive walk.
- ``ALINK_DAG_FUSION=0``      — schedule every node individually.
- ``ALINK_DAG_POOL_SIZE``     — DAG pool width (default: session parallelism,
  capped at 8).
- ``ALINK_RETRIES=off``       — fail fast on the first error (no unit
  retries, no defusion, no serial degradation).
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import FIRST_COMPLETED, wait
from typing import Any, Dict, List, Optional, Sequence

from .env import env_int, env_str
from .exceptions import is_sticky_device_error
from .faults import maybe_fail
from .metrics import metrics, node_phase_context
from .profiling import sample_device_memory
from .resilience import retries_enabled, with_retries
from .tracing import attach_context, capture_context, trace_span

_DAG_THREAD_PREFIX = "alink-dag"
_TRACE_LIMIT = 4096  # ring bound on trace series: long-lived processes
                     # collect() in a loop and must not leak records


def scheduler_enabled() -> bool:
    return (env_str("ALINK_DAG_SCHEDULER", "") or "").lower() not in (
        "off", "0", "serial")


def fusion_enabled() -> bool:
    return (env_str("ALINK_DAG_FUSION", "1") or "1").lower() not in (
        "0", "off")


def _in_dag_worker() -> bool:
    return threading.current_thread().name.startswith(_DAG_THREAD_PREFIX)


# ---------------------------------------------------------------------------
# Schedulable units
# ---------------------------------------------------------------------------


class _Unit:
    """One schedulable task: a single op, or a fused mapper chain whose tail
    is the only node that materializes."""

    __slots__ = ("ops", "deps", "consumers", "indegree")

    def __init__(self, ops: List[Any]):
        self.ops = ops                 # chain order; [-1] is the tail
        self.deps: set = set()         # unit ids this unit waits on
        self.consumers: List["_Unit"] = []
        self.indegree = 0

    @property
    def tail(self):
        return self.ops[-1]

    @property
    def fused(self) -> bool:
        return len(self.ops) > 1

    def run(self):
        if self.fused:
            self._run_fused()
        else:
            self.tail._evaluate()

    def _run_fused(self):
        from ..mapper.base import FusedMapperChain

        tail = self.tail
        with tail._eval_lock:
            if tail._executed:      # raced by an external _evaluate(): done,
                return              # and intermediates stayed consistent
            head = self.ops[0]
            src = head._inputs[head._fusion_data_index]._evaluate()
            schema = src.schema
            mappers = []
            for op in self.ops:
                m = op._fusion_mapper(schema)
                mappers.append(m)
                schema = m.output_schema(schema)
            out = FusedMapperChain(mappers).map_table(src)
            tail._set_result(out)

    def label(self) -> str:
        if self.fused:
            return "+".join(type(o).__name__ for o in self.ops)
        return type(self.tail).__name__


# ---------------------------------------------------------------------------
# Graph collection + fusion planning
# ---------------------------------------------------------------------------


def _collect_pending(roots: Sequence[Any]) -> List[Any]:
    """Every unexecuted op reachable from ``roots`` via ``_inputs``, in
    reverse-finish DFS order (deps before consumers)."""
    seen: Dict[int, Any] = {}
    order: List[Any] = []

    def visit(op):
        if id(op) in seen or op._executed:
            return
        seen[id(op)] = op
        for i in op._inputs:
            visit(i)
        order.append(op)

    for r in roots:
        visit(r)
    return order


def _fusable(op) -> bool:
    from ..operator.batch.utils import MapBatchOp, ModelMapBatchOp

    if not getattr(op, "_fusable", True):
        return False
    # fusion replays _execute_impl as mapper.map_table over the data edge, so
    # it is only sound for ops that (a) kept the stock execute body and
    # (b) are linked in the stock arity — subclasses with a custom
    # _execute_impl or extra inputs must run as ordinary nodes
    if isinstance(op, ModelMapBatchOp):
        return (type(op)._execute_impl is ModelMapBatchOp._execute_impl
                and len(op._inputs) == 2)
    if isinstance(op, MapBatchOp):
        return (type(op)._execute_impl is MapBatchOp._execute_impl
                and len(op._inputs) == 1)
    return False


def _plan_units(nodes: List[Any], roots: Sequence[Any]) -> List[_Unit]:
    node_ids = {id(op) for op in nodes}
    root_ids = {id(r) for r in roots}

    consumers_cnt: Dict[int, int] = {}
    for op in nodes:
        for i in op._inputs:
            if id(i) in node_ids:
                consumers_cnt[id(i)] = consumers_cnt.get(id(i), 0) + 1

    # chain links: data-edge a -> b where a may stay unmaterialized
    follows: Dict[int, Any] = {}
    if fusion_enabled():
        for op in nodes:
            if not _fusable(op):
                continue
            d = op._inputs[op._fusion_data_index]
            if id(d) not in node_ids or not _fusable(d):
                continue
            if consumers_cnt.get(id(d), 0) != 1 or id(d) in root_ids:
                continue
            follows[id(d)] = op

    has_pred = {id(op) for op in follows.values()}
    in_chain: Dict[int, _Unit] = {}
    units: List[_Unit] = []
    for op in nodes:
        if id(op) in in_chain or id(op) in has_pred:
            continue
        if id(op) in follows:       # chain start
            chain = [op]
            while id(chain[-1]) in follows:
                chain.append(follows[id(chain[-1])])
            u = _Unit(chain)
            for c in chain:
                in_chain[id(c)] = u
            units.append(u)
        else:
            u = _Unit([op])
            in_chain[id(op)] = u
            units.append(u)

    # unit dependency edges (dedup; intermediates resolve to their chain)
    for u in units:
        for op in u.ops:
            for i in op._inputs:
                du = in_chain.get(id(i))
                if du is not None and du is not u:
                    u.deps.add(id(du))
    by_id = {id(u): u for u in units}
    for u in units:
        u.indegree = len(u.deps)
        for dep_id in u.deps:
            by_id[dep_id].consumers.append(u)
    return units


# ---------------------------------------------------------------------------
# The scheduler
# ---------------------------------------------------------------------------


def _dag_pool_size(env) -> int:
    n = env_int("ALINK_DAG_POOL_SIZE", 0)
    if n > 0:
        return n
    return max(2, min(8, env.parallelism))


def _run_unit_resilient(unit: _Unit) -> Dict[str, Any]:
    """One unit through the resilience ladder. Every attempt starts at the
    ``unit`` fault-injection tap; a fused chain's first failure defuses it
    (node-by-node re-run, intermediates materialize) *within the same
    attempt*, so retry budget is only spent once fusion is ruled out as the
    cause. A sticky CUDA error skips the ladder. Returns attempt accounting
    for the node trace."""
    state = {"defused": False, "attempts": 0}

    def attempt():
        state["attempts"] += 1
        try:
            maybe_fail("unit", label=unit.label())
            if state["defused"]:
                for op in unit.ops:
                    op._evaluate()
            else:
                unit.run()
        except (KeyboardInterrupt, SystemExit, GeneratorExit):
            raise
        except BaseException as exc:
            if (retries_enabled() and unit.fused and not state["defused"]
                    and not is_sticky_device_error(exc)):
                state["defused"] = True
                metrics.incr("resilience.defused")
                # the defused re-run goes through the injection tap too —
                # a persistent fatal fault must propagate, not be absorbed
                # by defusion. May raise: counts as this attempt's failure
                # and enters the retry loop.
                maybe_fail("unit", label=unit.label())
                for op in unit.ops:
                    op._evaluate()
            else:
                raise

    with_retries(attempt, name=f"unit:{unit.label()}",
                 counter="resilience.unit_retries")
    return state


def _run_unit(unit: _Unit, record: bool, ctx=None):
    phases: Dict[str, Any] = {}
    state = {"defused": False, "attempts": 0}
    t0 = time.perf_counter()
    with attach_context(ctx):
        # one span per scheduled unit: a fused chain is ONE span with a
        # `fused` mark, parented to the dag.run root even though this
        # executes on an alink-dag pool thread
        with trace_span(unit.label(),
                        fused=len(unit.ops) if unit.fused else None) as sp:
            try:
                with node_phase_context(phases):
                    state = _run_unit_resilient(unit)
            finally:
                if sp is not None:
                    sp.phases.update({k: v for k, v in phases.items()
                                      if isinstance(v, (int, float))})
                    if state["defused"]:
                        sp.outcome = sp.outcome or "defused"
                    if state["attempts"] > 1:
                        sp.attrs["attempts"] = state["attempts"]
    t1 = time.perf_counter()
    # device-memory watermark at the node boundary: a cheap latched no-op
    # on a host without CUDA
    hbm_bytes = sample_device_memory()
    if record:
        wall = t1 - t0
        rec = {"op": unit.label(), "wall_s": round(wall, 6),
               "t0_s": t0, "t1_s": t1}
        if hbm_bytes is not None:
            rec["hbm_bytes"] = hbm_bytes
        if unit.fused:
            rec["fused"] = len(unit.ops)
        if state["attempts"] > 1:
            rec["attempts"] = state["attempts"]
        if state["defused"]:
            rec["defused"] = True
        for k, v in phases.items():
            rec[k] = round(v, 6) if isinstance(v, float) else v
        metrics.record_bounded("executor.node", _TRACE_LIMIT, **rec)
        metrics.add_time("executor.node_wall", wall)
        metrics.observe("executor.node_s", wall)


def run_dag(env, roots: Sequence[Any], record: bool = True) -> None:
    """Evaluate every op in ``roots`` (and their pending upstreams) through
    the pipelined scheduler. After return each root satisfies
    ``root._executed`` (its ``_evaluate()`` is a memoized read).

    Falls back to the serial recursive walk when the scheduler is disabled,
    when called from inside a DAG worker (nested ``collect()`` in an op body
    must not wait on its own pool), when the graph is trivial, or — with
    retries enabled — when the DAG pool itself fails (shutdown mid-flight,
    thread exhaustion).

    A failing run raises the *first* unit failure unchanged after draining
    every in-flight branch; completed units stay memoized, so a later
    ``collect()`` re-plans only the unfinished sub-DAG."""
    roots = [r for r in roots if r is not None]
    if not roots:
        return
    if not scheduler_enabled() or _in_dag_worker():
        for r in roots:
            r._evaluate()
        return

    nodes = _collect_pending(roots)
    if not nodes:        # everything memoized: pure reads, no trace noise
        for r in roots:
            r._evaluate()
        return
    if len(nodes) == 1:
        with trace_span("dag.run", mode="serial", nodes=1):
            for r in roots:
                r._evaluate()
        return

    units = _plan_units(nodes, roots)
    with trace_span("dag.run", nodes=len(nodes), units=len(units)):
        _run_scheduled(env, roots, units, nodes, record)


def _run_scheduled(env, roots: Sequence[Any], units: List[_Unit],
                   nodes: List[Any], record: bool) -> None:
    ctx = capture_context()   # units run on alink-dag pool threads; the
    t_start = time.perf_counter()  # captured context keeps their spans
                                   # parented to this run's root span
    ready = [u for u in units if u.indegree == 0]
    remaining = len(units)
    futures: Dict[Any, _Unit] = {}
    first_exc: Optional[BaseException] = None
    degraded = False

    try:
        pool = env.dag_pool
    except BaseException:
        if not retries_enabled():
            raise
        pool, degraded = None, True

    while (ready or futures) and remaining and not degraded:
        if first_exc is None:
            try:
                while ready:
                    u = ready[-1]
                    futures[pool.submit(_run_unit, u, record, ctx)] = u
                    ready.pop()
            except BaseException as exc:
                # pool broke (shutdown/exhaustion), not the unit itself:
                # degrade to the serial walk instead of failing the job
                if not retries_enabled():
                    if first_exc is None:
                        first_exc = exc
                    ready = []
                else:
                    degraded = True
        if not futures:
            break
        done, _ = wait(list(futures), return_when=FIRST_COMPLETED)
        for f in done:
            u = futures.pop(f)
            remaining -= 1
            exc = f.exception()
            if exc is not None:
                if first_exc is None:
                    first_exc = exc
                continue
            for c in u.consumers:
                c.indegree -= 1
                if c.indegree == 0:
                    ready.append(c)
    if degraded:
        # drain whatever the pool still runs, then finish serially —
        # memoization skips every unit that already completed
        if futures:
            wait(list(futures))
            futures.clear()
        metrics.incr("resilience.degraded_serial")
        if first_exc is None:
            for r in roots:
                r._evaluate()
    if record:
        metrics.add_time("executor.schedule", time.perf_counter() - t_start)
        metrics.record_bounded(
            "executor.run", _TRACE_LIMIT,
            units=len(units), nodes=len(nodes),
            fused_chains=sum(1 for u in units if u.fused),
            degraded=degraded,
            wall_s=round(time.perf_counter() - t_start, 6))
    if first_exc is not None:
        raise first_exc
