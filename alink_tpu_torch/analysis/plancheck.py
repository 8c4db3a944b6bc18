"""Plan-time static validation of deferred operator DAGs (port of
``alink_tpu.analysis.plancheck`` for batch DAGs and pipelines, and its
serving pre-flights).

:func:`validate_plan` walks the static-schema machinery
(``_out_schema``/``_static_schema``) node by node ahead of execution and
turns what would be a mid-job error into a structured diagnostic:

- **ALK101** columns named by selectedCols/featureCols/labelCol/... missing
  from the upstream schema;
- **ALK102** non-numeric dtypes feeding numeric kernels;
- **ALK103** a mapper block kernel whose closure captures state that cannot
  be content-keyed, and a huge-embedding op headed for the sharded engine
  with a batch size off the ``bucket_rows`` ladder;
- **ALK105** fusion breakers interrupting linear mapper chains;
- **ALK106** nodes whose static schema cannot be derived (checks downstream
  of them are skipped);
- **ALK110** / **ALK111** the serving tier's fleet-model and quantized-load
  pre-flights.

The stream rules (ALK104, ALK107, ALK109) wait for the stream operators'
checkpoint hooks (ROADMAP A7).

Wiring: ``ALINK_VALIDATE_PLAN=off|warn|error`` (default ``off``) gates an
automatic pre-flight in ``AlgoOperator.execute()/collect()`` and
``Pipeline.fit()`` — ``warn`` logs + counts diagnostics and never changes
results, ``error`` raises
:class:`~alink_tpu_torch.common.exceptions.AkPlanValidationException` when
any error-severity diagnostic is found. Validation only reads static
schemas; it never executes a node.
"""

from __future__ import annotations

import logging
import threading
from typing import Any, Dict, List, Optional, Sequence

from ..common.env import env_str
from ..common.metrics import metrics
from .diagnostics import ERROR, Report

logger = logging.getLogger("alink_tpu_torch.analysis")

_VALIDATE_ENV = "ALINK_VALIDATE_PLAN"
_MODES = ("off", "warn", "error")


def validation_mode() -> str:
    """``ALINK_VALIDATE_PLAN``: ``off`` (default — validation is opt-in),
    ``warn`` (log + count diagnostics, never fail), or ``error`` (raise on
    error-severity diagnostics). Unrecognized values read as ``off``."""
    raw = (env_str(_VALIDATE_ENV, "off") or "off").strip().lower()
    return raw if raw in _MODES else "off"


# ---------------------------------------------------------------------------
# Column-parameter requirements
# ---------------------------------------------------------------------------

_EXISTS = "exists"
_NUMERIC = "numeric"
_NUMVEC = "numvec"         # numeric or vector-typed
_VECTORISH = "vectorish"   # vector-typed, or STRING (parsed by the codec)

# param name -> requirement against the op's *data* input schema. Ops can
# tighten (or relax) per-param via the class attr
# ``_plan_col_requirements = {"selectedCols": "numeric"}``.
_COL_PARAMS: Dict[str, str] = {
    "selectedCol": _EXISTS,
    "selectedCols": _EXISTS,
    "featureCols": _NUMERIC,
    "vectorCol": _VECTORISH,
    "labelCol": _EXISTS,
    "weightCol": _NUMERIC,
    "groupCols": _EXISTS,
    "reservedCols": _EXISTS,
    "censorCol": _NUMERIC,
}


def _col_values(val) -> List[str]:
    if val is None:
        return []
    if isinstance(val, str):
        return [val]
    try:
        return [str(v) for v in val]
    except TypeError:
        return []


def _check_columns(op, schema, label: str, report: Report) -> None:
    """ALK101/ALK102 over the op's declared column params."""
    from ..common.mtable import AlinkTypes

    try:
        p = op.get_params()
    except Exception:
        return
    overrides = getattr(type(op), "_plan_col_requirements", {})
    for name, req in _COL_PARAMS.items():
        try:
            if not p.contains(name):
                continue
            cols = _col_values(p.get(name))
        except Exception:
            continue
        req = overrides.get(name, req)
        for c in cols:
            if c not in schema.names:
                report.add(
                    "ALK101",
                    f"{name} references column {c!r}, absent from the "
                    f"upstream schema [{', '.join(schema.names)}]",
                    where=label,
                    hint=f"check the column name set on {type(op).__name__}")
                continue
            t = schema.type_of(c)
            if req == _NUMERIC and not AlinkTypes.is_numeric(t):
                report.add(
                    "ALK102",
                    f"{name} column {c!r} has type {t}, but feeds a numeric "
                    "kernel",
                    where=label,
                    hint="cast/encode the column (e.g. StringIndexer) or "
                         "drop it from the numeric column list")
            elif req == _NUMVEC and not (
                    AlinkTypes.is_numeric(t) or AlinkTypes.is_vector(t)):
                report.add(
                    "ALK102",
                    f"{name} column {c!r} has type {t}; expected a numeric "
                    "or vector column",
                    where=label,
                    hint="cast/encode the column before assembling it")
            elif req == _VECTORISH and not (
                    AlinkTypes.is_vector(t) or t == AlinkTypes.STRING):
                report.add(
                    "ALK102",
                    f"{name} column {c!r} has type {t}; expected a vector "
                    "column (or a vector-formatted STRING)",
                    where=label,
                    hint="assemble features into a vector column first "
                         "(VectorAssembler)")


# ---------------------------------------------------------------------------
# Batch DAG walk
# ---------------------------------------------------------------------------


def _node_labels(order: Sequence[Any]) -> Dict[int, str]:
    counts: Dict[str, int] = {}
    for op in order:
        counts[type(op).__name__] = counts.get(type(op).__name__, 0) + 1
    seen: Dict[str, int] = {}
    labels: Dict[int, str] = {}
    for op in order:
        name = type(op).__name__
        if counts[name] > 1:
            seen[name] = seen.get(name, 0) + 1
            labels[id(op)] = f"{name}#{seen[name]}"
        else:
            labels[id(op)] = name
    return labels


def _collect_batch(roots: Sequence[Any]) -> List[Any]:
    """Every op reachable from ``roots`` via ``_inputs`` (executed nodes
    included — their real schemas anchor the propagation), deps first."""
    seen: set = set()
    order: List[Any] = []

    def visit(op):
        if id(op) in seen:
            return
        seen.add(id(op))
        for i in op._inputs:
            visit(i)
        order.append(op)

    for r in roots:
        visit(r)
    return order


def _derive_schema(op, in_schemas, label: str, report: Report):
    """The node's static output schema, or None when underivable."""
    from ..operator.base import AlgoOperator, SideOutputOp

    if op._executed and op._output is not None:
        return op._output.schema
    if any(s is None for s in in_schemas):
        return None
    # a sink that never overrode _out_schema must NOT be zero-row-probed by
    # the validator (the default probe runs _execute_impl — a write). Sinks
    # pass their input through, so the input schema IS the answer. Ops can
    # declare `_plan_passthrough` explicitly (True/False beats the
    # class-name heuristic).
    passthrough = getattr(type(op), "_plan_passthrough", None)
    if passthrough is None:
        passthrough = "Sink" in type(op).__name__
    if type(op)._out_schema is AlgoOperator._out_schema and passthrough:
        return in_schemas[0] if in_schemas else None
    try:
        if isinstance(op, SideOutputOp):
            return op._static_schema()
        return op._out_schema(*in_schemas)
    except Exception as e:
        report.add(
            "ALK106",
            f"static schema underivable: {type(e).__name__}: {e}",
            where=label,
            hint="override _out_schema on the op (or ignore: downstream "
                 "schema checks are skipped, execution is unaffected)")
        return None


_unkeyable_probe_cache: Dict[tuple, Optional[str]] = {}
_unkeyable_cache_lock = threading.Lock()
_UNKEYABLE_CACHE_MAX = 512


def _check_unkeyable(op, schema, label: str, report: Report) -> None:
    """ALK103: a stateless mapper kernel whose closure captures state that
    cannot be content-keyed (a tensor, an open handle). The probe builds
    the op's mapper + block kernel, so its outcome (deterministic per op
    type + params + input schema) is memoized."""
    from ..common.jitcache import Unkeyable, fn_content_key
    from ..operator.batch.utils import MapBatchOp

    if not isinstance(op, MapBatchOp) or schema is None:
        return
    if type(op)._execute_impl is not MapBatchOp._execute_impl:
        return
    try:
        cache_key = (type(op),
                     repr(sorted(op.get_params()._map.items(),
                                 key=lambda kv: kv[0])),
                     tuple(schema.names), tuple(schema.types))
    except Exception:
        cache_key = None
    hit = False
    msg = None
    if cache_key is not None:
        with _unkeyable_cache_lock:
            if cache_key in _unkeyable_probe_cache:
                msg = _unkeyable_probe_cache[cache_key]
                hit = True
    if not hit:
        try:
            spec = op._make_mapper(schema).block_kernel(schema)
        except Exception:
            return
        if spec is None:
            msg = None
        else:
            try:
                fn_content_key(spec[3])
                msg = None
            except Unkeyable as e:
                msg = str(e)
            except Exception as e:
                logger.debug("unkeyable probe failed on %s: %r", label, e)
                return
        if cache_key is not None:
            with _unkeyable_cache_lock:
                if len(_unkeyable_probe_cache) >= _UNKEYABLE_CACHE_MAX:
                    _unkeyable_probe_cache.clear()
                _unkeyable_probe_cache[cache_key] = msg
    if msg is not None:
        report.add(
            "ALK103",
            f"block kernel captures state the program-cache key cannot "
            f"content-hash ({msg}); the kernel chain falls back to a "
            "per-instance key, so every fresh mapper instance records its "
            "own shape signatures",
            where=label,
            hint="capture plain scalars/np arrays (content-digested) "
                 "instead of tensors or open handles")


def _check_huge_engine(op, label: str, report: Report) -> None:
    """ALK103 (huge family): a walk/SGNS op headed for the SHARDED engine
    with an off-ladder batch size, which can never share a batch shape with
    neighbouring configurations."""
    if not getattr(op, "_huge_sgns", False):
        return
    try:
        from ..common.jitcache import bucket_rows
        from ..embedding.engine import huge_engine

        p = op.get_params()
        forced = p.contains("shardModel") and bool(p.get("shardModel"))
        if not forced and huge_engine() != "sharded":
            return
        bs = p.get("batchSize") if p.contains("batchSize") else None
        if bs is None:
            bs = getattr(getattr(type(op), "BATCH_SIZE", None),
                         "default", None)
    except Exception:
        return
    if bs and int(bs) > 0 and bucket_rows(int(bs)) != int(bs):
        report.add(
            "ALK103",
            f"batchSize={int(bs)} is off the bucket_rows ladder on the "
            "sharded huge-embedding engine (one routed-exchange program "
            "per batch config; off-ladder sizes never share a compile "
            "across sweeps)",
            where=label,
            hint=f"use a ladder size (e.g. floor_bucket_rows({int(bs)})="
                 f"{_floor(int(bs))}) or pin ALINK_HUGE_ENGINE=host for "
                 "this job")


def _floor(n: int) -> int:
    from ..common.jitcache import floor_bucket_rows

    return floor_bucket_rows(n)


def _check_fusion_chain(order: Sequence[Any], labels: Dict[int, str],
                        report: Report) -> None:
    """ALK105: a mapper-family op that the executor cannot fuse, sitting on
    the data edge between two fusable mapper neighbors — the chain splits
    into separate device programs with host round trips between them."""
    from ..common.executor import _fusable
    from ..operator.batch.utils import MapBatchOp, ModelMapBatchOp

    def mapper_family(op) -> bool:
        return isinstance(op, (MapBatchOp, ModelMapBatchOp))

    children: Dict[int, List[Any]] = {}
    for c in order:
        for i in c._inputs:
            children.setdefault(id(i), []).append(c)

    for op in order:
        if not mapper_family(op) or _fusable(op) or not op._inputs:
            continue
        idx = getattr(type(op), "_fusion_data_index", 0)
        if idx >= len(op._inputs):
            continue
        upstream = op._inputs[idx]
        downstream = children.get(id(op), [])
        breaks_chain = (
            (mapper_family(upstream) and _fusable(upstream))
            or any(mapper_family(c) and _fusable(c) for c in downstream))
        if breaks_chain:
            report.add(
                "ALK105",
                f"{type(op).__name__} cannot fuse (custom _execute_impl, "
                "non-stock arity, or _fusable=False) and interrupts a "
                "linear mapper chain",
                where=labels[id(op)],
                hint="keep the stock MapBatchOp execute body, or move the "
                     "op off the mapper chain's hot path")


def _data_schema_for_checks(op, in_schemas):
    """The schema column params bind against, or None when the data edge
    cannot be trusted (subclasses with a custom ``_execute_impl`` or
    non-stock arity may bind columns against ANY of their inputs)."""
    from ..operator.batch.utils import MapBatchOp, ModelMapBatchOp

    if isinstance(op, ModelMapBatchOp):
        if type(op)._execute_impl is ModelMapBatchOp._execute_impl \
                and len(in_schemas) == 2:
            return in_schemas[1]
        return None
    if isinstance(op, MapBatchOp):
        if type(op)._execute_impl is MapBatchOp._execute_impl \
                and len(in_schemas) == 1:
            return in_schemas[0]
        return None
    return in_schemas[0] if len(in_schemas) == 1 else None


def _validate_batch(roots: Sequence[Any], report: Report) -> None:
    order = _collect_batch(roots)
    labels = _node_labels(order)
    schemas: Dict[int, Any] = {}
    for op in order:
        label = labels[id(op)]
        in_schemas = [schemas.get(id(i)) for i in op._inputs]
        data_schema = _data_schema_for_checks(op, in_schemas)
        if data_schema is not None and not op._executed:
            _check_columns(op, data_schema, label, report)
            _check_unkeyable(op, data_schema, label, report)
        if not op._executed:
            _check_huge_engine(op, label, report)
        schemas[id(op)] = _derive_schema(op, in_schemas, label, report)
    _check_fusion_chain(order, labels, report)


# ---------------------------------------------------------------------------
# Pipeline simulation
# ---------------------------------------------------------------------------


def _as_data_op(data):
    from ..common.mtable import MTable, TableSchema
    from ..operator.base import AlgoOperator
    from ..operator.batch.base import TableSourceBatchOp

    if isinstance(data, AlgoOperator):
        return data
    if isinstance(data, MTable):
        return TableSourceBatchOp(data)
    if isinstance(data, str):
        data = TableSchema.parse(data)
    if isinstance(data, TableSchema):
        return TableSourceBatchOp(MTable.empty(data))
    raise TypeError(f"cannot validate against data of type {type(data)}")


def _pipeline_tail(stages, op, report: Report):
    """Re-link the exact op DAG ``Pipeline.fit`` would build — estimator
    stages contribute (train op -> predict op) pairs whose schema decisions
    ride the train op's *static* model meta, so nothing executes. A stage
    the simulation cannot model truncates the walk, made visible as an
    ALK106 info."""
    from ..pipeline.base import EstimatorBase, ModelBase, TransformerBase

    def stop(i, stage, why):
        report.add(
            "ALK106",
            f"pipeline simulation stopped at stage {i} "
            f"({type(stage).__name__}): {why}; later stages were NOT "
            "validated",
            where=f"stage[{i}]",
            hint="register _train_op_cls/_model_cls/_map_op_cls on the "
                 "stage so the pre-flight can model it (execution is "
                 "unaffected)")
        return op

    for i, stage in enumerate(stages):
        if isinstance(stage, EstimatorBase):
            if stage._train_op_cls is None or stage._model_cls is None:
                return stop(i, stage, "no train/model op registered")
            train = stage._train_op_cls(
                stage.get_params().clone()).link_from(op)
            pred_cls = getattr(stage._model_cls, "_predict_op_cls", None)
            if pred_cls is None:
                return stop(i, stage, "model class has no predict op")
            op = pred_cls(stage.get_params().clone()).link_from(train, op)
        elif isinstance(stage, ModelBase):
            if stage.model_data is None or stage._predict_op_cls is None:
                return stop(i, stage, "model has no data/predict op")
            op = stage.transform(op)
        elif isinstance(stage, TransformerBase):
            if stage._map_op_cls is None:
                return stop(i, stage, "no map op registered")
            op = stage._map_op_cls(stage.get_params().clone()).link_from(op)
        else:
            return stop(i, stage, "unrecognized stage kind")
    return op


def validate_plan(target, data=None) -> Report:
    """Statically validate a deferred plan before running it.

    ``target`` may be a batch :class:`AlgoOperator` (or a list of them — the
    DAG reachable from all roots is walked once), a :class:`Pipeline` or
    fitted :class:`PipelineModel` (``data`` — an operator, MTable,
    TableSchema, or schema string — supplies the input schema). Returns a
    :class:`~alink_tpu_torch.analysis.diagnostics.Report`; never executes a
    node and never raises on a finding (mode enforcement lives in
    :func:`preflight`)."""
    from ..operator.base import AlgoOperator
    from ..pipeline.pipeline import Pipeline, PipelineModel

    report = Report(engine="plan")
    if isinstance(target, (Pipeline, PipelineModel)):
        if data is None:
            raise TypeError(
                "validate_plan(pipeline, data): pass the training/input "
                "data (operator, MTable, TableSchema, or schema string)")
        report.target = type(target).__name__
        tail = _pipeline_tail(target.stages, _as_data_op(data), report)
        _validate_batch([tail], report)
        return report

    roots = list(target) if isinstance(target, (list, tuple)) else [target]
    if not roots:
        return report
    report.target = ", ".join(sorted({type(r).__name__ for r in roots}))
    if not isinstance(roots[0], AlgoOperator):
        raise TypeError(f"cannot validate {type(roots[0]).__name__}")
    _validate_batch(roots, report)
    return report


_report_lock = threading.Lock()
_last_report: Optional[Dict[str, Any]] = None
_suppressed = threading.local()


class suppress_preflight:
    """Context manager: skip nested automatic pre-flights on this thread.
    ``Pipeline.fit()`` validates the WHOLE simulated pipeline up front, then
    wraps its stage loop in this — otherwise every stage's ``execute()``
    re-walks a partial sub-DAG, triple-counting ``analysis.plan_runs`` and
    overwriting the full-pipeline report with a clean partial one."""

    def __enter__(self):
        _suppressed.depth = getattr(_suppressed, "depth", 0) + 1
        return self

    def __exit__(self, *exc):
        _suppressed.depth -= 1
        return False


def last_plan_report() -> Optional[Dict[str, Any]]:
    """The most recent pre-flight's report dict (None before any run) —
    what ``job_report()["analysis"]`` surfaces."""
    with _report_lock:
        return dict(_last_report) if _last_report is not None else None


def _record_report(report: Report, mode: str) -> None:
    global _last_report
    metrics.incr("analysis.plan_runs")
    for d in report.diagnostics:
        metrics.incr(f"analysis.plan_{d.severity}s")
        metrics.incr(f"analysis.rule.{d.rule}")
    with _report_lock:
        _last_report = {"mode": mode, **report.to_dict()}


def preflight(target, data=None, *, where: str = "execute"
              ) -> Optional[Report]:
    """The opt-in pre-flight hook ``execute()``/``collect()``/``fit()``
    call. ``off`` → None without walking anything. ``warn`` → validate,
    log + count findings, return the report (results are bit-identical to
    validation-off). ``error`` → additionally raise
    ``AkPlanValidationException`` when error-severity diagnostics exist. A
    crash inside the validator itself is counted, never propagated."""
    from ..common.exceptions import AkPlanValidationException

    mode = validation_mode()
    if mode == "off" or getattr(_suppressed, "depth", 0):
        return None
    try:
        report = validate_plan(target, data)
    except Exception as e:
        metrics.incr("analysis.validator_errors")
        logger.debug("plan validator failed at %s: %r", where, e)
        return None
    _record_report(report, mode)
    if report.diagnostics:
        logger.warning("plan validation (%s, %s):\n%s",
                       where, mode, report.render())
    if mode == "error" and report.errors():
        raise AkPlanValidationException(report)
    return report


def preflight_quantized_load(name: str, *, policy: str, real_sample: bool,
                             band_enabled: bool, recovery: bool = False,
                             where: str = "serving.load"
                             ) -> Optional[Report]:
    """Pre-flight for quantized serving loads (**ALK111**): a load
    requesting a quantization policy with no real calibration sample
    (caller/sidecar rows — synthesized zero rows never count) or with the
    accuracy band disabled serves numerics nothing has proven. Warning
    severity by default; ``recovery=True`` (respawn/recovery loads)
    escalates to error, refusing the load under
    ``ALINK_VALIDATE_PLAN=error``. ``off`` skips, findings are counted, a
    validator crash is counted and never propagated."""
    from ..common.exceptions import AkPlanValidationException

    mode = validation_mode()
    if mode == "off" or getattr(_suppressed, "depth", 0):
        return None
    report = Report(engine="plan", target="ModelServer")
    try:
        problems = []
        if not real_sample:
            problems.append("no real calibration sample (caller or "
                            "sidecar rows)")
        if not band_enabled:
            problems.append("the accuracy-band gate is disabled")
        if problems:
            report.add(
                "ALK111",
                f"model {name!r} requests precision={policy} with "
                f"{' and '.join(problems)} — the quantized numerics "
                "would serve unproven",
                where=f"serving:{name}",
                severity=ERROR if recovery else "",
                hint="pass real warmup_rows to ModelServer.load (they "
                     "seed calibration AND the accuracy gate), or keep "
                     "quant_band/quant_tol >= 0")
    except Exception as e:
        metrics.incr("analysis.validator_errors")
        logger.debug("quantized-load pre-flight failed at %s: %r", where, e)
        return None
    _record_report(report, mode)
    if report.diagnostics:
        logger.warning("plan validation (%s, %s):\n%s",
                       where, mode, report.render())
    if mode == "error" and report.errors():
        raise AkPlanValidationException(report)
    return report


def preflight_fleet_models(models: Sequence, *, recovery: bool = False,
                           where: str = "fleet.load"
                           ) -> Optional[Report]:
    """Pre-flight for models entering a serving fleet (**ALK110**):
    each ``(name, path)`` must carry a readable ``.ak.warmup.json``
    sidecar, or a respawned replica would silently fall back to
    trace-on-first-traffic bring-up. Warning severity by default;
    ``recovery=True`` (a fleet that respawns replicas — the production
    shape) escalates to error, refusing the load under
    ``ALINK_VALIDATE_PLAN=error``. Same conventions as
    :func:`preflight_quantized_load`: ``off`` skips, findings are counted,
    a validator crash is counted and never propagated."""
    from ..common.exceptions import AkPlanValidationException

    mode = validation_mode()
    if mode == "off" or getattr(_suppressed, "depth", 0):
        return None
    report = Report(engine="plan", target="ServingFleet")
    try:
        from ..serving.warmup_store import load_warmup_spec

        for name, path in models:
            spec = load_warmup_spec(path) if isinstance(path, str) else None
            if spec is None:
                report.add(
                    "ALK110",
                    f"model {name!r} ({path}) has no readable warmup "
                    "sidecar — a respawned replica would warm from live "
                    "traffic instead of disk, tracing on its first "
                    "requests",
                    where=f"fleet:{name}",
                    severity=ERROR if recovery else "",
                    hint="persist one by loading the model through "
                         "ModelServer.load(..., persist_warmup=True) "
                         "once, or write it with "
                         "serving.save_warmup_spec()")
    except Exception as e:
        metrics.incr("analysis.validator_errors")
        logger.debug("fleet pre-flight failed at %s: %r", where, e)
        return None
    _record_report(report, mode)
    if report.diagnostics:
        logger.warning("plan validation (%s, %s):\n%s",
                       where, mode, report.render())
    if mode == "error" and report.errors():
        raise AkPlanValidationException(report)
    return report
