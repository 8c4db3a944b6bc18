"""Mapper framework — the inference runtime (port of ``alink_tpu.mapper.base``).

Capability parity with the reference's mapper stack (reference:
core/src/main/java/com/alibaba/alink/common/mapper/Mapper.java:20,
SISOMapper, ModelMapper.java:24, RichModelMapper, MapperChain). A Mapper
transforms an entire MTable columnar block at once; a row-level ``map_row``
shim is kept for API parity.

Fusion protocol: a row-wise numeric mapper may expose a torch block kernel
(``block_kernel``); :func:`run_kernel_chain` runs consecutive kernels as one
torch program over one staged block — the union of the source columns is
copied to the device once, columns are threaded between the kernels on the
device, and the surviving outputs come back in one device-to-host copy.
:class:`FusedMapperChain` (the DAG executor's fused unit) composes them;
mappers without a kernel run through ``map_table`` as in the plain chain.
"""

from __future__ import annotations

import itertools
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..common.exceptions import AkIllegalArgumentException
from ..common.mtable import AlinkTypes, MTable, TableSchema
from ..common.params import Params, ParamInfo, WithParams


class HasReservedCols:
    RESERVED_COLS = ParamInfo(
        "reservedCols", list, desc="input columns passed through (default: all)"
    )


class HasSelectedCols:
    SELECTED_COLS = ParamInfo("selectedCols", list, desc="input columns used")


class HasSelectedCol:
    SELECTED_COL = ParamInfo("selectedCol", str, desc="the single input column")


class HasOutputCol:
    OUTPUT_COL = ParamInfo("outputCol", str, desc="output column name")


class HasOutputCols:
    OUTPUT_COLS = ParamInfo("outputCols", list, desc="output column names")


class HasPredictionCol:
    PREDICTION_COL = ParamInfo("predictionCol", str, default="pred")


class HasPredictionDetailCol:
    PREDICTION_DETAIL_COL = ParamInfo("predictionDetailCol", str)


class HasVectorCol:
    VECTOR_COL = ParamInfo("vectorCol", str, desc="vector-typed feature column")


class HasFeatureCols:
    FEATURE_COLS = ParamInfo("featureCols", list, desc="numeric feature columns")


class Mapper(WithParams):
    """Stateless table→table transform kernel."""

    def __init__(self, data_schema: Optional[TableSchema] = None, params=None, **kw):
        super().__init__(params, **kw)
        self.data_schema = data_schema

    # -- to implement ------------------------------------------------------
    def output_schema(self, input_schema: TableSchema) -> TableSchema:
        """Schema of map_table's result given the input schema."""
        raise NotImplementedError

    def map_table(self, t: MTable) -> MTable:
        raise NotImplementedError

    # -- fusion protocol ---------------------------------------------------
    def block_kernel(self, input_schema: TableSchema):
        """Optional device-fusion hook. Pure row-wise numeric mappers return
        ``(in_cols, out_cols, out_types, fn)`` where ``fn`` is a torch
        ``(n, len(in_cols)) float32 -> (n, len(out_cols)) float32`` row-wise
        transform; :class:`FusedMapperChain` composes consecutive kernels
        into one program over one staged block. ``None`` (the default)
        means "execute via map_table"."""
        return None

    # -- row shim (serving parity with reference Mapper.map(Row)) ----------
    def map_row(self, row: Sequence, input_schema: Optional[TableSchema] = None):
        schema = input_schema or self.data_schema
        if schema is None:
            raise AkIllegalArgumentException("map_row needs an input schema")
        t = MTable.from_rows([row], schema)
        return self.map_table(t).get_row(0)

    # -- helpers -----------------------------------------------------------
    def reserved(self, input_schema: TableSchema) -> List[str]:
        r = self.get_params().get("reservedCols") if self.get_params().contains(
            "reservedCols"
        ) else None
        return list(r) if r is not None else list(input_schema.names)

    def _append_result_schema(
        self, input_schema: TableSchema, out_names: List[str], out_types: List[str]
    ) -> TableSchema:
        names = [n for n in self.reserved(input_schema) if n not in out_names]
        types = [input_schema.type_of(n) for n in names]
        return TableSchema(names + out_names, types + out_types)

    def _append_result(
        self, t: MTable, out_cols: Dict[str, Any], out_types: Dict[str, str]
    ) -> MTable:
        names = [n for n in self.reserved(t.schema) if n not in out_cols]
        cols = {n: t.col(n) for n in names}
        types = [t.schema.type_of(n) for n in names]
        for n, c in out_cols.items():
            cols[n] = c
            types.append(out_types[n])
        return MTable(cols, TableSchema(list(cols.keys()), types))


class SISOMapper(Mapper, HasSelectedCol, HasOutputCol, HasReservedCols):
    """Single-in single-out column mapper (reference: common/mapper/SISOMapper.java).
    Implement ``map_column(values) -> (values, type_tag)``."""

    def map_column(self, values: np.ndarray, type_tag: str) -> Tuple[Any, str]:
        raise NotImplementedError

    def _io_names(self):
        sel = self.get(HasSelectedCol.SELECTED_COL)
        out = self.get(HasOutputCol.OUTPUT_COL) or sel
        return sel, out

    def output_schema(self, input_schema: TableSchema) -> TableSchema:
        sel, out = self._io_names()
        _, tag = self.map_column(np.empty(0, dtype=object), input_schema.type_of(sel))
        return self._append_result_schema(input_schema, [out], [tag])

    def map_table(self, t: MTable) -> MTable:
        sel, out = self._io_names()
        vals, tag = self.map_column(t.col(sel), t.schema.type_of(sel))
        return self._append_result(t, {out: vals}, {out: tag})


class ModelMapper(Mapper):
    """Mapper with model state (reference: common/mapper/ModelMapper.java:24).
    ``load_model`` ingests a model MTable; hot-swap support mirrors
    ModelMapper.createNew (reference: ModelMapper.java:71-76)."""

    def __init__(self, model_schema=None, data_schema=None, params=None,
                 device=None, **kw):
        super().__init__(data_schema, params, **kw)
        self.model_schema = model_schema
        # torch device the model runs on; None = the port's default
        # (common/env.resolve_device)
        self.device = device

    def load_model(self, model: MTable) -> "ModelMapper":
        raise NotImplementedError

    def create_new(self, model: MTable) -> "ModelMapper":
        """Build a fresh mapper with new model rows (model-stream hot swap),
        on the same device."""
        fresh = type(self)(self.model_schema, self.data_schema,
                           self.get_params(), device=self.device)
        fresh.load_model(model)
        return fresh

class RichModelMapper(ModelMapper, HasPredictionCol, HasPredictionDetailCol,
                      HasReservedCols):
    """Prediction + optional JSON detail column (reference:
    common/mapper/RichModelMapper.java). Implement ``predict_block`` returning
    (pred values, pred type, detail strings or None)."""

    def predict_block(self, t: MTable):
        raise NotImplementedError

    def predict_proba_block(self, t: MTable):
        """(n, k) class probabilities aligned with ``self.meta['labels']``, or
        None for mappers without a probability notion."""
        return None

    def _classification_result(self, probs: np.ndarray):
        """Standard (pred, type, detail) triple from a probability block."""
        labels = self.meta["labels"]
        label_type = self.meta.get("labelType", AlinkTypes.STRING)
        pred = np_labels(labels, label_type, probs.argmax(axis=1))
        detail = None
        if self.get(HasPredictionDetailCol.PREDICTION_DETAIL_COL):
            detail = detail_json(labels, probs)
        return pred, label_type, detail

    def output_schema(self, input_schema: TableSchema) -> TableSchema:
        pred_col = self.get(HasPredictionCol.PREDICTION_COL)
        detail_col = self.get(HasPredictionDetailCol.PREDICTION_DETAIL_COL)
        names, types = [pred_col], [self._pred_type()]
        if detail_col:
            names.append(detail_col)
            types.append(AlinkTypes.STRING)
        return self._append_result_schema(input_schema, names, types)

    def _pred_type(self) -> str:
        return AlinkTypes.STRING

    def map_table(self, t: MTable) -> MTable:
        pred_col = self.get(HasPredictionCol.PREDICTION_COL)
        detail_col = self.get(HasPredictionDetailCol.PREDICTION_DETAIL_COL)
        pred, pred_type, detail = self.predict_block(t)
        out_cols = {pred_col: pred}
        out_types = {pred_col: pred_type}
        if detail_col:
            out_cols[detail_col] = detail
            out_types[detail_col] = AlinkTypes.STRING
        return self._append_result(t, out_cols, out_types)


class MapperChain:
    """Mapper pipeline (reference: common/mapper/MapperChain.java)."""

    def __init__(self, mappers: Sequence[Mapper]):
        self.mappers = list(mappers)

    def map_table(self, t: MTable) -> MTable:
        for m in self.mappers:
            t = m.map_table(t)
        return t

    def map_row(self, row, input_schema: TableSchema):
        t = MTable.from_rows([row], input_schema)
        return self.map_table(t).get_row(0)


class BlockKernelMapper(Mapper, HasReservedCols):
    """Row-wise numeric mapper defined entirely by a torch block kernel.

    Single-op execution and fused-chain execution share ONE code path
    (:func:`run_kernel_chain`), so a fused run of N such mappers is
    bit-identical to node-by-node execution: the same elementwise ops on the
    same float32 columns, only the host↔device copies between nodes
    disappear. Implement :meth:`kernel`; the kernel runs on the mapper's
    ``device`` (set by the operator from its session)."""

    device = None

    def kernel(self, input_schema: TableSchema):
        """Return (in_cols, out_cols, out_types, fn) — see Mapper.block_kernel."""
        raise NotImplementedError

    def block_kernel(self, input_schema: TableSchema):
        return self.kernel(input_schema)

    def output_schema(self, input_schema: TableSchema) -> TableSchema:
        _, out_cols, out_types, _ = self.kernel(input_schema)
        return self._append_result_schema(input_schema, list(out_cols),
                                          list(out_types))

    def map_table(self, t: MTable) -> MTable:
        return run_kernel_chain(t, [(self, self.kernel(t.schema))])


def _chain_cache_key(specs) -> tuple:
    """Content key for a kernel chain: each kernel by code + captured config
    (two chains built from the same mapper classes with the same params key
    equal; numpy captures are digested, so a swapped model array changes the
    key). Kernels that capture state the key machinery cannot content-hash
    (tensors, ``self``) fall back to a per-mapper instance token."""
    from ..common.jitcache import Unkeyable, fn_content_key, instance_token

    parts = []
    for m, (in_cols, out_cols, out_types, fn) in specs:
        try:
            fkey = fn_content_key(fn)
        except Unkeyable:
            fkey = ("tok", instance_token(m))
        parts.append((type(m).__qualname__, fkey, tuple(in_cols),
                      tuple(out_cols), tuple(out_types)))
    return tuple(parts)


# chain key -> the kernel id its batch shapes are recorded under
# (jitcache.note_signature); bounded, as the reference's program cache is
_CHAIN_IDS: Dict[tuple, str] = {}
_CHAIN_IDS_MAX = 512
_chain_lock = threading.Lock()
_chain_seq = itertools.count(1)


def _chain_kernel_id(key: tuple) -> str:
    with _chain_lock:
        kid = _CHAIN_IDS.get(key)
        if kid is None:
            if len(_CHAIN_IDS) >= _CHAIN_IDS_MAX:
                _CHAIN_IDS.clear()
            kid = f"mapper.kernel_chain.{next(_chain_seq)}"
            _CHAIN_IDS[key] = kid
        return kid


def run_kernel_chain(t: MTable, specs) -> MTable:
    """Execute ``specs`` — [(mapper, (in_cols, out_cols, out_types, fn))] —
    as one torch program over one staged input block: stage the union of
    required source columns once, thread columns between kernels on the
    device, fetch the surviving outputs in a single device→host copy. The
    block rows are padded up ``bucket_rows`` and the padded shape is
    recorded through ``note_signature``; kernels are row-wise by the
    ``block_kernel`` contract, so the sliced result is bit-identical to the
    unpadded run. The device is the first mapper's ``device``."""
    import torch

    from ..common.env import resolve_device
    from ..common.jitcache import bucket_rows, note_signature, pad_rows

    host_needed: List[str] = []
    produced: set = set()
    for _, (in_cols, out_cols, _, _) in specs:
        for c in in_cols:
            if c not in produced and c not in host_needed:
                host_needed.append(c)
        produced.update(out_cols)

    # final schema = the same output_schema fold node-by-node execution does
    schema = t.schema
    out_types_by_col: Dict[str, str] = {}
    for m, (_, out_cols, out_types, _) in specs:
        schema = m.output_schema(schema)
        out_types_by_col.update(dict(zip(out_cols, out_types)))
    final_produced = [n for n in schema.names if n in produced]

    n = t.num_rows
    if host_needed:
        block = t.to_numeric_block(host_needed, dtype=np.float32)
    else:
        block = np.zeros((n, 0), np.float32)
    if n == 0 or not final_produced:
        out_block = np.zeros((n, len(final_produced)), np.float32)
    else:
        dev = resolve_device(getattr(specs[0][0], "device", None))
        padded = pad_rows(block, bucket_rows(n))
        if not (padded.flags.writeable and padded.flags.c_contiguous):
            padded = np.array(padded)
        note_signature(_chain_kernel_id(
            (_chain_cache_key(specs), tuple(host_needed),
             tuple(final_produced))), [padded])
        with torch.inference_mode():
            B = torch.from_numpy(padded).to(dev)
            colmap = {c: B[:, i] for i, c in enumerate(host_needed)}
            for _, (in_cols, out_cols, out_types, fn) in specs:
                Y = fn(torch.stack([colmap[c] for c in in_cols], dim=1))
                for j, c in enumerate(out_cols):
                    v = Y[:, j]
                    # node-by-node execution truncates LONG/INT outputs to
                    # int64 on the host between nodes; replay that on the
                    # device so fused and unfused runs stay bit-identical
                    if out_types[j] in (AlinkTypes.LONG, AlinkTypes.INT):
                        v = torch.trunc(v)
                    colmap[c] = v
            out_block = torch.stack([colmap[c] for c in final_produced],
                                    dim=1).cpu().numpy()[:n]

    cols: Dict[str, Any] = {}
    for name in schema.names:
        if name in produced:
            vals = out_block[:, final_produced.index(name)]
            tp = out_types_by_col.get(name, AlinkTypes.DOUBLE)
            if tp == AlinkTypes.DOUBLE:
                vals = vals.astype(np.float64)
            elif tp in (AlinkTypes.LONG, AlinkTypes.INT):
                vals = vals.astype(np.int64)
            cols[name] = vals
        else:
            cols[name] = t.col(name)
    return MTable(cols, schema)


class FusedMapperChain(MapperChain):
    """MapperChain that additionally composes consecutive kernel-capable
    mappers (``block_kernel``) into one torch program. Mappers without a
    kernel run via ``map_table`` exactly as in the plain chain, so outputs
    are always bit-identical to node-by-node execution."""

    def map_table(self, t: MTable) -> MTable:
        i = 0
        while i < len(self.mappers):
            m = self.mappers[i]
            spec = m.block_kernel(t.schema)
            if spec is None:
                t = m.map_table(t)
                i += 1
                continue
            run = [(m, spec)]
            schema = m.output_schema(t.schema)
            j = i + 1
            while j < len(self.mappers):
                nxt = self.mappers[j].block_kernel(schema)
                if nxt is None:
                    break
                run.append((self.mappers[j], nxt))
                schema = self.mappers[j].output_schema(schema)
                j += 1
            t = run_kernel_chain(t, run)
            i = j
        return t


def get_feature_block(
    t: MTable,
    params: "Params | WithParams",
    dtype=np.float32,
    vector_size: Optional[int] = None,
    exclude: Optional[Sequence[str]] = None,
) -> np.ndarray:
    """Resolve featureCols / vectorCol params into one dense (n, d) block —
    the shared feature-assembly step of train and predict paths.

    ``exclude`` names columns (label/weight/prediction) that must never enter
    the default all-numeric-columns fallback."""
    p = params.get_params() if isinstance(params, WithParams) else params
    vec_col = p.get(HasVectorCol.VECTOR_COL)
    if vec_col:
        return t.to_numeric_block([vec_col], dtype=dtype, vector_size=vector_size)
    return t.to_numeric_block(
        resolve_feature_cols(t, params, exclude=exclude), dtype=dtype
    )


def default_feature_cols(
    t: "MTable | TableSchema",
    exclude: Optional[Sequence[str]] = None,
    include_vectors: bool = False,
) -> List[str]:
    """Every numeric (and optionally vector) column not in ``exclude`` — the
    shared default-column scan for ops run without explicit featureCols.
    Works on an MTable or a bare TableSchema (static schema derivation)."""
    schema = t if isinstance(t, TableSchema) else t.schema
    drop = set(exclude or ())
    cols = [
        n
        for n, tp in zip(schema.names, schema.types)
        if (
            AlinkTypes.is_numeric(tp)
            or (include_vectors and AlinkTypes.is_vector(tp))
        )
        and n not in drop
    ]
    if not cols:
        raise AkIllegalArgumentException(
            "no featureCols/vectorCol set and no numeric columns found"
        )
    return cols


def resolve_feature_cols(
    t: MTable,
    params: "Params | WithParams",
    exclude: Optional[Sequence[str]] = None,
) -> List[str]:
    """The featureCols actually used: the explicit param, else every numeric
    column not in ``exclude``. Train ops store this resolved list in model meta
    so predict binds to the same columns regardless of the predict table."""
    p = params.get_params() if isinstance(params, WithParams) else params
    feat_cols = p.get(HasFeatureCols.FEATURE_COLS)
    if feat_cols:
        return list(feat_cols)
    return default_feature_cols(t, exclude=exclude)


def merge_feature_params(params: "Params | WithParams", meta: Dict) -> Params:
    """Model-stored feature binding, unless the user explicitly set either
    featureCols or vectorCol on the predict op (explicit settings win whole) —
    the shared predict-side counterpart of resolve_feature_cols."""
    p = (params.get_params() if isinstance(params, WithParams) else params).clone()
    if not p.contains("vectorCol") and not p.contains("featureCols"):
        if meta.get("vectorCol"):
            p.set("vectorCol", meta["vectorCol"])
        elif meta.get("featureCols"):
            p.set("featureCols", meta["featureCols"])
    return p


def np_labels(labels: List, label_type: str, idx: np.ndarray) -> np.ndarray:
    """Decode argmax indices back to typed label values."""
    arr = np.asarray(labels, dtype=object)[idx]
    if label_type in (AlinkTypes.LONG, AlinkTypes.INT):
        return arr.astype(np.int64)
    if label_type in (AlinkTypes.DOUBLE, AlinkTypes.FLOAT):
        return arr.astype(np.float64)
    return arr.astype(str)


def softmax_np(logits: np.ndarray) -> np.ndarray:
    e = np.exp(logits - logits.max(axis=1, keepdims=True))
    return e / e.sum(axis=1, keepdims=True)


def sigmoid_np(s: np.ndarray) -> np.ndarray:
    """Numerically stable sigmoid (no overflow for large |s|)."""
    e = np.exp(-np.abs(s))
    return np.where(s >= 0, 1.0 / (1.0 + e), e / (1.0 + e))


def detail_json(labels: List, probs: np.ndarray) -> np.ndarray:
    """Per-row JSON {label: prob} detail strings (reference: RichModelMapper
    prediction-detail column format)."""
    import json as _json

    return np.asarray(
        [_json.dumps({str(labels[j]): float(pr[j]) for j in range(len(labels))})
         for pr in probs],
        dtype=object,
    )
