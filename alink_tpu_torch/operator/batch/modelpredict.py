"""Foreign-model predict operators: ONNX / torch.export / TF SavedModel (port
of ``alink_tpu.operator.batch.modelpredict``).

Capability parity with the reference's DL predictor ops (reference:
operator/batch/onnx/OnnxModelPredictBatchOp.java,
operator/batch/pytorch/TorchModelPredictBatchOp.java,
operator/batch/tensorflow/TFSavedModelPredictBatchOp.java — all routed through
the DLPredictorService plugin SPI, core/.../common/dl/plugin/).

The model file is imported once at mapper-open time (see
``alink_tpu_torch.onnx``) and its graph runs as PyTorch ops on the card.
Tables go in fixed ``predictBatchSize`` batches, the tail padded by repeating
the last row; host batches reach the card through
:func:`~alink_tpu_torch.common.streaming.stream_map` (pinned buffers, copies
on a side stream) with at most ``PIPELINE_DEPTH`` executions in flight, and
``FETCH_GROUP`` batches' outputs are trimmed and concatenated on the card and
fetched in one copy.

Inputs cross to the card uncached, as fp32 (or the graph's own input dtypes
for torch.export), and are cast there according to the precision policy. The
reference's ``_wire_cache_mode`` (the content-keyed staging cache on slow
wires) has no counterpart: the port has no such cache or wire probe.

StableHLO is a difference by design: ``StableHloModelPredictBatchOp`` and its
stream twin consume ``jax.export`` artifacts, which only XLA runs, so in the
port they raise and point to ``torch.export`` ``.pt2`` files served through
``TorchModelPredictBatchOp``; ``export_stablehlo`` is not ported.

SavedModel note: TensorFlow is needed only at LOAD time to parse the artifact
(``onnx/tfsaved.py``); the batches run on the card without it.
"""

from __future__ import annotations

from collections import deque
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ...common.env import resolve_device
from ...common.exceptions import (
    AkIllegalArgumentException,
    AkUnsupportedOperationException,
)
from ...common.mtable import AlinkTypes, MTable, TableSchema
from ...common.params import InValidator, ParamInfo
from ...mapper import HasReservedCols, HasSelectedCols, Mapper
from .utils import MapBatchOp


class HasIngestParams(HasSelectedCols, HasReservedCols):
    MODEL_PATH = ParamInfo("modelPath", str, optional=False)
    INPUT_NAMES = ParamInfo(
        "inputNames", list,
        desc="table columns bound to the graph inputs, in graph-input order; "
        "default: selectedCols stacked into the first input",
    )
    OUTPUT_COLS = ParamInfo(
        "outputCols", list, desc="output column names; default: graph outputs"
    )
    PREDICT_BATCH_SIZE = ParamInfo(
        "predictBatchSize", int, default=256,
        desc="fixed device batch (tail is padded) so every batch has one "
        "shape for any table size",
    )
    PRECISION = ParamInfo(
        "precision", str, default="float32",
        validator=InValidator("float32", "bfloat16"),
        desc="compute precision for the ingested model: float32 (numerics "
        "parity: fp32 products without TF32) or bfloat16 (half the memory "
        "traffic, tensor-core products; outputs return fp32). Implemented "
        "for the torch, ONNX and SavedModel ingests",
    )


def _done(device):
    """An event at the end of the work issued so far (None on the CPU)."""
    if device.type != "cuda":
        return None
    import torch

    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(device))
    return ev


def _host(t) -> np.ndarray:
    # numpy has no bfloat16: a bf16 output comes back as its fp32 value
    import torch

    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


class _BaseIngestMapper(Mapper):
    """Shared ingest mapper: bind columns → run the converted graph in fixed
    batches on the device → append output columns."""

    def __init__(self, data_schema=None, params=None, **kw):
        super().__init__(data_schema, params, **kw)
        self._fn = None
        self._in_names: List[str] = []
        self._out_info: List[Tuple[str, Optional[Tuple[int, ...]]]] = []
        # torch device the graph runs on; None = the port's default
        # (common/env.resolve_device)
        self.device = None

    # -- per-format hooks ---------------------------------------------------
    def _load(self, path: str):
        """Set self._fn (callable taking positional per-input device tensors
        and returning a list of output tensors), self._in_names,
        self._out_info [(name, per-row shape or None)]."""
        raise NotImplementedError

    # formats that honor precision="bfloat16"; others must raise rather
    # than silently serving fp32 under a bf16-labelled op
    _supports_bf16 = False

    def _ingest_dtype(self):
        """precision param -> converter dtype (None = fp32 parity path)."""
        prec = self.get(HasIngestParams.PRECISION)
        return None if prec == "float32" else prec

    # -- shared machinery ---------------------------------------------------
    def _ensure_loaded(self):
        if self._fn is None:
            if (self.get(HasIngestParams.PRECISION) != "float32"
                    and not self._supports_bf16):
                raise AkUnsupportedOperationException(
                    f"{type(self).__name__} does not implement the bfloat16 "
                    f"serving policy (torch/ONNX/SavedModel do); "
                    f"remove precision or use one of those paths")
            self.device = resolve_device(self.device)
            self._load(self.get(HasIngestParams.MODEL_PATH))

    def _bind_inputs(self, t: MTable) -> List[np.ndarray]:
        cols = self.get(HasIngestParams.INPUT_NAMES)
        if cols:
            return [_stack_column(t, c) for c in cols]
        sel = self.get(HasSelectedCols.SELECTED_COLS)
        if sel:
            if len(sel) == 1 and t.schema.type_of(sel[0]) in (
                AlinkTypes.TENSOR, AlinkTypes.DENSE_VECTOR,
                AlinkTypes.SPARSE_VECTOR, AlinkTypes.VECTOR,
            ):
                return [_stack_column(t, sel[0])]
            return [t.to_numeric_block(list(sel), dtype=np.float32)]
        raise AkIllegalArgumentException(
            "set selectedCols (feature/tensor columns) or inputNames"
        )

    def _out_names(self) -> List[str]:
        names = self.get(HasIngestParams.OUTPUT_COLS)
        if names:
            if len(names) != len(self._out_info):
                raise AkIllegalArgumentException(
                    f"outputCols has {len(names)} names but the model has "
                    f"{len(self._out_info)} outputs"
                )
            return list(names)
        return [n.rsplit("/", 1)[-1].replace(":", "_")
                for n, _ in self._out_info]

    def output_schema(self, input_schema: TableSchema) -> TableSchema:
        self._ensure_loaded()
        names, types = [], []
        for out_col, (gname, shape) in zip(self._out_names(), self._out_info):
            names.append(out_col)
            types.append(_col_type_for(shape))
        return self._append_result_schema(input_schema, names, types)

    # bounded dispatch-ahead: the host->device copy of batch i+1 runs on the
    # transfer thread's side stream (common/streaming.py) while the card
    # computes batch i, and at most PIPELINE_DEPTH executions are in flight
    PIPELINE_DEPTH = 3

    def _iter_batches(self, t: MTable):
        """Yield (valid_rows, padded fixed-size input chunk) — the single
        place batching/tail-padding happens for both serving paths."""
        n = t.num_rows
        bs = self.get(HasIngestParams.PREDICT_BATCH_SIZE)
        if n == 0:
            return
        inputs = self._bind_inputs(t)
        for s in range(0, n, bs):
            chunk = [a[s:s + bs] for a in inputs]
            m = chunk[0].shape[0]
            if m < bs:
                # pad the tail (and short tables) so every batch has the
                # same shape
                chunk = [
                    np.concatenate([c, np.repeat(c[-1:], bs - m, axis=0)])
                    for c in chunk
                ]
            yield m, chunk

    def _batches(self, t: MTable):
        """``stream_map`` of the graph over the table's batches, yielding
        (valid_rows, [device outputs]) with at most PIPELINE_DEPTH
        executions in flight (bounds the device buffers a long table
        holds)."""
        from ...common.streaming import stream_map

        inflight: deque = deque()
        for m, res in stream_map(self._fn, self._iter_batches(t),
                                 depth=self.PIPELINE_DEPTH,
                                 device=self.device):
            inflight.append(_done(self.device))
            if len(inflight) >= self.PIPELINE_DEPTH:
                ev = inflight.popleft()
                if ev is not None:
                    ev.synchronize()
            yield m, res

    # async two-phase protocol used by MapStreamOp to overlap micro-batches
    def dispatch_table(self, t: MTable):
        self._ensure_loaded()
        return t, list(self._batches(t))

    def finalize_table(self, handle) -> MTable:
        t, pending = handle
        outs: List[List[np.ndarray]] = [[] for _ in self._out_info]
        for m, res in pending:
            for i, r in enumerate(res):
                outs[i].append(_host(r[:m]))
        return self._build_result(t, outs)

    # batches whose outputs are concatenated ON DEVICE and fetched as one
    # host transfer — each device->host copy is a sync with a fixed cost, so
    # fetch rarely, fetch big
    FETCH_GROUP = 16

    def map_table(self, t: MTable) -> MTable:
        import torch

        self._ensure_loaded()
        outs: List[List[np.ndarray]] = [[] for _ in self._out_info]
        group: List[Tuple[int, list]] = []

        def flush_group():
            if not group:
                return
            for i in range(len(self._out_info)):
                parts = [res[i][:m] for m, res in group]  # on-device trim
                outs[i].append(_host(parts[0] if len(parts) == 1
                                     else torch.cat(parts, dim=0)))
            group.clear()

        for m, res in self._batches(t):
            group.append((m, res))
            if len(group) >= self.FETCH_GROUP:
                flush_group()
        flush_group()
        return self._build_result(t, outs)

    def _build_result(self, t: MTable, outs) -> MTable:
        n = t.num_rows
        out_cols: Dict[str, Any] = {}
        out_types: Dict[str, str] = {}
        for (gname, shape), col_name, parts in zip(
            self._out_info, self._out_names(), outs
        ):
            # the column type is decided by the DECLARED per-row shape — the
            # same rule output_schema uses — so runtime always matches the
            # static schema (unknown shapes stay TENSOR even for scalars)
            col_type = _col_type_for(shape)
            arr = np.concatenate(parts, axis=0) if parts else None
            if col_type == AlinkTypes.DOUBLE:
                if arr is None:
                    vals: Any = np.zeros(0, np.float64)
                else:
                    vals = arr.reshape(n).astype(np.float64)
                out_cols[col_name] = vals
            else:
                out_cols[col_name] = (
                    [] if arr is None else [row for row in arr]
                )
            out_types[col_name] = col_type
        return self._append_result(t, out_cols, out_types)


def _stack_column(t: MTable, name: str) -> np.ndarray:
    tp = t.schema.type_of(name)
    if AlinkTypes.is_numeric(tp):
        return np.asarray(t.col(name), np.float32)[:, None]
    vals = t.col(name)
    from ...common.linalg import DenseVector, SparseVector

    rows = []
    for v in vals:
        if isinstance(v, DenseVector):
            rows.append(np.asarray(v.data, np.float32))
        elif isinstance(v, SparseVector):
            rows.append(np.asarray(v.to_dense().data, np.float32))
        else:
            rows.append(np.asarray(v))
    out = np.stack(rows)
    if out.dtype == object:  # object sub-arrays keep the object dtype
        out = np.stack([np.asarray(r, np.float32) for r in rows])
    return out


def _col_type_for(shape: Optional[Tuple[int, ...]]) -> str:
    """Per-row output shape → column type: scalar rows ((), (1,)) become
    DOUBLE; everything else (incl. unknown shapes) stays TENSOR."""
    if shape in ((), (1,)):
        return AlinkTypes.DOUBLE
    return AlinkTypes.TENSOR


class OnnxModelMapper(_BaseIngestMapper, HasIngestParams):
    """(reference: operator/common/onnx/OnnxModelPredictMapper +
    predictor-onnx OnnxJavaPredictor.java:36)"""

    _supports_bf16 = True

    def _load(self, path: str):
        from ...onnx import OnnxModel, OnnxToTorch

        conv = OnnxToTorch(OnnxModel.load(path), dtype=self._ingest_dtype(),
                           device=self.device)
        served = conv.served()
        self._in_names = conv.input_names
        self._out_info = []
        for vi in conv.model.graph.outputs:
            shape = tuple(d for d in vi.shape[1:]) if vi.shape else None
            if shape is not None and any(d is None for d in shape):
                shape = None
            self._out_info.append((vi.name, shape))
        names = conv.input_names
        out_names = conv.output_names

        def fn(*arrays):
            res = served(**dict(zip(names, arrays)))
            return [res[n] for n in out_names]

        self._fn = fn


class TorchModelMapper(_BaseIngestMapper, HasIngestParams):
    """(reference: operator/common/pytorch/TorchModelPredictMapper +
    predictor-torch TorchJavaPredictor.java:29-33)"""

    _supports_bf16 = True

    def _load(self, path: str):
        from ...onnx import load_torch_fn

        served, conv = load_torch_fn(path, dtype=self._ingest_dtype(),
                                     device=self.device)
        self._in_names = list(conv.user_inputs)
        out_info = []
        # output shapes from the exported graph's fake tensors
        out_node = list(conv.ep.graph.nodes)[-1]
        for i, o in enumerate(out_node.args[0]):
            shape = None
            val = getattr(o, "meta", {}).get("val") if o is not None else None
            if val is not None and hasattr(val, "shape"):
                shape = tuple(int(d) for d in val.shape[1:])
            out_info.append((f"output_{i}", shape))
        self._out_info = out_info
        self._fn = _wrap_device_cast(served, _torch_input_dtypes(conv))


def _torch_input_dtypes(conv) -> List[Optional[str]]:
    """Graph-input dtypes from the exported program's fake tensors, so table
    columns ship in their native dtype (uint8 images are 4x smaller on the
    wire than fp32) and are cast on the device."""
    metas = {}
    for node in conv.ep.graph.nodes:
        if node.op == "placeholder":
            val = node.meta.get("val")
            if val is not None and hasattr(val, "dtype"):
                metas[node.name] = str(val.dtype).replace("torch.", "")
            if node.target not in metas and val is not None and hasattr(
                    val, "dtype"):
                metas[node.target] = str(val.dtype).replace("torch.", "")
    return [metas.get(n) for n in conv.user_inputs]


def _wrap_device_cast(fn, dtypes: Sequence[Optional[str]]):
    """Cast inputs to the graph's dtypes ON DEVICE, keeping the
    host->device copy in the caller's dtype."""
    if not any(dtypes):
        return fn
    import torch

    targets = [None if d is None else getattr(torch, d) for d in dtypes]

    def cast(*arrays):
        return fn(*[a if d is None else a.to(d)
                    for a, d in zip(arrays, targets)])

    return cast


class StableHloModelMapper(_BaseIngestMapper, HasIngestParams):
    """Serialized ``jax.export`` artifacts run only on XLA: a difference by
    design in the port, which raises at load and points to ``torch.export``
    ``.pt2`` files served through ``TorchModelPredictBatchOp``."""

    def _load(self, path: str):
        raise AkUnsupportedOperationException(
            f"{path!r}: StableHLO (jax.export) artifacts run only on XLA; "
            "export the model with torch.export and serve the .pt2 file "
            "through TorchModelPredictBatchOp / TorchModelPredictStreamOp")


class OnnxModelPredictBatchOp(MapBatchOp, HasIngestParams):
    """(reference: operator/batch/onnx/OnnxModelPredictBatchOp.java)"""

    mapper_cls = OnnxModelMapper


class TorchModelPredictBatchOp(MapBatchOp, HasIngestParams):
    """(reference: operator/batch/pytorch/TorchModelPredictBatchOp.java)"""

    mapper_cls = TorchModelMapper


class StableHloModelPredictBatchOp(MapBatchOp, HasIngestParams):
    """Raises in the port (see :class:`StableHloModelMapper`)."""

    mapper_cls = StableHloModelMapper


class TFSavedModelMapper(_BaseIngestMapper, HasIngestParams):
    """SavedModel serving signature → PyTorch ops on the device (reference:
    predictor-tf TFPredictorServiceImpl.java:139 SavedModelBundle.load; here
    the frozen GraphDef runs through alink_tpu_torch/onnx/tfsaved.py and the
    TF runtime never runs a batch)."""

    SIGNATURE_DEF_KEY = ParamInfo(
        "signatureDefKey", str, default="serving_default",
        aliases=("signatureDef",))

    _supports_bf16 = True

    def _load(self, path: str):
        from ...onnx.tfsaved import load_saved_model_fn

        served, in_names, out_info = load_saved_model_fn(
            path, self.get(self.SIGNATURE_DEF_KEY),
            dtype=self._ingest_dtype(), device=self.device)
        self._in_names = in_names
        self._out_info = out_info
        self._fn = served


class TFSavedModelPredictBatchOp(MapBatchOp, HasIngestParams):
    """(reference: operator/batch/tensorflow/TFSavedModelPredictBatchOp.java)"""

    mapper_cls = TFSavedModelMapper
    SIGNATURE_DEF_KEY = TFSavedModelMapper.SIGNATURE_DEF_KEY
