"""TF SavedModel → a function of PyTorch ops on the device (port of
``alink_tpu.onnx.tfsaved``; the converter class ``TFGraphToJax`` is
:class:`TFGraphToTorch` here).

Capability parity with the reference's TF predictor plugin (reference:
predictor-tf/src/main/java/.../TFPredictorServiceImpl.java:139 —
SavedModelBundle.load + TF-Java session.run per batch;
operator/batch/tensorflow/TFSavedModelPredictBatchOp.java).

The serving signature is **frozen** (variables → constants) and its GraphDef
runs node by node as PyTorch ops on the device, exactly like the ONNX and
torch.export ingest paths (convert.py, torchfx.py). TensorFlow is needed only
at load time to parse the artifact, and is imported only inside
:func:`_require_tf`; the serving path never touches it. Graphs are NHWC:
convolutions and pools view their tensors channels first (a channels-last
layout in memory, which cuDNN takes as it is) and hand NHWC back.

The supported-op manifest is :func:`supported_tf_ops`; an unsupported graph
raises listing exactly which ops are missing.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..common.env import resolve_device
from ..common.exceptions import (
    AkIllegalArgumentException,
    AkPluginNotExistException,
    AkUnsupportedOperationException,
)
from .convert import (conv_nd, max_pool, promote, same_pads, take,
                      window_counts, window_sum)


def _require_tf():
    try:
        import os

        os.environ.setdefault("TF_CPP_MIN_LOG_LEVEL", "2")
        import tensorflow as tf

        return tf
    except ImportError as e:
        raise AkPluginNotExistException(
            "TFSavedModel ingest needs the 'tensorflow' package at LOAD time "
            "only (the predictor-tf plugin analog). Alternatively export the "
            "model to ONNX (OnnxModelPredictBatchOp) or torch.export "
            "(TorchModelPredictBatchOp).") from e


# -- graph utilities ----------------------------------------------------------


def _ref(name: str) -> Tuple[str, int]:
    """'node:k' → (node, k); bare name is output 0; '^node' is a control
    dependency (callers skip those)."""
    if name.startswith("^"):
        return name[1:], -1
    if ":" in name:
        node, idx = name.rsplit(":", 1)
        return node, int(idx)
    return name, 0


def _topo_order(nodes: Dict[str, Any], out_nodes: Sequence[str]) -> List[str]:
    order: List[str] = []
    seen: Dict[str, int] = {}  # 0 = visiting, 1 = done

    def visit(name: str):
        state = seen.get(name)
        if state == 1:
            return
        if state == 0:
            raise AkIllegalArgumentException(f"graph cycle at '{name}'")
        seen[name] = 0
        node = nodes.get(name)
        if node is None:
            raise AkIllegalArgumentException(f"missing graph node '{name}'")
        for inp in node.input:
            n, idx = _ref(inp)
            if idx >= 0:
                visit(n)
        seen[name] = 1
        order.append(name)

    for name in out_nodes:
        visit(name)
    return order


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


def _tf_pads(padding: bytes, spatial, ks, strides, dils=None):
    """(lo, hi) per spatial dim for TF's SAME (the odd pad at the end) or
    VALID padding."""
    if padding == b"VALID":
        return [(0, 0)] * len(spatial)
    if padding != b"SAME":
        raise AkUnsupportedOperationException(f"padding {padding!r}")
    return same_pads(spatial, ks, strides, dils or [1] * len(spatial), False)


def _nhwc_pool(get, node, avg=False):
    """MaxPool/AvgPool over NHWC with ksize/strides (1, h, w, 1); an average
    counts only the input's cells, as ``reduce_window`` over ones does."""
    x = get(node.input[0])
    ksize = list(node.attr["ksize"].list.i)
    strides = list(node.attr["strides"].list.i)
    if ksize[0] != 1 or ksize[3] != 1 or strides[0] != 1 or strides[3] != 1:
        raise AkUnsupportedOperationException(
            "pools over the batch or channel axis")
    xc = _nchw(x)
    ks, st = ksize[1:3], strides[1:3]
    pads = _tf_pads(node.attr["padding"].s, xc.shape[2:], ks, st)
    if not avg:
        return _nhwc(max_pool(xc, ks, st, pads))
    out = window_sum(xc, ks, st, pads) / window_counts(
        xc, ks, st, pads, [(0, 0), (0, 0)])
    return _nhwc(out)


# one callable per op: (get, node, const_of) -> value.  `get` resolves an
# input tensor name to a device tensor; `const_of` resolves one to a static
# numpy array (for shape/axis operands that must be known on the host).
@functools.lru_cache(maxsize=1)
def _build_op_table():
    def unary(fn):
        return lambda get, node, const: fn(get(node.input[0]))

    def binary(fn):
        return lambda get, node, const: fn(*promote(get(node.input[0]),
                                                    get(node.input[1])))

    def reduce_op(fn):
        def run(get, node, const):
            x = get(node.input[0])
            axes = const(node.input[1]).reshape(-1).astype(int).tolist()
            keep = bool(node.attr["keep_dims"].b)
            return fn(x, dim=tuple(axes), keepdim=keep)

        return run

    def prod(x, dim, keepdim):
        for d in sorted((d % x.ndim for d in dim), reverse=True):
            x = x.prod(dim=d, keepdim=keepdim)
        return x

    def matmul(get, node, const):
        a, b = promote(get(node.input[0]), get(node.input[1]))
        if node.attr["transpose_a"].b:
            a = a.T
        if node.attr["transpose_b"].b:
            b = b.T
        return a @ b

    def batch_matmul(get, node, const):
        a, b = promote(get(node.input[0]), get(node.input[1]))
        if node.attr["adj_x"].b:
            a = a.transpose(-1, -2)
        if node.attr["adj_y"].b:
            b = b.transpose(-1, -2)
        return torch.matmul(a, b)

    def bias_add(get, node, const):
        x, b = get(node.input[0]), get(node.input[1])
        if node.attr["data_format"].s == b"NCHW":
            return x + b.reshape((1, -1) + (1,) * (x.ndim - 2))
        return x + b

    def conv2d(get, node, const):
        x, w = promote(get(node.input[0]), get(node.input[1]))
        if node.attr["data_format"].s == b"NCHW":
            raise AkUnsupportedOperationException(
                "Conv2D NCHW data_format not supported (SavedModels are "
                "NHWC by default)")
        strides = list(node.attr["strides"].list.i)[1:3]
        dil = list(node.attr["dilations"].list.i)
        dil = dil[1:3] if dil else [1, 1]
        xc, wc = _nchw(x), w.permute(3, 2, 0, 1)      # HWIO -> OIHW
        pad = node.attr["padding"].s
        if pad == b"EXPLICIT":
            ep = list(node.attr["explicit_paddings"].list.i)
            pads = [(ep[2], ep[3]), (ep[4], ep[5])]
        else:
            pads = _tf_pads(pad, xc.shape[2:], wc.shape[2:], strides, dil)
        return _nhwc(conv_nd(xc, wc, strides, pads, dil, 1))

    def depthwise_conv(get, node, const):
        x, w = promote(get(node.input[0]), get(node.input[1]))
        strides = list(node.attr["strides"].list.i)[1:3]
        h, w_, cin, mult = w.shape
        wc = w.reshape(h, w_, 1, cin * mult).permute(3, 2, 0, 1)
        xc = _nchw(x)
        pads = _tf_pads(node.attr["padding"].s, xc.shape[2:], [h, w_],
                        strides)
        return _nhwc(conv_nd(xc, wc, strides, pads, [1, 1], cin))

    def fused_bn(get, node, const):
        x = get(node.input[0])
        scale, offset = get(node.input[1]), get(node.input[2])
        mean, var = get(node.input[3]), get(node.input[4])
        eps = node.attr["epsilon"].f
        inv = scale * torch.rsqrt(var + eps)
        return x * inv + (offset - mean * inv)

    def reshape(get, node, const):
        shape = const(node.input[1]).reshape(-1).astype(int).tolist()
        return get(node.input[0]).reshape(shape)

    def strided_slice(get, node, const):
        from .convert import slice_dims

        x = get(node.input[0])
        begin = const(node.input[1]).reshape(-1).astype(int)
        end = const(node.input[2]).reshape(-1).astype(int)
        strides = const(node.input[3]).reshape(-1).astype(int)
        bm = node.attr["begin_mask"].i
        em = node.attr["end_mask"].i
        sm = node.attr["shrink_axis_mask"].i
        nm = node.attr["new_axis_mask"].i
        elm = node.attr["ellipsis_mask"].i
        if nm or elm:
            raise AkUnsupportedOperationException(
                "StridedSlice new_axis/ellipsis masks not supported")
        sl, shrink = [], []
        for d in range(len(begin)):
            if sm & (1 << d):
                b = int(begin[d])
                sl.append(slice(b, b + 1 if b != -1 else None, 1))
                shrink.append(d)
                continue
            b = None if bm & (1 << d) else int(begin[d])
            e = None if em & (1 << d) else int(end[d])
            sl.append(slice(b, e, int(strides[d])))
        sl += [slice(None)] * (x.ndim - len(sl))
        out = slice_dims(x, sl)
        return out.squeeze(tuple(shrink)) if shrink else out

    def tf_split(get, node, const):
        axis = int(const(node.input[0]))
        x = get(node.input[1])
        num = node.attr["num_split"].i
        return tuple(torch.tensor_split(x, num, dim=axis))

    def tf_cast(get, node, const):
        dst = node.attr["DstT"].type
        dtype = _TF_DTYPE.get(dst)
        if dtype is None:
            raise AkUnsupportedOperationException(f"Cast to dtype {dst}")
        return get(node.input[0]).to(dtype)

    def tf_pad(get, node, const):
        pads = const(node.input[1]).astype(int).tolist()
        value = float(const(node.input[2])) if node.op == "PadV2" else 0.0
        flat: List[int] = []
        for lo, hi in reversed(pads):
            flat += [lo, hi]
        return F.pad(get(node.input[0]), flat, value=value)

    def where(get, node, const):
        a, b = promote(get(node.input[1]), get(node.input[2]))
        return torch.where(get(node.input[0]).to(torch.bool), a, b)

    table: Dict[str, Callable] = {
        "Identity": unary(lambda x: x),
        "StopGradient": unary(lambda x: x),
        "PreventGradient": unary(lambda x: x),
        "Relu": unary(torch.relu),
        "Relu6": unary(lambda x: torch.clamp(x, 0, 6)),
        "LeakyRelu": lambda get, node, const: F.leaky_relu(
            get(node.input[0]), node.attr["alpha"].f),
        "Elu": unary(F.elu),
        "Selu": unary(F.selu),
        "Softplus": unary(lambda x: torch.logaddexp(x, torch.zeros_like(x))),
        "Sigmoid": unary(torch.sigmoid),
        "Tanh": unary(torch.tanh),
        "Softmax": unary(lambda x: torch.softmax(x, dim=-1)),
        "LogSoftmax": unary(lambda x: torch.log_softmax(x, dim=-1)),
        "Erf": unary(torch.erf),
        "Exp": unary(torch.exp),
        "Log": unary(torch.log),
        "Log1p": unary(torch.log1p),
        "Sqrt": unary(torch.sqrt),
        "Rsqrt": unary(torch.rsqrt),
        "Square": unary(torch.square),
        "Neg": unary(torch.neg),
        "Abs": unary(torch.abs),
        "Floor": unary(torch.floor),
        "Ceil": unary(torch.ceil),
        "Round": unary(torch.round),
        "Add": binary(torch.add),
        "AddV2": binary(torch.add),
        "Sub": binary(torch.sub),
        "Mul": binary(torch.mul),
        "RealDiv": binary(torch.true_divide),
        "Div": binary(torch.true_divide),
        "FloorDiv": binary(torch.floor_divide),
        "Maximum": binary(torch.maximum),
        "Minimum": binary(torch.minimum),
        "Pow": binary(torch.pow),
        "SquaredDifference": binary(lambda a, b: torch.square(a - b)),
        "Greater": binary(torch.gt),
        "GreaterEqual": binary(torch.ge),
        "Less": binary(torch.lt),
        "LessEqual": binary(torch.le),
        "Equal": binary(torch.eq),
        "NotEqual": binary(torch.ne),
        "LogicalAnd": binary(torch.logical_and),
        "LogicalOr": binary(torch.logical_or),
        "LogicalNot": unary(torch.logical_not),
        "Select": where,
        "SelectV2": where,
        "MatMul": matmul,
        "BatchMatMulV2": batch_matmul,
        "BatchMatMul": batch_matmul,
        "BiasAdd": bias_add,
        "Conv2D": conv2d,
        "DepthwiseConv2dNative": depthwise_conv,
        "FusedBatchNormV3": fused_bn,
        "FusedBatchNorm": fused_bn,
        "MaxPool": lambda get, node, const: _nhwc_pool(get, node),
        "AvgPool": lambda get, node, const: _nhwc_pool(get, node, avg=True),
        "Mean": reduce_op(torch.mean),
        "Sum": reduce_op(torch.sum),
        "Max": reduce_op(torch.amax),
        "Min": reduce_op(torch.amin),
        "Prod": reduce_op(prod),
        "Any": reduce_op(torch.any),
        "All": reduce_op(torch.all),
        "ArgMax": lambda get, node, const: torch.argmax(
            get(node.input[0]), dim=int(const(node.input[1]))),
        "ArgMin": lambda get, node, const: torch.argmin(
            get(node.input[0]), dim=int(const(node.input[1]))),
        "Reshape": reshape,
        "Squeeze": lambda get, node, const: (
            get(node.input[0]).squeeze(tuple(node.attr["squeeze_dims"].list.i))
            if node.attr["squeeze_dims"].list.i
            else get(node.input[0]).squeeze()),
        "ExpandDims": lambda get, node, const: get(node.input[0]).unsqueeze(
            int(const(node.input[1]))),
        "Transpose": lambda get, node, const: get(node.input[0]).permute(
            *const(node.input[1]).reshape(-1).astype(int).tolist()),
        "ConcatV2": lambda get, node, const: torch.cat(
            promote(*[get(i) for i in node.input[:-1]]),
            dim=int(const(node.input[-1]))),
        "Pack": lambda get, node, const: torch.stack(
            promote(*[get(i) for i in node.input]), dim=node.attr["axis"].i),
        "Unpack": lambda get, node, const: tuple(
            torch.movedim(get(node.input[0]), node.attr["axis"].i, 0)),
        "Split": tf_split,
        "Pad": tf_pad,
        "PadV2": tf_pad,
        "GatherV2": lambda get, node, const: take(
            get(node.input[0]), get(node.input[1]),
            int(const(node.input[2]))),
        "Tile": lambda get, node, const: get(node.input[0]).tile(
            tuple(const(node.input[1]).reshape(-1).astype(int).tolist())),
        "StridedSlice": strided_slice,
        "Cast": tf_cast,
        "Shape": lambda get, node, const: torch.tensor(
            tuple(get(node.input[0]).shape), dtype=torch.int32,
            device=get(node.input[0]).device),
        "Fill": lambda get, node, const: torch.broadcast_to(
            get(node.input[1]),
            tuple(const(node.input[0]).reshape(-1).astype(int).tolist())),
        "Rank": lambda get, node, const: torch.tensor(
            get(node.input[0]).ndim, dtype=torch.int32),
        "ZerosLike": unary(torch.zeros_like),
        "OnesLike": unary(torch.ones_like),
    }
    return table


# the reference's map: TF dtype enum -> dtype (bf16 -> f16 there too)
_TF_DTYPE = {
    1: torch.float32, 2: torch.float32, 3: torch.int32, 4: torch.uint8,
    6: torch.int8, 9: torch.int64, 10: torch.bool, 14: torch.float16,
    19: torch.float16,
}


class TFGraphToTorch:
    """Run a frozen ConcreteFunction's GraphDef as PyTorch ops on
    ``device``. Float constants (the frozen weights) are device tensors of
    the policy dtype, moved once; every constant also stays a host array
    for the operands that must be static (shapes, axes, paddings)."""

    def __init__(self, frozen_fn, tf=None, dtype=None, device=None):
        from .precision import as_tensor, resolve_dtype

        self._tf = tf or _require_tf()
        self.dtype = resolve_dtype(dtype)
        self.device = resolve_device(device)
        self.frozen = frozen_fn
        gd = frozen_fn.graph.as_graph_def()
        self.nodes = {n.name: n for n in gd.node}
        self.input_refs = [_ref(t.name) for t in frozen_fn.inputs]
        self.output_refs = [_ref(t.name) for t in frozen_fn.outputs]
        self.consts: Dict[str, np.ndarray] = {}
        for n in gd.node:
            if n.op == "Const":
                self.consts[n.name] = np.asarray(
                    self._tf.make_ndarray(n.attr["value"].tensor))
        self.dev_consts = {
            k: as_tensor(v.astype(np.float32) if v.dtype == np.float64
                         else v, self.device, self.dtype)
            for k, v in self.consts.items()
            if v.dtype != object}
        missing = sorted({
            n.op for n in gd.node
            if n.op not in _build_op_table()
            and n.op not in ("Const", "Placeholder", "NoOp")})
        if missing:
            raise AkUnsupportedOperationException(
                f"SavedModel graph uses unsupported TF ops {missing}; "
                f"supported: {list(supported_tf_ops())}")
        self._order = _topo_order(
            self.nodes, [n for n, _ in self.output_refs])

    def function(self) -> Callable:
        """A function of the graph's placeholder inputs (positional,
        frozen-input order, device tensors) returning the flat output
        list."""
        table = _build_op_table()
        nodes, consts, dev_consts = self.nodes, self.consts, self.dev_consts
        order = self._order
        input_names = [n for n, _ in self.input_refs]
        output_refs = self.output_refs

        def const_of(ref_name: str) -> np.ndarray:
            node_name, idx = _ref(ref_name)
            if node_name in consts and idx == 0:
                return consts[node_name]
            raise AkUnsupportedOperationException(
                f"operand '{ref_name}' must be a graph constant (dynamic "
                "shapes/axes are not supported)")

        def fn(*args):
            env: Dict[Tuple[str, int], Any] = {}
            for name, arg in zip(input_names, args):
                env[(name, 0)] = arg

            def get(ref_name: str):
                node_name, idx = _ref(ref_name)
                if (node_name, idx) in env:
                    return env[(node_name, idx)]
                if node_name in dev_consts:
                    return dev_consts[node_name]
                raise AkIllegalArgumentException(
                    f"unresolved tensor '{ref_name}'")

            for name in order:
                node = nodes[name]
                if node.op in ("Const", "Placeholder", "NoOp"):
                    continue
                out = table[node.op](get, node, const_of)
                if isinstance(out, tuple):
                    for i, o in enumerate(out):
                        env[(name, i)] = o
                else:
                    env[(name, 0)] = out
            return [get(f"{n}:{i}" if i else n) for n, i in output_refs]

        return fn


def load_saved_model_fn(path: str, signature: str = "serving_default",
                        dtype=None, device=None):
    """SavedModel → (served fn, input names, [(out name, per-row shape)]).

    The signature's variables freeze into constants and the GraphDef runs
    through :class:`TFGraphToTorch` — TF is not in the serving path.
    ``dtype="bfloat16"`` applies the serving policy (weights and inputs
    bf16, outputs fp32); the default is the pinned fp32 path."""
    tf = _require_tf()
    from tensorflow.python.framework.convert_to_constants import (
        convert_variables_to_constants_v2,
    )

    from .convert import device_inputs
    from .precision import wrap_positional

    loaded = tf.saved_model.load(path)
    sigs = dict(loaded.signatures)
    if not sigs:
        raise AkIllegalArgumentException(
            f"SavedModel at {path} has no serving signatures")
    if signature not in sigs:
        # only the implicit default may fall back, and only unambiguously —
        # an explicit typo must not silently serve a different signature
        if signature == "serving_default" and len(sigs) == 1:
            signature = next(iter(sigs))
        else:
            raise AkIllegalArgumentException(
                f"signature '{signature}' not in SavedModel; available: "
                f"{sorted(sigs)}")
    sig = sigs[signature]
    frozen = convert_variables_to_constants_v2(sig)
    conv = TFGraphToTorch(frozen, tf=tf, dtype=dtype, device=device)
    policy_fn = wrap_positional(conv.function(), conv.dtype)
    dev = conv.device

    def served(*args):
        return policy_fn(*device_inputs(dict(enumerate(args)), dev).values())

    in_names = [t.name.split(":")[0] for t in frozen.inputs]
    # flat output order ↔ structured output names (TF flattens dicts sorted
    # by key)
    structured = sig.structured_outputs
    if isinstance(structured, dict):
        out_names = sorted(structured.keys())
        out_specs = [structured[k] for k in out_names]
    else:
        out_names = [f"output_{i}" for i in range(len(frozen.outputs))]
        out_specs = list(frozen.outputs)
    out_info = []
    for name, spec in zip(out_names, out_specs):
        shape = None
        dims = getattr(spec, "shape", None)
        if dims is not None and dims.rank is not None:
            tail = [int(d) if d is not None else None
                    for d in dims.as_list()[1:]]
            shape = None if any(d is None for d in tail) else tuple(tail)
        out_info.append((name, shape))
    return served, in_names, out_info


def supported_tf_ops() -> Tuple[str, ...]:
    """The published conformance manifest: every GraphDef op the converter
    understands (plus the structural Const/Placeholder/NoOp)."""
    return tuple(sorted(
        list(_build_op_table().keys()) + ["Const", "Placeholder", "NoOp"]))
