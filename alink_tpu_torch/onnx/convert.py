"""ONNX graph → a function of PyTorch ops on the device (port of
``alink_tpu.onnx.convert``; the converter class ``OnnxToJax`` is
:class:`OnnxToTorch` here).

The reference executes ONNX models through ONNX Runtime in the JVM (reference:
dl_predictors/predictor-onnx/.../OnnxJavaPredictor.java:36-60 — OrtSession
run). The port imports the graph and runs every node as PyTorch ops on the
device, node by node: convolutions and products go to cuDNN and cuBLAS, as the
JAX package leaves them to XLA. No Pallas kernel is involved on either side.

Interpreter model: values are either device tensors or *static* numpy arrays
(shapes, axes, integer initializers, constants). Shape-manipulating ops
(Shape/Gather/Concat/...) on static values fold on the host with numpy, as the
reference folds them at trace time, so the shape subgraphs torch exports stay
on the host and never wait for the device. Float initializers are moved to the
device once, at load.

Departures from the reference, each a defect there:

- pools honour ``ceil_mode`` (the reference ignores it and floors the output
  size); the overhang past the input counts in no average's divisor;
- ``MaxPool`` honours ``dilations`` (the reference ignores them).

Torch's convolutions and pools pad symmetrically only, so asymmetric pads
(SAME_UPPER/SAME_LOWER, or explicit ``pads``) go through ``F.pad`` first,
with −inf for max pools.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..common.env import resolve_device
from ..common.exceptions import AkUnsupportedOperationException
from .proto import TENSOR_DTYPES, OnnxModel


def _is_static(v) -> bool:
    return isinstance(v, (np.ndarray, np.generic, int, float, list, tuple))


def _static_ints(v) -> List[int]:
    return [int(x) for x in np.asarray(v).reshape(-1)]


_TORCH_OF_NP = {np.dtype(np.float32): torch.float32,
                np.dtype(np.float64): torch.float64,
                np.dtype(np.float16): torch.float16,
                np.dtype(np.int64): torch.int64,
                np.dtype(np.int32): torch.int32,
                np.dtype(np.int16): torch.int16,
                np.dtype(np.int8): torch.int8,
                np.dtype(np.uint8): torch.uint8,
                np.dtype(np.bool_): torch.bool}


def torch_dtype(np_dtype) -> torch.dtype:
    dt = _TORCH_OF_NP.get(np.dtype(np_dtype))
    if dt is None:
        raise AkUnsupportedOperationException(f"dtype {np_dtype} on the device")
    return dt


def _t(v, dev) -> torch.Tensor:
    """A value as a tensor on ``dev``. Host float64 becomes float32, as JAX
    (64-bit off) canonicalizes the reference's constants."""
    if isinstance(v, torch.Tensor):
        return v
    arr = np.asarray(v)
    if arr.dtype == np.float64:
        arr = arr.astype(np.float32)
    return torch.as_tensor(np.array(arr), device=dev)


def promote(*ts: torch.Tensor) -> List[torch.Tensor]:
    """Tensors cast to one dtype (torch's products take no mixed dtypes;
    JAX promotes them, bf16 with fp32 to fp32)."""
    dt = ts[0].dtype
    for t in ts[1:]:
        dt = torch.promote_types(dt, t.dtype)
    return [t.to(dt) for t in ts]


def device_inputs(inputs: Dict[str, Any], dev) -> Dict[str, Any]:
    return {k: _t(v, dev) for k, v in inputs.items()}


class OnnxToTorch:
    """Compile an OnnxModel into ``fn(**inputs) -> dict[name, tensor]`` on
    ``device`` (default: :func:`~alink_tpu_torch.common.env.resolve_device`).

    ``dtype="bfloat16"`` applies the serving policy: float initializers load
    as bf16, float inputs cast on the device, float outputs return fp32.
    The default is the pinned fp32 path (``precision.pinned_fp32``)."""

    def __init__(self, model: OnnxModel, dtype=None, device=None):
        from .precision import resolve_dtype

        self.dtype = resolve_dtype(dtype)
        self.device = resolve_device(device)
        self.model = model
        self.graph = model.graph
        self.input_names = [
            vi.name for vi in self.graph.inputs
            if vi.name not in self.graph.initializers
        ]
        self.output_names = [vi.name for vi in self.graph.outputs]

    def function(self) -> Callable[..., Dict[str, Any]]:
        """The graph as a plain function of device tensors (no policy)."""
        from .precision import cast_float_state

        _ensure_registered()
        graph = self.graph
        dev = self.device
        inits = cast_float_state(graph.initializers, self.dtype, dev)
        # the values each node is the last reader of (graph outputs are
        # never dropped): a forward holds only the activations still to
        # be read
        last: Dict[str, int] = {}
        for i, node in enumerate(graph.nodes):
            for name in node.inputs:
                last[name] = i
        keep = set(self.output_names) | {""}
        dead: List[List[str]] = [[] for _ in graph.nodes]
        for name, i in last.items():
            if name not in keep:
                dead[i].append(name)

        def run(**inputs):
            env: Dict[str, Any] = {}
            env.update(inits)
            env.update(inputs)
            env[""] = None  # optional (omitted) input slot
            for node, drop in zip(graph.nodes, dead):
                handler = _OPS.get(node.op_type)
                if handler is None:
                    raise AkUnsupportedOperationException(
                        f"ONNX op {node.op_type!r} not supported"
                    )
                args = [env[i] for i in node.inputs]
                out = handler(node, args, dev)
                if not isinstance(out, tuple):
                    out = (out,)
                for name in drop:
                    env.pop(name, None)
                for name, v in zip(node.outputs, out):
                    if name:
                        env[name] = v
            return {n: env[n] for n in self.output_names}

        return run

    def served(self) -> Callable[..., Dict[str, Any]]:
        """The function under the policy; host arrays are moved to the
        device first (the reference's ``jitted``)."""
        from .precision import wrap_named

        fn = wrap_named(self.function(), self.dtype)
        dev = self.device

        def call(**inputs):
            return fn(**device_inputs(inputs, dev))

        return call


def load_onnx_fn(path: str, device=None) -> Tuple[Callable, OnnxToTorch]:
    conv = OnnxToTorch(OnnxModel.load(path), device=device)
    return conv.served(), conv


# -- op handlers: (node, args, device) -> value or tuple ---------------------

_OPS: Dict[str, Callable] = {}


def op(*names):
    def deco(fn):
        for n in names:
            _OPS[n] = fn
        return fn
    return deco


def _elementwise(fn_torch, fn_np):
    def h(node, args, dev):
        if all(_is_static(a) for a in args):
            return fn_np(*[np.asarray(a) for a in args])
        return fn_torch(*[_t(a, dev) for a in args])
    return h


def _register_elementwise():
    pairs = {
        "Add": (torch.add, np.add), "Sub": (torch.sub, np.subtract),
        "Mul": (torch.mul, np.multiply), "Div": (torch.true_divide, np.divide),
        "Pow": (torch.pow, np.power), "Neg": (torch.neg, np.negative),
        "Abs": (torch.abs, np.abs), "Exp": (torch.exp, np.exp),
        "Log": (torch.log, np.log), "Sqrt": (torch.sqrt, np.sqrt),
        "Floor": (torch.floor, np.floor), "Ceil": (torch.ceil, np.ceil),
        "Equal": (torch.eq, np.equal), "Greater": (torch.gt, np.greater),
        "Less": (torch.lt, np.less),
        "And": (torch.logical_and, np.logical_and),
        "Or": (torch.logical_or, np.logical_or),
        "Not": (torch.logical_not, np.logical_not),
        "Sin": (torch.sin, np.sin), "Cos": (torch.cos, np.cos),
        "Tanh": (torch.tanh, np.tanh), "Sign": (torch.sign, np.sign),
        "Reciprocal": ((lambda x: 1.0 / x), (lambda x: 1.0 / x)),
    }
    for name, (ft, fn) in pairs.items():
        _OPS[name] = _elementwise(ft, fn)
    _OPS["Min"] = _variadic(torch.minimum, np.minimum)
    _OPS["Max"] = _variadic(torch.maximum, np.maximum)
    _OPS["Sum"] = _variadic(torch.add, np.add)


@op("Identity", "Dropout")
def _identity(node, args, dev):
    return args[0]


def _variadic(ft, fn):
    """ONNX Min/Max/Sum take 1..N inputs — fold pairwise."""
    def h(node, args, dev):
        if all(_is_static(a) for a in args):
            out = np.asarray(args[0])
            for a in args[1:]:
                out = fn(out, np.asarray(a))
            return out
        out = _t(args[0], dev)
        for a in args[1:]:
            out = ft(out, _t(a, dev))
        return out
    return h


@op("Relu")
def _relu(node, args, dev):
    return torch.relu(_t(args[0], dev))


@op("LeakyRelu")
def _leaky_relu(node, args, dev):
    alpha = node.attr("alpha", 0.01)
    x = _t(args[0], dev)
    return torch.where(x >= 0, x, alpha * x)


@op("Sigmoid")
def _sigmoid(node, args, dev):
    return torch.sigmoid(_t(args[0], dev))


@op("Softmax")
def _softmax(node, args, dev):
    return torch.softmax(_t(args[0], dev), dim=node.attr("axis", -1))


@op("Erf")
def _erf(node, args, dev):
    return torch.erf(_t(args[0], dev))


@op("Gelu")
def _gelu(node, args, dev):
    approx = node.attr("approximate", "none") == "tanh"
    return F.gelu(_t(args[0], dev), approximate="tanh" if approx else "none")


@op("Softplus")
def _softplus(node, args, dev):
    x = _t(args[0], dev)
    return torch.logaddexp(x, torch.zeros_like(x))


@op("Clip")
def _clip(node, args, dev):
    x = _t(args[0], dev)
    lo = args[1] if len(args) > 1 and args[1] is not None else node.attr("min")
    hi = args[2] if len(args) > 2 and args[2] is not None else node.attr("max")
    if lo is not None:
        x = torch.maximum(x, _t(lo, dev).to(x.dtype))
    if hi is not None:
        x = torch.minimum(x, _t(hi, dev).to(x.dtype))
    return x


@op("MatMul")
def _matmul(node, args, dev):
    return torch.matmul(*promote(_t(args[0], dev), _t(args[1], dev)))


@op("Gemm")
def _gemm(node, args, dev):
    a, b = promote(_t(args[0], dev), _t(args[1], dev))
    if node.attr("transA", 0):
        a = a.T
    if node.attr("transB", 0):
        b = b.T
    y = a @ b
    alpha = node.attr("alpha", 1.0)
    if alpha != 1.0:
        y = alpha * y
    if len(args) > 2 and args[2] is not None:
        c = _t(args[2], dev)
        beta = node.attr("beta", 1.0)
        y = y + (c if beta == 1.0 else beta * c)
    return y


def same_pads(spatial, ks, strides, dils, lower: bool):
    """Explicit per-dim (lo, hi) pads for SAME_UPPER/SAME_LOWER — ONNX puts
    the odd pad at the END for UPPER and at the START for LOWER (TF's SAME
    is SAME_UPPER)."""
    out = []
    for n, k, s, d in zip(spatial, ks, strides, dils):
        eff_k = (k - 1) * d + 1
        total = max((int(np.ceil(n / s)) - 1) * s + eff_k - n, 0)
        half = total // 2
        out.append((total - half, half) if lower else (half, total - half))
    return out


def _torch_pad(pads) -> List[int]:
    """Per-dim (lo, hi) pads, leading dim first, in ``F.pad``'s order (last
    dim first)."""
    out: List[int] = []
    for lo, hi in reversed(list(pads)):
        out += [int(lo), int(hi)]
    return out


_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}


def conv_nd(x, w, strides, pads, dils, groups):
    """N-d convolution, channels first, with (lo, hi) pads per spatial dim:
    symmetric pads go to the convolution, others through ``F.pad`` first."""
    sp = x.ndim - 2
    if all(lo == hi for lo, hi in pads):
        padding = [int(lo) for lo, _ in pads]
    else:
        x = F.pad(x, _torch_pad(pads))
        padding = [0] * sp
    return _CONV[sp](x, w, None, [int(s) for s in strides], padding,
                     [int(d) for d in dils], int(groups))


@op("Conv")
def _conv(node, args, dev):
    x, w = promote(_t(args[0], dev), _t(args[1], dev))
    sp = x.ndim - 2
    strides = node.attr("strides", [1] * sp)
    dil = node.attr("dilations", [1] * sp)
    groups = node.attr("group", 1)
    pads = node.attr("pads")
    auto_pad = node.attr("auto_pad", "NOTSET")
    if auto_pad in ("SAME_UPPER", "SAME_LOWER"):
        ks = [w.shape[2 + i] for i in range(sp)]
        padding = same_pads(x.shape[2:], ks, strides, dil,
                            auto_pad == "SAME_LOWER")
    elif pads is None:
        padding = [(0, 0)] * sp
    else:
        padding = list(zip(pads[:sp], pads[sp:]))
    y = conv_nd(x, w, strides, padding, dil, groups)
    if len(args) > 2 and args[2] is not None:
        y = y + _t(args[2], dev).reshape((1, -1) + (1,) * sp)
    return y


def ceil_overhang(n, k, s, lo, hi, d=1) -> int:
    """Extra high-side pad so the output covers ceil((n+lo+hi-eff_k)/s)+1
    windows, the last of which must start inside the input or its low pad
    (PyTorch's rule, which ONNX Runtime follows)."""
    eff_k = (k - 1) * d + 1
    out = int(np.ceil((n + lo + hi - eff_k) / s)) + 1
    if (out - 1) * s >= n + lo:
        out -= 1
    return max((out - 1) * s + eff_k - (n + lo + hi), 0)


_MAXPOOL = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}


def max_pool(x, ks, strides, pads, dils=None):
    """Max over windows, channels first, (lo, hi) pads per spatial dim filled
    with −inf (the reference's ``reduce_window`` init)."""
    sp = x.ndim - 2
    if any(lo or hi for lo, hi in pads):
        x = F.pad(x, _torch_pad(pads), value=-float("inf"))
    return _MAXPOOL[sp](x, [int(k) for k in ks], [int(s) for s in strides],
                        0, [int(d) for d in (dils or [1] * sp)])


def window_sum(x, ks, strides, pads):
    """Sum over windows, channels first, zero (lo, hi) pads per spatial dim."""
    sp = x.ndim - 2
    if any(lo or hi for lo, hi in pads):
        x = F.pad(x, _torch_pad(pads))
    ks, strides = [int(k) for k in ks], [int(s) for s in strides]
    if sp == 1:
        return F.avg_pool2d(x.unsqueeze(2), [1] + ks, [1] + strides,
                            divisor_override=1).squeeze(2)
    pool = F.avg_pool2d if sp == 2 else F.avg_pool3d
    return pool(x, ks, strides, divisor_override=1)


def window_counts(x, ks, strides, pads, counted_pads):
    """Per-window divisors (1, 1, *out): cells of the input, plus those of
    ``counted_pads`` (a prefix of ``pads`` counted as cells)."""
    ones = torch.ones((1, 1) + tuple(x.shape[2:]), dtype=x.dtype,
                      device=x.device)
    if any(lo or hi for lo, hi in counted_pads):
        ones = F.pad(ones, _torch_pad(counted_pads), value=1.0)
    rest = [(lo - clo, hi - chi) for (lo, hi), (clo, chi)
            in zip(pads, counted_pads)]
    return window_sum(ones, ks, strides, rest)


def _pool(node, args, dev, avg: bool):
    x = _t(args[0], dev)
    sp = x.ndim - 2
    ks = node.attr("kernel_shape")
    strides = node.attr("strides", list(ks))
    dils = node.attr("dilations", [1] * sp)
    pads = node.attr("pads")
    auto_pad = node.attr("auto_pad", "NOTSET")
    if auto_pad in ("SAME_UPPER", "SAME_LOWER"):
        padding = same_pads(x.shape[2:], ks, strides, [1] * sp,
                            auto_pad == "SAME_LOWER")
    elif pads is None:
        padding = [(0, 0)] * sp
    else:
        padding = list(zip(pads[:sp], pads[sp:]))
    explicit = list(padding)
    if node.attr("ceil_mode", 0) and auto_pad not in ("SAME_UPPER",
                                                      "SAME_LOWER"):
        padding = [(lo, hi + ceil_overhang(n, k, s, lo, hi, 1 if avg else d))
                   for n, k, s, d, (lo, hi) in zip(x.shape[2:], ks, strides,
                                                   dils, padding)]
    if not avg:
        return max_pool(x, ks, strides, padding, dils)
    y = window_sum(x, ks, strides, padding)
    if node.attr("count_include_pad", 0):
        if padding == explicit:
            return y / float(np.prod(ks))
        return y / window_counts(x, ks, strides, padding, explicit)
    return y / window_counts(x, ks, strides, padding, [(0, 0)] * sp)


@op("MaxPool")
def _maxpool(node, args, dev):
    return _pool(node, args, dev, avg=False)


@op("AveragePool")
def _avgpool(node, args, dev):
    return _pool(node, args, dev, avg=True)


@op("GlobalAveragePool")
def _gap(node, args, dev):
    x = _t(args[0], dev)
    return x.mean(dim=tuple(range(2, x.ndim)), keepdim=True)


@op("GlobalMaxPool")
def _gmp(node, args, dev):
    x = _t(args[0], dev)
    return x.amax(dim=tuple(range(2, x.ndim)), keepdim=True)


@op("BatchNormalization")
def _batchnorm(node, args, dev):
    x, scale, bias, mean, var = [_t(a, dev) for a in args[:5]]
    eps = node.attr("epsilon", 1e-5)
    shape = (1, -1) + (1,) * (x.ndim - 2)
    inv = 1.0 / torch.sqrt(var + eps)
    return (x - mean.reshape(shape)) * (scale * inv).reshape(shape) + \
        bias.reshape(shape)


@op("LayerNormalization")
def _layernorm(node, args, dev):
    x = _t(args[0], dev)
    scale = _t(args[1], dev)
    axis = node.attr("axis", -1)
    eps = node.attr("epsilon", 1e-5)
    axes = tuple(range(axis % x.ndim, x.ndim))
    mean = x.mean(dim=axes, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=axes, keepdim=True)
    y = (x - mean) / torch.sqrt(var + eps) * scale
    if len(args) > 2 and args[2] is not None:
        y = y + _t(args[2], dev)
    return y


@op("InstanceNormalization")
def _instancenorm(node, args, dev):
    x, scale, bias = [_t(a, dev) for a in args[:3]]
    eps = node.attr("epsilon", 1e-5)
    axes = tuple(range(2, x.ndim))
    shape = (1, -1) + (1,) * (x.ndim - 2)
    mean = x.mean(dim=axes, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=axes, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps) * scale.reshape(shape) + \
        bias.reshape(shape)


# -- shape / structure ops (static-aware) ------------------------------------

def _shape_of(x):
    return np.shape(x) if _is_static(x) else tuple(x.shape)


@op("Shape")
def _shape(node, args, dev):
    shape = _shape_of(args[0])
    start = node.attr("start", 0)
    end = node.attr("end")
    sl = shape[start:end] if end is not None else shape[start:]
    return np.asarray(sl, np.int64)


@op("Constant")
def _constant(node, args, dev):
    t = node.attrs.get("value")
    if t is not None and t.t is not None:
        return t.t.array
    for k in ("value_float", "value_int"):
        a = node.attrs.get(k)
        if a is not None:
            return np.asarray(a.value)
    for k in ("value_floats", "value_ints"):
        a = node.attrs.get(k)
        if a is not None:
            return np.asarray(a.value)
    raise AkUnsupportedOperationException("Constant node without value")


@op("ConstantOfShape")
def _constant_of_shape(node, args, dev):
    shape = _static_ints(args[0])
    t = node.attrs.get("value")
    fill = t.t.array.reshape(-1)[0] if t is not None and t.t is not None else 0.0
    return np.full(shape, fill)


@op("Reshape")
def _reshape(node, args, dev):
    x = args[0]
    shape = _static_ints(args[1])
    if node.attr("allowzero", 0) == 0:
        xshape = _shape_of(x)
        shape = [xshape[i] if s == 0 else s for i, s in enumerate(shape)]
    if _is_static(x):
        return np.reshape(np.asarray(x), shape)
    return x.reshape(shape)


@op("Transpose")
def _transpose(node, args, dev):
    x = args[0]
    ndim = len(_shape_of(x))
    perm = node.attr("perm", list(range(ndim))[::-1])
    if _is_static(x):
        return np.transpose(np.asarray(x), perm)
    return x.permute(*perm)


@op("Flatten")
def _flatten(node, args, dev):
    x = _t(args[0], dev)
    axis = node.attr("axis", 1)
    lead = int(np.prod(x.shape[:axis])) if axis else 1
    return x.reshape(lead, -1)


@op("Squeeze")
def _squeeze(node, args, dev):
    x = args[0]
    axes = (_static_ints(args[1]) if len(args) > 1 and args[1] is not None
            else node.attr("axes"))
    if _is_static(x):
        return np.squeeze(np.asarray(x), axis=tuple(axes) if axes else None)
    return x.squeeze(tuple(axes)) if axes else x.squeeze()


@op("Unsqueeze")
def _unsqueeze(node, args, dev):
    x = args[0]
    axes = (_static_ints(args[1]) if len(args) > 1 and args[1] is not None
            else node.attr("axes"))
    static = _is_static(x)
    x = np.asarray(x) if static else x
    for a in sorted(axes):
        x = np.expand_dims(x, a) if static else x.unsqueeze(a)
    return x


@op("Concat")
def _concat(node, args, dev):
    axis = node.attr("axis", 0)
    if all(_is_static(a) for a in args):
        return np.concatenate([np.asarray(a) for a in args], axis=axis)
    return torch.cat([_t(a, dev) for a in args], dim=axis)


def take(x, idx, axis):
    """``jnp.take``: gather along ``axis`` with any index shape; negative
    indices count from the end."""
    axis = axis % x.ndim
    idx = idx.to(torch.int64)
    idx = torch.where(idx < 0, idx + x.shape[axis], idx)
    out = x.index_select(axis, idx.reshape(-1))
    return out.reshape(tuple(x.shape[:axis]) + tuple(idx.shape)
                       + tuple(x.shape[axis + 1:]))


@op("Gather")
def _gather(node, args, dev):
    axis = node.attr("axis", 0)
    x, idx = args
    if _is_static(x) and _is_static(idx):
        return np.take(np.asarray(x), np.asarray(idx, np.int64), axis=axis)
    return take(_t(x, dev), _t(idx, dev), axis)


def slice_dims(x, sl):
    """``x[tuple(sl)]`` for a tensor, negative steps included (torch's
    indexing refuses them): those dims gather their numpy indices."""
    plain = [s if s.step is None or s.step > 0 else slice(None) for s in sl]
    x = x[tuple(plain)]
    for a, s in enumerate(sl):
        if s.step is not None and s.step < 0:
            idx = np.ascontiguousarray(np.arange(x.shape[a])[s])
            x = x.index_select(a, torch.as_tensor(idx, device=x.device))
    return x


@op("Slice")
def _slice(node, args, dev):
    x = args[0]
    if len(args) > 1:
        starts = _static_ints(args[1])
        ends = _static_ints(args[2])
        axes = (_static_ints(args[3]) if len(args) > 3 and args[3] is not None
                else list(range(len(starts))))
        steps = (_static_ints(args[4]) if len(args) > 4 and args[4] is not None
                 else [1] * len(starts))
    else:  # opset < 10 attribute form
        starts = node.attr("starts")
        ends = node.attr("ends")
        axes = node.attr("axes", list(range(len(starts))))
        steps = [1] * len(starts)
    ndim = len(_shape_of(x))
    sl = [slice(None)] * ndim
    for s, e, a, st in zip(starts, ends, axes, steps):
        sl[a] = slice(s if s > -(2**62) else None,
                      e if abs(e) < 2**62 else None, st)
    return np.asarray(x)[tuple(sl)] if _is_static(x) else slice_dims(x, sl)


@op("Split")
def _split(node, args, dev):
    x = _t(args[0], dev)
    axis = node.attr("axis", 0)
    if len(args) > 1 and args[1] is not None:
        sizes = _static_ints(args[1])
    else:
        sizes = node.attr("split")
    if sizes is None:
        n = node.attr("num_outputs", len(node.outputs))
        return tuple(torch.tensor_split(x, n, dim=axis))
    bounds = np.cumsum(sizes)[:-1].tolist()
    return tuple(torch.tensor_split(x, bounds, dim=axis))


def pad_edges(x, pad_width, mode: str):
    """``jnp.pad`` in ``reflect`` or ``edge`` mode along every dim: each
    padded dim gathers the indices ``np.pad`` gives its ``arange``."""
    np_mode = {"reflect": "reflect", "edge": "edge"}[mode]
    for a, (lo, hi) in enumerate(pad_width):
        if lo or hi:
            idx = np.pad(np.arange(x.shape[a]), (lo, hi), mode=np_mode)
            x = x.index_select(a, torch.as_tensor(idx, device=x.device))
    return x


@op("Pad")
def _pad(node, args, dev):
    x = _t(args[0], dev)
    if len(args) > 1 and args[1] is not None:
        pads = _static_ints(args[1])
    else:
        pads = node.attr("pads")
    mode = node.attr("mode", "constant")
    value = 0.0
    if len(args) > 2 and args[2] is not None:
        value = float(np.asarray(args[2]).reshape(-1)[0])
    n = x.ndim
    pad_width = list(zip(pads[:n], pads[n:]))
    if mode == "constant":
        return F.pad(x, _torch_pad(pad_width), value=value)
    return pad_edges(x, pad_width, mode)


@op("Expand")
def _expand(node, args, dev):
    x = _t(args[0], dev)
    shape = _static_ints(args[1])
    return torch.broadcast_to(
        x, np.broadcast_shapes(tuple(x.shape), tuple(shape)))


@op("Where")
def _where(node, args, dev):
    c, a, b = [_t(v, dev) for v in args]
    return torch.where(c.to(torch.bool), a, b)


@op("Cast")
def _cast(node, args, dev):
    to = TENSOR_DTYPES[node.attr("to")]
    x = args[0]
    if _is_static(x):
        return np.asarray(x).astype(to)
    return x.to(torch_dtype(to))


@op("Tile")
def _tile(node, args, dev):
    return _t(args[0], dev).tile(tuple(_static_ints(args[1])))


@op("Range")
def _range(node, args, dev):
    start, limit, delta = [np.asarray(a).reshape(()) for a in args]
    return np.arange(start, limit, delta)


def _reduce_torch(name):
    def f(x, axis, keepdims):
        dims = axis if axis is not None else tuple(range(x.ndim))
        if name == "prod":
            for d in sorted((d % x.ndim for d in dims), reverse=True):
                x = x.prod(dim=d, keepdim=keepdims)
            return x
        return getattr(torch, name)(x, dim=dims, keepdim=keepdims)
    return f


def _reduce(np_fn, torch_fn):
    def h(node, args, dev):
        x = args[0]
        if len(args) > 1 and args[1] is not None:
            axes = tuple(_static_ints(args[1]))
        else:
            axes = node.attr("axes")
            axes = tuple(axes) if axes else None
        keep = bool(node.attr("keepdims", 1))
        if _is_static(x):
            return np_fn(np.asarray(x), axis=axes, keepdims=keep)
        return torch_fn(x, axes, keep)
    return h


@op("ArgMax")
def _argmax(node, args, dev):
    x = _t(args[0], dev)
    axis = node.attr("axis", 0)
    keep = bool(node.attr("keepdims", 1))
    return torch.argmax(x, dim=axis, keepdim=keep)


def _register_reduce():
    _OPS["ReduceMean"] = _reduce(np.mean, _reduce_torch("mean"))
    _OPS["ReduceSum"] = _reduce(np.sum, _reduce_torch("sum"))
    _OPS["ReduceMax"] = _reduce(np.max, _reduce_torch("amax"))
    _OPS["ReduceMin"] = _reduce(np.min, _reduce_torch("amin"))
    _OPS["ReduceProd"] = _reduce(np.prod, _reduce_torch("prod"))


_registered = False


def _ensure_registered():
    """Populate the elementwise and reduction tables on first use."""
    global _registered
    if not _registered:
        _register_elementwise()
        _register_reduce()
        _registered = True


def supported_onnx_ops() -> List[str]:
    """The published conformance manifest: every ONNX op type the converter
    understands. Graphs using anything else raise
    AkUnsupportedOperationException naming the op."""
    _ensure_registered()
    return sorted(_OPS)
