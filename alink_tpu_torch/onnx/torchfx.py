"""torch.export ExportedProgram → a function of PyTorch ops on the device
(port of ``alink_tpu.onnx.torchfx``; the converter class ``TorchToJax`` is
:class:`TorchExportToTorch` here).

The reference executes TorchScript through libtorch in the JVM (reference:
dl_predictors/predictor-torch/.../TorchJavaPredictor.java:29-33 —
org.pytorch.Module.load + forward). The JAX package lowers the aten-level FX
graph of ``torch.export`` to XLA; the port runs the same graph, after the same
``run_decompositions({})``, node by node on the device with its own handler
for each aten op, so that both packages accept exactly the same aten set and
refuse the same models (``_ATEN``), and compute each op by the reference's
rules: view shapes re-derive the batch (``_viewshape``), the pools take the
reference's arithmetic (its ``_ceil_extra`` is ``convert.ceil_overhang``
here), and under the bfloat16 policy ``_batch_norm_impl``, ``_to_copy``
and ``_sdpa`` keep the reference's dtypes.
Weights are moved to the device once, at load.

Load path: ``.pt2`` files (torch.export.save) or a live nn.Module.
TorchScript ``.pt`` files predate torch.export and carry no exportable graph;
they raise with a pointer to re-export.
"""

from __future__ import annotations

import math
import operator
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..common.env import resolve_device
from ..common.exceptions import (
    AkIllegalArgumentException,
    AkUnsupportedOperationException,
)
from .convert import device_inputs, promote, take


class TorchExportToTorch:
    """Run a torch.export.ExportedProgram's graph on ``device``.

    ``dtype="bfloat16"`` loads float weights as bf16 and computes in bf16;
    outputs are cast back to fp32. The default keeps fp32 on the pinned path
    (no TF32, ``precision.pinned_fp32``) for foreign-model numerics parity."""

    def __init__(self, ep, dtype=None, device=None):
        from .precision import as_tensor, resolve_dtype

        self.dtype = resolve_dtype(dtype)
        self.device = resolve_device(device)
        self.ep = ep.run_decompositions({})
        sig = self.ep.graph_signature
        self.user_inputs = list(sig.user_inputs)
        # placeholder name -> constant value (params, buffers, consts)
        state: Dict[str, Any] = {}
        for name, target in sig.inputs_to_parameters.items():
            state[name] = self.ep.state_dict[target]
        for name, target in sig.inputs_to_buffers.items():
            state[name] = self.ep.state_dict[target]
        consts = getattr(self.ep, "constants", {}) or {}
        for spec in sig.input_specs:
            target = getattr(spec, "target", None)
            if target is not None and target in consts:
                val = consts[target]
                if isinstance(val, torch.Tensor):
                    state[spec.arg.name] = val
        self.state = {k: as_tensor(v.detach(), self.device, self.dtype)
                      for k, v in state.items()}

    def function(self) -> Callable[..., List[Any]]:
        """The graph as a plain function of device tensors (no policy)."""
        _ensure_aten_registered()
        nodes = list(self.ep.graph_module.graph.nodes)
        state = self.state
        user_inputs = set(self.user_inputs)
        dev = self.device
        dead = _dead_after(nodes)

        def run(*args):
            env: Dict[str, Any] = {}
            it = iter(args)
            for i, node in enumerate(nodes):
                for name in dead[i]:   # values no later node reads
                    env.pop(name, None)
                if node.op == "placeholder":
                    if node.name in state:
                        env[node.name] = state[node.name]
                    elif node.name in user_inputs or node.target in user_inputs:
                        env[node.name] = next(it)
                    else:  # unused input slot
                        env[node.name] = None
                elif node.op == "call_function":
                    env[node.name] = _dispatch(node, env, dev)
                elif node.op == "output":
                    return [_resolve(o, env) for o in node.args[0]]
                elif node.op == "get_attr":
                    env[node.name] = state.get(node.target)
                else:
                    raise AkUnsupportedOperationException(
                        f"fx node op {node.op!r}"
                    )
            return []

        return run

    def served(self) -> Callable[..., List[Any]]:
        """The function under the policy; host arrays are moved to the
        device first (the reference's ``jitted``)."""
        from .precision import wrap_positional

        fn = wrap_positional(self.function(), self.dtype)
        dev = self.device

        def call(*args):
            return fn(*device_inputs(dict(enumerate(args)), dev).values())

        return call


def load_torch_fn(path_or_module, example_args: Optional[tuple] = None,
                  dtype=None, device=None):
    """Load a .pt2 exported program (or export a live nn.Module) and return
    (served fn, converter). ``dtype="bfloat16"`` enables the bf16 serving
    policy (see TorchExportToTorch)."""
    if isinstance(path_or_module, str):
        if path_or_module.endswith(".pt2"):
            ep = torch.export.load(path_or_module)
        else:
            raise AkIllegalArgumentException(
                f"{path_or_module!r}: only torch.export .pt2 artifacts are "
                "ingestable; re-export TorchScript models with "
                "torch.export.save(torch.export.export(model, args), 'm.pt2')"
            )
    elif isinstance(path_or_module, torch.nn.Module):
        if example_args is None:
            raise AkIllegalArgumentException("example_args needed to export")
        ep = torch.export.export(path_or_module.eval(), example_args)
    else:
        ep = path_or_module  # already an ExportedProgram
    conv = TorchExportToTorch(ep, dtype=dtype, device=device)
    return conv.served(), conv


def _dead_after(nodes) -> List[List[str]]:
    """For each node index i, the values whose last reader is node i - 1:
    the interpreter drops them before running node i, so a forward holds
    the activations that are still to be read, not every one it made."""
    last: Dict[str, int] = {}
    for i, node in enumerate(nodes):
        for inp in node.all_input_nodes:
            last[inp.name] = i
    dead: List[List[str]] = [[] for _ in range(len(nodes) + 1)]
    for name, i in last.items():
        dead[i + 1].append(name)
    return dead


# -- aten dispatch -----------------------------------------------------------

def _resolve(v, env):
    if isinstance(v, torch.fx.Node):
        return env[v.name]
    if isinstance(v, (list, tuple)):
        return type(v)(_resolve(x, env) for x in v)
    return v


def _dispatch(node, env, dev):
    target = node.target
    args = _resolve(list(node.args), env)
    kwargs = {k: _resolve(v, env) for k, v in node.kwargs.items()}
    if target is operator.getitem:
        return args[0][args[1]]
    name = getattr(target, "_opname", None) or str(target)
    # strip overload suffix: aten.add.Tensor -> add
    key = name.split("::")[-1].split(".")[0] if "::" in name else \
        str(target).replace("aten.", "").split(".")[0]
    fn = _ATEN.get(key)
    if fn is None:
        raise AkUnsupportedOperationException(
            f"aten op {target} (key {key!r}) not supported"
        )
    return fn(args, kwargs, dev)


_ATEN: Dict[str, Callable] = {}


def _j(v, dev):
    """Host arrays become device tensors (float64 as float32, as JAX with
    64-bit off); tensors and Python scalars pass through."""
    if isinstance(v, (np.ndarray, np.generic)):
        arr = np.asarray(v)
        if arr.dtype == np.float64:
            arr = arr.astype(np.float32)
        return torch.as_tensor(np.array(arr), device=dev)
    return v


def _jt(v, dev) -> torch.Tensor:
    """:func:`_j`, with Python scalars as 0-d tensors too."""
    v = _j(v, dev)
    return v if isinstance(v, torch.Tensor) else torch.tensor(v, device=dev)


def _binop(f):
    def h(a, k, dev):
        x, y = _j(a[0], dev), _j(a[1], dev)
        alpha = k.get("alpha")
        return f(x, y) if alpha in (None, 1) else f(x, y * alpha)
    return h


def _unary(f):
    return lambda a, k, dev: f(_jt(a[0], dev))


def _mm(a, k, dev):
    return torch.matmul(*promote(_jt(a[0], dev), _jt(a[1], dev)))


def _clamp(x, lo, hi):
    if lo is None and hi is None:
        return x
    return torch.clamp(x, lo, hi)


def _register_basic():
    _ATEN.update({
        "add": _binop(operator.add), "sub": _binop(operator.sub),
        "mul": lambda a, k, d: _j(a[0], d) * _j(a[1], d),
        "div": lambda a, k, d: _j(a[0], d) / _j(a[1], d),
        "pow": lambda a, k, d: _j(a[0], d) ** _j(a[1], d),
        # the op itself (the reference writes 1/sqrt): on the card rsqrt and
        # 1/sqrt part by an ulp, which a bf16 network grows to ~2e-3 of its
        # logits, so a served .pt2 computes what its module computed
        "rsqrt": _unary(torch.rsqrt),
        "sqrt": _unary(torch.sqrt),
        "exp": _unary(torch.exp),
        "log": _unary(torch.log),
        "neg": _unary(torch.neg),
        "abs": _unary(torch.abs),
        "relu": _unary(torch.relu),
        "sigmoid": _unary(torch.sigmoid),
        "silu": _unary(F.silu),
        "tanh": _unary(torch.tanh),
        "gelu": lambda a, k, d: F.gelu(
            _jt(a[0], d),
            approximate="tanh" if k.get("approximate", "none") == "tanh"
            else "none"),
        "hardtanh": lambda a, k, d: _clamp(
            _jt(a[0], d), a[1] if len(a) > 1 else -1.0,
            a[2] if len(a) > 2 else 1.0),
        "clamp": lambda a, k, d: _clamp(
            _jt(a[0], d), a[1] if len(a) > 1 else None,
            a[2] if len(a) > 2 else None),
        "minimum": lambda a, k, d: torch.minimum(
            *promote(_jt(a[0], d), _jt(a[1], d))),
        "maximum": lambda a, k, d: torch.maximum(
            *promote(_jt(a[0], d), _jt(a[1], d))),
        "mm": _mm, "bmm": _mm, "matmul": _mm,
        "t": lambda a, k, d: _jt(a[0], d).T,
        "addmm": _addmm,
        "linear": _linear,
        "view": lambda a, k, d: _jt(a[0], d).reshape(
            _viewshape(_jt(a[0], d), a[1])),
        "reshape": lambda a, k, d: _jt(a[0], d).reshape(
            _viewshape(_jt(a[0], d), a[1])),
        "_unsafe_view": lambda a, k, d: _jt(a[0], d).reshape(
            _viewshape(_jt(a[0], d), a[1])),
        "expand": lambda a, k, d: torch.broadcast_to(
            _jt(a[0], d), _expand_shape(tuple(_jt(a[0], d).shape), a[1])),
        "permute": lambda a, k, d: _jt(a[0], d).permute(*a[1]),
        "transpose": lambda a, k, d: _jt(a[0], d).transpose(a[1], a[2]),
        "flatten": lambda a, k, d: _flatten(_jt(a[0], d), *a[1:]),
        "squeeze": lambda a, k, d: _squeeze(_jt(a[0], d), *a[1:]),
        "unsqueeze": lambda a, k, d: _jt(a[0], d).unsqueeze(a[1]),
        "cat": lambda a, k, d: torch.cat(
            promote(*[_jt(x, d) for x in a[0]]),
            dim=k.get("dim", a[1] if len(a) > 1 else 0)),
        "stack": lambda a, k, d: torch.stack(
            promote(*[_jt(x, d) for x in a[0]]),
            dim=k.get("dim", a[1] if len(a) > 1 else 0)),
        "split": lambda a, k, d: _split(
            _jt(a[0], d), a[1], k.get("dim", a[2] if len(a) > 2 else 0)),
        "chunk": lambda a, k, d: list(torch.tensor_split(
            _jt(a[0], d), a[1], dim=k.get("dim", a[2] if len(a) > 2 else 0))),
        "slice": lambda a, k, d: _slice(_jt(a[0], d), *a[1:]),
        "select": lambda a, k, d: _jt(a[0], d).select(a[1], a[2]),
        # clone keeps a requested memory format: a layout, not a value
        "clone": lambda a, k, d: _jt(a[0], d).contiguous(
            memory_format=k["memory_format"])
        if k.get("memory_format") not in (None, torch.preserve_format)
        else _j(a[0], d),
        "detach": lambda a, k, d: _j(a[0], d),
        "alias": lambda a, k, d: _j(a[0], d),
        "contiguous": lambda a, k, d: _j(a[0], d),
        "dropout": lambda a, k, d: _j(a[0], d),
        "_to_copy": lambda a, k, d: _to_copy(_jt(a[0], d), k),
        "to": lambda a, k, d: _j(a[0], d),
        "softmax": lambda a, k, d: torch.softmax(_jt(a[0], d), dim=a[1]),
        "_softmax": lambda a, k, d: torch.softmax(_jt(a[0], d), dim=a[1]),
        "log_softmax": lambda a, k, d: torch.log_softmax(_jt(a[0], d),
                                                         dim=a[1]),
        "_log_softmax": lambda a, k, d: torch.log_softmax(_jt(a[0], d),
                                                          dim=a[1]),
        "mean": lambda a, k, d: _reduce(torch.mean, a, k, d),
        "sum": lambda a, k, d: _reduce(torch.sum, a, k, d),
        "amax": lambda a, k, d: _reduce(torch.amax, a, k, d),
        "amin": lambda a, k, d: _reduce(torch.amin, a, k, d),
        "var": _var,
        "argmax": lambda a, k, d: torch.argmax(
            _jt(a[0], d), dim=a[1] if len(a) > 1 else None),
        "embedding": lambda a, k, d: take(_jt(a[0], d), _jt(a[1], d), 0),
        "arange": _arange,
        "full": lambda a, k, d: torch.full(tuple(a[0]), a[1], device=d),
        "zeros": lambda a, k, d: torch.zeros(tuple(a[0]), device=d),
        "ones": lambda a, k, d: torch.ones(tuple(a[0]), device=d),
        "where": lambda a, k, d: torch.where(
            _jt(a[0], d).to(torch.bool), _j(a[1], d), _j(a[2], d)),
        "convolution": _convolution,
        "conv2d": _conv2d,
        "conv1d": _conv2d,
        "max_pool2d": _max_pool2d,
        "max_pool2d_with_indices": lambda a, k, d: (_max_pool2d(a, k, d),
                                                    None),
        "avg_pool2d": _avg_pool2d,
        "adaptive_avg_pool2d": _adaptive_avg_pool2d,
        "_adaptive_avg_pool2d": _adaptive_avg_pool2d,
        "native_layer_norm": _native_layer_norm,
        "layer_norm": _layer_norm,
        "native_batch_norm": _native_batch_norm,
        "_native_batch_norm_legit_no_training": _batch_norm_no_training,
        "batch_norm": _batch_norm,
        "native_group_norm": _group_norm,
        "scaled_dot_product_attention": _sdpa,
    })


def _addmm(a, k, dev):
    # beta·a0 + alpha·(a1 @ a2), the product rounded before the add, as the
    # reference's two XLA ops (a fused addmm rounds once)
    bias = _jt(a[0], dev)
    prod = torch.matmul(*promote(_jt(a[1], dev), _jt(a[2], dev)))
    beta, alpha = k.get("beta", 1), k.get("alpha", 1)
    if beta != 1:
        bias = beta * bias
    if alpha != 1:
        prod = alpha * prod
    return bias + prod


def _linear(a, k, dev):
    x, w = promote(_jt(a[0], dev), _jt(a[1], dev))
    y = x @ w.T
    if len(a) > 2 and a[2] is not None:
        y = y + _jt(a[2], dev)
    return y


def _viewshape(x, shape: Sequence[int]) -> List[int]:
    """torch.export bakes the EXAMPLE batch size into view/reshape targets;
    when the element counts disagree at serving time (different batch), the
    leading dim is re-derived so exported graphs stay batch-polymorphic."""
    shape = [int(s) for s in shape]
    if -1 in shape:
        return shape
    if math.prod(shape) != math.prod(x.shape):
        shape[0] = -1
    return shape


def _expand_shape(cur: Tuple[int, ...], target: Sequence[int]):
    out = []
    cur = (1,) * (len(target) - len(cur)) + tuple(cur)
    for c, t in zip(cur, target):
        out.append(c if t == -1 else t)
    return tuple(out)


def _flatten(x, start=0, end=-1):
    nd = x.ndim
    start %= nd
    end %= nd
    shape = tuple(x.shape[:start]) + (-1,) + tuple(x.shape[end + 1:])
    return x.reshape(shape)


def _squeeze(x, dims=None):
    if dims is None:
        return x.squeeze()
    if isinstance(dims, int):
        dims = [dims]
    dims = [d for d in dims if x.shape[d] == 1]
    return x.squeeze(tuple(dims)) if dims else x


def _split(x, sizes, dim):
    if isinstance(sizes, int):
        n = x.shape[dim] // sizes + (1 if x.shape[dim] % sizes else 0)
        sizes = [sizes] * n
        sizes[-1] = x.shape[dim] - sizes[0] * (n - 1)
    bounds = np.cumsum(sizes)[:-1].tolist()
    return list(torch.tensor_split(x, bounds, dim=dim))


def _slice(x, dim=0, start=None, end=None, step=1):
    sl = [slice(None)] * x.ndim
    if end is not None and end > (1 << 62):
        end = None
    sl[dim] = slice(start, end, step)
    return x[tuple(sl)]


_TO_COPY = {torch.float32: torch.float32, torch.float64: torch.float32,
            torch.int64: torch.int64, torch.int32: torch.int32,
            torch.bool: torch.bool, torch.float16: torch.float16,
            torch.bfloat16: torch.bfloat16}


def _to_copy(x, kwargs):
    # the reference's map (float64 is float32 there: JAX's 64-bit mode is
    # off; an unlisted dtype is float32), so a graph's own casts keep their
    # dtypes under the bfloat16 policy too
    dt = kwargs.get("dtype")
    if dt is None:
        return x
    return x.to(_TO_COPY.get(dt, torch.float32))


def _dims(x, axis):
    if axis is None:
        return tuple(range(x.ndim))
    return tuple(axis) if isinstance(axis, (list, tuple)) else axis


def _reduce(f, args, kwargs, dev):
    x = _jt(args[0], dev)
    axis = kwargs.get("dim", args[1] if len(args) > 1 else None)
    keep = kwargs.get("keepdim", args[2] if len(args) > 2 else False)
    return f(x, dim=_dims(x, axis), keepdim=bool(keep))


def _var(args, kwargs, dev):
    x = _jt(args[0], dev)
    axis = kwargs.get("dim", args[1] if len(args) > 1 else None)
    corr = kwargs.get("correction", 1)
    keep = kwargs.get("keepdim", False)
    return torch.var(x, dim=_dims(x, axis), correction=int(corr),
                     keepdim=keep)


def _arange(args, kwargs, dev):
    return torch.arange(*args[:3], device=dev)


def _convolution(args, kwargs, dev):
    # aten.convolution(input, weight, bias, stride, padding, dilation,
    #                  transposed, output_padding, groups)
    from .convert import conv_nd

    x, w, b, stride, padding, dilation, transposed, _outpad, groups = args[:9]
    x, w = promote(_jt(x, dev), _jt(w, dev))
    sp = x.ndim - 2
    if transposed:
        raise AkUnsupportedOperationException("transposed convolution")
    y = conv_nd(x, w, stride, [(int(p), int(p)) for p in padding], dilation,
                groups)
    if b is not None:
        y = y + _jt(b, dev).reshape((1, -1) + (1,) * sp)
    return y


def _conv2d(args, kwargs, dev):
    x, w = args[0], args[1]
    b = args[2] if len(args) > 2 else None
    stride = args[3] if len(args) > 3 else [1, 1]
    padding = args[4] if len(args) > 4 else [0, 0]
    dilation = args[5] if len(args) > 5 else [1, 1]
    groups = args[6] if len(args) > 6 else 1
    return _convolution(
        [x, w, b, stride, padding, dilation, False, [0, 0], groups], kwargs,
        dev)


def _pair(v):
    return [v, v] if isinstance(v, int) else list(v)


def _max_pool2d(args, kwargs, dev):
    # aten.max_pool2d(input, kernel, stride=[], padding=0, dilation=1,
    #                 ceil_mode=False)
    from .convert import ceil_overhang, max_pool

    x = _jt(args[0], dev)
    ks = _pair(args[1])
    stride = _pair(args[2]) if len(args) > 2 and args[2] else ks
    padding = _pair(args[3] if len(args) > 3 else 0)
    dilation = _pair(args[4] if len(args) > 4 else 1)
    ceil_mode = bool(args[5]) if len(args) > 5 else False
    pad = []
    for i in range(2):
        hi = padding[i]
        if ceil_mode:   # the reference's _ceil_extra
            hi += ceil_overhang(x.shape[2 + i], ks[i], stride[i],
                                padding[i], padding[i], dilation[i])
        pad.append((padding[i], hi))
    return max_pool(x, ks, stride, pad, dilation)


def _avg_pool2d(args, kwargs, dev):
    # aten.avg_pool2d(input, kernel, stride=[], padding=0, ceil_mode=False,
    #                 count_include_pad=True, divisor_override=None)
    from .convert import window_counts, window_sum

    x = _jt(args[0], dev)
    ks = _pair(args[1])
    stride = _pair(args[2]) if len(args) > 2 and args[2] else ks
    padding = _pair(args[3] if len(args) > 3 else 0)
    ceil_mode = bool(args[4]) if len(args) > 4 else False
    include_pad = bool(args[5]) if len(args) > 5 else True
    divisor = args[6] if len(args) > 6 else None
    if ceil_mode:
        raise AkUnsupportedOperationException("avg_pool2d with ceil_mode")
    pad = [(int(p), int(p)) for p in padding]
    s = window_sum(x, ks, stride, pad)
    if divisor:
        return s / divisor
    if include_pad:  # torch default: padded zeros count in the denominator
        return s / float(np.prod(ks))
    return s / window_counts(x, ks, stride, pad, [(0, 0), (0, 0)])


def _adaptive_avg_pool2d(args, kwargs, dev):
    x = _jt(args[0], dev)
    out = args[1]
    if isinstance(out, int):
        out = [out, out]
    if tuple(out) == (1, 1):
        return x.mean(dim=(2, 3), keepdim=True)
    h, w = x.shape[2], x.shape[3]
    if h % out[0] or w % out[1]:
        raise AkUnsupportedOperationException(
            f"adaptive_avg_pool2d {tuple(x.shape)} -> {out}"
        )
    x = x.reshape(x.shape[0], x.shape[1], out[0], h // out[0],
                  out[1], w // out[1])
    return x.mean(dim=(3, 5))


def _native_layer_norm(args, kwargs, dev):
    x, shape, w, b, eps = args[:5]
    x = _jt(x, dev)
    axes = tuple(range(x.ndim - len(shape), x.ndim))
    mean = x.mean(dim=axes, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=axes, keepdim=True)
    y = (x - mean) / torch.sqrt(var + eps)
    if w is not None:
        y = y * _jt(w, dev)
    if b is not None:
        y = y + _jt(b, dev)
    return y, mean, var


def _layer_norm(args, kwargs, dev):
    x, shape = args[0], args[1]
    w = args[2] if len(args) > 2 else kwargs.get("weight")
    b = args[3] if len(args) > 3 else kwargs.get("bias")
    eps = args[4] if len(args) > 4 else kwargs.get("eps", 1e-5)
    return _native_layer_norm([x, shape, w, b, eps], {}, dev)[0]


def _batch_norm_impl(x, w, b, rm, rv, eps, dev):
    # the reference's op order, each op in the operands' dtype: under the
    # bfloat16 policy every step rounds to bf16, as there
    x = _jt(x, dev)
    shape = (1, -1) + (1,) * (x.ndim - 2)
    y = (x - _jt(rm, dev).reshape(shape)) / torch.sqrt(
        _jt(rv, dev).reshape(shape) + eps)
    if w is not None:
        y = y * _jt(w, dev).reshape(shape)
    if b is not None:
        y = y + _jt(b, dev).reshape(shape)
    return y


def _batch_norm(args, kwargs, dev):
    # aten.batch_norm(input, w, b, rm, rv, training, momentum, eps,
    #                 cudnn_enabled) -> Tensor
    return _batch_norm_impl(args[0], args[1], args[2], args[3], args[4],
                            args[7], dev)


def _native_batch_norm(args, kwargs, dev):
    # aten.native_batch_norm(input, w, b, rm, rv, training, momentum, eps)
    # -> (out, save_mean, save_invstd)
    return (_batch_norm_impl(args[0], args[1], args[2], args[3], args[4],
                             args[7], dev), None, None)


def _batch_norm_no_training(args, kwargs, dev):
    # aten._native_batch_norm_legit_no_training(input, w, b, rm, rv,
    #                                           momentum, eps) -> tuple
    return (_batch_norm_impl(args[0], args[1], args[2], args[3], args[4],
                             args[6], dev), None, None)


def _group_norm(args, kwargs, dev):
    x, w, b, n, c, hw, groups, eps = args[:8]
    x = _jt(x, dev)
    orig = x.shape
    xg = x.reshape(orig[0], groups, -1)
    mean = xg.mean(dim=2, keepdim=True)
    var = ((xg - mean) ** 2).mean(dim=2, keepdim=True)
    y = ((xg - mean) / torch.sqrt(var + eps)).reshape(orig)
    shape = (1, -1) + (1,) * (x.ndim - 2)
    if w is not None:
        y = y * _jt(w, dev).reshape(shape)
    if b is not None:
        y = y + _jt(b, dev).reshape(shape)
    return y, mean, var


def _sdpa(args, kwargs, dev):
    q, k, v = [_jt(a, dev) for a in args[:3]]
    mask = _jt(args[3], dev) if len(args) > 3 and args[3] is not None \
        else None
    s = torch.matmul(*promote(q, k.transpose(-1, -2)))
    scale = kwargs.get("scale")
    if scale:
        s = s * scale
    else:
        # the reference's default scale is a numpy float64 scalar, which JAX
        # does not treat as weak: it lifts bf16 scores (and all after them)
        # to float32
        s = s.to(torch.promote_types(s.dtype, torch.float32)) \
            * float(1.0 / np.sqrt(q.shape[-1]))
    if kwargs.get("is_causal"):
        n, m = s.shape[-2], s.shape[-1]
        causal = torch.tril(torch.ones((n, m), dtype=torch.bool, device=dev))
        s = torch.where(causal, s, -torch.inf)
    if mask is not None:
        s = torch.where(mask, s, -torch.inf) if mask.dtype == torch.bool \
            else s + mask
    return torch.matmul(*promote(torch.softmax(s, dim=-1), v))


_basic_registered = False


def _ensure_aten_registered():
    """Populate the aten table on first use."""
    global _basic_registered
    if not _basic_registered:
        _register_basic()
        _basic_registered = True
