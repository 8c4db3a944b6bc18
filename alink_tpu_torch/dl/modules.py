"""BERT-family encoder as ``nn.Module``s (port of ``alink_tpu/dl/modules.py``).

The modules reproduce the reference flax modules' numerics, so weights carried
across with :func:`~alink_tpu_torch.dl.convert.flax_to_torch` give the same
logits:

- parameters are stored in fp32 and cast to the compute dtype at use, as
  flax's ``Dense``/``DenseGeneral``/``Embed`` with ``dtype=bf16`` do; a
  dense layer rounds its product to the compute dtype before adding the bias;
- :class:`LayerNorm` is flax's: ``epsilon=1e-6``, the fast variance
  ``E[x²] − E[x]²`` with fp32 statistics, output cast to the compute dtype;
- GELU is the tanh approximation (flax ``nn.gelu`` default);
- the classification/regression head computes in fp32.

Training mode (``deterministic=False``) applies :class:`Dropout` with an
explicit ``torch.Generator`` (``rng``), as the reference's ``nn.Dropout``
takes its ``dropout`` key; the draws differ from JAX's by design.
``remat=True`` recomputes each layer in the backward pass
(``torch.utils.checkpoint``, the reference's ``nn.remat``), replaying the
layer's dropout draws from the generator's state at the layer's start. A
fresh module draws its weights from flax's default initialisers
(:meth:`TransformerEncoder.init_weights` redraws them from a seed).

:class:`KerasSequential` builds the reference's string layer grammar
(:func:`parse_layers`) into modules with flax 0.12's layouts, defaults and
numerics (see its docstring); its weights carry across with
:func:`~alink_tpu_torch.dl.convert.keras_flax_to_torch`.
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass
from typing import Any, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..common.exceptions import AkIllegalArgumentException
from .attention import blockwise_attention, full_attention, ring_attention


@dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position: int = 512
    type_vocab_size: int = 2
    dropout: float = 0.1
    num_labels: int = 2
    regression: bool = False
    dtype: Any = torch.bfloat16  # compute dtype; params stay fp32
    use_ring_attention: bool = False
    remat: bool = False  # recompute each layer in the backward pass
    # "mean": masked mean-pool; "cls": first-token pooling
    pool: str = "mean"
    # >0: K/V consumed in blocks of this size under an online softmax (the
    # flash block-update kernel's route)
    attention_block_size: int = 0

    @staticmethod
    def base(**kw) -> "BertConfig":
        return BertConfig(**kw)

    @staticmethod
    def tiny(**kw) -> "BertConfig":
        d = dict(vocab_size=512, hidden_size=64, num_layers=2, num_heads=4,
                 intermediate_size=128, max_position=128, dropout=0.0)
        d.update(kw)
        return BertConfig(**d)


# flax's lecun_normal: a normal truncated to ±2 standard deviations, scaled
# so that the truncated draw has variance 1/fan_in (jax's variance_scaling
# divides by this standard deviation of the unit normal truncated to ±2)
_TRUNC_STD = 0.87962566103423978


class Dense(nn.Linear):
    """flax ``Dense`` numerics: input, weight and bias cast to the compute
    dtype; the product is rounded to it before the bias is added. Fresh
    weights: flax's ``lecun_normal`` on fan-in ``in_features`` (also for
    the fused qkv ``DenseGeneral``, whose kernel flax draws as
    (hidden, 3·hidden)), zero bias."""

    def __init__(self, in_features: int, out_features: int, dtype):
        super().__init__(in_features, out_features)
        self.compute_dtype = dtype

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        std = math.sqrt(1.0 / self.in_features) / _TRUNC_STD
        with torch.no_grad():
            nn.init.trunc_normal_(self.weight, 0.0, std, -2 * std, 2 * std,
                                  generator=generator)
            self.bias.zero_()

    def forward(self, x):
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight.to(dt)) + self.bias.to(dt)


class Embed(nn.Embedding):
    """flax ``Embed``: looks rows up, in the compute dtype. Fresh rows:
    flax's default embedding init, normal with variance 1/dim."""

    def __init__(self, num: int, dim: int, dtype):
        super().__init__(num, dim)
        self.compute_dtype = dtype

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        with torch.no_grad():
            self.weight.normal_(0.0, math.sqrt(1.0 / self.embedding_dim),
                                generator=generator)

    def forward(self, ids):
        return F.embedding(ids, self.weight).to(self.compute_dtype)


class LayerNorm(nn.LayerNorm):
    """flax ``LayerNorm``: fp32 statistics with the fast variance, fp32
    affine, output in the compute dtype. Fresh: ones and zeros."""

    def __init__(self, dim: int, dtype):
        super().__init__(dim, eps=1e-6)
        self.compute_dtype = dtype

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()

    def forward(self, x):
        xf = x.float()
        mu = xf.mean(dim=-1, keepdim=True)
        var = torch.clamp((xf * xf).mean(dim=-1, keepdim=True) - mu * mu, min=0.0)
        y = (xf - mu) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias
        return y.to(self.compute_dtype)


class Dropout(nn.Module):
    """flax ``nn.Dropout``: keeps each element with probability 1 − rate,
    drawn from the explicit generator ``rng``, and scales kept ones by
    1 / (1 − rate). Identity when ``deterministic`` or at rate 0."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = float(rate)

    def forward(self, x, deterministic: bool = True,
                rng: Optional[torch.Generator] = None):
        if deterministic or self.rate == 0.0:
            return x
        if rng is None:
            raise AkIllegalArgumentException(
                "dropout outside deterministic mode needs a generator")
        keep = 1.0 - self.rate
        if keep == 0.0:
            return torch.zeros_like(x)
        u = torch.rand(x.shape, generator=rng, device=x.device)
        return torch.where(u < keep, x / keep, torch.zeros((), dtype=x.dtype,
                                                             device=x.device))


class SelfAttention(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.cfg = cfg
        hd = cfg.hidden_size
        self.qkv = Dense(hd, 3 * hd, cfg.dtype)   # rows: q, k, v
        self.out = Dense(hd, hd, cfg.dtype)

    def forward(self, x, mask):
        c = self.cfg
        b, s, _ = x.shape
        h = c.num_heads
        d = c.hidden_size // h
        q, k, v = self.qkv(x).view(b, s, 3, h, d).unbind(dim=2)
        if c.use_ring_attention:
            o = ring_attention(q, k, v, mask)
        elif c.attention_block_size:
            o = blockwise_attention(q, k, v, mask,
                                    block_size=c.attention_block_size)
        else:
            o = full_attention(q, k, v, mask)
        return self.out(o.reshape(b, s, h * d))


class TransformerLayer(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.attention = SelfAttention(cfg)
        self.ln_att = LayerNorm(cfg.hidden_size, cfg.dtype)
        self.mlp_in = Dense(cfg.hidden_size, cfg.intermediate_size, cfg.dtype)
        self.mlp_out = Dense(cfg.intermediate_size, cfg.hidden_size, cfg.dtype)
        self.ln_mlp = LayerNorm(cfg.hidden_size, cfg.dtype)
        self.dropout = Dropout(cfg.dropout)

    def forward(self, x, mask, deterministic: bool = True,
                rng: Optional[torch.Generator] = None):
        a = self.dropout(self.attention(x, mask), deterministic, rng)
        x = self.ln_att(x + a)
        f = F.gelu(self.mlp_in(x), approximate="tanh")
        f = self.dropout(self.mlp_out(f), deterministic, rng)
        return self.ln_mlp(x + f)


def _replayed_layer(layer, x, mask, deterministic, rng, rng_state):
    """``layer`` under ``checkpoint``: the generator is set back to the
    layer's starting state, so the recomputation draws the same masks."""
    if rng is not None:
        rng.set_state(rng_state)
    return layer(x, mask, deterministic, rng)


class TransformerEncoder(nn.Module):
    """BERT-style encoder + pooled classification/regression head."""

    def __init__(self, cfg: BertConfig):
        super().__init__()
        if cfg.pool not in ("mean", "cls"):
            raise AkIllegalArgumentException(f"unknown pool {cfg.pool!r}")
        self.cfg = cfg
        hd, dt = cfg.hidden_size, cfg.dtype
        self.tok_emb = Embed(cfg.vocab_size, hd, dt)
        self.pos_emb = Embed(cfg.max_position, hd, dt)
        self.type_emb = Embed(cfg.type_vocab_size, hd, dt)
        self.ln_emb = LayerNorm(hd, dt)
        self.dropout = Dropout(cfg.dropout)
        self.layers = nn.ModuleList(
            TransformerLayer(cfg) for _ in range(cfg.num_layers))
        self.pooler = Dense(hd, hd, dt)
        self.head = Dense(hd, 1 if cfg.regression else cfg.num_labels,
                          torch.float32)

    def init_weights(self, seed: int) -> "TransformerEncoder":
        """Redraws every parameter from flax's default initialisers (see
        :class:`Dense`, :class:`Embed`, :class:`LayerNorm`) with a generator
        seeded by ``seed`` on the parameters' device, in module order."""
        g = torch.Generator(device=self.head.weight.device).manual_seed(
            int(seed))
        for mod in self.modules():
            if isinstance(mod, (Dense, Embed, LayerNorm)):
                mod.reset_parameters(g)
        return self

    def forward(self, input_ids, attention_mask=None, token_type_ids=None, *,
                deterministic: bool = True,
                rng: Optional[torch.Generator] = None,
                return_pooled: bool = False, return_sequence: bool = False):
        """Logits (or pooled/sequence states). ``deterministic=False``
        applies dropout with draws from ``rng``."""
        c = self.cfg
        b, s = input_ids.shape
        if attention_mask is None:
            attention_mask = torch.ones((b, s), dtype=torch.int32,
                                        device=input_ids.device)
        pos = torch.arange(s, device=input_ids.device)[None, :]
        x = self.tok_emb(input_ids.long()) + self.pos_emb(pos)
        if token_type_ids is not None:
            x = x + self.type_emb(token_type_ids.long())
        x = self.dropout(self.ln_emb(x), deterministic, rng)
        for layer in self.layers:
            if c.remat and torch.is_grad_enabled():
                state = None if rng is None else rng.get_state()
                x = checkpoint(_replayed_layer, layer, x, attention_mask,
                               deterministic, rng, state, use_reentrant=False,
                               preserve_rng_state=False)
            else:
                x = layer(x, attention_mask, deterministic, rng)
        if return_sequence:
            return x.float()
        if c.pool == "cls":
            pooled = x[:, 0]
        else:  # masked mean-pool, in the compute dtype as in the reference
            m = attention_mask.to(x.dtype)[:, :, None]
            pooled = (x * m).sum(dim=1) / torch.clamp(m.sum(dim=1), min=1.0)
        pooled = torch.tanh(self.pooler(pooled))
        if return_pooled:
            return pooled.float()
        return self.head(pooled)


# ---------------------------------------------------------------------------
# KerasSequential
# ---------------------------------------------------------------------------

_LAYER_RE = re.compile(r"^\s*([A-Za-z_][A-Za-z0-9_]*)\s*(?:\((.*)\))?\s*$")
_ACTIVATIONS = ("relu", "sigmoid", "tanh", "softmax", "gelu", "elu")


def _parse_val(s: str):
    s = s.strip().strip("'\"")
    try:
        return int(s)
    except ValueError:
        pass
    try:
        return float(s)
    except ValueError:
        pass
    if s.lower() in ("true", "false"):
        return s.lower() == "true"
    return s


def _parse_args(argstr: str) -> Tuple[List[Any], dict]:
    args, kwargs = [], {}
    for piece in (argstr or "").split(","):
        piece = piece.strip()
        if not piece:
            continue
        if "=" in piece:
            k, v = piece.split("=", 1)
            kwargs[k.strip()] = _parse_val(v.strip())
        else:
            args.append(_parse_val(piece))
    return args, kwargs


def parse_layers(specs: Sequence[str]) -> List[Tuple[str, list, dict]]:
    """Parse "Dense(64)" style layer specs into ``(name, args, kwargs)``
    (the reference's grammar; names case-insensitive)."""
    out = []
    for spec in specs:
        m = _LAYER_RE.match(spec)
        if not m:
            raise AkIllegalArgumentException(f"bad layer spec: {spec!r}")
        out.append((m.group(1).lower(), *_parse_args(m.group(2) or "")))
    return out


def activation(name: str, x):
    """flax's activations by name; gelu is the tanh form (``nn.gelu``'s
    default)."""
    name = name.lower()
    if name == "relu":
        return F.relu(x)
    if name == "sigmoid":
        return torch.sigmoid(x)
    if name == "tanh":
        return torch.tanh(x)
    if name == "softmax":
        return torch.softmax(x, dim=-1)
    if name == "gelu":
        return F.gelu(x, approximate="tanh")
    if name == "elu":
        return F.elu(x)
    raise AkIllegalArgumentException(f"unknown activation {name!r}")


def _lecun_(w, fan_in: int, generator):
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=generator)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` (momentum 0.99, epsilon 1e-5): statistics over
    every axis but the last, with the fast variance ``max(0, E[x²] −
    E[x]²)``, the biased batch variance. Training mode normalizes by the
    batch's statistics and moves the running ``mean``/``var`` buffers;
    deterministic mode uses the buffers."""

    MOMENTUM, EPS = 0.99, 1e-5

    def __init__(self, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def reset_parameters(self, generator=None):
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()
            self.mean.zero_()
            self.var.fill_(1.0)

    def forward(self, x, deterministic: bool = True):
        if deterministic:
            mean, var = self.mean, self.var
        else:
            axes = tuple(range(x.dim() - 1))
            xf = x.float()
            mean = xf.mean(axes)
            var = torch.clamp((xf * xf).mean(axes) - mean * mean, min=0.0)
            with torch.no_grad():
                m = self.MOMENTUM
                self.mean.copy_(m * self.mean + (1 - m) * mean)
                self.var.copy_(m * self.var + (1 - m) * var)
        return (x - mean) * (torch.rsqrt(var + self.EPS) * self.weight) \
            + self.bias


class Conv1D(nn.Module):
    """flax ``nn.Conv`` over (N, L, C) with padding ``SAME``: the kernel
    (out, in, k) is flax's (k, in, out); a cross-correlation, as
    ``lax.conv_general_dilated``. Fresh: lecun_normal on fan-in k·in."""

    def __init__(self, in_ch: int, filters: int, kernel: int, stride: int):
        super().__init__()
        self.kernel, self.stride = kernel, stride
        self.weight = nn.Parameter(torch.empty(filters, in_ch, kernel))
        self.bias = nn.Parameter(torch.zeros(filters))

    def reset_parameters(self, generator=None):
        with torch.no_grad():
            _lecun_(self.weight, self.weight.shape[1] * self.kernel,
                    generator)
            self.bias.zero_()

    def out_len(self, length: int) -> int:
        return -(-length // self.stride)

    def forward(self, x):
        length = x.shape[1]
        pad = max((self.out_len(length) - 1) * self.stride + self.kernel
                  - length, 0)
        y = F.pad(x.transpose(1, 2), (pad // 2, pad - pad // 2))
        return F.conv1d(y, self.weight, self.bias,
                        stride=self.stride).transpose(1, 2)


class _Kernel(nn.Module):
    """One of a flax RNN cell's dense kernels: ``weight`` (out, in) is the
    transposed flax kernel, with a ``bias`` where flax gives the cell one."""

    def __init__(self, in_f: int, out_f: int, bias: bool, orthogonal: bool):
        super().__init__()
        self.orthogonal = orthogonal
        self.weight = nn.Parameter(torch.empty(out_f, in_f))
        self.bias = nn.Parameter(torch.zeros(out_f)) if bias else None

    def reset_parameters(self, generator=None):
        with torch.no_grad():
            if self.orthogonal:
                nn.init.orthogonal_(self.weight, generator=generator)
            else:
                _lecun_(self.weight, self.weight.shape[1], generator)
            if self.bias is not None:
                self.bias.zero_()


class LSTMCell(nn.Module):
    """flax ``OptimizedLSTMCell``: input kernels ``ii, if, ig, io`` without
    bias, recurrent kernels ``hi, hf, hg, ho`` with bias (orthogonal init);
    gates ``σ(h·Kh + b + x·Ki)`` with g through tanh, ``c' = f·c + i·g``,
    ``h' = o·tanh(c')``, from a zero carry."""

    GATES = "ifgo"

    def __init__(self, in_f: int, units: int):
        super().__init__()
        self.units = units
        for g in self.GATES:
            self.add_module(f"i{g}", _Kernel(in_f, units, False, False))
            self.add_module(f"h{g}", _Kernel(units, units, True, True))

    def forward(self, x):
        U = self.units
        gi = [getattr(self, f"i{g}") for g in self.GATES]
        gh = [getattr(self, f"h{g}") for g in self.GATES]
        xi = F.linear(x, torch.cat([k.weight for k in gi]))
        wh = torch.cat([k.weight for k in gh])
        bh = torch.cat([k.bias for k in gh])
        h = x.new_zeros(x.shape[0], U)
        c = x.new_zeros(x.shape[0], U)
        outs = []
        for t in range(x.shape[1]):
            z = F.linear(h, wh, bh) + xi[:, t]
            i, f = torch.sigmoid(z[:, :U]), torch.sigmoid(z[:, U:2 * U])
            g, o = torch.tanh(z[:, 2 * U:3 * U]), torch.sigmoid(z[:, 3 * U:])
            c = f * c + i * g
            h = o * torch.tanh(c)
            outs.append(h)
        return torch.stack(outs, 1)


class GRUCell(nn.Module):
    """flax ``GRUCell``: input kernels ``ir, iz, in`` with bias, recurrent
    ``hr, hz`` without and ``hn`` with bias (orthogonal init);
    ``r = σ(ir(x) + hr(h))``, ``z = σ(iz(x) + hz(h))``,
    ``n = tanh(in(x) + r·hn(h))``, ``h' = (1 − z)·n + z·h``."""

    def __init__(self, in_f: int, units: int):
        super().__init__()
        self.units = units
        for g in "rzn":
            self.add_module(f"i{g}", _Kernel(in_f, units, True, False))
            self.add_module(f"h{g}", _Kernel(units, units, g == "n", True))

    def forward(self, x):
        U = self.units
        ki = [getattr(self, f"i{g}") for g in "rzn"]
        xi = F.linear(x, torch.cat([k.weight for k in ki]),
                      torch.cat([k.bias for k in ki]))
        wh = torch.cat([getattr(self, f"h{g}").weight for g in "rzn"])
        h = x.new_zeros(x.shape[0], U)
        outs = []
        for t in range(x.shape[1]):
            hh = F.linear(h, wh)
            xr, xz, xn = xi[:, t, :U], xi[:, t, U:2 * U], xi[:, t, 2 * U:]
            r = torch.sigmoid(xr + hh[:, :U])
            z = torch.sigmoid(xz + hh[:, U:2 * U])
            n = torch.tanh(xn + r * (hh[:, 2 * U:] + self.hn.bias))
            h = (1.0 - z) * n + z * h
            outs.append(h)
        return torch.stack(outs, 1)


class KerasSequential(nn.Module):
    """The reference's KerasSequential: string layer specs + an fp32 Dense
    ``head`` of ``out_dim`` outputs, over inputs of ``in_shape`` (per row;
    flax infers it from the first call, a torch module needs it up front).

    Layers (the reference's, flax 0.12 layouts and defaults): ``Dense(n,
    activation=...)``; ``Relu``, ``Sigmoid``, ``Tanh``, ``Softmax``, ``Gelu``
    (tanh form), ``Elu``; ``Dropout(rate=0.5)`` from the step's generator;
    ``BatchNorm`` (:class:`BatchNorm`); ``LayerNorm`` (epsilon 1e-6, fast
    variance); ``Flatten``; ``Reshape(...)``; ``Conv1D(filters, kernel=3,
    strides=1, activation=...)`` (padding SAME); ``MaxPool1D(w=2)`` (window
    and stride w, VALID); ``GlobalAvgPool1D``; ``LSTM(units)`` and
    ``GRU(units)`` (``return_sequences``, else the last step). Submodules
    carry flax's names (``dense_<i>``, ``norm_<i>``, ``conv_<i>``,
    ``OptimizedLSTMCell_<n>``, ``GRUCell_<n>``, ``head``), so the state dict
    maps leaf by leaf onto the reference's variables. An unknown layer
    raises."""

    def __init__(self, layer_specs: Sequence[str], out_dim: int = 1,
                 in_shape: "int | Sequence[int]" = 1):
        super().__init__()
        self.layer_specs = tuple(layer_specs)
        shape = (int(in_shape),) if isinstance(in_shape, int) \
            else tuple(int(s) for s in in_shape)
        self.plan: List[Tuple[str, Optional[str], list, dict]] = []
        cells = {"lstm": 0, "gru": 0}
        for i, (name, args, kwargs) in enumerate(
                parse_layers(self.layer_specs)):
            mod = None
            if name == "dense":
                mod = f"dense_{i}"
                self.add_module(mod, Dense(shape[-1], int(args[0]),
                                           torch.float32))
                shape = shape[:-1] + (int(args[0]),)
            elif name in _ACTIVATIONS + ("flatten", "globalavgpool1d"):
                if name == "flatten":
                    shape = (math.prod(shape),)
                elif name == "globalavgpool1d":
                    shape = shape[1:]
            elif name == "dropout":
                args = [float(args[0]) if args else 0.5]
            elif name in ("batchnorm", "batchnormalization"):
                mod = f"norm_{i}"
                self.add_module(mod, BatchNorm(shape[-1]))
            elif name in ("layernorm", "layernormalization"):
                mod = f"norm_{i}"
                self.add_module(mod, LayerNorm(shape[-1], torch.float32))
            elif name == "reshape":
                shape = tuple(int(a) for a in args)
            elif name == "conv1d":
                mod = f"conv_{i}"
                conv = Conv1D(shape[-1], int(args[0]),
                              int(args[1]) if len(args) > 1 else 3,
                              int(kwargs.get("strides", 1)))
                self.add_module(mod, conv)
                shape = (conv.out_len(shape[0]), int(args[0]))
            elif name == "maxpool1d":
                args = [int(args[0]) if args else 2]
                shape = (shape[0] // args[0], shape[1])
            elif name in ("lstm", "gru"):
                cls = LSTMCell if name == "lstm" else GRUCell
                mod = f"{'OptimizedLSTMCell' if name == 'lstm' else 'GRUCell'}" \
                    f"_{cells[name]}"
                cells[name] += 1
                self.add_module(mod, cls(shape[-1], int(args[0])))
                seq = bool(kwargs.get("return_sequences"))
                shape = (shape[0], int(args[0])) if seq else (int(args[0]),)
            else:
                raise AkIllegalArgumentException(f"unknown layer: {name!r}")
            act = kwargs.get("activation")
            if act and str(act).lower() not in _ACTIVATIONS:
                raise AkIllegalArgumentException(
                    f"unknown activation {act!r}")
            self.plan.append((name, mod, args, kwargs))
        self.head = Dense(shape[-1], int(out_dim), torch.float32)

    def init_weights(self, seed: int) -> "KerasSequential":
        """Redraws every parameter from flax's default initialisers
        (lecun_normal kernels, orthogonal recurrent kernels, zero biases,
        unit norm scales; running mean 0 and variance 1) with a generator
        seeded by ``seed``, in module order."""
        g = torch.Generator(device=self.head.weight.device).manual_seed(
            int(seed))
        for mod in self.modules():
            if isinstance(mod, (Dense, LayerNorm, BatchNorm, Conv1D,
                                _Kernel)):
                mod.reset_parameters(g)
        return self

    def forward(self, x, *, deterministic: bool = True,
                rng: Optional[torch.Generator] = None):
        for name, mod, args, kwargs in self.plan:
            m = getattr(self, mod) if mod else None
            if name in ("dense", "conv1d"):
                x = m(x)
                if kwargs.get("activation"):
                    x = activation(kwargs["activation"], x)
            elif name in _ACTIVATIONS:
                x = activation(name, x)
            elif name == "dropout":
                x = Dropout(args[0])(x, deterministic, rng)
            elif name in ("batchnorm", "batchnormalization"):
                x = m(x, deterministic)
            elif name in ("layernorm", "layernormalization"):
                x = m(x)
            elif name == "flatten":
                x = x.reshape(x.shape[0], -1)
            elif name == "reshape":
                x = x.reshape((x.shape[0],) + tuple(int(a) for a in args))
            elif name == "maxpool1d":
                x = F.max_pool1d(x.transpose(1, 2), args[0],
                                 args[0]).transpose(1, 2)
            elif name == "globalavgpool1d":
                x = x.mean(dim=1)
            else:  # lstm, gru
                x = m(x)
                if not kwargs.get("return_sequences"):
                    x = x[:, -1, :]
        return self.head(x)
