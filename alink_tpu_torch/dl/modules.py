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

The reference's ``KerasSequential`` is not ported yet.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Optional

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
