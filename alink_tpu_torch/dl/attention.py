"""Attention: full and blockwise (port of ``alink_tpu/dl/attention.py``).

Public functions keep the reference's ``(B, S, H, D)`` layout, so the tests
feed both packages the same arrays.

- :func:`full_attention` is plain torch, as the reference's is plain XLA.
- :func:`blockwise_attention` consumes K/V in blocks under an online softmax
  (a Python loop where the reference has ``lax.scan``). On the kernel route
  it calls :func:`~alink_tpu_torch.dl.attn_cuda.flash_block_update` once per
  block — the hand-written CUDA kernel for CUDA tensors, its plain version
  for CPU tensors. ``ALINK_ATTN_PALLAS=0`` is the reference's opt-out: it
  runs the plain einsum loop instead, on any device (for debugging; a
  failed build or launch never switches routes).
- :func:`ring_attention` (sequence parallelism) is not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..common.env import kernel_knob_on
from ..common.exceptions import AkUnsupportedOperationException
from .attn_cuda import NEG_INF, flash_block_update

ATTN_KERNEL_ENV = "ALINK_ATTN_PALLAS"


def full_attention(q, k, v, mask: Optional[torch.Tensor] = None, *,
                   causal: bool = False) -> torch.Tensor:
    """Standard scaled dot-product attention.

    q, k, v: (B, S, H, D); mask: (B, S) with 1 = valid key. Returns (B, S, H, D).
    """
    d = q.shape[-1]
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / torch.sqrt(
        torch.tensor(float(d), dtype=q.dtype, device=q.device))
    s = s.float()
    if mask is not None:
        s = torch.where(mask[:, None, None, :] > 0, s, NEG_INF)
    if causal:
        sq, sk = q.shape[1], k.shape[1]
        cm = torch.ones((sq, sk), dtype=torch.bool, device=q.device).tril()
        s = torch.where(cm[None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


def _online_softmax_update(o, m, l, s, v, p_dtype):
    """One online-softmax accumulation step over a new score block ``s``
    (B, H, Q, K), in the reference's ``(B, Q, H, D)`` accumulator layout.
    Accumulators o/m/l stay fp32."""
    m_new = torch.maximum(m, s.amax(dim=-1))
    # guard fully-masked rows: exp(-inf - -inf) -> exp(0) must not fire
    corr = torch.exp(torch.clamp(m - m_new, min=NEG_INF))
    p = torch.exp(s - m_new[..., None])
    l = l * corr + p.sum(dim=-1)
    pv = torch.einsum("bhqk,bkhd->bqhd", p.to(p_dtype), v)
    o = o * corr.transpose(1, 2)[..., None] + pv.float()
    return o, m_new, l


def blockwise_attention(q, k, v, mask: Optional[torch.Tensor] = None, *,
                        block_size: int = 512,
                        causal: bool = False) -> torch.Tensor:
    """Memory-efficient attention: the (S, S) score matrix never
    materializes — K/V are consumed in ``block_size`` chunks with the same
    online-softmax update as ring attention.

    q, k, v: (B, S, H, D); mask: (B, S) with 1 = valid key.
    """
    b, sq, h, d = q.shape
    sk = k.shape[1]
    nb = -(-sk // block_size)
    pad = nb * block_size - sk
    dev = q.device
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    # padded keys are always masked off
    kmask = (torch.ones((b, sk), dtype=torch.int32, device=dev)
             if mask is None else mask.to(torch.int32))
    kmask = torch.nn.functional.pad(kmask, (0, pad))
    q_pos = torch.arange(sq, device=dev)

    def block_ok(i):
        k_pos = i * block_size + torch.arange(block_size, device=dev)
        return q_pos[:, None] >= k_pos[None, :]

    if kernel_knob_on(ATTN_KERNEL_ENV):
        # kernel route: (B, H, ...) layout, each block's K/V contiguous
        scale = float(d) ** -0.5
        qf = q.permute(0, 2, 1, 3).contiguous()
        kb = k.reshape(b, nb, block_size, h, d).permute(1, 0, 3, 2, 4).contiguous()
        vb = v.reshape(b, nb, block_size, h, d).permute(1, 0, 3, 2, 4).contiguous()
        mb = kmask.reshape(b, nb, block_size).transpose(0, 1).contiguous()
        ok_all = torch.ones((sq, block_size), dtype=torch.int32, device=dev)
        o = torch.zeros((b, h, sq, d), dtype=torch.float32, device=dev)
        m = torch.full((b, h, sq), NEG_INF, dtype=torch.float32, device=dev)
        l = torch.zeros((b, h, sq), dtype=torch.float32, device=dev)
        for i in range(nb):
            ok = block_ok(i).to(torch.int32) if causal else ok_all
            o, m, l = flash_block_update(qf, kb[i], vb[i], mb[i], ok, o, m, l,
                                         scale=scale)
        l = torch.clamp(l, min=1e-30)
        return (o / l[..., None]).permute(0, 2, 1, 3).to(q.dtype)

    scale = 1.0 / torch.sqrt(torch.tensor(float(d), dtype=torch.float32))
    o = torch.zeros((b, sq, h, d), dtype=torch.float32, device=dev)
    m = torch.full((b, h, sq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, h, sq), dtype=torch.float32, device=dev)
    for i in range(nb):
        blk = slice(i * block_size, (i + 1) * block_size)
        s = torch.einsum("bqhd,bkhd->bhqk", q, k[:, blk]).float() * scale.to(dev)
        s = torch.where(kmask[:, None, None, blk] > 0, s, NEG_INF)
        if causal:
            s = torch.where(block_ok(i)[None, None], s, NEG_INF)
        o, m, l = _online_softmax_update(o, m, l, s, v[:, blk], q.dtype)
    l = torch.clamp(l, min=1e-30)
    return (o / l.transpose(1, 2)[..., None]).to(q.dtype)


def ring_attention(q, k, v, mask=None, *, mesh=None, axis: str = "seq",
                   causal: bool = False):
    """Sequence-parallel attention over a device group: not ported yet."""
    raise AkUnsupportedOperationException(
        "ring_attention is not ported yet (it needs the distributed slice)")
