"""Flash attention: the CUDA kernel's wrappers and their plain PyTorch
versions.

Port of ``alink_tpu/dl/attn_pallas.py::flash_block_update``. One block
update applies one online-softmax accumulation step over one K/V block, with
the exact accumulator semantics of
``alink_tpu/dl/attention._online_softmax_update``: fp32 ``o``/``m``/``l``,
masked scores pinned to the finite ``-1e30``, and the
``exp(max(m - m_new, -1e30))`` correction that lets a later block erase what
a fully masked one added.

Two entries launch the kernel (``csrc/flash_block_update.cu``):

- :func:`flash_blockwise`, the whole attention call of
  ``blockwise_attention``'s kernel route: every K/V block in one launch, q,
  k and v read in place in the ``(B, S, H, D)`` layout;
- :func:`flash_block_update`, one block with a carried state (the ring
  body's step).

Each counts one launch. Their plain versions :func:`flash_blockwise_ref` and
:func:`flash_block_update_ref` run on CPU tensors and are what the kernel is
held against on the card. A wrapper takes its plain version only because
its tensors lie on the CPU: for CUDA tensors it launches the kernel or
raises.

:func:`flash_attention` is :func:`flash_blockwise` with a gradient: a
``torch.autograd.Function`` whose forward is the wrapper (the kernel for
CUDA tensors) and whose backward is :func:`flash_blockwise_bwd`, the
FlashAttention backward in plain PyTorch from q, k, v, the mask, the output
and the rows' softmax statistics, which it recomputes. The
Pallas kernel has no backward of its own (the reference differentiates its
knob-off scan), so neither does the CUDA kernel; the backward launches no
kernel of the port and counts nothing.
"""

from __future__ import annotations

import torch

from ..native import kernels

NEG_INF = -1e30


def flash_block_update_ref(q, k, v, kvalid, qk_ok, o, m, l, *, scale: float):
    """Plain version of the block update, in the kernel's layout.

    q: (B, H, Q, D); k, v: (B, H, K, D); kvalid: (B, K), 1 = valid key;
    qk_ok: (Q, K), 1 = allowed; o: (B, H, Q, D), m and l: (B, H, Q), fp32.
    Returns the updated ``(o, m, l)``. With bf16 inputs the score and p·v
    products come out in bf16 and p is rounded to bf16 before p·v, as in the
    reference (``torch.einsum`` on bf16 returns bf16)."""
    s = torch.einsum("bhqd,bhkd->bhqk", q, k).float() * scale
    s = torch.where(kvalid[:, None, None, :] > 0, s, NEG_INF)
    s = torch.where(qk_ok[None, None] > 0, s, NEG_INF)
    m_new = torch.maximum(m, s.amax(dim=-1))
    corr = torch.exp(torch.clamp(m - m_new, min=NEG_INF))
    p = torch.exp(s - m_new[..., None])
    l_new = l * corr + p.sum(dim=-1)
    pv = torch.einsum("bhqk,bhkd->bhqd", p.to(q.dtype), v).float()
    return o * corr[..., None] + pv, m_new, l_new


def flash_blockwise_ref(q, k, v, kmask, *, block_size: int, causal: bool,
                        scale: float):
    """Plain version of the fused call: :func:`flash_block_update_ref` once
    per K/V block, then ``o / max(l, 1e-30)`` in q's dtype.

    q: (B, Sq, H, D); k, v: (B, Sk, H, D); kmask: (B, Sk), 1 = valid key, or
    None. K/V are zero-padded to whole blocks with their keys masked, as in
    the reference: on a fully masked row those keys count in l."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    nb = -(-sk // block_size)
    pad = nb * block_size - sk
    dev = q.device
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    kmask = (torch.ones((b, sk), dtype=torch.int32, device=dev)
             if kmask is None else kmask.to(torch.int32))
    kmask = torch.nn.functional.pad(kmask, (0, pad))
    qf = q.transpose(1, 2)
    kb = k.reshape(b, nb, block_size, h, d).permute(1, 0, 3, 2, 4)
    vb = v.reshape(b, nb, block_size, h, d).permute(1, 0, 3, 2, 4)
    mb = kmask.reshape(b, nb, block_size).transpose(0, 1)
    q_pos = torch.arange(sq, device=dev)
    ok = torch.ones((sq, block_size), dtype=torch.int32, device=dev)
    o = torch.zeros((b, h, sq, d), dtype=torch.float32, device=dev)
    m = torch.full((b, h, sq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, h, sq), dtype=torch.float32, device=dev)
    for i in range(nb):
        if causal:
            k_pos = i * block_size + torch.arange(block_size, device=dev)
            ok = (q_pos[:, None] >= k_pos[None, :]).to(torch.int32)
        o, m, l = flash_block_update_ref(qf, kb[i], vb[i], mb[i], ok, o, m, l,
                                         scale=scale)
    l = torch.clamp(l, min=1e-30)
    return (o / l[..., None]).transpose(1, 2).to(q.dtype)


def flash_blockwise(q, k, v, kmask, *, block_size: int, causal: bool,
                    scale: float):
    """The whole blockwise attention call in one launch (see
    :func:`flash_blockwise_ref` for shapes and semantics).

    CPU tensors take :func:`flash_blockwise_ref`; CUDA tensors launch the
    hand-written kernel, built on first use, which reads q, k and v in place
    by strides: the head dim must have stride 1 and, for bfloat16, every
    other stride must be 16-byte aligned. q/k/v in float32 or bfloat16; it
    raises on anything else."""
    if q.device.type == "cpu":
        return flash_blockwise_ref(q, k, v, kmask, block_size=block_size,
                                   causal=causal, scale=scale)
    km = None if kmask is None else kmask.to(torch.int32).contiguous()
    out = kernels.ops().flash_blockwise(q, k, v, km, int(block_size),
                                        bool(causal), float(scale))
    kernels.count_launch("flash_block_update")
    return out


BWD_CHUNK_ELEMS = 1 << 26   # score elements of a query chunk (256 MB fp32)


def flash_blockwise_bwd(q, k, v, kmask, out, dout, *, block_size: int,
                        causal: bool, scale: float):
    """The gradient of :func:`flash_blockwise_ref`'s function: ``(dq, dk,
    dv)`` in q's layout and dtype, from the inputs, the output ``out`` and
    its cotangent ``dout`` (both (B, Sq, H, D)).

    With P = exp(s − m) / l over the keys zero-padded to whole blocks (s
    masked to -1e30 as in the forward; m and l each row's max and sum,
    recomputed): dV = Pᵀ·dO; dS = P∘(dO·Vᵀ − rowsum(dO∘O)), zero where the
    score was masked; dQ = dS·K·scale and dK = dSᵀ·Q·scale. So masked
    scores carry no gradient to q and k, a fully masked row (m = -1e30)
    spreads 1/l over every key of every block, the ragged last block's
    padded keys included, and, in bf16, P and dS are rounded to bf16 before
    their products, as p is before p·v in the forward.

    The rows are taken in chunks of queries against all keys, at most
    ``BWD_CHUNK_ELEMS`` scores a chunk: each row's statistics come from one
    pass over its scores, the products are batched over (B, H), and dK and
    dV are summed over the chunks in fp32."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    skp = -(-sk // block_size) * block_size
    dev, dt = q.device, q.dtype
    kh, vh = (torch.nn.functional.pad(x, (0, 0, 0, 0, 0, skp - sk))
              .transpose(1, 2).contiguous() for x in (k, v))   # (B, H, K, D)
    kmask = (torch.ones((b, sk), dtype=torch.int32, device=dev)
             if kmask is None else kmask.to(torch.int32))
    valid = torch.nn.functional.pad(kmask, (0, skp - sk))[:, None, None, :] > 0
    k_pos = torch.arange(skp, device=dev)
    rows = max(1, BWD_CHUNK_ELEMS // max(1, b * h * skp))
    rows = -(-sq // -(-sq // rows))          # even chunks
    dq = torch.empty((b, sq, h, d), dtype=dt, device=dev)
    dk = torch.zeros((b, h, skp, d), dtype=torch.float32, device=dev)
    dv = torch.zeros_like(dk)
    for c0 in range(0, sq, rows):
        c1 = min(sq, c0 + rows)
        qc, oc, doc = (x[:, c0:c1].transpose(1, 2) for x in (q, out, dout))
        doc = doc.to(dt)
        masked = ~valid
        if causal:
            masked = masked | (torch.arange(c0, c1, device=dev)[:, None]
                               < k_pos[None, :])
        # in place where it can be: each pass over the (B, H, rows, K)
        # scores costs as much as the products
        s = torch.matmul(qc, kh.transpose(-1, -2)).float().mul_(scale)
        p = torch.softmax(s.masked_fill_(masked, NEG_INF), dim=-1)
        del s
        dv += torch.matmul(p.to(dt).transpose(-1, -2), doc).float()
        dsum = (doc.float() * oc.float()).sum(dim=-1, keepdim=True)
        ds = torch.matmul(doc, vh.transpose(-1, -2)).float()
        ds = ds.sub_(dsum).mul_(p).masked_fill_(masked, 0.0).mul_(scale)
        ds = ds.to(dt)
        del p
        dq[:, c0:c1] = torch.matmul(ds, kh).transpose(1, 2)
        dk += torch.matmul(ds.transpose(-1, -2), qc).float()
    return (dq, dk[:, :, :sk].transpose(1, 2).to(dt),
            dv[:, :, :sk].transpose(1, 2).to(dt))


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, kmask, block_size, causal, scale):
        out = flash_blockwise(q, k, v, kmask, block_size=block_size,
                              causal=causal, scale=scale)
        ctx.save_for_backward(q, k, v, kmask, out)
        ctx.args = dict(block_size=block_size, causal=causal, scale=scale)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, kmask, out = ctx.saved_tensors
        dq, dk, dv = flash_blockwise_bwd(q, k, v, kmask, out, dout,
                                         **ctx.args)
        return dq, dk, dv, None, None, None, None


def flash_attention(q, k, v, kmask, *, block_size: int, causal: bool,
                    scale: float):
    """:func:`flash_blockwise` (one kernel launch for CUDA tensors) with
    :func:`flash_blockwise_bwd` as its gradient."""
    return _FlashAttention.apply(q, k, v, kmask, int(block_size),
                                 bool(causal), float(scale))


def flash_block_update(q, k, v, kvalid, qk_ok, o, m, l, *, scale: float):
    """One online-softmax step over a K/V block (see the module docstring).

    CPU tensors take :func:`flash_block_update_ref`; CUDA tensors launch the
    hand-written kernel with one block, built on first use. It takes the
    dtypes documented on :func:`flash_block_update_ref`, q/k/v in float32 or
    bfloat16 with the layout rules of :func:`flash_blockwise`, the other
    tensors contiguous, and raises on anything else."""
    if q.device.type == "cpu":
        return flash_block_update_ref(q, k, v, kvalid, qk_ok, o, m, l,
                                      scale=scale)
    out = kernels.ops().flash_block_update(q, k, v, kvalid, qk_ok, o, m, l,
                                           float(scale))
    kernels.count_launch("flash_block_update")
    return out
