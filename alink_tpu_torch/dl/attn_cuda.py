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
