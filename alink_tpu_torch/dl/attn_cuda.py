"""Flash-attention block update: the CUDA kernel's wrapper and its plain
PyTorch version.

Port of ``alink_tpu/dl/attn_pallas.py::flash_block_update``. One call applies
one online-softmax accumulation step over one K/V block, with the exact
accumulator semantics of ``alink_tpu/dl/attention._online_softmax_update``:
fp32 ``o``/``m``/``l``, masked scores pinned to the finite ``-1e30``, and the
``exp(max(m - m_new, -1e30))`` correction that lets a later block erase what
a fully masked one added.

The kernel (``csrc/flash_block_update.cu``) runs on CUDA tensors; the plain
version :func:`flash_block_update_ref` runs on CPU tensors and is what the
kernel is held against on the card. :func:`flash_block_update` takes the
plain version only because its tensors lie on the CPU: for CUDA tensors it
launches the kernel or raises.
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


def flash_block_update(q, k, v, kvalid, qk_ok, o, m, l, *, scale: float):
    """One online-softmax step over a K/V block (see the module docstring).

    CPU tensors take :func:`flash_block_update_ref`; CUDA tensors launch the
    hand-written kernel, which is built on first use. The kernel takes
    contiguous tensors in the dtypes documented on
    :func:`flash_block_update_ref`, q/k/v in float32 or bfloat16, and raises
    on anything else."""
    if q.device.type == "cpu":
        return flash_block_update_ref(q, k, v, kvalid, qk_ok, o, m, l,
                                      scale=scale)
    out = kernels.ops().flash_block_update(q, k, v, kvalid, qk_ok, o, m, l,
                                           float(scale))
    kernels.count_launch("flash_block_update")
    return out
