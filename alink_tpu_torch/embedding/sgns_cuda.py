"""SGNS block gradients: the CUDA kernel's wrapper and its plain PyTorch
version.

Port of ``alink_tpu/embedding/sgns_pallas.py::sgns_block_grads``. One call
computes the skip-gram negative-sampling gradients of one block of B center
rows, between the APS pull and push of the sharded trainer
(:mod:`~alink_tpu_torch.embedding.skipgram`):

- ``g_pos = σ(v·u_pos) − 1`` and ``g_n = σ(v·u_n)`` per row;
- ``grad_v = g_pos·u_pos + Σ_n g_n·u_n``, (B, D);
- ``grad_u = concat(g_pos·v, g_n·v)`` with the negatives b-major,
  ((negs+1)·B, D): the id order ``concat(ctx, neg.reshape(-1))`` that the
  push consumes.

The kernel (``csrc/sgns_block_grads.cu``) runs on CUDA tensors; the plain
version :func:`sgns_block_grads_ref` runs on CPU tensors and is what the
kernel is held against on the card. :func:`sgns_block_grads` takes the plain
version only because its tensors lie on the CPU: for CUDA tensors it launches
the kernel or raises.
"""

from __future__ import annotations

import torch

from ..common.env import kernel_knob_on
from ..native import kernels

SGNS_KERNEL_ENV = "ALINK_SGNS_PALLAS"


def use_sgns_kernel() -> bool:
    """The opt-out knob ``ALINK_SGNS_PALLAS``: a falsey value routes the
    trainer's step to the plain version, for debugging only."""
    return kernel_knob_on(SGNS_KERNEL_ENV)


def sgns_block_grads_ref(v: torch.Tensor, u_pos: torch.Tensor,
                         u_neg: torch.Tensor):
    """Plain version: the reference's ``skipgram._block_grads`` arithmetic.
    v, u_pos: (B, D); u_neg: (B, negs, D), fp32. Returns ``(grad_v,
    grad_u)`` as in the module docstring. The dot products are elementwise
    products summed, never a matrix product, so no TF32 can enter."""
    D = v.shape[-1]
    s_pos = torch.sigmoid((v * u_pos).sum(-1))                  # (B,)
    s_neg = torch.sigmoid((v[:, None, :] * u_neg).sum(-1))      # (B, N)
    g_pos = (s_pos - 1.0)[:, None]
    g_neg = s_neg[..., None]
    grad_v = g_pos * u_pos + (g_neg * u_neg).sum(1)
    grad_u = torch.cat([g_pos * v, (g_neg * v[:, None, :]).reshape(-1, D)])
    return grad_v, grad_u


def sgns_block_grads(v: torch.Tensor, u_pos: torch.Tensor,
                     u_neg: torch.Tensor):
    """SGNS gradients of one block (see the module docstring).

    CPU tensors take :func:`sgns_block_grads_ref`; CUDA tensors launch the
    hand-written kernel, which is built on first use and takes contiguous
    fp32 tensors with D ≤ 1024, raising on anything else."""
    if v.device.type == "cpu":
        return sgns_block_grads_ref(v, u_pos, u_neg)
    out = kernels.ops().sgns_block_grads(v, u_pos, u_neg)
    kernels.count_launch("sgns_block_grads")
    return out
