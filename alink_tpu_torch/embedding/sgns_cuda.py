"""SGNS block gradients: the CUDA kernel's wrappers and their plain PyTorch
versions.

Port of ``alink_tpu/embedding/sgns_pallas.py::sgns_block_grads``. One call
computes the skip-gram negative-sampling gradients of one block of B center
rows of the sharded trainer (:mod:`~alink_tpu_torch.embedding.skipgram`):

- ``g_pos = σ(v·u_pos) − 1`` and ``g_n = σ(v·u_n)`` per row;
- ``grad_v = g_pos·u_pos + Σ_n g_n·u_n``, (B, D);
- ``grad_u = concat(g_pos·v, g_n·v)`` with the negatives b-major,
  ((negs+1)·B, D): the id order ``concat(ctx, neg.reshape(-1))`` that the
  push consumes.

Two entries launch the one kernel (``csrc/sgns_block_grads.cu``):

- :func:`sgns_pull_grads`, the trainer's step: the APS pull of the block's
  rows (hot ids from the cache replica) and the gradients in one launch,
  the pulled rows never written to device memory;
- :func:`sgns_block_grads`, the TPU kernel's own signature: the pulled rows
  given.

Each runs on CUDA tensors; its plain version (:func:`sgns_pull_grads_ref`,
:func:`sgns_block_grads_ref`) runs on CPU tensors and is what the kernel is
held against on the card. A wrapper takes the plain version only because its
tensors lie on the CPU: for CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from typing import Optional

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
    fp32 tensors of any width D, raising on anything else."""
    if v.device.type == "cpu":
        return sgns_block_grads_ref(v, u_pos, u_neg)
    out = kernels.ops().sgns_block_grads(v, u_pos, u_neg)
    kernels.count_launch("sgns_block_grads")
    return out


def pull_rows(win: torch.Tensor, w_ctx: torch.Tensor, center: torch.Tensor,
              uids: torch.Tensor, *, negs: int, rows: int, hot: int,
              rep_in: Optional[torch.Tensor] = None,
              rep_ctx: Optional[torch.Tensor] = None):
    """The one-rank pull of a step: ``center`` (B,) from ``win`` and
    ``uids`` ((negs+1)·B,) from ``w_ctx``, through the hot cache when
    ``hot > 0`` (:func:`~alink_tpu_torch.parallel.hotcache.pull_cached`),
    else :func:`~alink_tpu_torch.parallel.aps.pull`. An id in ``[0, hot)``
    reads the replica, one in ``[0, rows)`` the table, any other a zero row.
    Returns ``(v, u_pos, u_neg, hits)``: the rows (B, D), (B, D) and
    (B, negs, D), and the batch's cache hits as a 0-dim device tensor (None
    when ``hot == 0``)."""
    from ..parallel.aps import pull
    from ..parallel.hotcache import pull_cached
    from ..parallel.mesh import AXIS_MODEL

    B, D = center.shape[0], win.shape[1]
    hits = None
    if hot > 0:
        v, h1 = pull_cached(win, rep_in, center, AXIS_MODEL, rows, hot)
        u, h2 = pull_cached(w_ctx, rep_ctx, uids, AXIS_MODEL, rows, hot)
        hits = h1 + h2
    else:
        v = pull(win, center, AXIS_MODEL, rows)
        u = pull(w_ctx, uids, AXIS_MODEL, rows)
    return v, u[:B], u[B:].reshape(B, negs, D), hits


def sgns_pull_grads_ref(win: torch.Tensor, w_ctx: torch.Tensor,
                        center: torch.Tensor, uids: torch.Tensor, *,
                        negs: int, rows: int, hot: int,
                        rep_in: Optional[torch.Tensor] = None,
                        rep_ctx: Optional[torch.Tensor] = None,
                        hits: Optional[torch.Tensor] = None):
    """Plain version of the trainer's step between the ids and the push:
    :func:`pull_rows`, then :func:`sgns_block_grads_ref`; with ``hot > 0``
    the batch's cache hits are added to ``hits`` in place. Returns
    ``(grad_v, grad_u)``."""
    v, u_pos, u_neg, n_hot = pull_rows(win, w_ctx, center, uids, negs=negs,
                                       rows=rows, hot=hot, rep_in=rep_in,
                                       rep_ctx=rep_ctx)
    if n_hot is not None:
        hits += n_hot
    return sgns_block_grads_ref(v, u_pos, u_neg)


def sgns_pull_grads(win: torch.Tensor, w_ctx: torch.Tensor,
                    center: torch.Tensor, uids: torch.Tensor, *, negs: int,
                    rows: int, hot: int,
                    rep_in: Optional[torch.Tensor] = None,
                    rep_ctx: Optional[torch.Tensor] = None,
                    hits: Optional[torch.Tensor] = None):
    """The trainer's pull and SGNS gradients in one call (see
    :func:`pull_rows` and :func:`sgns_pull_grads_ref`).

    CPU tensors take the plain version; CUDA tensors launch the hand-written
    kernel once, built on first use: contiguous fp32 tables (rows, D) with
    any D, int64 ids, and when ``hot > 0`` the (hot, D) replicas and a
    0-dim int64 ``hits`` on the card, raising on anything else."""
    if win.device.type == "cpu":
        return sgns_pull_grads_ref(win, w_ctx, center, uids, negs=negs,
                                   rows=rows, hot=hot, rep_in=rep_in,
                                   rep_ctx=rep_ctx, hits=hits)
    out = kernels.ops().sgns_pull_grads(win, w_ctx, center, uids, rep_in,
                                        rep_ctx, hits, int(negs), int(rows),
                                        int(hot))
    kernels.count_launch("sgns_block_grads")
    return out
