"""Per-level binned histograms: the CUDA kernel's wrapper and its plain
PyTorch version.

Port of ``alink_tpu/tree/pallas_hist.py::pallas_histogram``:
``out[s, f] = Σ_n vals[n]·(ids[n, f] == s)`` for ``s`` in ``[0, S)``; ids
outside that range add nothing. The reference's level program calls it once
per value channel (g, h, counts) with ``ids = node·B + bin``, ``S = L·B``.
The port takes one level as one call: :func:`level_histograms` gives all
channels' (L, d, B) histograms from the bins and the node vector, and builds
the ids inside the kernel.

The kernel (``csrc/tree_histogram.cu``) runs on CUDA tensors; the plain
version :func:`level_histograms_ref` runs on CPU tensors and is what the
kernel is held against on the card. :func:`level_histograms` takes the plain
version only because its tensors lie on the CPU: for CUDA tensors it
launches the kernel or raises.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from ..native import kernels


def histogram_ref(ids: torch.Tensor, vals: torch.Tensor, *,
                  num_segments: int) -> torch.Tensor:
    """The reference kernel's function: one masked ``index_add_`` over the
    flat index ``ids·d + f``. ids: (n, d) integer; vals: (n,) fp32. Returns
    (num_segments, d) fp32; ids outside ``[0, num_segments)`` add
    nothing."""
    n, d = ids.shape
    ids = ids.long()
    ok = (ids >= 0) & (ids < num_segments)
    flat = torch.where(ok, ids * d + torch.arange(d, device=ids.device), 0)
    v = torch.where(ok, vals.float()[:, None], 0.0)
    out = torch.zeros(num_segments * d, dtype=torch.float32,
                      device=ids.device)
    out.index_add_(0, flat.reshape(-1), v.reshape(-1))
    return out.view(num_segments, d)


def level_histograms_ref(bins: torch.Tensor, node: torch.Tensor,
                         vals: Sequence[torch.Tensor], *, num_nodes: int,
                         num_bins: int) -> Tuple[torch.Tensor, ...]:
    """Plain version: one :func:`histogram_ref` per channel over
    ``ids = node·B + bins`` with ``S = L·B``, each reshaped to (L, d, B).
    bins: (n, d) integer; node: (n,) integer; vals: C (n,) fp32 tensors.
    Returns C contiguous (L, d, B) fp32 tensors."""
    L, B = num_nodes, num_bins
    d = bins.shape[1]
    ids = node.long()[:, None] * B + bins.long()
    return tuple(
        histogram_ref(ids, v, num_segments=L * B).view(L, B, d)
        .permute(0, 2, 1).contiguous() for v in vals)


def level_histograms(bins: torch.Tensor, node: torch.Tensor,
                     vals: Sequence[torch.Tensor], *, num_nodes: int,
                     num_bins: int) -> Tuple[torch.Tensor, ...]:
    """The C ≤ 3 (L, d, B) histograms of one level (see
    :func:`level_histograms_ref`).

    CPU tensors take the plain version; CUDA tensors launch the hand-written
    kernel once, built on first use: contiguous uint8 (or int32) bins (n, d)
    of any width d, int32 node (n,), fp32 vals (n,) and at most 16,384
    nodes, raising on anything else. A
    channel given twice (the forest passes its counts as h and as c) is
    computed once and returned for both: the same values the plain version
    computes twice."""
    if bins.device.type == "cpu":
        return level_histograms_ref(bins, node, vals, num_nodes=num_nodes,
                                    num_bins=num_bins)
    ops = kernels.ops()
    uniq, pick = [], []
    for v in vals:
        same = [i for i, u in enumerate(uniq) if u is v]
        pick.append(same[0] if same else len(uniq))
        if not same:
            uniq.append(v)
    out = ops.tree_histogram(bins, node, uniq, int(num_nodes), int(num_bins))
    kernels.count_launch("tree_histogram")
    return tuple(out[i] for i in pick)
