"""Per-feature binned histogram: the CUDA kernel's wrapper and its plain
PyTorch version.

Port of ``alink_tpu/tree/pallas_hist.py::pallas_histogram``:
``out[s, f] = Σ_n vals[n]·(ids[n, f] == s)`` for ``s`` in ``[0, S)``; ids
outside that range add nothing. The forest's level program
(:mod:`~alink_tpu_torch.tree.grow`) calls it three times per level, for
g, h and the counts, with ``ids = node·B + bin``.

The kernel (``csrc/tree_histogram.cu``) runs on CUDA tensors; the plain
version :func:`histogram_ref` runs on CPU tensors and is what the kernel is
held against on the card. :func:`histogram` takes the plain version only
because its tensors lie on the CPU: for CUDA tensors it launches the kernel
or raises.
"""

from __future__ import annotations

import torch

from ..native import kernels


def histogram_ref(ids: torch.Tensor, vals: torch.Tensor, *,
                  num_segments: int) -> torch.Tensor:
    """Plain version: one masked ``index_add_`` over the flat index
    ``ids·d + f``. ids: (n, d) integer; vals: (n,) fp32. Returns
    (num_segments, d) fp32; ids outside ``[0, num_segments)`` add nothing."""
    n, d = ids.shape
    ids = ids.long()
    ok = (ids >= 0) & (ids < num_segments)
    flat = torch.where(ok, ids * d + torch.arange(d, device=ids.device), 0)
    v = torch.where(ok, vals.float()[:, None], 0.0)
    out = torch.zeros(num_segments * d, dtype=torch.float32,
                      device=ids.device)
    out.index_add_(0, flat.reshape(-1), v.reshape(-1))
    return out.view(num_segments, d)


def histogram(ids: torch.Tensor, vals: torch.Tensor, *,
              num_segments: int) -> torch.Tensor:
    """``(num_segments, d)`` histogram of ``vals`` over ``ids`` (see the
    module docstring).

    CPU tensors take :func:`histogram_ref`; CUDA tensors launch the
    hand-written kernel, which is built on first use and takes contiguous
    int32 ids (n, d) and fp32 vals (n,), raising on anything else."""
    if ids.device.type == "cpu":
        return histogram_ref(ids, vals, num_segments=num_segments)
    out = kernels.ops().tree_histogram(ids, vals, int(num_segments))
    kernels.count_launch("tree_histogram")
    return out
