"""Axis names and world size (port of the part of
``alink_tpu.parallel.mesh`` that the embedding slice needs).

The reference names the axes of a ``jax.sharding.Mesh``; here an axis is
the world of ``torch.distributed`` ranks, of size 1 when no process group
is initialised (one card).
"""

from __future__ import annotations

AXIS_DATA = "data"
AXIS_MODEL = "model"


def axis_size(axis: str = AXIS_MODEL) -> int:
    """Ranks along ``axis``: the ``torch.distributed`` world size when a
    process group is initialised, else 1."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def pad_to_multiple(n: int, k: int) -> int:
    """Rows pad to a multiple of the axis size (even shards)."""
    return ((n + k - 1) // k) * k


class DeviceMesh:
    """The port's one-rank device handle where the reference hands a user
    script the session's ``jax.sharding.Mesh``: the session's torch device
    along the data axis."""

    axis_names = (AXIS_DATA,)

    def __init__(self, device):
        self.device = device
        self.devices = [device]

    @property
    def size(self) -> int:
        return len(self.devices)

    def __repr__(self) -> str:
        return f"DeviceMesh({self.device}, axis_names={self.axis_names})"
