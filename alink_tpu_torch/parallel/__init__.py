"""Distributed substrate of the port: the BSP iteration engine, the APS
embedding tables and their hot-key cache. The reference's device mesh
becomes the world of ranks, of size 1 on one card."""

from .comqueue import ComContext, IterativeComQueue, shard_rows
from .mesh import AXIS_DATA, AXIS_MODEL, axis_size, pad_to_multiple

__all__ = ["AXIS_DATA", "AXIS_MODEL", "ComContext", "IterativeComQueue",
           "axis_size", "pad_to_multiple", "shard_rows"]
