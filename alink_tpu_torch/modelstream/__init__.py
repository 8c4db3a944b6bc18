"""Continuous model streaming: exactly-once stream-train → serve
publishing with crash-safe hot-swap (port of ``alink_tpu.modelstream``).

:mod:`.store` holds the on-disk commit protocol and :mod:`.publisher` the
barrier hook that commits a version and swaps it into a ``ModelServer`` or
a ``ServingFleet``.
"""

from .publisher import ModelStreamPublisher, modelstream_summary
from .store import ModelStreamStore

__all__ = ["ModelStreamPublisher", "ModelStreamStore",
           "modelstream_summary"]
