"""DirectReader / DataBridge: read model tables outside any job (port of
``alink_tpu.io.directreader``; host code).

Capability parity with the reference (reference:
core/src/main/java/com/alibaba/alink/common/io/directreader/
DirectReader.java, DataBridge.java:13, LocalFileDataBridge.java,
MemoryDataBridge.java — stream predict loads batch-trained models through
this indirection, and LocalPredictor uses it to serve without a cluster).

The bridge is the serving-side handle to a trained model: memory-backed
(an MTable or a finished train op) or file-backed (.ak). ``DirectReader
.read`` normalizes any of those into the model MTable."""

from __future__ import annotations

import os
from typing import Union

from ..common.exceptions import AkIllegalArgumentException
from ..common.mtable import MTable


class DataBridge:
    """Abstract model-rows source (reference: DataBridge.java)."""

    def read(self) -> MTable:
        raise NotImplementedError


class MemoryDataBridge(DataBridge):
    """(reference: MemoryDataBridge.java)"""

    def __init__(self, table: MTable):
        self._table = table

    def read(self) -> MTable:
        return self._table


class LocalFileDataBridge(DataBridge):
    """.ak file-backed bridge (reference: LocalFileDataBridge.java)."""

    def __init__(self, path: str):
        self.path = os.path.abspath(path)

    def read(self) -> MTable:
        from .ak import read_ak

        return read_ak(self.path)


class DirectReader:
    """Normalize any model reference into its MTable (reference:
    DirectReader.java collect + the BatchOperator/DataBridge overloads)."""

    @staticmethod
    def to_bridge(ref) -> DataBridge:
        if isinstance(ref, DataBridge):
            return ref
        if isinstance(ref, MTable):
            return MemoryDataBridge(ref)
        if isinstance(ref, str):
            return LocalFileDataBridge(ref)
        if hasattr(ref, "collect"):  # a (possibly unexecuted) train op
            return MemoryDataBridge(ref.collect())
        raise AkIllegalArgumentException(
            f"cannot build a DataBridge from {type(ref).__name__}")

    @staticmethod
    def read(ref) -> MTable:
        return DirectReader.to_bridge(ref).read()
