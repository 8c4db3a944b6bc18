"""Filesystem model stream: timestamped model files + scanner source (port
of ``alink_tpu.operator.stream.modelstream``).

Capability parity with the reference's modelstream package (reference:
core/src/main/java/com/alibaba/alink/operator/common/modelstream/
FileModelStreamSink.java (writes <dir>/<timestamp> model dirs atomically) and
ModelStreamFileScanner.java:41-178 (polls the directory, emits newly landed
models in timestamp order) — feeding ModelStreamModelMapperAdapter hot-swap,
common/mapper/ModelMapper.java:71-76).

A model lands as ONE ``<millis>.ak`` file written via tmp+rename (atomic on
POSIX); the scanner orders by the numeric timestamp in the name. The stream
source (``ModelStreamFileSourceStreamOp``) yields each model table as a
micro-batch chunk, so any model-consuming stream op (FtrlPredict hot-swap,
ModelMapStreamOp) can link from it directly.
"""

from __future__ import annotations

import os
import time
from typing import Iterator, List, Optional, Tuple

from ...common.mtable import MTable, TableSchema
from ...common.params import ParamInfo
from ...io.ak import read_ak, write_ak
from ...io.filesystem import get_file_system
from .base import StreamOperator


class FileModelStreamSink:
    """Append models to a stream directory (reference:
    FileModelStreamSink.java)."""

    def __init__(self, path: str):
        self._fs = get_file_system(path)
        self.path = path if "://" in path else os.path.abspath(path)
        self._fs.makedirs(self.path)

    def write(self, model: MTable, timestamp: Optional[int] = None) -> str:
        ts = int(time.time() * 1000) if timestamp is None else int(timestamp)
        final = self._fs.join(self.path, f"{ts}.ak")
        tmp = final + ".tmp"
        write_ak(tmp, model)
        self._fs.rename(tmp, final)  # atomic landing on POSIX; mv elsewhere
        return final


def scan_model_dir(path: str, after: int = -1) -> List[Tuple[int, str]]:
    """(timestamp, file) pairs newer than ``after``, in timestamp order
    (reference: ModelStreamFileScanner.scanToFile)."""
    out = []
    fs = get_file_system(path)
    if not fs.isdir(path):
        return out
    for name in fs.listdir(path):
        if not name.endswith(".ak"):
            continue
        stem = name[:-3]
        if not stem.isdigit():
            continue
        ts = int(stem)
        if ts > after:
            out.append((ts, fs.join(path, name)))
    out.sort()
    return out


class ModelStreamFileSourceStreamOp(StreamOperator):
    """Stream source yielding each landed model table as one chunk. Bounded
    by ``maxModels``/``timeoutMs`` so tests and batch-style replays
    terminate (the reference scanner polls forever)."""

    FILE_PATH = ParamInfo("filePath", str, optional=False)
    POLL_INTERVAL_MS = ParamInfo("pollIntervalMs", int, default=100)
    MAX_MODELS = ParamInfo("maxModels", int, default=0,
                           desc="stop after N models; 0 = until timeout")
    TIMEOUT_MS = ParamInfo("timeoutMs", int, default=1000,
                           desc="stop when no new model lands for this long")

    _max_inputs = 0

    def _stream_impl(self) -> Iterator[MTable]:
        path = self.get(self.FILE_PATH)
        poll_s = self.get(self.POLL_INTERVAL_MS) / 1000.0
        max_models = self.get(self.MAX_MODELS)
        timeout_s = self.get(self.TIMEOUT_MS) / 1000.0
        last_ts = -1
        emitted = 0
        idle_since = time.monotonic()
        while True:
            fresh = scan_model_dir(path, after=last_ts)
            for ts, f in fresh:
                yield read_ak(f)
                last_ts = ts
                emitted += 1
                idle_since = time.monotonic()
                if max_models and emitted >= max_models:
                    return
            if not fresh and time.monotonic() - idle_since > timeout_s:
                return
            if not fresh:
                time.sleep(poll_s)

    def _out_schema(self) -> TableSchema:
        from ...common.model import MODEL_SCHEMA

        return MODEL_SCHEMA
