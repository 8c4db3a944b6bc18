"""Filesystem model stream: timestamped model files (port of
``FileModelStreamSink`` and ``scan_model_dir`` of
``alink_tpu.operator.stream.modelstream``).

Capability parity with the reference's modelstream package (reference:
core/src/main/java/com/alibaba/alink/operator/common/modelstream/
FileModelStreamSink.java (writes <dir>/<timestamp> model dirs atomically) and
ModelStreamFileScanner.java:41-178 (lists newly landed models in timestamp
order)).

A model lands as ONE ``<millis>.ak`` file written via tmp+rename (atomic on
POSIX); the scanner orders by the numeric timestamp in the name. The stream
source over them (``ModelStreamFileSourceStreamOp``) is ROADMAP A7.
"""

from __future__ import annotations

import os
import time
from typing import List, Optional, Tuple

from ...common.mtable import MTable
from ...io.ak import write_ak
from ...io.filesystem import get_file_system


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
