""".ak model/table file format.

Capability parity with the reference's .ak format (reference:
core/src/main/java/com/alibaba/alink/common/io/filesystem/AkUtils.java:52-110,
AkStream.java:28-165 — a zip archive holding a JSON meta entry plus
row-serialized partition entries).

This is a copy of ``alink_tpu.io.ak``; every path opens through the
scheme-dispatched filesystem (``io/filesystem.py``: local paths,
``file://``, ``memory://`` and registered schemes). Files written by either
package read in the other.

Re-design: same envelope (zip + ``alink_meta.json``), columnar payload — each
partition is an npz of column arrays (object columns via their string codecs)
instead of Kryo row bytes. Partition entries allow large tables to be written
in chunks and read lazily.
"""

from __future__ import annotations

import json
import zipfile
from typing import List, Optional

from ..common.exceptions import AkParseErrorException
from ..common.mtable import MTable
from .filesystem import file_open

META_ENTRY = "alink_meta.json"
DATA_PREFIX = "data/part-"
FORMAT_VERSION = 1

# zipfile stamps each member with current localtime by default, which makes
# two writes of the same table differ byte-for-byte. The .ak contract is
# content-deterministic (modelstream republishes after a crash must be
# bit-identical to the fault-free write), so every entry carries this fixed
# epoch instead.
ZIP_EPOCH = (1980, 1, 1, 0, 0, 0)


def _write_zip_entry(zf: zipfile.ZipFile, name: str, data) -> None:
    zi = zipfile.ZipInfo(name, date_time=ZIP_EPOCH)
    zi.compress_type = zipfile.ZIP_DEFLATED
    zf.writestr(zi, data)


def write_ak(path: str, table: MTable, num_partitions: int = 1, extra_meta: Optional[dict] = None):
    n = table.num_rows
    num_partitions = max(1, min(num_partitions, max(1, n)))
    bounds = [round(i * n / num_partitions) for i in range(num_partitions + 1)]
    with file_open(path, "wb") as fobj, \
            zipfile.ZipFile(fobj, "w", compression=zipfile.ZIP_DEFLATED) as zf:
        metas: List[str] = []
        for p in range(num_partitions):
            import numpy as np

            part = table.take(np.arange(bounds[p], bounds[p + 1]))
            data, meta = part.to_payload()
            _write_zip_entry(zf, f"{DATA_PREFIX}{p:05d}", data)
            metas.append(meta)
        header = {
            "version": FORMAT_VERSION,
            "schema": table.schema.to_str(),
            "num_partitions": num_partitions,
            "num_rows": n,
            "partition_meta": metas,
        }
        if extra_meta:
            header["extra"] = extra_meta
        _write_zip_entry(zf, META_ENTRY, json.dumps(header))


def read_ak(path: str) -> MTable:
    with file_open(path, "rb") as fobj, zipfile.ZipFile(fobj, "r") as zf:
        try:
            header = json.loads(zf.read(META_ENTRY))
        except KeyError:
            raise AkParseErrorException(f"{path} is not an .ak file (no {META_ENTRY})")
        parts = []
        for p in range(header["num_partitions"]):
            data = zf.read(f"{DATA_PREFIX}{p:05d}")
            parts.append(MTable.from_payload(data, header["partition_meta"][p]))
    return MTable.concat(parts) if len(parts) > 1 else parts[0]


def read_ak_meta(path: str) -> dict:
    with file_open(path, "rb") as fobj, zipfile.ZipFile(fobj, "r") as zf:
        return json.loads(zf.read(META_ENTRY))
