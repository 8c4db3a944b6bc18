"""Crash-safe model version store — the persistence half of the
stream-train → serve loop (port of ``alink_tpu.modelstream.store``, on the
local filesystem).

Every version is three files and the manifest rename is the ONE atomic
commit point::

    <dir>/v-000000000007.ak              # model blob (PipelineModel .ak)
    <dir>/v-000000000007.ak.warmup.json  # serving warmup sidecar
    <dir>/v-000000000007.json            # manifest — the atomic commit

Write order is blob → sidecar → manifest, each fsync'd tmp+rename, so a
crash at ANY point leaves either (a) debris with no manifest — readers
skip it (``modelstream.torn_skipped``) and the retry overwrites it
bit-identically (.ak serialization is content-deterministic), or (b) a
fully durable committed version. A reader that sees the manifest is
guaranteed a complete blob + sidecar underneath it.

Retention keeps the last K committed versions (``ALINK_MODELSTREAM_KEEP``);
``latest()`` / ``versions()`` give late-joining serving replicas the
scanner-style readout.

The store lives on a local (or locally mounted) path; ``file://`` is
accepted. Other schemes (``hdfs://``, ``oss://``, …) raise
:class:`~alink_tpu_torch.common.exceptions.AkUnsupportedOperationException`
until the scheme-dispatched ``io/filesystem.py`` is ported (ROADMAP A1).
"""

from __future__ import annotations

import json
import os
import zlib
from typing import Callable, Dict, List, Optional, Tuple

from ..common.env import env_int
from ..common.exceptions import (AkIllegalArgumentException,
                                 AkUnsupportedOperationException)
from ..common.faults import maybe_fail
from ..common.metrics import metrics

MANIFEST_VERSION = 1
_PREFIX = "v-"


def _local_path(path: str) -> str:
    if "://" in path:
        scheme, rest = path.split("://", 1)
        if scheme != "file":
            raise AkUnsupportedOperationException(
                f"modelstream store on scheme {scheme!r} ({path}): the "
                "port's stores are local paths until io/filesystem.py's "
                "scheme dispatch is ported (ROADMAP A1)")
        path = rest
    return os.path.abspath(path)


def _durable_write(path: str, data: bytes) -> None:
    """Write-tmp → flush → fsync → rename: the bytes are on disk before the
    name exists, so a reader never sees a half-written file and a rename
    that survived power loss implies the payload did too (copy of
    ``alink_tpu.common.recovery._durable_write``, local files)."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def _crc_file(path: str) -> Tuple[int, int]:
    crc, nbytes = 0, 0
    with open(path, "rb") as f:
        while True:
            chunk = f.read(1 << 20)
            if not chunk:
                break
            crc = zlib.crc32(chunk, crc)
            nbytes += len(chunk)
    return crc & 0xFFFFFFFF, nbytes


class ModelStreamStore:
    """Versioned, crash-safe model directory keyed by training epoch."""

    def __init__(self, path: str, keep: Optional[int] = None):
        if not path:
            raise AkIllegalArgumentException("modelstream store needs a path")
        self.path = _local_path(path)
        os.makedirs(self.path, exist_ok=True)
        self.keep = keep if keep is not None \
            else env_int("ALINK_MODELSTREAM_KEEP", 3)
        if self.keep < 1:
            raise AkIllegalArgumentException(
                f"modelstream keep must be >= 1, got {self.keep}")
        # debris epochs already counted by this reader, so a scan loop
        # doesn't re-count the same torn version forever
        self._torn_seen: set = set()

    # -- layout --------------------------------------------------------------
    def blob_path(self, epoch: int) -> str:
        return os.path.join(self.path, f"{_PREFIX}{epoch:012d}.ak")

    def sidecar_path(self, epoch: int) -> str:
        return self.blob_path(epoch) + ".warmup.json"

    def manifest_path(self, epoch: int) -> str:
        return os.path.join(self.path, f"{_PREFIX}{epoch:012d}.json")

    # -- commit protocol -----------------------------------------------------
    def publish(self, epoch: int,
                write_blob: Callable[[str], None],
                write_sidecar: Optional[Callable[[str, str], None]] = None,
                meta: Optional[Dict] = None) -> str:
        """Commit one model version; returns the blob path.

        ``write_blob(tmp_path)`` must write the full ``.ak`` to the given
        temporary path; ``write_sidecar(blob_path, sidecar_path)``
        (optional) writes the warmup sidecar after the blob is durable (it
        typically hashes the blob's content). Idempotent by epoch: an
        already-committed version is returned untouched, so a restart that
        replays an epoch never rewrites a published model."""
        blob = self.blob_path(epoch)
        if self._read_manifest(epoch) is not None:
            metrics.incr("modelstream.republish_skipped")
            return blob
        maybe_fail("publish", label=f"epoch{epoch}.pre_blob")
        tmp = blob + ".tmp"
        write_blob(tmp)
        fd = os.open(tmp, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)
        crc, nbytes = _crc_file(tmp)
        os.replace(tmp, blob)
        sidecar = None
        if write_sidecar is not None:
            maybe_fail("publish", label=f"epoch{epoch}.pre_sidecar")
            write_sidecar(blob, self.sidecar_path(epoch))
            sidecar = os.path.basename(self.sidecar_path(epoch))
        maybe_fail("publish", label=f"epoch{epoch}.pre_manifest")
        manifest = {
            "version": MANIFEST_VERSION,
            "epoch": int(epoch),
            "blob": os.path.basename(blob),
            "blob_crc32": crc,
            "blob_bytes": nbytes,
            "sidecar": sidecar,
            "meta": meta or {},
        }
        _durable_write(self.manifest_path(epoch),
                       json.dumps(manifest).encode())
        metrics.incr("modelstream.commits")
        self.retain()
        return blob

    # -- scanner-style readout ----------------------------------------------
    def _read_manifest(self, epoch: int) -> Optional[Dict]:
        p = self.manifest_path(epoch)
        if not os.path.exists(p):
            return None
        try:
            with open(p, "rb") as f:
                m = json.loads(f.read())
            if int(m.get("version", 0)) > MANIFEST_VERSION:
                return None
            return m
        except (OSError, ValueError, TypeError, AttributeError):
            return None

    def committed(self, epoch: int) -> bool:
        return self._read_manifest(epoch) is not None

    def _scan_epochs(self) -> Dict[int, Dict[str, bool]]:
        """epoch -> {"manifest": bool, "blob": bool} over the directory."""
        out: Dict[int, Dict[str, bool]] = {}
        if not os.path.isdir(self.path):
            return out
        for name in os.listdir(self.path):
            if not name.startswith(_PREFIX):
                continue
            stem, kind = None, None
            if name.endswith(".json") and not name.endswith(".warmup.json"):
                stem, kind = name[len(_PREFIX):-5], "manifest"
            elif name.endswith(".ak"):
                stem, kind = name[len(_PREFIX):-3], "blob"
            if stem is None or not stem.isdigit():
                continue
            out.setdefault(int(stem), {})[kind] = True
        return out

    def versions(self) -> List[int]:
        """Committed epochs, oldest first (readable manifests only)."""
        scan = self._scan_epochs()
        out = []
        for epoch in sorted(scan):
            if scan[epoch].get("manifest") and \
                    self._read_manifest(epoch) is not None:
                out.append(epoch)
        return out

    def latest(self) -> Optional[Tuple[int, Dict]]:
        """Newest fully-verifiable committed version as ``(epoch,
        manifest)``, skipping (and counting) torn debris — an orphan blob
        with no manifest, an unreadable manifest, or a blob whose bytes no
        longer match the manifest's checksum."""
        scan = self._scan_epochs()
        for epoch in sorted(scan, reverse=True):
            m = self._read_manifest(epoch) if scan[epoch].get("manifest") \
                else None
            if m is None:
                self._count_torn(epoch)
                continue
            blob = self.blob_path(epoch)
            try:
                crc, nbytes = _crc_file(blob)
            except OSError:
                self._count_torn(epoch)
                continue
            if crc != m.get("blob_crc32") or nbytes != m.get("blob_bytes"):
                self._count_torn(epoch)
                continue
            return epoch, m
        return None

    def _count_torn(self, epoch: int) -> None:
        if epoch not in self._torn_seen:
            self._torn_seen.add(epoch)
            metrics.incr("modelstream.torn_skipped")

    # -- retention -----------------------------------------------------------
    def retain(self) -> None:
        """Keep the last ``keep`` committed versions; uncommit (manifest
        first) then delete everything older, debris included."""
        committed = self.versions()
        if len(committed) <= self.keep:
            return
        cutoff = committed[-self.keep]
        scan = self._scan_epochs()
        for epoch in sorted(scan):
            if epoch >= cutoff:
                continue
            # manifest FIRST: a version stops being visible before its
            # bytes disappear, so a concurrent reader never resolves a
            # manifest whose blob was just deleted
            for p in (self.manifest_path(epoch), self.blob_path(epoch),
                      self.sidecar_path(epoch)):
                try:
                    if os.path.exists(p):
                        os.remove(p)
                except OSError:
                    metrics.incr("modelstream.retain_errors")
            self._torn_seen.discard(epoch)
