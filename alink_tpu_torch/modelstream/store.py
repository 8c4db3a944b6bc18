"""Crash-safe model version store — the persistence half of the
stream-train → serve loop (port of ``alink_tpu.modelstream.store``).

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

The store lives on any scheme the filesystem layer speaks
(``io/filesystem.py``: local paths, ``file://``, ``memory://``, registered
schemes); an unregistered scheme raises
:class:`~alink_tpu_torch.common.exceptions.AkPluginNotExistException`.
fsync applies to local files; on another store durability is the store's
close contract (counted in ``modelstream.fsync_skipped``).
"""

from __future__ import annotations

import json
import os
import zlib
from typing import Callable, Dict, List, Optional, Tuple

from ..common.env import env_int
from ..common.exceptions import AkIllegalArgumentException
from ..common.faults import maybe_fail
from ..common.metrics import metrics
from ..io.filesystem import LocalFileSystem, get_file_system

MANIFEST_VERSION = 1
_PREFIX = "v-"


def _fsync(fs, path: str) -> None:
    """fsync a closed file of a local store; elsewhere durability is the
    store's close contract."""
    if not isinstance(fs, LocalFileSystem):
        metrics.incr("modelstream.fsync_skipped")
        return
    fd = os.open(LocalFileSystem._strip(path), os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _durable_write(fs, path: str, data: bytes) -> None:
    """Write-tmp → fsync → rename: the bytes are on disk before the name
    exists, so a reader never sees a half-written file and a rename that
    survived power loss implies the payload did too (copy of
    ``alink_tpu.common.recovery._durable_write``)."""
    tmp = path + ".tmp"
    with fs.open(tmp, "wb") as f:
        f.write(data)
    _fsync(fs, tmp)
    fs.rename(tmp, path)


def _crc_file(fs, path: str) -> Tuple[int, int]:
    crc, nbytes = 0, 0
    with fs.open(path, "rb") as f:
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
        self._fs = get_file_system(path)
        self.path = os.path.abspath(LocalFileSystem._strip(path)) \
            if isinstance(self._fs, LocalFileSystem) else path
        self._fs.makedirs(self.path)
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
        return self._fs.join(self.path, f"{_PREFIX}{epoch:012d}.ak")

    def sidecar_path(self, epoch: int) -> str:
        return self.blob_path(epoch) + ".warmup.json"

    def manifest_path(self, epoch: int) -> str:
        return self._fs.join(self.path, f"{_PREFIX}{epoch:012d}.json")

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
        _fsync(self._fs, tmp)
        crc, nbytes = _crc_file(self._fs, tmp)
        self._fs.rename(tmp, blob)
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
        _durable_write(self._fs, self.manifest_path(epoch),
                       json.dumps(manifest).encode())
        metrics.incr("modelstream.commits")
        self.retain()
        return blob

    # -- scanner-style readout ----------------------------------------------
    def _read_manifest(self, epoch: int) -> Optional[Dict]:
        p = self.manifest_path(epoch)
        if not self._fs.exists(p):
            return None
        try:
            with self._fs.open(p, "rb") as f:
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
        if not self._fs.isdir(self.path):
            return out
        for name in self._fs.listdir(self.path):
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
                crc, nbytes = _crc_file(self._fs, blob)
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
                    if self._fs.exists(p):
                        self._fs.delete(p)
                except OSError:
                    metrics.incr("modelstream.retain_errors")
            self._torn_seen.discard(epoch)
