"""Device-resident staging cache + wire-precision policy (port of
``alink_tpu.common.staging``).

Reference analog: the comqueue session cache
(core/src/main/java/com/alibaba/alink/common/comqueue/SessionSharedObjs.java:158
``cachePartitionedData`` — partitioned data staged once and reused across
supersteps within a job). The cache spans jobs: repeated
``collect()``/``link_from`` over the same table does not re-push the same
block host->device.

Keys: the reference keys its cache by a blake2b digest of the whole block,
taken on the host at every staging call. Here the key is the block's
identity, and only a block that nothing can write while it lives is
cached: a read-only array that owns its memory (MTable's memoized feature
blocks are such, see ``MTable.to_numeric_block``). Its entry is dropped
when the block is collected. Any other block is pushed as it is, on every
call. A digest of a 60,000 × 784 float32 block takes longer on the host
than the push it would save (``chip_smoke.py`` phase 11 times both).

Wire precision, ``ALINK_WIRE_PRECISION``:

- ``"auto"`` (default) and ``"fp32"``: exact fp32. The reference's auto
  downcasts only on a measured-slow tunnel to a TPU; a card's local wire
  is not one;
- ``"bf16"``: float32 blocks are cast to bfloat16 on the host (halving
  wire bytes), shipped, and upcast to float32 on the device, so compute
  keeps fp32 accumulation.

``ALINK_STAGING_CACHE_BYTES`` sets the cap (0 disables the cache); the
default is min(2 GiB, 12% of the card's memory).

Tensors are mutable where JAX arrays are not: every caller of the cache
shares one device copy, so nothing may write into a staged tensor.
"""

from __future__ import annotations

import threading
import warnings
import weakref
from collections import OrderedDict
from typing import Any, Tuple

import numpy as np

from .env import env_raw, env_str

_DEFAULT_MAX_BYTES = 2 * 1024 * 1024 * 1024
_HBM_FRACTION = 0.12


def _device_default_cap(device) -> int:
    """min(2 GiB, 12% of the device's memory); the flat default on the CPU."""
    import torch

    if device.type != "cuda":
        return _DEFAULT_MAX_BYTES
    total = torch.cuda.get_device_properties(device).total_memory
    return min(_DEFAULT_MAX_BYTES, int(total * _HBM_FRACTION))


class _Stats:
    __slots__ = ("hits", "misses", "uncached", "wire_bytes_sent",
                 "wire_bytes_saved", "evictions")

    def __init__(self):
        self.hits = 0
        self.misses = 0
        self.uncached = 0         # pushes of blocks the cache cannot key
        self.wire_bytes_sent = 0
        self.wire_bytes_saved = 0
        self.evictions = 0

    def as_dict(self):
        return {k: getattr(self, k) for k in self.__slots__}


class StagingCache:
    """LRU cache of device-resident tensors keyed by the host block's
    identity plus the placement (device, padding, wire policy); eviction
    is LRU by device bytes."""

    def __init__(self):
        self._lock = threading.RLock()
        self._entries: "OrderedDict[Tuple, Any]" = OrderedDict()
        self._bytes = 0
        self.stats = _Stats()

    # -- config ------------------------------------------------------------
    @staticmethod
    def max_bytes(device) -> int:
        raw = env_raw("ALINK_STAGING_CACHE_BYTES")
        if raw is not None:
            try:
                return int(raw)  # any <= 0 disables the cache
            except ValueError:
                pass  # malformed tuning knob: fall back, never crash
        return _device_default_cap(device)

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._bytes = 0

    # -- core --------------------------------------------------------------
    def get(self, key: Tuple):
        with self._lock:
            if key in self._entries:
                self._entries.move_to_end(key)
                self.stats.hits += 1
                return self._entries[key][0]
            self.stats.misses += 1
            return None

    def put(self, key: Tuple, value, device, owner=None) -> None:
        """Keep ``value`` under ``key``; with ``owner``, the host block the
        key names by id, drop it when ``owner`` is collected, before its id
        can name another block."""
        cap = self.max_bytes(device)
        if cap <= 0:
            return
        nbytes = value.element_size() * value.nelement()
        with self._lock:
            if key in self._entries:
                return
            self._entries[key] = (value, nbytes)
            self._bytes += nbytes
            while self._bytes > cap and self._entries:
                _, (_, nb) = self._entries.popitem(last=False)
                self._bytes -= nb
                self.stats.evictions += 1
        if owner is not None:
            weakref.finalize(owner, self.drop, key)

    def drop(self, key: Tuple) -> None:
        with self._lock:
            entry = self._entries.pop(key, None)
            if entry is not None:
                self._bytes -= entry[1]

    def note(self, sent: int = 0, saved: int = 0, uncached: int = 0) -> None:
        with self._lock:
            self.stats.wire_bytes_sent += sent
            self.stats.wire_bytes_saved += saved
            self.stats.uncached += uncached

    def stats_dict(self):
        with self._lock:
            d = self.stats.as_dict()
            d["resident_bytes"] = self._bytes
            d["resident_entries"] = len(self._entries)
            return d


_cache = StagingCache()


def staging_cache_stats() -> dict:
    return _cache.stats_dict()


def clear_staging_cache() -> None:
    _cache.clear()
    _cache.stats = _Stats()


# ---------------------------------------------------------------------------
# Wire precision policy
# ---------------------------------------------------------------------------

def wire_precision() -> str:
    return env_str("ALINK_WIRE_PRECISION", "auto").lower()


def _wire_downcast(arr: np.ndarray) -> bool:
    """Whether ``arr`` rides the bf16 wire: only float32 blocks, and only
    under the explicit ``bf16`` policy. float64 stays full precision, and
    the upcast on the device restores the caller's dtype."""
    return wire_precision() == "bf16" and arr.dtype == np.float32


def _to_device(arr: np.ndarray, device):
    """One host→device push under the wire policy."""
    import torch

    with warnings.catch_warnings():
        # a read-only block (MTable's memoized feature blocks are) is never
        # written through: the staged tensor is always a copy
        warnings.simplefilter("ignore", UserWarning)
        host = torch.from_numpy(np.ascontiguousarray(arr))
    if _wire_downcast(arr):
        wire = host.to(torch.bfloat16)             # cast on the host
        out = wire.to(device).to(host.dtype)       # upcast on the device
        _cache.note(sent=wire.nbytes, saved=host.nbytes - wire.nbytes)
        return out
    _cache.note(sent=host.nbytes)
    return host.to(device, copy=True)


def _canonical(arr) -> np.ndarray:
    """The reference stages without 64-bit types (JAX's default): float64
    blocks land as float32 and int64 as int32; so do they here."""
    arr = np.asarray(arr)
    if arr.dtype == np.float64:
        return arr.astype(np.float32)
    if arr.dtype == np.int64:
        return arr.astype(np.int32)
    return arr


def _frozen(arr: np.ndarray) -> bool:
    """Whether nothing can write ``arr``'s bytes while it lives: read-only,
    and owning its memory (a read-only view of a writable base is not)."""
    return not arr.flags.writeable and arr.flags.owndata


# ---------------------------------------------------------------------------
# Staging entry points
# ---------------------------------------------------------------------------

def _staged(kind: str, arr: np.ndarray, device, pad_rows_to=None):
    """``arr`` (zero-padded to ``pad_rows_to`` rows) on ``device``: from the
    cache when ``arr`` is frozen, else pushed. The padding is made on the
    device: the host copies and sends only ``arr``'s own rows."""
    def push():
        out = _to_device(arr, device)
        if pad_rows_to is not None and pad_rows_to != arr.shape[0]:
            padded = out.new_zeros((pad_rows_to,) + tuple(out.shape[1:]))
            padded[:arr.shape[0]] = out
            out = padded
        return out

    if not _frozen(arr):
        _cache.note(uncached=1)
        return push()
    key = (kind, id(arr), str(device), pad_rows_to,
           "bf16" if _wire_downcast(arr) else "fp32")
    out = _cache.get(key)
    if out is None:
        out = push()
        _cache.put(key, out, device, owner=arr)
    return out


def stage_sharded(arr: np.ndarray, device, num_shards: int = 1, *,
                  with_mask: bool = False):
    """Stage ``arr`` row-sharded over ``num_shards`` ranks, via the cache.
    Dim 0 pads to the next multiple of the shard count. Returns the
    tensor, or ``(tensor, mask)`` when ``with_mask`` — the mask is 1.0 for
    real rows."""
    import torch

    arr = _canonical(arr)
    n = arr.shape[0]
    pad_rows_to = -(-max(n, num_shards) // num_shards) * num_shards
    out = _staged("rows", arr, device, pad_rows_to)
    if not with_mask:
        return out
    mdtype = arr.dtype if arr.dtype.kind == "f" else np.dtype(np.float32)
    mkey = ("mask", n, pad_rows_to, mdtype.str, str(device))
    mask = _cache.get(mkey)
    if mask is None:
        host = np.zeros(pad_rows_to, dtype=mdtype)
        host[:n] = 1.0
        mask = torch.from_numpy(host).to(device)
        _cache.note(sent=host.nbytes)
        _cache.put(mkey, mask, device)
    return out, mask


def stage_replicated(arr: np.ndarray, device, pad_rows_to=None):
    """Stage ``arr`` whole on ``device`` (every rank's copy), via the
    cache; with ``pad_rows_to``, zero-padded to that many rows."""
    return _staged("repl", _canonical(arr), device, pad_rows_to)


def push_block(arr: np.ndarray, device):
    """Push ``arr`` to ``device`` under the wire policy, bypassing the
    cache: for one-off blocks such as a prediction's row chunks."""
    _cache.note(uncached=1)
    return _to_device(_canonical(arr), device)
