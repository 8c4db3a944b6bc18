"""APS analog: model-sharded embedding tables with pull/push (port of
``alink_tpu.parallel.aps``).

The reference's Alink Parameter Server (ApsEnv.java: mini-batch
pull→train→push with the model partitioned by key across tasks) becomes a
(V, D) table on the device, row-sharded over the ranks of the ``model``
axis. The reference routes each pull and push to the shard that owns the id
with fixed-capacity ``all_to_all`` buckets; on one rank every id is owned
here, so:

- **pull(ids)** is a gather; ids outside the table (the hot cache's parked
  sentinel) read back as zero rows;
- **push(ids, grads)** is the per-rank dedup :func:`_dedup_batch` (sorted
  unique ids at a fixed size B, duplicates' grads combined by
  ``index_add_``) followed by a scatter-add of ``-scale·g`` into the owned
  rows, as the reference does on each owner.

More than one rank raises ``NotImplementedError``: the owner-routed bucket
exchange (``all_to_all``, capacity, overflow fallback) comes with the
multi-rank slice (ROADMAP A3).

Nothing here waits on the host: the dedup is a stable sort, first-of-run
flags and a cumulative sum at fixed shapes (``torch.unique`` and boolean-mask
indexing would sync once per call).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from .mesh import AXIS_MODEL, axis_size, pad_to_multiple

# The APS counters (the reference keeps them in its metrics module, which the
# port has not yet): cache hits, misses and evictions, bucket overflows, and
# the huge-engine knob's fallbacks (embedding/engine.py).
counters: Dict[str, int] = dict.fromkeys(
    ("aps.cache_hits", "aps.cache_misses", "aps.cache_evictions",
     "aps.bucket_overflows", "huge.engine_bad_knob"), 0)


def incr(name: str, n: int = 1) -> None:
    counters[name] = counters.get(name, 0) + int(n)


def _single_rank(axis: str, what: str) -> int:
    m = axis_size(axis)
    if m != 1:
        raise NotImplementedError(
            f"{what} over {m} ranks: the owner-routed APS exchange is not "
            f"ported yet (ROADMAP A3)")
    return m


def shard_table(table: np.ndarray, device, axis: str = AXIS_MODEL):
    """Place (V, D) on ``device``, V padded to a multiple of the axis size.
    Returns (tensor, padded_rows)."""
    m = _single_rank(axis, "sharding a table")
    v_pad = pad_to_multiple(table.shape[0], m)
    return torch.as_tensor(np.ascontiguousarray(table), device=device), v_pad


def _dedup_batch(ids: torch.Tensor, grads: torch.Tensor, fill: int):
    """Per-rank dedup: ``uid`` (B,) the sorted unique ids padded with
    ``fill``, ``g`` (B, D) each unique id's grads summed, duplicates in
    batch order (as ``jnp.unique(size=B)`` and ``.at[inv].add`` in the
    reference; on CUDA ``index_add_`` adds duplicates in any order).
    Fixed shapes throughout, so nothing syncs with the host."""
    b = ids.shape[0]
    sorted_ids, order = torch.sort(ids, stable=True)
    first = torch.ones(b, dtype=torch.bool, device=ids.device)
    first[1:] = sorted_ids[1:] != sorted_ids[:-1]
    slot = torch.cumsum(first, 0) - 1            # uid slot of each sorted id
    inv = torch.empty_like(slot).scatter_(0, order, slot)
    # every id of a run writes the same value to its slot
    uid = torch.full((b,), fill, dtype=ids.dtype,
                     device=ids.device).scatter_(0, slot, sorted_ids)
    g = torch.zeros_like(grads).index_add_(0, inv, grads)
    return uid, g


def _scatter_add(table: torch.Tensor, uid: torch.Tensor, g: torch.Tensor,
                 rows: int, scale) -> torch.Tensor:
    """``table[uid] += -scale·g`` in place for the ids in ``[0, rows)``; the
    others (dedup padding, foreign rows) are dropped. Dropped slots add
    ``-0.0`` to row 0, which changes no value, so every owned row's update
    holds exactly its own contribution. ``scale`` is an fp32 value."""
    ok = (uid >= 0) & (uid < rows)
    upd = torch.where(ok[:, None], g * -scale, -0.0)
    return table.index_add_(0, torch.where(ok, uid, 0), upd)


def pull(table_l: torch.Tensor, ids: torch.Tensor, axis: str,
         rows_per_shard: int, *, slack: Optional[float] = None,
         cap: Optional[int] = None) -> torch.Tensor:
    """The rows of ``ids`` (B,) from the table, (B, D); ids outside the
    table read back as zero rows. ``slack`` and ``cap`` size the
    reference's exchange buckets and change nothing on one rank."""
    _single_rank(axis, "pull")
    idx = ids.clamp(0, rows_per_shard - 1)
    return torch.where((idx == ids)[:, None], table_l[idx], 0.0)


def push(table_l: torch.Tensor, ids: torch.Tensor, grads: torch.Tensor,
         axis: str, rows_per_shard: int, scale=1.0, *,
         slack: Optional[float] = None) -> torch.Tensor:
    """Apply ``-scale·grads`` for ``ids`` to the table, in place: per-rank
    dedup, then one scatter-add into the owned rows. Returns the table."""
    m = _single_rank(axis, "push")
    uid, g = _dedup_batch(ids, grads, m * rows_per_shard)
    return _scatter_add(table_l, uid, g, rows_per_shard, scale)


def apply_gathered_replicated(table: torch.Tensor, ids: torch.Tensor,
                              grads: torch.Tensor, axis: str, num_rows: int,
                              scale) -> torch.Tensor:
    """Replicated-table twin of :func:`push`, the host engine's update:
    per-rank dedup, then (the reference's ``all_gather`` of every rank's
    deduped batch is the identity on one rank) a scatter-add of every id in
    ``[0, num_rows)``. Each row gets the same add sequence as through
    :func:`push`, so the two engines evolve bit-identically on the CPU."""
    _single_rank(axis, "apply_gathered_replicated")
    uid, g = _dedup_batch(ids, grads, num_rows)
    return _scatter_add(table, uid, g, num_rows, scale)


def aps_summary() -> dict:
    """The APS counters: cache hits, misses, evictions and hit rate, bucket
    overflows."""
    hits = counters["aps.cache_hits"]
    misses = counters["aps.cache_misses"]
    return {
        "cache_hits": hits,
        "cache_misses": misses,
        "cache_evictions": counters["aps.cache_evictions"],
        "cache_hit_rate": round(hits / (hits + misses), 4)
        if hits + misses else None,
        "bucket_overflows": counters["aps.bucket_overflows"],
    }


class ShardedEmbedding:
    """Handle of a model-sharded (V, D) fp32 table on the device.

    The table stays on the device between training calls (the reference's
    APS keeps the model in task memory); ``to_numpy()`` is the final
    persist. The reference's default init, ``(U[0, 1) − 0.5) / D`` from
    ``seed``, is drawn with numpy, so both packages start from the same
    bits."""

    def __init__(self, vocab_size: int, dim: int,
                 init: Optional[Callable[[np.random.Generator],
                                         np.ndarray]] = None,
                 seed: int = 0, *, device=None, axis: str = AXIS_MODEL):
        from ..common.env import resolve_device

        self.axis = axis
        self.vocab_size = vocab_size
        self.dim = dim
        rng = np.random.default_rng(seed)
        table = (init(rng) if init is not None
                 else ((rng.random((vocab_size, dim)) - 0.5) / dim)
                 .astype(np.float32))
        self.array, self.padded_rows = shard_table(
            np.asarray(table, np.float32), resolve_device(device), axis)
        self.rows_per_shard = self.padded_rows // axis_size(axis)

    @staticmethod
    def from_numpy(table: np.ndarray, *, device=None,
                   axis: str = AXIS_MODEL) -> "ShardedEmbedding":
        """A handle holding a copy of ``table`` (V, D)."""
        table = np.asarray(table, np.float32)
        return ShardedEmbedding(table.shape[0], table.shape[1],
                                init=lambda rng: table, device=device,
                                axis=axis)

    def to_numpy(self) -> np.ndarray:
        return np.array(self.array[:self.vocab_size].cpu())

    def save(self, path: str):
        """Persist the table as a ``.ak`` model file, in the reference's
        layout (meta ``ShardedEmbedding`` with ``vocabSize``/``dim``, one
        array ``table``): either package loads the other's."""
        from ..common.model import model_to_table
        from ..io.ak import write_ak

        meta = {"modelName": "ShardedEmbedding",
                "vocabSize": self.vocab_size, "dim": self.dim}
        write_ak(path, model_to_table(meta, {"table": self.to_numpy()}))

    @staticmethod
    def load(path: str, *, device=None,
             axis: str = AXIS_MODEL) -> "ShardedEmbedding":
        """Restore a saved table onto ``device``."""
        from ..common.model import table_to_model
        from ..io.ak import read_ak

        meta, arrays = table_to_model(read_ak(path))
        handle = ShardedEmbedding.from_numpy(arrays["table"], device=device,
                                             axis=axis)
        if (handle.vocab_size, handle.dim) != (meta["vocabSize"],
                                               meta["dim"]):
            from ..common.exceptions import AkIllegalDataException

            raise AkIllegalDataException(
                f"{path}: table {arrays['table'].shape} disagrees with its "
                f"meta ({meta['vocabSize']}, {meta['dim']})")
        return handle
