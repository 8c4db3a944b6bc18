"""Hot-key embedding cache over the APS pull/push (port of
``alink_tpu.parallel.hotcache``).

``build_vocab`` sorts the vocabulary most frequent first and the APS shards
rows contiguously, so the Zipf-hot rows are the table prefix ``[0, hot)``,
all owned by shard 0. The cache is a replica of that prefix on every rank:

- **pull**: ids ``< hot`` gather from the replica (counted as hits); cold
  ids go through :func:`~alink_tpu_torch.parallel.aps.pull` (the
  reference sizes the cold remainder's exchange buckets from the empirical
  tail mass; one rank has no exchange);
- **push** is unchanged; :func:`refresh_hot` then copies the owner's updated
  prefix into the replica.

On one rank the replica is a copy of rows the rank owns, so the cache
changes no value: cached and uncached pulls return the same bits. The hit
count stays on the device; the trainer reads it once per call
(:func:`note_cache_traffic`).

Knob: ``ALINK_APS_HOT_ROWS`` = ``auto`` (default: 0 for vocabularies under
64, else ``min(1024, V/4)``, clamped to the rows per shard) | row count.
"""

from __future__ import annotations

from typing import Optional

import torch

from .aps import incr, pull

_AUTO_MIN_VOCAB = 64
_AUTO_MAX_ROWS = 1024


def resolve_hot_rows(explicit: Optional[int], vocab_size: int,
                     rows_per_shard: int) -> int:
    """Effective hot-set size: explicit argument > ``ALINK_APS_HOT_ROWS`` >
    auto heuristic; always clamped to ``[0, rows_per_shard]`` (the hot
    prefix must sit inside shard 0)."""
    if explicit is None:
        from ..common.env import env_raw

        raw = env_raw("ALINK_APS_HOT_ROWS")
        if raw is not None and raw.strip().lower() not in ("", "auto"):
            try:
                explicit = int(raw)
            except ValueError:
                explicit = None  # malformed tuning knob: fall back to auto
    if explicit is None:
        explicit = (0 if vocab_size < _AUTO_MIN_VOCAB
                    else min(_AUTO_MAX_ROWS, vocab_size // 4))
    return max(0, min(int(explicit), int(rows_per_shard)))


def refresh_hot(table_l: torch.Tensor, axis: str, hot: int) -> torch.Tensor:
    """The replica of shard 0's first ``hot`` rows: a copy, bit for bit."""
    return refresh_hot_many((table_l,), axis, hot)[0]


def refresh_hot_many(tables, axis: str, hot: int):
    """:func:`refresh_hot` for several tables (the SGNS step refreshes both
    embedding replicas)."""
    from .aps import _single_rank

    _single_rank(axis, "refresh_hot")
    return tuple(t[:hot].clone() for t in tables)


def pull_cached(table_l: torch.Tensor, replica: torch.Tensor,
                ids: torch.Tensor, axis: str, rows_per_shard: int, hot: int,
                *, cap: Optional[int] = None, slack: Optional[float] = None):
    """Pull with hot ids served from the replica. Returns ``(rows, n_hot)``:
    ``rows`` the same bits as an uncached :func:`pull` of ``ids``, ``n_hot``
    the batch's cache hits as a 0-dim device tensor. Hot ids go to the cold
    pull as the out-of-table sentinel ``M·rows``, which reads nothing."""
    from .mesh import axis_size

    is_hot = (ids >= 0) & (ids < hot)
    sentinel = axis_size(axis) * rows_per_shard
    cold = pull(table_l, torch.where(is_hot, sentinel, ids), axis,
                rows_per_shard, slack=slack, cap=cap)
    hot_vals = replica[ids.clamp(0, hot - 1)]
    return (torch.where(is_hot[:, None], hot_vals, cold),
            is_hot.sum())


def note_cache_traffic(hits: int, total: int) -> None:
    """Fold one training call's cache counts into the APS counters."""
    hits = int(hits)
    incr("aps.cache_hits", hits)
    incr("aps.cache_misses", max(0, int(total) - hits))


def note_cache_dropped(hot: int) -> None:
    """Count a replica being released (``aps.cache_evictions``): the static
    hot set never evicts per step."""
    if hot > 0:
        incr("aps.cache_evictions", int(hot))
