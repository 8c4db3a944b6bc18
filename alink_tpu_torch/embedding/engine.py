"""Engine selection for the huge-embedding family (port of
``alink_tpu.embedding.engine``).

One knob spans the family (Word2Vec, DeepWalk and Node2Vec embeddings):

- ``sharded`` (default): tables row-sharded over the ``model`` ranks, APS
  pull/push with the hot-key cache and the ``sgns_block_grads`` kernel;
- ``host``: replicated tables, gathered scatter-add updates.

``ALINK_HUGE_ENGINE`` overrides the default; unrecognised values fall back
to ``sharded`` (a typoed tuning knob must not crash a job) and are counted
in ``huge.engine_bad_knob``. The reference's ``collective_bytes_probe`` waits
for the port's profiling module (ROADMAP A10).
"""

from __future__ import annotations

import logging
from typing import Optional

import numpy as np

from .skipgram import SkipGramConfig, train_skipgram, train_skipgram_sharded

_ENGINES = ("sharded", "host")
_log = logging.getLogger("alink_tpu_torch.embedding")


def huge_engine(override: Optional[str] = None) -> str:
    """Resolve the active engine: explicit ``override`` >
    ``ALINK_HUGE_ENGINE`` > ``sharded``."""
    from ..common.env import env_str

    raw = override if override is not None \
        else (env_str("ALINK_HUGE_ENGINE", "sharded") or "sharded")
    val = raw.strip().lower()
    if val in _ENGINES:
        return val
    from ..parallel.aps import incr

    incr("huge.engine_bad_knob")
    _log.warning("unrecognized huge-embedding engine %r; using 'sharded' "
                 "(valid: %s)", raw, "|".join(_ENGINES))
    return "sharded"


def train_embedding(
    pairs: np.ndarray,
    vocab_size: int,
    counts: np.ndarray,
    cfg: SkipGramConfig,
    *,
    engine: Optional[str] = None,
    device=None,
    hot_rows: Optional[int] = None,
) -> np.ndarray:
    """Train SGNS through the resolved engine on ``device``; returns the
    (V, dim) input table on the host either way."""
    if huge_engine(engine) == "host":
        return train_skipgram(pairs, vocab_size, counts, cfg, device=device)
    handle = train_skipgram_sharded(pairs, vocab_size, counts, cfg,
                                    device=device, hot_rows=hot_rows)
    return handle.to_numpy()
