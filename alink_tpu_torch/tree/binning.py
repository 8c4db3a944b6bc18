"""Quantile binning for histogram trees (a copy of
``alink_tpu/tree/binning.py``: host numpy, so the port's bins are the
reference's, value for value).

(reference: operator/common/tree/parallelcart/EpsilonApproQuantile.java — a
distributed epsilon-approximate sketch; here one exact percentile pass.)
"""

from __future__ import annotations

import numpy as np


def quantile_bins(X: np.ndarray, num_bins: int = 64) -> np.ndarray:
    """Per-feature bin edges, shape (d, num_bins-1). Edges are interior
    boundaries: bin b holds x in (edge[b-1], edge[b]]."""
    qs = np.linspace(0, 100, num_bins + 1)[1:-1]
    edges = np.percentile(X, qs, axis=0).T.astype(np.float32)  # (d, B-1)
    return edges


def apply_bins(X: np.ndarray, edges: np.ndarray) -> np.ndarray:
    """Bin codes int32 (n, d): number of edges strictly below x."""
    n, d = X.shape
    out = np.empty((n, d), np.int32)
    for j in range(d):
        out[:, j] = np.searchsorted(edges[j], X[:, j], side="left")
    return out
