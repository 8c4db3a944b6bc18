"""The repository's small real-text fixtures (a copy of the loaders of
``alink_tpu/dl/data.py``; numpy and csv only):

- ``data/reviews_unlabeled.txt``: unlabeled review sentences;
- ``data/sst2_mini.csv``: labeled sentiment rows (``text,label`` with quoted
  commas), the fine-tune and holdout task;
- ``data/bert_tiny_sst/``: an HF-layout checkpoint directory (config.json,
  model.safetensors, vocab.txt).

Both packages read the same rows and the same splits. The reference's
streaming corpus (``CorpusStream``) is not ported yet.
"""

from __future__ import annotations

import csv
import os
from typing import List, Optional, Tuple

import numpy as np

_DATA_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "data")


def data_path(name: str) -> str:
    """Absolute path of a shipped ``data/`` artifact."""
    return os.path.join(_DATA_DIR, name)


def load_reviews(path: Optional[str] = None,
                 limit: Optional[int] = None) -> List[str]:
    """The unlabeled review sentences (one per line, blank lines dropped)."""
    path = path or data_path("reviews_unlabeled.txt")
    with open(path, encoding="utf-8") as f:
        texts = [line.strip() for line in f]
    texts = [t for t in texts if t]
    return texts[:limit] if limit else texts


def load_sst2(path: Optional[str] = None) -> Tuple[List[str], np.ndarray]:
    """The labeled sentiment rows as ``(texts, labels)``: csv with quoted
    commas, label in {0, 1}; malformed lines are skipped."""
    path = path or data_path("sst2_mini.csv")
    texts: List[str] = []
    labels: List[int] = []
    with open(path, encoding="utf-8", newline="") as f:
        for row in csv.reader(f):
            if len(row) != 2 or not row[1].strip().lstrip("-").isdigit():
                continue
            texts.append(row[0])
            labels.append(int(row[1]))
    return texts, np.asarray(labels, np.int64)


def sst2_split(seed: int = 0, holdout: float = 0.2,
               path: Optional[str] = None):
    """Deterministic train/holdout split of the sst2 rows:
    ``(train_texts, train_y, hold_texts, hold_y)``."""
    texts, y = load_sst2(path)
    rng = np.random.default_rng(seed)
    perm = rng.permutation(len(texts))
    n_hold = max(1, int(len(texts) * holdout))
    hold, train = perm[:n_hold], perm[n_hold:]
    return ([texts[i] for i in train], y[train],
            [texts[i] for i in hold], y[hold])
