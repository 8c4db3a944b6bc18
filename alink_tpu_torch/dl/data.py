"""The repository's small real-text fixtures and the streaming corpus (a
copy of ``alink_tpu/dl/data.py``; numpy and csv only):

- ``data/reviews_unlabeled.txt``: unlabeled review sentences;
- ``data/sst2_mini.csv``: labeled sentiment rows (``text,label`` with quoted
  commas), the fine-tune and holdout task;
- ``data/bert_tiny_sst/``: an HF-layout checkpoint directory (config.json,
  model.safetensors, vocab.txt).

Both packages read the same rows and the same splits.

Corpus-scale ingestion (:class:`CorpusStream`, a copy of the reference's)
streams a line-delimited corpus that does not fit host RAM: one indexing
pass records the byte offset and row count of fixed-size row *blocks*,
then every epoch reads blocks in a per-``(seed, epoch)`` permuted order
with a per-block row shuffle (the *block schedule*). The schedule is a
pure function of ``(seed, epoch)``, so a resumed run replays the exact
remaining order, and :func:`scheduled_order` materializes the identical
order over an in-memory array. Peak host memory is bounded by the row
buffer (one block plus one assembling batch); ``max_resident_rows``
records the high-water mark.
"""

from __future__ import annotations

import csv
import os
from typing import Iterator, List, Optional, Tuple

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


# ---------------------------------------------------------------------------
# Streaming corpus ingestion
# ---------------------------------------------------------------------------


def block_order(num_blocks: int, seed: int, epoch: int) -> np.ndarray:
    """The epoch's block permutation — a pure function of ``(seed, epoch)``
    (the generator family of the training loop's per-epoch shuffles), so every process
    and every resumed run derives the identical schedule locally."""
    return np.random.default_rng((seed, epoch)).permutation(num_blocks)


def _intra_block_order(rows: int, seed: int, epoch: int,
                       block: int) -> np.ndarray:
    # +1 keeps the stream distinct from the (seed, epoch) block-order seed
    return np.random.default_rng((seed, epoch, int(block) + 1)).permutation(
        rows)


def scheduled_order(n: int, block_rows: int, seed: int,
                    epoch: int) -> np.ndarray:
    """The epoch's full row order under the block schedule, materialized
    over an in-memory corpus of ``n`` rows: contiguous blocks of
    ``block_rows`` rows, blocks visited in :func:`block_order`, rows inside
    each block shuffled per-(seed, epoch, block). This is BY CONSTRUCTION
    the exact order :class:`CorpusStream` streams off disk — the in-memory
    feed and the streaming feed assemble identical batches, so training is
    bit-identical either way (CI-pinned)."""
    if n <= 0:
        return np.zeros(0, np.int64)
    block_rows = max(1, int(block_rows))
    nb = -(-n // block_rows)
    parts = []
    for b in block_order(nb, seed, epoch):
        start = int(b) * block_rows
        rows = min(block_rows, n - start)
        parts.append(start + _intra_block_order(rows, seed, epoch, int(b)))
    return np.concatenate(parts)


class CorpusStream:
    """Shard-aware streaming iterator over a line-delimited text corpus.

    One indexing pass at construction records each block's byte offset and
    row count (O(num_blocks) memory — blank lines are dropped, matching
    :func:`load_reviews`); afterwards every epoch streams blocks in the
    :func:`block_order` schedule, holding at most one block plus one
    assembling batch of rows in memory. ``max_resident_rows`` tracks the
    high-water mark of rows held simultaneously so the bounded-buffer
    contract is assertable, and ``iter_batches(start_batch=k)`` skips
    already-consumed blocks WITHOUT reading them — crash-resume replays
    the exact remaining schedule at block-seek cost."""

    def __init__(self, path: str, *, block_rows: int = 256,
                 buffer_rows: int = 2048, encoding: str = "utf-8",
                 limit: Optional[int] = None):
        if block_rows < 1:
            raise ValueError(f"block_rows must be >= 1, got {block_rows}")
        if block_rows > buffer_rows:
            raise ValueError(
                f"block_rows={block_rows} exceeds buffer_rows={buffer_rows}"
                " — the buffer must hold at least one block")
        self.path = os.path.abspath(path)
        self.block_rows = int(block_rows)
        self.buffer_rows = int(buffer_rows)
        self.encoding = encoding
        self.max_resident_rows = 0
        offsets: List[int] = []
        counts: List[int] = []
        n = 0
        # binary scan: byte offsets must be independent of text decoding
        with open(self.path, "rb") as f:
            pos = f.tell()
            in_block = 0
            for raw in f:
                if not raw.strip():
                    pos = f.tell()
                    continue
                if in_block == 0:
                    offsets.append(pos)
                in_block += 1
                n += 1
                if in_block == self.block_rows:
                    counts.append(in_block)
                    in_block = 0
                pos = f.tell()
                if limit is not None and n >= limit:
                    break
            if in_block:
                counts.append(in_block)
        self._block_off = offsets
        self._block_rows = counts
        self.num_rows = n
        self.num_blocks = len(offsets)

    def __len__(self) -> int:
        return self.num_rows

    def _note_resident(self, rows: int) -> None:
        if rows > self.max_resident_rows:
            self.max_resident_rows = rows

    def read_block(self, b: int) -> List[str]:
        """The (unshuffled) non-blank rows of block ``b``."""
        want = self._block_rows[b]
        rows: List[str] = []
        with open(self.path, "rb") as f:
            f.seek(self._block_off[b])
            for raw in f:
                if not raw.strip():
                    continue
                rows.append(raw.decode(self.encoding).strip())
                if len(rows) == want:
                    break
        return rows

    def sample_texts(self, k: int) -> List[str]:
        """The first ``k`` rows in FILE order (no shuffle) — the bounded
        sample a streaming pretrain builds its vocab from when no
        tokenizer is supplied."""
        out: List[str] = []
        for b in range(self.num_blocks):
            out.extend(self.read_block(b))
            if len(out) >= k:
                return out[:k]
        return out

    def iter_rows(self, seed: int, epoch: int, *,
                  start_row: int = 0) -> Iterator[str]:
        """Rows in the epoch's scheduled order, starting at scheduled
        position ``start_row``. Blocks wholly before the start position are
        skipped by their indexed row counts — no file reads."""
        pos = 0
        for b in block_order(self.num_blocks, seed, epoch):
            b = int(b)
            rows = self._block_rows[b]
            if pos + rows <= start_row:
                pos += rows
                continue
            texts = self.read_block(b)
            self._note_resident(len(texts))
            order = _intra_block_order(len(texts), seed, epoch, b)
            for i in order[max(0, start_row - pos):]:
                yield texts[int(i)]
            pos += rows

    def iter_batches(self, batch: int, seed: int, epoch: int, *,
                     start_batch: int = 0
                     ) -> Iterator[Tuple[int, List[str]]]:
        """``(global_step, texts)`` batches of the epoch's scheduled order
        (the last batch may be short). The row buffer holds one block plus
        the assembling batch; ``batch + block_rows`` must fit
        ``buffer_rows``."""
        if batch < 1:
            raise ValueError(f"batch must be >= 1, got {batch}")
        if batch + self.block_rows > self.buffer_rows:
            raise ValueError(
                f"batch={batch} + block_rows={self.block_rows} exceeds "
                f"buffer_rows={self.buffer_rows}; raise buffer_rows or "
                "shrink the batch/block")
        step = start_batch
        pending: List[str] = []
        for row in self.iter_rows(seed, epoch, start_row=start_batch * batch):
            pending.append(row)
            self._note_resident(len(pending) + self.block_rows)
            if len(pending) == batch:
                yield step, pending
                step += 1
                pending = []
        if pending:
            yield step, pending


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
