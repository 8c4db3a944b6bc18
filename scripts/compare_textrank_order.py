"""Counts the documents whose TextRank keywords move when PageRank's
scatter-adds run in another order, as they do on the card (``index_add_``
adds duplicate indices in any order there).

Run from the repository root on the CPU:

    python3 scripts/compare_textrank_order.py [--docs N] [--trials T]

It extracts the keywords of the first N documents of chip_smoke.py's
text8-layout corpus (phase 20.3's documents) once in edge order, the CPU
route's, and then T times with every superstep's contributions added in a
fresh random order, and prints how many documents' keywords differ in
each trial. Defaults: 200 documents, 5 trials (about a minute).
"""

from __future__ import annotations

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
os.environ["ALINK_TORCH_DEVICE"] = "cpu"


def main() -> int:
    import numpy as np
    import torch

    import chip_smoke as cs
    from alink_tpu_torch.common.mtable import MTable
    from alink_tpu_torch.graph import engine
    from alink_tpu_torch.operator.batch import (KeywordsExtractionBatchOp,
                                                TableSourceBatchOp)

    ap = argparse.ArgumentParser()
    ap.add_argument("--docs", type=int, default=200)
    ap.add_argument("--trials", type=int, default=5)
    args = ap.parse_args()
    docs = cs.text8_corpus(cs.LDA_TOKENS, cs.SEED)[:args.docs]
    src = TableSourceBatchOp(MTable({"doc": np.asarray(docs, object)}))

    def keywords():
        return list(KeywordsExtractionBatchOp(selectedCol="doc")
                    .link_from(src).collect().col("keywords"))

    base = keywords()
    rng = np.random.default_rng(0)
    in_order = engine.scatter_add

    def shuffled(n, index, values):
        p = torch.as_tensor(rng.permutation(len(index)))
        return in_order(n, index[p], values[p])

    engine.scatter_add = shuffled
    try:
        for trial in range(args.trials):
            moved = sum(a != b for a, b in zip(base, keywords()))
            print(f"trial {trial}: {moved} of {len(base)} documents' "
                  f"keywords differ from the edge-order run", flush=True)
    finally:
        engine.scatter_add = in_order
    return 0


if __name__ == "__main__":
    sys.exit(main())
