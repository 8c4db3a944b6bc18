"""Times the forest's level call (``level_histograms``, one launch of
``tree_histogram``) on the tree this script sits in, so that two trees can
be compared on one card in turns.

Run from a repository root on a machine with one CUDA device:

    python3 scripts/time_level_calls.py

Builds that tree's kernels, makes chip_smoke.py's Covertype-layout bins
(522,911 rows, 54 features, seed 0) and times one level call at L = 1, 64
and 2,048 on evenly spread nodes with the forest's channels (g, count,
count), as device time in CUDA graphs (``chip_smoke.time_level``). Prints
one JSON line: ms by L. To compare a parent commit, unpack it with
``git archive`` into a directory that ``.gitignore`` lists and run its copy
of this script in turns with this one (parent, change, change, parent).
"""

from __future__ import annotations

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

LEVELS = (0, 6, 11)


def main() -> int:
    import torch

    import chip_smoke as cs
    from alink_tpu_torch.native import kernels
    from alink_tpu_torch.tree.binning import apply_bins, quantile_bins

    if not torch.cuda.is_available():
        cs.fail("no CUDA device")
    kernels.build()
    _, peaks = cs.card_peaks(torch.cuda.get_device_name(0))
    X, _ = cs.covertype_data(cs.COVTYPE_TRAIN, cs.SEED)
    bins = torch.tensor(apply_bins(X, quantile_bins(X, cs.HIST_BINS)),
                        dtype=torch.uint8, device="cuda")
    out = {}
    for level in LEVELS:
        b, node, L, vals = cs.level_inputs(bins, level, cs.SEED + level)
        row = cs.time_level(peaks, b, node,
                            (vals["g"], vals["count"], vals["count"]), L,
                            f"{ROOT} L={L}")
        out[L] = row["ms"]
    print(json.dumps({"tree": ROOT, "ms_by_L": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
