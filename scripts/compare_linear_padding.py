"""Phase 12.2 of chip_smoke.py (the Softmax model at n = 60,000 served in
requests of 5,000 rows at fp32, bf16 and int8) with the row bucketing off
and on, in turns (off, on, on, off), in one process on one card: whether
padding each request's staged block up the bucket ladder (5,000 rows to
8,192) costs the requests' rows/s.

Run from the repository root on a machine with one CUDA device:

    python3 scripts/compare_linear_padding.py

Prints the card's name and power limit, one JSON line a turn, then a JSON
summary: rows/s per policy and turn, and the median of each arm.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

TURNS = ("off", "pow2", "pow2", "off")


def main() -> int:
    import torch

    import chip_smoke as cs

    if not torch.cuda.is_available():
        cs.fail("no CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rates = {arm: {} for arm in set(TURNS)}
    for arm in TURNS:
        os.environ["ALINK_SHAPE_BUCKETS"] = arm
        out, problems = cs.linear_policies()
        if problems:
            cs.fail(f"12.2 with bucketing {arm}: {problems}")
        turn = {p: out[p]["rows_per_s"] for p in ("fp32", "bf16", "int8")}
        print(f"[{card}] bucketing {arm}: {json.dumps(turn)}", flush=True)
        for p, r in turn.items():
            rates[arm].setdefault(p, []).append(r)
    summary = {arm: {p: dict(turns=r, median=statistics.median(r))
                     for p, r in by.items()} for arm, by in rates.items()}
    print(json.dumps({"card": card, "rows_per_s": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
