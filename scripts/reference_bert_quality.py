"""The reference's accuracy on bench.py's BERT quality route, on the CPU:
the constant ``chip_smoke.BERT_QUALITY_REFERENCE_ACC`` that phase 15.4
holds the port to on the card.

Run from the repository root on a host that has both packages (JAX on the
CPU):

    JAX_PLATFORMS=cpu python3 scripts/reference_bert_quality.py [--port]

Runs ``bench.bench_bert_quality()`` (``alink_tpu``): MLM pretraining on
data/reviews_unlabeled.txt at vocab_size 2000, hidden 96, 2 layers, 4
heads, intermediate 192, max_len 32, 5 epochs, batch 64, learning rate
3e-4, seed 0; the HF checkpoint; ``BertTextClassifierTrainBatchOp`` on
``sst2_split(seed=0)``'s 407 train rows (maxSeqLength 32, 14 epochs, batch
32, learning rate 5e-4, seed 0, mean pooling); accuracy on the 101
holdout rows. JAX runs on one CPU device (no ``XLA_FLAGS`` device count).
``--port`` also runs the same route in ``alink_tpu_torch`` on the CPU
(``chip_smoke.bert_quality_route`` with ``ALINK_TORCH_DEVICE=cpu``). Prints
one JSON line per package.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--port", action="store_true",
                    help="also run the port's route on the CPU")
    args = ap.parse_args()
    os.environ.setdefault("JAX_PLATFORMS", "cpu")

    import bench

    t0 = time.perf_counter()
    ref = bench.bench_bert_quality()
    print(json.dumps({"package": "alink_tpu", "host_s":
                      round(time.perf_counter() - t0, 1), **ref}),
          flush=True)
    if args.port:
        import chip_smoke

        os.environ["ALINK_TORCH_DEVICE"] = "cpu"
        with tempfile.TemporaryDirectory() as d:
            port = chip_smoke.bert_quality_route(d)
        print(json.dumps({"package": "alink_tpu_torch", "device": "cpu",
                          **port}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
