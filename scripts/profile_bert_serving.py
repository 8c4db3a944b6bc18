"""Where a BERT-base serving forward spends its time on the card.

Run from the repository root on a machine with one CUDA device:

    python3 scripts/profile_bert_serving.py

Builds chip_smoke.py's served model (BERT-base, seeded random weights,
maxSeqLength 512, attentionBlockSize 128) with chip_smoke's helpers, encodes
64 rows of its seeded texts, and traces three warm forwards
(``predict_model``, kernel route) with ``torch.profiler``: it prints device
time by kernel, the flash kernel's share, and the device's idle share of the
traced wall time; the Chrome trace goes to
``build/bert_serving_trace.json``. chip_smoke.py times the forward on each
attention route.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

ROWS = 64
REPS = 3


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("FAIL: no CUDA device")
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import chip_smoke
    from alink_tpu_torch.dl.convert import flax_to_torch
    from alink_tpu_torch.dl.modules import TransformerEncoder
    from alink_tpu_torch.dl.tokenizer import Tokenizer
    from alink_tpu_torch.dl.train import predict_model

    rng = np.random.default_rng(chip_smoke.SEED)
    cfg = chip_smoke.serving_config()
    model = TransformerEncoder(cfg)
    model.load_state_dict(flax_to_torch(chip_smoke.flax_params(cfg, rng)))
    vocab = chip_smoke.synthetic_vocab(cfg)
    enc = Tokenizer.from_list(vocab).encode_batch(
        chip_smoke.request_texts(vocab, rng, ROWS), max_len=512)
    import subprocess

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.returncode == 0
          else "nvidia-smi: not available")
    print(f"{torch.cuda.get_device_name(0)}; warm {ROWS}-row forward "
          f"{chip_smoke.forward_ms(model, enc):.1f} ms")

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    predict_model(model, enc)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(REPS):
            predict_model(model, enc)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # device-side rows only: the operator rows carry the same time again
    rows = [(ev.self_device_time_total, ev.count, ev.key)
            for ev in prof.key_averages()
            if ev.device_type == DeviceType.CUDA
            and ev.self_device_time_total > 0]
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    flash = sum(r[0] for r in rows if "flash_block_update" in r[2])
    print(f"traced {REPS} forwards: wall {wall_us / 1e3:.1f} ms, device busy "
          f"{busy / 1e3:.1f} ms (kernel time summed; idle share "
          f"{max(0.0, 1 - busy / wall_us):.3f}), flash_block_update "
          f"{flash / 1e3:.1f} ms = {flash / max(busy, 1e-9):.3f} of device "
          f"time")
    groups = {"flash_block_update": 0.0, "matmul": 0.0, "other": 0.0}
    for dev, _, key in rows:
        if "flash_block_update" in key:
            groups["flash_block_update"] += dev
        elif any(m in key for m in ("nvjet", "gemm", "cutlass", "xmma")):
            groups["matmul"] += dev
        else:
            groups["other"] += dev
    print("device ms per forward by group: " + ", ".join(
        f"{g} {v / 1e3 / REPS:.2f}" for g, v in groups.items()))
    for dev, count, key in rows[:15]:
        print(f"  {dev / 1e3:9.2f} ms  {count:5d}x  {dev / busy:6.3f}  "
              f"{key[:90]}")
    out = os.path.join(ROOT, "build")
    os.makedirs(out, exist_ok=True)
    prof.export_chrome_trace(os.path.join(out, "bert_serving_trace.json"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
