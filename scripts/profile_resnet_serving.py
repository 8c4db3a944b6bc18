"""Where ResNet-50 batch inference (BASELINE #3) spends its time on the card.

Run from the repository root on a machine with one CUDA device:

    python3 scripts/profile_resnet_serving.py

Builds chip_smoke.py's 13.1 cell with its helpers: bench.py's ResNet-50
exported at (256, 3, 224, 224) to ``build/profile_resnet50.pt2``, 1,000
seeded NCHW fp32 images, ``TorchModelPredictBatchOp(predictBatchSize=256)``.
For each precision it times the host's stacking of the image column (the
op's ``_bind_inputs``), then traces one warm ``map_table`` of the loaded
mapper with ``torch.profiler`` and prints device time by group
(convolution kernels; GEMM kernels, which are cuDNN's 1x1 convolutions run
as GEMMs and the head; layout transposes; elementwise; pooling and
reductions; copies to and from the card), the device operations, the busy
time and the device's idle share of the traced wall. The Chrome traces go
to ``build/resnet_serving_<precision>.json``.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

GROUPS = (  # (group, substrings of the kernel name), first match wins
    ("copy to card", ("Memcpy HtoD",)),
    ("copy to host", ("Memcpy DtoH",)),
    ("layout transposes", ("nchwToNhwc", "nhwcToNchw", "transpose")),
    ("convolution kernels", ("conv", "fprop", "fft", "winograd")),
    # cuDNN runs some 1x1 convolutions as plain GEMMs; the head is one too
    ("GEMM kernels", ("gemm", "nvjet", "cutlass")),
    ("pooling and reductions", ("pool", "reduce", "mean")),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
)


def group_of(key: str) -> str:
    for group, keys in GROUPS:
        if any(k.lower() in key.lower() for k in keys):
            return group
    return "other"


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("FAIL: no CUDA device")
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import chip_smoke as cs
    from alink_tpu_torch.operator.batch import (TableSourceBatchOp,
                                                TorchModelPredictBatchOp)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 \
        else "nvidia-smi: not available"
    print(card, flush=True)
    out = os.path.join(ROOT, "build")
    os.makedirs(out, exist_ok=True)
    X = cs.resnet_images(cs.RESNET_ROWS)
    model = cs.bench_resnet50()
    pt2 = os.path.join(out, "profile_resnet50.pt2")
    torch.export.save(torch.export.export(
        model, (torch.from_numpy(X[:cs.RESNET_BATCH]),)), pt2)
    table = cs.image_table(X)

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for prec in ("float32", "bfloat16"):
        op = TorchModelPredictBatchOp(
            selectedCols=["img"], outputCols=["logits"], modelPath=pt2,
            predictBatchSize=cs.RESNET_BATCH, precision=prec).link_from(
            TableSourceBatchOp(table))
        op.collect()
        mapper = op._mapper_cache[1]
        t0 = time.perf_counter()
        mapper._bind_inputs(table)
        stack_s = time.perf_counter() - t0
        mapper.map_table(table)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            mapper.map_table(table)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        rows = [(ev.self_device_time_total / 1e3, ev.count, ev.key)
                for ev in prof.key_averages()
                if ev.device_type == DeviceType.CUDA
                and ev.self_device_time_total > 0]
        rows.sort(reverse=True)
        busy = sum(r[0] for r in rows)
        groups: dict = {}
        for ms, _, key in rows:
            g = group_of(key)
            groups[g] = groups.get(g, 0.0) + ms
        print(f"[{card}] {prec}: {cs.RESNET_ROWS} rows, traced wall "
              f"{wall_ms:.1f} ms ({cs.RESNET_ROWS / wall_ms * 1e3:.0f} "
              f"rows/s), device busy {busy:.1f} ms, idle share "
              f"{max(0.0, 1 - busy / wall_ms):.3f}, "
              f"{sum(r[1] for r in rows)} device operations; host stacking "
              f"of the image column {stack_s * 1e3:.1f} ms", flush=True)
        print("  device ms by group: " + ", ".join(
            f"{g} {v:.2f}" for g, v in sorted(groups.items(),
                                              key=lambda kv: -kv[1])))
        for ms, count, key in rows[:12]:
            print(f"  {ms:9.2f} ms {count:5d}x {ms / busy:6.3f}  {key[:90]}")
        prof.export_chrome_trace(os.path.join(
            out, f"resnet_serving_{prec}.json"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
