"""Where a RandomForest training run spends its time on the card.

Run from the repository root on a machine with one CUDA device:

    python3 scripts/profile_forest_training.py

Takes chip_smoke.py's forest cell (522,911 seeded rows in UCI Covertype's
column layout; numTrees=20, maxDepth=12, maxBins=64, minSamplesPerLeaf=5)
and times on the host clock what ``RandomForestTrainBatchOp`` does: the
feature block and label mapping (``_prep_data``), the binning
(``quantile_bins`` + ``apply_bins``) and the whole ``train_forest`` (which
bins again). A second ``train_forest`` runs under ``torch.profiler``: the
script prints device time by kernel group and the device's idle share of
the traced wall time; the Chrome trace goes to
``build/forest_training_trace.json``.
"""

from __future__ import annotations

import os
import sys
import time


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

GROUPS = (("tree_histogram", ("hist_shared_kernel", "hist_global_kernel")),
          ("cumsum (split search)", ("scan", "cumsum")),
          ("argmax and other reductions", ("reduce",)),
          ("gather and index (routing, ids)", ("gather", "index")),
          ("copies host<->device", ("Memcpy",)))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("FAIL: no CUDA device")
        return 1
    import chip_smoke
    from alink_tpu_torch.native import kernels
    from alink_tpu_torch.operator.batch import RandomForestTrainBatchOp
    from alink_tpu_torch.tree import train_forest
    from alink_tpu_torch.tree.binning import apply_bins, quantile_bins

    kernels.build()
    n = chip_smoke.COVTYPE_TRAIN
    X, y = chip_smoke.covertype_data(n + chip_smoke.COVTYPE_TEST,
                                     chip_smoke.SEED)
    table = chip_smoke.covertype_table(X[:n], y[:n])
    op = RandomForestTrainBatchOp(labelCol="label", **chip_smoke.FOREST)

    t0 = time.perf_counter()
    Xb, yb = op._prep_data(table)[:2]
    t1 = time.perf_counter()
    apply_bins(Xb, quantile_bins(Xb, chip_smoke.FOREST["maxBins"]))
    t2 = time.perf_counter()
    kw = dict(task="binary", num_trees=chip_smoke.FOREST["numTrees"],
              depth=chip_smoke.FOREST["maxDepth"],
              num_bins=chip_smoke.FOREST["maxBins"],
              min_samples=float(chip_smoke.FOREST["minSamplesPerLeaf"]))
    train_forest(Xb, yb, **kw)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    print(f"{torch.cuda.get_device_name(0)}; host clock: feature block and "
          f"labels {t1 - t0:.3f} s, binning "
          f"{t2 - t1:.3f} s, train_forest {t3 - t2:.3f} s (binning "
          f"included)")

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        train_forest(Xb, yb, **kw)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = [(ev.self_device_time_total, ev.count, ev.key)
            for ev in prof.key_averages()
            if ev.device_type == DeviceType.CUDA
            and ev.self_device_time_total > 0]
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    print(f"traced train_forest: wall {wall_us / 1e3:.1f} ms, device busy "
          f"{busy / 1e3:.1f} ms (kernel time summed; idle share "
          f"{max(0.0, 1 - busy / wall_us):.3f})")
    sums = dict.fromkeys([g for g, _ in GROUPS] + ["other"], 0.0)
    for dev, _, key in rows:
        group = next((g for g, keys in GROUPS
                      if any(k in key for k in keys)), "other")
        sums[group] += dev
    print("device ms by group: " + ", ".join(
        f"{g} {v / 1e3:.1f} ({v / max(busy, 1e-9):.3f})"
        for g, v in sums.items()))
    for dev, count, key in rows[:15]:
        print(f"  {dev / 1e3:9.2f} ms  {count:6d}x  {dev / busy:6.3f}  "
              f"{key[:90]}")
    out = os.path.join(ROOT, "build")
    os.makedirs(out, exist_ok=True)
    prof.export_chrome_trace(os.path.join(out, "forest_training_trace.json"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
