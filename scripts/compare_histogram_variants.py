"""What the fused level call of ``tree_histogram`` spends its time on: the
kernel's design choices timed one against another at every level.

Run from the repository root on a machine with one CUDA device and the
CUDA toolkit (``nvcc`` under PyTorch's ``CUDA_HOME``):

    python3 scripts/compare_histogram_variants.py

Compiles copies of ``alink_tpu_torch/csrc/tree_histogram.cu`` into
``build/histogram_variants/``, each with one change (``VARIANTS``: a sizing
constant, or a piece of the source replaced), each with a C shim called
through ``ctypes``, and times each as device time in a CUDA graph on
chip_smoke.py's Covertype-layout bins (n = 522,911, d = 54): first with
node ids spread evenly over the levels' nodes, then on the level calls of
the first tree of a forest grown on the card, as its level program makes
them (g, counts, counts: h is c). Beside them: a library sort of node
(``torch.sort``, stable) for scale, and the whole call
``level_histograms``. Variants whose result
must differ (a lower bound without atomics) are marked; every other
variant is checked against ``level_histograms_ref``.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

ATOMIC = ("  for (int c = 0; c < C; ++c) atomicAdd(&hist[(c * d + f) * HB + bin], "
          "a[c]);")
RUN = "          } else if (bin == cur[j]) {"
# name: ({constant: value}, [(source text, replacement)], exact)
VARIANTS = {
    "as built": ({}, [], True),
    "no run-length sums": ({}, [(RUN, "          } else if (false) {")],
                           True),
    "shared runs from 16 rows": ({"SMEM_MIN_ROWS": 16}, [], True),
    "sort counters up to 2^22": ({}, [("1 << 19;", "1 << 22;")], True),
    "2 sort units an SM": ({"SORT_UNITS_PER_SM": 2}, [], True),
    "4 CTAs of 256 threads an SM": ({"THREADS": 256, "CTAS_PER_SM": 4}, [],
                                    True),
    "bins of 4 rows in flight": ({"UNROLL": 4}, [], True),
    "no shared atomics (wrong sums: a lower bound)": (
        {}, [(ATOMIC, "  for (int c = 0; c < C; ++c) hist[(c * d + f) * HB "
                      "+ bin] += a[c];")], False),
}
SHIM = r"""
extern "C" long long scratch_c(int n, int L) {
  return tree_histogram_scratch(n, L);
}
extern "C" int hist_c(const void* bins, const int32_t* node, const float* v0,
                      const float* v1, int C, float* out, int* scratch, int n,
                      int d, int L, int B, void* stream) {
  HistVals hv{{v0, v1, nullptr}};
  return (int)tree_histogram_launch(bins, 1, node, hv, C, out, scratch, n, d,
                                    L, B, (cudaStream_t)stream);
}
"""


def build(out_dir):
    import re

    from torch.utils.cpp_extension import CUDA_HOME

    nvcc = os.path.join(CUDA_HOME, "bin", "nvcc")
    src = open(os.path.join(ROOT, "alink_tpu_torch", "csrc",
                            "tree_histogram.cu")).read()
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for i, (name, (consts, texts, _)) in enumerate(VARIANTS.items()):
        s = src
        for key, value in consts.items():
            s, k = re.subn(rf"constexpr int {key} = [^;]*;",
                           f"constexpr int {key} = {value};", s)
            assert k == 1, (name, key)
        for old, new in texts:
            assert old in s, (name, old)
            s = s.replace(old, new)
        cu = os.path.join(out_dir, f"v{i}.cu")
        with open(cu, "w") as f:
            f.write(s + SHIM)
        procs[name] = (subprocess.Popen(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-O3",
             "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-o",
             cu[:-3] + ".so", cu]), cu[:-3] + ".so")
    libs = {}
    for name, (proc, so) in procs.items():
        if proc.wait() != 0:
            raise RuntimeError(f"nvcc failed for {name}")
        lib = ctypes.CDLL(so)
        lib.hist_c.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] \
            + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        lib.hist_c.restype = ctypes.c_int
        lib.scratch_c.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.scratch_c.restype = ctypes.c_longlong
        libs[name] = lib
    return libs


def compare(libs, label, cases):
    """Times every variant on each (bins, node, (g, w, w), L); returns True
    on a mismatch of an exact variant."""
    import torch

    import chip_smoke
    from alink_tpu_torch.tree.hist_cuda import (level_histograms,
                                                level_histograms_ref)

    B = chip_smoke.HIST_BINS
    for bins, node, vals, L in cases:
        n, d = bins.shape
        ref = level_histograms_ref(bins, node, vals, num_nodes=L, num_bins=B)
        row = {"torch.sort of node": chip_smoke.graph_ms(
            lambda: torch.sort(node, stable=True), 10, 20),
               "level_histograms": chip_smoke.graph_ms(
            lambda: level_histograms(bins, node, vals, num_nodes=L,
                                     num_bins=B), 10, 20)}
        for name, lib in libs.items():
            def run():
                out = torch.zeros((2, L, d, B), device="cuda")
                scratch = torch.empty(lib.scratch_c(n, L), dtype=torch.int32,
                                      device="cuda")
                if lib.hist_c(bins.data_ptr(), node.data_ptr(),
                              vals[0].data_ptr(), vals[1].data_ptr(), 2,
                              out.data_ptr(), scratch.data_ptr(), n, d, L, B,
                              torch.cuda.current_stream().cuda_stream) != 0:
                    raise RuntimeError(f"launch failed: {name}")
                return out
            out = run()
            torch.cuda.synchronize()
            if VARIANTS[name][2] and not (torch.equal(out[0], ref[0])
                                          and torch.equal(out[1], ref[1])):
                print(f"FAIL: {name} differs from level_histograms_ref at "
                      f"L={L}")
                return True
            row[name] = chip_smoke.graph_ms(run, 10, 20)
        sizes = torch.bincount(node.long()).cpu()
        sizes = sizes[sizes > 0].float()
        print(f"{label} L={L} ({len(sizes)} nodes with rows, median "
              f"{int(sizes.median())} rows): " + ", ".join(
                  f"{k} {v:.4f} ms" for k, v in row.items()), flush=True)
    return False


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("FAIL: no CUDA device")
        return 1
    import chip_smoke
    from alink_tpu_torch.tree import grow, train_forest
    from alink_tpu_torch.tree.binning import apply_bins, quantile_bins

    libs = build(os.path.join(ROOT, "build", "histogram_variants"))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"{card}; device ms a level call (CUDA graph of 10 calls, 20 "
          f"replays); each variant's time includes zeroing out and the "
          f"kernel's own sort of the rows", flush=True)
    n = chip_smoke.COVTYPE_TRAIN
    X, y = chip_smoke.covertype_data(n, chip_smoke.SEED)
    bins = torch.tensor(apply_bins(X, quantile_bins(X, 64)).astype(np.uint8),
                        device="cuda")
    even = []
    for level in (0, 6, 11):
        b, node, L, vals = chip_smoke.level_inputs(bins, level, level)
        even.append((b, node, (vals["g"], vals["count"], vals["count"]), L))
    if compare(libs, "even nodes", even):
        return 1
    del even
    _, _, kept, restore = chip_smoke.instrument_forest(grow)
    try:
        train_forest(X, y.astype("float32"), task="binary", num_trees=2,
                     depth=chip_smoke.FOREST["maxDepth"], num_bins=64,
                     min_samples=5.0)
    finally:
        restore()
    return 1 if compare(libs, "forest tree 1", [
        (b, node, vals, L) for b, node, vals, L in kept]) else 0


if __name__ == "__main__":
    sys.exit(main())
