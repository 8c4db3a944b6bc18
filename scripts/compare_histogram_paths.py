"""Where ``tree_histogram`` should switch from its shared-memory path to
global atomics: both paths timed at every S of a depth-12 tree.

Run from the repository root on a machine with one CUDA device and the
CUDA toolkit (``nvcc`` under PyTorch's ``CUDA_HOME``):

    python3 scripts/compare_histogram_paths.py

Compiles copies of ``alink_tpu_torch/csrc/tree_histogram.cu`` into
``build/histogram_paths/`` with other values of its two sizing constants
(``SMEM_TILE``: bytes of a CTA's private histogram; ``MIN_TILE_FEATURES``:
the fewest features a tile may hold before the global path takes over),
each with a C shim called through ``ctypes``, and times each variant with
CUDA events on chip_smoke.py's Covertype-layout ids (n = 522,911, d = 54):
first with node ids spread evenly over each level's nodes, then on the g
histograms' inputs of the first tree of chip_smoke.py's forest, as its
level program makes them. Every result is checked against
``histogram_ref``.
"""

from __future__ import annotations

import ctypes
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# name: (SMEM_TILE, MIN_TILE_FEATURES); SMEM_TILE 0 leaves only global atomics
VARIANTS = {
    "as built (48 KB, >= 6 features)": (48 * 1024, 6),
    "48 KB, >= 1 feature": (48 * 1024, 1),
    "48 KB, whole rows only": (48 * 1024, 54),
    "global atomics only": (0, 1),
}
SHIM = """
extern "C" int hist_c(const void* ids, const void* vals, void* out, int n,
                      int d, int S, void* stream) {
  return (int)tree_histogram_launch((const int32_t*)ids, (const float*)vals,
                                    (float*)out, n, d, S,
                                    (cudaStream_t)stream);
}
"""


def build(out_dir):
    from torch.utils.cpp_extension import CUDA_HOME

    nvcc = os.path.join(CUDA_HOME, "bin", "nvcc")
    src = open(os.path.join(ROOT, "alink_tpu_torch", "csrc",
                            "tree_histogram.cu")).read()
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for i, (name, (tile, least)) in enumerate(VARIANTS.items()):
        s = re.sub(r"constexpr int SMEM_TILE = [^;]*;",
                   f"constexpr int SMEM_TILE = {tile};", src)
        s = re.sub(r"constexpr int MIN_TILE_FEATURES = [^;]*;",
                   f"constexpr int MIN_TILE_FEATURES = {least};", s)
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
        lib.hist_c.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 \
            + [ctypes.c_void_p]
        lib.hist_c.restype = ctypes.c_int
        libs[name] = lib
    return libs


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("FAIL: no CUDA device")
        return 1
    import chip_smoke
    from alink_tpu_torch.tree.binning import apply_bins, quantile_bins

    libs = build(os.path.join(ROOT, "build", "histogram_paths"))
    print(torch.cuda.get_device_name(0), flush=True)
    n_tr = chip_smoke.COVTYPE_TRAIN
    X, y = chip_smoke.covertype_data(n_tr + chip_smoke.COVTYPE_TEST,
                                     chip_smoke.SEED)
    bins = apply_bins(X[:n_tr], quantile_bins(X[:n_tr], 64))
    even = [(ids, vals["g"], S) for ids, S, vals in (
        chip_smoke.histogram_inputs(bins, level, level)
        for level in range(chip_smoke.FOREST["maxDepth"]))]
    if compare(libs, "even nodes", even):
        return 1
    del even

    from alink_tpu_torch.tree import grow, train_forest

    _, _, kept, restore = chip_smoke.instrument_forest(grow)
    try:
        train_forest(X[:n_tr], y[:n_tr].astype("float32"), task="binary",
                     num_trees=2, depth=chip_smoke.FOREST["maxDepth"],
                     num_bins=64, min_samples=5.0)
    finally:
        restore()
    return 1 if compare(libs, "forest tree 1", kept) else 0


def compare(libs, label, cases):
    """Times every variant on each (ids, vals, S); True on a mismatch."""
    import torch

    import chip_smoke
    from alink_tpu_torch.tree.hist_cuda import histogram_ref

    totals = dict.fromkeys(libs, 0.0)
    for ids, v, S in cases:
        n, d = ids.shape
        ref = histogram_ref(ids, v, num_segments=S)
        out = torch.zeros((S, d), device="cuda")
        stream = torch.cuda.current_stream().cuda_stream
        row = []
        for name, lib in libs.items():
            def run():
                out.zero_()
                if lib.hist_c(ids.data_ptr(), v.data_ptr(), out.data_ptr(),
                              n, d, S, stream) != 0:
                    raise RuntimeError(f"launch failed: {name}")
            run()
            torch.cuda.synchronize()
            if not torch.equal(out, ref):
                print(f"FAIL: {name} differs from histogram_ref at S={S}")
                return True
            ms = chip_smoke.cuda_ms(run)
            totals[name] += ms
            row.append(f"{name} {ms:.4f}")
        print(f"{label} S={S:6d} ms: " + "; ".join(row), flush=True)
    print(f"{label}, sum over the levels, ms: " + "; ".join(
        f"{k} {v:.4f}" for k, v in totals.items()), flush=True)
    return False


if __name__ == "__main__":
    sys.exit(main())
