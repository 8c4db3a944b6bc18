"""Registry of the port's hand-written CUDA kernels.

One record per kernel: the module holding its wrappers and their plain
PyTorch versions (one per entry of the kernel), the TPU kernel of
``alink_tpu`` it replaces, its CUDA source, and a launch counter. A wrapper adds one to its counter each time it launches its
kernel and nowhere else, so a run can show that its main path went through
the kernel (``reset_launches`` before, ``launches`` after).

:func:`build` compiles every kernel source with
``torch.utils.cpp_extension.load`` for ``sm_90a`` into ``build/kernels`` at
the repository root (``build/`` is the kernel cache, listed in
``.gitignore``) and loads the library, which registers the kernels as
``torch.ops.alink_tpu_torch.*``. It runs at a wrapper's first launch, never
at import: the CPU tests import every module on hosts without ``nvcc``.

A process started by one that has already built the library (a serving
fleet's replica) gets its path in ``ALINK_TORCH_KERNELS_LIB`` and loads it
as it is: ``load`` takes a file lock in the build directory on every call,
even with the library up to date, and a replica killed while holding it
would stall every later replica's first launch.
"""

from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO_ROOT = os.path.dirname(_PKG_DIR)
BUILD_DIR = os.path.join(REPO_ROOT, "build", "kernels")
BINDING = "csrc/bind.cpp"
CUDA_FLAGS = ["-O3", "-gencode=arch=compute_90a,code=sm_90a"]
PREBUILT_ENV = "ALINK_TORCH_KERNELS_LIB"


@dataclass
class KernelSpec:
    name: str
    module: str       # wrappers + plain versions, repo-relative
    plain: Tuple[str, ...]   # the plain PyTorch version of each entry there
    replaces: str     # the TPU kernel, file:line of its pl.pallas_call
    source: str       # CUDA source, package-relative
    route: str = "cuda"
    launches: int = 0


KERNELS: Dict[str, KernelSpec] = {
    "flash_block_update": KernelSpec(
        name="flash_block_update",
        module="alink_tpu_torch/dl/attn_cuda.py",
        plain=("flash_block_update_ref", "flash_blockwise_ref"),
        replaces="alink_tpu/dl/attn_pallas.py:114",
        source="csrc/flash_block_update.cu",
    ),
    "tree_histogram": KernelSpec(
        name="tree_histogram",
        module="alink_tpu_torch/tree/hist_cuda.py",
        plain=("level_histograms_ref",),
        replaces="alink_tpu/tree/pallas_hist.py:101",
        source="csrc/tree_histogram.cu",
    ),
    "sgns_block_grads": KernelSpec(
        name="sgns_block_grads",
        module="alink_tpu_torch/embedding/sgns_cuda.py",
        plain=("sgns_block_grads_ref", "sgns_pull_grads_ref"),
        replaces="alink_tpu/embedding/sgns_pallas.py:100",
        source="csrc/sgns_block_grads.cu",
    ),
}

_build_lock = threading.Lock()
_built: Optional[str] = None
build_seconds: Optional[float] = None


# ``launches += 1`` is a read, an add and a write: two threads launching
# the same kernel (two DAG branches, a server's batcher beside a caller)
# would lose counts without the lock
_count_lock = threading.Lock()


def count_launch(name: str) -> None:
    with _count_lock:
        KERNELS[name].launches += 1


def launches() -> Dict[str, int]:
    with _count_lock:
        return {n: k.launches for n, k in KERNELS.items()}


def reset_launches() -> None:
    with _count_lock:
        for k in KERNELS.values():
            k.launches = 0


def build(verbose: bool = False) -> str:
    """Compile and load every kernel (once per process); returns the path of
    the loaded library. Raises if the toolchain or the card is missing,
    or if ``ALINK_TORCH_KERNELS_LIB`` names a library that does not load."""
    global _built, build_seconds
    with _build_lock:
        if _built is not None:
            return _built
        prebuilt = os.environ.get(PREBUILT_ENV)
        if prebuilt:
            import torch

            t0 = time.perf_counter()
            torch.ops.load_library(prebuilt)
            build_seconds = time.perf_counter() - t0
            _built = prebuilt
            return _built
        from torch.utils.cpp_extension import load

        sources = [os.path.join(_PKG_DIR, k.source) for k in KERNELS.values()]
        sources.append(os.path.join(_PKG_DIR, BINDING))
        os.makedirs(BUILD_DIR, exist_ok=True)
        t0 = time.perf_counter()
        _built = load(
            name="alink_tpu_torch_kernels", sources=sources,
            build_directory=BUILD_DIR, extra_cflags=["-O3"],
            extra_cuda_cflags=CUDA_FLAGS, is_python_module=False,
            verbose=verbose)
        build_seconds = time.perf_counter() - t0
        return _built


def ops():
    """``torch.ops.alink_tpu_torch``, building the kernels on first use."""
    import torch

    build()
    return torch.ops.alink_tpu_torch
