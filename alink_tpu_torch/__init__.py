"""alink_tpu_torch — the PyTorch/CUDA port of alink_tpu.

A second package beside ``alink_tpu`` (the JAX reference, left unchanged):
the same paths and public names, PyTorch idiom inside, and each Pallas TPU
kernel on a ported path replaced by a hand-written CUDA kernel for Hopper
(``csrc/``, registry in ``native/kernels.py``). It imports nothing of JAX
and nothing of ``alink_tpu``.

Entry points run on ``cuda`` unless asked for the CPU (``device="cpu"`` or
``ALINK_TORCH_DEVICE=cpu``); see ``common/env.py``.
"""

__version__ = "0.1.0"
