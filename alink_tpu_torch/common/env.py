"""Session / environment layer of the port.

The ``env_*`` helpers are copied from ``alink_tpu.common.env``.
:class:`MLEnvironment` keeps the reference's session shape (a lazy-sink
manager, registered by id in :class:`MLEnvironmentFactory`) but holds a torch
device where the reference holds a JAX mesh, and the reference's two thread
pools: the session pool for host-side work inside a node (``executor``,
threads ``alink-local``) and the DAG pool the executor runs node tasks on
(``dag_pool``, threads ``alink-dag``; ``common/executor.py``). The
reference's jit cache has no counterpart (nothing is compiled per shape).

A worker thread never relies on PyTorch's thread-local current device:
every mapper reads its own ``device``, which the operator sets from the
session's :attr:`MLEnvironment.device`.

Device policy: entry points run on ``cuda`` unless the caller asks for the
CPU, either with an explicit ``device="cpu"`` or with ``ALINK_TORCH_DEVICE=cpu``
(the tests do the latter). Without a CUDA device and without such a request,
:func:`resolve_device` raises; it never falls back to the CPU quietly.
"""

from __future__ import annotations

import os
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Optional

from .exceptions import AkIllegalArgumentException, AkIllegalStateException

_FALSEY = ("0", "off", "false", "no", "")

DEVICE_ENV = "ALINK_TORCH_DEVICE"


def env_int(name: str, default: int) -> int:
    """Integer env knob; malformed values fall back to the default (config
    typos must never crash a running job)."""
    try:
        raw = os.environ.get(name)
        return default if raw is None or raw.strip() == "" else int(raw)
    except ValueError:
        return default


def env_float(name: str, default: "float | None") -> "float | None":
    try:
        raw = os.environ.get(name)
        return default if raw is None or raw.strip() == "" else float(raw)
    except ValueError:
        return default


def env_str(name: str, default: "str | None" = None) -> "str | None":
    """String env knob: the raw value when set and non-empty, else the
    default (empty/whitespace counts as unset — an exported-but-blank knob
    must behave like an absent one)."""
    raw = os.environ.get(name)
    if raw is None or raw.strip() == "":
        return default
    return raw


def env_raw(name: str) -> "str | None":
    """The value exactly as set (blank included); ``None`` only when absent."""
    return os.environ.get(name)


def env_flag(name: str, default: bool = False) -> bool:
    """Boolean env knob: "0"/"off"/"false"/"no" are false, anything else
    present is true, absent is the default."""
    raw = os.environ.get(name)
    if raw is None:
        return default
    return raw.strip().lower() not in _FALSEY


def kernel_knob_on(name: str) -> bool:
    """A kernel's opt-out knob (``ALINK_ATTN_PALLAS``, ``ALINK_GBDT_PALLAS``):
    False only when set to a falsey spelling; unset or blank keeps the
    kernel on."""
    flag = env_str(name)
    return flag is None or flag.strip().lower() not in _FALSEY


def resolve_device(device=None):
    """The torch device an entry point runs on.

    An explicit ``device`` wins; else ``ALINK_TORCH_DEVICE``; else ``cuda``.
    A CUDA device that is not available raises — the port never drops to the
    CPU unless asked to."""
    import torch

    if device is None:
        device = env_str(DEVICE_ENV, "cuda").strip()
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise AkIllegalStateException(
            f"no CUDA device is available; pass device='cpu' or set "
            f"{DEVICE_ENV}=cpu to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise AkIllegalArgumentException(
            f"unsupported device {device!r}: use 'cuda[:i]' or 'cpu'")
    return dev


def plugin_dir() -> str:
    """The local plugin directory pretrained resources are read from
    (the reference's ``AlinkGlobalConfiguration.get_plugin_dir``):
    ``ALINK_PLUGINS_DIR``, else ``plugins``."""
    return os.environ.get("ALINK_PLUGINS_DIR", "plugins")


class MLEnvironment:
    """One session: torch device + lazy-sink manager + host thread pools."""

    def __init__(self, device=None, parallelism: Optional[int] = None):
        from .lazy import LazyObjectsManager

        self._device_request = device
        self._parallelism = parallelism
        self.lazy_manager = LazyObjectsManager()
        self._pool: Optional[ThreadPoolExecutor] = None
        self._dag_pool: Optional[ThreadPoolExecutor] = None
        self._lock = threading.Lock()

    # -- host-side thread pool (AlinkLocalSession analog) ------------------
    @property
    def executor(self) -> ThreadPoolExecutor:
        with self._lock:
            if self._pool is None:
                self._pool = ThreadPoolExecutor(
                    max_workers=self.parallelism,
                    thread_name_prefix="alink-local")
            return self._pool

    # -- DAG scheduler pool -------------------------------------------------
    @property
    def dag_pool(self) -> ThreadPoolExecutor:
        """Threads running DAG *node* tasks (common/executor.py). Separate
        from ``executor`` so a node blocking on intra-op futures can never
        starve the pool those run on (two-level submit to one pool
        deadlocks once every worker waits on queued inner tasks)."""
        from .executor import _DAG_THREAD_PREFIX, _dag_pool_size

        with self._lock:
            if self._dag_pool is None:
                self._dag_pool = ThreadPoolExecutor(
                    max_workers=_dag_pool_size(self),
                    thread_name_prefix=_DAG_THREAD_PREFIX)
            return self._dag_pool

    @property
    def parallelism(self) -> int:
        if self._parallelism is not None:
            return self._parallelism
        return max(1, os.cpu_count() or 1)

    @property
    def device(self):
        """Resolved at each use (see :func:`resolve_device`), so a session
        can be created and an operator DAG built on a host without a card."""
        return resolve_device(self._device_request)

    def close(self):
        self.lazy_manager.clear()
        with self._lock:
            pools, self._pool, self._dag_pool = \
                (self._pool, self._dag_pool), None, None
        for pool in pools:
            if pool is not None:
                pool.shutdown(wait=False)


class MLEnvironmentFactory:
    """Session registry keyed by id (reference: common/MLEnvironmentFactory.java)."""

    _envs: Dict[int, MLEnvironment] = {}
    _next_id = 1
    _lock = threading.Lock()
    DEFAULT_ML_ENVIRONMENT_ID = 0

    @classmethod
    def get_default(cls) -> MLEnvironment:
        return cls.get(cls.DEFAULT_ML_ENVIRONMENT_ID)

    @classmethod
    def get(cls, session_id: int) -> MLEnvironment:
        with cls._lock:
            if session_id not in cls._envs:
                if session_id == cls.DEFAULT_ML_ENVIRONMENT_ID:
                    cls._envs[session_id] = MLEnvironment()
                else:
                    raise AkIllegalArgumentException(f"unknown session id {session_id}")
            return cls._envs[session_id]

    @classmethod
    def get_new_environment_id(cls, env: Optional[MLEnvironment] = None) -> int:
        with cls._lock:
            sid = cls._next_id
            cls._next_id += 1
            cls._envs[sid] = env or MLEnvironment()
            return sid

    @classmethod
    def remove(cls, session_id: int):
        with cls._lock:
            env = cls._envs.pop(session_id, None)
        if env is not None:
            env.close()

    @classmethod
    def reset_default(cls):
        """Force-reset the default session (test harness parity with
        reference AlinkTestBase.java:83-97)."""
        with cls._lock:
            env = cls._envs.pop(cls.DEFAULT_ML_ENVIRONMENT_ID, None)
        if env is not None:
            env.close()
