"""IterativeComQueue — the BSP iteration engine (port of
``alink_tpu.parallel.comqueue``).

Capability parity with the reference's iterative-communication queue
(reference: core/src/main/java/com/alibaba/alink/common/comqueue/BaseComQueue.java:39
exec at :168-331; IterativeComQueue.java; ComContext.java:8-70;
communication/AllReduce.java:41-125).

A *superstep* is a function ``fn(ctx, state, data) -> state`` over tensors;
row data is staged once on the device through the staging cache
(``common/staging.py``) and stays there; state is replicated. The
reference compiles the whole loop into one XLA program (``exec``) or jits
one superstep and decides on the host (``exec_host``). Eager torch has no
loop on the device, so both run the supersteps from Python and differ from
the reference only in where the decision is made: the criterion is
evaluated on the device after each superstep and read once (one host sync
per iteration); no superstep syncs otherwise.

The world is the ``torch.distributed`` ranks of the ``data`` axis. On one
rank the all-reduces are the identity; above one they raise
``NotImplementedError`` until the multi-rank slice (ROADMAP A3).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import numpy as np

from .mesh import AXIS_DATA, axis_size


def _single_rank(axis: str, what: str) -> int:
    m = axis_size(axis)
    if m != 1:
        raise NotImplementedError(
            f"{what} over {m} ranks is not ported yet (ROADMAP A3)")
    return m


class ComContext:
    """Per-superstep context handed to compute functions
    (reference: common/comqueue/ComContext.java:8-70 — getTaskId/getStepNo/
    getNumTask; the collectives live on it too)."""

    def __init__(self, axis: str, step_no, num_workers: int):
        self.axis = axis
        self.step_no = step_no
        self.num_workers = num_workers

    @property
    def task_id(self):
        return 0

    # -- collectives (reference: communication/AllReduce.java SUM/MAX/MIN);
    # the identity on one rank --------------------------------------------
    def _reduce(self, x, what):
        _single_rank(self.axis, what)
        return x

    def all_reduce_sum(self, x):
        return self._reduce(x, "all_reduce_sum")

    def all_reduce_max(self, x):
        return self._reduce(x, "all_reduce_max")

    def all_reduce_min(self, x):
        return self._reduce(x, "all_reduce_min")

    def pmean(self, x):
        return self._reduce(x, "pmean")

    def all_gather(self, x, axis: int = 0, tiled: bool = True):
        _single_rank(self.axis, "all_gather")
        return x if tiled else x.unsqueeze(axis)


def shard_rows(device, arr: np.ndarray, *, with_mask: bool = False,
               axis: str = AXIS_DATA):
    """Pad rows to a multiple of the data axis's ranks and place the array
    on ``device``. Returns the tensor (and optionally the validity mask for
    the padded tail — weight-0 rows for algorithms that aggregate).

    Staging goes through the device cache (``common/staging.py``):
    re-staging a table's memoized block is free of wire traffic, and an
    explicit bf16 wire upcasts on the device."""
    from ..common.staging import stage_sharded

    m = _single_rank(axis, "shard_rows")
    return stage_sharded(np.asarray(arr), device, m, with_mask=with_mask)


def _as_state(value, device):
    """Broadcast state as the reference holds it: ``jnp.asarray`` without
    64-bit types, so Python and numpy floats land as float32 and integers
    as int32."""
    import torch

    t = torch.as_tensor(np.asarray(value))
    if t.dtype == torch.float64:
        t = t.float()
    elif t.dtype == torch.int64:
        t = t.int()
    return t.to(device)


def _to_host(out):
    import torch

    if isinstance(out, dict):
        return {k: _to_host(v) for k, v in out.items()}
    if isinstance(out, torch.Tensor):
        return out.detach().cpu().numpy()
    return out


class IterativeComQueue:
    """Builder for a BSP iterative program (reference: IterativeComQueue API:
    initWithPartitionedData / initWithBroadcastData / add / setCompareCriterion /
    setMaxIter / closeWith / exec)."""

    def __init__(self, device=None, axis: str = AXIS_DATA):
        self._device = device
        self._axis = axis
        self._partitioned: Dict[str, np.ndarray] = {}
        self._broadcast: Dict[str, Any] = {}
        self._steps: List[Callable] = []
        self._criterion: Optional[Callable] = None
        self._close: Optional[Callable] = None
        self._max_iter = 10

    # -- builder -----------------------------------------------------------
    def init_with_partitioned_data(self, name: str, arr) -> "IterativeComQueue":
        """Rows shard over the data axis; all partitioned arrays must have the
        same row count. A validity mask is exposed as ``data["__mask__"]``
        (1.0 for real rows, 0.0 for the padded tail)."""
        arr = np.asarray(arr)
        for other_name, other in self._partitioned.items():
            if other.shape[0] != arr.shape[0]:
                from ..common.exceptions import AkIllegalArgumentException

                raise AkIllegalArgumentException(
                    f"partitioned data {name!r} has {arr.shape[0]} rows but "
                    f"{other_name!r} has {other.shape[0]}; row counts must match"
                )
        self._partitioned[name] = arr
        return self

    def init_with_broadcast_data(self, name: str, value) -> "IterativeComQueue":
        self._broadcast[name] = value
        return self

    def add(self, fn: Callable) -> "IterativeComQueue":
        """``fn(ctx, state, data) -> state`` — a ComputeFunction;
        communication happens inline through ``ctx.all_reduce_*``."""
        self._steps.append(fn)
        return self

    def set_max_iter(self, n: int) -> "IterativeComQueue":
        self._max_iter = int(n)
        return self

    def set_compare_criterion(self, fn: Callable) -> "IterativeComQueue":
        """``fn(ctx, state) -> bool scalar`` — True stops the loop (evaluated
        on the device after each superstep)."""
        self._criterion = fn
        return self

    def close_with(self, fn: Callable) -> "IterativeComQueue":
        """``fn(ctx, state, data) -> output dict`` run once after the loop."""
        self._close = fn
        return self

    # -- execution ---------------------------------------------------------
    def _run(self) -> Dict[str, Any]:
        from ..common.env import resolve_device

        device = resolve_device(self._device)
        axis = self._axis
        num_workers = _single_rank(axis, "IterativeComQueue")
        data = {}
        for name, arr in self._partitioned.items():
            if "__mask__" not in data:
                data[name], data["__mask__"] = shard_rows(
                    device, arr, with_mask=True, axis=axis)
            else:
                data[name] = shard_rows(device, arr, axis=axis)
        state = {k: _as_state(v, device) for k, v in self._broadcast.items()}
        i = 0
        while i < self._max_iter:
            ctx = ComContext(axis, i, num_workers)
            for fn in self._steps:
                state = fn(ctx, state, data)
            i += 1
            if self._criterion is not None and bool(
                    self._criterion(ctx, state)):
                break
        out: Any = dict(state)
        if self._close is not None:
            out = self._close(ComContext(axis, i, num_workers), state, data)
        if isinstance(out, dict):
            out = dict(out)
            out["__num_iters__"] = i
        return _to_host(out)

    def exec(self) -> Dict[str, Any]:
        """Run the loop; returns the final state (or ``close_with``'s
        output) as numpy, with ``__num_iters__``."""
        return self._run()

    def exec_host(self) -> Dict[str, Any]:
        """The reference's host-decided variant; in eager torch the loop is
        decided on the host either way, so it is :meth:`exec`."""
        return self._run()
