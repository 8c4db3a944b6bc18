"""Double-buffered host→device streaming (port of
``alink_tpu.common.streaming``: ``stream_map``, ``stream_depth``,
``iter_row_chunks``).

"Transfer, then compute, then transfer, ..." becomes a pipeline: batch *k+1*
is staged into pinned host memory and copied to the card with
``non_blocking`` copies on a side CUDA stream, on a transfer thread, while
the card computes batch *k*; the compute stream waits on each copy's CUDA
event, never on the host. At most ``depth`` transfers are in flight ahead of
compute, which bounds the pinned and device buffers a long table holds.

Knob (env): ``ALINK_STREAM_DEPTH`` — in-flight transfers (default 2: batch
*k* computing while *k+1* ships).

``stream_map(..., split=k)`` ships every batch as *k* row-chunk copies into
one device buffer, so the batch the function sees is bit-identical and its
shape is untouched.

``put=`` replaces the copy with the caller's own transfer function (the
pretraining feed tokenizes and masks a batch there, on the transfer
thread); it runs on the same side stream, so its copies are ordered the
same way. Every batch observes the ``stream.transfer_s``, ``stream.wait_s``
and ``stream.compute_s`` histograms (``common/metrics.py``).

Left out of the port: the reference's ``use_cache`` staging-cache route
(the port has no content-keyed device cache and no ``wire_is_slow``
probe), its ``ALINK_H2D_STREAMS`` thread pool, its retry and
fault-injection hooks (they wait for A10's ``common/faults.py``) and the
executor's node-phase accounting (A1).
On a CPU device a "transfer" wraps the host array as a tensor, and the
pipeline order, depth and phases are the same.
"""

from __future__ import annotations

import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Iterable, Iterator, Optional, Sequence, Tuple

import numpy as np

from .env import env_int, resolve_device

DEFAULT_DEPTH = 2


def stream_depth(default: int = DEFAULT_DEPTH) -> int:
    return max(1, env_int("ALINK_STREAM_DEPTH", default))


def _host_tensor(a):
    """A host array as a tensor, copied only when torch cannot wrap it (a
    read-only or strided block, such as a frozen MTable column)."""
    import torch

    a = np.asarray(a)
    if not (a.flags.writeable and a.flags.c_contiguous):
        a = np.array(a)
    return torch.from_numpy(a)


def _pinned(a):
    """A host array staged into pinned memory: one copy, any layout."""
    import torch

    a = np.asarray(a)
    dtype = torch.from_numpy(np.empty(0, a.dtype)).dtype
    host = torch.empty(a.shape, dtype=dtype, pin_memory=True)
    host.numpy()[...] = a
    return host


def _chunk_bounds(n: int, split: int):
    bounds = np.linspace(0, n, split + 1).astype(int)
    return [(s, e) for s, e in zip(bounds[:-1], bounds[1:]) if e > s]


class _Transfer:
    """One batch's copy to the card on ``stream``: staged into pinned host
    memory, copied in ``split`` row chunks (or handed to ``put``), its end
    recorded as ``done``. ``run`` blocks the transfer thread (never the
    consumer) until the copy has landed, so its wall time is the batch's
    transfer time."""

    def __init__(self, device, stream, split, put=None):
        self.device, self.stream, self.split = device, stream, split
        self.put = put

    def _copy(self, arrays):
        import torch

        devs = []
        for a in arrays:
            host = _pinned(a)
            out = torch.empty(host.shape, dtype=host.dtype,
                              device=self.device)
            parts = _chunk_bounds(host.shape[0], self.split) \
                if host.ndim and host.shape[0] >= self.split else None
            if parts is None:
                out.copy_(host, non_blocking=True)
            else:
                for s, e in parts:
                    out[s:e].copy_(host[s:e], non_blocking=True)
            devs.append(out)
        return devs

    def run(self, arrays):
        import torch

        t0 = time.perf_counter()
        if self.device.type != "cuda":
            devs = list(self.put(arrays)) if self.put is not None \
                else [_host_tensor(a) for a in arrays]
            return devs, None, time.perf_counter() - t0
        with torch.cuda.device(self.device), torch.cuda.stream(self.stream):
            devs = list(self.put(arrays)) if self.put is not None \
                else self._copy(arrays)
            done = torch.cuda.Event()
            done.record(self.stream)
        done.synchronize()
        return devs, done, time.perf_counter() - t0


def stream_map(
    fn: Callable[..., Any],
    batches: Iterable[Tuple[Any, Sequence[Any]]],
    *,
    depth: Optional[int] = None,
    put: Optional[Callable[[Sequence[Any]], Sequence[Any]]] = None,
    split: int = 1,
    phases: Optional[dict] = None,
    device=None,
) -> Iterator[Tuple[Any, Any]]:
    """Yield ``(meta, fn(*device_tensors))`` for each ``(meta, host_arrays)``
    in ``batches``, with up to ``depth`` transfers in flight ahead of compute
    and results in input order. ``device`` defaults to
    :func:`~alink_tpu_torch.common.env.resolve_device`.

    ``put(host_arrays) -> device tensors`` replaces the default pinned
    copy (the transfer thread runs it on the side stream; its tensors must
    be on ``device``); ``split=k`` copies each batch of the default copy as
    *k* row chunks into one device buffer (bit-identical input). The
    ``stream.transfer_s``, ``stream.wait_s`` and ``stream.compute_s``
    histograms observe every batch. ``phases`` (optional dict) accumulates
    ``transfer_s`` (the transfer thread's wall per batch: pinning and the
    copy until it landed), ``wait_s`` (the consumer's stall on an in-flight
    transfer — ~0 when the pipeline overlaps), ``compute_s`` (host time in
    ``fn``: issue, or the whole call where ``fn`` syncs) and ``batches``."""
    import torch

    from .metrics import metrics

    dev = resolve_device(device)
    depth = stream_depth(DEFAULT_DEPTH) if depth is None else max(1, depth)
    stream = torch.cuda.Stream(device=dev) if dev.type == "cuda" else None
    transfer = _Transfer(dev, stream, max(1, int(split)), put)
    it = iter(batches)
    inflight: deque = deque()
    with ThreadPoolExecutor(max_workers=1,
                            thread_name_prefix="alink-h2d") as pool:

        def pump():
            while len(inflight) < depth:
                try:
                    meta, arrays = next(it)
                except StopIteration:
                    return
                inflight.append((meta, pool.submit(transfer.run, arrays)))

        pump()
        while inflight:
            meta, fut = inflight.popleft()
            t_wait = time.perf_counter()
            devs, done, dt_put = fut.result()
            dt_wait = time.perf_counter() - t_wait
            if done is not None:
                # the copy ran on the side stream: order the compute stream
                # after it, and tell the allocator the buffers are used here
                cur = torch.cuda.current_stream(dev)
                cur.wait_event(done)
                for d in devs:
                    d.record_stream(cur)
            t0 = time.perf_counter()
            out = fn(*devs)
            dt_fn = time.perf_counter() - t0
            metrics.observe("stream.transfer_s", dt_put)
            metrics.observe("stream.wait_s", dt_wait)
            metrics.observe("stream.compute_s", dt_fn)
            if phases is not None:
                phases["transfer_s"] = phases.get("transfer_s", 0.0) + dt_put
                phases["wait_s"] = phases.get("wait_s", 0.0) + dt_wait
                phases["compute_s"] = phases.get("compute_s", 0.0) + dt_fn
                phases["batches"] = phases.get("batches", 0) + 1
            pump()  # keep the pipe full before handing control back
            yield meta, out


def iter_row_chunks(arrays: Sequence[Any], chunk_rows: int):
    """Split row-aligned host arrays into ``(n_valid, [chunks])`` micro-batches
    — the generic feeder for :func:`stream_map` over one logical table."""
    n = arrays[0].shape[0]
    for s in range(0, n, chunk_rows):
        part = [a[s:s + chunk_rows] for a in arrays]
        yield part[0].shape[0], part
