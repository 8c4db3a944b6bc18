"""Socket data plane + failover load balancer for the serving fleet (port
of ``alink_tpu.serving.fleet_frontend``, copied but for the wire guard
below).

The fleet's request path has two halves. This module is the half that
moves requests: a length-prefixed pickle **frame protocol** (the data
plane every replica worker serves on a real TCP socket), a pooled
:class:`ReplicaClient` per replica, and the :class:`FleetFrontend` load
balancer that routes each request to a healthy replica and **fails over**
when one dies mid-call. The other half — process supervision, health,
respawn, autoscale — lives in ``serving/fleet.py``.

Delivery contract (the fleet's robustness center): a request the
front-end accepts either returns a result or completes with a *typed*
error — it never vanishes. Concretely:

- transport failure (replica died mid-batch, connection refused, socket
  timeout) → the replica's ``fleet:<replica>`` circuit breaker records a
  failure, ``fleet.failovers`` counts, and the request **re-dispatches**
  to another healthy replica under a :class:`RetryPolicy`, the original
  deadline still honored (re-dispatch is safe: predicts are pure);
- a *typed* serving error decoded off the wire (overload shed, breaker
  reject, deadline, bad row) propagates to the caller unchanged — the
  replica answered, so it is healthy and the error is the answer;
- a replica that reports itself draining (the ``__draining__`` sentinel)
  is not an error at all: the request silently re-dispatches;
- no routable replica, or the re-dispatch budget exhausted → a typed
  :class:`~alink_tpu_torch.common.exceptions.AkServingOverloadException`.

Frames are ``4-byte big-endian length + pickle``. Pickle (not JSON) is
deliberate: rows round-trip **bitwise** including numpy scalar types, so
the fleet ≡ single-process bit-parity gate holds by construction. The
trust boundary matches the transport: frames are only ever exchanged
between a supervisor and worker processes it spawned itself, over
loopback sockets bound to 127.0.0.1 — never across machines or trust
domains.

Rows and results cross the wire as Python or numpy values, never as torch
tensors: a replica's tensors live on its own card context, and a pickled
CUDA tensor would make the receiving process initialise CUDA to rebuild
it. The frame pickler refuses any torch object with a ``TypeError``
before a byte is sent.
"""

from __future__ import annotations

import io
import pickle
import socket
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from ..common.exceptions import (
    AkCircuitOpenException,
    AkDeadlineExceededException,
    AkExecutionErrorException,
    AkIllegalArgumentException,
    AkIllegalDataException,
    AkIllegalOperationException,
    AkIllegalStateException,
    AkServingOverloadException,
)
from ..common.metrics import metrics
from ..common.resilience import CircuitBreaker, RetryPolicy
from ..common.tracing import (adopt_context, note_retry, trace_span,
                              wire_context)

#: Upper bound on one frame — a corrupt length prefix must not make the
#: reader try to allocate gigabytes.
MAX_FRAME_BYTES = 64 << 20

#: Wire sentinel a draining replica answers predicts with. NOT a caller
#: error: the front-end re-dispatches instead of raising.
DRAINING = "__draining__"

# Exception types that cross the wire by name. Anything not in this map
# decodes as AkExecutionErrorException with the original type in the
# message — the caller still gets a typed (if generic) error.
_ETYPES = {
    cls.__name__: cls
    for cls in (
        AkServingOverloadException,
        AkCircuitOpenException,
        AkDeadlineExceededException,
        AkIllegalArgumentException,
        AkIllegalStateException,
        AkIllegalOperationException,
        AkIllegalDataException,
        AkExecutionErrorException,
    )
}


# ---------------------------------------------------------------------------
# Frame protocol
# ---------------------------------------------------------------------------


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed mid-frame")
        buf.extend(chunk)
    return bytes(buf)


class _FramePickler(pickle.Pickler):
    """Pickler of the frames: refuses torch objects (see the module
    docstring) wherever they sit in the frame."""

    def reducer_override(self, obj):
        if type(obj).__module__.split(".", 1)[0] == "torch":
            raise TypeError(
                f"a torch {type(obj).__name__} cannot cross the fleet's "
                "wire: send Python or numpy values")
        return NotImplemented


def send_frame(sock: socket.socket, obj: Any) -> None:
    buf = io.BytesIO()
    _FramePickler(buf, protocol=pickle.HIGHEST_PROTOCOL).dump(obj)
    payload = buf.getvalue()
    sock.sendall(len(payload).to_bytes(4, "big") + payload)


def recv_frame(sock: socket.socket) -> Any:
    n = int.from_bytes(_recv_exact(sock, 4), "big")
    if n > MAX_FRAME_BYTES:
        raise ConnectionError(f"frame of {n} bytes exceeds the "
                              f"{MAX_FRAME_BYTES}-byte bound")
    return pickle.loads(_recv_exact(sock, n))


def encode_error(exc: BaseException) -> Dict[str, Any]:
    return {"ok": False, "etype": type(exc).__name__, "msg": str(exc)}


def decode_error(resp: Dict[str, Any]) -> BaseException:
    etype = resp.get("etype") or ""
    msg = resp.get("msg") or "replica error"
    cls = _ETYPES.get(etype)
    if cls is None:
        return AkExecutionErrorException(f"replica failed with {etype}: "
                                         f"{msg}")
    return cls(msg)


# ---------------------------------------------------------------------------
# Per-replica client
# ---------------------------------------------------------------------------


class ReplicaClient:
    """Pooled frame-protocol client for one replica's data socket.

    Connections are created lazily, reused across calls, and closed on
    any transport error (a half-delivered frame poisons the stream — the
    next call must start on a fresh connection)."""

    def __init__(self, rid: str, host: str, port: int, *,
                 connect_timeout: float = 5.0, pool_size: int = 8):
        self.rid = rid
        self.host = host
        self.port = port
        self.connect_timeout = connect_timeout
        self._pool_size = pool_size
        self._lock = threading.Lock()
        self._pool: deque = deque()
        self._closed = False

    def _checkout(self) -> socket.socket:
        with self._lock:
            if self._closed:
                raise ConnectionError(f"client for {self.rid} is closed")
            if self._pool:
                return self._pool.popleft()
        return socket.create_connection((self.host, self.port),
                                        timeout=self.connect_timeout)

    def _checkin(self, sock: socket.socket) -> None:
        with self._lock:
            if not self._closed and len(self._pool) < self._pool_size:
                self._pool.append(sock)
                return
        sock.close()

    def call(self, op: Dict[str, Any],
             timeout: Optional[float] = None) -> Dict[str, Any]:
        """One request/response round trip. Raises the transport error
        unchanged on failure; returns the raw response dict (the caller
        decodes ``ok``/``etype``)."""
        sock = self._checkout()
        try:
            sock.settimeout(timeout)
            send_frame(sock, op)
            resp = recv_frame(sock)
        except BaseException:
            sock.close()
            raise
        if not isinstance(resp, dict):
            sock.close()
            raise ConnectionError(
                f"malformed response from replica {self.rid}")
        self._checkin(sock)
        return resp

    def close(self) -> None:
        with self._lock:
            self._closed = True
            socks = list(self._pool)
            self._pool.clear()
        for s in socks:
            s.close()


# ---------------------------------------------------------------------------
# Failover router
# ---------------------------------------------------------------------------

#: Errors that mean "the replica did not answer" — the only class of
#: failure that triggers re-dispatch. socket.timeout is an OSError
#: subclass; pickle errors mean a torn frame off a dying peer.
TRANSPORT_ERRORS = (ConnectionError, OSError, EOFError,
                    pickle.UnpicklingError)


class FleetFrontend:
    """Round-robin load balancer with breaker-guarded failover.

    ``targets`` is a callable returning the currently *routable*
    replicas as ``[(rid, ReplicaClient), ...]`` — the supervisor owns
    membership and health; the front-end only routes. Each replica's
    health additionally gates on its registry breaker
    (``fleet:<rid>``), which transport failures observed here feed."""

    def __init__(self, targets: Callable[[], List[Tuple[str,
                                                        "ReplicaClient"]]],
                 *, retry: Optional[RetryPolicy] = None):
        self._targets = targets
        self._retry = retry or RetryPolicy(max_attempts=4, base_delay=0.01,
                                           max_delay=0.25)
        self._rr_lock = threading.Lock()
        self._rr = 0

    def _pick(self, exclude: Optional[str] = None
              ) -> Optional[Tuple[str, "ReplicaClient", CircuitBreaker]]:
        """Next routable replica past its breaker, round-robin. Skips
        ``exclude`` (the replica that just failed) unless it is the only
        one left."""
        targets = self._targets()
        if not targets:
            return None
        with self._rr_lock:
            self._rr += 1
            start = self._rr
        order = [targets[(start + i) % len(targets)]
                 for i in range(len(targets))]
        if exclude is not None and len(order) > 1:
            order = [t for t in order if t[0] != exclude] \
                or order
        for rid, client in order:
            breaker = CircuitBreaker.for_endpoint(f"fleet:{rid}")
            try:
                breaker.before_call()
            except AkCircuitOpenException:
                continue
            return rid, client, breaker
        return None

    def call(self, op: Dict[str, Any], *, deadline_s: float,
             model: str = "") -> Any:
        """Dispatch ``op`` to a healthy replica; re-dispatch on transport
        failure or a draining replica; return the decoded value or raise
        the decoded typed error. Never returns nothing: exhausting the
        budget raises a typed overload error."""
        start = time.perf_counter()
        deadline = start + deadline_s
        attempts = 0
        last: Optional[BaseException] = None
        last_rid: Optional[str] = None
        while attempts < self._retry.max_attempts:
            remaining = deadline - time.perf_counter()
            if remaining <= 0:
                metrics.incr("fleet.deadline_expired")
                raise AkDeadlineExceededException(
                    f"fleet request deadline ({deadline_s:.3f}s) expired "
                    f"after {attempts} dispatch attempt(s)")
            picked = self._pick(exclude=last_rid)
            if picked is None:
                metrics.incr("fleet.no_replica")
                raise AkServingOverloadException(
                    "no healthy replica available"
                    + (f" for model {model!r}" if model else ""))
            rid, client, breaker = picked
            attempts += 1
            try:
                # the socket budget trails the request deadline slightly
                # so the replica's own deadline error (typed) wins the
                # race against a raw socket timeout when both would fire
                resp = client.call({**op, "deadline_s": remaining},
                                   timeout=remaining + 1.0)
            except TRANSPORT_ERRORS as e:
                breaker.record_failure()
                metrics.incr("fleet.failovers")
                note_retry()  # the request span reads ``retried``
                last, last_rid = e, rid
                continue
            if resp.get("ok"):
                breaker.record_success()
                metrics.observe("fleet.request_s",
                                time.perf_counter() - start)
                return resp.get("value")
            if resp.get("etype") == DRAINING:
                # not a health verdict: the replica is retiring cleanly
                breaker.release_probe()
                metrics.incr("fleet.drain_redirects")
                last_rid = rid
                continue
            breaker.record_success()  # it answered; the error is the answer
            metrics.observe("fleet.request_s", time.perf_counter() - start)
            raise decode_error(resp)
        raise AkServingOverloadException(
            f"request failed over {attempts} dispatch attempts"
            + (f" (last replica error: {last!r})" if last else "")) from last

    # -- request API ---------------------------------------------------------
    # Every request opens a ``fleet.request`` span and stamps its wire
    # context into the frame, so the replica-side batcher spans parent
    # under THIS span in one stitched trace. With tracing off the field
    # is None — the request dict shape (and the served bits) never change.
    def predict(self, name: str, row: Sequence, *,
                timeout: float) -> Tuple:
        with trace_span("fleet.request", model=name):
            return self.call({"op": "predict", "name": name,
                              "row": tuple(row),
                              "trace": wire_context()},
                             deadline_s=timeout, model=name)

    def predict_many(self, name: str, rows: Sequence[Sequence], *,
                     timeout: float) -> List[Tuple]:
        with trace_span("fleet.request", model=name,
                        rows=len(rows)):
            return self.call({"op": "predict_many", "name": name,
                              "rows": [tuple(r) for r in rows],
                              "trace": wire_context()},
                             deadline_s=timeout, model=name)


# ---------------------------------------------------------------------------
# External socket front door
# ---------------------------------------------------------------------------


class FrontendListener:
    """TCP front door speaking the same frame protocol to external
    clients, forwarding through a :class:`FleetFrontend`. Lets non-WebUI
    clients hit the fleet over one stable socket regardless of which
    replicas are alive behind it. Typed errors encode back onto the wire
    the same way replicas encode them."""

    def __init__(self, frontend: FleetFrontend, *,
                 host: str = "127.0.0.1", port: int = 0,
                 default_timeout_s: float = 30.0):
        self._frontend = frontend
        self._default_timeout_s = default_timeout_s
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(64)
        self.host, self.port = self._sock.getsockname()
        self._closed = False
        self._thread = threading.Thread(target=self._accept_loop,
                                        name="alink-fleet-frontdoor",
                                        daemon=True)
        self._thread.start()

    def _accept_loop(self) -> None:
        while not self._closed:
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return  # listener closed
            threading.Thread(target=self._serve_conn, args=(conn,),
                             daemon=True).start()

    def _serve_conn(self, conn: socket.socket) -> None:
        try:
            while True:
                op = recv_frame(conn)
                try:
                    kind = op.get("op")
                    timeout = float(op.get("deadline_s")
                                    or self._default_timeout_s)
                    # a tracing client's context parents the whole fleet
                    # request tree; absent/None (old clients) or garbage
                    # is tolerated — spans fall back to local roots
                    with adopt_context(op.get("trace")):
                        if kind == "predict":
                            val = self._frontend.predict(
                                op["name"], op["row"], timeout=timeout)
                        elif kind == "predict_many":
                            val = self._frontend.predict_many(
                                op["name"], op["rows"], timeout=timeout)
                        elif kind == "ping":
                            val = True
                        else:
                            raise AkIllegalArgumentException(
                                f"unknown fleet op {kind!r}")
                    send_frame(conn, {"ok": True, "value": val})
                except TRANSPORT_ERRORS:
                    raise  # the CLIENT connection broke — stop serving it
                except BaseException as e:
                    send_frame(conn, encode_error(e))
        except TRANSPORT_ERRORS:
            metrics.incr("fleet.frontdoor_disconnects")
        finally:
            conn.close()

    def close(self) -> None:
        self._closed = True
        try:
            self._sock.close()
        except OSError:
            metrics.incr("fleet.frontdoor_close_errors")
