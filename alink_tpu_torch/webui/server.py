"""stdlib HTTP server + experiment store + DAG runner for the WebUI (port
of ``alink_tpu.webui.server``).

(reference: webui/server — ExperimentController/NodeController/
EdgeController REST over JPA, embedded job execution; here one module.)

Routes: ``GET /metrics`` (Prometheus text), ``/api/ops``, ``/api/traces``,
``/api/experiments`` and ``/api/serving``; the serving POST/DELETE routes
(load, predict, unload; a shed answers 429, an open breaker 503, an expired
deadline 504). ``/api/profile`` and ``/api/analysis`` answer 501 naming the
ROADMAP item their modules wait for.
"""

from __future__ import annotations

import json
import os
import threading
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..common.catalog import list_operators, op_info
from ..common.exceptions import (
    AkCircuitOpenException,
    AkDeadlineExceededException,
    AkIllegalArgumentException,
    AkServingOverloadException,
)
from ..common.metrics import metrics
from ..common.mtable import MTable
from ..common.tracing import job_report, trace_span, tracer


# -- op registry --------------------------------------------------------------


def _op_index() -> Dict[str, type]:
    idx: Dict[str, type] = {}
    for kind, classes in list_operators().items():
        for cls in classes:
            idx[cls.__name__] = cls
    return idx


_INDEX: Optional[Dict[str, type]] = None


def op_index() -> Dict[str, type]:
    global _INDEX
    if _INDEX is None:
        _INDEX = _op_index()
    return _INDEX


# -- DAG execution ------------------------------------------------------------


def _table_payload(t: MTable, limit: int = 50) -> dict:
    rows = []
    for i, row in enumerate(t.rows()):
        if i >= limit:
            break
        rows.append([_json_cell(v) for v in row])
    return {
        "schema": [{"name": n, "type": tp}
                   for n, tp in zip(t.names, t.schema.types)],
        "num_rows": t.num_rows,
        "rows": rows,
    }


def _json_cell(v):
    if v is None:
        return None
    if isinstance(v, (np.integer,)):
        return int(v)
    if isinstance(v, (np.floating, float)):
        f = float(v)
        return None if f != f else f
    if isinstance(v, (np.bool_,)):
        return bool(v)
    if isinstance(v, (str, int, bool)):
        return v
    return str(v)


def run_experiment(exp: dict) -> Dict[str, dict]:
    """Execute an experiment {nodes: [{id, op, params}], edges: [{src, dst,
    dstPort?}]} and return per-node output payloads (table head + schema).

    The whole run is ONE trace (root span ``webui.run_experiment``): every
    node's ``collect()`` parents its DAG spans under it, so
    ``job_report(results["__trace_id__"])`` — or the UI's Traces panel —
    shows the experiment as a single waterfall. The trace id rides the
    result dict under the reserved ``__trace_id__`` key (None when
    ``ALINK_TRACING=off``).

    ``MemSourceBatchOp`` nodes take ``rows`` + ``schemaStr`` params inline
    (the WebUI's data-entry node)."""
    with trace_span("webui.run_experiment",
                    experiment=exp.get("name")) as sp:
        results = _run_experiment_inner(exp)
    results["__trace_id__"] = sp.trace_id if sp is not None else None
    return results


def _run_experiment_inner(exp: dict) -> Dict[str, dict]:
    nodes = {n["id"]: n for n in exp.get("nodes", [])}
    edges = exp.get("edges", [])
    idx = op_index()

    incoming: Dict[str, List[Tuple[int, str]]] = {nid: [] for nid in nodes}
    for e in edges:
        if e["src"] not in nodes or e["dst"] not in nodes:
            raise AkIllegalArgumentException(
                f"edge {e} references a missing node")
        incoming[e["dst"]].append((int(e.get("dstPort", 0)), e["src"]))

    # topological order (DFS)
    order: List[str] = []
    state: Dict[str, int] = {}

    def visit(nid: str):
        st = state.get(nid)
        if st == 1:
            return
        if st == 0:
            raise AkIllegalArgumentException(f"cycle at node '{nid}'")
        state[nid] = 0
        for _, src in sorted(incoming[nid]):
            visit(src)
        state[nid] = 1
        order.append(nid)

    for nid in nodes:
        visit(nid)

    built: Dict[str, Any] = {}
    results: Dict[str, dict] = {}
    for nid in order:
        spec = nodes[nid]
        op_name = spec["op"]
        params = dict(spec.get("params") or {})
        cls = idx.get(op_name)
        if cls is None:
            raise AkIllegalArgumentException(f"unknown operator '{op_name}'")
        try:
            if op_name == "MemSourceBatchOp":
                op = cls(params.pop("rows", []),
                         params.pop("schemaStr", ""), **params)
            else:
                # sugar ops (Select/Filter/GroupBy...) take positional ctor
                # args; the UI passes them as the "__args__" list
                pos = params.pop("__args__", [])
                op = cls(*pos, **params)
            ins = [built[src]
                   for _, src in sorted(incoming[nid])]
            if ins:
                op = op.link_from(*ins)
            built[nid] = op
            results[nid] = {"status": "ok",
                            "table": _table_payload(op.collect())}
        except Exception as e:  # per-node failure surfaces in the UI
            results[nid] = {"status": "error",
                            "error": f"{type(e).__name__}: {e}",
                            "trace": traceback.format_exc(limit=5)}
            # downstream nodes of a failed node are skipped
            built[nid] = None
    # mark nodes skipped due to failed inputs
    for nid in order:
        if results.get(nid, {}).get("status") == "ok":
            continue
        for e in edges:
            if e["src"] == nid and results.get(e["dst"], {}).get(
                    "status") == "error":
                results[e["dst"]]["status"] = "skipped"
    return results


# -- experiment store ---------------------------------------------------------


class ExperimentStore:
    """JSON-file-backed experiment CRUD (the JPA repositories analog)."""

    def __init__(self, path: Optional[str] = None):
        self.path = path or os.path.join(
            os.path.expanduser("~"), ".alink_tpu_torch", "experiments.json")
        self._lock = threading.Lock()
        self._data: Dict[str, dict] = {}
        self._next_id = 1
        if os.path.exists(self.path):
            try:
                with open(self.path) as f:
                    blob = json.load(f)
                self._data = blob.get("experiments", {})
                self._next_id = blob.get("next_id", len(self._data) + 1)
            except Exception:
                pass

    def _persist(self):
        os.makedirs(os.path.dirname(self.path), exist_ok=True)
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"experiments": self._data,
                       "next_id": self._next_id}, f)
        os.replace(tmp, self.path)

    def list(self) -> List[dict]:
        with self._lock:
            return [{"id": k, "name": v.get("name", k),
                     "num_nodes": len(v.get("nodes", []))}
                    for k, v in sorted(self._data.items(),
                                       key=lambda kv: int(kv[0]))]

    def get(self, eid: str) -> Optional[dict]:
        with self._lock:
            exp = self._data.get(eid)
            return None if exp is None else {"id": eid, **exp}

    def create(self, payload: dict) -> dict:
        with self._lock:
            eid = str(self._next_id)
            self._next_id += 1
            self._data[eid] = {
                "name": payload.get("name", f"experiment-{eid}"),
                "nodes": payload.get("nodes", []),
                "edges": payload.get("edges", []),
            }
            self._persist()
            return {"id": eid, **self._data[eid]}

    def update(self, eid: str, payload: dict) -> Optional[dict]:
        with self._lock:
            if eid not in self._data:
                return None
            exp = self._data[eid]
            for k in ("name", "nodes", "edges"):
                if k in payload:
                    exp[k] = payload[k]
            self._persist()
            return {"id": eid, **exp}

    def delete(self, eid: str) -> bool:
        with self._lock:
            gone = self._data.pop(eid, None) is not None
            if gone:
                self._persist()
            return gone


# -- HTTP server --------------------------------------------------------------


_STATIC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "static")


class _Handler(BaseHTTPRequestHandler):
    server_version = "AlinkTorchWebUI/1.0"
    store: ExperimentStore = None  # set by WebUIServer
    model_server = None            # set by WebUIServer (ModelServer)

    @classmethod
    def _serving(cls):
        if cls.model_server is None:
            from ..serving import default_server

            cls.model_server = default_server()
        return cls.model_server

    # -- helpers --
    def _send_json(self, obj, code: int = 200):
        self._send_text(json.dumps(obj), "application/json", code)

    def _send_text(self, text: str, ctype: str, code: int = 200):
        data = text.encode("utf-8")
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def _body(self) -> dict:
        length = int(self.headers.get("Content-Length", 0) or 0)
        if not length:
            return {}
        return json.loads(self.rfile.read(length))

    def log_message(self, fmt, *args):  # quiet by default
        pass

    # -- routing --
    def do_GET(self):
        parts = [p for p in self.path.split("?")[0].split("/") if p]
        try:
            if not parts or parts == ["index.html"]:
                return self._static("index.html")
            if parts == ["metrics"]:
                # Prometheus text exposition of the live process metrics —
                # point a scraper at a serving WebUI and it just works
                return self._send_text(
                    metrics.export_prometheus(),
                    "text/plain; version=0.0.4; charset=utf-8")
            if parts[0] == "api":
                return self._api_get(parts[1:])
            return self._static("/".join(parts))
        except BrokenPipeError:
            pass
        except Exception as e:
            self._send_json({"error": f"{type(e).__name__}: {e}"}, 500)

    def do_POST(self):
        parts = [p for p in self.path.split("?")[0].split("/") if p]
        try:
            if parts[:2] == ["api", "serving"]:
                return self._serving_post(parts[2:])
            if parts[:2] == ["api", "experiments"]:
                if len(parts) == 2:
                    return self._send_json(self.store.create(self._body()))
                if len(parts) == 4 and parts[3] == "run":
                    exp = self.store.get(parts[2])
                    if exp is None:
                        return self._send_json(
                            {"error": "no such experiment"}, 404)
                    results = run_experiment(exp)
                    trace_id = results.pop("__trace_id__", None)
                    return self._send_json(
                        {"results": results, "trace_id": trace_id})
            self._send_json({"error": "not found"}, 404)
        except BrokenPipeError:
            pass
        except Exception as e:
            self._send_json({"error": f"{type(e).__name__}: {e}"}, 500)

    def do_PUT(self):
        parts = [p for p in self.path.split("?")[0].split("/") if p]
        try:
            if parts[:2] == ["api", "experiments"] and len(parts) == 3:
                out = self.store.update(parts[2], self._body())
                if out is None:
                    return self._send_json({"error": "no such experiment"},
                                           404)
                return self._send_json(out)
            self._send_json({"error": "not found"}, 404)
        except Exception as e:
            self._send_json({"error": f"{type(e).__name__}: {e}"}, 500)

    def do_DELETE(self):
        parts = [p for p in self.path.split("?")[0].split("/") if p]
        try:
            if (parts[:3] == ["api", "serving", "models"]
                    and len(parts) == 4):
                if self._serving().unload(parts[3]):
                    return self._send_json({"unloaded": parts[3]})
                return self._send_json({"error": "no such model"}, 404)
            if parts[:2] == ["api", "experiments"] and len(parts) == 3:
                if self.store.delete(parts[2]):
                    return self._send_json({"deleted": parts[2]})
                return self._send_json({"error": "no such experiment"}, 404)
            self._send_json({"error": "not found"}, 404)
        except Exception as e:
            self._send_json({"error": f"{type(e).__name__}: {e}"}, 500)

    # -- GET endpoints --
    def _api_get(self, parts: List[str]):
        if parts == ["ops"]:
            cats: Dict[str, List[str]] = {}
            for kind, classes in list_operators().items():
                for cls in classes:
                    cat = cls.__module__.rsplit(".", 1)[-1]
                    cats.setdefault(f"{kind}/{cat}", []).append(cls.__name__)
            return self._send_json(
                {"categories": {k: sorted(v) for k, v in sorted(cats.items())}})
        if len(parts) == 2 and parts[0] == "ops":
            cls = op_index().get(parts[1])
            if cls is None:
                return self._send_json({"error": "unknown op"}, 404)
            return self._send_json(op_info(cls))
        if parts == ["profile"]:
            return self._send_json(
                {"error": "not ported yet: the per-kernel cost table "
                          "(common/profiling.py) waits for ROADMAP A10"}, 501)
        if parts[:1] == ["analysis"]:
            return self._send_json(
                {"error": "not ported yet: the plan validator's rules and "
                          "the source linter wait for ROADMAP A10"}, 501)
        if parts == ["traces"]:
            return self._send_json({"traces": tracer.traces()})
        if len(parts) == 2 and parts[0] == "traces":
            rep = job_report(parts[1])
            if "error" in rep:
                return self._send_json(rep, 404)
            return self._send_json(rep)
        if parts == ["experiments"]:
            return self._send_json({"experiments": self.store.list()})
        if len(parts) == 2 and parts[0] == "experiments":
            exp = self.store.get(parts[1])
            if exp is None:
                return self._send_json({"error": "no such experiment"}, 404)
            return self._send_json(exp)
        if parts == ["serving"]:
            # full summary (not bare stats): joins the jit trace counters
            # and, when a ServingFleet is live in this process, the fleet
            # block with per-replica health
            from ..serving.router import serving_summary

            return self._send_json(serving_summary(self._serving()))
        return self._send_json({"error": "not found"}, 404)

    # -- serving endpoints --
    def _serving_post(self, parts: List[str]):
        """POST /api/serving/models — load (or hot-swap) a saved pipeline
        (optional "precision": "int8"/"bf16" requests a quantized load —
        the response's "precision" block reports the effective policy and
        any counted fallback reason);
        POST /api/serving/predict/<name> — synchronous predict of one row
        ({"row": [...]}) or a row set ({"rows": [[...], ...]}).

        Overload/degradation map onto transport codes: shed → 429, breaker
        open → 503, deadline expired → 504."""
        srv = self._serving()
        try:
            if parts == ["models"]:
                body = self._body()
                if not body.get("name") or not body.get("path"):
                    return self._send_json(
                        {"error": "body requires 'name' and 'path'"}, 400)
                out = srv.load(
                    body["name"], body["path"],
                    body.get("inputSchema"),
                    warmup_rows=body.get("warmupRows"),
                    precision=body.get("precision"))
                return self._send_json(out)
            if len(parts) == 2 and parts[0] == "predict":
                body = self._body()
                if "row" not in body and "rows" not in body:
                    return self._send_json(
                        {"error": "body requires 'row' or 'rows'"}, 400)
                timeout = body.get("timeoutS")
                priority = bool(body.get("priority", False))
                if "rows" in body:
                    rows = srv.predict_many(parts[1], body["rows"],
                                            timeout=timeout,
                                            priority=priority)
                    return self._send_json(
                        {"rows": [[_json_cell(v) for v in r] for r in rows]})
                row = srv.predict(parts[1], body["row"], timeout=timeout,
                                  priority=priority)
                return self._send_json(
                    {"row": [_json_cell(v) for v in row]})
        except AkServingOverloadException as e:
            return self._send_json({"error": str(e)}, 429)
        except AkCircuitOpenException as e:
            return self._send_json({"error": str(e)}, 503)
        except AkDeadlineExceededException as e:
            return self._send_json({"error": str(e)}, 504)
        except AkIllegalArgumentException as e:
            # unknown model / schema-mismatched rows / bad load args —
            # caller errors by class contract. Anything else escapes to the
            # outer 500 handler (a model-internal KeyError is NOT a 400).
            return self._send_json(
                {"error": f"{type(e).__name__}: {e}"}, 400)
        return self._send_json({"error": "not found"}, 404)

    def _static(self, rel: str):
        path = os.path.normpath(os.path.join(_STATIC_DIR, rel))
        if not path.startswith(_STATIC_DIR + os.sep) \
                or not os.path.isfile(path):
            return self._send_json({"error": "not found"}, 404)
        ctype = "text/html" if path.endswith(".html") else \
            "text/javascript" if path.endswith(".js") else \
            "text/css" if path.endswith(".css") else "application/octet-stream"
        with open(path, "rb") as f:
            data = f.read()
        self.send_response(200)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)


class WebUIServer:
    """``WebUIServer(port=8765).start()`` then open http://localhost:8765.
    ``start(background=True)`` serves from a daemon thread (tests)."""

    def __init__(self, port: int = 8765, host: str = "127.0.0.1",
                 store: Optional[ExperimentStore] = None,
                 model_server=None):
        handler = type("BoundHandler", (_Handler,),
                       {"store": store or ExperimentStore(),
                        "model_server": model_server})
        self.httpd = ThreadingHTTPServer((host, port), handler)
        self.port = self.httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None

    def start(self, background: bool = False):
        if background:
            self._thread = threading.Thread(
                target=self.httpd.serve_forever, daemon=True)
            self._thread.start()
            return self
        self.httpd.serve_forever()

    def stop(self):
        self.httpd.shutdown()
        self.httpd.server_close()


def main():  # pragma: no cover — CLI entry
    import argparse

    ap = argparse.ArgumentParser(description="alink_tpu_torch WebUI")
    ap.add_argument("--port", type=int, default=8765)
    ap.add_argument("--host", default="127.0.0.1")
    args = ap.parse_args()
    print(f"alink_tpu_torch WebUI on http://{args.host}:{args.port}")
    WebUIServer(port=args.port, host=args.host).start()


if __name__ == "__main__":  # pragma: no cover
    main()
