"""Model (de)serialization between algorithm state and model MTables.

A copy of ``alink_tpu.common.model``: the port keeps its own, so that it imports nothing
of the JAX package.

Capability parity with the reference's model-data converters (reference:
core/src/main/java/com/alibaba/alink/common/model/ModelDataConverter.java,
SimpleModelDataConverter, LabeledModelDataConverter — model POJOs ↔ Row tables
of (id, json/data) so models live in ordinary tables and persist as .ak files).

Re-design: the canonical model table is columnar with three columns —
``key STRING`` (array name or "__meta__"), ``json STRING`` (meta/params JSON),
``tensor TENSOR`` (numpy payload) — so numeric payloads stay binary arrays
end-to-end instead of string-encoded rows, while remaining an ordinary MTable
(printable, .ak-persistable, streamable).
"""

from __future__ import annotations

import json
import threading
import weakref
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np

from .exceptions import AkIllegalDataException
from .mtable import AlinkTypes, MTable, TableSchema

MODEL_SCHEMA = TableSchema(
    ["key", "json", "tensor"],
    [AlinkTypes.STRING, AlinkTypes.STRING, AlinkTypes.TENSOR],
)
_META_KEY = "__meta__"


def model_to_table(meta: Dict[str, Any], arrays: Optional[Dict[str, np.ndarray]] = None) -> MTable:
    arrays = arrays or {}
    keys = [_META_KEY] + list(arrays.keys())
    jsons = [json.dumps(meta, default=_json_default)] + [""] * len(arrays)
    tensors = [np.zeros(0)] + [np.asarray(v) for v in arrays.values()]
    return MTable({"key": keys, "json": jsons, "tensor": tensors}, MODEL_SCHEMA)


def table_to_model(t: MTable) -> Tuple[Dict[str, Any], Dict[str, np.ndarray]]:
    if t.names != MODEL_SCHEMA.names:
        raise AkIllegalDataException(
            f"not a model table: columns {t.names} != {MODEL_SCHEMA.names}"
        )
    meta: Dict[str, Any] = {}
    arrays: Dict[str, np.ndarray] = {}
    for key, js, tensor in t.rows():
        if key == _META_KEY:
            meta = json.loads(js)
        else:
            arrays[key] = np.asarray(tensor)
    return meta, arrays


def _json_default(o):
    if isinstance(o, (np.integer,)):
        return int(o)
    if isinstance(o, (np.floating,)):
        return float(o)
    if isinstance(o, np.ndarray):
        return o.tolist()
    return str(o)


# (id(table), key) -> [lock, result or _PENDING]; an entry goes when its
# table is collected
_DECODED: Dict[Tuple[int, Any], list] = {}
_DECODED_LOCK = threading.Lock()
_PENDING = object()


def decode_once(table: MTable, key: Any, build: Callable[[], Any]) -> Any:
    """``build()``'s result for this model table object and ``key``, built
    once: mappers that load the same table (the two predict branches of one
    DAG, say) share one decode, and a thread that asks while another builds
    waits for that build instead of decoding beside it under the
    interpreter lock. The result lives as long as the table; a build that
    raises is not kept."""
    ident = (id(table), key)
    with _DECODED_LOCK:
        entry = _DECODED.get(ident)
        if entry is None:
            entry = _DECODED[ident] = [threading.Lock(), _PENDING]
            weakref.finalize(table, _DECODED.pop, ident, None)
    with entry[0]:
        if entry[1] is _PENDING:
            entry[1] = build()
        return entry[1]
