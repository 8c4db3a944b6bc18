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
from typing import Any, Dict, Optional, Tuple

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
