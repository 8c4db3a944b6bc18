"""Mapper framework — the inference runtime (port of ``alink_tpu.mapper.base``).

Capability parity with the reference's mapper stack (reference:
core/src/main/java/com/alibaba/alink/common/mapper/Mapper.java:20,
ModelMapper.java:24, RichModelMapper). A Mapper transforms an entire MTable
columnar block at once; a row-level ``map_row`` shim is kept for API parity.
The reference's fused block-kernel chain (``run_kernel_chain``) is not ported
yet.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from ..common.exceptions import AkIllegalArgumentException
from ..common.mtable import AlinkTypes, MTable, TableSchema
from ..common.params import ParamInfo, WithParams


class HasReservedCols:
    RESERVED_COLS = ParamInfo(
        "reservedCols", list, desc="input columns passed through (default: all)"
    )


class HasPredictionCol:
    PREDICTION_COL = ParamInfo("predictionCol", str, default="pred")


class HasPredictionDetailCol:
    PREDICTION_DETAIL_COL = ParamInfo("predictionDetailCol", str)


class Mapper(WithParams):
    """Stateless table→table transform kernel."""

    def __init__(self, data_schema: Optional[TableSchema] = None, params=None, **kw):
        super().__init__(params, **kw)
        self.data_schema = data_schema

    # -- to implement ------------------------------------------------------
    def output_schema(self, input_schema: TableSchema) -> TableSchema:
        """Schema of map_table's result given the input schema."""
        raise NotImplementedError

    def map_table(self, t: MTable) -> MTable:
        raise NotImplementedError

    # -- row shim (serving parity with reference Mapper.map(Row)) ----------
    def map_row(self, row: Sequence, input_schema: Optional[TableSchema] = None):
        schema = input_schema or self.data_schema
        if schema is None:
            raise AkIllegalArgumentException("map_row needs an input schema")
        t = MTable.from_rows([row], schema)
        return self.map_table(t).get_row(0)

    # -- helpers -----------------------------------------------------------
    def reserved(self, input_schema: TableSchema) -> List[str]:
        r = self.get_params().get("reservedCols") if self.get_params().contains(
            "reservedCols"
        ) else None
        return list(r) if r is not None else list(input_schema.names)

    def _append_result_schema(
        self, input_schema: TableSchema, out_names: List[str], out_types: List[str]
    ) -> TableSchema:
        names = [n for n in self.reserved(input_schema) if n not in out_names]
        types = [input_schema.type_of(n) for n in names]
        return TableSchema(names + out_names, types + out_types)

    def _append_result(
        self, t: MTable, out_cols: Dict[str, Any], out_types: Dict[str, str]
    ) -> MTable:
        names = [n for n in self.reserved(t.schema) if n not in out_cols]
        cols = {n: t.col(n) for n in names}
        types = [t.schema.type_of(n) for n in names]
        for n, c in out_cols.items():
            cols[n] = c
            types.append(out_types[n])
        return MTable(cols, TableSchema(list(cols.keys()), types))


class ModelMapper(Mapper):
    """Mapper with model state (reference: common/mapper/ModelMapper.java:24).
    ``load_model`` ingests a model MTable; hot-swap support mirrors
    ModelMapper.createNew (reference: ModelMapper.java:71-76)."""

    def __init__(self, model_schema=None, data_schema=None, params=None,
                 device=None, **kw):
        super().__init__(data_schema, params, **kw)
        self.model_schema = model_schema
        # torch device the model runs on; None = the port's default
        # (common/env.resolve_device)
        self.device = device

    def load_model(self, model: MTable) -> "ModelMapper":
        raise NotImplementedError

class RichModelMapper(ModelMapper, HasPredictionCol, HasPredictionDetailCol,
                      HasReservedCols):
    """Prediction + optional JSON detail column (reference:
    common/mapper/RichModelMapper.java). Implement ``predict_block`` returning
    (pred values, pred type, detail strings or None)."""

    def predict_block(self, t: MTable):
        raise NotImplementedError

    def output_schema(self, input_schema: TableSchema) -> TableSchema:
        pred_col = self.get(HasPredictionCol.PREDICTION_COL)
        detail_col = self.get(HasPredictionDetailCol.PREDICTION_DETAIL_COL)
        names, types = [pred_col], [self._pred_type()]
        if detail_col:
            names.append(detail_col)
            types.append(AlinkTypes.STRING)
        return self._append_result_schema(input_schema, names, types)

    def _pred_type(self) -> str:
        return AlinkTypes.STRING

    def map_table(self, t: MTable) -> MTable:
        pred_col = self.get(HasPredictionCol.PREDICTION_COL)
        detail_col = self.get(HasPredictionDetailCol.PREDICTION_DETAIL_COL)
        pred, pred_type, detail = self.predict_block(t)
        out_cols = {pred_col: pred}
        out_types = {pred_col: pred_type}
        if detail_col:
            out_cols[detail_col] = detail
            out_types[detail_col] = AlinkTypes.STRING
        return self._append_result(t, out_cols, out_types)


def np_labels(labels: List, label_type: str, idx: np.ndarray) -> np.ndarray:
    """Decode argmax indices back to typed label values."""
    arr = np.asarray(labels, dtype=object)[idx]
    if label_type in (AlinkTypes.LONG, AlinkTypes.INT):
        return arr.astype(np.int64)
    if label_type in (AlinkTypes.DOUBLE, AlinkTypes.FLOAT):
        return arr.astype(np.float64)
    return arr.astype(str)


def softmax_np(logits: np.ndarray) -> np.ndarray:
    e = np.exp(logits - logits.max(axis=1, keepdims=True))
    return e / e.sum(axis=1, keepdims=True)


def detail_json(labels: List, probs: np.ndarray) -> np.ndarray:
    """Per-row JSON {label: prob} detail strings (reference: RichModelMapper
    prediction-detail column format)."""
    import json as _json

    return np.asarray(
        [_json.dumps({str(labels[j]): float(pr[j]) for j in range(len(labels))})
         for pr in probs],
        dtype=object,
    )
