"""KV connector batch ops: external-store lookup decoration + sink (port
of ``alink_tpu.operator.batch.connectors``; host code) (reference: operator/batch/dataproc/LookupRedisBatchOp.java,
LookupHBaseBatchOp.java, RedisSinkStreamOp's batch counterpart). The store
layer (memory:// / redis://) lives in alink_tpu_torch/io/kv.py."""

from __future__ import annotations

from typing import List

import numpy as np

from ...common.exceptions import AkIllegalArgumentException
from ...common.mtable import AlinkTypes, MTable, TableSchema
from ...common.params import ParamInfo
from ...io.kv import KvStore, open_kv_store
from ...mapper import HasOutputCols, HasReservedCols, HasSelectedCols
from .base import BatchOperator


class LookupKvBatchOp(BatchOperator, HasSelectedCols, HasOutputCols,
                      HasReservedCols):
    """Decorate rows with values fetched from an external KV store
    (reference: LookupRedisBatchOp.java / LookupHBaseBatchOp.java — the
    selected column is the rowkey; fetched JSON fields land in the output
    columns; misses yield NULLs)."""

    STORE_URI = ParamInfo("storeUri", str, optional=False,
                          aliases=("pluginUri", "redisIp"))
    OUTPUT_TYPES = ParamInfo("outputTypes", list, default=None,
                             desc="Alink type per output col; default STRING")

    _min_inputs = 1
    _max_inputs = 1

    def _resolved_cols(self):
        sel = self.get(HasSelectedCols.SELECTED_COLS)
        if not sel or len(sel) != 1:
            raise AkIllegalArgumentException(
                "LookupKv needs exactly one selectedCol (the rowkey)")
        out_cols = list(self.get(HasOutputCols.OUTPUT_COLS) or [])
        if not out_cols:
            raise AkIllegalArgumentException("LookupKv needs outputCols")
        types = self.get(self.OUTPUT_TYPES)
        if types is None:
            types = [AlinkTypes.STRING] * len(out_cols)
        norm = []
        for tp in types:
            tp = str(tp).upper()
            # KV misses are NULL; nullable ints are DOUBLE+NaN framework-wide
            # (same contract as the SQL engine's result reader), so numeric
            # outputs are always DOUBLE — keeps the static schema truthful
            if tp in (AlinkTypes.LONG, AlinkTypes.INT, AlinkTypes.FLOAT):
                tp = AlinkTypes.DOUBLE
            norm.append(tp)
        return sel[0], out_cols, norm

    def _kept_input_cols(self, in_names) -> List[str]:
        reserved = self.get(HasReservedCols.RESERVED_COLS)
        if reserved is None:
            return list(in_names)
        return [n for n in in_names if n in set(reserved)]

    def _decorate(self, t: MTable, store: KvStore) -> MTable:
        """One chunk's lookup against an already-open store (shared by the
        batch op and the stream twin, which keeps the handle open)."""
        key_col, out_cols, out_types = self._resolved_cols()
        hits = store.mget([str(v) for v in t.col(key_col)])
        kept = self._kept_input_cols(t.names)
        cols = {n: t.col(n) for n in kept if n not in out_cols}
        names = [n for n in kept if n not in out_cols]
        types = [t.schema.type_of(n) for n in names]
        for oc, tp in zip(out_cols, out_types):
            vals = [None if h is None else h.get(oc) for h in hits]
            if tp == AlinkTypes.DOUBLE:
                arr = np.asarray(
                    [np.nan if v is None else float(v) for v in vals])
            else:
                arr = np.asarray(vals, object)
            cols[oc] = arr
            names.append(oc)
            types.append(tp)
        return MTable(cols, TableSchema(names, types))

    def _execute_impl(self, t: MTable) -> MTable:
        store = open_kv_store(self.get(self.STORE_URI))
        try:
            return self._decorate(t, store)
        finally:
            store.close()

    def _out_schema(self, in_schema: TableSchema) -> TableSchema:
        _, out_cols, out_types = self._resolved_cols()
        kept = self._kept_input_cols(in_schema.names)
        names = [n for n in kept if n not in out_cols]
        types = [in_schema.type_of(n) for n in names]
        return TableSchema(names + list(out_cols), types + list(out_types))


class KvSinkBatchOp(BatchOperator, HasSelectedCols):
    """Write rows into a KV store: ``keyCol`` is the key; the JSON value
    carries ``selectedCols`` when set, else every non-key column
    (reference: RedisSinkStreamOp / PutHBase ops)."""

    STORE_URI = ParamInfo("storeUri", str, optional=False)
    KEY_COL = ParamInfo("keyCol", str, optional=False)

    _min_inputs = 1
    _max_inputs = 1

    def _write(self, t: MTable, store: KvStore,
               key_col: "str | None" = None) -> None:
        key_col = key_col or self.get(self.KEY_COL)
        selected = self.get(HasSelectedCols.SELECTED_COLS)
        val_cols = [n for n in (selected or t.names) if n != key_col]
        keep = [key_col] + val_cols
        for row in t.rows():
            d = {n: v for n, v in zip(t.names, row) if n in keep}
            key = str(d.pop(key_col))
            clean = {}
            for k, v in d.items():
                if isinstance(v, (np.integer,)):
                    v = int(v)
                elif isinstance(v, (np.floating,)):
                    v = float(v)
                elif isinstance(v, (np.bool_,)):
                    v = bool(v)
                clean[k] = v
            store.set(key, clean)

    def _execute_impl(self, t: MTable) -> MTable:
        store = open_kv_store(self.get(self.STORE_URI))
        try:
            self._write(t, store)
        finally:
            store.close()
        return t

    def _out_schema(self, in_schema: TableSchema) -> TableSchema:
        return in_schema
