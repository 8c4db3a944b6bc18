"""Dataproc operators: StringIndexer, Imputer, JsonValue, Lookup, type convert
(port of ``alink_tpu.operator.batch.dataproc``; host-side, copied).

Capability parity with the reference dataproc package (reference:
core/src/main/java/com/alibaba/alink/operator/batch/dataproc/
StringIndexerTrainBatchOp.java + StringIndexerPredictBatchOp.java
(HugeStringIndexer distributed variants collapse into one unique pass),
ImputerTrainBatchOp.java + common/dataproc/ImputerModelMapper.java,
JsonValueBatchOp.java (common/dataproc/JsonPathMapper.java),
LookupBatchOp.java (common/dataproc/LookupModelMapper.java),
TypeConvertBatchOp.java (common/dataproc/TypeConvertMapper — numeric/string
casts)).
"""

from __future__ import annotations

import json
import numpy as np

from ...common.exceptions import AkIllegalArgumentException
from ...common.model import model_to_table, table_to_model
from ...common.mtable import AlinkTypes, MTable, TableSchema
from ...common.params import InValidator, ParamInfo
from ...mapper import (
    HasOutputCols,
    HasReservedCols,
    HasSelectedCol,
    HasSelectedCols,
    Mapper,
    ModelMapper,
    default_feature_cols,
)
from .base import BatchOperator
from .utils import MapBatchOp, ModelMapBatchOp, ModelTrainOpMixin


# ---------------------------------------------------------------------------
# StringIndexer
# ---------------------------------------------------------------------------

class StringIndexerTrainBatchOp(ModelTrainOpMixin, BatchOperator,
                                HasSelectedCols):
    """Token → LONG id per selected column (reference:
    StringIndexerTrainBatchOp.java; orderings RANDOM/FREQUENCY/ALPHABET)."""

    STRING_ORDER_TYPE = ParamInfo(
        "stringOrderType", str, default="ALPHABET_ASC",
        validator=InValidator("ALPHABET_ASC", "ALPHABET_DESC",
                              "FREQUENCY_ASC", "FREQUENCY_DESC", "RANDOM"))

    _min_inputs = 1
    _max_inputs = 1

    def _execute_impl(self, t: MTable) -> MTable:
        cols = list(self.get(HasSelectedCols.SELECTED_COLS) or t.names)
        order = self.get(self.STRING_ORDER_TYPE)
        token_maps = {}
        for c in cols:
            vals = np.asarray(t.col(c), dtype=object).astype(str)
            uniq, counts = np.unique(vals, return_counts=True)
            if order == "ALPHABET_ASC":
                toks = list(uniq)
            elif order == "ALPHABET_DESC":
                toks = list(uniq[::-1])
            elif order == "FREQUENCY_ASC":
                toks = list(uniq[np.argsort(counts, kind="stable")])
            elif order == "FREQUENCY_DESC":
                toks = list(uniq[np.argsort(-counts, kind="stable")])
            else:  # RANDOM — deterministic shuffle for reproducibility
                rng = np.random.default_rng(0)
                toks = list(uniq[rng.permutation(len(uniq))])
            token_maps[c] = toks
        meta = {"modelName": "StringIndexerModel", "selectedCols": cols,
                "tokenMaps": token_maps}
        return model_to_table(meta, {})

    def _static_meta_keys(self, in_schema):
        return {"modelName": "StringIndexerModel",
                "selectedCols": list(self.get(HasSelectedCols.SELECTED_COLS) or
                                     in_schema.names)}


class StringIndexerModelMapper(ModelMapper, HasSelectedCols, HasOutputCols,
                               HasReservedCols):
    """Replaces (or appends as outputCols) each selected column by its id.
    handleInvalid: KEEP maps unseen to size, SKIP maps to -1, ERROR raises
    (reference: StringIndexerPredictBatchOp.java HasHandleInvalid)."""

    HANDLE_INVALID = ParamInfo(
        "handleInvalid", str, default="KEEP",
        validator=InValidator("KEEP", "SKIP", "ERROR"))

    def load_model(self, model: MTable):
        self.meta, _ = table_to_model(model)
        self.lookups = {c: {tok: i for i, tok in enumerate(toks)}
                        for c, toks in self.meta["tokenMaps"].items()}
        return self

    def _io_cols(self, schema):
        in_cols = (self.get(HasSelectedCols.SELECTED_COLS) or
                   self.meta["selectedCols"])
        out_cols = self.get(HasOutputCols.OUTPUT_COLS) or in_cols
        return list(in_cols), list(out_cols)

    def output_schema(self, input_schema):
        in_cols, out_cols = self._io_cols(input_schema)
        names, types = list(input_schema.names), list(input_schema.types)
        for ic, oc in zip(in_cols, out_cols):
            if oc in names:
                types[names.index(oc)] = AlinkTypes.LONG
            else:
                names.append(oc)
                types.append(AlinkTypes.LONG)
        return TableSchema(names, types)

    def map_table(self, t: MTable) -> MTable:
        in_cols, out_cols = self._io_cols(t.schema)
        handle = self.get(self.HANDLE_INVALID)
        out = t
        for ic, oc in zip(in_cols, out_cols):
            # model columns are keyed by the TRAIN column name; a predict-time
            # selectedCols override maps positionally onto the model columns
            model_col = (ic if ic in self.lookups else
                         self.meta["selectedCols"][in_cols.index(ic)])
            lut = self.lookups[model_col]
            vals = np.asarray(t.col(ic), dtype=object).astype(str)
            n_tokens = len(lut)
            ids = np.empty(len(vals), np.int64)
            for i, v in enumerate(vals):
                if v in lut:
                    ids[i] = lut[v]
                elif handle == "KEEP":
                    ids[i] = n_tokens
                elif handle == "SKIP":
                    ids[i] = -1
                else:
                    raise AkIllegalArgumentException(
                        f"StringIndexer: unseen token {v!r} in column {ic!r}")
            out = out.with_column(oc, ids, AlinkTypes.LONG)
        return out


class StringIndexerPredictBatchOp(ModelMapBatchOp, HasSelectedCols,
                                  HasOutputCols, HasReservedCols):
    mapper_cls = StringIndexerModelMapper
    HANDLE_INVALID = StringIndexerModelMapper.HANDLE_INVALID


# ---------------------------------------------------------------------------
# Imputer
# ---------------------------------------------------------------------------

class ImputerTrainBatchOp(ModelTrainOpMixin, BatchOperator, HasSelectedCols):
    """Missing-value fill statistics (reference: ImputerTrainBatchOp.java;
    strategies MEAN/MIN/MAX/VALUE)."""

    STRATEGY = ParamInfo("strategy", str, default="MEAN",
                         validator=InValidator("MEAN", "MIN", "MAX", "VALUE"))
    FILL_VALUE = ParamInfo("fillValue", str)

    _min_inputs = 1
    _max_inputs = 1

    def _execute_impl(self, t: MTable) -> MTable:
        cols = list(self.get(HasSelectedCols.SELECTED_COLS) or
                    default_feature_cols(t))
        strategy = self.get(self.STRATEGY)
        fills = []
        for c in cols:
            if strategy == "VALUE":
                fv = self.get(self.FILL_VALUE)
                if fv is None:
                    raise AkIllegalArgumentException(
                        "Imputer strategy VALUE needs fillValue")
                fills.append(float(fv))
                continue
            arr = np.asarray(t.col(c), np.float64)
            ok = arr[~np.isnan(arr)]
            if ok.size == 0:
                fills.append(0.0)
            elif strategy == "MEAN":
                fills.append(float(ok.mean()))
            elif strategy == "MIN":
                fills.append(float(ok.min()))
            else:
                fills.append(float(ok.max()))
        meta = {"modelName": "ImputerModel", "selectedCols": cols,
                "strategy": strategy}
        return model_to_table(meta, {"fills": np.asarray(fills, np.float64)})

    def _static_meta_keys(self, in_schema):
        cols = list(self.get(HasSelectedCols.SELECTED_COLS) or
                    default_feature_cols(in_schema))
        return {"modelName": "ImputerModel", "selectedCols": cols}


class ImputerModelMapper(ModelMapper, HasReservedCols):
    def load_model(self, model: MTable):
        self.meta, arrays = table_to_model(model)
        self.fills = arrays["fills"]
        return self

    def output_schema(self, input_schema):
        cols = set(self.meta["selectedCols"])
        types = [AlinkTypes.DOUBLE if n in cols else tp
                 for n, tp in zip(input_schema.names, input_schema.types)]
        return TableSchema(list(input_schema.names), types)

    def map_table(self, t: MTable) -> MTable:
        out = t
        for i, c in enumerate(self.meta["selectedCols"]):
            arr = np.asarray(t.col(c), np.float64)
            arr = np.where(np.isnan(arr), self.fills[i], arr)
            out = out.with_column(c, arr, AlinkTypes.DOUBLE)
        return out


class ImputerPredictBatchOp(ModelMapBatchOp, HasReservedCols):
    mapper_cls = ImputerModelMapper


# ---------------------------------------------------------------------------
# JsonValue
# ---------------------------------------------------------------------------

def _json_path_get(obj, path: str):
    """Tiny JsonPath subset: $.a.b[0].c (reference relies on com.jayway
    jsonpath; ops only ever use simple dotted paths)."""
    if path.startswith("$"):
        path = path[1:]
    cur = obj
    for part in path.replace("]", "").split("."):
        if not part:
            continue
        for piece in part.split("["):
            if piece == "":
                continue
            if isinstance(cur, list):
                try:
                    cur = cur[int(piece)]
                except (ValueError, IndexError):
                    return None
            elif isinstance(cur, dict):
                if piece.isdigit() and piece not in cur:
                    try:
                        cur = list(cur.values())[int(piece)]
                        continue
                    except IndexError:
                        return None
                cur = cur.get(piece)
            else:
                return None
            if cur is None:
                return None
    return cur


class JsonValueMapper(Mapper, HasSelectedCol, HasOutputCols, HasReservedCols):
    """Extract JSON-path values from a JSON string column (reference:
    JsonValueBatchOp.java / common/dataproc/JsonPathMapper.java)."""

    JSON_PATHS = ParamInfo("jsonPath", list, optional=False,
                           aliases=("jsonPaths",))

    def output_schema(self, input_schema):
        out_cols = self.get(HasOutputCols.OUTPUT_COLS) or [
            f"v{i}" for i in range(len(self.get(self.JSON_PATHS)))]
        return self._append_result_schema(
            input_schema, list(out_cols),
            [AlinkTypes.STRING] * len(out_cols))

    def map_table(self, t: MTable) -> MTable:
        col = self.get(HasSelectedCol.SELECTED_COL)
        paths = self.get(self.JSON_PATHS)
        out_cols = self.get(HasOutputCols.OUTPUT_COLS) or [
            f"v{i}" for i in range(len(paths))]
        parsed = []
        for s in t.col(col):
            try:
                parsed.append(json.loads(s) if s is not None else None)
            except (json.JSONDecodeError, TypeError):
                parsed.append(None)
        cols, types = {}, {}
        for p, oc in zip(paths, out_cols):
            vals = []
            for obj in parsed:
                v = _json_path_get(obj, p) if obj is not None else None
                if v is not None and not isinstance(v, str):
                    v = json.dumps(v)
                vals.append(v)
            cols[oc] = np.asarray(vals, object)
            types[oc] = AlinkTypes.STRING
        return self._append_result(t, cols, types)


class JsonValueBatchOp(MapBatchOp, HasSelectedCol, HasOutputCols,
                       HasReservedCols):
    mapper_cls = JsonValueMapper
    JSON_PATHS = JsonValueMapper.JSON_PATHS


# ---------------------------------------------------------------------------
# Lookup
# ---------------------------------------------------------------------------

class LookupBatchOp(BatchOperator, HasSelectedCols, HasOutputCols,
                    HasReservedCols):
    """Join-free key lookup against a small model table held in memory
    (reference: LookupBatchOp.java — HBase/Redis backends collapse into an
    in-memory dict; ``link_from(model_table, data)``)."""

    MAP_KEY_COLS = ParamInfo("mapKeyCols", list, optional=False)
    MAP_VALUE_COLS = ParamInfo("mapValueCols", list, optional=False)

    _min_inputs = 2
    _max_inputs = 2

    def _build_lut(self, model: MTable) -> dict:
        """key tuple → value tuple; built ONCE per lookup (the Huge variant
        reuses it across data blocks)."""
        key_cols = list(self.get(self.MAP_KEY_COLS))
        val_cols = list(self.get(self.MAP_VALUE_COLS))
        lut = {}
        key_arrays = [np.asarray(model.col(c), object) for c in key_cols]
        val_arrays = [np.asarray(model.col(c), object) for c in val_cols]
        for i in range(model.num_rows):
            k = tuple(str(a[i]) for a in key_arrays)
            lut[k] = tuple(a[i] for a in val_arrays)
        return lut

    def _probe(self, model_schema, t: MTable, lut: dict) -> MTable:
        key_cols = list(self.get(self.MAP_KEY_COLS))
        val_cols = list(self.get(self.MAP_VALUE_COLS))
        sel = list(self.get(HasSelectedCols.SELECTED_COLS) or key_cols)
        out_cols = list(self.get(HasOutputCols.OUTPUT_COLS) or val_cols)
        sel_arrays = [np.asarray(t.col(c), object) for c in sel]
        n = t.num_rows
        outs = {oc: [] for oc in out_cols}
        for i in range(n):
            k = tuple(str(a[i]) for a in sel_arrays)
            hit = lut.get(k)
            for j, oc in enumerate(out_cols):
                outs[oc].append(hit[j] if hit is not None else None)
        cols = {name: t.col(name) for name in t.names}
        for j, oc in enumerate(out_cols):
            cols[oc] = np.asarray(outs[oc], object)
        names = list(t.names) + [oc for oc in out_cols if oc not in t.names]
        types = [t.schema.type_of(n) if n in t.names
                 else model_schema.type_of(val_cols[out_cols.index(n)])
                 for n in names]
        return MTable(cols, TableSchema(names, types))

    def _execute_impl(self, model: MTable, t: MTable) -> MTable:
        return self._probe(model.schema, t, self._build_lut(model))

    def _out_schema(self, model_schema, data_schema):
        val_cols = list(self.get(self.MAP_VALUE_COLS))
        out_cols = list(self.get(HasOutputCols.OUTPUT_COLS) or val_cols)
        names = list(data_schema.names) + [
            oc for oc in out_cols if oc not in data_schema.names]
        types = [data_schema.type_of(n) if n in data_schema.names
                 else model_schema.type_of(val_cols[out_cols.index(n)])
                 for n in names]
        return TableSchema(names, types)


# ---------------------------------------------------------------------------
# Type conversion
# ---------------------------------------------------------------------------

class TypeConvertMapper(Mapper, HasSelectedCols, HasReservedCols):
    """Cast selected columns to a target type (reference:
    TypeConvertBatchOp.java)."""

    TARGET_TYPE = ParamInfo(
        "targetType", str, optional=False,
        validator=InValidator("STRING", "DOUBLE", "FLOAT", "LONG", "INT",
                              "BOOLEAN"))

    def output_schema(self, input_schema):
        cols = set(self.get(HasSelectedCols.SELECTED_COLS) or
                   input_schema.names)
        tgt = self.get(self.TARGET_TYPE)
        types = [tgt if n in cols else tp
                 for n, tp in zip(input_schema.names, input_schema.types)]
        return TableSchema(list(input_schema.names), types)

    def map_table(self, t: MTable) -> MTable:
        cols = list(self.get(HasSelectedCols.SELECTED_COLS) or t.names)
        tgt = self.get(self.TARGET_TYPE)
        out = t
        for c in cols:
            arr = t.col(c)
            if tgt == "STRING":
                conv = np.asarray([None if v is None else str(v)
                                   for v in arr], object)
            elif tgt in ("DOUBLE", "FLOAT"):
                conv = np.asarray(arr).astype(np.float64 if tgt == "DOUBLE"
                                              else np.float32)
            elif tgt in ("LONG", "INT"):
                conv = np.asarray(arr).astype(np.float64).astype(
                    np.int64 if tgt == "LONG" else np.int32)
            else:
                conv = np.asarray(arr).astype(bool)
            out = out.with_column(c, conv, tgt)
        return out


class TypeConvertBatchOp(MapBatchOp, HasSelectedCols, HasReservedCols):
    mapper_cls = TypeConvertMapper
    TARGET_TYPE = TypeConvertMapper.TARGET_TYPE


class StratifiedSampleBatchOp(BatchOperator):
    """Per-stratum sampling (reference: StratifiedSampleBatchOp.java —
    strataRatio or per-value strataRatios 'a:0.1,b:0.5')."""

    STRATA_COL = ParamInfo("strataCol", str, optional=False)
    STRATA_RATIO = ParamInfo("strataRatio", float, default=-1.0)
    STRATA_RATIOS = ParamInfo("strataRatios", str,
                              desc="per-value ratios 'a:0.1,b:0.5'")
    RANDOM_SEED = ParamInfo("randomSeed", int, default=0, aliases=("seed",))

    _min_inputs = 1
    _max_inputs = 1

    def _execute_impl(self, t: MTable) -> MTable:
        rng = np.random.default_rng(self.get(self.RANDOM_SEED))
        strata = np.asarray(t.col(self.get(self.STRATA_COL)), object) \
            .astype(str)
        default = self.get(self.STRATA_RATIO)
        per_value = {}
        ratios_str = self.get(self.STRATA_RATIOS)
        if ratios_str:
            for part in ratios_str.split(","):
                k, v = part.split(":")
                per_value[k.strip()] = float(v)
        keep = np.zeros(t.num_rows, bool)
        for val in np.unique(strata):
            ratio = per_value.get(val, default)
            if ratio < 0:
                raise AkIllegalArgumentException(
                    f"no ratio for stratum {val!r} (set strataRatio or "
                    f"strataRatios)")
            rows = np.flatnonzero(strata == val)
            n_keep = int(round(len(rows) * min(ratio, 1.0)))
            keep[rng.choice(rows, n_keep, replace=False)] = True
        return t.filter_mask(keep)


class WeightSampleBatchOp(BatchOperator):
    """Weighted sampling without replacement via exponential sort keys
    (reference: WeightSampleBatchOp.java)."""

    WEIGHT_COL = ParamInfo("weightCol", str, optional=False)
    RATIO = ParamInfo("ratio", float, optional=False)
    RANDOM_SEED = ParamInfo("randomSeed", int, default=0, aliases=("seed",))

    _min_inputs = 1
    _max_inputs = 1

    def _execute_impl(self, t: MTable) -> MTable:
        rng = np.random.default_rng(self.get(self.RANDOM_SEED))
        w = np.asarray(t.col(self.get(self.WEIGHT_COL)), np.float64)
        w = np.maximum(w, 1e-12)
        n_keep = int(round(t.num_rows * min(self.get(self.RATIO), 1.0)))
        # Efraimidis–Spirakis: keys u^(1/w); top-n_keep keys win
        keys = rng.random(t.num_rows) ** (1.0 / w)
        keep_idx = np.argsort(-keys)[:n_keep]
        return t.take(np.sort(keep_idx))


class RebalanceBatchOp(BatchOperator):
    """Round-robin redistribution (reference: RebalanceBatchOp.java). The
    columnar runtime has no skewed partitions to fix — this shuffles rows so
    downstream row->shard striping is uniform."""

    RANDOM_SEED = ParamInfo("randomSeed", int, default=0, aliases=("seed",))

    _min_inputs = 1
    _max_inputs = 1

    def _execute_impl(self, t: MTable) -> MTable:
        rng = np.random.default_rng(self.get(self.RANDOM_SEED))
        return t.take(rng.permutation(t.num_rows))


class OverWindowBatchOp(BatchOperator):
    """Per-group rolling-window aggregate features (reference:
    common/fe/GenerateFeatureUtil + the over-window feature ops — e.g.
    "sum of the previous N events per user"). Rides the embedded SQL
    engine's window functions; each agg spec 'agg(col)' yields a column
    '<agg>_<col>_<N>'."""

    GROUP_COLS = ParamInfo("groupCols", list, optional=False)
    ORDER_COL = ParamInfo("orderCol", str, optional=False)
    AGG_SPECS = ParamInfo("aggSpecs", list, optional=False,
                          desc="e.g. ['sum(amount)', 'avg(amount)']")
    WINDOW_SIZE = ParamInfo("windowSize", int, default=10,
                            desc="preceding rows included (current excluded)")

    _min_inputs = 1
    _max_inputs = 1

    def _agg_cols(self):
        out = []
        for spec in self.get(self.AGG_SPECS):
            fn, col = spec.rstrip(")").split("(")
            out.append((fn.strip().lower(), col.strip()))
        return out

    def _execute_impl(self, t: MTable) -> MTable:
        from ..sqlengine import sql_query

        groups = ", ".join(f'"{c}"' for c in self.get(self.GROUP_COLS))
        order = f'"{self.get(self.ORDER_COL)}"'
        n = int(self.get(self.WINDOW_SIZE))
        exprs = []
        for fn, col in self._agg_cols():
            exprs.append(
                f'{fn}("{col}") OVER (PARTITION BY {groups} ORDER BY {order} '
                f"ROWS BETWEEN {n} PRECEDING AND 1 PRECEDING) "
                f'AS "{fn}_{col}_{n}"')
        q = f'SELECT *, {", ".join(exprs)} FROM t'
        return sql_query(q, {"t": t})

    def _out_schema(self, in_schema):
        names = list(in_schema.names)
        types = list(in_schema.types)
        n = int(self.get(self.WINDOW_SIZE))
        for fn, col in self._agg_cols():
            names.append(f"{fn}_{col}_{n}")
            if fn == "count":
                types.append(AlinkTypes.LONG)   # count over empty window = 0
            elif in_schema.type_of(col) == AlinkTypes.STRING:
                types.append(AlinkTypes.STRING)  # min/max over strings
            else:
                # numeric aggregates: each group's FIRST row has an empty
                # window -> NULL, and the reader coerces int+NULL to DOUBLE
                types.append(AlinkTypes.DOUBLE)
        return TableSchema(names, types)


class HugeStringIndexerPredictBatchOp(StringIndexerPredictBatchOp):
    """Huge-vocabulary StringIndexer serving (reference:
    dataproc/HugeStringIndexerPredictBatchOp.java — the reference swaps the
    broadcast model for a distributed join when the dictionary outgrows one
    TM; here the lookup table already lives host-side once per process, so
    the huge variant processes the DATA in bounded row blocks instead of
    one giant object-array materialization)."""

    BLOCK_SIZE = ParamInfo("blockSize", int, default=200_000)

    def _execute_impl(self, model: MTable, t: MTable) -> MTable:
        block = max(1, int(self.get(self.BLOCK_SIZE)))
        if t.num_rows <= block:
            return super()._execute_impl(model, t)
        # load the huge dictionary ONCE; only the data flows in blocks
        mapper = self._loaded_mapper(model, t.schema)
        parts = []
        for s in range(0, t.num_rows, block):
            parts.append(mapper.map_table(
                t.slice(s, min(s + block, t.num_rows))))
        return MTable.concat(parts)


class HugeMultiStringIndexerPredictBatchOp(HugeStringIndexerPredictBatchOp):
    """Multi-column huge StringIndexer serving (reference:
    dataproc/HugeMultiStringIndexerPredictBatchOp.java); the shared mapper
    already handles multiple selectedCols."""
