"""IO / DL long-tail: dataset-named TFRecord ops, Xls sink, Redis/HBase
named connectors, catalog source/sink, TF table-model family, XGBoost
regression names, tensor-to-image, aggregated embedding lookup, BERT
embeddings and text-pair serving, stepwise-regression names (port of
``alink_tpu.operator.batch.io2``).

Capability parity (reference: operator/batch/source/
TFRecordDatasetSourceBatchOp.java / sink/TFRecordDatasetSinkBatchOp.java;
sink/XlsSinkBatchOp.java; dataproc/LookupRedisRowBatchOp.java /
LookupRedisStringBatchOp.java / LookupHBaseBatchOp.java,
sink/RedisRowSinkBatchOp.java / RedisStringSinkBatchOp.java /
HBaseSinkBatchOp.java; source/CatalogSourceBatchOp.java /
sink/CatalogSinkBatchOp.java; dataproc/TensorFlowBatchOp.java /
TensorFlow2BatchOp.java, classification/TFTableModelClassifierPredictBatchOp
.java + regression twin + dataproc/TFTableModelPredictBatchOp.java /
TF2TableModelTrainBatchOp.java; classification/XGBoostRegTrainBatchOp.java /
XGBoostRegPredictBatchOp.java; image/WriteTensorToImageBatchOp.java;
dataproc/AggLookupBatchOp.java; classification/BertTextEmbeddingBatchOp.java
+ pair predict twins; regression/LinearRegStepwiseTrainBatchOp.java /
LinearRegStepwisePredictBatchOp.java; statistics/InternalFullStatsBatchOp
.java).

The BERT embedding and text-pair names live in ``dl.py`` and are re-exported
here. AggLookup reduces on the device: the embedding table is one
``(V, D)`` float64 tensor, keys are split and looked up on the host, and
SUM/AVG run as ``index_add_``, MAX/MIN as ``scatter_reduce`` and CONCAT as a
gather. XlsSink writes through pandas and openpyxl in the reference; the
port depends on neither, so it raises the missing-plugin exception.
"""

from __future__ import annotations

import struct
import zlib
import numpy as np

from ...common.exceptions import (
    AkIllegalArgumentException,
    AkIllegalDataException,
)
from ...common.env import resolve_device
from ...common.linalg import DenseVector, dense_vectors, parse_vector
from ...common.mtable import AlinkTypes, MTable, TableSchema
from ...common.params import InValidator, ParamInfo
from ...io.filesystem import file_open
from ...mapper import (
    HasOutputCol,
    HasReservedCols,
    HasSelectedCol,
    ModelMapper,
)
from .base import BatchOperator
from .connectors import KvSinkBatchOp, LookupKvBatchOp
from .dl import (  # noqa: F401 — the BertText* names are io2's in the reference
    BertTextEmbeddingBatchOp,
    BertTextEmbeddingMapper,
    BertTextPairClassifierPredictBatchOp,
    BertTextPairRegressorPredictBatchOp,
    BertTextPairRegressorTrainBatchOp,
    KerasSequentialClassifierPredictBatchOp,
    KerasSequentialClassifierTrainBatchOp,
    KerasSequentialRegressorPredictBatchOp,
    KerasSequentialRegressorTrainBatchOp,
)
from .linear import LinearRegPredictBatchOp
from .regression import StepwiseLinearRegTrainBatchOp
from .sources import TFRecordSinkBatchOp, TFRecordSourceBatchOp
from .statistics import SummarizerBatchOp
from .script import JaxScriptBatchOp
from .utils import ModelMapBatchOp
from .xgboost import XGBoostPredictBatchOp, XGBoostTrainBatchOp


# ---------------------------------------------------------------------------
# sources / sinks
# ---------------------------------------------------------------------------


class TFRecordDatasetSourceBatchOp(TFRecordSourceBatchOp):
    """(reference: operator/batch/source/TFRecordDatasetSourceBatchOp.java)"""


class TFRecordDatasetSinkBatchOp(TFRecordSinkBatchOp):
    """(reference: operator/batch/sink/TFRecordDatasetSinkBatchOp.java)"""


class XlsSinkBatchOp(BatchOperator):
    """Excel sheet sink, plugin-gated on openpyxl (reference:
    operator/batch/sink/XlsSinkBatchOp.java via connectors/connector-xls)."""

    FILE_PATH = ParamInfo("filePath", str, optional=False)
    SHEET_NAME = ParamInfo("sheetName", str, default="Sheet1")

    _min_inputs = 1
    _max_inputs = 1

    def _execute_impl(self, t: MTable) -> MTable:
        from ...common.exceptions import AkPluginNotExistException

        raise AkPluginNotExistException(
            "XlsSinkBatchOp needs the 'openpyxl' package (with pandas; the "
            "reference ships connector-xls as a plugin), which the port "
            "does not depend on. CsvSinkBatchOp is the built-in "
            "alternative.")

    def _out_schema(self, in_schema):
        return in_schema


# ---------------------------------------------------------------------------
# named KV-store connectors
# ---------------------------------------------------------------------------


class LookupRedisRowBatchOp(LookupKvBatchOp):
    """Row-structured Redis lookup — field values land in output columns
    (reference: operator/batch/dataproc/LookupRedisRowBatchOp.java; the
    Redis backend resolves from the redis:// storeUri, the in-memory
    backend serves tests)."""


class LookupRedisStringBatchOp(LookupKvBatchOp):
    """Plain-string Redis lookup: the whole value lands in ONE output
    column (reference: operator/batch/dataproc/
    LookupRedisStringBatchOp.java)."""

    def _decorate(self, t: MTable, store) -> MTable:
        key_col, out_cols, _ = self._resolved_cols()
        if len(out_cols) != 1:
            raise AkIllegalArgumentException(
                "LookupRedisString writes exactly one output column")
        raw = store.mget_raw([str(v) for v in t.col(key_col)])
        kept = self._kept_input_cols(t.names)
        names = [n for n in kept if n != out_cols[0]]
        cols = {n: t.col(n) for n in names}
        types = [t.schema.type_of(n) for n in names]
        cols[out_cols[0]] = np.asarray(raw, object)
        return MTable(cols, TableSchema(names + [out_cols[0]],
                                        types + [AlinkTypes.STRING]))

    def _out_schema(self, in_schema):
        _, out_cols, _ = self._resolved_cols()
        kept = self._kept_input_cols(in_schema.names)
        names = [n for n in kept if n != out_cols[0]]
        types = [in_schema.type_of(n) for n in names]
        return TableSchema(names + [out_cols[0]],
                           types + [AlinkTypes.STRING])


class _HasHBaseParams:
    """The reference's HBase connection/table params (reference:
    params/io/HBaseConfigParams.java zookeeperQuorum/timeout +
    params/io/HBaseParams.java tableName/familyName). When these are set the
    op talks to a real HBase thrift gateway through
    :class:`alink_tpu.io.hbase.HBaseClient` (plugin-gated on happybase);
    an explicit ``storeUri`` (e.g. ``memory://`` in tests) still wins."""

    ZOOKEEPER_QUORUM = ParamInfo("zookeeperQuorum", str)
    THRIFT_HOST = ParamInfo("thriftHost", str)
    THRIFT_PORT = ParamInfo("thriftPort", int, default=9090)
    HBASE_TABLE_NAME = ParamInfo("tableName", str)
    FAMILY_NAME = ParamInfo("familyName", str, default="cf")
    TIMEOUT = ParamInfo("timeout", int, desc="thrift timeout in ms")
    # storeUri stops being required: HBase params are the primary route
    STORE_URI = ParamInfo("storeUri", str,
                          aliases=("pluginUri", "redisIp"))

    def _open_hbase_store(self):
        uri = self.get(self.STORE_URI)
        if uri:
            from ...io.kv import open_kv_store

            return open_kv_store(uri)
        from ...io.hbase import HBaseClient, HBaseKvStore

        table = self.get(self.HBASE_TABLE_NAME)
        if not table:
            raise AkIllegalArgumentException(
                "HBase ops need tableName (+ zookeeperQuorum/thriftHost), "
                "or an explicit storeUri")
        client = HBaseClient(
            thrift_host=self.get(self.THRIFT_HOST),
            thrift_port=self.get(self.THRIFT_PORT),
            zookeeper_quorum=self.get(self.ZOOKEEPER_QUORUM),
            timeout_ms=self.get(self.TIMEOUT))
        return HBaseKvStore(client=client, table=table,
                            family=self.get(self.FAMILY_NAME))


class LookupHBaseBatchOp(_HasHBaseParams, LookupKvBatchOp):
    """HBase rowkey lookup (reference: operator/batch/dataproc/
    LookupHBaseBatchOp.java). Output columns are qualifiers in
    ``familyName``; the batched thrift ``rows`` call serves each chunk."""

    def _execute_impl(self, t: MTable) -> MTable:
        store = self._open_hbase_store()
        try:
            return self._decorate(t, store)
        finally:
            store.close()


class RedisRowSinkBatchOp(KvSinkBatchOp):
    """(reference: operator/batch/sink/RedisRowSinkBatchOp.java)"""


class RedisStringSinkBatchOp(KvSinkBatchOp):
    """(reference: operator/batch/sink/RedisStringSinkBatchOp.java)"""


class HBaseSinkBatchOp(_HasHBaseParams, KvSinkBatchOp):
    """(reference: operator/batch/sink/HBaseSinkBatchOp.java — rowKeyCols
    + familyName; each selected column lands as one qualifier)."""

    ROW_KEY_COLS = ParamInfo("rowKeyCols", list, aliases=("rowKeyCol",))
    KEY_COL = ParamInfo("keyCol", str, aliases=("rowKey",))

    def _execute_impl(self, t: MTable) -> MTable:
        # reference names the key column rowKeyCols; keyCol also accepted.
        # Derived locally — executing an op must not write back params
        key = self.get(self.KEY_COL)
        if not key:
            rk = self.get(self.ROW_KEY_COLS)
            if isinstance(rk, str):  # singular alias invites a bare string
                key = rk
            elif rk:
                key = rk[0]
            else:
                raise AkIllegalArgumentException(
                    "HBaseSink needs rowKeyCols (or keyCol)")
        store = self._open_hbase_store()
        try:
            self._write(t, store, key_col=key)
        finally:
            store.close()
        return t


# ---------------------------------------------------------------------------
# catalog source / sink (sqlite catalog plays the Hive/ODPS catalog role)
# ---------------------------------------------------------------------------


class CatalogSourceBatchOp(BatchOperator):
    """Read a table registered in a database catalog (reference:
    operator/batch/source/CatalogSourceBatchOp.java — Hive/ODPS/JDBC
    catalogs). ``dbPath`` routes by scheme: ``hive://host:port/db`` opens
    the pyhive-backed HiveCatalog, ``odps://`` the pyodps-backed
    OdpsCatalog, plain paths the built-in JDBC-sqlite catalog
    (alink_tpu_torch/io/hivecatalog.py)."""

    DB_PATH = ParamInfo("dbPath", str, optional=False,
                        aliases=("catalogPath", "url"))
    TABLE_NAME = ParamInfo("tableName", str, optional=False,
                           aliases=("inputTableName",))

    _max_inputs = 0

    def _execute_impl(self) -> MTable:
        from ...io.hivecatalog import open_catalog

        cat = open_catalog(self.get(self.DB_PATH))
        try:
            return cat.read_table(self.get(self.TABLE_NAME))
        finally:
            getattr(cat, "close", lambda: None)()

    def _out_schema(self):
        from ...io.hivecatalog import open_catalog

        cat = open_catalog(self.get(self.DB_PATH))
        try:
            return cat.get_table_schema(self.get(self.TABLE_NAME))
        finally:
            getattr(cat, "close", lambda: None)()


class CatalogSinkBatchOp(BatchOperator):
    """Write a table into a database catalog (reference:
    operator/batch/sink/CatalogSinkBatchOp.java). Scheme-routed like
    CatalogSourceBatchOp."""

    DB_PATH = ParamInfo("dbPath", str, optional=False,
                        aliases=("catalogPath", "url"))
    TABLE_NAME = ParamInfo("tableName", str, optional=False,
                           aliases=("outputTableName",))

    _min_inputs = 1
    _max_inputs = 1

    def _execute_impl(self, t: MTable) -> MTable:
        from ...io.hivecatalog import open_catalog

        cat = open_catalog(self.get(self.DB_PATH))
        try:
            cat.write_table(self.get(self.TABLE_NAME), t)
        finally:
            getattr(cat, "close", lambda: None)()
        return t

    def _out_schema(self, in_schema):
        return in_schema


class InternalFullStatsBatchOp(SummarizerBatchOp):
    """Full per-column statistics under the reference's internal name
    (reference: operator/batch/statistics/InternalFullStatsBatchOp.java —
    the engine behind the stats visualizer)."""


# ---------------------------------------------------------------------------
# TF table-model family (python-first collapse onto the shared DL loop)
# ---------------------------------------------------------------------------


class TFTableModelTrainBatchOp(KerasSequentialRegressorTrainBatchOp):
    """Train a user-declared network on table columns — the akdl
    TFTableModelTrain role; the reference runs a user TF script through
    DLLauncher, here the SAME layer-spec DSL trains via the port's
    KerasSequential loop and persists in the standard model table (reference:
    operator/batch/dataproc/TFTableModelTrainBatchOp.java)."""


class TF2TableModelTrainBatchOp(TFTableModelTrainBatchOp):
    """(reference: operator/batch/dataproc/TF2TableModelTrainBatchOp.java)"""


class TFTableModelRegressorPredictBatchOp(
        KerasSequentialRegressorPredictBatchOp):
    """(reference: operator/batch/regression/
    TFTableModelRegressorPredictBatchOp.java)"""


class TFTableModelClassifierPredictBatchOp(
        KerasSequentialClassifierPredictBatchOp):
    """(reference: operator/batch/classification/
    TFTableModelClassifierPredictBatchOp.java)"""


class TFTableModelClassifierTrainBatchOp(
        KerasSequentialClassifierTrainBatchOp):
    """(reference: operator/batch/classification/
    TFTableModelClassifierTrainBatchOp.java)"""


class TFTableModelRegressorTrainBatchOp(TFTableModelTrainBatchOp):
    """(reference: operator/batch/regression/
    TFTableModelRegressorTrainBatchOp.java)"""


class TFTableModelPredictBatchOp(KerasSequentialRegressorPredictBatchOp):
    """Serve a TFTableModel trainer's output on table columns — the
    (model, data) contract the rest of the family uses; foreign SavedModel
    artifacts serve through TFSavedModelPredictBatchOp instead (reference:
    operator/batch/dataproc/TFTableModelPredictBatchOp.java)."""


class TensorFlowBatchOp(JaxScriptBatchOp):
    """Run an arbitrary user training script with the session mesh + a
    dataset iterator handed in — the reference ships the table to a user
    TF1 script on a formed cluster via DLLauncher; here ``main(ctx)`` runs
    against the session's device (see JaxScriptBatchOp) (reference:
    operator/batch/dataproc/TensorFlowBatchOp.java)."""


class TensorFlow2BatchOp(TensorFlowBatchOp):
    """(reference: operator/batch/tensorflow/TensorFlow2BatchOp.java)"""


# ---------------------------------------------------------------------------
# XGBoost regression names (plugin-gated like the classifier)
# ---------------------------------------------------------------------------


class XGBoostRegTrainBatchOp(XGBoostTrainBatchOp):
    """(reference: operator/batch/regression/XGBoostRegTrainBatchOp.java)"""

    def __init__(self, params=None, **kw):
        super().__init__(params, **kw)
        # default the objective to regression ONLY when unset anywhere
        # (params object or kwargs)
        if not self._params.contains("objective"):
            self._params.set("objective", "reg:squarederror")


class XGBoostRegPredictBatchOp(XGBoostPredictBatchOp):
    """(reference: operator/batch/regression/XGBoostRegPredictBatchOp.java)"""


# ---------------------------------------------------------------------------
# tensor → image (dependency-free PNG encoder)
# ---------------------------------------------------------------------------


def _png_bytes(a: np.ndarray) -> bytes:
    """Minimal PNG writer: (h, w) grayscale or (h, w, 3) RGB uint8."""
    a = np.asarray(a)
    if a.dtype != np.uint8:
        lo, hi = float(a.min()), float(a.max())
        a = ((a - lo) / (hi - lo + 1e-12) * 255).astype(np.uint8)
    if a.ndim == 2:
        color_type, channels = 0, 1
    elif a.ndim == 3 and a.shape[2] == 3:
        color_type, channels = 2, 3
    else:
        raise AkIllegalDataException(
            f"tensor shape {a.shape} is not (h, w) or (h, w, 3)")
    h, w = a.shape[:2]
    raw = b"".join(
        b"\x00" + a[i].tobytes() for i in range(h))  # filter 0 per row

    def chunk(tag: bytes, payload: bytes) -> bytes:
        return (struct.pack(">I", len(payload)) + tag + payload
                + struct.pack(">I", zlib.crc32(tag + payload)))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(raw))
            + chunk(b"IEND", b""))


class WriteTensorToImageBatchOp(BatchOperator, HasSelectedCol,
                                HasReservedCols):
    """Write tensor cells as PNG files; the written path lands in a column
    (reference: operator/batch/image/WriteTensorToImageBatchOp.java — PNG
    encoded here by a dependency-free writer)."""

    ROOT_FILE_PATH = ParamInfo("rootFilePath", str, optional=False)
    RELATIVE_FILE_PATH_COL = ParamInfo("relativeFilePathCol", str,
                                       optional=False)

    _min_inputs = 1
    _max_inputs = 1

    def _execute_impl(self, t: MTable) -> MTable:
        root = self.get(self.ROOT_FILE_PATH).rstrip("/")
        rel_col = self.get(self.RELATIVE_FILE_PATH_COL)
        sel = self.get(HasSelectedCol.SELECTED_COL)
        for cell, rel in zip(t.col(sel), t.col(rel_col)):
            if cell is None:
                continue
            path = f"{root}/{rel}"
            with file_open(path, "wb") as f:
                f.write(_png_bytes(np.asarray(cell)))
        return t

    def _out_schema(self, in_schema):
        return in_schema


# ---------------------------------------------------------------------------
# aggregated embedding lookup
# ---------------------------------------------------------------------------


# gathered embedding rows (keys x dims) the device reduces at a time
_AGG_CHUNK_ELEMS = 1 << 27


class AggLookupMapper(ModelMapper, HasSelectedCol, HasOutputCol,
                      HasReservedCols):
    """Delimited keys → aggregate of their model vectors (reference:
    operator/common/dataproc/AggLookupModelMapper.java — CONCAT/AVG/SUM/
    MAX/MIN over embedding vectors). The table lives on the device as one
    float64 block; the host splits each cell into keys and looks up their
    rows (a key seen twice in the model keeps its last vector)."""

    HANDLE = ParamInfo("handle", str, default="AVG",
                       validator=InValidator("AVG", "MEAN", "SUM", "MAX",
                                             "MIN", "CONCAT"))
    DELIMITER = ParamInfo("delimiter", str, default=",")

    def load_model(self, model: MTable):
        import torch

        key_col, vec_col = model.names[0], model.names[-1]
        self.row_of = {str(k): i for i, k in enumerate(model.col(key_col))}
        vecs = [parse_vector(v).to_dense().data for v in model.col(vec_col)]
        block = np.stack(vecs) if vecs else np.zeros((0, 0))
        self.table = torch.as_tensor(block, dtype=torch.float64,
                                     device=resolve_device(self.device))
        return self

    def output_schema(self, input_schema):
        out = self.get(HasOutputCol.OUTPUT_COL) or "agg_vec"
        return self._append_result_schema(
            input_schema, [out], [AlinkTypes.DENSE_VECTOR])

    def _lookup(self, cells):
        """(model rows of every hit key, in order; hits per cell)."""
        get = self.row_of.get
        delim = self.get(self.DELIMITER)
        rows, counts = [], np.zeros(len(cells), np.int64)
        for i, cell in enumerate(cells):
            if cell is None:
                continue
            hit = [r for r in (get(k.strip()) if k.strip() else None
                               for k in str(cell).split(delim))
                   if r is not None]
            rows += hit
            counts[i] = len(hit)
        return np.asarray(rows, np.int64), counts

    def _reduce(self, rows, counts, how):
        """One chunk of cells with at least one hit each: (cells, D) for the
        reductions, or the gathered (hits, D) block for CONCAT."""
        import torch

        dev = self.table.device
        idx = torch.as_tensor(rows, device=dev)
        gathered = self.table.index_select(0, idx)
        if how == "CONCAT":
            return gathered.cpu().numpy()
        seg = torch.as_tensor(np.repeat(np.arange(counts.size), counts),
                              device=dev)
        out = torch.zeros((counts.size, self.table.shape[1]),
                          dtype=torch.float64, device=dev)
        if how in ("MAX", "MIN"):
            out.scatter_reduce_(
                0, seg[:, None].expand_as(gathered), gathered,
                "amax" if how == "MAX" else "amin", include_self=False)
        else:
            out.index_add_(0, seg, gathered)
            if how != "SUM":            # AVG / MEAN
                out /= torch.as_tensor(counts, dtype=torch.float64,
                                       device=dev)[:, None]
        return out.cpu().numpy()

    def map_table(self, t: MTable) -> MTable:
        sel = self.get(HasSelectedCol.SELECTED_COL)
        how = self.get(self.HANDLE)
        out = self.get(HasOutputCol.OUTPUT_COL) or "agg_vec"
        rows, counts = self._lookup(t.col(sel))
        vecs = np.empty(t.num_rows, object)
        hit = np.flatnonzero(counts)
        width = max(int(self.table.shape[1]), 1)
        ends = np.cumsum(counts[hit])
        s = 0
        while s < hit.size:
            # cells whose gathered rows fit one chunk (one cell at least)
            first = ends[s] - counts[hit[s]]
            e = max(s + 1, int(np.searchsorted(
                ends, first + _AGG_CHUNK_ELEMS // width, side="right")))
            part = hit[s:e]
            res = self._reduce(rows[first:ends[e - 1]], counts[part], how)
            if how == "CONCAT":
                starts = np.concatenate([[0], np.cumsum(counts[part])])
                for j, i in enumerate(part):
                    vecs[i] = DenseVector(
                        res[starts[j]:starts[j + 1]].reshape(-1))
            else:
                vecs[part] = dense_vectors(res)
            s = e
        return self._append_result(
            t, {out: vecs}, {out: AlinkTypes.DENSE_VECTOR})


class AggLookupBatchOp(ModelMapBatchOp, HasSelectedCol, HasOutputCol,
                       HasReservedCols):
    """(reference: operator/batch/dataproc/AggLookupBatchOp.java)"""

    mapper_cls = AggLookupMapper
    HANDLE = AggLookupMapper.HANDLE
    DELIMITER = AggLookupMapper.DELIMITER


# ---------------------------------------------------------------------------
# stepwise-regression reference names
# ---------------------------------------------------------------------------


class LinearRegStepwiseTrainBatchOp(StepwiseLinearRegTrainBatchOp):
    """(reference: operator/batch/regression/
    LinearRegStepwiseTrainBatchOp.java)"""


class LinearRegStepwisePredictBatchOp(LinearRegPredictBatchOp):
    """(reference: operator/batch/regression/
    LinearRegStepwisePredictBatchOp.java — the stepwise model serves
    through the standard linear predictor)."""
