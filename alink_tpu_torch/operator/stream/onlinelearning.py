"""Online learning: FTRL train/predict streams + model quality filter (port
of ``alink_tpu.operator.stream.onlinelearning``).

Capability parity (reference: operator/stream/onlinelearning/
FtrlTrainStreamOp.java:63 — warm-start from a batch LR model via DirectReader
at :67, unbounded feedback iteration at :133-178, fragment merge + ModelUpdater
at :147,:265, periodic model snapshots; FtrlPredictStreamOp — model hot-swap;
BinaryClassModelFilterStreamOp — only forwards models beating AUC/acc gates).

Device design: the FTRL-proximal state lives in one device tensor
(z, n, the weights and √n, one row each, plus a scratch column). Each
micro-batch is the reference's per-row scan, one row after another, over
the row's non-zero coordinates only: a coordinate a row does not touch has
g = 0, so its z and n stay as they are, bit for bit, and the scan equals
the reference's dense one. The rows are an ELL block (``_ell_rows``, the
intercept one more slot, padding on the scratch column with value 0, an
exact no-op). Each row's dot product and sigmoid run in float64 and round
to float32 once, so the card and the CPU agree bit for bit; the rest is
the reference's float32 arithmetic, one elementwise op at a time. On the
card the scan of a chunk replays CUDA graphs of ``_GRAPH_ROWS`` rows each,
captured once from the second chunk on (the per-row scan is bound by
launches). OnlineFm and OnlineLearning take one autograd step a chunk on
the session's device.
"""

from __future__ import annotations

from typing import Iterator, List, Optional

import numpy as np

from ...common.exceptions import AkIllegalDataException
from ...common.model import model_to_table, table_to_model
from ...common.mtable import AlinkTypes, MTable
from ...common.params import ParamInfo
from ...mapper import (
    HasFeatureCols,
    HasPredictionCol,
    HasPredictionDetailCol,
    HasReservedCols,
    HasVectorCol,
    resolve_feature_cols,
)
from ..batch.linear import LinearModelMapper
from .base import (GlobalElasticStateMixin, ModelMapStreamOp,
                   StreamOperator)

# warm-up chunks buffer host-side until both classes arrive; bound the
# buffer so a one-label stream fails fast instead of accumulating RAM
_WARMUP_MAX_ROWS = 100_000

# rows of one captured CUDA graph of the FTRL scan
_GRAPH_ROWS = 32


def _ftrl_weights_np(z, n, alpha, beta, l1, l2):
    """The FTRL closed form in float32 numpy (the reference's host form)."""
    w = -(z - np.sign(z) * l1) / ((beta + np.sqrt(n)) / alpha + l2)
    return np.where(np.abs(z) <= l1, 0.0, w).astype(np.float32)


def _ell_rows(vecs, width: int):
    """An ELL block of a vector column: ``idx`` (rows, k) int64 and ``val``
    (rows, k) float32, the intercept at index ``width`` with value 1 and
    padding at ``width + 1`` (the scan's scratch column) with value 0. A
    duplicated index keeps its last value, as the dense block's assignment
    does; an index at or above ``width`` raises, as it does there."""
    from ...common.linalg import SparseVector, parse_vector

    vecs = [parse_vector(v) for v in vecs]
    rows = len(vecs)
    if rows and all(isinstance(v, SparseVector) for v in vecs):
        nnz = np.fromiter((v.indices.size for v in vecs), np.int64, rows)
        flat_i = np.concatenate([v.indices for v in vecs])
        flat_v = np.concatenate([v.values for v in vecs])
        row_of = np.repeat(np.arange(rows), nnz)
        if flat_i.size and (flat_i.max() >= width or flat_i.min() < 0):
            raise AkIllegalDataException(
                f"sparse index {int(flat_i.max())} out of the feature width "
                f"{width}")
        key = row_of * (width + 1) + flat_i
        # the constructor sorts each vector's indices stably, so the last of
        # a run of equal keys is the value a dense assignment keeps
        last = np.ones(key.size, bool)
        if key.size > 1:
            last[:-1] = key[1:] != key[:-1]
        if not last.all():
            row_of, flat_i, flat_v = row_of[last], flat_i[last], flat_v[last]
            nnz = np.bincount(row_of, minlength=rows)
        k = int(nnz.max(initial=0)) + 1
        idx = np.full((rows, k), width + 1, np.int64)
        val = np.zeros((rows, k), np.float32)
        start = np.concatenate([[0], np.cumsum(nnz)[:-1]])
        col = np.arange(row_of.size) - np.repeat(start, nnz)
        idx[row_of, col] = flat_i
        val[row_of, col] = flat_v
        idx[np.arange(rows), nnz] = width
        val[np.arange(rows), nnz] = 1.0
        return idx, val
    from ...common.linalg import stack_vectors

    return _dense_rows(stack_vectors(vecs, size=width, dtype=np.float32))


def _dense_rows(X: np.ndarray):
    """The ELL block of a dense (rows, d) block: every column, then the
    intercept at index d."""
    rows, d = X.shape
    idx = np.broadcast_to(np.arange(d + 1, dtype=np.int64), (rows, d + 1))
    val = np.concatenate([X.astype(np.float32),
                          np.ones((rows, 1), np.float32)], 1)
    return np.ascontiguousarray(idx), val


class _FtrlScan:
    """The FTRL-proximal accumulators on one device, and the per-row scan
    over ELL rows. ``S`` holds z, n, the weights and √n as rows over D + 1
    columns, the last a scratch column that padding entries touch."""

    def __init__(self, z: np.ndarray, n: np.ndarray, hp, device):
        import torch

        self.device = device
        self.D = int(z.shape[0])
        f32 = dict(dtype=torch.float32, device=device)
        # constants as 1-element device tensors: a CPU scalar divisor takes
        # the reciprocal route on the card, which the CPU does not
        self.alpha, self.beta, self.l1, self.l2 = (
            torch.tensor([v], **f32) for v in hp)
        self.zero = torch.zeros(1, **f32)
        S = torch.zeros((4, self.D + 1), **f32)
        S[0, :self.D] = torch.as_tensor(np.asarray(z, np.float32))
        S[1, :self.D] = torch.as_tensor(np.asarray(n, np.float32))
        S[3] = torch.sqrt(S[1])
        S[2] = self._weights(S[0], S[3])
        self.S = S
        self._graphs: list = []
        self._chunks = 0

    def _weights(self, z, sq):
        import torch

        num = z - torch.sign(z) * self.l1
        den = (sq + self.beta) / self.alpha + self.l2
        return torch.where(z.abs() <= self.l1, self.zero, -(num / den))

    def _row(self, ix, v, v64, yi) -> None:
        import torch

        S = self.S
        zi, ni, wi, si = S[:, ix].unbind(0)
        p = torch.sigmoid((wi.double() * v64).sum()).float()
        g = (p - yi) * v
        nn = ni + g * g
        sq = torch.sqrt(nn)
        sigma = (sq - si) / self.alpha
        zn = zi + g - sigma * wi
        S.index_copy_(1, ix, torch.stack((zn, nn, self._weights(zn, sq),
                                          sq)))

    def z(self) -> np.ndarray:
        return self.S[0, :self.D].cpu().numpy().copy()

    def n(self) -> np.ndarray:
        return self.S[1, :self.D].cpu().numpy().copy()

    def weights(self) -> np.ndarray:
        return self.S[2, :self.D].cpu().numpy().copy()

    def run(self, idx: np.ndarray, val: np.ndarray, y: np.ndarray) -> None:
        import torch

        dev = self.device
        t_idx = torch.as_tensor(idx, device=dev)
        t_val = torch.as_tensor(val, device=dev)
        t_y = torch.as_tensor(y, device=dev)
        self._chunks += 1
        if dev.type != "cuda" or self._chunks == 1:
            # the CPU route, and the card's first chunk (loads every kernel
            # the graphs capture): one eager row at a time
            t_v64 = t_val.double()
            for i in range(idx.shape[0]):
                self._row(t_idx[i], t_val[i], t_v64[i], t_y[i])
            return
        self._run_graphed(t_idx, t_val, t_y)

    # -- CUDA graphs ---------------------------------------------------------
    def _capture(self, rows: int, k: int) -> None:
        import torch

        B = _GRAPH_ROWS
        rows = -(-rows // B) * B
        dev = self.device
        self._idx = torch.full((rows, k), self.D, dtype=torch.int64,
                               device=dev)
        self._val = torch.zeros((rows, k), dtype=torch.float32, device=dev)
        self._v64 = torch.zeros((rows, k), dtype=torch.float64, device=dev)
        self._y = torch.zeros(rows, dtype=torch.float32, device=dev)
        torch.cuda.synchronize(dev)
        self._graphs = []
        for b in range(rows // B):
            g = torch.cuda.CUDAGraph()
            # thread-local: another chain of a recovery job may run device
            # work on its own thread meanwhile
            with torch.cuda.graph(g, capture_error_mode="thread_local"):
                for i in range(b * B, (b + 1) * B):
                    self._row(self._idx[i], self._val[i], self._v64[i],
                              self._y[i])
            self._graphs.append(g)

    def _run_graphed(self, t_idx, t_val, t_y) -> None:
        B = _GRAPH_ROWS
        R, k = t_idx.shape
        if not self._graphs or k > self._idx.shape[1]:
            self._capture(max(R, self._idx.shape[0] if self._graphs else 0),
                          max(k, self._idx.shape[1] if self._graphs else 0))
        cap = self._idx.shape[0]
        for s in range(0, R, cap):
            r = min(cap, R - s)
            nb = -(-r // B)
            # rows past r and columns past k are no-op padding on the
            # scratch column
            self._idx[:nb * B].fill_(self.D)
            self._val[:nb * B].zero_()
            self._y[:nb * B].zero_()
            self._idx[:r, :k].copy_(t_idx[s:s + r])
            self._val[:r, :k].copy_(t_val[s:s + r])
            self._v64[:nb * B].copy_(self._val[:nb * B])
            self._y[:r].copy_(t_y[s:s + r])
            for b in range(nb):
                self._graphs[b].replay()


def _ftrl_device_state_to_host(st: dict) -> None:
    scan = st.get("scan")
    if scan is not None:
        st["z"], st["n"] = scan.z(), scan.n()


class HasFtrlParams(HasVectorCol, HasFeatureCols):
    LABEL_COL = ParamInfo("labelCol", str, optional=False)
    ALPHA = ParamInfo("alpha", float, default=0.1)
    BETA = ParamInfo("beta", float, default=1.0)
    L_1 = ParamInfo("l1", float, default=0.0)
    L_2 = ParamInfo("l2", float, default=0.0)
    VECTOR_SIZE = ParamInfo("vectorSize", int, default=0)
    MODEL_SAVE_INTERVAL = ParamInfo(
        "modelSaveInterval", int, default=1,
        desc="emit a model snapshot every k micro-batches",
    )


class FtrlTrainStreamOp(GlobalElasticStateMixin, StreamOperator,
                        HasFtrlParams):
    """Streaming FTRL logistic regression; emits model snapshot tables.
    Warm-starts from a batch-trained linear model when given one.

    Elastic: the (z, n) accumulators are one global model — the state
    rides a pinned key group (GlobalElasticStateMixin), so a rescale
    moves the accumulators whole to the new owner partition and the
    resumed stream is bit-identical to a fixed-parallelism run."""

    _min_inputs = 1
    _max_inputs = 1

    def __init__(self, initial_model: Optional[MTable] = None, params=None,
                 **kwargs):
        super().__init__(params, **kwargs)
        self._initial_model = initial_model

    def _hyper(self):
        return (self.get(self.ALPHA), self.get(self.BETA),
                self.get(self.L_1), self.get(self.L_2))

    # FTRL state (z, n) and warm-up bookkeeping live on the instance so
    # epoch snapshots (common/recovery.py) can persist them: a resumed job
    # restarts mid-stream with the exact accumulators. While the stream
    # runs, "scan" holds them on the device; "z"/"n" are host copies.
    def _ftrl_state(self) -> dict:
        st = getattr(self, "_fstate", None)
        if st is not None:
            return st
        alpha, beta, l1, l2 = self._hyper()
        st = {
            "z": None, "n": None,
            "labels": None, "label_type": None,
            "meta0": {},
            "vec_col": self.get(HasVectorCol.VECTOR_COL),
            # resolved once (first chunk / initial model) and persisted in
            # every snapshot so predict binds to the same columns
            "feat_cols": self.get(HasFeatureCols.FEATURE_COLS),
            "batch_no": 0,
            "warmup": [],   # chunks buffered until 2 distinct labels arrive
            "seen_labels": set(),
        }
        if self._initial_model is not None:
            meta0, arrays = table_to_model(self._initial_model)
            w0 = np.concatenate(
                [arrays["weights"].reshape(-1),
                 arrays["intercept"].reshape(-1)]
            )
            st["meta0"] = meta0
            st["labels"] = meta0.get("labels")
            st["label_type"] = meta0.get("labelType", AlinkTypes.STRING)
            st["vec_col"] = st["vec_col"] or meta0.get("vectorCol")
            st["feat_cols"] = st["feat_cols"] or meta0.get("featureCols")
            # invert the closed form at n=0 so weights(z, 0) == w0
            st["z"] = np.asarray(
                -(w0 * (beta / alpha + l2)) - np.sign(w0) * l1,
            ).astype(np.float32)
            st["n"] = np.zeros_like(st["z"])
            st["seen_labels"] = set(st["labels"] or [])
        self._fstate = st
        return st

    def state_snapshot(self) -> dict:
        st = self._ftrl_state()
        _ftrl_device_state_to_host(st)
        out = {k: v for k, v in st.items() if k != "scan"}
        out["z"] = None if st["z"] is None else np.array(st["z"], np.float32)
        out["n"] = None if st["n"] is None else np.array(st["n"], np.float32)
        out["seen_labels"] = set(st["seen_labels"])
        out["warmup"] = list(st["warmup"])
        return out

    def state_restore(self, state: dict) -> None:
        # z/n stay host numpy here; the next chunk stages them on the
        # device (float32 both ways, so they round-trip bit-exactly)
        self._fstate = {k: v for k, v in state.items() if k != "scan"}

    def servable_model(self) -> Optional[MTable]:
        """Barrier-time model snapshot for the modelstream publisher: the
        current (z, n) accumulators rendered as a servable LinearModel
        table via the FTRL closed form, computed host-side — a restored
        epoch's accumulators are bit-exact, so a republished epoch yields
        the identical model. None until warm-up resolved both labels."""
        st = getattr(self, "_fstate", None)
        if not st:
            return None
        _ftrl_device_state_to_host(st)
        if st.get("z") is None or not st.get("labels") \
                or len(st["labels"]) < 2:
            return None
        z = np.asarray(st["z"], np.float32)
        n = np.asarray(st["n"], np.float32)
        w = _ftrl_weights_np(z, n, *self._hyper())
        meta = {
            "modelName": "LinearModel",
            "linearModelType": "LR",
            "vectorCol": st["vec_col"],
            "featureCols": st["feat_cols"],
            "labelCol": self.get(self.LABEL_COL),
            "labelType": st.get("label_type") or AlinkTypes.STRING,
            "labels": st["labels"],
            "hasIntercept": True,
            "dim": int(z.shape[0] - 1),
            "batchNo": st["batch_no"],
        }
        return model_to_table(meta, {
            "weights": w[:-1].astype(np.float32),
            "intercept": np.asarray([w[-1]], np.float32)})

    def _rows(self, chunk: MTable, st: dict, label_col: str):
        """The chunk's features as an ELL block (intercept included) and
        the feature width."""
        if st["vec_col"]:
            vecs = chunk.col(st["vec_col"])
            size = self.get(self.VECTOR_SIZE) or None
            if size is None:
                from ...common.linalg import parse_vector

                size = max((parse_vector(v).size() for v in vecs),
                           default=0)
            return _ell_rows(vecs, size) + (size,)
        if st["feat_cols"] is None:
            st["feat_cols"] = resolve_feature_cols(
                chunk, self, exclude=[label_col]
            )
        X = chunk.to_numeric_block(st["feat_cols"]).astype(np.float32)
        return _dense_rows(X) + (X.shape[1],)

    def _stream_impl(self, it: Iterator[MTable]) -> Iterator[MTable]:
        from ...common.env import resolve_device

        device = resolve_device()
        label_col = self.get(self.LABEL_COL)
        interval = self.get(self.MODEL_SAVE_INTERVAL)

        st = self._ftrl_state()
        for chunk in it:
            if chunk.num_rows == 0:
                continue
            st["seen_labels"].update(
                np.asarray(chunk.col(label_col)).tolist())
            if len(st["seen_labels"]) > 2:
                raise AkIllegalDataException(
                    "FTRL is binary; saw labels "
                    f"{sorted(map(str, st['seen_labels']))}")
            if st["labels"] is None or len(st["labels"]) < 2:
                # same warm-up contract as OnlineFm: a label-skewed first
                # chunk must not train a one-label model
                if len(st["seen_labels"]) < 2:
                    st["warmup"].append(chunk)
                    if sum(c.num_rows
                           for c in st["warmup"]) > _WARMUP_MAX_ROWS:
                        raise AkIllegalDataException(
                            "FTRL warm-up saw only one label in the first "
                            f"{_WARMUP_MAX_ROWS} rows; a binary stream must "
                            "deliver both classes early (or warm-start from "
                            "a batch model carrying the label set)")
                    continue
                st["labels"] = sorted(st["seen_labels"], key=str)
                st["label_type"] = chunk.schema.type_of(label_col)
                if st["warmup"]:
                    chunk = MTable.concat(st["warmup"] + [chunk])
                    st["warmup"] = []
            idx, val, width = self._rows(chunk, st, label_col)
            y_raw = np.asarray(chunk.col(label_col)).tolist()
            y = np.asarray(
                [1.0 if v == st["labels"][0] else 0.0 for v in y_raw],
                np.float32
            )
            scan = st.get("scan")
            if scan is None:
                if st["z"] is None:
                    st["z"] = np.zeros(width + 1, np.float32)
                    st["n"] = np.zeros(width + 1, np.float32)
                scan = st["scan"] = _FtrlScan(st["z"], st["n"],
                                              self._hyper(), device)
            if width + 1 != scan.D:
                raise AkIllegalDataException(
                    f"feature dim {width} != model dim {scan.D - 1}"
                )
            scan.run(idx, val, y)
            st["z"] = st["n"] = None   # the device holds them now
            st["batch_no"] += 1
            if st["batch_no"] % interval == 0 and len(st["labels"]) == 2:
                w_np = scan.weights()
                meta = {
                    "modelName": "LinearModel",
                    "linearModelType": "LR",
                    "vectorCol": st["vec_col"],
                    "featureCols": st["feat_cols"],
                    "labelCol": label_col,
                    "labelType": st["meta0"].get("labelType",
                                                 AlinkTypes.STRING)
                    if self._initial_model is not None
                    else chunk.schema.type_of(label_col),
                    "labels": st["labels"],
                    "hasIntercept": True,
                    "dim": int(scan.D - 1),
                    "batchNo": st["batch_no"],
                }
                yield model_to_table(
                    meta,
                    {
                        "weights": w_np[:-1].astype(np.float32),
                        "intercept": np.asarray([w_np[-1]], np.float32),
                    },
                )


class FtrlPredictStreamOp(ModelMapStreamOp, HasPredictionCol,
                          HasPredictionDetailCol, HasReservedCols):
    """link_from(model_stream, data_stream) — hot-swaps the newest model
    (reference: FtrlPredictStreamOp + ModelStreamModelMapperAdapter)."""

    mapper_cls = LinearModelMapper


class BinaryClassModelFilterStreamOp(StreamOperator):
    """Forward only model snapshots whose accuracy on the concurrent data
    stream beats the threshold (reference: onlinelearning/
    BinaryClassModelFilterStreamOp.java)."""

    _min_inputs = 2
    _max_inputs = 2

    LABEL_COL = ParamInfo("labelCol", str, optional=False)
    ACCURACY_THRESHOLD = ParamInfo("accuracyThreshold", float, default=0.5)
    NUM_EVAL_BATCHES = ParamInfo(
        "numEvalBatches", int, default=5,
        desc="evaluate over a sliding window of the last k data micro-batches",
    )

    def _stream_impl(self, model_it, data_it) -> Iterator[MTable]:
        label_col = self.get(self.LABEL_COL)
        thresh = self.get(self.ACCURACY_THRESHOLD)
        window = max(1, self.get(self.NUM_EVAL_BATCHES))
        data_chunks: List[MTable] = []

        def passes(model: MTable) -> bool:
            eval_t = MTable.concat(data_chunks)
            mapper = LinearModelMapper(
                model.schema, eval_t.schema,
                self.get_params().clone().set("predictionCol", "__pred__"),
            ).load_model(model)
            pred = mapper.map_table(eval_t)
            acc = float(
                np.mean(
                    np.asarray(pred.col("__pred__")).astype(str)
                    == np.asarray(eval_t.col(label_col)).astype(str)
                )
            )
            return acc >= thresh

        pending: Optional[MTable] = None
        for model in model_it:
            try:
                data_chunks.append(next(data_it))
            except StopIteration:
                pass
            del data_chunks[:-window]
            if not data_chunks:
                pending = model  # no evidence yet — hold the newest model
                continue
            pending = None
            if passes(model):
                yield model
        if pending is not None:
            # model stream outran the data stream: drain remaining data and
            # give the newest unevaluated model its quality check
            for chunk in data_it:
                data_chunks.append(chunk)
                del data_chunks[:-window]
            if data_chunks and passes(pending):
                yield pending


def _fm_update(params, accum, X, y, lr: float):
    """One AdaGrad step of the binary FM's mean logistic loss over (w0, w,
    V) (the reference's ``_build_fm_update``)."""
    import torch

    from ...optim.objfunc import fm_pairwise

    ps = [p.detach().requires_grad_(True) for p in params]
    w0, w, V = ps
    s = w0 + X @ w + fm_pairwise(X, V)
    loss = torch.logaddexp(torch.zeros_like(s), -y * s).mean()
    grads = torch.autograd.grad(loss, ps)
    new_accum = tuple(a + g * g for a, g in zip(accum, grads))
    new_params = tuple((p - lr * g / torch.sqrt(a + 1e-8)).detach()
                       for p, g, a in zip(params, grads, new_accum))
    return new_params, new_accum


class OnlineFmTrainStreamOp(GlobalElasticStateMixin, StreamOperator,
                            HasVectorCol, HasFeatureCols):
    """Streaming factorization machine (binary) with AdaGrad updates; emits
    FmModel snapshot tables servable by FmPredict (reference:
    operator/stream/onlinelearning OnlineFM ops over the FtrlOnlineFm
    kernel)."""

    LABEL_COL = ParamInfo("labelCol", str, optional=False)
    NUM_FACTOR = ParamInfo("numFactor", int, default=8)
    LEARN_RATE = ParamInfo("learnRate", float, default=0.1)
    INIT_STDEV = ParamInfo("initStdev", float, default=0.05)
    MODEL_SAVE_INTERVAL = ParamInfo("modelSaveInterval", int, default=1)
    RANDOM_SEED = ParamInfo("randomSeed", int, default=0, aliases=("seed",))

    _min_inputs = 1
    _max_inputs = 1

    # AdaGrad state (device tensors while the stream runs) + warm-up
    # bookkeeping on the instance, same epoch snapshot/restore contract as
    # FtrlTrainStreamOp
    def _fm_state(self) -> dict:
        st = getattr(self, "_fmstate", None)
        if st is None:
            st = self._fmstate = {
                "state": None,  # (params, accum): (w0, w, V) each
                "labels": None, "label_type": None,
                "batch_no": 0, "warmup": [], "seen_labels": set(),
                "vec_col": self.get(HasVectorCol.VECTOR_COL),
                "feat_cols": self.get(HasFeatureCols.FEATURE_COLS),
                # Generator objects pickle, so the full RNG stream state
                # survives snapshots: restored draws continue the sequence
                "rng": np.random.default_rng(self.get(self.RANDOM_SEED)),
            }
        return st

    @staticmethod
    def _host_state(state):
        return tuple(tuple(np.asarray(a.cpu().numpy() if hasattr(a, "cpu")
                                      else a) for a in tree)
                     for tree in state)

    def state_snapshot(self) -> dict:
        st = self._fm_state()
        out = dict(st)
        if st["state"] is not None:
            out["state"] = self._host_state(st["state"])
        out["seen_labels"] = set(st["seen_labels"])
        out["warmup"] = list(st["warmup"])
        return out

    def state_restore(self, state: dict) -> None:
        self._fmstate = dict(state)

    def _model_table(self, st: dict, params, d: int) -> MTable:
        w0, w, V = self._host_state((params,))[0]
        meta = {
            "modelName": "FmModel", "fmTask": "binary",
            "numFactor": self.get(self.NUM_FACTOR),
            "vectorCol": st["vec_col"],
            "featureCols": (list(st["feat_cols"])
                            if st["feat_cols"] else None),
            "labelCol": self.get(self.LABEL_COL),
            "labelType": st["label_type"],
            "labels": st["labels"], "dim": int(d),
        }
        return model_to_table(meta, {
            "w0": np.asarray([w0], np.float32),
            "w": np.asarray(w, np.float32),
            "V": np.asarray(V, np.float32)})

    def servable_model(self) -> Optional[MTable]:
        """Barrier-time FmModel snapshot for the modelstream publisher —
        the AdaGrad params straight from state, so a restored epoch
        republishes bit-identically. None until warm-up resolved."""
        st = getattr(self, "_fmstate", None)
        if not st or st.get("state") is None or not st.get("labels"):
            return None
        params, _ = st["state"]
        return self._model_table(st, params, int(params[1].shape[0]))

    def _stream_impl(self, it: Iterator[MTable]) -> Iterator[MTable]:
        import torch

        from ...common.env import resolve_device

        device = resolve_device()
        kf = self.get(self.NUM_FACTOR)
        lr = self.get(self.LEARN_RATE)
        interval = self.get(self.MODEL_SAVE_INTERVAL)
        label_col = self.get(self.LABEL_COL)
        st = self._fm_state()
        # no row bucketing: the loss is a row MEAN, so padding would change
        # the gradient

        for chunk in it:
            if chunk.num_rows == 0:
                continue
            if st["feat_cols"] is None and not st["vec_col"]:
                st["feat_cols"] = resolve_feature_cols(chunk, self,
                                                       exclude=[label_col])
            st["seen_labels"].update(
                np.asarray(chunk.col(label_col)).tolist())
            if st["labels"] is None:
                # same warm-up contract as FTRL: a label-skewed first chunk
                # must not freeze a one-label (or 3+-label) model
                if len(st["seen_labels"]) > 2:
                    raise AkIllegalDataException(
                        "OnlineFm is binary; saw labels "
                        f"{sorted(map(str, st['seen_labels']))}")
                if len(st["seen_labels"]) < 2:
                    st["warmup"].append(chunk)
                    if sum(c.num_rows
                           for c in st["warmup"]) > _WARMUP_MAX_ROWS:
                        raise AkIllegalDataException(
                            "OnlineFm warm-up saw only one label in the "
                            f"first {_WARMUP_MAX_ROWS} rows; a binary stream "
                            "must deliver both classes early")
                    continue
                st["labels"] = sorted(st["seen_labels"],
                                      key=lambda v: str(v))
                st["label_type"] = chunk.schema.type_of(label_col)
                if st["warmup"]:
                    chunk = MTable.concat(st["warmup"] + [chunk])
                    st["warmup"] = []
            X = chunk.to_numeric_block(
                [st["vec_col"]] if st["vec_col"] else st["feat_cols"],
                dtype=np.float32)
            y_raw = chunk.col(label_col)
            y = np.where(np.asarray(y_raw) == st["labels"][0], 1.0, -1.0) \
                .astype(np.float32)
            d = X.shape[1]
            if st["state"] is None:
                # the initial factors come from the seeded numpy stream, so
                # every device starts from the same weights
                V0 = st["rng"].normal(0, self.get(self.INIT_STDEV),
                                      (d, kf)).astype(np.float32)
                params = (np.asarray(0.0, np.float32),
                          np.zeros(d, np.float32), V0)
                accum = tuple(np.full_like(p, 1e-8) for p in params)
                st["state"] = (params, accum)
            # host arrays (fresh or restored) are copied into tensors of
            # torch's own allocation: a product's summation path may
            # depend on its operands' alignment
            params, accum = (tuple(
                a.to(device) if isinstance(a, torch.Tensor)
                else torch.tensor(np.asarray(a), device=device)
                for a in tree) for tree in st["state"])
            params, accum = _fm_update(
                params, accum, torch.tensor(X, device=device),
                torch.tensor(y, device=device), lr)
            st["state"] = (params, accum)
            st["batch_no"] += 1
            if st["batch_no"] % interval == 0:
                yield self._model_table(st, params, d)


class OnlineFmPredictStreamOp(ModelMapStreamOp, HasPredictionCol,
                              HasPredictionDetailCol, HasReservedCols,
                              HasVectorCol, HasFeatureCols):
    """Hot-swap FM serving over an OnlineFm model stream."""

    from ...operator.batch.classification import FmModelMapper as _FmMapper

    mapper_cls = _FmMapper


def _ol_update(w, X, y, lr: float, squared: bool):
    """One SGD step of the linear model's mean loss (the reference's
    ``_build_ol_update``): squared for regression, logistic else."""
    import torch

    w = w.detach().requires_grad_(True)
    s = X @ w[:-1] + w[-1]
    if squared:
        loss = 0.5 * ((s - y) ** 2).mean()
    else:
        loss = torch.logaddexp(torch.zeros_like(s), -y * s).mean()
    (g,) = torch.autograd.grad(loss, (w,))
    return (w - lr * g).detach()


class OnlineLearningStreamOp(StreamOperator):
    """Generic online refinement of a batch-trained LinearModel: per-chunk
    SGD on the matching loss (logistic for classifiers, squared for
    regression), emitting updated model snapshots (reference:
    operator/stream/onlinelearning/OnlineLearningStreamOp.java — online
    update of a fitted pipeline stage)."""

    LEARN_RATE = ParamInfo("learnRate", float, default=0.01)
    MODEL_SAVE_INTERVAL = ParamInfo("modelSaveInterval", int, default=1)

    _min_inputs = 2
    _max_inputs = 2

    def _stream_impl(self, model_it, data_it) -> Iterator[MTable]:
        import torch

        from ...common.env import resolve_device

        device = resolve_device()
        lr = self.get(self.LEARN_RATE)
        interval = self.get(self.MODEL_SAVE_INTERVAL)
        # the initial model may arrive split over micro-batches: drain it
        model_chunks = list(model_it)
        meta, arrays = table_to_model(MTable.concat(model_chunks))
        mtype = meta["linearModelType"]
        squared = mtype in ("LinearReg", "SVR")
        w = torch.as_tensor(np.concatenate(
            [arrays["weights"].reshape(-1),
             arrays["intercept"].reshape(-1)]).astype(np.float32),
            device=device)
        label_col = meta["labelCol"]
        feat_cols = meta.get("featureCols")
        vec_col = meta.get("vectorCol")
        labels = meta.get("labels")

        batch_no = 0
        for chunk in data_it:
            if chunk.num_rows == 0:
                continue
            X = chunk.to_numeric_block(
                [vec_col] if vec_col else feat_cols, dtype=np.float32)
            y_raw = chunk.col(label_col)
            if squared:
                y = np.asarray(y_raw, np.float32)
            else:
                y = np.where(np.asarray(y_raw) == labels[0], 1.0, -1.0) \
                    .astype(np.float32)
            w = _ol_update(w, torch.tensor(X, device=device),
                           torch.tensor(y, device=device), lr, squared)
            batch_no += 1
            if batch_no % interval == 0:
                wv = w.cpu().numpy()
                yield model_to_table(meta, {
                    "weights": wv[:-1].astype(np.float32),
                    "intercept": np.asarray([wv[-1]], np.float32)})
