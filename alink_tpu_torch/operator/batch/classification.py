"""Classical classification breadth: NaiveBayes, KNN, FM, MLP, OneVsRest
(port of ``alink_tpu.operator.batch.classification``).

Capability parity with the reference (reference:
core/src/main/java/com/alibaba/alink/operator/batch/classification/
NaiveBayesTrainBatchOp.java + operator/common/classification/NaiveBayesModelData.java,
KnnTrainBatchOp.java + operator/common/similarity/NearestNeighborsMapper,
FmClassifierTrainBatchOp.java + operator/common/optim/FmOptimizer.java:39,
MultilayerPerceptronTrainBatchOp.java +
operator/common/classification/ann/FeedForwardTopology.java / FeedForwardTrainer.java,
OneVsRestTrainBatchOp.java / OneVsRestModelMapper).

On the session's device:
- NaiveBayes sufficient statistics are one-hot × feature products; scoring
  is the same three products against factors staged at load.
- KNN predict is a dense distance block and a stable sort per query row:
  ties go to the lower training row, as ``lax.top_k`` breaks them in the
  reference.
- FM/MLP ride the optimizer framework (``optim.optimize``) with
  flat-parameter objectives, as the reference routes both through its
  Optimizer/FmOptimizer stack.
- OneVsRest packs the k sub-models into ONE model table with per-model key
  prefixes so the standard .ak / Pipeline persistence works unchanged.

Each mapper stages its model's constants on its own ``device`` once, at
load, and scores feature blocks zero-padded up ``jitcache.bucket_rows``
(every score is row-wise, so the padded rows are sliced off and a row
scores the same whatever batch it came in), noting each signature with
``note_signature``. Under ``inferencePrecision`` the NB, FM and MLP
scorers run the policies of :mod:`...common.quant`.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from ...common import quant
from ...common.exceptions import AkIllegalArgumentException, AkIllegalDataException
from ...common.linalg import pairwise_sq_dists
from ...common.model import model_to_table, table_to_model
from ...common.mtable import AlinkTypes, MTable
from ...common.params import InValidator, MinValidator, ParamInfo
from ...mapper import (
    HasFeatureCols,
    HasPredictionCol,
    HasPredictionDetailCol,
    HasReservedCols,
    HasVectorCol,
    RichModelMapper,
    get_feature_block,
    merge_feature_params,
    resolve_feature_cols,
    sigmoid_np,
    softmax_np,
)
from ...optim import fm_obj, fm_pairwise, mlp_forward, mlp_obj, optimize
from .base import BatchOperator
from .utils import ModelMapBatchOp, ModelTrainOpMixin

# query rows per distance block of the KNN scorer: the (rows, n_train) fp32
# block and its sort stay within about 256 MiB
_KNN_BLOCK_BYTES = 256 * 1024 * 1024


def _encode_labels(y_raw) -> tuple:
    labels = sorted(set(np.asarray(y_raw).tolist()), key=lambda v: str(v))
    lab_to_idx = {v: i for i, v in enumerate(labels)}
    idx = np.asarray([lab_to_idx[v] for v in np.asarray(y_raw).tolist()], np.int32)
    return labels, idx


def _train_features(op, t: MTable, label_col: str):
    vec_col = op.get(HasVectorCol.VECTOR_COL)
    if vec_col:
        feature_cols = None
        X = t.to_numeric_block([vec_col], dtype=np.float32)
    else:
        feature_cols = resolve_feature_cols(t, op, exclude=[label_col])
        X = t.to_numeric_block(feature_cols, dtype=np.float32)
    return X, feature_cols


class _StagedScorer(RichModelMapper):
    """Shared device plumbing of the scorers: constants staged on the
    mapper's own device, feature blocks padded up the row bucket."""

    def _stage(self, *arrays):
        import torch

        from ...common.env import resolve_device

        self._device = resolve_device(self.device)
        return tuple(torch.as_tensor(np.asarray(a), device=self._device)
                     for a in arrays)

    def _features(self, t: MTable) -> np.ndarray:
        return get_feature_block(
            t, merge_feature_params(self.get_params(), self.meta),
            vector_size=self.meta["dim"],
        ).astype(np.float32, copy=False)

    def _padded(self, kernel_id: str, X: np.ndarray):
        """X on the device, zero-padded to its row bucket."""
        from ...common.jitcache import bucket_rows, note_signature
        from ...common.staging import stage_replicated

        Xd = stage_replicated(X, self._device,
                              pad_rows_to=bucket_rows(X.shape[0]))
        note_signature(kernel_id, [Xd])
        return Xd


# ---------------------------------------------------------------------------
# Naive Bayes
# ---------------------------------------------------------------------------

class NaiveBayesTrainBatchOp(ModelTrainOpMixin, BatchOperator, HasVectorCol,
                             HasFeatureCols):
    """(reference: operator/batch/classification/NaiveBayesTrainBatchOp.java —
    category/gaussian mixed features; here: modelType selects the likelihood)"""

    _min_inputs = 1
    _max_inputs = 1

    LABEL_COL = ParamInfo("labelCol", str, optional=False)
    MODEL_TYPE = ParamInfo(
        "modelType", str, default="GAUSSIAN",
        validator=InValidator("GAUSSIAN", "MULTINOMIAL", "BERNOULLI"),
    )
    SMOOTHING = ParamInfo("smoothing", float, default=1.0,
                          validator=MinValidator(0.0))

    def _static_meta_keys(self, in_schema):
        return {
            "modelName": "NaiveBayesModel",
            "labelType": in_schema.type_of(self.get(self.LABEL_COL)),
        }

    def _execute_impl(self, t: MTable) -> MTable:
        import torch

        from ...common.env import resolve_device

        label_col = self.get(self.LABEL_COL)
        X, feature_cols = _train_features(self, t, label_col)
        labels, y = _encode_labels(t.col(label_col))
        k, d = len(labels), X.shape[1]
        alpha = self.get(self.SMOOTHING)
        mtype = self.get(self.MODEL_TYPE)

        dev = resolve_device(self.env.device)
        Xd = torch.tensor(X, device=dev)    # a copy: X is read-only
        onehot = torch.nn.functional.one_hot(
            torch.as_tensor(y, dtype=torch.int64, device=dev), k).float()
        counts = onehot.sum(0)                            # per-class rows
        s1 = onehot.T @ Xd                                # (k, d) sums
        s2 = onehot.T @ (Xd * Xd)                         # (k, d) sq sums
        sb = onehot.T @ (Xd > 0).float()                  # (k, d) nnz
        counts, s1, s2, sb = (v.cpu().numpy() for v in (counts, s1, s2, sb))
        prior = np.log(counts / counts.sum())

        if mtype == "GAUSSIAN":
            mu = s1 / counts[:, None]
            var = s2 / counts[:, None] - mu * mu
            var = np.maximum(var, 1e-9) + alpha * 1e-9
            arrays = {"mu": mu.astype(np.float32), "var": var.astype(np.float32),
                      "prior": prior.astype(np.float32)}
        elif mtype == "MULTINOMIAL":
            theta = np.log((s1 + alpha) / (s1.sum(axis=1, keepdims=True) + alpha * d))
            arrays = {"theta": theta.astype(np.float32),
                      "prior": prior.astype(np.float32)}
        else:  # BERNOULLI
            p = (sb + alpha) / (counts[:, None] + 2.0 * alpha)
            arrays = {"logp": np.log(p).astype(np.float32),
                      "log1mp": np.log1p(-p).astype(np.float32),
                      "prior": prior.astype(np.float32)}

        meta = {
            "modelName": "NaiveBayesModel",
            "modelType": mtype,
            "vectorCol": self.get(HasVectorCol.VECTOR_COL),
            "featureCols": feature_cols,
            "labelCol": label_col,
            "labelType": t.schema.type_of(label_col),
            "labels": labels,
            "dim": int(d),
        }
        return model_to_table(meta, arrays)


def nb_score(mtype: str, X, a, b, c):
    """Naive-Bayes scores from the model's (a, b, c) factors: the three
    forms all reduce to products against them."""
    if mtype == "GAUSSIAN":
        return -(X * X) @ a + X @ b + c
    if mtype == "MULTINOMIAL":
        return X @ a + c
    return (X > 0).float() @ a + c     # BERNOULLI


class NaiveBayesModelMapper(_StagedScorer):
    """(reference: operator/common/classification/NaiveBayesModelMapper.java)"""

    def load_model(self, model: MTable):
        self.meta, arrays = table_to_model(model)
        mtype = self.meta["modelType"]

        if mtype == "GAUSSIAN":
            mu, var, prior = arrays["mu"], arrays["var"], arrays["prior"]
            # log N(x|mu,var) summed over features, as three products:
            # -0.5·x²·(1/var) + x·(mu/var) − 0.5·(mu²/var + log 2πvar)
            a = (1.0 / (2.0 * var)).T
            b = (mu / var).T
            c = (-0.5 * (mu * mu / var + np.log(2.0 * np.pi * var)).sum(1)
                 + prior)
        elif mtype == "MULTINOMIAL":
            theta, prior = arrays["theta"], arrays["prior"]
            a, b, c = theta.T, np.zeros((1, 1), np.float32), prior
        else:  # BERNOULLI
            logp, log1mp, prior = (arrays["logp"], arrays["log1mp"],
                                   arrays["prior"])
            a = (logp - log1mp).T
            b = np.zeros((1, 1), np.float32)
            c = log1mp.sum(1) + prior

        self._mtype = mtype
        self._policy = quant.policy_of(self.get_params())
        site = quant.site_of(self.get_params(), "naivebayes")
        self._site_x, self._site_xx = site + ".x", site + ".xx"
        a = np.asarray(a, np.float32)
        b = np.asarray(b, np.float32)
        c = np.asarray(c, np.float32)
        if self._policy == quant.BF16:
            a, b, c = (quant.bf16_round(v) for v in (a, b, c))
        # staged on the device ONCE: no per-predict re-transfer
        self._score_factors = self._stage(a, b, c)
        if self._policy == quant.INT8:
            aq, sa = quant.quantize_per_channel(a)
            bq, sb = quant.quantize_per_channel(b)
            self._q_factors = self._stage(
                aq, bq, c, np.asarray(sa, np.float32),
                np.asarray(sb, np.float32))
        return self

    def _pred_type(self) -> str:
        return self.meta.get("labelType", AlinkTypes.STRING)

    def predict_proba_block(self, t: MTable):
        import torch

        X = self._features(t)
        if quant.capturing():
            quant.observe(self._site_x, X)
            if self._mtype == "GAUSSIAN":
                quant.observe(self._site_xx, X * X)
        if self._policy == quant.BF16:
            X = quant.bf16_round(X)
        n = X.shape[0]
        Xd = self._padded("naivebayes.score", X)
        if self._policy == quant.INT8:
            params = self.get_params()
            sx = (quant.calib_scale(params, self._site_x)
                  if self._mtype != "BERNOULLI" else 1.0)
            sxx = (quant.calib_scale(params, self._site_xx)
                   if self._mtype == "GAUSSIAN" else 1.0)
            scales = [torch.tensor(v, dtype=torch.float32,
                                   device=self._device) for v in (sxx, sx)]
            s = quant.int8_nb_score(self._mtype, Xd, *self._q_factors,
                                    *scales)
        else:
            s = nb_score(self._mtype, Xd, *self._score_factors)
        return softmax_np(s[:n].cpu().numpy())

    def predict_block(self, t: MTable):
        return self._classification_result(self.predict_proba_block(t))


class NaiveBayesPredictBatchOp(ModelMapBatchOp, HasPredictionCol,
                               HasPredictionDetailCol, HasReservedCols,
                               HasVectorCol, HasFeatureCols):
    mapper_cls = NaiveBayesModelMapper


# ---------------------------------------------------------------------------
# KNN
# ---------------------------------------------------------------------------

class KnnTrainBatchOp(ModelTrainOpMixin, BatchOperator, HasVectorCol,
                      HasFeatureCols):
    """Stores the training block — predict does the work (reference:
    operator/batch/classification/KnnTrainBatchOp.java builds the same
    "model = data" table via NearestNeighbor converters)."""

    _min_inputs = 1
    _max_inputs = 1

    LABEL_COL = ParamInfo("labelCol", str, optional=False)
    DISTANCE_TYPE = ParamInfo(
        "distanceType", str, default="EUCLIDEAN",
        validator=InValidator("EUCLIDEAN", "COSINE"),
    )

    def _static_meta_keys(self, in_schema):
        return {
            "modelName": "KnnModel",
            "labelType": in_schema.type_of(self.get(self.LABEL_COL)),
        }

    def _execute_impl(self, t: MTable) -> MTable:
        label_col = self.get(self.LABEL_COL)
        X, feature_cols = _train_features(self, t, label_col)
        labels, y = _encode_labels(t.col(label_col))
        meta = {
            "modelName": "KnnModel",
            "distanceType": self.get(self.DISTANCE_TYPE),
            "vectorCol": self.get(HasVectorCol.VECTOR_COL),
            "featureCols": feature_cols,
            "labelCol": label_col,
            "labelType": t.schema.type_of(label_col),
            "labels": labels,
            "dim": int(X.shape[1]),
        }
        return model_to_table(meta, {"X": X.astype(np.float32),
                                     "y": y.astype(np.int32)})


def knn_neighbors(Q, X, k: int, cosine: bool):
    """The k nearest training rows of each query row: (distances, indices),
    nearest first. A stable sort of each distance row, so equal distances
    go to the lower training row, as ``lax.top_k`` orders them."""
    import torch

    if cosine:
        Qn = Q / torch.clamp(torch.linalg.vector_norm(Q, dim=1, keepdim=True),
                             min=1e-12)
        Xn = X / torch.clamp(torch.linalg.vector_norm(X, dim=1, keepdim=True),
                             min=1e-12)
        d = 1.0 - Qn @ Xn.T
    else:
        d = pairwise_sq_dists(Q, X)
    dist, idx = torch.sort(d, dim=1, stable=True)
    return dist[:, :k], idx[:, :k]


def _knn_blocks(Q, X, k: int, cosine: bool):
    """:func:`knn_neighbors` over query blocks of bounded size."""
    import torch

    rows = max(1, _KNN_BLOCK_BYTES // max(8 * X.shape[0], 1))
    parts = [knn_neighbors(Q[i:i + rows], X, k, cosine)
             for i in range(0, Q.shape[0], rows)]
    return (torch.cat([p[0] for p in parts]),
            torch.cat([p[1] for p in parts]))


class KnnModelMapper(_StagedScorer):
    """Blocked brute-force top-k on the device (reference:
    operator/common/classification/KnnMapper.java — per-row priority queue)."""

    K = ParamInfo("k", int, default=10, validator=MinValidator(1))

    def load_model(self, model: MTable):
        self.meta, arrays = table_to_model(model)
        self.X_train = arrays["X"]
        self.y_train = arrays["y"]
        self._k = int(min(self.get(self.K), self.X_train.shape[0]))
        self._cosine = self.meta.get("distanceType") == "COSINE"
        self._train_dev = self._stage(self.X_train,
                                      self.y_train.astype(np.int64))
        return self

    def _pred_type(self) -> str:
        return self.meta.get("labelType", AlinkTypes.STRING)

    def predict_proba_block(self, t: MTable):
        import torch

        Q = self._features(t)
        n = Q.shape[0]
        # per-query top-k is row-wise over Q: bucketing is bit-parity safe
        Qd = self._padded("knn.classify", Q)
        X, y = self._train_dev
        _, idx = _knn_blocks(Qd, X, self._k, self._cosine)
        votes = torch.nn.functional.one_hot(
            y[idx], len(self.meta["labels"])).sum(1)[:n]
        votes = votes.cpu().numpy().astype(np.float32)
        return votes / votes.sum(axis=1, keepdims=True)

    def predict_block(self, t: MTable):
        return self._classification_result(self.predict_proba_block(t))


class KnnPredictBatchOp(ModelMapBatchOp, HasPredictionCol,
                        HasPredictionDetailCol, HasReservedCols,
                        HasVectorCol, HasFeatureCols):
    mapper_cls = KnnModelMapper
    K = KnnModelMapper.K


class KnnRegTrainBatchOp(ModelTrainOpMixin, BatchOperator, HasVectorCol,
                         HasFeatureCols):
    """KNN regression: the model is the training block with float targets
    (reference: operator/batch/regression/KnnRegTrainBatchOp.java)."""

    _min_inputs = 1
    _max_inputs = 1

    LABEL_COL = ParamInfo("labelCol", str, optional=False)
    DISTANCE_TYPE = KnnTrainBatchOp.DISTANCE_TYPE

    def _static_meta_keys(self, in_schema):
        return {"modelName": "KnnRegModel"}

    def _execute_impl(self, t: MTable) -> MTable:
        label_col = self.get(self.LABEL_COL)
        X, feature_cols = _train_features(self, t, label_col)
        y = np.asarray(t.col(label_col), np.float32)
        meta = {
            "modelName": "KnnRegModel",
            "distanceType": self.get(self.DISTANCE_TYPE),
            "vectorCol": self.get(HasVectorCol.VECTOR_COL),
            "featureCols": feature_cols,
            "labelCol": label_col,
            "dim": int(X.shape[1]),
        }
        return model_to_table(meta, {"X": X.astype(np.float32),
                                     "y": y})


class KnnRegModelMapper(_StagedScorer):
    """Inverse-distance-weighted mean of the k nearest targets."""

    K = ParamInfo("k", int, default=10, validator=MinValidator(1))

    def load_model(self, model: MTable):
        self.meta, arrays = table_to_model(model)
        self.X_train = arrays["X"]
        self.y_train = arrays["y"].astype(np.float32)
        self._k = int(min(self.get(self.K), self.X_train.shape[0]))
        self._cosine = self.meta.get("distanceType") == "COSINE"
        self._train_dev = self._stage(self.X_train, self.y_train)
        return self

    def _pred_type(self) -> str:
        return AlinkTypes.DOUBLE

    def predict_block(self, t: MTable):
        import torch

        Q = self._features(t)
        n = Q.shape[0]
        Qd = self._padded("knn.regress", Q)
        X, y = self._train_dev
        dist, idx = _knn_blocks(Qd, X, self._k, self._cosine)
        w = 1.0 / (torch.sqrt(torch.clamp(dist, min=0.0)) + 1e-6)
        pred = ((w * y[idx]).sum(1) / w.sum(1))[:n].cpu().numpy()
        return pred.astype(np.float64), AlinkTypes.DOUBLE, None


class KnnRegPredictBatchOp(ModelMapBatchOp, HasPredictionCol,
                           HasReservedCols, HasVectorCol, HasFeatureCols):
    mapper_cls = KnnRegModelMapper
    K = KnnRegModelMapper.K


# ---------------------------------------------------------------------------
# Factorization machines
# ---------------------------------------------------------------------------

class BaseFmTrainBatchOp(ModelTrainOpMixin, BatchOperator, HasVectorCol,
                         HasFeatureCols):
    """(reference: operator/batch/classification/FmClassifierTrainBatchOp.java,
    regression/FmRegressorTrainBatchOp.java → common/fm/BaseFmTrainBatchOp.java
    with FmOptimizer.java:39,80-84 adaptive SGD)"""

    _min_inputs = 1
    _max_inputs = 1

    fm_task: str = None  # binary | regression

    LABEL_COL = ParamInfo("labelCol", str, optional=False)
    NUM_FACTOR = ParamInfo("numFactor", int, default=10,
                           validator=MinValidator(1))
    MAX_ITER = ParamInfo("maxIter", int, default=100, validator=MinValidator(1))
    EPSILON = ParamInfo("epsilon", float, default=1e-6)
    LAMBDA_0 = ParamInfo("lambda0", float, default=0.0)
    LAMBDA_1 = ParamInfo("lambda1", float, default=0.0)
    LAMBDA_2 = ParamInfo("lambda2", float, default=0.0)
    INIT_STDEV = ParamInfo("initStdev", float, default=0.05)
    RANDOM_SEED = ParamInfo("randomSeed", int, default=0, aliases=("seed",))
    LEARN_RATE = ParamInfo("learnRate", float, default=0.1)

    def _static_meta_keys(self, in_schema):
        return {
            "modelName": "FmModel",
            "fmTask": self.fm_task,
            "labelType": in_schema.type_of(self.get(self.LABEL_COL)),
        }

    def _execute_impl(self, t: MTable) -> MTable:
        label_col = self.get(self.LABEL_COL)
        X, feature_cols = _train_features(self, t, label_col)
        n, d = X.shape
        kf = self.get(self.NUM_FACTOR)
        labels: Optional[List] = None
        if self.fm_task == "binary":
            labels, idx = _encode_labels(t.col(label_col))
            if len(labels) != 2:
                raise AkIllegalDataException(
                    f"FM classifier needs exactly 2 label values, got {len(labels)}"
                )
            y = np.where(idx == 0, 1.0, -1.0).astype(np.float32)
        else:
            y = np.asarray(t.col(label_col), np.float32)

        obj = fm_obj(d, kf, self.fm_task)
        rng = np.random.default_rng(self.get(self.RANDOM_SEED))
        w0 = np.zeros(obj.num_params, np.float32)
        # V must start non-zero: the pairwise term's gradient vanishes at V=0
        w0[1 + d:] = rng.normal(0.0, self.get(self.INIT_STDEV), d * kf)
        # per-block L2 as in the reference FmOptimizer: lambda0 on the
        # intercept, lambda1 on the linear weights, lambda2 on the factors
        l2_vec = np.concatenate([
            [self.get(self.LAMBDA_0)],
            np.full(d, self.get(self.LAMBDA_1)),
            np.full(d * kf, self.get(self.LAMBDA_2)),
        ]).astype(np.float32)
        res = optimize(
            obj, X, y, w0=w0,
            device=self.env.device,
            method="lbfgs",
            max_iter=self.get(self.MAX_ITER),
            l2=l2_vec,
            tol=self.get(self.EPSILON),
            learning_rate=self.get(self.LEARN_RATE),
        )
        w = res.weights
        meta = {
            "modelName": "FmModel",
            "fmTask": self.fm_task,
            "numFactor": kf,
            "vectorCol": self.get(HasVectorCol.VECTOR_COL),
            "featureCols": feature_cols,
            "labelCol": label_col,
            "labelType": t.schema.type_of(label_col),
            "labels": labels,
            "dim": int(d),
            "loss": res.loss,
            "numIters": res.num_iters,
        }
        arrays = {
            "w0": np.asarray([w[0]], np.float32),
            "w": np.asarray(w[1:1 + d], np.float32),
            "V": np.asarray(w[1 + d:], np.float32).reshape(d, kf),
        }
        return model_to_table(meta, arrays)


class FmClassifierTrainBatchOp(BaseFmTrainBatchOp):
    fm_task = "binary"


class FmRegressorTrainBatchOp(BaseFmTrainBatchOp):
    fm_task = "regression"


class FmModelMapper(_StagedScorer):
    """(reference: operator/common/fm/FmModelMapper.java)"""

    def load_model(self, model: MTable):
        self.meta, arrays = table_to_model(model)
        self._policy = quant.policy_of(self.get_params())
        self._site = quant.site_of(self.get_params(), "fm") + ".x"
        w0 = arrays["w0"].astype(np.float32)
        w = arrays["w"].astype(np.float32)
        V = arrays["V"].astype(np.float32)
        if self._policy == quant.BF16:
            w0, w, V = (quant.bf16_round(v) for v in (w0, w, V))
        self._fm_params = self._stage(w0, w, V)
        if self._policy == quant.INT8:
            wq, sw = quant.quantize_per_channel(w)
            Vq, sv = quant.quantize_per_channel(V)
            self._fm_q = self._stage(
                w0, wq, Vq, np.asarray(sw, np.float32),
                np.asarray(sv, np.float32))
        return self

    def _pred_type(self) -> str:
        if self.meta["fmTask"] == "regression":
            return AlinkTypes.DOUBLE
        return self.meta.get("labelType", AlinkTypes.STRING)

    def _scores(self, t: MTable) -> np.ndarray:
        import torch

        X = self._features(t)
        if quant.capturing():
            quant.observe(self._site, X)
        if self._policy == quant.BF16:
            X = quant.bf16_round(X)
        n = X.shape[0]
        Xd = self._padded("fm.score", X)
        if self._policy == quant.INT8:
            sx = torch.tensor(quant.calib_scale(self.get_params(), self._site),
                              dtype=torch.float32, device=self._device)
            s = quant.int8_fm_score(Xd, *self._fm_q, sx)
        else:
            w0, w, V = self._fm_params
            s = w0[0] + Xd @ w + fm_pairwise(Xd, V)
        return s[:n].cpu().numpy()

    def predict_proba_block(self, t: MTable):
        if self.meta["fmTask"] == "regression":
            return None
        prob_pos = sigmoid_np(self._scores(t))
        return np.stack([prob_pos, 1 - prob_pos], 1)

    def predict_block(self, t: MTable):
        if self.meta["fmTask"] == "regression":
            return self._scores(t).astype(np.float64), AlinkTypes.DOUBLE, None
        return self._classification_result(self.predict_proba_block(t))


class FmPredictBatchOp(ModelMapBatchOp, HasPredictionCol,
                       HasPredictionDetailCol, HasReservedCols,
                       HasVectorCol, HasFeatureCols):
    mapper_cls = FmModelMapper


class FmClassifierPredictBatchOp(FmPredictBatchOp):
    pass


class FmRegressorPredictBatchOp(FmPredictBatchOp):
    pass


# ---------------------------------------------------------------------------
# Multilayer perceptron
# ---------------------------------------------------------------------------

class MultilayerPerceptronTrainBatchOp(ModelTrainOpMixin, BatchOperator,
                                       HasVectorCol, HasFeatureCols):
    """(reference: operator/batch/classification/
    MultilayerPerceptronTrainBatchOp.java → FeedForwardTrainer over the
    distributed optimizer framework)"""

    _min_inputs = 1
    _max_inputs = 1

    LABEL_COL = ParamInfo("labelCol", str, optional=False)
    LAYERS = ParamInfo("layers", list, desc="hidden layer sizes", default=[16])
    MAX_ITER = ParamInfo("maxIter", int, default=100, validator=MinValidator(1))
    EPSILON = ParamInfo("epsilon", float, default=1e-6)
    L_2 = ParamInfo("l2", float, default=0.0, validator=MinValidator(0.0))
    RANDOM_SEED = ParamInfo("randomSeed", int, default=0, aliases=("seed",))

    def _static_meta_keys(self, in_schema):
        return {
            "modelName": "MlpModel",
            "labelType": in_schema.type_of(self.get(self.LABEL_COL)),
        }

    def _execute_impl(self, t: MTable) -> MTable:
        label_col = self.get(self.LABEL_COL)
        X, feature_cols = _train_features(self, t, label_col)
        labels, y = _encode_labels(t.col(label_col))
        d, k = X.shape[1], len(labels)
        sizes = [d] + [int(h) for h in self.get(self.LAYERS)] + [k]
        obj = mlp_obj(sizes)
        rng = np.random.default_rng(self.get(self.RANDOM_SEED))
        # Glorot-ish init per layer, biases zero
        w0 = np.zeros(obj.num_params, np.float32)
        off = 0
        for i in range(len(sizes) - 1):
            fan_in, fan_out = sizes[i], sizes[i + 1]
            w0[off:off + fan_in * fan_out] = rng.normal(
                0.0, np.sqrt(2.0 / (fan_in + fan_out)), fan_in * fan_out
            )
            off += fan_in * fan_out + fan_out
        res = optimize(
            obj, X, y.astype(np.float32), w0=w0,
            device=self.env.device, method="lbfgs",
            max_iter=self.get(self.MAX_ITER),
            l2=self.get(self.L_2), tol=self.get(self.EPSILON),
        )
        meta = {
            "modelName": "MlpModel",
            "layerSizes": sizes,
            "vectorCol": self.get(HasVectorCol.VECTOR_COL),
            "featureCols": feature_cols,
            "labelCol": label_col,
            "labelType": t.schema.type_of(label_col),
            "labels": labels,
            "dim": int(d),
            "loss": res.loss,
            "numIters": res.num_iters,
        }
        return model_to_table(meta, {"weights": res.weights.astype(np.float32)})


def mlp_int8_layers(sizes, w: np.ndarray) -> list:
    """The flat L-BFGS weight vector unpacked per ``mlp_forward``'s layout
    ((fan_in, fan_out) matrix then (fan_out,) bias per layer), each matrix
    quantized per output channel: [Wq, scale, b] per layer."""
    packed = []
    off = 0
    for fi, fo in zip(sizes[:-1], sizes[1:]):
        W = w[off:off + fi * fo].reshape(fi, fo)
        off += fi * fo
        b = w[off:off + fo]
        off += fo
        Wq, s = quant.quantize_per_channel(W)
        packed += [Wq, np.asarray(s, np.float32), b]
    return packed


class MlpModelMapper(_StagedScorer):
    """(reference: operator/common/classification/ann/MlpcModelMapper.java)"""

    def load_model(self, model: MTable):
        self.meta, arrays = table_to_model(model)
        self._policy = quant.policy_of(self.get_params())
        self._site = quant.site_of(self.get_params(), "mlp") + ".x"
        w = arrays["weights"].astype(np.float32)
        if self._policy == quant.BF16:
            w = quant.bf16_round(w)
        (self._mlp_w,) = self._stage(w)
        self._sizes = tuple(int(s) for s in self.meta["layerSizes"])
        if self._policy == quant.INT8:
            self._mlp_q = self._stage(*mlp_int8_layers(self._sizes, w))
        return self

    def _pred_type(self) -> str:
        return self.meta.get("labelType", AlinkTypes.STRING)

    def predict_proba_block(self, t: MTable):
        X = self._features(t)
        if quant.capturing():
            quant.observe(self._site, X)
        if self._policy == quant.BF16:
            X = quant.bf16_round(X)
        n = X.shape[0]
        Xd = self._padded("mlp.score", X)
        if self._policy == quant.INT8:
            logits = quant.int8_mlp_score(self._sizes, Xd, *self._mlp_q)
        else:
            logits = mlp_forward(self._sizes, self._mlp_w, Xd)
        return softmax_np(logits[:n].cpu().numpy())

    def predict_block(self, t: MTable):
        return self._classification_result(self.predict_proba_block(t))


class MultilayerPerceptronPredictBatchOp(ModelMapBatchOp, HasPredictionCol,
                                         HasPredictionDetailCol,
                                         HasReservedCols, HasVectorCol,
                                         HasFeatureCols):
    mapper_cls = MlpModelMapper


# ---------------------------------------------------------------------------
# One-vs-rest meta estimator
# ---------------------------------------------------------------------------

_OVR_POS, _OVR_NEG = "1", "2"  # "1" sorts first → positive class by convention


class OneVsRestTrainBatchOp(ModelTrainOpMixin, BatchOperator):
    """Trains one binary classifier per label value (reference:
    operator/batch/classification/OneVsRestTrainBatchOp.java).

    ``classifier`` is a prototype binary train op (e.g. a configured
    LogisticRegressionTrainBatchOp); it is cloned per class with the label
    column rewritten to a {pos, rest} indicator."""

    _min_inputs = 1
    _max_inputs = 1

    LABEL_COL = ParamInfo("labelCol", str)

    def __init__(self, classifier=None, params=None, **kwargs):
        super().__init__(params, **kwargs)
        if classifier is None:
            raise AkIllegalArgumentException(
                "OneVsRestTrainBatchOp needs a prototype binary classifier op"
            )
        self.classifier = classifier

    def _label_col(self):
        return self.get(self.LABEL_COL) or self.classifier.get_params().get("labelCol")

    def _static_meta_keys(self, in_schema):
        return {
            "modelName": "OneVsRestModel",
            "labelType": in_schema.type_of(self._label_col()),
        }

    def _execute_impl(self, t: MTable) -> MTable:
        from ..base import TableSourceOp
        from ...common.mtable import TableSchema

        label_col = self._label_col()
        labels, idx = _encode_labels(t.col(label_col))
        if len(labels) < 3:
            raise AkIllegalDataException(
                f"OneVsRest expects ≥3 label values, got {len(labels)}"
            )
        schema = TableSchema(
            list(t.schema.names),
            [AlinkTypes.STRING if n == label_col else t.schema.type_of(n)
             for n in t.schema.names],
        )
        sub_metas, all_arrays = [], {}
        for ci in range(len(labels)):
            relabel = np.where(idx == ci, _OVR_POS, _OVR_NEG).astype(object)
            cols = {n: t.col(n) for n in t.names}
            cols[label_col] = relabel
            sub_t = MTable(cols, schema)
            trainer = type(self.classifier)(self.classifier.get_params().clone())
            trainer.set("labelCol", label_col)
            model = trainer.link_from(TableSourceOp(sub_t))._evaluate()
            sub_meta, sub_arrays = table_to_model(model)
            sub_metas.append(sub_meta)
            for key, arr in sub_arrays.items():
                all_arrays[f"m{ci}:{key}"] = np.asarray(arr)
        meta = {
            "modelName": "OneVsRestModel",
            "labelCol": label_col,
            "labelType": t.schema.type_of(label_col),
            "labels": labels,
            "numClasses": len(labels),
            "subMetas": sub_metas,
            "mapperClass": getattr(
                type(self.classifier), "paired_mapper_cls_name", None
            ) or _fail_no_mapper(type(self.classifier).__name__),
        }
        return model_to_table(meta, all_arrays)


class OneVsRestModelMapper(RichModelMapper):
    """(reference: operator/common/classification/OneVsRestModelMapper.java —
    per-class probability from each sub-model's detail, argmax wins)"""

    def load_model(self, model: MTable):
        self.meta, arrays = table_to_model(model)
        mapper_cls = _resolve_mapper(self.meta["mapperClass"])
        self.sub_mappers = []
        for ci in range(self.meta["numClasses"]):
            prefix = f"m{ci}:"
            sub_arrays = {
                k[len(prefix):]: v for k, v in arrays.items()
                if k.startswith(prefix)
            }
            sub_model = model_to_table(self.meta["subMetas"][ci], sub_arrays)
            sub = mapper_cls(self.model_schema, self.data_schema,
                             self.get_params().clone())
            sub.device = self.device
            sub.load_model(sub_model)
            self.sub_mappers.append(sub)
        return self

    def _pred_type(self) -> str:
        return self.meta.get("labelType", AlinkTypes.STRING)

    def predict_proba_block(self, t: MTable):
        probs = []
        for sub in self.sub_mappers:
            sub_p = sub.predict_proba_block(t)
            pos = sub.meta["labels"].index(_OVR_POS)
            probs.append(np.asarray(sub_p[:, pos], np.float64))
        P = np.stack(probs, axis=1)  # (n, k) one-vs-rest positive probs
        return P / np.maximum(P.sum(axis=1, keepdims=True), 1e-12)

    def predict_block(self, t: MTable):
        return self._classification_result(self.predict_proba_block(t))


class OneVsRestPredictBatchOp(ModelMapBatchOp, HasPredictionCol,
                              HasPredictionDetailCol, HasReservedCols,
                              HasVectorCol, HasFeatureCols):
    mapper_cls = OneVsRestModelMapper


def _resolve_mapper(name: str):
    from .linear import LinearModelMapper

    base = {
        "LinearModelMapper": LinearModelMapper,
        "NaiveBayesModelMapper": NaiveBayesModelMapper,
        "FmModelMapper": FmModelMapper,
        "MlpModelMapper": MlpModelMapper,
        "KnnModelMapper": KnnModelMapper,
    }
    if name not in base:
        raise AkIllegalArgumentException(f"unknown OneVsRest base mapper {name}")
    return base[name]


def _fail_no_mapper(name: str):
    raise AkIllegalArgumentException(
        f"{name} declares no paired_mapper_cls_name; OneVsRest cannot serve it"
    )


NaiveBayesTrainBatchOp.paired_mapper_cls_name = "NaiveBayesModelMapper"
KnnTrainBatchOp.paired_mapper_cls_name = "KnnModelMapper"
BaseFmTrainBatchOp.paired_mapper_cls_name = "FmModelMapper"
MultilayerPerceptronTrainBatchOp.paired_mapper_cls_name = "MlpModelMapper"
