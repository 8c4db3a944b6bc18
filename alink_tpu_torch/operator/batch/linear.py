"""Linear models: LR / LinearSVM / Linear-Ridge-Lasso regression / SVR /
Softmax (port of ``alink_tpu.operator.batch.linear``).

Capability parity with the reference (reference:
core/src/main/java/com/alibaba/alink/operator/common/linear/
BaseLinearModelTrainBatchOp.java:126 (optimize at :758-812), LinearModelMapper.java,
operator/batch/classification/LogisticRegressionTrainBatchOp.java,
LinearSvmTrainBatchOp.java, operator/batch/regression/LinearRegTrainBatchOp.java,
RidgeRegTrainBatchOp.java, LassoRegTrainBatchOp.java,
operator/batch/classification/SoftmaxTrainBatchOp.java + common/linear/
SoftmaxModelMapper.java).

Training runs the optimizer framework (optim/optimizers.py) on the session's
device; standardization statistics are folded back into the stored weights
exactly as the reference does, so the model predicts on raw features and a
model table written by either package predicts the same in the other.
Scoring is one product on the device per block (chunked for big blocks),
under the stamped serving policy (:mod:`...common.quant`, see
:class:`LinearModelMapper`).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from ...common.exceptions import AkIllegalDataException
from ...common.model import model_to_table, table_to_model
from ...common.mtable import AlinkTypes, MTable
from ...common.params import InValidator, MinValidator, ParamInfo
from ...common import quant
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
from ...optim import (
    hinge_obj,
    logistic_obj,
    optimize,
    softmax_obj,
    squared_obj,
    svr_obj,
)
from .base import BatchOperator
from .utils import ModelMapBatchOp, ModelTrainOpMixin


class HasLinearTrainParams(HasVectorCol, HasFeatureCols):
    LABEL_COL = ParamInfo("labelCol", str, optional=False)
    WEIGHT_COL = ParamInfo("weightCol", str)
    MAX_ITER = ParamInfo("maxIter", int, default=100, validator=MinValidator(1))
    EPSILON = ParamInfo("epsilon", float, default=1e-6)
    L_1 = ParamInfo("l1", float, default=0.0, validator=MinValidator(0.0))
    L_2 = ParamInfo("l2", float, default=0.0, validator=MinValidator(0.0))
    WITH_INTERCEPT = ParamInfo("withIntercept", bool, default=True)
    STANDARDIZATION = ParamInfo("standardization", bool, default=True)
    OPTIM_METHOD = ParamInfo(
        "optimMethod", str, default="lbfgs",
        validator=InValidator("lbfgs", "owlqn", "gd", "sgd", "newton"),
    )


def _labels_of(col: np.ndarray) -> List:
    vals = sorted(set(col.tolist()), key=lambda v: str(v))
    return vals


class BaseLinearModelTrainBatchOp(ModelTrainOpMixin, BatchOperator,
                                  HasLinearTrainParams):
    """Shared train flow: assemble features → standardize → optimize →
    de-standardize weights → model table."""

    _min_inputs = 1
    _max_inputs = 1

    linear_model_type: str = None  # LR | SVM | LinearReg | Softmax
    paired_mapper_cls_name = "LinearModelMapper"  # OneVsRest serving hook

    def _static_meta_keys(self, in_schema):
        return {
            "modelName": "LinearModel",
            "linearModelType": self.linear_model_type,
            "labelType": in_schema.type_of(self.get(self.LABEL_COL)),
        }

    # Ridge/Lasso override these to alias their `lambda` param without
    # mutating persistent op state between executions
    def _effective_l1(self) -> float:
        return self.get(self.L_1)

    def _effective_l2(self) -> float:
        return self.get(self.L_2)

    def _execute_sparse(self, t: MTable, parsed, label_col: str,
                        weight_col: Optional[str]) -> MTable:
        """High-dimensional sparse training: features stay an ELL SparseBlock
        end to end (SURVEY §7 hard-part #2 — the HugeSparseVector capability).
        Standardization is skipped (it would destroy sparsity; the reference
        treats sparse input the same way)."""
        from ...common.linalg import to_sparse_block

        intercept = self.get(self.WITH_INTERCEPT)
        X, d_raw = to_sparse_block(parsed, append_intercept=intercept)
        d = d_raw + (1 if intercept else 0)
        y_raw = t.col(label_col)
        is_classif = self.linear_model_type in ("LR", "SVM", "Softmax")
        labels: Optional[List] = None
        if is_classif:
            labels = _labels_of(np.asarray(y_raw))
            if self.linear_model_type in ("LR", "SVM"):
                if len(labels) != 2:
                    raise AkIllegalDataException(
                        f"{self.linear_model_type} needs exactly 2 label "
                        f"values, got {len(labels)}")
                y = np.where(np.asarray(y_raw) == labels[0], 1.0, -1.0) \
                    .astype(np.float32)
                num_classes = 2
            else:
                lab_to_idx = {v: i for i, v in enumerate(labels)}
                y = np.asarray([lab_to_idx[v] for v in y_raw], np.float32)
                num_classes = len(labels)
        else:
            y = np.asarray(y_raw, np.float32)
            num_classes = 1
        sample_w = (np.asarray(t.col(weight_col), np.float32)
                    if weight_col else None)
        obj = self._objective(d, num_classes)
        res = self._solve(obj, X, y, sample_w)
        if self.linear_model_type == "Softmax":
            W = res.weights.reshape(d, num_classes)
            arrays = {
                "weights": W[:d_raw].astype(np.float32),
                "intercept": (W[d_raw] if intercept
                              else np.zeros(num_classes)).astype(np.float32)}
        else:
            w = res.weights
            arrays = {
                "weights": w[:d_raw].astype(np.float32),
                "intercept": np.asarray(
                    [w[d_raw] if intercept else 0.0], np.float32)}
        meta = {
            "modelName": "LinearModel",
            "linearModelType": self.linear_model_type,
            "vectorCol": self.get(HasVectorCol.VECTOR_COL),
            "featureCols": None,
            "labelCol": label_col,
            "labelType": t.schema.type_of(label_col),
            "labels": labels,
            "hasIntercept": bool(intercept),
            "dim": int(d_raw),
            "loss": res.loss,
            "gradNorm": res.grad_norm,
            "numIters": res.num_iters,
        }
        return model_to_table(meta, arrays)

    def _solve(self, obj, X, y, sample_w):
        """Solver hook — the Constrained* variants override this to route
        through the constrained optimizers (optim/constrained.py)."""
        return optimize(
            obj, X, y, sample_weights=sample_w,
            device=self.env.device,
            method=self.get(self.OPTIM_METHOD),
            max_iter=self.get(self.MAX_ITER),
            l1=self._effective_l1(), l2=self._effective_l2(),
            tol=self.get(self.EPSILON))

    def _objective(self, dim: int, num_classes: int):
        t = self.linear_model_type
        if t == "LR":
            return logistic_obj(dim)
        if t == "SVM":
            return hinge_obj(dim)
        if t == "LinearReg":
            return squared_obj(dim)
        if t == "SVR":
            return svr_obj(dim, float(self.get(LinearSvrTrainBatchOp.SVR_EPSILON)))
        if t == "Softmax":
            return softmax_obj(dim, num_classes)
        raise AkIllegalDataException(f"unknown linear model type {t}")

    def _execute_impl(self, t: MTable) -> MTable:
        label_col = self.get(self.LABEL_COL)
        weight_col = self.get(self.WEIGHT_COL)
        vec_col = self.get(HasVectorCol.VECTOR_COL)
        if vec_col:
            from ...common.linalg import SparseVector, parse_vector

            col = t.col(vec_col)
            # probe the first cell before parsing the whole column — dense
            # input must not pay a full throwaway parse
            if len(col) and isinstance(parse_vector(col[0]), SparseVector):
                parsed = [parse_vector(v) for v in col]
                if all(isinstance(p, SparseVector) for p in parsed):
                    # huge-sparse path: ELL block, no densification
                    return self._execute_sparse(t, parsed, label_col,
                                                weight_col)
            feature_cols = None
            X = t.to_numeric_block([vec_col], dtype=np.float32)
        else:
            feature_cols = resolve_feature_cols(
                t, self, exclude=[label_col, weight_col]
            )
            X = t.to_numeric_block(feature_cols, dtype=np.float32)
        n, d_raw = X.shape
        y_raw = t.col(label_col)
        is_classif = self.linear_model_type in ("LR", "SVM", "Softmax")  # SVR/LinearReg: numeric y
        labels: Optional[List] = None
        if is_classif:
            labels = _labels_of(y_raw)
            if self.linear_model_type in ("LR", "SVM"):
                if len(labels) != 2:
                    raise AkIllegalDataException(
                        f"{self.linear_model_type} needs exactly 2 label values, "
                        f"got {len(labels)}"
                    )
                # labels[0] is the positive class (+1), matching the reference's
                # convention of orderly label mapping
                y = np.where(np.asarray(y_raw) == labels[0], 1.0, -1.0).astype(
                    np.float32
                )
                num_classes = 2
            else:
                lab_to_idx = {v: i for i, v in enumerate(labels)}
                y = np.asarray([lab_to_idx[v] for v in y_raw], np.float32)
                num_classes = len(labels)
        else:
            y = np.asarray(y_raw, np.float32)
            num_classes = 1

        sample_w = None
        if self.get(self.WEIGHT_COL):
            sample_w = np.asarray(t.col(self.get(self.WEIGHT_COL)), np.float32)

        # standardization (reference folds stats back into weights)
        standardize = self.get(self.STANDARDIZATION)
        if standardize:
            mean = X.mean(axis=0)
            std = X.std(axis=0)
            std = np.where(std < 1e-12, 1.0, std)
            Xn = (X - mean) / std
        else:
            mean = np.zeros(d_raw, np.float32)
            std = np.ones(d_raw, np.float32)
            Xn = X

        intercept = self.get(self.WITH_INTERCEPT)
        if intercept:
            Xn = np.concatenate([Xn, np.ones((n, 1), np.float32)], axis=1)
        d = Xn.shape[1]

        obj = self._objective(d, num_classes)
        res = self._solve(obj, Xn, y, sample_w)

        # de-standardize: w_raw = w_std / std ; b_raw = b - sum(w_std * mean / std)
        if self.linear_model_type == "Softmax":
            W = res.weights.reshape(d, num_classes)
            Wf = W[:d_raw] / std[:, None]
            b = (W[d_raw] if intercept else np.zeros(num_classes)) - (
                W[:d_raw] * (mean / std)[:, None]
            ).sum(axis=0)
            arrays = {"weights": Wf.astype(np.float32), "intercept": b.astype(np.float32)}
        else:
            w = res.weights
            wf = w[:d_raw] / std
            b = (w[d_raw] if intercept else 0.0) - float((w[:d_raw] * mean / std).sum())
            arrays = {
                "weights": wf.astype(np.float32),
                "intercept": np.asarray([b], np.float32),
            }

        meta = {
            "modelName": "LinearModel",
            "linearModelType": self.linear_model_type,
            "vectorCol": self.get(HasVectorCol.VECTOR_COL),
            "featureCols": feature_cols,
            "labelCol": label_col,
            "labelType": t.schema.type_of(label_col),
            "labels": labels,
            "hasIntercept": bool(intercept),
            "dim": int(d_raw),
            "loss": res.loss,
            "gradNorm": res.grad_norm,
            "numIters": res.num_iters,
        }
        return model_to_table(meta, arrays)


class LogisticRegressionTrainBatchOp(BaseLinearModelTrainBatchOp):
    linear_model_type = "LR"


class LinearSvmTrainBatchOp(BaseLinearModelTrainBatchOp):
    linear_model_type = "SVM"


class LinearRegTrainBatchOp(BaseLinearModelTrainBatchOp):
    linear_model_type = "LinearReg"


class RidgeRegTrainBatchOp(BaseLinearModelTrainBatchOp):
    linear_model_type = "LinearReg"
    LAMBDA = ParamInfo("lambda", float, default=0.1, validator=MinValidator(0.0))

    def _effective_l2(self) -> float:
        # lambda is Ridge's canonical knob; an explicitly set l2 wins
        if self._params.contains("l2"):
            return self.get(self.L_2)
        return self.get(self.LAMBDA)


class LassoRegTrainBatchOp(BaseLinearModelTrainBatchOp):
    linear_model_type = "LinearReg"
    LAMBDA = ParamInfo("lambda", float, default=0.1, validator=MinValidator(0.0))

    def _effective_l1(self) -> float:
        if self._params.contains("l1"):
            return self.get(self.L_1)
        return self.get(self.LAMBDA)


class LinearSvrTrainBatchOp(BaseLinearModelTrainBatchOp):
    """Linear support-vector regression with a smoothed epsilon-insensitive
    loss (reference: operator/batch/regression/LinearSvrTrainBatchOp.java)."""

    linear_model_type = "SVR"
    SVR_EPSILON = ParamInfo("svrEpsilon", float, default=0.1,
                            aliases=("tau", "epsilonSvr"))


class SoftmaxTrainBatchOp(BaseLinearModelTrainBatchOp):
    linear_model_type = "Softmax"


class LinearModelMapper(RichModelMapper):
    """(reference: operator/common/linear/LinearModelMapper.java +
    SoftmaxModelMapper.java)

    Serving policies (``inferencePrecision``), as the reference's mapper:

    - ``bf16``: the weights and intercept are rounded through bf16 at load,
      and every dense feature block before its product;
    - ``int8``: static W8A8 on the single staged push
      (:func:`~...common.quant.int8_linear_score`): per-channel int8
      weights, the activation scale ``calib_scale(params, site + ".x")``
      from the stamped ``quantCalib`` (a missing site raises);
    - the 4 MiB chunked route (blocks of STREAM_THRESHOLD_BYTES or more)
      and the ELL sparse route keep fp32 products under either policy, on
      the weights the policy loaded (bf16-rounded under ``bf16``, fp32
      under ``int8``), as the reference's do.

    Inside :func:`~...common.quant.calibration` each dense block is observed
    under the site before any rounding."""

    # feature blocks at/above the threshold are scored in ~4 MiB row chunks
    # (the reference streams them so; each chunk is one staged push and one
    # product); below it one staged push is cheaper than the bookkeeping
    STREAM_THRESHOLD_BYTES = 16 * 1024 * 1024
    STREAM_CHUNK_BYTES = 4 * 1024 * 1024

    def load_model(self, model: MTable):
        import torch

        from ...common.env import resolve_device

        self.meta, arrays = table_to_model(model)
        self.weights = arrays["weights"]      # host copies: ndim checks
        self.intercept = arrays["intercept"]
        self._policy = quant.policy_of(self.get_params())
        self._site = quant.site_of(self.get_params(), "linear") + ".x"
        if self._policy == quant.BF16:
            self.weights = quant.bf16_round(self.weights)
            self.intercept = quant.bf16_round(self.intercept)
        self._device = resolve_device(self.device)
        dev = self._device
        self._w = torch.as_tensor(np.asarray(self.weights, np.float32),
                                  device=dev)
        self._b = torch.as_tensor(np.asarray(self.intercept, np.float32),
                                  device=dev)
        if self._policy == quant.INT8:
            wq, sw = quant.quantize_per_channel(self.weights)
            self._wq = torch.as_tensor(wq, device=dev)
            self._sw = torch.as_tensor(np.asarray(sw, np.float32), device=dev)
        return self

    def _pred_type(self) -> str:
        lt = self.meta.get("labelType", AlinkTypes.STRING)
        if self.meta["linearModelType"] == "LinearReg":
            return AlinkTypes.DOUBLE
        return lt

    def _scores(self, t: MTable) -> np.ndarray:
        import torch

        from ...common.jitcache import bucket_rows, note_signature
        from ...common.staging import push_block, stage_replicated

        merged = merge_feature_params(self.get_params(), self.meta)
        vec_col = merged.get("vectorCol") if merged.contains("vectorCol") \
            else None
        if vec_col:
            from ...common.linalg import (SparseVector, parse_vector,
                                          to_sparse_block)

            parsed = [parse_vector(v) for v in t.col(vec_col)]
            if parsed and all(isinstance(p, SparseVector) for p in parsed):
                # huge-sparse scoring: gather+reduce on the ELL block, never
                # densified (dim can exceed memory as a dense matrix)
                blk, _ = to_sparse_block(parsed, dim=self.meta["dim"])
                idx = torch.from_numpy(blk.idx).to(self._device)
                val = torch.from_numpy(blk.val).to(self._device)
                if self._w.ndim == 1:
                    s = (val * self._w[idx]).sum(1)
                else:
                    s = (val[..., None] * self._w[idx]).sum(1)
                return (s + self._b).cpu().numpy()
        X = get_feature_block(
            t, merged, vector_size=self.meta["dim"],
        ).astype(np.float32, copy=False)
        if quant.capturing():
            quant.observe(self._site, X)
        if self._policy == quant.BF16:
            X = quant.bf16_round(X)
        if X.nbytes >= self.STREAM_THRESHOLD_BYTES:
            # the reference's chunk: the largest power of two of rows
            # within STREAM_CHUNK_BYTES
            rows = max(1, self.STREAM_CHUNK_BYTES // max(X.strides[0], 1))
            rows = 1 << (rows.bit_length() - 1)
            parts = [push_block(X[i:i + rows], self._device) @ self._w
                     + self._b for i in range(0, X.shape[0], rows)]
            return torch.cat(parts).cpu().numpy()
        # cached device staging: re-predicting the same table does not
        # re-push its (memoized, read-only) feature block host->device. The
        # block is zero-padded to its row bucket, as the reference's is
        # (X @ w + b is row-wise; the padded scores are sliced off), so a
        # row scores the same whatever batch it came in
        n = X.shape[0]
        Xd = stage_replicated(X, self._device, pad_rows_to=bucket_rows(n))
        note_signature("linear.score", [Xd])
        if self._policy == quant.INT8:
            sx = torch.tensor(quant.calib_scale(self.get_params(),
                                                self._site),
                              dtype=torch.float32, device=self._device)
            return quant.int8_linear_score(Xd, self._wq, self._b, self._sw,
                                           sx)[:n].cpu().numpy()
        return (Xd @ self._w + self._b)[:n].cpu().numpy()

    def predict_proba_block(self, t: MTable):
        mtype = self.meta["linearModelType"]
        if mtype in ("LinearReg", "SVR"):
            return None
        if mtype == "Softmax":
            return softmax_np(self._scores(t))
        # binary LR / SVM: labels[0] is positive
        s = self._scores(t)
        s = s[:, 0] if s.ndim > 1 else s
        prob_pos = sigmoid_np(s)
        return np.stack([prob_pos, 1 - prob_pos], 1)

    def predict_block(self, t: MTable):
        if self.meta["linearModelType"] in ("LinearReg", "SVR"):
            s = self._scores(t)[:, 0] if self.weights.ndim > 1 else self._scores(t)
            return np.asarray(s, np.float64), AlinkTypes.DOUBLE, None
        return self._classification_result(self.predict_proba_block(t))


class LinearModelPredictOp(ModelMapBatchOp, HasPredictionCol,
                           HasPredictionDetailCol, HasReservedCols,
                           HasVectorCol, HasFeatureCols):
    mapper_cls = LinearModelMapper


class LogisticRegressionPredictBatchOp(LinearModelPredictOp):
    pass


class LinearSvmPredictBatchOp(LinearModelPredictOp):
    pass


class LinearRegPredictBatchOp(LinearModelPredictOp):
    pass


class RidgeRegPredictBatchOp(LinearModelPredictOp):
    pass


class LassoRegPredictBatchOp(LinearModelPredictOp):
    pass


class LinearSvrPredictBatchOp(LinearModelPredictOp):
    pass


class SoftmaxPredictBatchOp(LinearModelPredictOp):
    pass
