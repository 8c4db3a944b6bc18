"""Tree ensemble operators: GBDT, RandomForest, DecisionTree (port of the
histogram-tree part of ``alink_tpu/operator/batch/tree.py``).

Capability parity (reference: operator/batch/classification/
GbdtTrainBatchOp.java, RandomForestTrainBatchOp.java,
DecisionTreeTrainBatchOp.java; regression/GbdtRegTrainBatchOp.java,
RandomForestRegTrainBatchOp.java, DecisionTreeRegTrainBatchOp.java; predict
via operator/common/tree/predictors/*).

Training runs on the session's device (``self.env.device``); a model table
written by either package predicts the same in the other. Not ported yet:
the impurity trees (Cart/C45/Id3) and the tree-model encoder family
(ROADMAP A5), and the quantized serving policies (int8/bf16 raise).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ...common.exceptions import AkIllegalDataException
from ...common.model import model_to_table, table_to_model
from ...common.mtable import AlinkTypes, MTable
from ...common.params import MinValidator, ParamInfo
from ...common.quant import policy_of
from ...mapper import (
    HasFeatureCols,
    HasPredictionCol,
    HasPredictionDetailCol,
    HasReservedCols,
    HasVectorCol,
    RichModelMapper,
    detail_json,
    get_feature_block,
    merge_feature_params,
    np_labels,
    resolve_feature_cols,
    softmax_np,
)
from ...tree import TreeEnsemble, train_forest, train_gbdt
from .base import BatchOperator
from .utils import ModelMapBatchOp, ModelTrainOpMixin


class HasTreeTrainParams(HasFeatureCols, HasVectorCol):
    LABEL_COL = ParamInfo("labelCol", str, optional=False)
    MAX_DEPTH = ParamInfo("maxDepth", int, default=5, validator=MinValidator(1))
    NUM_TREES = ParamInfo("numTrees", int, default=100, validator=MinValidator(1))
    MAX_BINS = ParamInfo("maxBins", int, default=64, validator=MinValidator(2))
    MIN_SAMPLES_PER_LEAF = ParamInfo("minSamplesPerLeaf", int, default=5)
    MIN_INFO_GAIN = ParamInfo("minInfoGain", float, default=0.0)
    SUBSAMPLING_RATIO = ParamInfo("subsamplingRatio", float, default=1.0)
    FEATURE_SUBSAMPLING_RATIO = ParamInfo("featureSubsamplingRatio", float,
                                          default=1.0)
    RANDOM_SEED = ParamInfo("randomSeed", int, default=0)


class _BaseTreeTrainBatchOp(ModelTrainOpMixin, BatchOperator, HasTreeTrainParams):
    _min_inputs = 1
    _max_inputs = 1

    _algo: str = None  # "gbdt" | "forest"
    _regression = False

    def _static_meta_keys(self, in_schema):
        return {
            "modelName": "TreeEnsembleModel",
            "task": "regression" if self._regression else "classification",
            "labelType": in_schema.type_of(self.get(self.LABEL_COL)),
        }
    # forced overrides for single-tree variants (DecisionTree)
    _force_num_trees: Optional[int] = None

    LEARNING_RATE = ParamInfo("learningRate", float, default=0.1)

    def _prep_data(self, t: MTable):
        """Shared label-encoding + feature-block extraction for every tree
        trainer."""
        label_col = self.get(self.LABEL_COL)
        vec_col = self.get(HasVectorCol.VECTOR_COL)
        feature_cols = (
            None if vec_col else resolve_feature_cols(t, self, exclude=[label_col])
        )
        X = get_feature_block(t, self, exclude=[label_col]).astype(np.float32)
        y_raw = t.col(label_col)

        if self._regression:
            y = np.asarray(y_raw, np.float32)
            labels, task, K = None, "regression", 1
        else:
            labels = sorted(set(np.asarray(y_raw).tolist()), key=str)
            lab_to_idx = {v: i for i, v in enumerate(labels)}
            y = np.asarray([lab_to_idx[v] for v in y_raw], np.float32)
            K = len(labels)
            if K < 2:
                raise AkIllegalDataException("need >= 2 label values")
            task = "binary" if K == 2 else "multiclass"
        return X, y, labels, K, task, feature_cols, vec_col, label_col

    def _model_meta(self, t, ens, task, labels, feature_cols, vec_col,
                    label_col, num_trees, dim, **extra):
        meta = {
            "modelName": "TreeEnsembleModel",
            "algo": self._algo,
            "task": task,
            "depth": int(ens.depth),
            "vectorCol": vec_col,
            "featureCols": feature_cols,
            "labelCol": label_col,
            "labelType": t.schema.type_of(label_col),
            "labels": labels,
            "dim": dim,
            "numTrees": int(num_trees),
        }
        meta.update(extra)
        return meta

    def _execute_impl(self, t: MTable) -> MTable:
        (X, y, labels, K, task, feature_cols, vec_col,
         label_col) = self._prep_data(t)
        num_trees = self._force_num_trees or self.get(self.NUM_TREES)
        common = dict(
            task=task,
            num_trees=num_trees,
            depth=self.get(self.MAX_DEPTH),
            num_bins=self.get(self.MAX_BINS),
            min_samples=float(self.get(self.MIN_SAMPLES_PER_LEAF)),
            min_gain=self.get(self.MIN_INFO_GAIN),
            num_classes=K,
            seed=self.get(self.RANDOM_SEED),
            device=self.env.device,
        )
        if self._algo == "gbdt":
            ens = train_gbdt(
                X, y,
                learning_rate=self.get(self.LEARNING_RATE),
                subsample=self.get(self.SUBSAMPLING_RATIO),
                colsample=self.get(self.FEATURE_SUBSAMPLING_RATIO),
                **common,
            )
        else:
            # explicitly-set 1.0 means "all features"; unset means the
            # sqrt(d)/d forest heuristic (resolved inside train_forest)
            ff = (
                self.get(self.FEATURE_SUBSAMPLING_RATIO)
                if self._params.contains("featureSubsamplingRatio")
                else None
            )
            ens = train_forest(
                X, y,
                subsample=self.get(self.SUBSAMPLING_RATIO),
                feature_fraction=ff,
                bootstrap=num_trees > 1,
                **common,
            )

        meta = self._model_meta(t, ens, task, labels, feature_cols, vec_col,
                                label_col, num_trees, int(X.shape[1]))
        return model_to_table(meta, ens.to_arrays())


class GbdtTrainBatchOp(_BaseTreeTrainBatchOp):
    """(reference: operator/batch/classification/GbdtTrainBatchOp.java)"""

    _algo = "gbdt"
    _regression = False


class GbdtRegTrainBatchOp(_BaseTreeTrainBatchOp):
    _algo = "gbdt"
    _regression = True


class RandomForestTrainBatchOp(_BaseTreeTrainBatchOp):
    """(reference: operator/batch/classification/RandomForestTrainBatchOp.java)"""

    _algo = "forest"
    _regression = False
    NUM_TREES = ParamInfo("numTrees", int, default=10, validator=MinValidator(1))


class RandomForestRegTrainBatchOp(_BaseTreeTrainBatchOp):
    _algo = "forest"
    _regression = True
    NUM_TREES = ParamInfo("numTrees", int, default=10, validator=MinValidator(1))


class DecisionTreeTrainBatchOp(_BaseTreeTrainBatchOp):
    """Single tree via the variance/Newton-gain histogram trainer
    (reference: DecisionTreeTrainBatchOp.java)."""

    _algo = "forest"
    _regression = False
    _force_num_trees = 1


class DecisionTreeRegTrainBatchOp(_BaseTreeTrainBatchOp):
    _algo = "forest"
    _regression = True
    _force_num_trees = 1


class TreeModelMapper(RichModelMapper):
    def load_model(self, model: MTable):
        self.meta, arrays = table_to_model(model)
        self.ensemble = TreeEnsemble.from_arrays(self.meta, arrays)
        policy_of(self.get_params())  # fp32 only: bf16/int8 raise
        return self

    def _pred_type(self) -> str:
        if self.meta["task"] == "regression":
            return AlinkTypes.DOUBLE
        return self.meta.get("labelType", AlinkTypes.STRING)

    def predict_block(self, t: MTable):
        meta = self.meta
        p = merge_feature_params(self.get_params(), meta)
        X = get_feature_block(t, p, vector_size=meta["dim"]).astype(np.float32)
        scores = self.ensemble.raw_predict(X, device=self.device)  # (n, K)
        task = meta["task"]
        if task == "regression":
            return scores[:, 0].astype(np.float64), AlinkTypes.DOUBLE, None

        labels = meta["labels"]
        if task == "binary":
            if meta["algo"] == "gbdt":
                p1 = 1.0 / (1.0 + np.exp(-np.clip(scores[:, 0], -30, 30)))
            else:
                p1 = np.clip(scores[:, 0], 0.0, 1.0)
            probs = np.stack([1 - p1, p1], axis=1)
        else:
            if meta["algo"] == "gbdt":
                probs = softmax_np(scores)
            else:
                s = np.clip(scores, 0, None)
                probs = s / np.maximum(s.sum(axis=1, keepdims=True), 1e-12)
        idx = probs.argmax(axis=1)
        pred = np_labels(labels, meta.get("labelType", AlinkTypes.STRING), idx)
        detail = None
        if self.get(HasPredictionDetailCol.PREDICTION_DETAIL_COL):
            detail = detail_json(labels, probs)
        return pred, self._pred_type(), detail


class _TreePredictBatchOp(ModelMapBatchOp, HasPredictionCol,
                          HasPredictionDetailCol, HasReservedCols,
                          HasFeatureCols, HasVectorCol):
    mapper_cls = TreeModelMapper


class GbdtPredictBatchOp(_TreePredictBatchOp):
    pass


class GbdtRegPredictBatchOp(_TreePredictBatchOp):
    pass


class RandomForestPredictBatchOp(_TreePredictBatchOp):
    pass


class RandomForestRegPredictBatchOp(_TreePredictBatchOp):
    pass


class DecisionTreePredictBatchOp(_TreePredictBatchOp):
    pass


class DecisionTreeRegPredictBatchOp(_TreePredictBatchOp):
    pass
