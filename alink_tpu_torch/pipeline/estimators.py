"""Concrete pipeline stages bound to their train/predict operators (the part
of ``alink_tpu.pipeline.estimators`` whose operators the port has).

Capability parity with the reference's generated pipeline classes (reference:
pipeline/clustering/KMeans.java, pipeline/classification/LogisticRegression.java,
LinearSvm.java, Softmax.java, pipeline/regression/LinearRegression.java /
Ridge / Lasso / LinearSvr, pipeline/classification/DecisionTreeClassifier.java,
RandomForestClassifier.java, GbdtClassifier.java,
pipeline/regression/GbdtRegressor.java, pipeline/nlp/Word2Vec.java — thin
Trainer wrappers over the corresponding BatchOps). Class names are the
reference's: a saved pipeline model names its stages by class.
"""

from __future__ import annotations

from ..mapper import (HasFeatureCols, HasPredictionCol, HasPredictionDetailCol,
                      HasReservedCols)
from ..operator.batch import clustering as _clu
from ..operator.batch import huge as _huge
from ..operator.batch import linear as _lin
from ..operator.batch import tree as _tree
from .base import EstimatorBase, ModelBase


class _RichPredictParams:
    PREDICTION_COL = HasPredictionCol.PREDICTION_COL
    PREDICTION_DETAIL_COL = HasPredictionDetailCol.PREDICTION_DETAIL_COL
    RESERVED_COLS = HasReservedCols.RESERVED_COLS


# -- clustering --------------------------------------------------------------
class KMeansModel(ModelBase):
    _predict_op_cls = _clu.KMeansPredictBatchOp


class KMeans(EstimatorBase, _clu.HasKMeansParams, _RichPredictParams):
    """(reference: pipeline/clustering/KMeans.java)"""

    _train_op_cls = _clu.KMeansTrainBatchOp
    _model_cls = KMeansModel


# -- linear models -----------------------------------------------------------
class LinearModel(ModelBase):
    _predict_op_cls = _lin.LinearModelPredictOp


class _LinearEstimator(EstimatorBase, _lin.HasLinearTrainParams,
                       _RichPredictParams):
    _model_cls = LinearModel


class LogisticRegression(_LinearEstimator):
    _train_op_cls = _lin.LogisticRegressionTrainBatchOp


class LinearSvm(_LinearEstimator):
    _train_op_cls = _lin.LinearSvmTrainBatchOp


class LinearRegression(_LinearEstimator):
    _train_op_cls = _lin.LinearRegTrainBatchOp


class Ridge(_LinearEstimator):
    _train_op_cls = _lin.RidgeRegTrainBatchOp
    LAMBDA = _lin.RidgeRegTrainBatchOp.LAMBDA


class Lasso(_LinearEstimator):
    _train_op_cls = _lin.LassoRegTrainBatchOp
    LAMBDA = _lin.LassoRegTrainBatchOp.LAMBDA


class Softmax(_LinearEstimator):
    _train_op_cls = _lin.SoftmaxTrainBatchOp


class LinearSvr(_LinearEstimator):
    """(reference: pipeline/regression/LinearSvr.java)"""

    _train_op_cls = _lin.LinearSvrTrainBatchOp
    SVR_EPSILON = _lin.LinearSvrTrainBatchOp.SVR_EPSILON


# -- trees / ensembles ---------------------------------------------------------
class DecisionTreeModel(ModelBase):
    _predict_op_cls = _tree.DecisionTreePredictBatchOp


class DecisionTreeClassifier(EstimatorBase, _RichPredictParams):
    """(reference: pipeline/classification/DecisionTreeClassifier.java)"""

    _train_op_cls = _tree.DecisionTreeTrainBatchOp
    _model_cls = DecisionTreeModel
    LABEL_COL = _tree.DecisionTreeTrainBatchOp.LABEL_COL
    MAX_DEPTH = _tree.DecisionTreeTrainBatchOp.MAX_DEPTH
    FEATURE_COLS = HasFeatureCols.FEATURE_COLS


class RandomForestModel(ModelBase):
    _predict_op_cls = _tree.RandomForestPredictBatchOp


class RandomForestClassifier(EstimatorBase, _RichPredictParams):
    """(reference: pipeline/classification/RandomForestClassifier.java)"""

    _train_op_cls = _tree.RandomForestTrainBatchOp
    _model_cls = RandomForestModel
    LABEL_COL = _tree.RandomForestTrainBatchOp.LABEL_COL
    NUM_TREES = _tree.RandomForestTrainBatchOp.NUM_TREES
    MAX_DEPTH = _tree.RandomForestTrainBatchOp.MAX_DEPTH
    FEATURE_COLS = HasFeatureCols.FEATURE_COLS


class GbdtModel(ModelBase):
    _predict_op_cls = _tree.GbdtPredictBatchOp


class GbdtClassifier(EstimatorBase, _RichPredictParams):
    """(reference: pipeline/classification/GbdtClassifier.java)"""

    _train_op_cls = _tree.GbdtTrainBatchOp
    _model_cls = GbdtModel
    LABEL_COL = _tree.GbdtTrainBatchOp.LABEL_COL
    NUM_TREES = _tree.GbdtTrainBatchOp.NUM_TREES
    MAX_DEPTH = _tree.GbdtTrainBatchOp.MAX_DEPTH
    LEARNING_RATE = _tree.GbdtTrainBatchOp.LEARNING_RATE
    FEATURE_COLS = HasFeatureCols.FEATURE_COLS


class GbdtRegModel(ModelBase):
    _predict_op_cls = _tree.GbdtRegPredictBatchOp


class GbdtRegressor(EstimatorBase, _RichPredictParams):
    """(reference: pipeline/regression/GbdtRegressor.java)"""

    _train_op_cls = _tree.GbdtRegTrainBatchOp
    _model_cls = GbdtRegModel
    LABEL_COL = _tree.GbdtRegTrainBatchOp.LABEL_COL
    NUM_TREES = _tree.GbdtRegTrainBatchOp.NUM_TREES
    MAX_DEPTH = _tree.GbdtRegTrainBatchOp.MAX_DEPTH
    FEATURE_COLS = HasFeatureCols.FEATURE_COLS


# -- nlp ----------------------------------------------------------------------
class Word2VecModel(ModelBase):
    _predict_op_cls = _huge.Word2VecPredictBatchOp


class Word2Vec(EstimatorBase):
    """(reference: pipeline/nlp/Word2Vec.java)"""

    _train_op_cls = _huge.Word2VecTrainBatchOp
    _model_cls = Word2VecModel
    SELECTED_COL = _huge.HasWord2VecParams.SELECTED_COL
    VECTOR_SIZE = _huge.HasWord2VecParams.VECTOR_SIZE
    WINDOW = _huge.HasWord2VecParams.WINDOW
    NUM_ITER = _huge.HasWord2VecParams.NUM_ITER
    MIN_COUNT = _huge.HasWord2VecParams.MIN_COUNT
    PREDICTION_COL = HasPredictionCol.PREDICTION_COL
