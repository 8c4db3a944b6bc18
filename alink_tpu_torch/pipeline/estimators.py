"""Concrete pipeline stages bound to their train/predict operators (the part
of ``alink_tpu.pipeline.estimators`` whose operators the port has).

Capability parity with the reference's generated pipeline classes (reference:
pipeline/clustering/KMeans.java, pipeline/classification/LogisticRegression.java,
LinearSvm.java, Softmax.java, pipeline/regression/LinearRegression.java /
Ridge / Lasso / LinearSvr, pipeline/classification/DecisionTreeClassifier.java,
RandomForestClassifier.java, GbdtClassifier.java,
pipeline/regression/GbdtRegressor.java, pipeline/classification/C45.java,
Cart.java, Id3.java, pipeline/nlp/Word2Vec.java — thin Trainer wrappers over
the corresponding BatchOps). Class names are the reference's: a saved
pipeline model names its stages by class. The stages that the reference's
``pipeline/generated.py`` builds from its spec tables (KerasSequential,
CartReg, the tree encoders, the BERT text stages and the model-only BERT
stages) are built here from the same entries (:data:`GENERATED`,
:data:`GENERATED_MODELS`).
"""

from __future__ import annotations

from typing import Dict

from ..common.params import ParamInfo
from ..mapper import (HasFeatureCols, HasPredictionCol, HasPredictionDetailCol,
                      HasReservedCols)
from ..operator.batch import clustering as _clu
from ..operator.batch import dl as _dl
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


class C45Model(ModelBase):
    _predict_op_cls = _tree.C45PredictBatchOp


class C45(EstimatorBase, _RichPredictParams):
    """(reference: pipeline/classification/C45.java)"""

    _train_op_cls = _tree.C45TrainBatchOp
    _model_cls = C45Model
    LABEL_COL = _tree.HasTreeTrainParams.LABEL_COL
    MAX_DEPTH = _tree.HasTreeTrainParams.MAX_DEPTH
    FEATURE_COLS = HasFeatureCols.FEATURE_COLS


class CartModel(ModelBase):
    _predict_op_cls = _tree.CartPredictBatchOp


class Cart(EstimatorBase, _RichPredictParams):
    """(reference: pipeline/classification/Cart.java)"""

    _train_op_cls = _tree.CartTrainBatchOp
    _model_cls = CartModel
    LABEL_COL = _tree.HasTreeTrainParams.LABEL_COL
    MAX_DEPTH = _tree.HasTreeTrainParams.MAX_DEPTH
    FEATURE_COLS = HasFeatureCols.FEATURE_COLS


class Id3Model(ModelBase):
    _predict_op_cls = _tree.Id3PredictBatchOp


class Id3(EstimatorBase, _RichPredictParams):
    """(reference: pipeline/classification/Id3.java)"""

    _train_op_cls = _tree.Id3TrainBatchOp
    _model_cls = Id3Model
    LABEL_COL = _tree.HasTreeTrainParams.LABEL_COL
    MAX_DEPTH = _tree.HasTreeTrainParams.MAX_DEPTH
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


# -- the reference's generated stages -----------------------------------------
# name -> (train op, predict op, model class name), the entries of the
# reference's pipeline/generated.py ESTIMATORS table whose ops the port has
GENERATED: Dict[str, tuple] = {
    "C45Encoder": (_tree.C45EncoderTrainBatchOp,
                   _tree.TreeModelEncoderBatchOp, "C45EncoderModel"),
    "CartEncoder": (_tree.CartEncoderTrainBatchOp,
                    _tree.TreeModelEncoderBatchOp, "CartEncoderModel"),
    "CartReg": (_tree.CartRegTrainBatchOp, _tree.CartRegPredictBatchOp,
                "CartRegModel"),
    "CartRegEncoder": (_tree.CartRegEncoderTrainBatchOp,
                       _tree.TreeModelEncoderBatchOp, "CartRegEncoderModel"),
    "DecisionTreeEncoder": (_tree.DecisionTreeEncoderTrainBatchOp,
                            _tree.TreeModelEncoderBatchOp,
                            "DecisionTreeEncoderModel"),
    "DecisionTreeRegEncoder": (_tree.DecisionTreeRegEncoderTrainBatchOp,
                               _tree.TreeModelEncoderBatchOp,
                               "DecisionTreeRegEncoderModel"),
    "GbdtEncoder": (_tree.GbdtEncoderTrainBatchOp,
                    _tree.GbdtEncoderPredictBatchOp, "GbdtEncoderModel"),
    "GbdtRegEncoder": (_tree.GbdtRegEncoderTrainBatchOp,
                       _tree.TreeModelEncoderBatchOp, "GbdtRegEncoderModel"),
    "Id3Encoder": (_tree.Id3EncoderTrainBatchOp,
                   _tree.TreeModelEncoderBatchOp, "Id3EncoderModel"),
    "KerasSequentialClassifier": (
        _dl.KerasSequentialClassifierTrainBatchOp,
        _dl.KerasSequentialClassifierPredictBatchOp,
        "KerasSequentialClassifierModel"),
    "KerasSequentialRegressor": (
        _dl.KerasSequentialRegressorTrainBatchOp,
        _dl.KerasSequentialRegressorPredictBatchOp,
        "KerasSequentialRegressorModel"),
    "BertTextClassifier": (_dl.BertTextClassifierTrainBatchOp,
                           _dl.BertTextClassifierPredictBatchOp,
                           "BertTextClassifierModel"),
    "BertTextPairClassifier": (_dl.BertTextPairClassifierTrainBatchOp,
                               _dl.BertTextPairClassifierPredictBatchOp,
                               "BertTextPairClassifierModel"),
    "BertTextPairRegressor": (_dl.BertTextPairRegressorTrainBatchOp,
                              _dl.BertTextPairRegressorPredictBatchOp,
                              "BertTextPairRegressorModel"),
    "BertTextRegressor": (_dl.BertTextRegressorTrainBatchOp,
                          _dl.BertTextRegressorPredictBatchOp,
                          "BertTextRegressorModel"),
    "RandomForestEncoder": (_tree.RandomForestEncoderTrainBatchOp,
                            _tree.TreeModelEncoderBatchOp,
                            "RandomForestEncoderModel"),
    "RandomForestRegEncoder": (_tree.RandomForestRegEncoderTrainBatchOp,
                               _tree.TreeModelEncoderBatchOp,
                               "RandomForestRegEncoderModel"),
}

# model-only stage -> its predict op, the entries of the reference's
# pipeline/generated.py MODELS table whose ops the port has
GENERATED_MODELS: Dict[str, type] = {
    "BertClassificationModel": _dl.BertTextClassifierPredictBatchOp,
    "BertRegressionModel": _dl.BertTextRegressorPredictBatchOp,
    "BertTextEmbedding": _dl.BertTextEmbeddingBatchOp,
}

# serving-only param names: the predict op's definition wins, as in the
# reference's generated stages
_SERVING_PARAM_NAMES = frozenset(
    {"predictionCol", "predictionDetailCol", "reservedCols"})


def _mirror_params(*op_classes) -> Dict[str, ParamInfo]:
    """The ops' ParamInfos by attribute name, for the stage's setters."""
    out: Dict[str, ParamInfo] = {}
    for cls in op_classes:
        mine: Dict[str, ParamInfo] = {}
        for klass in cls.__mro__:
            for k, v in vars(klass).items():
                if isinstance(v, ParamInfo) and k not in mine:
                    mine[k] = v
        for k, v in mine.items():
            if k not in out or (out[k] is not v
                                and v.name in _SERVING_PARAM_NAMES):
                out[k] = v
    return out


def _generate():
    for name, predict_op in GENERATED_MODELS.items():
        globals()[name] = type(name, (ModelBase,), {
            "__doc__": f"(reference: pipeline/**/{name}.java, generated)",
            "__module__": __name__, "_predict_op_cls": predict_op,
            **_mirror_params(predict_op)})
    for name, (train_op, predict_op, model_name) in GENERATED.items():
        doc = f"(reference: pipeline/**/{name}.java, generated)"
        model = type(model_name, (ModelBase,), {
            "__doc__": doc, "__module__": __name__,
            "_predict_op_cls": predict_op, **_mirror_params(predict_op)})
        globals()[model_name] = model
        globals()[name] = type(name, (EstimatorBase,), {
            "__doc__": doc, "__module__": __name__,
            "_train_op_cls": train_op, "_model_cls": model,
            **_mirror_params(train_op, predict_op)})


_generate()
