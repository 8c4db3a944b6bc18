"""Concrete pipeline stages bound to their train/predict operators (the part
of ``alink_tpu.pipeline.estimators`` whose operators the port has).

Capability parity with the reference's generated pipeline classes (reference:
pipeline/clustering/KMeans.java, pipeline/classification/LogisticRegression.java,
LinearSvm.java, Softmax.java, pipeline/regression/LinearRegression.java /
Ridge / Lasso / LinearSvr, pipeline/classification/DecisionTreeClassifier.java,
NaiveBayes.java, KnnClassifier.java, FmClassifier.java,
MultilayerPerceptronClassifier.java, pipeline/regression/FmRegressor.java,
GeneralizedLinearRegression.java, IsotonicRegression.java,
AftSurvivalRegression.java,
RandomForestClassifier.java, GbdtClassifier.java,
pipeline/regression/GbdtRegressor.java, pipeline/classification/C45.java,
pipeline/clustering/GaussianMixture.java, BisectingKMeans.java, Lda.java,
pipeline/dataproc/StandardScaler.java, MinMaxScaler.java, StringIndexer.java,
Imputer.java, pipeline/dataproc/vector/VectorAssembler.java,
pipeline/feature/OneHotEncoder.java, PCA.java, QuantileDiscretizer.java,
Binning.java, FeatureHasher.java, MultiHotEncoder.java, TargetEncoder.java,
Binarizer.java, Bucketizer.java, CrossFeature.java,
pipeline/dataproc/MultiStringIndexer.java, pipeline/finance/WoeEncoder.java,
pipeline/classification/NaiveBayesTextClassifier.java,
pipeline/nlp/Tokenizer.java, RegexTokenizer.java,
Cart.java, Id3.java, pipeline/nlp/Word2Vec.java,
pipeline/recommendation/ALS.java, pipeline/dataproc/SparseFeatureIndexer.java
— thin Trainer wrappers over
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
from ..mapper import (HasFeatureCols, HasOutputCol, HasOutputCols,
                      HasPredictionCol, HasPredictionDetailCol,
                      HasReservedCols, HasSelectedCol, HasSelectedCols,
                      HasVectorCol)
from ..operator.batch import classification as _cls
from ..operator.batch import clustering as _clu
from ..operator.batch import clustering2 as _clu2
from ..operator.batch import dataproc as _dp
from ..operator.batch import dl as _dl
from ..operator.batch import huge as _huge
from ..operator.batch import linear as _lin
from ..operator.batch import regression as _reg
from ..operator.batch import feature as _feat
from ..operator.batch import feature2 as _feat2
from ..operator.batch import feature3 as _feat3
from ..operator.batch import feature4 as _feat4
from ..operator.batch import misc2 as _misc2
from ..operator.batch import nlp as _nlp
from ..operator.batch import nlp2 as _nlp2
from ..operator.batch import recommendation as _rec
from ..operator.batch import tree as _tree
from .base import EstimatorBase, ModelBase, TransformerBase


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


class GaussianMixtureModel(ModelBase):
    _predict_op_cls = _clu2.GmmPredictBatchOp


class GaussianMixture(EstimatorBase):
    """(reference: pipeline/clustering/GaussianMixture.java)"""

    _train_op_cls = _clu2.GmmTrainBatchOp
    _model_cls = GaussianMixtureModel
    K = _clu2.GmmTrainBatchOp.K
    MAX_ITER = _clu2.GmmTrainBatchOp.MAX_ITER
    FEATURE_COLS = HasFeatureCols.FEATURE_COLS
    VECTOR_COL = HasVectorCol.VECTOR_COL
    PREDICTION_COL = HasPredictionCol.PREDICTION_COL
    PREDICTION_DETAIL_COL = HasPredictionDetailCol.PREDICTION_DETAIL_COL


class BisectingKMeansModel(ModelBase):
    _predict_op_cls = _clu2.BisectingKMeansPredictBatchOp


class BisectingKMeans(EstimatorBase):
    """(reference: pipeline/clustering/BisectingKMeans.java)"""

    _train_op_cls = _clu2.BisectingKMeansTrainBatchOp
    _model_cls = BisectingKMeansModel
    K = _clu2.BisectingKMeansTrainBatchOp.K
    FEATURE_COLS = HasFeatureCols.FEATURE_COLS
    VECTOR_COL = HasVectorCol.VECTOR_COL
    PREDICTION_COL = HasPredictionCol.PREDICTION_COL


class LdaModel(ModelBase):
    _predict_op_cls = _clu2.LdaPredictBatchOp


class Lda(EstimatorBase):
    """(reference: pipeline/clustering/Lda.java)"""

    _train_op_cls = _clu2.LdaTrainBatchOp
    _model_cls = LdaModel
    SELECTED_COL = _clu2.HasSelectedCol.SELECTED_COL
    TOPIC_NUM = _clu2.LdaTrainBatchOp.TOPIC_NUM
    NUM_ITER = _clu2.LdaTrainBatchOp.NUM_ITER
    PREDICTION_COL = HasPredictionCol.PREDICTION_COL
    PREDICTION_DETAIL_COL = HasPredictionDetailCol.PREDICTION_DETAIL_COL


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


# -- regression breadth ------------------------------------------------------
class GlmModel(ModelBase):
    _predict_op_cls = _reg.GlmPredictBatchOp


class GeneralizedLinearRegression(EstimatorBase):
    """(reference: pipeline/regression/GeneralizedLinearRegression.java)"""

    _train_op_cls = _reg.GlmTrainBatchOp
    _model_cls = GlmModel
    LABEL_COL = _reg.GlmTrainBatchOp.LABEL_COL
    FAMILY = _reg.GlmTrainBatchOp.FAMILY
    LINK = _reg.GlmTrainBatchOp.LINK
    MAX_ITER = _reg.GlmTrainBatchOp.MAX_ITER
    FEATURE_COLS = HasFeatureCols.FEATURE_COLS
    PREDICTION_COL = HasPredictionCol.PREDICTION_COL


class IsotonicRegressionModel(ModelBase):
    _predict_op_cls = _reg.IsotonicRegPredictBatchOp


class IsotonicRegression(EstimatorBase):
    """(reference: pipeline/regression/IsotonicRegression.java)"""

    _train_op_cls = _reg.IsotonicRegTrainBatchOp
    _model_cls = IsotonicRegressionModel
    FEATURE_COL = _reg.IsotonicRegTrainBatchOp.FEATURE_COL
    LABEL_COL = _reg.IsotonicRegTrainBatchOp.LABEL_COL
    ISOTONIC = _reg.IsotonicRegTrainBatchOp.ISOTONIC
    PREDICTION_COL = HasPredictionCol.PREDICTION_COL


class AftSurvivalRegressionModel(ModelBase):
    _predict_op_cls = _reg.AftSurvivalRegPredictBatchOp


class AftSurvivalRegression(EstimatorBase):
    """(reference: pipeline/regression/AftSurvivalRegression.java)"""

    _train_op_cls = _reg.AftSurvivalRegTrainBatchOp
    _model_cls = AftSurvivalRegressionModel
    LABEL_COL = _reg.AftSurvivalRegTrainBatchOp.LABEL_COL
    CENSOR_COL = _reg.AftSurvivalRegTrainBatchOp.CENSOR_COL
    FEATURE_COLS = HasFeatureCols.FEATURE_COLS
    PREDICTION_COL = HasPredictionCol.PREDICTION_COL


# -- feature engineering -----------------------------------------------------
class StandardScalerModel(ModelBase):
    _predict_op_cls = _feat.StandardScalerPredictBatchOp


class StandardScaler(EstimatorBase, _feat.HasSelectedCols):
    """(reference: pipeline/dataproc/StandardScaler.java)"""

    _train_op_cls = _feat.StandardScalerTrainBatchOp
    _model_cls = StandardScalerModel
    WITH_MEAN = _feat.StandardScalerTrainBatchOp.WITH_MEAN
    WITH_STD = _feat.StandardScalerTrainBatchOp.WITH_STD


class MinMaxScalerModel(ModelBase):
    _predict_op_cls = _feat.MinMaxScalerPredictBatchOp


class MinMaxScaler(EstimatorBase, _feat.HasSelectedCols):
    """(reference: pipeline/dataproc/MinMaxScaler.java)"""

    _train_op_cls = _feat.MinMaxScalerTrainBatchOp
    _model_cls = MinMaxScalerModel
    MIN = _feat.MinMaxScalerTrainBatchOp.MIN
    MAX = _feat.MinMaxScalerTrainBatchOp.MAX


class VectorAssembler(TransformerBase, _feat.HasSelectedCols):
    """(reference: pipeline/dataproc/vector/VectorAssembler.java)"""

    _map_op_cls = _feat.VectorAssemblerBatchOp
    OUTPUT_COL = _feat.HasOutputCol.OUTPUT_COL
    RESERVED_COLS = HasReservedCols.RESERVED_COLS


class OneHotEncoderModel(ModelBase):
    _predict_op_cls = _feat2.OneHotPredictBatchOp


class OneHotEncoder(EstimatorBase, _feat2.HasSelectedCols):
    """(reference: pipeline/feature/OneHotEncoder.java)"""

    _train_op_cls = _feat2.OneHotTrainBatchOp
    _model_cls = OneHotEncoderModel
    DROP_LAST = _feat2.OneHotTrainBatchOp.DROP_LAST
    OUTPUT_COL = _feat2.HasOutputCol.OUTPUT_COL


class PCAModel(ModelBase):
    _predict_op_cls = _feat2.PcaPredictBatchOp


class PCA(EstimatorBase, _feat2.HasSelectedCols):
    """(reference: pipeline/feature/PCA.java)"""

    _train_op_cls = _feat2.PcaTrainBatchOp
    _model_cls = PCAModel
    K = _feat2.PcaTrainBatchOp.K
    CALCULATION_TYPE = _feat2.PcaTrainBatchOp.CALCULATION_TYPE
    VECTOR_COL = _feat2.PcaTrainBatchOp.VECTOR_COL
    OUTPUT_COL = _feat2.HasOutputCol.OUTPUT_COL


class QuantileDiscretizerModel(ModelBase):
    _predict_op_cls = _feat2.QuantileDiscretizerPredictBatchOp


class QuantileDiscretizer(EstimatorBase, _feat2.HasSelectedCols):
    """(reference: pipeline/feature/QuantileDiscretizer.java)"""

    _train_op_cls = _feat2.QuantileDiscretizerTrainBatchOp
    _model_cls = QuantileDiscretizerModel
    NUM_BUCKETS = _feat2.QuantileDiscretizerTrainBatchOp.NUM_BUCKETS


class BinningModel(ModelBase):
    _predict_op_cls = _feat2.BinningPredictBatchOp


class Binning(EstimatorBase, _feat2.HasSelectedCols):
    """(reference: pipeline/feature/Binning.java — WOE/INDEX encode)"""

    _train_op_cls = _feat2.BinningTrainBatchOp
    _model_cls = BinningModel
    LABEL_COL = _feat2.BinningTrainBatchOp.LABEL_COL
    NUM_BUCKETS = _feat2.BinningTrainBatchOp.NUM_BUCKETS
    ENCODE = _feat2.BinningModelMapper.ENCODE


class StringIndexerModel(ModelBase):
    _predict_op_cls = _dp.StringIndexerPredictBatchOp


class StringIndexer(EstimatorBase, _dp.HasSelectedCols):
    """(reference: pipeline/dataproc/StringIndexer.java)"""

    _train_op_cls = _dp.StringIndexerTrainBatchOp
    _model_cls = StringIndexerModel
    STRING_ORDER_TYPE = _dp.StringIndexerTrainBatchOp.STRING_ORDER_TYPE
    HANDLE_INVALID = _dp.StringIndexerModelMapper.HANDLE_INVALID
    OUTPUT_COLS = _dp.HasOutputCols.OUTPUT_COLS


class ImputerModel(ModelBase):
    _predict_op_cls = _dp.ImputerPredictBatchOp


class Imputer(EstimatorBase, _dp.HasSelectedCols):
    """(reference: pipeline/dataproc/Imputer.java)"""

    _train_op_cls = _dp.ImputerTrainBatchOp
    _model_cls = ImputerModel
    STRATEGY = _dp.ImputerTrainBatchOp.STRATEGY
    FILL_VALUE = _dp.ImputerTrainBatchOp.FILL_VALUE


class FeatureHasher(TransformerBase, _feat2.HasSelectedCols):
    """(reference: pipeline/feature/FeatureHasher.java)"""

    _map_op_cls = _feat2.FeatureHasherBatchOp
    NUM_FEATURES = _feat2.FeatureHasherBatchOp.NUM_FEATURES
    CATEGORICAL_COLS = _feat2.FeatureHasherBatchOp.CATEGORICAL_COLS
    OUTPUT_COL = _feat2.HasOutputCol.OUTPUT_COL


# -- classification breadth ----------------------------------------------------
class NaiveBayesModel(ModelBase):
    _predict_op_cls = _cls.NaiveBayesPredictBatchOp


class NaiveBayes(EstimatorBase, _RichPredictParams):
    """(reference: pipeline/classification/NaiveBayes.java)"""

    _train_op_cls = _cls.NaiveBayesTrainBatchOp
    _model_cls = NaiveBayesModel
    LABEL_COL = _cls.NaiveBayesTrainBatchOp.LABEL_COL
    MODEL_TYPE = _cls.NaiveBayesTrainBatchOp.MODEL_TYPE
    SMOOTHING = _cls.NaiveBayesTrainBatchOp.SMOOTHING
    FEATURE_COLS = HasFeatureCols.FEATURE_COLS
    VECTOR_COL = HasVectorCol.VECTOR_COL


class KnnClassifierModel(ModelBase):
    _predict_op_cls = _cls.KnnPredictBatchOp


class KnnClassifier(EstimatorBase, _RichPredictParams):
    """(reference: pipeline/classification/KnnClassifier.java)"""

    _train_op_cls = _cls.KnnTrainBatchOp
    _model_cls = KnnClassifierModel
    LABEL_COL = _cls.KnnTrainBatchOp.LABEL_COL
    DISTANCE_TYPE = _cls.KnnTrainBatchOp.DISTANCE_TYPE
    K = _cls.KnnModelMapper.K
    FEATURE_COLS = HasFeatureCols.FEATURE_COLS
    VECTOR_COL = HasVectorCol.VECTOR_COL


class FmModel(ModelBase):
    _predict_op_cls = _cls.FmPredictBatchOp


class FmClassifier(EstimatorBase, _RichPredictParams):
    """(reference: pipeline/classification/FmClassifier.java)"""

    _train_op_cls = _cls.FmClassifierTrainBatchOp
    _model_cls = FmModel
    LABEL_COL = _cls.BaseFmTrainBatchOp.LABEL_COL
    NUM_FACTOR = _cls.BaseFmTrainBatchOp.NUM_FACTOR
    MAX_ITER = _cls.BaseFmTrainBatchOp.MAX_ITER
    FEATURE_COLS = HasFeatureCols.FEATURE_COLS
    VECTOR_COL = HasVectorCol.VECTOR_COL


class FmRegressor(FmClassifier):
    """(reference: pipeline/regression/FmRegressor.java)"""

    _train_op_cls = _cls.FmRegressorTrainBatchOp


class MultilayerPerceptronModel(ModelBase):
    _predict_op_cls = _cls.MultilayerPerceptronPredictBatchOp


class MultilayerPerceptronClassifier(EstimatorBase, _RichPredictParams):
    """(reference: pipeline/classification/MultilayerPerceptronClassifier.java)"""

    _train_op_cls = _cls.MultilayerPerceptronTrainBatchOp
    _model_cls = MultilayerPerceptronModel
    LABEL_COL = _cls.MultilayerPerceptronTrainBatchOp.LABEL_COL
    LAYERS = _cls.MultilayerPerceptronTrainBatchOp.LAYERS
    MAX_ITER = _cls.MultilayerPerceptronTrainBatchOp.MAX_ITER
    FEATURE_COLS = HasFeatureCols.FEATURE_COLS
    VECTOR_COL = HasVectorCol.VECTOR_COL


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


# -- feature, NLP and text-classification stages ------------------------------
class MultiHotEncoderModel(ModelBase):
    _predict_op_cls = _feat3.MultiHotPredictBatchOp


class MultiHotEncoder(EstimatorBase, HasSelectedCols):
    """(reference: pipeline/feature/MultiHotEncoder.java)"""

    _train_op_cls = _feat3.MultiHotTrainBatchOp
    _model_cls = MultiHotEncoderModel
    DELIMITER = _feat3.MultiHotTrainBatchOp.DELIMITER
    OUTPUT_COL = HasOutputCol.OUTPUT_COL


class TargetEncoderModel(ModelBase):
    _predict_op_cls = _feat3.TargetEncoderPredictBatchOp


class TargetEncoder(EstimatorBase, HasSelectedCols):
    """(reference: pipeline/feature/TargetEncoder.java)"""

    _train_op_cls = _feat3.TargetEncoderTrainBatchOp
    _model_cls = TargetEncoderModel
    LABEL_COL = _feat3.TargetEncoderTrainBatchOp.LABEL_COL
    POSITIVE_LABEL_VALUE_STRING = \
        _feat3.TargetEncoderTrainBatchOp.POSITIVE_LABEL_VALUE_STRING
    SMOOTHING = _feat3.TargetEncoderTrainBatchOp.SMOOTHING
    OUTPUT_COLS = HasOutputCols.OUTPUT_COLS


class MultiStringIndexerModel(ModelBase):
    _predict_op_cls = _feat3.MultiStringIndexerPredictBatchOp


class MultiStringIndexer(EstimatorBase, HasSelectedCols):
    """(reference: pipeline/dataproc/MultiStringIndexer.java)"""

    _train_op_cls = _feat3.MultiStringIndexerTrainBatchOp
    _model_cls = MultiStringIndexerModel
    STRING_ORDER_TYPE = \
        _feat3.MultiStringIndexerTrainBatchOp.STRING_ORDER_TYPE
    OUTPUT_COLS = HasOutputCols.OUTPUT_COLS


class Binarizer(TransformerBase):
    """(reference: pipeline/feature/Binarizer.java)"""

    _map_op_cls = _feat3.BinarizerBatchOp
    SELECTED_COL = HasSelectedCol.SELECTED_COL
    THRESHOLD = _feat3.BinarizerBatchOp.THRESHOLD
    OUTPUT_COL = HasOutputCol.OUTPUT_COL
    RESERVED_COLS = HasReservedCols.RESERVED_COLS


class Bucketizer(TransformerBase):
    """(reference: pipeline/feature/Bucketizer.java)"""

    _map_op_cls = _feat3.BucketizerBatchOp
    SELECTED_COLS = HasSelectedCols.SELECTED_COLS
    CUTS_ARRAY = _feat3.BucketizerBatchOp.CUTS_ARRAY
    OUTPUT_COLS = HasOutputCols.OUTPUT_COLS
    RESERVED_COLS = HasReservedCols.RESERVED_COLS


class CrossFeatureModel(ModelBase):
    _predict_op_cls = _feat4.CrossFeaturePredictBatchOp


class CrossFeature(EstimatorBase, HasSelectedCols):
    """(reference: pipeline/feature/CrossFeature.java)"""

    _train_op_cls = _feat4.CrossFeatureTrainBatchOp
    _model_cls = CrossFeatureModel
    OUTPUT_COL = HasOutputCol.OUTPUT_COL


class WoeEncoderModel(ModelBase):
    _predict_op_cls = _feat4.WoePredictBatchOp


class WoeEncoder(EstimatorBase, HasSelectedCols):
    """(reference: pipeline/finance/WoeEncoder.java)"""

    _train_op_cls = _feat4.WoeTrainBatchOp
    _model_cls = WoeEncoderModel
    LABEL_COL = _feat4.WoeTrainBatchOp.LABEL_COL
    POSITIVE_LABEL = _feat4.WoeTrainBatchOp.POSITIVE_LABEL


class NaiveBayesTextClassifierModel(ModelBase):
    _predict_op_cls = _nlp2.NaiveBayesTextPredictBatchOp


class NaiveBayesTextClassifier(EstimatorBase, _RichPredictParams):
    """(reference: pipeline/classification/NaiveBayesTextClassifier.java)"""

    _train_op_cls = _nlp2.NaiveBayesTextTrainBatchOp
    _model_cls = NaiveBayesTextClassifierModel
    VECTOR_COL = HasVectorCol.VECTOR_COL
    LABEL_COL = _nlp2.NaiveBayesTextTrainBatchOp.LABEL_COL
    MODEL_TYPE = _nlp2.NaiveBayesTextTrainBatchOp.MODEL_TYPE


class Tokenizer(TransformerBase):
    """(reference: pipeline/nlp/Tokenizer.java)"""

    _map_op_cls = _nlp.TokenizerBatchOp
    SELECTED_COL = HasSelectedCol.SELECTED_COL
    OUTPUT_COL = HasOutputCol.OUTPUT_COL
    RESERVED_COLS = HasReservedCols.RESERVED_COLS


class RegexTokenizer(TransformerBase):
    """(reference: pipeline/nlp/RegexTokenizer.java)"""

    _map_op_cls = _nlp.RegexTokenizerBatchOp
    SELECTED_COL = HasSelectedCol.SELECTED_COL
    OUTPUT_COL = HasOutputCol.OUTPUT_COL
    PATTERN = _nlp.RegexTokenizerBatchOp.PATTERN
    GAPS = _nlp.RegexTokenizerBatchOp.GAPS
    MIN_TOKEN_LENGTH = _nlp.RegexTokenizerBatchOp.MIN_TOKEN_LENGTH
    TO_LOWER_CASE = _nlp.RegexTokenizerBatchOp.TO_LOWER_CASE
    RESERVED_COLS = HasReservedCols.RESERVED_COLS


# -- the reference's generated stages -----------------------------------------
# name -> (train op, predict op, model class name), the entries of the
# reference's pipeline/generated.py ESTIMATORS table whose ops the port has
# -- recommendation ----------------------------------------------------------


class ALSModel(ModelBase):
    """transform() scores (user, item) pairs with the factor model."""

    _predict_op_cls = _rec.AlsRateRecommBatchOp


class ALS(EstimatorBase, _rec.HasRecommTripleCols):
    """(reference: pipeline/recommendation/ALS.java / AlsRateRecommender)"""

    _train_op_cls = _rec.AlsTrainBatchOp
    _model_cls = ALSModel
    RANK = _rec.AlsTrainBatchOp.RANK
    NUM_ITER = _rec.AlsTrainBatchOp.NUM_ITER
    LAMBDA = _rec.AlsTrainBatchOp.LAMBDA
    IMPLICIT_PREFS = _rec.AlsTrainBatchOp.IMPLICIT_PREFS
    ALPHA = _rec.AlsTrainBatchOp.ALPHA
    PREDICTION_COL = _rec._AlsRecommMapper.PREDICTION_COL


# -- sparse feature indexing -------------------------------------------------


class SparseFeatureIndexerModel(ModelBase):
    _predict_op_cls = _misc2.SparseFeatureIndexerPredictBatchOp


class SparseFeatureIndexer(EstimatorBase):
    """(reference: pipeline/dataproc/SparseFeatureIndexer.java)"""

    _train_op_cls = _misc2.SparseFeatureIndexerTrainBatchOp
    _model_cls = SparseFeatureIndexerModel
    SELECTED_COL = _feat2.HasSelectedCol.SELECTED_COL
    OUTPUT_COL = _feat2.HasOutputCol.OUTPUT_COL
    KV_DELIMITER = _misc2.SparseFeatureIndexerTrainBatchOp.KV_DELIMITER
    FEATURE_DELIMITER = \
        _misc2.SparseFeatureIndexerTrainBatchOp.FEATURE_DELIMITER
    MIN_FREQUENCY = _misc2.SparseFeatureIndexerTrainBatchOp.MIN_FREQUENCY


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
    "DocCountVectorizer": (_nlp.DocCountVectorizerTrainBatchOp,
                           _nlp.DocCountVectorizerPredictBatchOp,
                           "DocCountVectorizerModel"),
    "DocHashCountVectorizer": (_nlp.DocHashCountVectorizerTrainBatchOp,
                               _nlp.DocHashCountVectorizerPredictBatchOp,
                               "DocHashCountVectorizerModel"),
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
