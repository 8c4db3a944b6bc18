from ..sql import (DistinctOp, FilterOp, GroupByOp, IntersectOp, JoinOp,
                   MinusAllOp, MinusOp, OrderByOp, RenameOp, SampleOp,
                   SelectOp, UnionAllOp, UnionOp)
from .base import (AkSinkBatchOp, AkSourceBatchOp, BatchOperator,
                   CsvSinkBatchOp, CsvSourceBatchOp, FirstNBatchOp,
                   MemSourceBatchOp, NumSeqSourceBatchOp,
                   RandomTableSourceBatchOp, ShuffleBatchOp, SplitBatchOp,
                   TableSourceBatchOp)
from ..sqlengine import (JdbcSinkBatchOp, JdbcSourceBatchOp, SqliteCatalog,
                         SqlQueryBatchOp, sql_query)


# Reference-style names for the SQL sugar ops (reference: operator/batch/sql/*.java)
class SelectBatchOp(SelectOp, BatchOperator):
    pass


class WhereBatchOp(FilterOp, BatchOperator):
    pass


class FilterBatchOp(FilterOp, BatchOperator):
    pass


class DistinctBatchOp(DistinctOp, BatchOperator):
    pass


class OrderByBatchOp(OrderByOp, BatchOperator):
    pass


class GroupByBatchOp(GroupByOp, BatchOperator):
    pass


class UnionAllBatchOp(UnionAllOp, BatchOperator):
    pass


class UnionBatchOp(UnionOp, BatchOperator):
    pass


class IntersectBatchOp(IntersectOp, BatchOperator):
    pass


class MinusBatchOp(MinusOp, BatchOperator):
    pass


class JoinBatchOp(JoinOp, BatchOperator):
    pass


class SampleBatchOp(SampleOp, BatchOperator):
    pass

from .clustering import (GeoKMeansPredictBatchOp, GeoKMeansTrainBatchOp,
                         KMeansModelInfoBatchOp, KMeansModelMapper,
                         KMeansPredictBatchOp, KMeansTrainBatchOp)
from .dl import (BaseBertTextTrainBatchOp, BaseKerasSequentialTrainBatchOp,
                 BertTextClassifierPredictBatchOp,
                 BertTextClassifierTrainBatchOp, BertTextEmbeddingBatchOp,
                 BertTextEmbeddingMapper, BertTextModelMapper,
                 BertTextPairClassifierPredictBatchOp,
                 BertTextPairClassifierTrainBatchOp,
                 BertTextPairRegressorPredictBatchOp,
                 BertTextPairRegressorTrainBatchOp,
                 BertTextRegressorPredictBatchOp, BertTextRegressorTrainBatchOp,
                 KerasSequentialClassifierPredictBatchOp,
                 KerasSequentialClassifierTrainBatchOp,
                 KerasSequentialModelMapper,
                 KerasSequentialRegressorPredictBatchOp,
                 KerasSequentialRegressorTrainBatchOp)
from .huge import (DeepWalkBatchOp, DeepWalkEmbeddingBatchOp,
                   Node2VecEmbeddingBatchOp, Node2VecWalkBatchOp,
                   RandomWalkBatchOp, Word2VecModelMapper,
                   Word2VecPredictBatchOp, Word2VecTrainBatchOp)
from .modelpredict import (HasIngestParams, OnnxModelMapper,
                           OnnxModelPredictBatchOp, StableHloModelMapper,
                           StableHloModelPredictBatchOp, TFSavedModelMapper,
                           TFSavedModelPredictBatchOp, TorchModelMapper,
                           TorchModelPredictBatchOp)
from .tree import (C45EncoderTrainBatchOp, C45PredictBatchOp,
                   C45TrainBatchOp, CartEncoderTrainBatchOp,
                   CartPredictBatchOp, CartRegEncoderTrainBatchOp,
                   CartRegPredictBatchOp, CartRegTrainBatchOp,
                   CartTrainBatchOp, DecisionTreeEncoderTrainBatchOp,
                   DecisionTreePredictBatchOp, DecisionTreeRegEncoderTrainBatchOp,
                   DecisionTreeRegPredictBatchOp,
                   DecisionTreeRegTrainBatchOp, DecisionTreeTrainBatchOp,
                   GbdtEncoderBatchOp, GbdtEncoderMapper,
                   GbdtEncoderPredictBatchOp, GbdtEncoderTrainBatchOp,
                   GbdtPredictBatchOp, GbdtRegEncoderTrainBatchOp,
                   GbdtRegPredictBatchOp, GbdtRegTrainBatchOp,
                   GbdtTrainBatchOp, Id3EncoderTrainBatchOp,
                   Id3PredictBatchOp, Id3TrainBatchOp,
                   RandomForestEncoderTrainBatchOp,
                   RandomForestPredictBatchOp,
                   RandomForestRegEncoderTrainBatchOp,
                   RandomForestRegPredictBatchOp,
                   RandomForestRegTrainBatchOp, RandomForestTrainBatchOp,
                   TreeModelEncoderBatchOp, TreeModelMapper)
from .linear import (BaseLinearModelTrainBatchOp, LassoRegPredictBatchOp,
                     LassoRegTrainBatchOp, LinearModelMapper,
                     LinearModelPredictOp, LinearRegPredictBatchOp,
                     LinearRegTrainBatchOp, LinearSvmPredictBatchOp,
                     LinearSvmTrainBatchOp, LinearSvrPredictBatchOp,
                     LinearSvrTrainBatchOp, LogisticRegressionPredictBatchOp,
                     LogisticRegressionTrainBatchOp, RidgeRegPredictBatchOp,
                     RidgeRegTrainBatchOp, SoftmaxPredictBatchOp,
                     SoftmaxTrainBatchOp)
from .classification import (BaseFmTrainBatchOp, FmClassifierPredictBatchOp,
                             FmClassifierTrainBatchOp, FmModelMapper,
                             FmPredictBatchOp, FmRegressorPredictBatchOp,
                             FmRegressorTrainBatchOp, KnnModelMapper,
                             KnnPredictBatchOp, KnnRegModelMapper,
                             KnnRegPredictBatchOp, KnnRegTrainBatchOp,
                             KnnTrainBatchOp, MlpModelMapper,
                             MultilayerPerceptronPredictBatchOp,
                             MultilayerPerceptronTrainBatchOp,
                             NaiveBayesModelMapper, NaiveBayesPredictBatchOp,
                             NaiveBayesTrainBatchOp, OneVsRestModelMapper,
                             OneVsRestPredictBatchOp, OneVsRestTrainBatchOp)
from .evaluation import (BaseEvalBatchOp, EvalBinaryClassBatchOp,
                         EvalClusterBatchOp, EvalMultiClassBatchOp,
                         EvalMultiLabelBatchOp, EvalRankingBatchOp,
                         EvalRegressionBatchOp, Metrics)
from .regression import (AftSurvivalRegModelMapper,
                         AftSurvivalRegPredictBatchOp,
                         AftSurvivalRegTrainBatchOp, GlmModelMapper,
                         GlmPredictBatchOp, GlmTrainBatchOp,
                         IsotonicRegModelMapper, IsotonicRegPredictBatchOp,
                         IsotonicRegTrainBatchOp,
                         StepwiseLinearRegTrainBatchOp)
from .sources import (LibSvmSinkBatchOp, LibSvmSourceBatchOp,
                      ParquetSinkBatchOp, ParquetSourceBatchOp,
                      TextSourceBatchOp, TFRecordSinkBatchOp,
                      TFRecordSourceBatchOp, TsvSinkBatchOp, TsvSourceBatchOp,
                      XlsSourceBatchOp)
from .statistics import (ChiSquareTestBatchOp, CorrelationBatchOp,
                         CorrelationResult, CovarianceBatchOp,
                         QuantileBatchOp, SummarizerBatchOp,
                         VectorChiSquareTestBatchOp, VectorCorrelationBatchOp,
                         VectorSummarizerBatchOp)
from .utils import MapBatchOp, ModelMapBatchOp, ModelTrainOpMixin

__all__ = [
    "AkSinkBatchOp", "AkSourceBatchOp", "BatchOperator", "CsvSinkBatchOp",
    "CsvSourceBatchOp", "FirstNBatchOp", "MemSourceBatchOp",
    "NumSeqSourceBatchOp", "RandomTableSourceBatchOp", "ShuffleBatchOp",
    "SplitBatchOp", "TableSourceBatchOp",
    "DistinctOp", "FilterOp", "GroupByOp", "IntersectOp", "JoinOp",
    "MinusAllOp", "MinusOp", "OrderByOp", "RenameOp", "SampleOp", "SelectOp",
    "UnionAllOp", "UnionOp", "SelectBatchOp", "WhereBatchOp",
    "FilterBatchOp", "DistinctBatchOp", "OrderByBatchOp", "GroupByBatchOp",
    "UnionAllBatchOp", "UnionBatchOp", "IntersectBatchOp", "MinusBatchOp",
    "JoinBatchOp", "SampleBatchOp",
    "JdbcSinkBatchOp", "JdbcSourceBatchOp", "SqliteCatalog",
    "SqlQueryBatchOp", "sql_query",
    "GeoKMeansPredictBatchOp", "GeoKMeansTrainBatchOp",
    "KMeansModelInfoBatchOp", "KMeansModelMapper", "KMeansPredictBatchOp",
    "KMeansTrainBatchOp",
    "BaseLinearModelTrainBatchOp", "LassoRegPredictBatchOp",
    "LassoRegTrainBatchOp", "LinearModelMapper", "LinearModelPredictOp",
    "LinearRegPredictBatchOp", "LinearRegTrainBatchOp",
    "LinearSvmPredictBatchOp", "LinearSvmTrainBatchOp",
    "LinearSvrPredictBatchOp", "LinearSvrTrainBatchOp",
    "LogisticRegressionPredictBatchOp", "LogisticRegressionTrainBatchOp",
    "RidgeRegPredictBatchOp", "RidgeRegTrainBatchOp",
    "SoftmaxPredictBatchOp", "SoftmaxTrainBatchOp",
    "BaseBertTextTrainBatchOp", "BertTextClassifierPredictBatchOp",
    "BertTextClassifierTrainBatchOp", "BertTextEmbeddingBatchOp",
    "BertTextEmbeddingMapper", "BertTextModelMapper",
    "BertTextPairClassifierPredictBatchOp",
    "BertTextPairClassifierTrainBatchOp",
    "BertTextPairRegressorPredictBatchOp",
    "BertTextPairRegressorTrainBatchOp", "BertTextRegressorPredictBatchOp",
    "BertTextRegressorTrainBatchOp", "DecisionTreePredictBatchOp",
    "DeepWalkBatchOp", "DeepWalkEmbeddingBatchOp", "Node2VecEmbeddingBatchOp",
    "Node2VecWalkBatchOp", "RandomWalkBatchOp", "Word2VecModelMapper",
    "Word2VecPredictBatchOp", "Word2VecTrainBatchOp",
    "DecisionTreeRegPredictBatchOp", "DecisionTreeRegTrainBatchOp",
    "DecisionTreeTrainBatchOp", "GbdtPredictBatchOp", "GbdtRegPredictBatchOp",
    "GbdtRegTrainBatchOp", "GbdtTrainBatchOp", "ModelMapBatchOp",
    "ModelTrainOpMixin", "RandomForestPredictBatchOp",
    "RandomForestRegPredictBatchOp", "RandomForestRegTrainBatchOp",
    "RandomForestTrainBatchOp", "TreeModelMapper",
    "BaseKerasSequentialTrainBatchOp",
    "KerasSequentialClassifierPredictBatchOp",
    "KerasSequentialClassifierTrainBatchOp", "KerasSequentialModelMapper",
    "KerasSequentialRegressorPredictBatchOp",
    "KerasSequentialRegressorTrainBatchOp",
    "C45EncoderTrainBatchOp", "C45PredictBatchOp", "C45TrainBatchOp",
    "CartEncoderTrainBatchOp", "CartPredictBatchOp",
    "CartRegEncoderTrainBatchOp", "CartRegPredictBatchOp",
    "CartRegTrainBatchOp", "CartTrainBatchOp",
    "DecisionTreeEncoderTrainBatchOp", "DecisionTreeRegEncoderTrainBatchOp",
    "GbdtEncoderBatchOp", "GbdtEncoderMapper", "GbdtEncoderPredictBatchOp",
    "GbdtEncoderTrainBatchOp", "GbdtRegEncoderTrainBatchOp",
    "Id3EncoderTrainBatchOp", "Id3PredictBatchOp", "Id3TrainBatchOp",
    "RandomForestEncoderTrainBatchOp", "RandomForestRegEncoderTrainBatchOp",
    "TreeModelEncoderBatchOp",
    "HasIngestParams", "MapBatchOp", "OnnxModelMapper",
    "OnnxModelPredictBatchOp", "StableHloModelMapper",
    "StableHloModelPredictBatchOp", "TFSavedModelMapper",
    "TFSavedModelPredictBatchOp", "TorchModelMapper",
    "TorchModelPredictBatchOp",
    "BaseFmTrainBatchOp", "FmClassifierPredictBatchOp",
    "FmClassifierTrainBatchOp", "FmModelMapper", "FmPredictBatchOp",
    "FmRegressorPredictBatchOp", "FmRegressorTrainBatchOp", "KnnModelMapper",
    "KnnPredictBatchOp", "KnnRegModelMapper", "KnnRegPredictBatchOp",
    "KnnRegTrainBatchOp", "KnnTrainBatchOp", "MlpModelMapper",
    "MultilayerPerceptronPredictBatchOp", "MultilayerPerceptronTrainBatchOp",
    "NaiveBayesModelMapper", "NaiveBayesPredictBatchOp",
    "NaiveBayesTrainBatchOp", "OneVsRestModelMapper",
    "OneVsRestPredictBatchOp", "OneVsRestTrainBatchOp",
    "BaseEvalBatchOp", "EvalBinaryClassBatchOp", "EvalClusterBatchOp",
    "EvalMultiClassBatchOp", "EvalMultiLabelBatchOp", "EvalRankingBatchOp",
    "EvalRegressionBatchOp", "Metrics",
    "AftSurvivalRegModelMapper", "AftSurvivalRegPredictBatchOp",
    "AftSurvivalRegTrainBatchOp", "GlmModelMapper", "GlmPredictBatchOp",
    "GlmTrainBatchOp", "IsotonicRegModelMapper", "IsotonicRegPredictBatchOp",
    "IsotonicRegTrainBatchOp", "StepwiseLinearRegTrainBatchOp",
    "LibSvmSinkBatchOp", "LibSvmSourceBatchOp", "ParquetSinkBatchOp",
    "ParquetSourceBatchOp", "TextSourceBatchOp", "TFRecordSinkBatchOp",
    "TFRecordSourceBatchOp", "TsvSinkBatchOp", "TsvSourceBatchOp",
    "XlsSourceBatchOp",
    "ChiSquareTestBatchOp", "CorrelationBatchOp", "CorrelationResult",
    "CovarianceBatchOp", "QuantileBatchOp", "SummarizerBatchOp",
    "VectorChiSquareTestBatchOp", "VectorCorrelationBatchOp",
    "VectorSummarizerBatchOp",
]
from .clustering2 import (AgnesBatchOp, BisectingKMeansPredictBatchOp,
                          BisectingKMeansTrainBatchOp, DbscanBatchOp,
                          GmmModelMapper, GmmPredictBatchOp, GmmTrainBatchOp,
                          GroupDbscanBatchOp, GroupEmBatchOp,
                          GroupGeoDbscanBatchOp, GroupGeoDbscanModelBatchOp,
                          GroupKMeansBatchOp, KModesPredictBatchOp,
                          KModesTrainBatchOp, LdaModelMapper,
                          LdaPredictBatchOp, LdaTrainBatchOp,
                          SomPredictBatchOp, SomTrainBatchOp)
from .dataproc import (HugeMultiStringIndexerPredictBatchOp,
                       HugeStringIndexerPredictBatchOp, ImputerPredictBatchOp,
                       ImputerTrainBatchOp, JsonValueBatchOp, LookupBatchOp,
                       OverWindowBatchOp, RebalanceBatchOp,
                       StratifiedSampleBatchOp, StringIndexerPredictBatchOp,
                       StringIndexerTrainBatchOp, TypeConvertBatchOp,
                       WeightSampleBatchOp)
from .feature import (MinMaxScalerPredictBatchOp, MinMaxScalerTrainBatchOp,
                      StandardScalerPredictBatchOp, StandardScalerTrainBatchOp,
                      VectorAssemblerBatchOp)
from .feature2 import (AutoCrossBatchOp, AutoCrossPredictBatchOp,
                       BinningPredictBatchOp, BinningTrainBatchOp,
                       ChiSqSelectorBatchOp, ChiSqSelectorPredictBatchOp,
                       DCTBatchOp, EqualWidthDiscretizerPredictBatchOp,
                       EqualWidthDiscretizerTrainBatchOp, FeatureHasherBatchOp,
                       MaxAbsScalerPredictBatchOp, MaxAbsScalerTrainBatchOp,
                       OneHotPredictBatchOp, OneHotTrainBatchOp,
                       PcaPredictBatchOp, PcaTrainBatchOp,
                       QuantileDiscretizerPredictBatchOp,
                       QuantileDiscretizerTrainBatchOp)
from .feature3 import (BinarizerBatchOp, BucketizerBatchOp,
                       ExclusiveFeatureBundlePredictBatchOp,
                       ExclusiveFeatureBundleTrainBatchOp,
                       IndexToStringPredictBatchOp, MultiHotPredictBatchOp,
                       MultiHotTrainBatchOp, MultiStringIndexerPredictBatchOp,
                       MultiStringIndexerTrainBatchOp,
                       TargetEncoderPredictBatchOp, TargetEncoderTrainBatchOp)
from .vector import (ColumnsToVectorBatchOp, UdfBatchOp, UdtfBatchOp,
                     VectorElementwiseProductBatchOp, VectorImputerPredictBatchOp,
                     VectorImputerTrainBatchOp, VectorInteractionBatchOp,
                     VectorMaxAbsScalerPredictBatchOp,
                     VectorMaxAbsScalerTrainBatchOp,
                     VectorMinMaxScalerPredictBatchOp,
                     VectorMinMaxScalerTrainBatchOp, VectorNormalizeBatchOp,
                     VectorSliceBatchOp, VectorStandardScalerPredictBatchOp,
                     VectorStandardScalerTrainBatchOp, VectorToColumnsBatchOp)
from .vector2 import (VectorBiFunctionBatchOp, VectorChiSqSelectorBatchOp,
                      VectorFunctionBatchOp, VectorPolynomialExpandBatchOp,
                      VectorSizeHintBatchOp)
from .graph import (CommonNeighborsBatchOp, CommunityDetectionClusterBatchOp,
                    ConnectedComponentsBatchOp,
                    EdgeClusterCoefficientBatchOp, KCoreBatchOp,
                    LouvainBatchOp, ModularityCalBatchOp,
                    MultiSourceShortestPathBatchOp, PageRankBatchOp,
                    SingleSourceShortestPathBatchOp, TreeDepthBatchOp,
                    TriangleListBatchOp, VertexClusterCoefficientBatchOp,
                    VertexNeighborSearchBatchOp)
from .associationrule import (AprioriBatchOp, FpGrowthBatchOp,
                              PrefixSpanBatchOp)
from .similarity import (StringNearestNeighborPredictBatchOp,
                         StringNearestNeighborTrainBatchOp,
                         StringSimilarityPairwiseBatchOp,
                         TextNearestNeighborPredictBatchOp,
                         TextNearestNeighborTrainBatchOp,
                         TextSimilarityPairwiseBatchOp,
                         VectorNearestNeighborPredictBatchOp,
                         VectorNearestNeighborTrainBatchOp)
from .feature4 import (ApplyAssociationRuleBatchOp, ApplySequenceRuleBatchOp,
                       AutoCrossAlgoTrainBatchOp, AutoCrossTrainBatchOp,
                       BaseCrossTrainBatchOp, BinarySelectorPredictBatchOp,
                       BinarySelectorTrainBatchOp,
                       BinningTrainForScorecardBatchOp,
                       ConstrainedBinarySelectorPredictBatchOp,
                       ConstrainedBinarySelectorTrainBatchOp,
                       ConstrainedDivergenceTrainBatchOp,
                       ConstrainedLinearRegTrainBatchOp,
                       ConstrainedLogisticRegressionTrainBatchOp,
                       ConstrainedRegSelectorPredictBatchOp,
                       ConstrainedRegSelectorTrainBatchOp,
                       CrossCandidateSelectorPredictBatchOp,
                       CrossCandidateSelectorTrainBatchOp,
                       CrossFeaturePredictBatchOp, CrossFeatureTrainBatchOp,
                       GlmEvaluationBatchOp, GroupedFpGrowthBatchOp,
                       HashCrossFeatureBatchOp, MultiCollinearityBatchOp,
                       RegressionSelectorPredictBatchOp,
                       RegressionSelectorTrainBatchOp, WoePredictBatchOp,
                       WoeTrainBatchOp)
from .nlp import (DocCountVectorizerPredictBatchOp,
                  DocCountVectorizerTrainBatchOp, DocHashCountVectorizerPredictBatchOp,
                  DocHashCountVectorizerTrainBatchOp, DocWordCountBatchOp,
                  KeywordsExtractionBatchOp, NGramBatchOp,
                  RegexTokenizerBatchOp, SegmentBatchOp,
                  StopWordsRemoverBatchOp, TfidfBatchOp, TokenizerBatchOp,
                  WordCountBatchOp)
from .nlp2 import (NaiveBayesTextPredictBatchOp, NaiveBayesTextTrainBatchOp,
                   StringApproxNearestNeighborPredictBatchOp,
                   StringApproxNearestNeighborTrainBatchOp,
                   TextApproxNearestNeighborPredictBatchOp,
                   TextApproxNearestNeighborTrainBatchOp,
                   VectorApproxNearestNeighborPredictBatchOp,
                   VectorApproxNearestNeighborTrainBatchOp)
from .recommendation import (AlsItemsPerUserRecommBatchOp,
                             AlsRateRecommBatchOp,
                             AlsSimilarItemsRecommBatchOp, AlsTrainBatchOp,
                             AlsUsersPerItemRecommBatchOp,
                             DeepFmItemsPerUserRecommBatchOp,
                             DeepFmRateRecommBatchOp,
                             DeepFmRecommTrainBatchOp,
                             FmItemsPerUserRecommBatchOp,
                             FmRateRecommBatchOp, FmRecommTrainBatchOp,
                             FmUsersPerItemRecommBatchOp,
                             ItemCfItemsPerUserRecommBatchOp,
                             ItemCfRateRecommBatchOp,
                             ItemCfSimilarItemsRecommBatchOp,
                             ItemCfTrainBatchOp, LeaveKObjectOutBatchOp,
                             LeaveTopKObjectOutBatchOp,
                             SwingSimilarItemsRecommBatchOp,
                             SwingTrainBatchOp, UserCfRateRecommBatchOp,
                             UserCfTrainBatchOp)
from .recommendation2 import (AlsForHotPointTrainBatchOp,
                              AlsImplicitForHotPointTrainBatchOp,
                              AlsImplicitTrainBatchOp,
                              AlsSimilarUsersRecommBatchOp,
                              FmRecommBinaryImplicitTrainBatchOp,
                              ItemCfUsersPerItemRecommBatchOp, MfAlsBatchOp,
                              MfAlsForHotPointBatchOp,
                              NegativeItemSamplingBatchOp, RankingListBatchOp,
                              RecommendationRankingBatchOp,
                              SwingRecommBatchOp,
                              UserCfItemsPerUserRecommBatchOp,
                              UserCfSimilarUsersRecommBatchOp,
                              UserCfUsersPerItemRecommBatchOp,
                              VecDotItemsPerUserRecommBatchOp,
                              VecDotModelGeneratorBatchOp)
from .outlier import (BoxPlotOutlier4GroupedDataBatchOp, BoxPlotOutlierBatchOp,
                      CooksDistanceOutlierBatchOp,
                      CopodOutlier4GroupedDataBatchOp, CopodOutlierBatchOp,
                      DbscanModelOutlierPredictBatchOp,
                      DbscanOutlier4GroupedDataBatchOp, DbscanOutlierBatchOp,
                      DbscanPredictBatchOp, DynamicTimeWarpOutlierBatchOp,
                      EcodOutlier4GroupedDataBatchOp, EcodOutlierBatchOp,
                      EsdOutlier4GroupedDataBatchOp, EsdOutlierBatchOp,
                      EvalOutlierBatchOp, GroupDbscanModelBatchOp,
                      HbosOutlier4GroupedDataBatchOp, HbosOutlierBatchOp,
                      IForestModelOutlierPredictBatchOp,
                      IForestModelOutlierTrainBatchOp,
                      IForestOutlier4GroupedDataBatchOp,
                      IForestOutlierBatchOp,
                      KSigmaOutlier4GroupedDataBatchOp, KSigmaOutlierBatchOp,
                      KdeOutlier4GroupedDataBatchOp, KdeOutlierBatchOp,
                      LofOutlier4GroupedDataBatchOp, LofOutlierBatchOp,
                      MadOutlier4GroupedDataBatchOp, MadOutlierBatchOp,
                      OcsvmModelOutlierPredictBatchOp,
                      OcsvmModelOutlierTrainBatchOp,
                      OcsvmOutlier4GroupedDataBatchOp, OcsvmOutlierBatchOp,
                      SHEsdOutlierBatchOp, ShEsdOutlier4GroupedDataBatchOp,
                      ShEsdOutlierBatchOp, SosOutlier4GroupedDataBatchOp,
                      SosOutlierBatchOp)
from .utils2 import (AppendIdBatchOp, AppendModelStreamFileSinkBatchOp,
                     DummySinkBatchOp, FlattenMTableBatchOp,
                     GroupDataToMTableBatchOp, TextSinkBatchOp)
from .finance import (GroupScorecardPredictBatchOp, GroupScorecardTrainBatchOp,
                      PsiBatchOp, ScorecardPredictBatchOp,
                      ScorecardTrainBatchOp)
from .misc2 import (AddressParserBatchOp, BaseFormatTransBatchOp,
                    BaseNearestNeighborTrainBatchOp, BaseRecommBatchOp,
                    BaseSinkBatchOp, BaseSourceBatchOp, BaseSqlApiBatchOp,
                    PSIBatchOp, SomBatchOp, SparseFeatureIndexerPredictBatchOp,
                    SparseFeatureIndexerTrainBatchOp)
from .timeseries import (ArimaBatchOp, AutoArimaBatchOp, DeepARBatchOp,
                         DifferenceBatchOp, EvalTimeSeriesBatchOp,
                         GarchBatchOp, HoltWintersBatchOp, LSTNetBatchOp,
                         ProphetBatchOp, ShiftBatchOp, TFTBatchOp)
from .timeseries2 import (AutoGarchBatchOp, DeepARPredictBatchOp,
                          DeepARTrainBatchOp, LSTNetPredictBatchOp,
                          LSTNetTrainBatchOp, LookupRecentDaysBatchOp,
                          LookupValueInTimeSeriesBatchOp,
                          LookupVectorInTimeSeriesBatchOp,
                          ProphetPredictBatchOp, ProphetTrainBatchOp)
from .huge import LineBatchOp, MetaPath2VecBatchOp, MetaPathWalkBatchOp
from .windowfe import (GenerateFeatureOfLatestBatchOp,
                       GenerateFeatureOfLatestNDaysBatchOp,
                       GenerateFeatureOfWindowBatchOp)
from .relational2 import (AsBatchOp, DataSetWrapperBatchOp,
                          FullOuterJoinBatchOp, IntersectAllBatchOp,
                          LeftOuterJoinBatchOp, MinusAllBatchOp, PrintBatchOp,
                          RandomVectorSourceBatchOp, RightOuterJoinBatchOp,
                          SampleWithSizeBatchOp,
                          StratifiedSampleWithSizeBatchOp)
from .graph2 import (CommunityDetectionClassifyBatchOp,
                     HugeDeepWalkTrainBatchOp, HugeIndexerStringPredictBatchOp,
                     HugeLabeledWord2VecTrainBatchOp, HugeLookupBatchOp,
                     HugeMetaPath2VecTrainBatchOp,
                     HugeMultiIndexerStringPredictBatchOp,
                     HugeNode2VecTrainBatchOp, HugeWord2VecTrainBatchOp,
                     IndexToNodeBatchOp, MdsBatchOp, Node2VecBatchOp,
                     NodeIndexerTrainBatchOp, NodeToIndexBatchOp,
                     RiskAlikeBuildGraphBatchOp, SimrankBatchOp)
from .media import (ExtractMfccFeatureBatchOp, ReadAudioToTensorBatchOp,
                    ReadImageToTensorBatchOp)
from .insights import AutoDiscoveryBatchOp
from .xgboost import XGBoostPredictBatchOp, XGBoostTrainBatchOp
from .connectors import KvSinkBatchOp, LookupKvBatchOp
from . import modelinfo as _modelinfo
from .modelinfo import *  # noqa: F401,F403 — ModelInfo family
from . import format as _format
from .format import *  # noqa: F401,F403 — format conversion family
from .tensorops import (MTableSerializeBatchOp, TensorReshapeBatchOp,
                        TensorSerializeBatchOp, TensorToVectorBatchOp,
                        ToMTableBatchOp, ToTensorBatchOp, ToVectorBatchOp,
                        VectorSerializeBatchOp, VectorToTensorBatchOp)
from .udf2 import (BaseGroupPandasUdfBatchOp, BasePandasUdfBatchOp,
                   BasePyScalarFnBatchOp, BasePyTableFnBatchOp,
                   FlatMapBatchOp, FlatModelMapBatchOp, FlattenKObjectBatchOp,
                   GroupPandasFileUdfBatchOp, GroupPandasUdfBatchOp,
                   GroupRBatchOp, PandasUdfBatchOp, PandasUdfFileBatchOp,
                   PyFileScalarFnBatchOp, PyFileTableFnBatchOp,
                   PyScalarFnBatchOp, PyTableFnBatchOp, RUdfBatchOp,
                   UDFBatchOp, UDTFBatchOp)
from .script import JaxScriptBatchOp
from .io2 import (AggLookupBatchOp, CatalogSinkBatchOp, CatalogSourceBatchOp,
                  HBaseSinkBatchOp, InternalFullStatsBatchOp,
                  LinearRegStepwisePredictBatchOp,
                  LinearRegStepwiseTrainBatchOp, LookupHBaseBatchOp,
                  LookupRedisRowBatchOp, LookupRedisStringBatchOp,
                  RedisRowSinkBatchOp, RedisStringSinkBatchOp,
                  TF2TableModelTrainBatchOp, TFRecordDatasetSinkBatchOp,
                  TFRecordDatasetSourceBatchOp,
                  TFTableModelClassifierPredictBatchOp,
                  TFTableModelClassifierTrainBatchOp,
                  TFTableModelPredictBatchOp,
                  TFTableModelRegressorPredictBatchOp,
                  TFTableModelRegressorTrainBatchOp, TFTableModelTrainBatchOp,
                  TensorFlow2BatchOp, TensorFlowBatchOp,
                  WriteTensorToImageBatchOp, XGBoostRegPredictBatchOp,
                  XGBoostRegTrainBatchOp, XlsSinkBatchOp)
