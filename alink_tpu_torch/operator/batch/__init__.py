from .base import (AkSinkBatchOp, AkSourceBatchOp, BatchOperator,
                   TableSourceBatchOp)
from .dl import (BaseBertTextTrainBatchOp, BertTextClassifierPredictBatchOp,
                 BertTextClassifierTrainBatchOp, BertTextModelMapper,
                 BertTextPairClassifierTrainBatchOp,
                 BertTextRegressorPredictBatchOp, BertTextRegressorTrainBatchOp)
from .huge import (DeepWalkBatchOp, DeepWalkEmbeddingBatchOp,
                   Node2VecEmbeddingBatchOp, Node2VecWalkBatchOp,
                   RandomWalkBatchOp, Word2VecModelMapper,
                   Word2VecPredictBatchOp, Word2VecTrainBatchOp)
from .tree import (DecisionTreePredictBatchOp, DecisionTreeRegPredictBatchOp,
                   DecisionTreeRegTrainBatchOp, DecisionTreeTrainBatchOp,
                   GbdtPredictBatchOp, GbdtRegPredictBatchOp,
                   GbdtRegTrainBatchOp, GbdtTrainBatchOp,
                   RandomForestPredictBatchOp, RandomForestRegPredictBatchOp,
                   RandomForestRegTrainBatchOp, RandomForestTrainBatchOp,
                   TreeModelMapper)
from .utils import ModelMapBatchOp, ModelTrainOpMixin

__all__ = [
    "AkSinkBatchOp", "AkSourceBatchOp", "BatchOperator", "TableSourceBatchOp",
    "BaseBertTextTrainBatchOp", "BertTextClassifierPredictBatchOp",
    "BertTextClassifierTrainBatchOp", "BertTextModelMapper",
    "BertTextPairClassifierTrainBatchOp", "BertTextRegressorPredictBatchOp",
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
]
