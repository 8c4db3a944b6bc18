from .base import (AkSinkBatchOp, AkSourceBatchOp, BatchOperator,
                   TableSourceBatchOp)
from .dl import (BertTextClassifierPredictBatchOp, BertTextModelMapper,
                 BertTextRegressorPredictBatchOp)
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
    "BertTextClassifierPredictBatchOp", "BertTextModelMapper",
    "BertTextRegressorPredictBatchOp", "DecisionTreePredictBatchOp",
    "DecisionTreeRegPredictBatchOp", "DecisionTreeRegTrainBatchOp",
    "DecisionTreeTrainBatchOp", "GbdtPredictBatchOp", "GbdtRegPredictBatchOp",
    "GbdtRegTrainBatchOp", "GbdtTrainBatchOp", "ModelMapBatchOp",
    "ModelTrainOpMixin", "RandomForestPredictBatchOp",
    "RandomForestRegPredictBatchOp", "RandomForestRegTrainBatchOp",
    "RandomForestTrainBatchOp", "TreeModelMapper",
]
