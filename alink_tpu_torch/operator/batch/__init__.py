from .base import (AkSinkBatchOp, AkSourceBatchOp, BatchOperator,
                   TableSourceBatchOp)
from .dl import (BertTextClassifierPredictBatchOp, BertTextModelMapper,
                 BertTextRegressorPredictBatchOp)
from .utils import ModelMapBatchOp, ModelTrainOpMixin

__all__ = [
    "AkSinkBatchOp", "AkSourceBatchOp", "BatchOperator", "TableSourceBatchOp",
    "BertTextClassifierPredictBatchOp", "BertTextModelMapper",
    "BertTextRegressorPredictBatchOp", "ModelMapBatchOp", "ModelTrainOpMixin",
]
