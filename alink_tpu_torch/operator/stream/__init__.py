"""Stream operator layer — micro-batch streaming runtime (the core and the
foreign-model predict ops; the rest of ``alink_tpu.operator.stream`` is
ROADMAP A7)."""

from .base import (
    CsvSourceStreamOp,
    MapStreamOp,
    ModelMapStreamOp,
    StreamOperator,
    TableSourceStreamOp,
)
from .modelpredict import (
    OnnxModelPredictStreamOp,
    StableHloModelPredictStreamOp,
    TFSavedModelPredictStreamOp,
    TorchModelPredictStreamOp,
)

__all__ = [
    "CsvSourceStreamOp",
    "MapStreamOp",
    "ModelMapStreamOp",
    "StreamOperator",
    "TableSourceStreamOp",
    "OnnxModelPredictStreamOp",
    "StableHloModelPredictStreamOp",
    "TFSavedModelPredictStreamOp",
    "TorchModelPredictStreamOp",
]
