from .base import (HasPredictionCol, HasPredictionDetailCol, HasReservedCols,
                   Mapper, ModelMapper, RichModelMapper, detail_json,
                   np_labels, softmax_np)

__all__ = [
    "HasPredictionCol", "HasPredictionDetailCol", "HasReservedCols", "Mapper",
    "ModelMapper", "RichModelMapper", "detail_json", "np_labels", "softmax_np",
]
