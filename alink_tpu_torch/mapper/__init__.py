from .base import (HasFeatureCols, HasPredictionCol, HasPredictionDetailCol,
                   HasReservedCols, HasSelectedCols, HasVectorCol, Mapper,
                   ModelMapper, RichModelMapper, default_feature_cols,
                   detail_json, get_feature_block, merge_feature_params,
                   np_labels, resolve_feature_cols, sigmoid_np, softmax_np)

__all__ = [
    "HasFeatureCols", "HasPredictionCol", "HasPredictionDetailCol",
    "HasReservedCols", "HasSelectedCols", "HasVectorCol", "Mapper",
    "ModelMapper", "RichModelMapper", "default_feature_cols", "detail_json",
    "get_feature_block", "merge_feature_params", "np_labels",
    "resolve_feature_cols", "sigmoid_np", "softmax_np",
]
