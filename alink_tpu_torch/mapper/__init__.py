from .base import (BlockKernelMapper, FusedMapperChain, HasFeatureCols,
                   HasOutputCol, HasOutputCols, HasPredictionCol,
                   HasPredictionDetailCol, HasReservedCols, HasSelectedCol,
                   HasSelectedCols, HasVectorCol, Mapper, MapperChain,
                   ModelMapper, RichModelMapper, SISOMapper,
                   default_feature_cols, detail_json, get_feature_block,
                   merge_feature_params, np_labels, resolve_feature_cols,
                   run_kernel_chain, sigmoid_np, softmax_np)

__all__ = [
    "BlockKernelMapper", "FusedMapperChain", "HasFeatureCols",
    "HasOutputCol", "HasOutputCols", "HasPredictionCol",
    "HasPredictionDetailCol", "HasReservedCols", "HasSelectedCol",
    "HasSelectedCols", "HasVectorCol", "Mapper", "MapperChain",
    "ModelMapper", "RichModelMapper", "SISOMapper", "default_feature_cols",
    "detail_json", "get_feature_block", "merge_feature_params", "np_labels",
    "resolve_feature_cols", "run_kernel_chain", "sigmoid_np", "softmax_np",
]
