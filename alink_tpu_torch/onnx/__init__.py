"""Model ingestion: ONNX / torch.export / TF SavedModel → PyTorch ops on the
device (port of ``alink_tpu.onnx``).

The reference serves foreign models through three JVM plugin engines
(reference: dl_predictors/predictor-tf (SavedModelBundle), predictor-onnx
(OnnxRuntime), predictor-torch (libtorch TorchScript), behind the
DLPredictorService SPI at core/.../common/dl/plugin/DLPredictorService.java).
Each format is *imported* and its graph runs node by node as PyTorch ops on
the card (cuDNN convolutions, cuBLAS products). The converter classes are
``OnnxToTorch``, ``TorchExportToTorch`` and ``TFGraphToTorch`` (the JAX
package's ``OnnxToJax``, ``TorchToJax`` and ``TFGraphToJax``).
"""

from .proto import OnnxGraph, OnnxModel, NodeProto, TensorProto, ValueInfo
from .convert import OnnxToTorch, load_onnx_fn, supported_onnx_ops
from .torchfx import TorchExportToTorch, load_torch_fn
from .tfsaved import TFGraphToTorch, load_saved_model_fn, supported_tf_ops

__all__ = [
    "OnnxGraph", "OnnxModel", "NodeProto", "TensorProto", "ValueInfo",
    "OnnxToTorch", "load_onnx_fn", "supported_onnx_ops",
    "TorchExportToTorch", "load_torch_fn",
    "TFGraphToTorch", "load_saved_model_fn", "supported_tf_ops",
]
