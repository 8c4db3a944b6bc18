"""Foreign-model predict stream ops (port of
``alink_tpu.operator.stream.modelpredict``; reference:
operator/stream/onnx/OnnxModelPredictStreamOp.java,
operator/stream/pytorch/TorchModelPredictStreamOp.java,
operator/stream/tensorflow/TFSavedModelPredictStreamOp.java).

Each micro-batch runs through the same ingest mapper as the batch ops;
``StableHloModelPredictStreamOp`` raises, as its batch twin does."""

from __future__ import annotations

from ..batch.modelpredict import (
    HasIngestParams,
    OnnxModelMapper,
    StableHloModelMapper,
    TFSavedModelMapper,
    TorchModelMapper,
)
from .base import MapStreamOp


class OnnxModelPredictStreamOp(MapStreamOp, HasIngestParams):
    mapper_cls = OnnxModelMapper


class TorchModelPredictStreamOp(MapStreamOp, HasIngestParams):
    mapper_cls = TorchModelMapper


class StableHloModelPredictStreamOp(MapStreamOp, HasIngestParams):
    mapper_cls = StableHloModelMapper


class TFSavedModelPredictStreamOp(MapStreamOp, HasIngestParams):
    mapper_cls = TFSavedModelMapper
    SIGNATURE_DEF_KEY = TFSavedModelMapper.SIGNATURE_DEF_KEY
