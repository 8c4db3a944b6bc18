"""Pipeline API — scikit-style Estimator/Transformer/Model over operators
(port of ``alink_tpu.pipeline.base``).

Capability parity with the reference's pipeline layer (reference:
core/src/main/java/com/alibaba/alink/pipeline/Pipeline.java:30,
PipelineModel.java:48, EstimatorBase/TransformerBase/ModelBase, Trainer.java:42
— Trainer.fit reflects to <Xxx>TrainBatchOp at :135-171 and wraps rows in a
MapModel; persistence via ModelExporterUtils.java:558,1118 packs all stage
models into ONE table saved as .ak).

Re-design keeps the exact user contract (fit/transform chains, one-file
pipeline model, LocalPredictor serving) over the columnar operator layer;
stage→op binding is explicit class attributes instead of name reflection.
Stages register by class name, under the reference's names, so a pipeline
model saved by either package loads in the other.
"""

from __future__ import annotations

from typing import Dict, Optional, Type

from ..common.exceptions import AkIllegalArgumentException, AkIllegalStateException
from ..common.mtable import MTable
from ..common.params import WithParams
from ..operator.base import AlgoOperator
from ..operator.batch.base import TableSourceBatchOp

# class-name → stage class, for pipeline model loading
STAGE_REGISTRY: Dict[str, type] = {}


class PipelineStageBase(WithParams):
    """Base of Estimator/Transformer/Model stages."""

    def __init_subclass__(cls, **kw):
        super().__init_subclass__(**kw)
        STAGE_REGISTRY[cls.__name__] = cls

    @staticmethod
    def _as_op(data) -> AlgoOperator:
        if isinstance(data, AlgoOperator):
            return data
        if isinstance(data, MTable):
            return TableSourceBatchOp(data)
        raise AkIllegalArgumentException(f"expected operator or MTable, got {type(data)}")


class TransformerBase(PipelineStageBase):
    """Model-free stage (reference: pipeline/TransformerBase.java). Subclasses
    bind ``_map_op_cls`` (a MapBatchOp subclass)."""

    _map_op_cls: Optional[Type] = None

    def transform(self, data) -> AlgoOperator:
        if self._map_op_cls is None:
            raise NotImplementedError(type(self).__name__)
        return self._map_op_cls(self.get_params().clone()).link_from(self._as_op(data))


class ModelBase(PipelineStageBase):
    """A fitted model stage (reference: pipeline/ModelBase.java). Holds the
    model table; transform links the bound predict op."""

    _predict_op_cls: Optional[Type] = None

    def __init__(self, params=None, **kw):
        super().__init__(params, **kw)
        self.model_data: Optional[MTable] = None

    def set_model_data(self, model: "MTable | AlgoOperator") -> "ModelBase":
        self.model_data = model.collect() if isinstance(model, AlgoOperator) else model
        return self

    def get_model_data(self) -> MTable:
        if self.model_data is None:
            raise AkIllegalStateException(f"{type(self).__name__} has no model data")
        return self.model_data

    def transform(self, data) -> AlgoOperator:
        if self._predict_op_cls is None:
            raise NotImplementedError(type(self).__name__)
        return self._predict_op_cls(self.get_params().clone()).link_from(
            TableSourceBatchOp(self.get_model_data()), self._as_op(data)
        )


class EstimatorBase(PipelineStageBase):
    """Trainable stage (reference: pipeline/EstimatorBase.java + Trainer.java:57).
    Subclasses bind ``_train_op_cls`` and ``_model_cls``."""

    _train_op_cls: Optional[Type] = None
    _model_cls: Optional[Type] = None

    def fit(self, data) -> ModelBase:
        if self._train_op_cls is None or self._model_cls is None:
            raise NotImplementedError(type(self).__name__)
        train_op = self._train_op_cls(self.get_params().clone()).link_from(
            self._as_op(data)
        )
        model: ModelBase = self._model_cls(self.get_params().clone())
        model.set_model_data(train_op.collect())
        return model

    def fit_and_transform(self, data) -> AlgoOperator:
        return self.fit(data).transform(data)
