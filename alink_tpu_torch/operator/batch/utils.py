"""Mapper and model-mapper batch operators and the train-op mixin (port of
``alink_tpu.operator.batch.utils``; the executor's mapper-chain fusion
contract is not ported).

Capability parity with reference operator/batch/utils/ModelMapBatchOp.java:62:
the mapper loads the model MTable once and maps the data table with it. The
loaded mapper is kept across executes while the model table is the same
object (see ``ModelMapBatchOp._loaded_mapper``).
"""

from __future__ import annotations

from typing import Type

from ...common.exceptions import AkIllegalOperationException
from ...common.model import MODEL_SCHEMA
from ...common.mtable import MTable, TableSchema
from ..base import AlgoOperator
from .base import BatchOperator


class MapBatchOp(BatchOperator):
    """Wrap a stateless Mapper class as an operator; the mapper runs on the
    session's device (``MLEnvironment.device``)."""

    _min_inputs = 1
    _max_inputs = 1

    mapper_cls: Type = None

    def _make_mapper(self, data_schema):
        # cached per input schema: foreign-model mappers (modelpredict) load
        # and convert whole model files, so schema access + execute must
        # share one instance
        key = data_schema.to_str()
        cached = getattr(self, "_mapper_cache", None)
        if cached is not None and cached[0] == key:
            return cached[1]
        mapper = self.mapper_cls(data_schema, self.get_params())
        mapper.device = self.env.device
        self._mapper_cache = (key, mapper)
        return mapper

    def _execute_impl(self, t: MTable) -> MTable:
        return self._make_mapper(t.schema).map_table(t)

    def _out_schema(self, in_schema: TableSchema) -> TableSchema:
        return self._make_mapper(in_schema).output_schema(in_schema)


class ModelMapBatchOp(BatchOperator):
    """Wrap a ModelMapper class; ``link_from(model_op, data_op)``."""

    _min_inputs = 2
    _max_inputs = 2

    mapper_cls: Type = None

    def __init__(self, params=None, **kwargs):
        super().__init__(params, **kwargs)

    def _make_mapper(self, model_schema, data_schema):
        return self.mapper_cls(model_schema, data_schema, self.get_params())

    def _loaded_mapper(self, model: MTable, data_schema: TableSchema):
        """The mapper loaded from ``model``, kept while the model table is
        the same object (identity, as the staging cache keys) and the data
        schema, params and device are unchanged. A ``LocalPredictor``'s
        cached plan feeds every predict the same model table, so it decodes
        the model once; the reference reloads it on every execute (2.0–2.4 s
        of host work per batch for BERT-base)."""
        key = (data_schema.to_str(), self.get_params().to_json(),
               str(self.env.device))
        kept = getattr(self, "_kept_mapper", None)
        if kept is not None and kept[0] is model and kept[1] == key:
            return kept[2]
        mapper = self._make_mapper(model.schema, data_schema)
        mapper.device = self.env.device
        mapper.load_model(model)
        self._kept_mapper = (model, key, mapper)
        return mapper

    def _execute_impl(self, model: MTable, t: MTable) -> MTable:
        return self._loaded_mapper(model, t.schema).map_table(t)

    def _out_schema(self, model_schema: TableSchema,
                    data_schema: TableSchema) -> TableSchema:
        # the mapper's schema decisions (pred type etc.) read model meta;
        # model-producing ops declare it statically (reference analog:
        # ModelMapper.prepareIoSchema works off the model *schema* alone)
        meta = self._inputs[0]._static_model_meta() if self._inputs else None
        mapper = self._make_mapper(model_schema, data_schema)
        if meta is not None:
            mapper.meta = meta
        try:
            return mapper.output_schema(data_schema)
        except (AttributeError, KeyError) as e:
            raise AkIllegalOperationException(
                f"{type(self).__name__}: static schema needs model meta that "
                f"{type(self._inputs[0]).__name__ if self._inputs else '?'} "
                f"does not declare ({e!r})"
            ) from e


class ModelTrainOpMixin:
    """Train ops emit the canonical model table; schema is a constant.

    Static model meta: once executed the real meta row wins; before that,
    ``_static_meta_keys(in_schema)`` supplies the keys the paired
    ModelMapper's schema decisions need (labelType etc.)."""

    def _out_schema(self, *in_schemas: TableSchema) -> TableSchema:
        return MODEL_SCHEMA

    def _static_model_meta(self):
        meta = AlgoOperator._static_model_meta(self)
        if meta is not None:
            return meta
        in_schema = self._inputs[0]._static_schema() if self._inputs else None
        return self._static_meta_keys(in_schema)

    def _static_meta_keys(self, in_schema: TableSchema) -> dict:
        return {}
