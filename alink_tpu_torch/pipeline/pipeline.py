"""Pipeline / PipelineModel with single-file persistence (port of
``alink_tpu.pipeline.pipeline``).

Capability parity with reference pipeline/Pipeline.java:127 (fit),
PipelineModel.java:127,184,221 (transform), save/load at PipelineModel.java:403-437
via ModelExporterUtils.serializePipelineStages (ModelExporterUtils.java:558):
all stage models packed into ONE table — (stage id, meta-json, model rows) —
written as a .ak file. Load reconstructs stages and their models
(deserializePipelineStagesFromMeta :1027, loadStagesFromPipelineModel :1118).
The table and its ``.ak`` file are the reference's, byte for byte in
layout, so a pipeline model saved by either package loads in the other.
The reference's opt-in plan pre-flight (``ALINK_VALIDATE_PLAN``) is not
ported yet.
"""

from __future__ import annotations

import json
from typing import List

import numpy as np

from ..common.exceptions import AkIllegalDataException
from ..common.mtable import AlinkTypes, MTable, TableSchema
from ..common.params import Params
from ..operator.base import AlgoOperator
from .base import (
    STAGE_REGISTRY,
    EstimatorBase,
    ModelBase,
    PipelineStageBase,
    TransformerBase,
)

_PIPE_SCHEMA = TableSchema(
    ["stage_id", "key", "json", "tensor"],
    [AlinkTypes.LONG, AlinkTypes.STRING, AlinkTypes.STRING, AlinkTypes.TENSOR],
)
_STAGE_META_KEY = "__stage__"


class Pipeline(PipelineStageBase):
    """(reference: pipeline/Pipeline.java)"""

    def __init__(self, *stages: PipelineStageBase):
        super().__init__()
        self.stages: List[PipelineStageBase] = list(stages)

    def add(self, stage: PipelineStageBase) -> "Pipeline":
        self.stages.append(stage)
        return self

    def fit(self, data) -> "PipelineModel":
        op = self._as_op(data)
        fitted: List[PipelineStageBase] = []
        for stage in self.stages:
            if isinstance(stage, EstimatorBase):
                model = stage.fit(op)
                fitted.append(model)
                op = model.transform(op)
            elif isinstance(stage, (TransformerBase, ModelBase)):
                fitted.append(stage)
                op = stage.transform(op)
            else:
                raise AkIllegalDataException(
                    f"stage {type(stage).__name__} is not "
                    "estimator/transformer")
        return PipelineModel(*fitted)

    def fit_and_transform(self, data) -> AlgoOperator:
        return self.fit(data).transform(data)


class PipelineModel(PipelineStageBase):
    """(reference: pipeline/PipelineModel.java)"""

    def __init__(self, *stages: PipelineStageBase):
        super().__init__()
        self.stages: List[PipelineStageBase] = list(stages)

    def transform(self, data) -> AlgoOperator:
        op = self._as_op(data)
        for stage in self.stages:
            op = stage.transform(op)
        return op

    # -- persistence -------------------------------------------------------
    def _to_table(self) -> MTable:
        sid, keys, jsons, tensors = [], [], [], []
        for i, stage in enumerate(self.stages):
            sid.append(i)
            keys.append(_STAGE_META_KEY)
            jsons.append(
                json.dumps(
                    {
                        "className": type(stage).__name__,
                        "params": json.loads(stage.get_params().to_json()),
                    }
                )
            )
            tensors.append(np.zeros(0))
            if isinstance(stage, ModelBase) and stage.model_data is not None:
                model = stage.model_data
                for key, js, tensor in model.rows():
                    sid.append(i)
                    keys.append(key)
                    jsons.append(js)
                    tensors.append(np.asarray(tensor))
        return MTable(
            {"stage_id": np.asarray(sid, np.int64), "key": keys,
             "json": jsons, "tensor": tensors},
            _PIPE_SCHEMA,
        )

    def save(self, path: str):
        from ..io.ak import write_ak

        write_ak(path, self._to_table(), extra_meta={"type": "PipelineModel"})

    @staticmethod
    def load(path: str) -> "PipelineModel":
        from ..io.ak import read_ak

        return PipelineModel.from_table(read_ak(path))

    @staticmethod
    def from_table(t: MTable) -> "PipelineModel":
        from ..common.model import MODEL_SCHEMA

        stages: List[PipelineStageBase] = []
        sids = np.asarray(t.col("stage_id"))
        for i in sorted(set(sids.tolist())):
            part = t.filter_mask(sids == i)
            meta_rows = [r for r in part.rows() if r[1] == _STAGE_META_KEY]
            if not meta_rows:
                raise AkIllegalDataException(f"stage {i} missing meta row")
            info = json.loads(meta_rows[0][2])
            cls = STAGE_REGISTRY.get(info["className"])
            if cls is None:
                raise AkIllegalDataException(
                    f"unknown pipeline stage class {info['className']!r}"
                )
            params = Params(**info["params"])
            stage = cls(params)
            model_rows = [r for r in part.rows() if r[1] != _STAGE_META_KEY]
            if isinstance(stage, ModelBase):
                model = MTable(
                    {
                        "key": [r[1] for r in model_rows],
                        "json": [r[2] for r in model_rows],
                        "tensor": [np.asarray(r[3]) for r in model_rows],
                    },
                    MODEL_SCHEMA,
                )
                stage.set_model_data(model)
            stages.append(stage)
        return PipelineModel(*stages)
