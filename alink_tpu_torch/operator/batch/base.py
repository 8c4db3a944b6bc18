"""BatchOperator + the batch sources and sink of the serving slice (port of
``alink_tpu.operator.batch.base``).

Capability parity with reference operator/batch/BatchOperator.java:67 and
operator/batch/source/AkSourceBatchOp.java, sink/AkSinkBatchOp.java.
"""

from __future__ import annotations

import os

from ...common.exceptions import AkIllegalArgumentException
from ...common.mtable import MTable, TableSchema
from ...common.params import ParamInfo
from ..base import AlgoOperator, TableSourceOp


class BatchOperator(AlgoOperator):
    """Bounded-data operator (reference: operator/batch/BatchOperator.java)."""


class TableSourceBatchOp(TableSourceOp, BatchOperator):
    pass


class AkSourceBatchOp(BatchOperator):
    """.ak-file source (reference: AkSourceBatchOp.java; format at
    common/io/filesystem/AkUtils.java:52-110)."""

    FILE_PATH = ParamInfo("filePath", str, optional=False)

    _max_inputs = 0

    def _execute_impl(self) -> MTable:
        from ...io.ak import read_ak

        return read_ak(self.get(self.FILE_PATH))

    def _out_schema(self) -> TableSchema:
        from ...io.ak import read_ak_meta

        return TableSchema.parse(read_ak_meta(self.get(self.FILE_PATH))["schema"])

    def _static_model_meta(self):
        from ...common.model import MODEL_SCHEMA, table_to_model
        from ...io.ak import read_ak, read_ak_meta

        path = self.get(self.FILE_PATH)
        cached = getattr(self, "_meta_cache", None)
        if cached is not None and cached[0] == path:
            return cached[1]
        header = read_ak_meta(path)
        meta = None
        if TableSchema.parse(header["schema"]) == MODEL_SCHEMA:
            meta = table_to_model(read_ak(path))[0]
        self._meta_cache = (path, meta)
        return meta


class AkSinkBatchOp(BatchOperator):
    FILE_PATH = ParamInfo("filePath", str, optional=False)
    OVERWRITE_SINK = ParamInfo("overwriteSink", bool, default=False)

    _min_inputs = 1
    _max_inputs = 1

    def _execute_impl(self, t: MTable) -> MTable:
        from ...io.ak import write_ak

        path = self.get(self.FILE_PATH)
        if os.path.exists(path) and not self.get(self.OVERWRITE_SINK):
            raise AkIllegalArgumentException(
                f"sink path {path} exists; set overwriteSink=True"
            )
        write_ak(path, t)
        return t

    def _out_schema(self, in_schema: TableSchema) -> TableSchema:
        return in_schema  # never probe: a sink must not write on schema access
