"""LocalPredictor — embedded row/batch serving without the DAG layer (port
of ``alink_tpu.pipeline.local_predictor``).

Capability parity with reference pipeline/LocalPredictor.java:25-138 (embeds a
MapperChain built from a saved pipeline model for in-process serving) and
LocalPredictorLoader. Batched ``predict_table`` is the hot path;
``predict_row`` serves single requests through the same mappers.

The transform plan (the mapper chain: one predict/map op per pipeline stage,
linked over a swappable source) is built ONCE at construction and reused for
every predict — repeated predicts skip stage re-planning (op construction,
param cloning, link_from). The cached-plan path is bit-identical to
rebuilding the DAG per call; ``cache_plan=False`` restores the
rebuild-per-call behavior.
"""

from __future__ import annotations

import threading
from typing import List, Optional, Sequence, Tuple

from ..common.mtable import MTable, TableSchema
from ..operator.base import AlgoOperator
from ..operator.batch.base import TableSourceBatchOp
from .pipeline import PipelineModel


class LocalPredictor:
    def __init__(self, model: "PipelineModel | str", input_schema: "TableSchema | str",
                 cache_plan: bool = True):
        if isinstance(model, str):
            model = PipelineModel.load(model)
        self.pipeline_model = model
        self.input_schema = (
            TableSchema.parse(input_schema) if isinstance(input_schema, str)
            else input_schema
        )
        self._cache_plan = cache_plan
        # plan state: (source op, chain tail, every op in the sub-DAG).
        # Guarded by a lock — the plan's op nodes memoize results in place,
        # so concurrent predicts must serialize on one predictor instance.
        self._plan_lock = threading.Lock()
        self._plan: Optional[Tuple[TableSourceBatchOp, AlgoOperator,
                                   List[AlgoOperator]]] = None

    # -- plan construction --------------------------------------------------
    def _build_plan(self):
        src = TableSourceBatchOp(MTable.empty(self.input_schema))
        tail = self.pipeline_model.transform(src)
        ops: List[AlgoOperator] = []
        seen = set()
        stack: List[AlgoOperator] = [tail]
        while stack:
            op = stack.pop()
            if id(op) in seen:
                continue
            seen.add(id(op))
            ops.append(op)
            stack.extend(op._inputs)
        return src, tail, ops

    def _predict_table_planned(self, t: MTable) -> MTable:
        with self._plan_lock:
            if self._plan is None:
                self._plan = self._build_plan()
            src, tail, ops = self._plan
            src._table = t
            # re-arm every node: model TableSourceBatchOps re-"execute" for
            # free (they return their held table); predict ops re-run on the
            # fresh input
            for op in ops:
                op._executed = False
                op._output = None
                op._side_tables = []
            return tail.collect()

    # -- serving API ---------------------------------------------------------
    def predict_table(self, t: MTable) -> MTable:
        if self._cache_plan:
            return self._predict_table_planned(t)
        op = self.pipeline_model.transform(t)
        return op.collect()

    def predict_row(self, row: Sequence):
        t = MTable.from_rows([row], self.input_schema)
        return self.predict_table(t).get_row(0)

    def get_output_schema(self) -> TableSchema:
        """Static output schema of the serving chain — derived from the
        mapper IO-schema contracts without executing anything (an empty-row
        probe run would choke on vector/tensor output columns)."""
        with self._plan_lock:
            if self._plan is None:
                self._plan = self._build_plan()
            return self._plan[1].schema
