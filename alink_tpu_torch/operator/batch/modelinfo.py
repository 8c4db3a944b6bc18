"""Generic *ModelInfoBatchOp family: model table → human-readable summary
(port of ``alink_tpu.operator.batch.modelinfo``; reads model tables written
by either package).

Capability parity with the reference's ModelInfo column (reference: ~40
per-algorithm ops like operator/batch/classification/
LogisticRegressionModelInfoBatchOp.java, regression/GlmModelInfoBatchOp.java,
recommendation/AlsModelInfoBatchOp.java — each loads the model rows and
prints a structured summary; wired to ``lazyPrintModelInfo``).

Re-design: one generic inspector over the framework's uniform model-table
format (meta JSON + named arrays) plus per-model-kind detail rows, exposed
both as a generic :class:`ModelInfoBatchOp` and as the familiar per-name
classes (metaprogrammed, like the stream twins)."""

from __future__ import annotations

import json
from typing import List

import numpy as np

from ...common.model import table_to_model
from ...common.mtable import AlinkTypes, MTable, TableSchema
from .base import BatchOperator

_INFO_SCHEMA = TableSchema(["key", "value"],
                           [AlinkTypes.STRING, AlinkTypes.STRING])


class ModelInfoBatchOp(BatchOperator):
    """Inspect ANY framework model table: meta entries + per-array shape/
    stats rows (the ``lazyPrintModelInfo`` payload)."""

    _min_inputs = 1
    _max_inputs = 1

    def _execute_impl(self, model: MTable) -> MTable:
        meta, arrays = table_to_model(model)
        rows: List[tuple] = []
        for k in sorted(meta):
            v = meta[k]
            rows.append((f"meta.{k}",
                         json.dumps(v) if isinstance(v, (list, dict))
                         else str(v)))
        for name in sorted(arrays):
            a = np.asarray(arrays[name])
            desc = f"shape={tuple(a.shape)} dtype={a.dtype}"
            if a.size and np.issubdtype(a.dtype, np.number):
                flat = a.astype(np.float64).reshape(-1)
                finite = flat[np.isfinite(flat)]
                if finite.size:
                    desc += (f" min={finite.min():g} max={finite.max():g}"
                             f" mean={finite.mean():g}")
            rows.append((f"array.{name}", desc))
        return MTable.from_rows(rows, _INFO_SCHEMA)

    def _out_schema(self, in_schema):
        return _INFO_SCHEMA


# familiar per-algorithm names (reference parity for lazyPrintModelInfo
# call sites); all share the generic inspector
_NAMES = [
    "LogisticRegression", "LinearReg", "LinearSvm", "Softmax", "RidgeReg",
    "LassoReg", "LinearSvr", "Glm", "NaiveBayes", "Fm", "FmClassifier",
    "FmRegressor", "Gbdt", "GbdtReg", "RandomForest", "DecisionTree",
    "Gmm", "BisectingKMeans", "Lda", "Als", "ItemCf", "UserCf", "Swing",
    "OneHot", "Pca", "QuantileDiscretizer", "StandardScaler",
    "MinMaxScaler", "MaxAbsScaler", "Imputer", "StringIndexer",
    "Word2Vec", "Scorecard",
    # tree-family variants (reference: C45ModelInfoBatchOp.java etc.)
    "C45", "Cart", "CartReg", "Id3", "DecisionTreeReg", "RandomForestReg",
    # long-tail per-model inspectors (reference: same-named .java files)
    "AftSurvivalReg", "ChisqSelector", "EqualWidthDiscretizer", "MultiHot",
    "NaiveBayesText", "VectorImputer", "VectorMaxAbsScaler",
    "VectorMinMaxScaler", "VectorStandardScaler", "ExclusiveFeatureBundle",
    "MultiStringIndexer", "TargetEncoder",
]

__all__ = ["ModelInfoBatchOp"]
for _name in _NAMES:
    _cls_name = f"{_name}ModelInfoBatchOp"
    if _cls_name in globals():
        continue
    globals()[_cls_name] = type(_cls_name, (ModelInfoBatchOp,), {
        "__module__": __name__,
        "__doc__": f"(reference: {_cls_name}.java — served by the generic "
                   "model inspector over the uniform model-table format)",
    })
    __all__.append(_cls_name)


class ExtractModelInfoBatchOp(ModelInfoBatchOp):
    """Base of the per-model inspector family — extract a structured summary
    from any linked model table (reference: operator/batch/utils/
    ExtractModelInfoBatchOp.java, the shared base of every *ModelInfoBatchOp)."""


class WithModelInfoBatchOp(ModelInfoBatchOp):
    """Mixin-style entry: gives any trainer a ``lazyPrintModelInfo``-style
    inspector over its model output (reference: operator/batch/utils/
    WithModelInfoBatchOp.java)."""


__all__ += ["ExtractModelInfoBatchOp", "WithModelInfoBatchOp"]
