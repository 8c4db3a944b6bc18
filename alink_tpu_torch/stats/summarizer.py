"""Table summary statistics (a copy of ``alink_tpu.stats.summarizer``).

Capability parity with the reference's statistics package (reference:
core/src/main/java/com/alibaba/alink/operator/common/statistics/ —
SummarizerBatchOp → TableSummary; basicstatistic/TableSummarizer.java).

Re-design: one pass of columnar numpy reductions on the host instead of a
partition merge tree (the summarizer's merge is a sum of (count, sum, sum²,
min, max) vectors).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from ..common.mtable import AlinkTypes, MTable, TableSchema


SUMMARY_KEYS = ["count", "numMissing", "sum", "mean", "variance",
                "standardDeviation", "min", "max"]


def summary_schema() -> TableSchema:
    """Schema of a summary table — the single source for the statistic list."""
    return TableSchema(["colName"] + SUMMARY_KEYS,
                       [AlinkTypes.STRING] + [AlinkTypes.DOUBLE] * len(SUMMARY_KEYS))


class TableSummary:
    """Per-column count/numMissing/sum/mean/variance/std/min/max
    (reference: common/statistics/basicstatistic/TableSummary.java)."""

    def __init__(self, col_names: List[str]):
        self.col_names = col_names
        self.stats: Dict[str, Dict[str, float]] = {}

    def add_numeric(self, name, count, missing, total, mean, var, vmin, vmax):
        self.stats[name] = {
            "count": count,
            "numMissing": missing,
            "sum": total,
            "mean": mean,
            "variance": var,
            "standardDeviation": float(np.sqrt(var)) if var == var else float("nan"),
            "min": vmin,
            "max": vmax,
        }

    def add_non_numeric(self, name, count, missing):
        self.stats[name] = {"count": count, "numMissing": missing}

    def count(self, col: Optional[str] = None) -> float:
        c = col or self.col_names[0]
        return self.stats[c]["count"]

    def mean(self, col: str) -> float:
        return self.stats[col]["mean"]

    def variance(self, col: str) -> float:
        return self.stats[col]["variance"]

    def standard_deviation(self, col: str) -> float:
        return self.stats[col]["standardDeviation"]

    def sum(self, col: str) -> float:
        return self.stats[col]["sum"]

    def min(self, col: str) -> float:
        return self.stats[col]["min"]

    def max(self, col: str) -> float:
        return self.stats[col]["max"]

    def num_missing(self, col: str) -> float:
        return self.stats[col]["numMissing"]

    def to_mtable(self) -> MTable:
        keys = SUMMARY_KEYS
        cols: Dict[str, list] = {"colName": []}
        for k in keys:
            cols[k] = []
        for name in self.col_names:
            cols["colName"].append(name)
            s = self.stats[name]
            for k in keys:
                cols[k].append(float(s.get(k, float("nan"))))
        return MTable(cols)

    def to_display_string(self) -> str:
        return self.to_mtable().to_display_string(max_rows=len(self.col_names))

    def __repr__(self):
        return self.to_display_string()


def summarize(t: MTable, selected_cols: Optional[List[str]] = None) -> TableSummary:
    names = selected_cols or t.names
    summary = TableSummary(list(names))
    for n in names:
        tp = t.schema.type_of(n)
        col = t.col(n)
        if AlinkTypes.is_numeric(tp):
            arr = np.asarray(col, dtype=np.float64)
            missing = int(np.isnan(arr).sum())
            valid = arr[~np.isnan(arr)]
            cnt = valid.size
            if cnt == 0:
                summary.add_numeric(n, 0, missing, 0.0, float("nan"), float("nan"),
                                    float("nan"), float("nan"))
            else:
                var = float(valid.var(ddof=1)) if cnt > 1 else 0.0
                summary.add_numeric(
                    n, cnt, missing, float(valid.sum()), float(valid.mean()),
                    var, float(valid.min()), float(valid.max()),
                )
        else:
            if col.dtype == object:
                missing = sum(1 for v in col if v is None)
            else:
                missing = 0
            summary.add_non_numeric(n, t.num_rows - missing, missing)
    return summary
