"""Streaming evaluation — windowed metrics per micro-batch (port of
``alink_tpu.operator.stream.evaluation``, host code as there).

(reference: operator/stream/evaluation/EvalBinaryClassStreamOp.java — windowed
AUC/accuracy over a time window, emitting one metrics row per window.)
"""

from __future__ import annotations

import json
from typing import Iterator

import numpy as np

from ...common.mtable import AlinkTypes, MTable, TableSchema
from ...common.params import ParamInfo
from .base import CumulativeEvalStateMixin, StreamOperator


class EvalBinaryClassStreamOp(CumulativeEvalStateMixin, StreamOperator):
    """One metrics row per micro-batch (window) + cumulative row.

    Cumulative counters live on the instance (CumulativeEvalStateMixin) so
    epoch snapshots (common/recovery.py) carry them: the post-restart
    cumulative row keeps covering the whole stream, not just post-crash
    chunks."""

    _min_inputs = 1
    _max_inputs = 1

    LABEL_COL = ParamInfo("labelCol", str, optional=False)
    PREDICTION_DETAIL_COL = ParamInfo("predictionDetailCol", str, optional=False)
    POSITIVE_LABEL = ParamInfo("positiveLabelValueString", str)

    _eval_series = ("all_y", "all_s")

    def _stream_impl(self, it: Iterator[MTable]) -> Iterator[MTable]:
        label_col = self.get(self.LABEL_COL)
        detail_col = self.get(self.PREDICTION_DETAIL_COL)
        pos = self.get(self.POSITIVE_LABEL)
        st = self._eval_state()
        for chunk in it:
            y_raw = [str(v) for v in chunk.col(label_col)]
            details = [json.loads(str(v)) for v in chunk.col(detail_col)]
            p = pos if pos is not None else sorted(details[0].keys())[-1]
            scores = np.asarray([d.get(p, 0.0) for d in details])
            y = np.asarray([1.0 if v == p else 0.0 for v in y_raw])
            st["all_y"].append(y)
            st["all_s"].append(scores)
            i = st["window"]
            st["window"] += 1
            yield self._metrics_row("window", i, y, scores)

        if st["all_y"]:
            yield self._metrics_row(
                "all", -1, np.concatenate(st["all_y"]),
                np.concatenate(st["all_s"])
            )

    @staticmethod
    def _metrics_row(kind: str, window: int, y, s) -> MTable:
        pred = (s >= 0.5).astype(float)
        acc = float(np.mean(pred == y))
        auc = _auc(y, s)
        stat = json.dumps({"Accuracy": acc, "AUC": auc, "Count": int(len(y))})
        return MTable(
            {
                "Statistics": np.asarray([kind], object),
                "WindowId": np.asarray([window], np.int64),
                "Data": np.asarray([stat], object),
            },
            TableSchema(
                ["Statistics", "WindowId", "Data"],
                [AlinkTypes.STRING, AlinkTypes.LONG, AlinkTypes.STRING],
            ),
        )


def _auc(y: np.ndarray, s: np.ndarray) -> float:
    n_pos = int(y.sum())
    n_neg = len(y) - n_pos
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    order = np.argsort(s, kind="stable")
    ranks = np.empty(len(s), np.float64)
    sorted_s = s[order]
    ranks[order] = np.arange(1, len(s) + 1)
    # average ranks over ties
    uniq, inv, counts = np.unique(sorted_s, return_inverse=True,
                                  return_counts=True)
    cum = np.cumsum(counts)
    avg = (cum - (counts - 1) / 2.0)
    ranks[order] = avg[inv]
    return float(
        (ranks[y == 1].sum() - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg)
    )


class SummarizerStreamOp(StreamOperator):
    """Cumulative streaming summary statistics: each chunk emits the summary
    over everything seen so far (reference: operator/stream/statistics/
    SummarizerStreamOp.java — merged TableSummary over windows). The merge
    is the summarizer's (count, sum, sum2, min, max) moment algebra."""

    # cross-chunk state in generator locals, no snapshot hooks yet:
    # refused by the recovery runtime rather than silently reset
    _stateful_unhooked = True

    SELECTED_COLS = ParamInfo("selectedCols", list)

    _min_inputs = 1
    _max_inputs = 1

    def _stream_impl(self, it):
        import numpy as np

        from ...common.mtable import AlinkTypes, MTable, TableSchema
        from ...stats.summarizer import summary_schema

        state = {}  # col -> [count, sum, sum2, min, max, missing]
        text_state = {}  # non-numeric col -> [count, missing]
        cols = self.get(self.SELECTED_COLS)
        for chunk in it:
            selected = cols or list(chunk.names)
            use = [c for c in selected
                   if AlinkTypes.is_numeric(chunk.schema.type_of(c))]
            # non-numeric columns track count/missing only (same contract as
            # the batch summarize() add_non_numeric path)
            for c in selected:
                if c in use:
                    continue
                vals = chunk.col(c)
                st = text_state.setdefault(c, [0.0, 0.0])
                miss = sum(1 for v in vals if v is None)
                st[0] += len(vals) - miss
                st[1] += miss
            for c in use:
                arr = np.asarray(chunk.col(c), np.float64)
                ok = arr[~np.isnan(arr)]
                st = state.setdefault(
                    c, [0.0, 0.0, 0.0, np.inf, -np.inf, 0.0])
                st[0] += ok.size
                st[1] += float(ok.sum())
                st[2] += float((ok * ok).sum())
                if ok.size:
                    st[3] = min(st[3], float(ok.min()))
                    st[4] = max(st[4], float(ok.max()))
                st[5] += float(np.isnan(arr).sum())
            rows = []
            for c, st in state.items():
                cnt = st[0]
                mean = st[1] / cnt if cnt else float("nan")
                var = (st[2] / cnt - mean * mean) * cnt / (cnt - 1) \
                    if cnt > 1 else 0.0
                rows.append((c, cnt, st[5], st[1], mean, var,
                             float(np.sqrt(max(var, 0.0))), st[3], st[4]))
            nan = float("nan")
            for c, st in text_state.items():
                rows.append((c, st[0], st[1], nan, nan, nan, nan, nan, nan))
            yield MTable.from_rows(rows, summary_schema())
