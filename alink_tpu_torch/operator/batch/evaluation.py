"""Evaluation operators (port of ``alink_tpu.operator.batch.evaluation``).

Capability parity with the reference's evaluation suite (reference:
core/src/main/java/com/alibaba/alink/operator/common/evaluation/ — 6.4k LoC;
operator/batch/evaluation/EvalBinaryClassBatchOp.java, EvalMultiClassBatchOp.java,
EvalRegressionBatchOp.java, EvalClusterBatchOp.java; metrics containers
BinaryClassMetrics etc.).

Metrics are columnar float64 numpy reductions on the host; each op emits a
one-row table of metric columns plus a JSON blob, and ``collect_metrics()``
returns a dict-like accessor mirroring the reference's ``collectMetrics()``.
"""

from __future__ import annotations

import json
from typing import Dict, List

import numpy as np

from ...common.exceptions import AkIllegalDataException
from ...common.mtable import AlinkTypes, MTable, TableSchema
from ...common.params import ParamInfo
from ...mapper import HasFeatureCols, HasVectorCol
from .base import BatchOperator


class Metrics(dict):
    """Dict with attribute access: m.auc / m["auc"]."""

    def __getattr__(self, k):
        try:
            return self[k]
        except KeyError:
            raise AttributeError(k)


def rank_auc(scores: np.ndarray, y: np.ndarray) -> float:
    """AUC by the rank statistic with tie-averaged ranks; y is boolean."""
    order = np.argsort(scores, kind="stable")
    ranks = np.empty(len(scores), np.float64)
    sp = scores[order]
    uniq, inv, counts = np.unique(sp, return_inverse=True, return_counts=True)
    cum = np.cumsum(counts)
    avg_rank = cum - (counts - 1) / 2.0
    ranks[order] = avg_rank[inv]
    n_pos, n_neg = int(y.sum()), int((~y).sum())
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    return float((ranks[y].sum() - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg))


def _metrics_table(metrics: Dict) -> MTable:
    flat = {k: v for k, v in metrics.items() if isinstance(v, (int, float, str))}
    cols = {k: [v] for k, v in flat.items()}
    cols["Data"] = [json.dumps(metrics, default=lambda o: np.asarray(o).tolist())]
    return MTable(cols)


class BaseEvalBatchOp(BatchOperator):
    _min_inputs = 1
    _max_inputs = 1

    # (name, type) pairs of the scalar metric columns this op emits, in order;
    # the JSON "Data" column is appended automatically
    _metric_cols: List = []

    def collect_metrics(self) -> Metrics:
        t = self.collect()
        return Metrics(json.loads(t.col("Data")[0]))

    def _out_schema(self, in_schema: TableSchema) -> TableSchema:
        names = [n for n, _ in self._metric_cols] + ["Data"]
        types = [t for _, t in self._metric_cols] + [AlinkTypes.STRING]
        return TableSchema(names, types)


class EvalBinaryClassBatchOp(BaseEvalBatchOp):
    """AUC / KS / accuracy / precision / recall / F1 / logloss
    (reference: EvalBinaryClassBatchOp.java; metrics in
    common/evaluation/BinaryClassMetrics.java)."""

    LABEL_COL = ParamInfo("labelCol", str, optional=False)
    PREDICTION_DETAIL_COL = ParamInfo("predictionDetailCol", str)
    PREDICTION_SCORE_COL = ParamInfo(
        "predictionScoreCol", str,
        desc="numeric positive-class probability column — the JSON-free "
             "path for large tables")
    POS_LABEL_VAL_STR = ParamInfo("positiveLabelValueString", str)

    _metric_cols = [
        ("AUC", AlinkTypes.DOUBLE), ("KS", AlinkTypes.DOUBLE),
        ("Accuracy", AlinkTypes.DOUBLE), ("Precision", AlinkTypes.DOUBLE),
        ("Recall", AlinkTypes.DOUBLE), ("F1", AlinkTypes.DOUBLE),
        ("LogLoss", AlinkTypes.DOUBLE), ("PositiveLabel", AlinkTypes.STRING),
    ]

    def _execute_impl(self, t: MTable) -> MTable:
        y = np.asarray([str(v) for v in t.col(self.get(self.LABEL_COL))])
        score_col = self.get(self.PREDICTION_SCORE_COL)
        if score_col:
            # JSON-free fast path for large tables. A bare score column
            # carries no label orientation, so guessing the positive class
            # would silently invert AUC — require it explicitly.
            pos = self.get(self.POS_LABEL_VAL_STR)
            if pos is None:
                raise AkIllegalDataException(
                    "predictionScoreCol needs positiveLabelValueString (the "
                    "label whose probability the score column holds)")
            p = np.asarray(t.col(score_col), np.float64)
        else:
            detail_col = self.get(self.PREDICTION_DETAIL_COL)
            if not detail_col:
                raise AkIllegalDataException(
                    "binary eval needs predictionDetailCol or "
                    "predictionScoreCol")
            # ONE json parse for the whole column (C loop) instead of a
            # python-loop of per-row loads
            details = json.loads(
                "[" + ",".join(t.col(detail_col)) + "]"
            ) if t.num_rows else []
            labels = sorted({k for d in details for k in d})
            if len(labels) != 2:
                raise AkIllegalDataException(
                    f"binary eval needs 2 labels, got {labels}")
            pos = self.get(self.POS_LABEL_VAL_STR) or labels[0]
            p = np.asarray([d.get(pos, 0.0) for d in details], np.float64)
        yb = (y == pos).astype(np.int64)

        n_pos, n_neg = yb.sum(), (1 - yb).sum()
        auc = rank_auc(p, yb.astype(bool))

        pred = (p >= 0.5).astype(np.int64)
        tp = int(((pred == 1) & (yb == 1)).sum())
        fp = int(((pred == 1) & (yb == 0)).sum())
        tn = int(((pred == 0) & (yb == 0)).sum())
        fn = int(((pred == 0) & (yb == 1)).sum())
        precision = tp / (tp + fp) if tp + fp else 0.0
        recall = tp / (tp + fn) if tp + fn else 0.0
        f1 = 2 * precision * recall / (precision + recall) if precision + recall else 0.0
        eps = 1e-15
        logloss = float(-(yb * np.log(p + eps) + (1 - yb) * np.log(1 - p + eps)).mean())

        # KS: max |TPR - FPR| over thresholds
        thr_order = np.argsort(-p, kind="stable")
        tps = np.cumsum(yb[thr_order])
        fps = np.cumsum(1 - yb[thr_order])
        ks = float(np.max(np.abs(tps / max(n_pos, 1) - fps / max(n_neg, 1))))

        return _metrics_table(
            {
                "AUC": float(auc),
                "KS": ks,
                "Accuracy": (tp + tn) / len(y),
                "Precision": precision,
                "Recall": recall,
                "F1": f1,
                "LogLoss": logloss,
                "PositiveLabel": pos,
                "ConfusionMatrix": [[tp, fp], [fn, tn]],
            }
        )


class EvalMultiClassBatchOp(BaseEvalBatchOp):
    """(reference: EvalMultiClassBatchOp.java)"""

    LABEL_COL = ParamInfo("labelCol", str, optional=False)
    PREDICTION_COL = ParamInfo("predictionCol", str, optional=False)

    _metric_cols = [
        ("Accuracy", AlinkTypes.DOUBLE), ("MacroPrecision", AlinkTypes.DOUBLE),
        ("MacroRecall", AlinkTypes.DOUBLE), ("MacroF1", AlinkTypes.DOUBLE),
    ]

    def _execute_impl(self, t: MTable) -> MTable:
        y = np.asarray([str(v) for v in t.col(self.get(self.LABEL_COL))])
        pred = np.asarray([str(v) for v in t.col(self.get(self.PREDICTION_COL))])
        labels = sorted(set(y) | set(pred))
        k = len(labels)
        idx = {v: i for i, v in enumerate(labels)}
        cm = np.zeros((k, k), np.int64)
        for yi, pi in zip(y, pred):
            cm[idx[yi], idx[pi]] += 1
        acc = float(np.trace(cm)) / len(y)
        prec, rec, f1s = [], [], []
        for i in range(k):
            tp = cm[i, i]
            p_ = tp / cm[:, i].sum() if cm[:, i].sum() else 0.0
            r_ = tp / cm[i, :].sum() if cm[i, :].sum() else 0.0
            prec.append(p_)
            rec.append(r_)
            f1s.append(2 * p_ * r_ / (p_ + r_) if p_ + r_ else 0.0)
        return _metrics_table(
            {
                "Accuracy": acc,
                "MacroPrecision": float(np.mean(prec)),
                "MacroRecall": float(np.mean(rec)),
                "MacroF1": float(np.mean(f1s)),
                "Labels": labels,
                "ConfusionMatrix": cm.tolist(),
            }
        )


class EvalRegressionBatchOp(BaseEvalBatchOp):
    """(reference: EvalRegressionBatchOp.java)"""

    LABEL_COL = ParamInfo("labelCol", str, optional=False)
    PREDICTION_COL = ParamInfo("predictionCol", str, optional=False)

    _metric_cols = [
        ("MSE", AlinkTypes.DOUBLE), ("RMSE", AlinkTypes.DOUBLE),
        ("MAE", AlinkTypes.DOUBLE), ("R2", AlinkTypes.DOUBLE),
        ("SSE", AlinkTypes.DOUBLE), ("Count", AlinkTypes.LONG),
    ]

    def _execute_impl(self, t: MTable) -> MTable:
        y = np.asarray(t.col(self.get(self.LABEL_COL)), np.float64)
        p = np.asarray(t.col(self.get(self.PREDICTION_COL)), np.float64)
        err = y - p
        mse = float((err**2).mean())
        mae = float(np.abs(err).mean())
        sst = float(((y - y.mean()) ** 2).sum())
        r2 = 1.0 - float((err**2).sum()) / sst if sst > 0 else float("nan")
        return _metrics_table(
            {
                "MSE": mse,
                "RMSE": float(np.sqrt(mse)),
                "MAE": mae,
                "R2": r2,
                "SSE": float((err**2).sum()),
                "Count": int(len(y)),
            }
        )


class EvalClusterBatchOp(BaseEvalBatchOp, HasVectorCol, HasFeatureCols):
    """Compactness / Calinski-Harabasz / silhouette-approx (reference:
    EvalClusterBatchOp.java with common/evaluation/ClusterMetrics.java)."""

    PREDICTION_COL = ParamInfo("predictionCol", str, optional=False)
    LABEL_COL = ParamInfo("labelCol", str)

    def _out_schema(self, in_schema: TableSchema) -> TableSchema:
        names = ["K", "Count", "Compactness", "CalinskiHarabasz"]
        types = [AlinkTypes.LONG, AlinkTypes.LONG,
                 AlinkTypes.DOUBLE, AlinkTypes.DOUBLE]
        if self.get(self.LABEL_COL):
            names.append("Purity")
            types.append(AlinkTypes.DOUBLE)
        return TableSchema(names + ["Data"], types + [AlinkTypes.STRING])

    def _execute_impl(self, t: MTable) -> MTable:
        from ...mapper import get_feature_block

        X = get_feature_block(
            t, self, exclude=[self.get(self.PREDICTION_COL), self.get(self.LABEL_COL)]
        )
        a = np.asarray(t.col(self.get(self.PREDICTION_COL)))
        ids = sorted(set(a.tolist()))
        k = len(ids)
        centers = np.stack([X[a == c].mean(axis=0) for c in ids])
        grand = X.mean(axis=0)
        ssw = sum(((X[a == c] - centers[i]) ** 2).sum() for i, c in enumerate(ids))
        ssb = sum((a == c).sum() * ((centers[i] - grand) ** 2).sum()
                  for i, c in enumerate(ids))
        n = X.shape[0]
        ch = float((ssb / max(k - 1, 1)) / (ssw / max(n - k, 1))) if ssw > 0 else float("nan")
        metrics = {
            "K": k,
            "Count": int(n),
            "Compactness": float(ssw / n),
            "CalinskiHarabasz": ch,
            "ClusterSizes": [int((a == c).sum()) for c in ids],
        }
        if self.get(self.LABEL_COL):
            # purity against ground-truth labels
            y = np.asarray([str(v) for v in t.col(self.get(self.LABEL_COL))])
            purity = sum(
                max(np.sum(y[a == c] == lab) for lab in set(y[a == c]))
                for c in ids
            ) / n
            metrics["Purity"] = float(purity)
        return _metrics_table(metrics)


def _parse_items(v) -> List[str]:
    """Parse a label-set cell: JSON array or delimiter-separated string."""
    if v is None:
        return []
    s = str(v).strip()
    if s.startswith("["):
        try:
            return [str(x) for x in json.loads(s)]
        except json.JSONDecodeError:
            pass
    return [x for x in s.replace(";", ",").split(",") if x]


class EvalMultiLabelBatchOp(BaseEvalBatchOp):
    """Multi-label metrics: micro/macro precision-recall-F1, subset accuracy,
    hamming loss, Jaccard accuracy (reference:
    operator/batch/evaluation/EvalMultiLabelBatchOp.java +
    common/evaluation/MultiLabelMetrics.java). Cells hold label sets as JSON
    arrays or comma-separated strings."""

    LABEL_COL = ParamInfo("labelCol", str, optional=False)
    PREDICTION_COL = ParamInfo("predictionCol", str, optional=False)

    _metric_cols = [("microPrecision", AlinkTypes.DOUBLE),
                    ("microRecall", AlinkTypes.DOUBLE),
                    ("microF1", AlinkTypes.DOUBLE),
                    ("macroF1", AlinkTypes.DOUBLE),
                    ("subsetAccuracy", AlinkTypes.DOUBLE),
                    ("hammingLoss", AlinkTypes.DOUBLE),
                    ("accuracy", AlinkTypes.DOUBLE)]

    def _execute_impl(self, t: MTable) -> MTable:
        y_sets = [set(_parse_items(v)) for v in t.col(self.get(self.LABEL_COL))]
        p_sets = [set(_parse_items(v))
                  for v in t.col(self.get(self.PREDICTION_COL))]
        all_labels = sorted(set().union(*y_sets, *p_sets) or {""})
        n = len(y_sets)
        tp = {l: 0 for l in all_labels}
        fp = {l: 0 for l in all_labels}
        fn = {l: 0 for l in all_labels}
        subset_ok = 0
        jacc_sum = 0.0
        hamming = 0
        for ys, ps in zip(y_sets, p_sets):
            for l in ps - ys:
                fp[l] += 1
            for l in ys - ps:
                fn[l] += 1
            for l in ys & ps:
                tp[l] += 1
            subset_ok += ys == ps
            union = ys | ps
            jacc_sum += len(ys & ps) / len(union) if union else 1.0
            hamming += len(ys ^ ps)
        tp_sum, fp_sum, fn_sum = sum(tp.values()), sum(fp.values()), sum(fn.values())
        micro_p = tp_sum / max(tp_sum + fp_sum, 1)
        micro_r = tp_sum / max(tp_sum + fn_sum, 1)
        micro_f1 = (2 * micro_p * micro_r / (micro_p + micro_r)
                    if micro_p + micro_r > 0 else 0.0)
        macro_f1s = []
        for l in all_labels:
            p = tp[l] / max(tp[l] + fp[l], 1)
            r = tp[l] / max(tp[l] + fn[l], 1)
            macro_f1s.append(2 * p * r / (p + r) if p + r > 0 else 0.0)
        metrics = {
            "microPrecision": micro_p,
            "microRecall": micro_r,
            "microF1": micro_f1,
            "macroF1": float(np.mean(macro_f1s)),
            "subsetAccuracy": subset_ok / max(n, 1),
            "hammingLoss": hamming / max(n * len(all_labels), 1),
            "accuracy": jacc_sum / max(n, 1),
        }
        return _metrics_table(metrics)


class EvalRankingBatchOp(BaseEvalBatchOp):
    """Ranking metrics: MAP, NDCG, precision/recall@k, hit rate (reference:
    operator/batch/evaluation/EvalRankingBatchOp.java +
    common/evaluation/RankingMetrics.java). labelCol holds the relevant item
    set; predictionCol the ranked recommendation list."""

    LABEL_COL = ParamInfo("labelCol", str, optional=False)
    PREDICTION_COL = ParamInfo("predictionCol", str, optional=False)
    K = ParamInfo("k", int, default=10)

    _metric_cols = [("map", AlinkTypes.DOUBLE),
                    ("ndcg", AlinkTypes.DOUBLE),
                    ("precisionAtK", AlinkTypes.DOUBLE),
                    ("recallAtK", AlinkTypes.DOUBLE),
                    ("hitRate", AlinkTypes.DOUBLE),
                    ("k", AlinkTypes.LONG)]

    def _execute_impl(self, t: MTable) -> MTable:
        k = int(self.get(self.K))
        aps, ndcgs, p_at_k, r_at_k, hits = [], [], [], [], []
        for yv, pv in zip(t.col(self.get(self.LABEL_COL)),
                          t.col(self.get(self.PREDICTION_COL))):
            rel = set(_parse_items(yv))
            ranked = _parse_items(pv)
            if not rel:
                continue
            topk = ranked[:k]
            n_hit = sum(1 for x in topk if x in rel)
            p_at_k.append(n_hit / max(len(topk), 1))
            r_at_k.append(n_hit / len(rel))
            hits.append(1.0 if n_hit > 0 else 0.0)
            # average precision over the full ranked list
            ap_hits, ap_sum = 0, 0.0
            for i, x in enumerate(ranked, 1):
                if x in rel:
                    ap_hits += 1
                    ap_sum += ap_hits / i
            aps.append(ap_sum / len(rel))
            # binary-relevance NDCG@k
            dcg = sum(1.0 / np.log2(i + 1)
                      for i, x in enumerate(topk, 1) if x in rel)
            idcg = sum(1.0 / np.log2(i + 1)
                       for i in range(1, min(len(rel), k) + 1))
            ndcgs.append(dcg / idcg if idcg > 0 else 0.0)
        metrics = {
            "map": float(np.mean(aps)) if aps else float("nan"),
            "ndcg": float(np.mean(ndcgs)) if ndcgs else float("nan"),
            "precisionAtK": float(np.mean(p_at_k)) if p_at_k else float("nan"),
            "recallAtK": float(np.mean(r_at_k)) if r_at_k else float("nan"),
            "hitRate": float(np.mean(hits)) if hits else float("nan"),
            "k": k,
        }
        return _metrics_table(metrics)
