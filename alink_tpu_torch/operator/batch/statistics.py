"""Statistics operators: summary, correlation, chi-square, quantile (port of
``alink_tpu.operator.batch.statistics``).

Capability parity with the reference statistics ops (reference:
core/src/main/java/com/alibaba/alink/operator/batch/statistics/
SummarizerBatchOp.java, CorrelationBatchOp.java (Pearson + Spearman via
common/statistics/basicstatistic/SpearmanCorrelation.java),
ChiSquareTestBatchOp.java (common/statistics/ChiSquareTestUtil.java),
QuantileBatchOp.java, VectorSummarizerBatchOp.java,
VectorCorrelationBatchOp.java).

Each statistic is one columnar float64 reduction over the MTable block on
the host, as in the reference: the partition-merge trees
(StatisticsHelper.pearsonCorrelation) collapse into one product,
corr = normalize(XᵀX) on the centred block. p-values come from
stats/prob.py (the reference used common/probabilistic/CDF.java).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from ...common.linalg import parse_vector
from ...common.mtable import AlinkTypes, MTable, TableSchema
from ...common.params import ParamInfo
from ...mapper import HasSelectedCol, HasSelectedCols, default_feature_cols
from ...stats.prob import CDF
from ...stats.summarizer import TableSummary, summarize, summary_schema
from .base import BatchOperator


def _numeric_cols(t_or_schema, selected: Optional[List[str]]) -> List[str]:
    if selected:
        return list(selected)
    return list(default_feature_cols(t_or_schema))


class SummarizerBatchOp(BatchOperator, HasSelectedCols):
    """Whole-table summary (reference: SummarizerBatchOp.java → TableSummary)."""

    _min_inputs = 1
    _max_inputs = 1

    def _execute_impl(self, t: MTable) -> MTable:
        cols = self.get(HasSelectedCols.SELECTED_COLS) or t.names
        self._summary = summarize(t, list(cols))
        return self._summary.to_mtable()

    def _out_schema(self, in_schema: TableSchema) -> TableSchema:
        return summary_schema()

    def collect_summary(self) -> TableSummary:
        self.collect()
        return self._summary


class CorrelationResult:
    """(reference: common/statistics/basicstatistic/CorrelationResult.java)"""

    def __init__(self, col_names: List[str], matrix: np.ndarray):
        self.col_names = col_names
        self.correlation_matrix = matrix

    def __repr__(self):
        head = " ".join(f"{c:>12s}" for c in self.col_names)
        lines = [f"{'':>12s} {head}"]
        for name, row in zip(self.col_names, self.correlation_matrix):
            vals = " ".join(f"{v:12.6f}" for v in row)
            lines.append(f"{name:>12s} {vals}")
        return "\n".join(lines)


def _rankdata(x: np.ndarray) -> np.ndarray:
    """Average ranks with ties (reference: SpearmanCorrelation.java)."""
    order = np.argsort(x, kind="stable")
    ranks = np.empty_like(order, dtype=np.float64)
    sorted_x = x[order]
    # average rank over each tied run
    boundaries = np.flatnonzero(np.r_[True, sorted_x[1:] != sorted_x[:-1], True])
    for s, e in zip(boundaries[:-1], boundaries[1:]):
        ranks[order[s:e]] = 0.5 * (s + e - 1) + 1.0
    return ranks


def _corr_matrix(X: np.ndarray) -> np.ndarray:
    Xc = X - X.mean(axis=0)
    cov = Xc.T @ Xc
    d = np.sqrt(np.diag(cov))
    d = np.where(d < 1e-300, 1.0, d)
    m = cov / np.outer(d, d)
    np.fill_diagonal(m, 1.0)
    return np.clip(m, -1.0, 1.0)


class CorrelationBatchOp(BatchOperator, HasSelectedCols):
    """Pearson/Spearman correlation matrix (reference: CorrelationBatchOp.java)."""

    METHOD = ParamInfo("method", str, default="PEARSON",
                       desc="PEARSON or SPEARMAN")

    _min_inputs = 1
    _max_inputs = 1

    def _selected(self, t_or_schema):
        return _numeric_cols(t_or_schema, self.get(HasSelectedCols.SELECTED_COLS))

    def _execute_impl(self, t: MTable) -> MTable:
        cols = self._selected(t)
        X = t.to_numeric_block(cols, dtype=np.float64)
        if self.get(self.METHOD).upper() == "SPEARMAN":
            X = np.column_stack([_rankdata(X[:, j]) for j in range(X.shape[1])])
        m = _corr_matrix(X)
        self._result = CorrelationResult(cols, m)
        data = {"colName": cols}
        for j, c in enumerate(cols):
            data[c] = m[:, j]
        return MTable(data, schema=TableSchema(
            ["colName"] + cols,
            [AlinkTypes.STRING] + [AlinkTypes.DOUBLE] * len(cols)))

    def _out_schema(self, in_schema: TableSchema) -> TableSchema:
        cols = self._selected(in_schema)
        return TableSchema(["colName"] + cols,
                           [AlinkTypes.STRING] + [AlinkTypes.DOUBLE] * len(cols))

    def collect_correlation(self) -> CorrelationResult:
        self.collect()
        return self._result


class VectorCorrelationBatchOp(BatchOperator, HasSelectedCol):
    """Correlation over a vector column (reference: VectorCorrelationBatchOp.java)."""

    METHOD = ParamInfo("method", str, default="PEARSON")

    _min_inputs = 1
    _max_inputs = 1

    def _execute_impl(self, t: MTable) -> MTable:
        col = self.get(HasSelectedCol.SELECTED_COL)
        X = np.stack([parse_vector(v).to_dense().data for v in t.col(col)])
        if self.get(self.METHOD).upper() == "SPEARMAN":
            X = np.column_stack([_rankdata(X[:, j]) for j in range(X.shape[1])])
        m = _corr_matrix(X)
        names = [f"v{j}" for j in range(m.shape[1])]
        self._result = CorrelationResult(names, m)
        data = {"colName": names}
        for j, c in enumerate(names):
            data[c] = m[:, j]
        return MTable(data, schema=TableSchema(
            ["colName"] + names,
            [AlinkTypes.STRING] + [AlinkTypes.DOUBLE] * len(names)))

    def collect_correlation(self) -> CorrelationResult:
        self.collect()
        return self._result


def chi_square_test(observed: np.ndarray):
    """Pearson chi-square independence test on a contingency table.

    Returns (statistic, p_value, degrees_of_freedom). (reference:
    common/statistics/ChiSquareTestUtil.java → ChiSquareTest.java)."""
    observed = np.asarray(observed, dtype=np.float64)
    n = observed.sum()
    row = observed.sum(axis=1, keepdims=True)
    col = observed.sum(axis=0, keepdims=True)
    expected = row @ col / max(n, 1e-300)
    mask = expected > 0
    stat = float((((observed - expected) ** 2)[mask] / expected[mask]).sum())
    df = (observed.shape[0] - 1) * (observed.shape[1] - 1)
    p = float(1.0 - CDF.chi2(stat, max(df, 1)))
    return stat, p, df


_CHI2_SCHEMA = TableSchema(
    ["col", "chi2", "p", "df"],
    [AlinkTypes.STRING, AlinkTypes.DOUBLE, AlinkTypes.DOUBLE, AlinkTypes.DOUBLE])


def _contingency(a_vals, b_vals) -> np.ndarray:
    _, ai = np.unique(np.asarray(a_vals, dtype=object).astype(str), return_inverse=True)
    _, bi = np.unique(np.asarray(b_vals, dtype=object).astype(str), return_inverse=True)
    table = np.zeros((ai.max() + 1, bi.max() + 1))
    np.add.at(table, (ai, bi), 1.0)
    return table


class ChiSquareTestBatchOp(BatchOperator, HasSelectedCols):
    """Chi-square independence test of each selected column against the label
    column (reference: ChiSquareTestBatchOp.java)."""

    LABEL_COL = ParamInfo("labelCol", str, optional=False)

    _min_inputs = 1
    _max_inputs = 1

    def _execute_impl(self, t: MTable) -> MTable:
        label_col = self.get(self.LABEL_COL)
        cols = self.get(HasSelectedCols.SELECTED_COLS) or [
            c for c in t.names if c != label_col]
        y = t.col(label_col)
        rows = []
        for c in cols:
            stat, p, df = chi_square_test(_contingency(t.col(c), y))
            rows.append((c, stat, p, float(df)))
        return MTable.from_rows(rows, _CHI2_SCHEMA)

    def _out_schema(self, in_schema: TableSchema) -> TableSchema:
        return _CHI2_SCHEMA


class VectorChiSquareTestBatchOp(BatchOperator, HasSelectedCol):
    """Chi-square test of each vector component against the label
    (reference: VectorChiSquareTestBatchOp.java)."""

    LABEL_COL = ParamInfo("labelCol", str, optional=False)

    _min_inputs = 1
    _max_inputs = 1

    def _execute_impl(self, t: MTable) -> MTable:
        col = self.get(HasSelectedCol.SELECTED_COL)
        y = t.col(self.get(self.LABEL_COL))
        X = np.stack([parse_vector(v).to_dense().data for v in t.col(col)])
        rows = []
        for j in range(X.shape[1]):
            stat, p, df = chi_square_test(_contingency(X[:, j], y))
            rows.append((f"v{j}", stat, p, float(df)))
        return MTable.from_rows(rows, _CHI2_SCHEMA)

    def _out_schema(self, in_schema: TableSchema) -> TableSchema:
        return _CHI2_SCHEMA


class QuantileBatchOp(BatchOperator, HasSelectedCols):
    """Per-column quantile points (reference: QuantileBatchOp.java;
    common/statistics/interval quantile sketch collapses to one sort)."""

    QUANTILE_NUM = ParamInfo("quantileNum", int, default=100)

    _min_inputs = 1
    _max_inputs = 1

    def _selected(self, t_or_schema):
        return _numeric_cols(t_or_schema, self.get(HasSelectedCols.SELECTED_COLS))

    def _execute_impl(self, t: MTable) -> MTable:
        cols = self._selected(t)
        q = int(self.get(self.QUANTILE_NUM))
        ps = np.linspace(0.0, 1.0, q + 1)
        data = {"quantile": ps}
        for c in cols:
            arr = np.asarray(t.col(c), np.float64)
            arr = arr[~np.isnan(arr)]
            data[c] = np.quantile(arr, ps) if arr.size else np.full(q + 1, np.nan)
        return MTable(data, schema=self._out_schema(t.schema))

    def _out_schema(self, in_schema: TableSchema) -> TableSchema:
        cols = self._selected(in_schema)
        return TableSchema(["quantile"] + cols,
                           [AlinkTypes.DOUBLE] * (len(cols) + 1))


class VectorSummarizerBatchOp(BatchOperator, HasSelectedCol):
    """Summary over a vector column (reference: VectorSummarizerBatchOp.java)."""

    _min_inputs = 1
    _max_inputs = 1

    def _execute_impl(self, t: MTable) -> MTable:
        col = self.get(HasSelectedCol.SELECTED_COL)
        X = np.stack([parse_vector(v).to_dense().data for v in t.col(col)])
        names = [f"v{j}" for j in range(X.shape[1])]
        expanded = MTable({n: X[:, j] for j, n in enumerate(names)})
        self._summary = summarize(expanded, names)
        return self._summary.to_mtable()

    def _out_schema(self, in_schema: TableSchema) -> TableSchema:
        return summary_schema()

    def collect_vector_summary(self) -> TableSummary:
        self.collect()
        return self._summary


class CovarianceBatchOp(BatchOperator, HasSelectedCols):
    """Covariance matrix (reference: StatisticsHelper covariance path used by
    basicstatistic/TableSummarizer.covariance)."""

    _min_inputs = 1
    _max_inputs = 1

    def _selected(self, t_or_schema):
        return _numeric_cols(t_or_schema, self.get(HasSelectedCols.SELECTED_COLS))

    def _execute_impl(self, t: MTable) -> MTable:
        cols = self._selected(t)
        X = t.to_numeric_block(cols, dtype=np.float64)
        Xc = X - X.mean(axis=0)
        denom = max(X.shape[0] - 1, 1)
        cov = Xc.T @ Xc / denom
        data = {"colName": cols}
        for j, c in enumerate(cols):
            data[c] = cov[:, j]
        return MTable(data, schema=self._out_schema(t.schema))

    def _out_schema(self, in_schema: TableSchema) -> TableSchema:
        cols = self._selected(in_schema)
        return TableSchema(["colName"] + cols,
                           [AlinkTypes.STRING] + [AlinkTypes.DOUBLE] * len(cols))
