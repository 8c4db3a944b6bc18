"""Auto-insights: automatic findings over a table (port of
``alink_tpu.operator.batch.insights``).

Capability parity with the reference's insight engine (reference:
core/src/main/java/com/alibaba/alink/common/insights/AutoDiscovery.java:19
(subspace/breakdown/measure enumeration under a time budget),
Mining.java:73-809 (OutstandingNo1/Top2/Last, Evenness, Attribution,
ChangePoint, Outlier, Trend, Seasonality detectors with p-value-style
scores), CorrelationInsight.java / CrossMeasureCorrelationInsight.java:80-137,
ImpactDetector.java, BreakdownDetector.java, InsightType.java, and
StatInsight/DistributionUtil for the basic-stat/distribution findings).

Re-design: the Flink/LocalOperator aggregation queries collapse into
group-bys over the columnar MTable; every detector scores
into [0, 1] and findings are globally ranked (subspace findings scaled by
the subspace's impact share, the ImpactDetector analog). The taxonomy
matches InsightType.java: outstanding_no1/_top2/_last, evenness,
attribution, change_point, series_outlier, trend, seasonality, correlation,
cross_measure_correlation, clustering_2d, distribution, plus the
column-quality findings (missing_values, constant_column, outliers,
dominant_category) and the breakdown/impact segment findings.

On the device, in float64 as the reference's numpy: the Pearson matrix of
the numeric block, each breakdown's per-segment sums, counts and means of
every measure (``index_add_`` over ``np.unique``'s inverse), and the 2-means
loop of the 2-D clustering. On the host, as in the reference: the column
findings, the detectors over the aggregated series (at most
``_MAX_BREAKDOWN_CARD`` points each) and the ranking."""

from __future__ import annotations

import json
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from ...common.mtable import AlinkTypes, MTable, TableSchema
from ...common.params import ParamInfo
from ...mapper import HasSelectedCols
from .base import BatchOperator

_INSIGHT_SCHEMA = TableSchema(
    ["type", "columns", "score", "description", "detail"],
    [AlinkTypes.STRING, AlinkTypes.STRING, AlinkTypes.DOUBLE,
     AlinkTypes.STRING, AlinkTypes.STRING])

_MAX_BREAKDOWN_CARD = 50
_MIN_SEGMENT_ROWS = 5


def _finding(kind: str, columns: str, score: float, desc: str,
             **detail) -> Tuple[str, str, float, str, str]:
    return (kind, columns, float(min(max(score, 0.0), 1.0)), desc,
            json.dumps(detail, default=str) if detail else "{}")


# ---------------------------------------------------------------------------
# Series detectors (reference: Mining.java — each consumes the aggregated
# measure series of one (breakdown, measure, aggr) subject)
# ---------------------------------------------------------------------------

def _normal_cdf(x: float) -> float:
    from math import erf, sqrt

    return 0.5 * (1.0 + erf(x / sqrt(2.0)))


def _power_law_pvalue(vals: np.ndarray, beta: float, target: float,
                      drop_top: int) -> float:
    """Score an extreme value against a power-law fit of the remaining
    values (reference: Mining.outstandingNo1PValue / outstandingTop2PValue
    — fit y ~ a + b * rank^-beta on the non-extreme values, then the
    normal-tail probability of the observed gap)."""
    rest = np.sort(vals)[: len(vals) - drop_top]
    if rest.size < 2:
        return 0.0
    mu = float(rest.mean())
    sigma = float(rest.std(ddof=1))
    if sigma <= 0:
        return 0.0
    ranks = np.power(np.arange(rest.size, 0, -1, dtype=np.float64), -beta)
    A = np.stack([np.ones_like(ranks), ranks], 1)
    coef, *_ = np.linalg.lstsq(A, np.sort(rest)[::-1], rcond=None)
    pred = float(coef[0] + coef[1] * np.power(float(len(vals)), -beta))
    return _normal_cdf(abs(target - pred) / sigma) * 2.0 - 1.0


def _outstanding_no1(keys: List[str], vals: np.ndarray):
    """(reference: Mining.outstandingNo1 — Mining.java:113-175)"""
    if vals.size <= 2 or vals.min() == vals.max():
        return None
    mx = float(vals.max())
    s = float(vals.sum())
    if mx < 0 or s <= 0 or mx / s < 0.1:
        return None
    score = mx / s if vals.size == 3 else _power_law_pvalue(
        vals, 0.7, mx, drop_top=1)
    return score, keys[int(vals.argmax())], mx


def _outstanding_top2(keys: List[str], vals: np.ndarray):
    """(reference: Mining.outstandingTop2 — Mining.java:245-327)"""
    if vals.size <= 3 or vals.min() == vals.max():
        return None
    order = np.argsort(vals)[::-1]
    mx, mx2 = float(vals[order[0]]), float(vals[order[1]])
    s = float(vals.sum())
    if mx2 <= 0 or s <= 0 or (mx + mx2) / s < 0.2:
        return None
    score = _power_law_pvalue(vals, 0.7, mx2, drop_top=2)
    return score, [keys[int(order[0])], keys[int(order[1])]], mx + mx2


def _outstanding_last(keys: List[str], vals: np.ndarray):
    """(reference: Mining.outstandingNoLast — Mining.java:176-244; the
    clearly-most-negative segment)"""
    if vals.size <= 2 or vals.min() == vals.max():
        return None
    mn = float(vals.min())
    if mn >= 0:
        return None
    if vals.size == 3:
        rest = np.sort(np.abs(vals))[::-1]
        score = abs(mn) / max(rest[0] + rest[1], 1e-12)
    else:
        score = _power_law_pvalue(-vals, 0.7, -mn, drop_top=1)
    return score, keys[int(vals.argmin())], mn


def _evenness(vals: np.ndarray):
    """(reference: Mining.even — Mining.java:328-383: chi-square test that
    the aggregated shares are uniform)"""
    if vals.size < 3 or vals.min() < 0:
        return None
    s = float(vals.sum())
    if s <= 0:
        return None
    mean = s / vals.size
    if mean == 0:
        return None
    chi = float(((vals - mean) ** 2 / max(mean, 1e-12)).sum())
    # small chi-square => even; map through the survival-ish transform the
    # reference uses (score 0.6 for an exactly-even split, decayed by chi)
    score = 0.6 * float(np.exp(-chi / (2.0 * vals.size)))
    return score if score > 0.3 else None


def _attribution(keys: List[str], vals: np.ndarray):
    """(reference: Mining.attribution — Mining.java:384-441: one segment
    carries >50% of a non-negative total)"""
    if vals.size < 2 or vals.min() < 0:
        return None
    s = float(vals.sum())
    if s <= 0:
        return None
    i = int(vals.argmax())
    share = float(vals[i]) / s
    if share <= 0.5:
        return None
    return min(share * 1.001, 1.0), keys[i], share


def _change_point(vals: np.ndarray):
    """(reference: Mining.changePoint — Mining.java:442-537: Welch t-test
    at every interior index; the largest normalized |t| wins)"""
    n = vals.size
    if n < 6:
        return None
    best, best_i = 0.0, -1
    csum = np.cumsum(vals)
    csum2 = np.cumsum(vals * vals)
    for i in range(2, n - 2):
        nl, nr = i, n - i
        sl, sr = csum[i - 1], csum[-1] - csum[i - 1]
        s2l, s2r = csum2[i - 1], csum2[-1] - csum2[i - 1]
        ml, mr = sl / nl, sr / nr
        vl = max(s2l / nl - ml * ml, 0.0)
        vr = max(s2r / nr - mr * mr, 0.0)
        se = np.sqrt(vl / nl + vr / nr)
        if se <= 1e-12:
            continue
        t = abs(ml - mr) / se
        if t > best:
            best, best_i = t, i
    if best_i < 0:
        return None
    score = _normal_cdf(best) * 2.0 - 1.0
    return (score, best_i) if score > 0.5 else None


def _series_outlier(keys: List[str], vals: np.ndarray):
    """(reference: Mining.outlier — Mining.java:538-627: points far outside
    the distribution of the aggregated series)"""
    if vals.size < 8:
        return None
    med = float(np.median(vals))
    mad = float(np.median(np.abs(vals - med)))
    scale = mad * 1.4826 if mad > 0 else float(vals.std())
    if scale <= 0:
        return None
    z = np.abs(vals - med) / scale
    i = int(z.argmax())
    if z[i] < 3.5:
        return None
    score = _normal_cdf(float(z[i])) * 2.0 - 1.0
    return score, keys[i], float(vals[i])


def _trend(vals: np.ndarray):
    """(reference: Mining.trend — Mining.java:628-682: least-squares line
    over the ordered series, scored by r^2 damped through the reference's
    slope logistic)"""
    n = vals.size
    if n < 5 or vals.min() == vals.max():
        return None
    x = np.arange(n, dtype=np.float64)
    sd = vals.std()
    if sd <= 0:
        return None
    # raw-scale slope feeds the logistic damping exactly as the reference
    # does (Mining.java:656-658: p = 1 - sigmoid((slope - 0.2) / 2))
    slope, intercept = np.polyfit(x, vals, 1)
    pred = slope * x + intercept
    ss_res = float(((vals - pred) ** 2).sum())
    ss_tot = float(((vals - vals.mean()) ** 2).sum())
    r2 = 1.0 - ss_res / max(ss_tot, 1e-12)
    p = 1.0 - 1.0 / (1.0 + np.exp(-(float(slope) - 0.2) / 2.0))
    score = r2 * (1.0 - float(p))
    if score < 0.4:
        return None
    return score, float(slope), r2


def _acf(x: np.ndarray, max_lag: int) -> np.ndarray:
    x = x - x.mean()
    denom = float((x * x).sum())
    if denom <= 0:
        return np.zeros(max_lag + 1)
    return np.array([
        float((x[: len(x) - k] * x[k:]).sum()) / denom
        for k in range(max_lag + 1)
    ])


def _seasonality(vals: np.ndarray):
    """(reference: Mining.seasonality — Mining.java:692-809: the dominant
    autocorrelation lag >= 2 scores the periodicity)"""
    n = vals.size
    if n < 8 or vals.min() == vals.max():
        return None
    acf = _acf(vals.astype(np.float64), min(n // 2, 12))
    if acf.size <= 2:
        return None
    lag = int(np.argmax(acf[2:])) + 2
    score = float(acf[lag])
    if score <= 0.3:
        return None
    return score, lag


# ---------------------------------------------------------------------------
# Device aggregates (float64, the reference's numpy arithmetic)
# ---------------------------------------------------------------------------

def _pearson(X: np.ndarray, device) -> Optional[np.ndarray]:
    """``np.corrcoef`` of the columns of ``X`` over its rows without a NaN,
    on ``device``; None where two rows or fewer remain."""
    import torch

    Z = torch.tensor(X, dtype=torch.float64, device=device)
    Z = Z[~torch.isnan(Z).any(dim=1)]
    if Z.shape[0] <= 2:
        return None
    Z = Z - Z.mean(dim=0)
    c = (Z.T @ Z) * (1.0 / (Z.shape[0] - 1))   # np.cov's scaling
    sd = torch.sqrt(torch.diagonal(c))
    c = c / sd[:, None]
    c = c / sd[None, :]
    return torch.clamp(c, -1.0, 1.0).cpu().numpy()


class _MeasureBlock:
    """The measures of one (sub)space as one (rows, measures) float64 block
    on the device, NaNs zeroed under a validity mask; ``segments`` reduces
    it over one breakdown's segment ids."""

    def __init__(self, num_arrays: Dict[str, np.ndarray], n: int, device):
        import torch

        arrays = list(num_arrays.values())
        self._host = arrays
        self._stats: Dict[int, Tuple[float, float]] = {}
        self.valid = np.asarray([int((~np.isnan(a)).sum()) for a in arrays])
        X = torch.as_tensor(
            np.stack(arrays, 1) if arrays else np.zeros((n, 0)),
            dtype=torch.float64, device=device)
        ok = ~torch.isnan(X)
        self._ok = ok.to(torch.float64)
        self._X = torch.where(ok, X, torch.zeros((), dtype=X.dtype,
                                                  device=device))
        self._ones = torch.ones(n, dtype=torch.float64, device=device)
        self._device = device

    def segments(self, seg_inv: np.ndarray, k: int):
        """(rows per segment, valid values per segment and measure, their
        sums, their means): ``index_add_`` over the segment ids."""
        import torch

        idx = torch.as_tensor(seg_inv, dtype=torch.int64,
                              device=self._device)
        m = self._X.shape[1]
        rows = torch.zeros(k, dtype=torch.float64, device=self._device)
        rows.index_add_(0, idx, self._ones)
        cnt = torch.zeros((k, m), dtype=torch.float64, device=self._device)
        cnt.index_add_(0, idx, self._ok)
        sums = torch.zeros((k, m), dtype=torch.float64, device=self._device)
        sums.index_add_(0, idx, self._X)
        means = sums / torch.clamp(cnt, min=1.0)
        rows, cnt, sums, means = (a.cpu().numpy()
                                  for a in (rows, cnt, sums, means))
        return rows.astype(np.int64), cnt.astype(np.int64), sums, means

    def overall(self, j: int) -> Tuple[float, float]:
        """Mean and population std of measure ``j``'s valid values (host
        numpy, once per measure)."""
        if j not in self._stats:
            a = self._host[j]
            ok = a[~np.isnan(a)]
            self._stats[j] = (float(ok.mean()), float(ok.std()))
        return self._stats[j]


def _two_means(a: np.ndarray, b: np.ndarray, device):
    """The reference's 2-means Lloyd loop over the standardised pair on
    ``device``: (score, size of cluster 0, size of cluster 1), or None when
    one cluster empties."""
    import torch

    X = torch.as_tensor(np.stack([a, b], 1), dtype=torch.float64,
                        device=device)
    X = (X - X.mean(dim=0)) / X.std(dim=0, correction=0)
    c0, c1 = X[torch.argmin(X[:, 0])], X[torch.argmax(X[:, 0])]
    for _ in range(10):
        d0 = ((X - c0) ** 2).sum(dim=1)
        d1 = ((X - c1) ** 2).sum(dim=1)
        lab = d1 < d0
        n1 = int(lab.sum())
        if n1 in (0, X.shape[0]):
            return None
        c0, c1 = X[~lab].mean(dim=0), X[lab].mean(dim=0)
    d0 = ((X - c0) ** 2).sum(dim=1)
    d1 = ((X - c1) ** 2).sum(dim=1)
    sep = float(torch.linalg.norm(c1 - c0))
    spread = float(torch.sqrt(d1[lab].mean() + d0[~lab].mean()))
    return sep / max(sep + spread, 1e-12), X.shape[0] - n1, n1


# ---------------------------------------------------------------------------
# The discovery op
# ---------------------------------------------------------------------------

class AutoDiscoveryBatchOp(BatchOperator, HasSelectedCols):
    """(reference: common/insights/AutoDiscovery.java:19 ``find(data,
    limitedSeconds)``; detector taxonomy InsightType.java)

    **Time-budget contract** (``timeLimitSeconds``): discovery is
    best-effort under the budget. Every mining stage (column quality,
    correlations, subject mining, subspace drill-down, 2-D clustering)
    checks the deadline between units of work and stops early when it is
    exhausted — the op then RETURNS the findings ranked so far instead of
    silently overrunning. An exhausted budget is observable: the
    ``insights.time_budget_exhausted`` counter is bumped once per run that
    was cut short. The return value is always a valid findings table (at
    worst empty, with the standard schema)."""

    TOP_N = ParamInfo("topN", int, default=20)
    TIME_LIMIT_SECONDS = ParamInfo(
        "timeLimitSeconds", float, default=30.0,
        desc="wall budget for discovery; on exhaustion the findings "
             "collected so far are ranked and returned (best-effort)")

    _min_inputs = 1
    _max_inputs = 1

    def _execute_impl(self, t: MTable) -> MTable:
        deadline = time.monotonic() + float(self.get(self.TIME_LIMIT_SECONDS))
        self._budget_hit = False
        self._device = self.env.device
        findings: List[Tuple[str, str, float, str, str]] = []
        cols = list(self.get(HasSelectedCols.SELECTED_COLS) or t.names)
        numeric = [c for c in cols
                   if AlinkTypes.is_numeric(t.schema.type_of(c))]
        categorical = [c for c in cols
                       if t.schema.type_of(c) == AlinkTypes.STRING]
        n = max(t.num_rows, 1)

        num_arrays: Dict[str, np.ndarray] = {
            c: np.asarray(t.col(c), np.float64) for c in numeric}
        cat_arrays: Dict[str, np.ndarray] = {
            c: np.asarray(t.col(c), object).astype(str) for c in categorical}

        self._column_findings(findings, num_arrays, cat_arrays, n, deadline)
        self._correlations(findings, t, numeric, deadline)

        # breakdown subjects in the full space (impact 1.0), then within the
        # highest-impact subspaces (reference: AutoDiscovery.find — the
        # ImpactDetector pass at AutoDiscovery.java:84-125)
        breakdowns = [
            c for c in categorical
            if 2 <= len(np.unique(cat_arrays[c])) <= _MAX_BREAKDOWN_CARD]
        self._mine_subjects(findings, breakdowns, cat_arrays, num_arrays,
                            impact=1.0, subspace="", deadline=deadline)

        for sub_col, sub_val, impact in self._top_subspaces(
                cat_arrays, num_arrays, n):
            if self._expired(deadline):
                break
            sel = cat_arrays[sub_col] == sub_val
            sub_cats = {c: v[sel] for c, v in cat_arrays.items()
                        if c != sub_col}
            sub_nums = {c: v[sel] for c, v in num_arrays.items()}
            sub_bds = [
                c for c in sub_cats
                if 2 <= len(np.unique(sub_cats[c])) <= _MAX_BREAKDOWN_CARD]
            self._mine_subjects(
                findings, sub_bds, sub_cats, sub_nums, impact=impact,
                subspace=f"{sub_col}={sub_val!r}", deadline=deadline)

        self._clustering_2d(findings, num_arrays, deadline)

        if self._budget_hit:  # only runs that actually truncated work count
            from ...common.metrics import metrics

            metrics.incr("insights.time_budget_exhausted")

        findings = self._rank(findings)[: self.get(self.TOP_N)]
        if not findings:
            return MTable(
                {k: np.asarray([], np.float64) if k == "score"
                 else np.asarray([], object)
                 for k in _INSIGHT_SCHEMA.names}, _INSIGHT_SCHEMA)
        return MTable.from_rows(findings, _INSIGHT_SCHEMA)

    def _expired(self, deadline) -> bool:
        """Deadline probe every mining stage calls between units of work;
        remembers that the budget ran out for the end-of-run counter."""
        if time.monotonic() > deadline:
            self._budget_hit = True
            return True
        return False

    # -- column-quality + stat findings ------------------------------------
    def _column_findings(self, findings, num_arrays, cat_arrays, n, deadline):
        """missing/constant/outlier/dominant + basic-stat + distribution
        (reference: StatInsight + DistributionUtil; AutoDiscovery.basicStat
        — AutoDiscovery.java:127-142)."""
        for c, arr in num_arrays.items():
            if self._expired(deadline):
                return
            miss = float(np.isnan(arr).mean())
            if miss > 0.05:
                findings.append(_finding(
                    "missing_values", c, miss,
                    f"{c}: {miss:.1%} of values are missing",
                    missing_fraction=miss))
            ok = arr[~np.isnan(arr)]
            if ok.size <= 1:
                continue
            std = float(ok.std())
            if std < 1e-12:
                findings.append(_finding(
                    "constant_column", c, 1.0,
                    f"{c} is constant ({ok[0]:g})", value=float(ok[0])))
                continue
            z = np.abs(ok - ok.mean()) / std
            frac_out = float((z > 3).mean())
            if frac_out > 0.01:
                findings.append(_finding(
                    "outliers", c, frac_out,
                    f"{c}: {frac_out:.1%} of values beyond 3 sigma",
                    fraction=frac_out))
            # distribution shape (reference: Distribution insight type):
            # strong skew or heavy tails on a real-valued column
            mean = float(ok.mean())
            skew = float(((ok - mean) ** 3).mean() / std ** 3)
            kurt = float(((ok - mean) ** 4).mean() / std ** 4) - 3.0
            if abs(skew) > 2.0 or kurt > 7.0:
                shape = ("right-skewed" if skew > 2.0 else
                         "left-skewed" if skew < -2.0 else "heavy-tailed")
                score = min(max(abs(skew) / 10.0, kurt / 20.0), 0.9)
                findings.append(_finding(
                    "distribution", c, score,
                    f"{c} is {shape} (skew={skew:.2f}, "
                    f"excess kurtosis={kurt:.2f})", skew=skew, kurtosis=kurt))

        for c, vals_str in cat_arrays.items():
            if self._expired(deadline):
                return
            vals, counts = np.unique(vals_str, return_counts=True)
            top_frac = float(counts.max() / n)
            if len(vals) > 1 and top_frac > 0.8:
                findings.append(_finding(
                    "dominant_category", c, top_frac,
                    f"{c}: {vals[counts.argmax()]!r} covers "
                    f"{top_frac:.1%} of rows",
                    value=str(vals[counts.argmax()]), fraction=top_frac))

    # -- raw-column correlation + cross-measure ----------------------------
    def _correlations(self, findings, t, numeric, deadline):
        """(reference: CorrelationInsight.java — pairwise Pearson over raw
        measures)."""
        if len(numeric) < 2 or self._expired(deadline):
            return
        corr = _pearson(t.to_numeric_block(numeric, dtype=np.float64),
                        self._device)
        if corr is None:
            return
        for i in range(len(numeric)):
            for j in range(i + 1, len(numeric)):
                r = float(corr[i, j])
                if abs(r) > 0.8:
                    findings.append(_finding(
                        "correlation", f"{numeric[i]},{numeric[j]}", abs(r),
                        f"{numeric[i]} and {numeric[j]} correlate "
                        f"(r={r:.3f})", r=r))

    # -- subject mining ----------------------------------------------------
    def _mine_subjects(self, findings, breakdowns, cat_arrays, num_arrays,
                       *, impact, subspace, deadline):
        """Enumerate (breakdown, measure, aggr) subjects and run the series
        detectors on each aggregated series (reference:
        AutoDiscovery.findInSingleSubspace — AutoDiscovery.java:144-251)."""
        prefix = f"[{subspace}] " if subspace else ""
        measures = list(num_arrays)
        block = None
        for bd in breakdowns:
            if self._expired(deadline):
                return
            if block is None:
                block = _MeasureBlock(num_arrays, len(cat_arrays[bd]),
                                      self._device)
            seg_vals_np, seg_inv = np.unique(cat_arrays[bd],
                                             return_inverse=True)
            keys = [str(v) for v in seg_vals_np]
            # ordered breakdown => series detectors apply (the reference
            # gates trend/seasonality/changepoint on timestamp breakdowns).
            # All-numeric labels sort numerically — '2' before '10' — so
            # month-style keys don't scramble the series; otherwise the
            # lexical order covers zero-padded ordinal labels
            try:
                order = np.argsort([float(s) for s in keys], kind="stable")
            except ValueError:
                order = np.arange(len(keys))
            if not np.array_equal(order, np.arange(len(keys))):
                remap = np.empty(len(keys), np.int64)
                remap[order] = np.arange(len(keys))
                seg_inv = remap[seg_inv]
                keys = [keys[i] for i in order]
            k = len(keys)
            counts_all, cnts, sums, means = block.segments(seg_inv, k)
            agg_series = {}
            for j, m in enumerate(measures):
                if block.valid[j] < 2 * _MIN_SEGMENT_ROWS:
                    continue
                cnt = cnts[:, j]
                if (cnt < 1).any():
                    continue
                agg_series[(m, "sum")] = sums[:, j]
                agg_series[(m, "mean")] = means[:, j]
                self._segment_findings(
                    findings, bd, m, keys, cnt, sums[:, j], means[:, j],
                    *block.overall(j), impact, prefix)
            if k >= 3:
                cv = counts_all.astype(np.float64)
                ev = _evenness(cv)
                if ev is not None:
                    findings.append(_finding(
                        "evenness", f"count by {bd}", ev * impact,
                        f"{prefix}rows spread evenly across the {k} "
                        f"values of {bd}", breakdown=bd, subspace=subspace))
            for (m, aggr), series in agg_series.items():
                self._series_findings(findings, bd, m, aggr, keys, series,
                                      impact, prefix, subspace)

    def _segment_findings(self, findings, bd, m, keys, cnt, sums, means,
                          overall_mean, overall_std, impact, prefix):
        """breakdown/impact segment findings (reference:
        BreakdownDetector.java + ImpactDetector.java)."""
        with np.errstate(invalid="ignore", divide="ignore"):
            se = overall_std / np.sqrt(np.maximum(cnt, 1))
            z = np.abs(means - overall_mean) / np.maximum(se, 1e-12)
        big = (cnt >= _MIN_SEGMENT_ROWS) & (z > 3.0)
        for si in np.flatnonzero(big):
            delta = means[si] - overall_mean
            findings.append(_finding(
                "breakdown", f"{m} by {bd}={keys[si]}",
                min(float(z[si]) / 10.0, 1.0) * impact,
                f"{prefix}{m} averages {means[si]:g} for {bd}="
                f"{keys[si]!r} vs {overall_mean:g} overall "
                f"({'+' if delta >= 0 else ''}{delta:g}, "
                f"z={z[si]:.1f}, n={int(cnt[si])})",
                breakdown=bd, measure=m, segment=keys[si],
                z=float(z[si])))
        total = float(sums.sum())
        if abs(total) > 1e-12 and np.all(sums >= 0):
            contrib = sums / total
            si = int(np.argmax(contrib))
            if contrib[si] > 0.5 and len(keys) > 2:
                findings.append(_finding(
                    "impact", f"{m} from {bd}={keys[si]}",
                    float(contrib[si]) * impact,
                    f"{prefix}{bd}={keys[si]!r} contributes "
                    f"{contrib[si]:.1%} of total {m} "
                    f"across {len(keys)} segments",
                    breakdown=bd, measure=m, segment=keys[si],
                    share=float(contrib[si])))

    def _series_findings(self, findings, bd, m, aggr, keys, series, impact,
                         prefix, subspace):
        vals = np.asarray(series, np.float64)
        label = f"{aggr}({m}) by {bd}"
        detail = dict(breakdown=bd, measure=m, aggr=aggr, subspace=subspace)

        r = _outstanding_no1(keys, vals)
        if r is not None and r[0] > 0.5:
            findings.append(_finding(
                "outstanding_no1", label, r[0] * impact,
                f"{prefix}{label}: {bd}={r[1]!r} stands out "
                f"({aggr}={r[2]:g})", focus=r[1], **detail))
        r = _outstanding_top2(keys, vals)
        if r is not None and r[0] > 0.5:
            findings.append(_finding(
                "outstanding_top2", label, r[0] * impact,
                f"{prefix}{label}: {bd} in {r[1]} together dominate "
                f"(sum={r[2]:g})", focus=r[1], **detail))
        r = _outstanding_last(keys, vals)
        if r is not None and r[0] > 0.5:
            findings.append(_finding(
                "outstanding_last", label, r[0] * impact,
                f"{prefix}{label}: {bd}={r[1]!r} is the clear negative "
                f"extreme ({aggr}={r[2]:g})", focus=r[1], **detail))
        if aggr == "sum":
            r = _attribution(keys, vals)
            if r is not None:
                findings.append(_finding(
                    "attribution", label, r[0] * impact,
                    f"{prefix}{bd}={r[1]!r} accounts for {r[2]:.1%} "
                    f"of {aggr}({m})", focus=r[1], **detail))
        r = _series_outlier(keys, vals)
        if r is not None:
            findings.append(_finding(
                "series_outlier", label, r[0] * impact,
                f"{prefix}{label}: value at {bd}={r[1]!r} ({r[2]:g}) "
                f"is a series outlier", focus=r[1], **detail))
        r = _change_point(vals)
        if r is not None:
            findings.append(_finding(
                "change_point", label, r[0] * impact,
                f"{prefix}{label} shifts level at {bd}={keys[r[1]]!r}",
                focus=keys[r[1]], **detail))
        r = _trend(vals)
        if r is not None:
            findings.append(_finding(
                "trend", label, r[0] * impact,
                f"{prefix}{label} {'rises' if r[1] > 0 else 'falls'} "
                f"across ordered {bd} (r2={r[2]:.2f})",
                slope=r[1], r2=r[2], **detail))
        r = _seasonality(vals)
        if r is not None:
            findings.append(_finding(
                "seasonality", label, r[0] * impact,
                f"{prefix}{label} repeats with period {r[1]} "
                f"(acf={r[0]:.2f})", period=r[1], **detail))

    def _top_subspaces(self, cat_arrays, num_arrays, n,
                       max_subspaces: int = 3):
        """Highest-impact (col, value) filters (reference:
        ImpactDetector.listSubspaceByCol — impact = the subspace's share of
        rows; only sufficiently heavy subspaces are mined)."""
        cands = []
        for c, vals_str in cat_arrays.items():
            vals, counts = np.unique(vals_str, return_counts=True)
            if not 2 <= len(vals) <= _MAX_BREAKDOWN_CARD:
                continue
            for v, cnt in zip(vals, counts):
                share = cnt / n
                if 0.1 <= share < 1.0 and cnt >= 4 * _MIN_SEGMENT_ROWS:
                    cands.append((str(c), str(v), float(share)))
        cands.sort(key=lambda x: -x[2])
        return cands[:max_subspaces]

    def _clustering_2d(self, findings, num_arrays, deadline,
                       max_pairs: int = 10):
        """(reference: ScatterplotClusteringInsight.java — KMeans over a
        2-D measure pair, scored by separation). A 2-means Lloyd loop with
        a silhouette-style score; only clearly-bimodal pairs surface."""
        cols = [c for c, v in num_arrays.items()
                if np.isfinite(v).all() and v.std() > 0]
        pairs = [(a, b) for i, a in enumerate(cols) for b in cols[i + 1:]]
        for a, b in pairs[:max_pairs]:
            if self._expired(deadline):
                return
            if num_arrays[a].shape[0] < 20:
                continue
            r = _two_means(num_arrays[a], num_arrays[b], self._device)
            if r is None:
                continue
            score, n0, n1 = r
            if score > 0.65:
                findings.append(_finding(
                    "clustering_2d", f"{a},{b}", score,
                    f"({a}, {b}) separates into two clusters "
                    f"({n0} vs {n1} points)", sizes=[n0, n1]))

    def _rank(self, findings):
        """Global ranking with per-(type, subject-family) decay so one loud
        subject does not flood the list (reference: InsightDecay.java)."""
        findings.sort(key=lambda f: -f[2])
        seen: Dict[Tuple[str, str], int] = {}
        out = []
        for f in findings:
            fam = (f[0], f[1].split(" by ")[-1].split("=")[0])
            k = seen.get(fam, 0)
            seen[fam] = k + 1
            out.append((f[0], f[1], f[2] * (0.8 ** k), f[3], f[4]))
        out.sort(key=lambda f: -f[2])
        return out

    def _out_schema(self, in_schema):
        return _INSIGHT_SCHEMA
