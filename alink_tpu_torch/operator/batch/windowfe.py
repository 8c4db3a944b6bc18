"""Window feature generation: tumble/hop/session aggregates + per-row
trailing ("latest") statistics (port of
``alink_tpu.operator.batch.windowfe``, without pandas).

Capability parity with the reference's fe subsystem (reference:
core/src/main/java/com/alibaba/alink/common/fe/GenerateFeatureUtil.java —
group → sort by time → window index discovery → per-window stats;
operator/batch/feature/GenerateFeatureOfWindowBatchOp.java,
GenerateFeatureOfLatestBatchOp.java, GenerateFeatureOfLatestNDaysBatchOp.java;
stat set at common/fe/define/statistics/BaseNumericStatistics.java).

Each (group, target) is computed columnarly: one sort by (group, time),
window boundaries via ``searchsorted``, every additive stat as a
prefix-sum difference over the group's sorted values (the reference's
arithmetic, so the columns are bit-identical), and MAX/MIN as a sparse table
of the group's values (exact, O(n log n) a group). Groups are contiguous
slices of the sorted rows, found once.

Two departures from the reference, both in ROADMAP's "Differences by
design": timestamp strings are parsed over numpy (ISO 8601 with a space or
``T``, an optional fraction, or a date alone; any other string raises
``AkIllegalDataException`` naming it) into epoch nanoseconds / 1e9, where
the reference's ``pd.to_datetime(...).astype("int64") / 1e9`` divides
pandas' inferred unit (microseconds from pandas 3 on) by 1e9; and the
trailing extremes are pandas' rolling max/min rebuilt (NaN skipped, a window
of the declared rows or a trailing time span closed on both ends, its
bounds in integer nanoseconds as pandas computes them).
"""

from __future__ import annotations

import json
import re
from typing import Dict, List, Sequence, Tuple

import numpy as np

from ...common.exceptions import (AkIllegalArgumentException,
                                  AkIllegalDataException)
from ...common.mtable import AlinkTypes, MTable, TableSchema
from ...common.params import ParamInfo
from .base import BatchOperator

STAT_TYPES = ("COUNT", "SUM", "AVG", "MEAN", "MAX", "MIN", "STDDEV",
              "FIRST", "LAST")

_TIMESTAMP = re.compile(
    r"\d{4}-\d{2}-\d{2}(?:[ T]\d{2}:\d{2}(?::\d{2}(?:\.\d{1,9})?)?)?")


def _epoch_nanos(col) -> np.ndarray:
    """Epoch nanoseconds (int64) of a column of timestamps: datetime64
    values, ``datetime`` objects, or ISO 8601 strings."""
    arr = np.asarray(col)
    if arr.dtype.kind == "M":
        return arr.astype("datetime64[ns]").astype(np.int64)
    uniq, inv = np.unique(arr.astype(object).astype(str), return_inverse=True)
    for s in uniq:
        if not _TIMESTAMP.fullmatch(s):
            raise AkIllegalDataException(
                f"cannot parse timestamp {s!r}: expected ISO 8601 "
                f"'YYYY-MM-DD[( |T)hh:mm[:ss[.fraction]]]'")
    stamps = np.asarray([s.replace(" ", "T") for s in uniq],
                        dtype="datetime64[ns]")
    return stamps.astype(np.int64)[inv.reshape(-1)]


def _epoch_seconds(col: np.ndarray) -> np.ndarray:
    """Numeric columns pass through; timestamps become epoch seconds."""
    arr = np.asarray(col)
    if arr.dtype.kind in ("i", "u", "f"):
        return arr.astype(np.float64)
    return _epoch_nanos(arr) / 1e9


def _parse_defs(raw) -> List[dict]:
    if isinstance(raw, str):
        raw = json.loads(raw)
    if isinstance(raw, dict):
        raw = [raw]
    out = []
    for d in raw:
        d = dict(d)
        d.setdefault("groupCols", [])
        stats = [s.upper() for s in d.get("statTypes", ["SUM"])]
        for s in stats:
            if s not in STAT_TYPES:
                raise AkIllegalArgumentException(
                    f"unknown statType '{s}'; supported: {STAT_TYPES}")
        d["statTypes"] = stats
        if not d.get("targetCols"):
            raise AkIllegalArgumentException(
                "feature definition needs targetCols")
        out.append(d)
    return out


def _group_ids(t: MTable, group_cols: Sequence[str]
               ) -> Tuple[np.ndarray, List[tuple]]:
    """(gid per row, list of group key tuples by gid), gids in order of
    first appearance."""
    if not group_cols:
        return np.zeros(t.num_rows, np.int64), [()]
    cols = [np.asarray(t.col(c), object) for c in group_cols]
    keys = list(zip(*[c.tolist() for c in cols]))
    uniq: Dict[tuple, int] = {}
    gid = np.empty(len(keys), np.int64)
    for i, k in enumerate(keys):
        g = uniq.get(k)
        if g is None:
            g = uniq[k] = len(uniq)
        gid[i] = g
    return gid, list(uniq.keys())


def _group_slices(gids: np.ndarray, num_groups: int) -> np.ndarray:
    """Row bounds (num_groups + 1,) of each gid in rows sorted by gid."""
    return np.searchsorted(gids, np.arange(num_groups + 1), side="left")


def _sparse_table(vals: np.ndarray, red) -> List[np.ndarray]:
    """``table[k][i] = red(vals[i : i + 2**k])``."""
    table = [vals]
    k = 1
    while 2 * k <= len(vals):
        prev = table[-1]
        table.append(red(prev[:-k], prev[k:]))
        k *= 2
    return table


def _range_extreme(vals: np.ndarray, starts: np.ndarray, ends: np.ndarray,
                   red) -> np.ndarray:
    """``red`` over ``vals[starts[i]:ends[i]]`` for nonempty windows."""
    table = _sparse_table(vals, red)
    length = ends - starts
    k = np.floor(np.log2(np.maximum(length, 1))).astype(np.int64)
    out = np.empty(len(starts), np.float64)
    for level in np.unique(k):
        sel = k == level
        row = table[level]
        out[sel] = red(row[starts[sel]], row[ends[sel] - (1 << level)])
    return out


def _window_stat(vals: np.ndarray, starts: np.ndarray, ends: np.ndarray,
                 stat: str) -> np.ndarray:
    """stat over vals[starts[i]:ends[i]] for every window i, via prefix
    sums (the reference's arithmetic) or a sparse table for the extremes
    — no per-window loop."""
    n = len(vals)
    cnt = (ends - starts).astype(np.float64)
    safe = np.maximum(cnt, 1.0)
    if stat == "COUNT":
        return cnt
    if stat in ("SUM", "AVG", "MEAN", "STDDEV"):
        cs = np.concatenate([[0.0], np.cumsum(vals)])
        s = cs[ends] - cs[starts]
    if stat == "SUM":
        return s
    if stat in ("AVG", "MEAN"):
        return np.where(cnt > 0, s / safe, np.nan)
    if stat == "STDDEV":
        cs2 = np.concatenate([[0.0], np.cumsum(vals * vals)])
        ss = cs2[ends] - cs2[starts]
        var = np.where(cnt > 1,
                       (ss - s * s / safe) / np.maximum(cnt - 1, 1.0), np.nan)
        return np.sqrt(np.maximum(var, 0.0))
    if stat == "FIRST":
        return np.where(cnt > 0, vals[np.minimum(starts, n - 1)], np.nan)
    if stat == "LAST":
        return np.where(cnt > 0, vals[np.maximum(ends - 1, 0)], np.nan)
    if stat in ("MAX", "MIN"):
        # np.maximum/np.minimum propagate NaN, as the reference's reduceat
        red = np.maximum if stat == "MAX" else np.minimum
        out = np.full(len(starts), np.nan)
        nonempty = cnt > 0
        if n and nonempty.any():
            out[nonempty] = _range_extreme(vals, starts[nonempty],
                                           ends[nonempty], red)
        return out
    raise AkIllegalArgumentException(stat)


def _feature_col_name(target: str, stat: str, suffix: str) -> str:
    return f"{target}_{stat.lower()}_{suffix}"


def _window_bounds(tg: np.ndarray, d: dict, wtype: str):
    """(window starts, ends, first row, end row) of one group's sorted
    times, empty windows dropped."""
    if wtype == "TUMBLE":
        size = float(d["windowTime"])
        w0 = np.floor(tg[0] / size) * size
        # arange stop is exclusive: tg[-1] + size guarantees a start <=
        # tg[-1], so boundary-exact rows keep a window
        starts_t = np.arange(w0, tg[-1] + size, size)
        ends_t = starts_t + size
    elif wtype == "HOP":
        size = float(d["windowTime"])
        hop = float(d.get("hopTime", size))
        # earliest aligned window COVERING tg[0]: start in (tg[0]-size, tg[0]]
        w0 = np.floor((tg[0] - size) / hop) * hop + hop
        starts_t = np.arange(w0, tg[-1] + hop, hop)
        ends_t = starts_t + size
    elif wtype == "SESSION":
        gap = float(d.get("sessionGapTime", d.get("windowTime", 1)))
        cut = np.flatnonzero(np.diff(tg) > gap) + 1
        si = np.concatenate([[0], cut])
        ei = np.concatenate([cut, [len(tg)]])
        return tg[si], tg[ei - 1] + 1e-9, si, ei
    else:
        raise AkIllegalArgumentException(
            f"windowType '{wtype}' not in TUMBLE|HOP|SESSION")
    si = np.searchsorted(tg, starts_t, side="left")
    ei = np.searchsorted(tg, ends_t, side="left")
    keep = ei > si
    return starts_t[keep], ends_t[keep], si[keep], ei[keep]


class GenerateFeatureOfWindowBatchOp(BatchOperator):
    """Per-(group, window) aggregate rows. ``featureDefinitions``: list of
    {groupCols, timeCol?, windowType: TUMBLE|HOP|SESSION, windowTime,
    hopTime?, sessionGapTime?, targetCols, statTypes} (times in the time
    column's units, i.e. seconds for timestamps).
    (reference: GenerateFeatureOfWindowBatchOp.java)"""

    TIME_COL = ParamInfo("timeCol", str, optional=False)
    FEATURE_DEFINITIONS = ParamInfo("featureDefinitions", (list, dict, str),
                                    optional=False)

    _min_inputs = 1
    _max_inputs = 1

    def _execute_impl(self, t: MTable) -> MTable:
        time_col = self.get(self.TIME_COL)
        defs = _parse_defs(self.get(self.FEATURE_DEFINITIONS))
        gsets = {tuple(d["groupCols"]) for d in defs}
        wspecs = {(d.get("windowType", "TUMBLE").upper(),
                   float(d.get("windowTime", 0)),
                   float(d.get("hopTime", d.get("windowTime", 0)) or 0),
                   float(d.get("sessionGapTime",
                               d.get("windowTime", 0)) or 0))
                  for d in defs}
        if len(gsets) > 1 or len(wspecs) > 1:
            raise AkIllegalArgumentException(
                "all featureDefinitions in one op must share groupCols and "
                "the window spec (their outputs join on the same window "
                "keys); use one op per window/grouping")
        times_all = _epoch_seconds(t.col(time_col))
        frames = [self._one_def(t, times_all, d) for d in defs]
        out = frames[0]
        for f in frames[1:]:
            # same group/window spec -> identical key rows; append the
            # extra stat columns positionally
            extra = [c for c in f.names if c not in out.names]
            for c in extra:
                out = out.with_column(c, f.col(c), f.schema.type_of(c))
        return out

    def _one_def(self, t: MTable, times_all: np.ndarray, d: dict) -> MTable:
        wtype = d.get("windowType", "TUMBLE").upper()
        group_cols = list(d["groupCols"])
        gid, keys = _group_ids(t, group_cols)
        order = np.lexsort((times_all, gid))
        ts = times_all[order]
        bounds = _group_slices(gid[order], len(keys))
        targets = {c: np.asarray(t.col(c), np.float64)[order]
                   for c in d["targetCols"]}

        key_rows, ws_parts, we_parts = [], [], []
        stat_parts: List[List[np.ndarray]] = []
        for g in range(len(keys)):
            lo, hi = bounds[g], bounds[g + 1]
            if hi == lo:
                continue
            ws, we, si, ei = _window_bounds(ts[lo:hi], d, wtype)
            stat_parts.append([
                _window_stat(targets[target][lo:hi], si, ei, stat)
                for target in d["targetCols"] for stat in d["statTypes"]])
            ws_parts.append(np.asarray(ws, np.float64))
            we_parts.append(np.asarray(we, np.float64))
            key_rows.append((keys[g], len(si)))

        names = group_cols + ["window_start", "window_end"] + [
            _feature_col_name(target, stat, f"w{d.get('windowTime', 's')}")
            for target in d["targetCols"] for stat in d["statTypes"]]
        types = ([t.schema.type_of(c) for c in group_cols]
                 + [AlinkTypes.DOUBLE] * (2 + len(d["targetCols"])
                                          * len(d["statTypes"])))
        cat = lambda parts: (np.concatenate(parts) if parts  # noqa: E731
                             else np.zeros(0, np.float64))
        cols = {}
        for j, c in enumerate(group_cols):
            rows = [k[j] for k, cnt in key_rows for _ in range(cnt)]
            cols[c] = MTable.from_rows(
                [(v,) for v in rows],
                TableSchema([c], [types[j]])).col(c)
        cols["window_start"] = cat(ws_parts)
        cols["window_end"] = cat(we_parts)
        for j, name in enumerate(names[len(group_cols) + 2:]):
            cols[name] = cat([p[j] for p in stat_parts])
        return MTable(cols, TableSchema(names, types))

    def _out_schema(self, in_schema: TableSchema) -> TableSchema:
        d = _parse_defs(self.get(self.FEATURE_DEFINITIONS))[0]
        group_cols = list(d["groupCols"])
        names = group_cols + ["window_start", "window_end"] + [
            _feature_col_name(tg, st, f"w{d.get('windowTime', 's')}")
            for tg in d["targetCols"] for st in d["statTypes"]]
        types = ([in_schema.type_of(c) for c in group_cols]
                 + [AlinkTypes.DOUBLE] * (2 + len(d["targetCols"])
                                          * len(d["statTypes"])))
        return TableSchema(names, types)


def _trailing_extreme(vals: np.ndarray, starts: np.ndarray,
                      stat: str) -> np.ndarray:
    """pandas' rolling max/min over ``vals[starts[i] : i + 1]`` with
    ``min_periods=1``: NaN values are skipped; a window of NaN only is
    NaN."""
    n = len(vals)
    if n == 0:
        return np.zeros(0, np.float64)
    fill = -np.inf if stat == "MAX" else np.inf
    red = np.maximum if stat == "MAX" else np.minimum
    nan = np.isnan(vals)
    ends = np.arange(1, n + 1)
    out = _range_extreme(np.where(nan, fill, vals), starts, ends, red)
    seen = np.concatenate([[0], np.cumsum(~nan)])
    return np.where(seen[ends] - seen[starts] > 0, out, np.nan)


class _BaseTrailingFeatureOp(BatchOperator):
    """Shared per-row trailing-window engine: every row gets stats over the
    preceding window (inclusive of the row), per group."""

    TIME_COL = ParamInfo("timeCol", str, optional=False)
    GROUP_COLS = ParamInfo("groupCols", list, default=None)
    TARGET_COLS = ParamInfo("targetCols", list, optional=False)
    STAT_TYPES = ParamInfo("statTypes", list, default=["SUM"])

    _min_inputs = 1
    _max_inputs = 1

    def _suffix(self) -> str:
        raise NotImplementedError

    def _start_indices(self, tg: np.ndarray) -> np.ndarray:
        """Per-row window start index within the sorted group."""
        raise NotImplementedError

    def _rolling_spec(self):
        """("rows", N) or ("time", span_seconds) — the DECLARED window, so
        extremes agree with every other stat about the same window."""
        raise NotImplementedError

    def _rolling_extreme(self, vals: np.ndarray, tg: np.ndarray,
                         stat: str) -> np.ndarray:
        kind, size = self._rolling_spec()
        if kind == "rows":
            starts = np.maximum(np.arange(len(vals)) - int(size) + 1, 0)
        else:
            # a trailing time span closed on both ends, in integer
            # nanoseconds as pandas bounds it (the left edge is the same
            # contract as _start_indices' side="left" searchsorted)
            ns = (tg * 1e9).astype("int64")
            span = int(round(float(size) * 1e9))
            starts = np.searchsorted(ns, ns - span, side="left")
        return _trailing_extreme(vals, starts, stat)

    def _execute_impl(self, t: MTable) -> MTable:
        time_col = self.get(self.TIME_COL)
        group_cols = list(self.get(self.GROUP_COLS) or [])
        targets = list(self.get(self.TARGET_COLS))
        stats = [s.upper() for s in self.get(self.STAT_TYPES)]
        for s in stats:
            if s not in STAT_TYPES:
                raise AkIllegalArgumentException(f"unknown statType '{s}'")
        times_all = _epoch_seconds(t.col(time_col))
        gid, keys = _group_ids(t, group_cols)
        order = np.lexsort((times_all, gid))
        inv = np.empty_like(order)
        inv[order] = np.arange(len(order))
        ts = times_all[order]
        bounds = _group_slices(gid[order], len(keys))
        spans = [(bounds[g], bounds[g + 1]) for g in range(len(keys))
                 if bounds[g + 1] > bounds[g]]
        starts = {lo: self._start_indices(ts[lo:hi]) for lo, hi in spans}

        n = t.num_rows
        out_cols: Dict[str, np.ndarray] = {}
        for target in targets:
            vals = np.asarray(t.col(target), np.float64)[order]
            for stat in stats:
                res_sorted = np.empty(n, np.float64)
                for lo, hi in spans:
                    if stat in ("MAX", "MIN"):
                        res_sorted[lo:hi] = self._rolling_extreme(
                            vals[lo:hi], ts[lo:hi], stat)
                    else:
                        res_sorted[lo:hi] = _window_stat(
                            vals[lo:hi], starts[lo],
                            np.arange(1, hi - lo + 1), stat)
                name = _feature_col_name(target, stat, self._suffix())
                out_cols[name] = res_sorted[inv]

        cols = {nm: t.col(nm) for nm in t.names}
        cols.update(out_cols)
        names = list(t.names) + list(out_cols)
        types = list(t.schema.types) + [AlinkTypes.DOUBLE] * len(out_cols)
        return MTable(cols, TableSchema(names, types))

    def _out_schema(self, in_schema: TableSchema) -> TableSchema:
        stats = [s.upper() for s in self.get(self.STAT_TYPES)]
        extra = [_feature_col_name(tg, st, self._suffix())
                 for tg in self.get(self.TARGET_COLS) for st in stats]
        return TableSchema(list(in_schema.names) + extra,
                           list(in_schema.types)
                           + [AlinkTypes.DOUBLE] * len(extra))


class GenerateFeatureOfLatestBatchOp(_BaseTrailingFeatureOp):
    """Stats over the latest N rows (per group, up to and including each
    row). (reference: GenerateFeatureOfLatestBatchOp.java)"""

    NUMBER = ParamInfo("number", int, default=5)

    def _suffix(self) -> str:
        return f"n{self.get(self.NUMBER)}"

    def _rolling_spec(self):
        return ("rows", int(self.get(self.NUMBER)))

    def _start_indices(self, tg: np.ndarray) -> np.ndarray:
        ends = np.arange(1, len(tg) + 1)
        return np.maximum(ends - int(self.get(self.NUMBER)), 0)


class GenerateFeatureOfLatestNDaysBatchOp(_BaseTrailingFeatureOp):
    """Stats over the trailing N days (time units when the time column is
    numeric-seconds). (reference: GenerateFeatureOfLatestNDaysBatchOp.java)"""

    N_DAYS = ParamInfo("nDays", float, default=7.0)

    def _suffix(self) -> str:
        nd = self.get(self.N_DAYS)
        return f"d{int(nd) if float(nd).is_integer() else nd}"

    def _rolling_spec(self):
        return ("time", float(self.get(self.N_DAYS)) * 86400.0)

    def _start_indices(self, tg: np.ndarray) -> np.ndarray:
        span = float(self.get(self.N_DAYS)) * 86400.0
        return np.searchsorted(tg, tg - span, side="left")
