"""Relational / SQL-ish operators over MTable (port of
``alink_tpu.operator.sql``).

Capability parity with the reference's SQL layer (reference:
core/src/main/java/com/alibaba/alink/operator/common/sql/ — Calcite's
CalciteSelectMapper.java; the select/where/groupby/join/union/intersect/
minus ops under operator/batch/sql/).

The reference evaluates expressions through pandas (``DataFrame.eval`` /
``query`` / ``merge`` / ``groupby``). pandas is not among the port's
dependencies, so the port evaluates the same expression language over numpy
columns: the expression is parsed with the standard library's ``ast`` (no
``eval`` of the raw string) and each node maps to the numpy operation pandas
performs — ``and``/``or``/``not`` and ``&``/``|`` at boolean precedence,
chained comparisons, ``in``/``==`` against a list as membership, true
division, integer floor division and modulo by zero as pandas gives them
(float, ``inf``/``nan``), missing strings comparing false, and pandas'
math functions. Joins, intersections and differences follow ``merge``'s row
order and column naming; group-bys follow ``groupby(sort=True,
dropna=False)``. Output types follow the reference's ``_from_pandas`` rule
(a column that survives keeps its source schema's type). Object columns
(vectors) pass through untouched.
"""

from __future__ import annotations

import ast
import io
import operator
import re
import tokenize
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..common.exceptions import AkIllegalArgumentException, AkParseErrorException
from ..common.mtable import _NP_OF_TYPE, MTable, TableSchema, _infer_type
from .base import AlgoOperator

# ---------------------------------------------------------------------------
# Expression evaluation (the reference's DataFrame.eval)
# ---------------------------------------------------------------------------

_FUNCS = {name: getattr(np, name) for name in (
    "sin", "cos", "tan", "exp", "log", "log10", "log1p", "expm1", "sqrt",
    "sinh", "cosh", "tanh", "arcsin", "arccos", "arctan", "arccosh",
    "arcsinh", "arctanh", "arctan2", "abs")}

_BACKTICK_RE = re.compile(r"`([^`]*)`")


def _prepare(expr: str) -> Tuple[str, Dict[str, str]]:
    """Backtick-quoted names become placeholders, and ``&``/``|`` become
    ``and``/``or`` (pandas' parser gives them boolean precedence)."""
    quoted: Dict[str, str] = {}

    def sub(m):
        key = f"__bq{len(quoted)}__"
        quoted[key] = m.group(1)
        return key

    expr = _BACKTICK_RE.sub(sub, expr)
    out = []
    for tok in tokenize.generate_tokens(io.StringIO(expr).readline):
        if tok.type == tokenize.OP and tok.string in ("&", "|"):
            tok = tok._replace(string=" and " if tok.string == "&" else " or ")
        out.append((tok.type, tok.string))
    return tokenize.untokenize(out), quoted


def _is_str_array(v) -> bool:
    return isinstance(v, np.ndarray) and v.dtype == object


def _is_missing(v) -> bool:
    return v is None or (isinstance(v, float) and v != v)


def _order_compare(op, a, b):
    """``<``/``<=``/``>``/``>=`` with string operands: element-wise, and a
    missing value compares false (pandas' string columns)."""
    n = len(a) if isinstance(a, np.ndarray) else len(b)
    av = a if isinstance(a, np.ndarray) else [a] * n
    bv = b if isinstance(b, np.ndarray) else [b] * n
    return np.asarray([False if _is_missing(x) or _is_missing(y) else
                       bool(op(x, y)) for x, y in zip(av, bv)], dtype=bool)


def _isin(a, values) -> np.ndarray:
    vals = list(values)
    if _is_str_array(a):
        s = set(v for v in vals if not _is_missing(v))
        return np.asarray([(not _is_missing(x)) and x in s for x in a], bool)
    out = np.isin(a, [v for v in vals if not _is_missing(v)])
    if any(_is_missing(v) for v in vals) and np.asarray(a).dtype.kind == "f":
        out = out | np.isnan(a)
    return out


def _int_like(v) -> bool:
    dt = np.asarray(v).dtype
    return dt.kind in "iub"


def _floordiv_mod(fn, a, b):
    # pandas turns an integer floor division or modulo by zero into float
    # (x // 0 -> ±inf, 0 // 0 and x % 0 -> nan) where numpy gives 0
    if _int_like(a) and _int_like(b) and np.any(np.asarray(b) == 0):
        a = np.asarray(a, np.float64)
        b = np.asarray(b, np.float64)
    return fn(a, b)


# the array operators pandas' Series dispatch to (``x ** 2`` is numpy's
# squaring fast path, not ``np.power``)
_BINOPS = {ast.Add: operator.add, ast.Sub: operator.sub,
           ast.Mult: operator.mul, ast.Div: operator.truediv,
           ast.FloorDiv: operator.floordiv, ast.Mod: operator.mod,
           ast.Pow: operator.pow, ast.BitXor: operator.xor}


class _Evaluator:
    def __init__(self, t: MTable, quoted: Dict[str, str]):
        self.t, self.quoted = t, quoted

    def visit(self, node):
        fn = getattr(self, "v_" + type(node).__name__, None)
        if fn is None:
            raise AkParseErrorException(
                f"unsupported expression element {type(node).__name__}")
        return fn(node)

    def v_Expression(self, node):
        return self.visit(node.body)

    def v_Constant(self, node):
        return node.value

    def v_Name(self, node):
        name = self.quoted.get(node.id, node.id)
        if name in self.t.names:
            return np.asarray(self.t.col(name))
        raise AkParseErrorException(f"name {name!r} is not defined")

    def v_List(self, node):
        return [self.visit(e) for e in node.elts]

    v_Tuple = v_List

    def v_BoolOp(self, node):
        vals = [self.visit(v) for v in node.values]
        op = np.bitwise_and if isinstance(node.op, ast.And) else np.bitwise_or
        out = vals[0]
        for v in vals[1:]:
            out = op(out, v)
        return out

    def v_UnaryOp(self, node):
        v = self.visit(node.operand)
        if isinstance(node.op, (ast.Not, ast.Invert)):
            return np.invert(v) if isinstance(v, np.ndarray) else (not v)
        if isinstance(node.op, ast.USub):
            return -v
        if isinstance(node.op, ast.UAdd):
            return +v
        raise AkParseErrorException("unsupported unary operator")

    def v_BinOp(self, node):
        a, b = self.visit(node.left), self.visit(node.right)
        if any(_is_str_array(v) or isinstance(v, str) for v in (a, b)):
            # pandas' python engine refuses arithmetic on string columns
            raise TypeError(f"unsupported operand type(s) for "
                            f"{type(node.op).__name__}: string column")
        fn = _BINOPS.get(type(node.op))
        if fn is None:
            raise AkParseErrorException(
                f"unsupported operator {type(node.op).__name__}")
        with np.errstate(all="ignore"):
            if isinstance(node.op, (ast.FloorDiv, ast.Mod)):
                return _floordiv_mod(fn, a, b)
            return fn(a, b)

    def _compare(self, op, a, b):
        if isinstance(op, (ast.In, ast.NotIn)) or (
                isinstance(op, (ast.Eq, ast.NotEq)) and isinstance(b, list)):
            m = _isin(a, b if isinstance(b, list) else [b])
            return ~m if isinstance(op, (ast.NotIn, ast.NotEq)) else m
        fn = {ast.Eq: operator.eq, ast.NotEq: operator.ne,
              ast.Lt: operator.lt, ast.LtE: operator.le,
              ast.Gt: operator.gt, ast.GtE: operator.ge}.get(type(op))
        if fn is None:
            raise AkParseErrorException(
                f"unsupported comparison {type(op).__name__}")
        if fn not in (operator.eq, operator.ne) and (
                _is_str_array(a) or _is_str_array(b)):
            return _order_compare(fn, a, b)
        with np.errstate(invalid="ignore"):
            return np.asarray(fn(a, b))

    def v_Compare(self, node):
        left = self.visit(node.left)
        out = None
        for op, comp in zip(node.ops, node.comparators):
            right = self.visit(comp)
            r = self._compare(op, left, right)
            out = r if out is None else (out & r)
            left = right
        return out

    def v_Call(self, node):
        if not isinstance(node.func, ast.Name) or node.func.id not in _FUNCS \
                or node.keywords:
            raise AkParseErrorException("unsupported function call")
        args = [self.visit(a) for a in node.args]
        with np.errstate(all="ignore"):
            return _FUNCS[node.func.id](*args)


def _eval(t: MTable, expr: str):
    src, quoted = _prepare(expr)
    tree = ast.parse(src.strip(), mode="eval")
    return _Evaluator(t, quoted).visit(tree)


# ---------------------------------------------------------------------------
# Row keys (the reference's duplicated / merge matching: NaN equals NaN)
# ---------------------------------------------------------------------------

_NAN_KEY = ("__nan__",)


def _cell_key(v):
    if _is_missing(v):
        return _NAN_KEY
    if isinstance(v, np.generic):
        return v.item()
    return v


def _row_keys(t: MTable, names: Sequence[str]) -> List[tuple]:
    cols = [t.col(n) for n in names]
    return [tuple(_cell_key(c[i]) for c in cols) for i in range(t.num_rows)]


def _first_occurrence(keys: Sequence[tuple]) -> np.ndarray:
    seen: set = set()
    keep = np.zeros(len(keys), bool)
    for i, k in enumerate(keys):
        if k not in seen:
            seen.add(k)
            keep[i] = True
    return keep


def _distinct(t: MTable) -> MTable:
    return t.filter_mask(_first_occurrence(_row_keys(t, t.names)))


def _from_columns(cols: Dict[str, np.ndarray],
                  like: Sequence[MTable] = ()) -> MTable:
    """The reference's ``_from_pandas``: a column whose name is in a source
    table keeps that table's type (cast as numpy casts), others infer."""
    names, types, out = [], [], {}
    for name, arr in cols.items():
        arr = np.asarray(arr)
        t = None
        for src in like:
            if name in src.names:
                t = src.schema.type_of(name)
                np_t = _NP_OF_TYPE.get(t)
                if np_t is not None and arr.dtype != object \
                        and arr.dtype.kind != "O":
                    try:
                        with np.errstate(invalid="ignore"):
                            arr = arr.astype(np_t, copy=False)
                    except (TypeError, ValueError):
                        t = None
                break
        if t is None:
            t = _infer_type(arr)
        out[name] = arr
        names.append(name)
        types.append(t)
    return MTable(out, TableSchema(names, types))


def _take_fill(col: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """``col[idx]`` with -1 meaning a missing row (merge's fill): numeric
    columns go float64 with NaN, others object with NaN."""
    col = np.asarray(col)
    miss = idx < 0
    if not miss.any():
        return col[idx]
    safe = np.where(miss, 0, idx)
    if col.dtype.kind in "iufb":
        out = col[safe].astype(np.float64)
        out[miss] = np.nan
        return out
    out = col[safe].astype(object)
    out[miss] = np.nan
    return out


def _merge(a: MTable, b: MTable, left_on: List[str], right_on: List[str],
           how: str, suffixes=("", "_r")) -> Dict[str, np.ndarray]:
    """pandas ``merge`` on equal keys: inner and left keep the left rows'
    order, right the right rows', outer sorts the keys; each matched row
    pairs with its partners in their table's order."""
    lk, rk = _row_keys(a, left_on), _row_keys(b, right_on)
    r_by: Dict[tuple, List[int]] = {}
    for j, k in enumerate(rk):
        r_by.setdefault(k, []).append(j)
    l_by: Dict[tuple, List[int]] = {}
    for i, k in enumerate(lk):
        l_by.setdefault(k, []).append(i)
    li: List[int] = []
    ri: List[int] = []
    if how in ("inner", "left"):
        for i, k in enumerate(lk):
            js = r_by.get(k)
            if js:
                li += [i] * len(js)
                ri += js
            elif how == "left":
                li.append(i)
                ri.append(-1)
    elif how == "right":
        for j, k in enumerate(rk):
            is_ = l_by.get(k)
            if is_:
                li += is_
                ri += [j] * len(is_)
            else:
                li.append(-1)
                ri.append(j)
    else:  # outer: keys sorted
        keys = sorted(set(lk) | set(rk), key=lambda k: tuple(
            (1, 0) if x == _NAN_KEY else (0, x) for x in k))
        for k in keys:
            is_, js = l_by.get(k, [-1]), r_by.get(k, [-1])
            for i in is_:
                li += [i] * len(js)
                ri += js
    li_a, ri_a = np.asarray(li, np.intp), np.asarray(ri, np.intp)
    shared = [l for l, r in zip(left_on, right_on) if l == r]
    cols: Dict[str, np.ndarray] = {}
    for n in a.names:
        col = _take_fill(a.col(n), li_a)
        if n in shared and (ri_a >= 0).any() and (li_a < 0).any():
            # a collapsed key takes the right side's value where the left
            # row is missing
            other = _take_fill(b.col(n), ri_a)
            col = np.where(li_a < 0, other, col)
        name = n + suffixes[0] if n in b.names and n not in shared else n
        cols[name] = col
    for n in b.names:
        if n in shared:
            continue
        name = n + suffixes[1] if n in a.names else n
        cols[name] = _take_fill(b.col(n), ri_a)
    return cols


# ---------------------------------------------------------------------------
# Operators
# ---------------------------------------------------------------------------

_AGG_RE = re.compile(r"^\s*(\w+)\s*\(\s*(\*|[\w.]+)\s*\)\s*(?:as\s+(\w+))?\s*$", re.I)
_AS_RE = re.compile(r"^(.*?)\s+as\s+(\w+)\s*$", re.I)


def _split_top_level(s: str) -> List[str]:
    parts, depth, cur = [], 0, []
    for ch in s:
        if ch == "(":
            depth += 1
        elif ch == ")":
            depth -= 1
        if ch == "," and depth == 0:
            parts.append("".join(cur).strip())
            cur = []
        else:
            cur.append(ch)
    if cur:
        parts.append("".join(cur).strip())
    return [p for p in parts if p]


class SelectOp(AlgoOperator):
    """``select("a, b as c, a*2 as d, *")`` projection + expressions
    (reference: operator/batch/sql/SelectBatchOp.java + CalciteSelectMapper)."""

    _min_inputs = 1
    _max_inputs = 1

    def __init__(self, fields=None, clause=None, **kwargs):
        super().__init__(**kwargs)
        fields = fields if fields is not None else clause  # reference name
        if fields is None:
            raise AkIllegalArgumentException("select needs a clause")
        if isinstance(fields, str):
            self._clauses = _split_top_level(fields)
        else:
            self._clauses = list(fields)

    def _execute_impl(self, t: MTable) -> MTable:
        out_cols: Dict[str, np.ndarray] = {}
        out_names: List[str] = []
        out_types: List[str] = []
        for clause in self._clauses:
            clause = clause.strip()
            if clause == "*":
                for n in t.names:
                    out_cols[n] = t.col(n)
                    out_names.append(n)
                    out_types.append(t.schema.type_of(n))
                continue
            m = _AS_RE.match(clause)
            expr, alias = (m.group(1).strip(), m.group(2)) if m else (clause, None)
            if re.fullmatch(r"[\w.]+", expr) and expr in t.names:
                name = alias or expr
                out_cols[name] = t.col(expr)
                out_names.append(name)
                out_types.append(t.schema.type_of(expr))
            else:
                try:
                    arr = _eval(t, expr)
                except Exception as e:
                    raise AkParseErrorException(f"bad select expression {clause!r}: {e}")
                name = alias or expr
                arr = np.asarray(arr)
                if arr.ndim == 0:
                    # constant expression ('tag', 1+2): broadcast to n rows
                    val = arr.item()
                    arr = np.full(
                        t.num_rows, val,
                        dtype=object if isinstance(val, str) else None)
                out_cols[name] = arr
                out_names.append(name)
                out_types.append(_infer_type(arr))
        return MTable(out_cols, TableSchema(out_names, out_types))


class FilterOp(AlgoOperator):
    """``filter("a > 1 and category == 'x'")`` (reference: WhereBatchOp)."""

    _min_inputs = 1
    _max_inputs = 1

    def __init__(self, predicate: str = None, clause: str = None, **kwargs):
        super().__init__(**kwargs)
        predicate = predicate if predicate is not None else clause
        if predicate is None:
            raise AkIllegalArgumentException("filter needs a clause")
        self._predicate = predicate

    def _execute_impl(self, t: MTable) -> MTable:
        try:
            mask = _eval(t, self._predicate)
        except Exception as e:
            raise AkParseErrorException(f"bad filter predicate {self._predicate!r}: {e}")
        mask = np.asarray(mask, dtype=bool)
        if mask.ndim == 0:
            mask = np.full(t.num_rows, bool(mask))
        return t.filter_mask(mask)


class DistinctOp(AlgoOperator):
    _min_inputs = 1
    _max_inputs = 1

    def _execute_impl(self, t: MTable) -> MTable:
        return _distinct(t)


class OrderByOp(AlgoOperator):
    _min_inputs = 1
    _max_inputs = 1

    def __init__(self, field: str, limit: Optional[int] = None, ascending: bool = True, **kw):
        super().__init__(**kw)
        self._field, self._limit, self._ascending = field, limit, ascending

    def _execute_impl(self, t: MTable) -> MTable:
        out = t.sort_by(self._field, ascending=self._ascending)
        return out.head(self._limit) if self._limit is not None else out


class SampleOp(AlgoOperator):
    _min_inputs = 1
    _max_inputs = 1

    def __init__(self, ratio: float, seed: int = 0, **kw):
        super().__init__(**kw)
        self._ratio, self._seed = ratio, seed

    def _execute_impl(self, t: MTable) -> MTable:
        return t.sample(self._ratio, seed=self._seed)


class RenameOp(AlgoOperator):
    _min_inputs = 1
    _max_inputs = 1

    def __init__(self, mapping, **kw):
        super().__init__(**kw)
        if isinstance(mapping, str):
            # "a as x, b as y"
            m = {}
            for clause in _split_top_level(mapping):
                mm = _AS_RE.match(clause)
                if not mm:
                    raise AkIllegalArgumentException(f"bad rename clause {clause!r}")
                m[mm.group(1).strip()] = mm.group(2)
            mapping = m
        self._mapping = mapping

    def _execute_impl(self, t: MTable) -> MTable:
        return t.rename(self._mapping)


def _valid(v: np.ndarray) -> np.ndarray:
    if v.dtype.kind == "f":
        return v[~np.isnan(v)]
    if v.dtype == object:
        return v[[not _is_missing(x) for x in v]]
    return v


def _kahan_sum(v: np.ndarray):
    """pandas' group sum: compensated (Kahan) summation in the column's own
    float type, a non-finite value resetting the compensation."""
    s = c = v.dtype.type(0)
    for x in v:
        y = x - c
        t = s + y
        c = t - s - y
        if c != c:
            c = v.dtype.type(0)
        s = t
    return s


def _agg_sum(v):
    v = _valid(v)
    if v.dtype == object:
        return sum(v.tolist()) if len(v) else 0
    if v.dtype.kind == "f":
        return _kahan_sum(v)
    return v.sum() if len(v) else v.dtype.type(0)


def _agg_mean(v):
    v = _valid(v)
    if v.dtype.kind != "f":
        v = v.astype(np.float64)
    return _kahan_sum(v) / v.dtype.type(len(v)) if len(v) \
        else v.dtype.type(np.nan)


def _agg_minmax(fn):
    def agg(v):
        v = _valid(v)
        return fn(v) if len(v) else np.nan
    return agg


def _agg_std(v):
    """pandas' group variance: Welford's online update, ddof 1."""
    v = _valid(v).astype(np.float64)
    if len(v) < 2:
        return np.nan
    mean = m2 = np.float64(0)
    for n, x in enumerate(v, 1):
        old = mean
        mean = mean + (x - old) / np.float64(n)
        m2 = m2 + (x - mean) * (x - old)
    return np.sqrt(m2 / np.float64(len(v) - 1))


_AGGS = {
    "sum": _agg_sum,
    "avg": _agg_mean,
    "mean": _agg_mean,
    "min": _agg_minmax(np.min),
    "max": _agg_minmax(np.max),
    "count": lambda v: np.int64(len(_valid(v))),
    "std": _agg_std,
    "stddev": _agg_std,
    "first": lambda v: _valid(v)[0] if len(_valid(v)) else np.nan,
    "last": lambda v: _valid(v)[-1] if len(_valid(v)) else np.nan,
}


def _group_sort_key(k: tuple):
    # groupby(sort=True, dropna=False): keys ascending, missing keys last
    return tuple((1, 0) if x == _NAN_KEY else (0, x) for x in k)


class GroupByOp(AlgoOperator):
    """``group_by("category", "category, avg(f0) as m, count(*) as c")``
    (reference: GroupByBatchOp via Calcite)."""

    _min_inputs = 1
    _max_inputs = 1

    def __init__(self, group_cols: str, select_clause: str, **kw):
        super().__init__(**kw)
        self._group_cols = [c.strip() for c in group_cols.split(",") if c.strip()]
        self._select = _split_top_level(select_clause)

    def _execute_impl(self, t: MTable) -> MTable:
        keys = _row_keys(t, self._group_cols)
        groups: Dict[tuple, List[int]] = {}
        for i, k in enumerate(keys):
            groups.setdefault(k, []).append(i)
        order = sorted(groups, key=_group_sort_key)
        firsts = np.asarray([groups[k][0] for k in order], np.intp)
        out: Dict[str, np.ndarray] = {
            g: np.asarray(t.col(g))[firsts] for g in self._group_cols}
        for clause in self._select:
            if clause.strip() in self._group_cols:
                continue
            m = _AGG_RE.match(clause)
            if not m:
                raise AkParseErrorException(f"bad aggregate clause {clause!r}")
            fn, col, alias = m.group(1).lower(), m.group(2), m.group(3)
            if fn not in _AGGS:
                raise AkParseErrorException(f"unknown aggregate {fn!r}")
            name = alias or f"{fn}_{col}".replace("*", "all")
            if col == "*":
                vals = [np.int64(len(groups[k])) for k in order]
            else:
                c = np.asarray(t.col(col))
                vals = [_AGGS[fn](c[groups[k]]) for k in order]
            out[name] = _agg_column(vals)
        return _from_columns(out)


def _agg_column(vals: List[Any]) -> np.ndarray:
    """One aggregate's per-group values as a column: object where a group
    gave a string, else numpy's common type of the values."""
    if any(isinstance(v, str) for v in vals):
        return np.asarray(vals, dtype=object)
    return np.asarray(vals)


class UnionAllOp(AlgoOperator):
    """(reference: UnionAllBatchOp)"""

    _min_inputs = 1

    def _execute_impl(self, *tables: MTable) -> MTable:
        return MTable.concat(list(tables))


class UnionOp(AlgoOperator):
    _min_inputs = 1

    def _execute_impl(self, *tables: MTable) -> MTable:
        return _distinct(MTable.concat(list(tables)))


class IntersectOp(AlgoOperator):
    _min_inputs = 2
    _max_inputs = 2

    def _execute_impl(self, a: MTable, b: MTable) -> MTable:
        on = [n for n in a.names if n in b.names]
        cols = _merge(a, _distinct(b), on, on, "inner")
        out = _from_columns(cols, like=(a, b))
        return _distinct(out)


class MinusAllOp(AlgoOperator):
    """EXCEPT ALL semantics — left duplicates preserved (reference: MinusAllBatchOp)."""

    _min_inputs = 2
    _max_inputs = 2

    def _execute_impl(self, a: MTable, b: MTable) -> MTable:
        right = set(_row_keys(b, a.names))
        return a.filter_mask(np.asarray(
            [k not in right for k in _row_keys(a, a.names)], bool))


class MinusOp(MinusAllOp):
    """EXCEPT semantics — result is deduplicated (reference: MinusBatchOp)."""

    def _execute_impl(self, a: MTable, b: MTable) -> MTable:
        return _distinct(super()._execute_impl(a, b))


class JoinOp(AlgoOperator):
    """Equi-join (reference: JoinBatchOp / LeftOuterJoinBatchOp / ...)."""

    _min_inputs = 2
    _max_inputs = 2

    def __init__(self, join_predicate: str = None, select_clause: str = "*",
                 how: str = "inner", joinPredicate: str = None,
                 selectClause: str = None, **kw):
        super().__init__(**kw)
        join_predicate = join_predicate or joinPredicate  # reference names
        if selectClause is not None:
            select_clause = selectClause
        if join_predicate is None:
            raise AkIllegalArgumentException("join needs a joinPredicate")
        self._how = {"inner": "inner", "left": "left", "right": "right", "full": "outer"}[how]
        self._pairs = self._parse_predicate(join_predicate)
        self._select = select_clause

    @staticmethod
    def _parse_predicate(pred: str) -> List[Tuple[Optional[str], str,
                                                  Optional[str], str]]:
        """Parse "a.k = b.k" / "k = k" fragments keeping the side qualifier
        so swapped predicates ("b.k = a.v") join the right columns."""
        pairs = []
        for part in re.split(r"(?i)\s+and\s+", pred.strip()):
            m = re.fullmatch(
                r"\s*(?:([ab])\.)?(\w+)\s*=+\s*(?:([ab])\.)?(\w+)\s*", part)
            if not m:
                raise AkParseErrorException(f"bad join predicate fragment {part!r}")
            pairs.append((m.group(1), m.group(2), m.group(3), m.group(4)))
        return pairs

    def _execute_impl(self, a: MTable, b: MTable) -> MTable:
        left_keys, right_keys = [], []
        for q1, c1, q2, c2 in self._pairs:
            # orient each pair to (left-table col, right-table col)
            swap = (q1 == "b") or (q2 == "a") or (
                q1 is None and q2 is None and c1 not in a.names)
            if swap:
                c1, c2 = c2, c1
            left_keys.append(c1)
            right_keys.append(c2)
        out = _from_columns(
            _merge(a, b, left_keys, right_keys, self._how), like=(a, b))
        if self._select != "*":
            # reference clauses qualify columns a.<col>/b.<col>; resolve
            # b-side duplicates to the "_r" suffix the merge used
            # (equal-named key pairs collapse into one unsuffixed column)
            merged_keys = {l for l, r in zip(left_keys, right_keys) if l == r}

            def repl(m):
                side, col = m.group(1), m.group(2)
                if (side == "b" and col in a.names
                        and col not in merged_keys):
                    return f"{col}_r"
                return col

            # tokenize around quoted literals so 'b.x' inside a string is
            # never rewritten as a column qualifier
            parts = re.split(r"('(?:[^']|'')*')", self._select)
            sel = "".join(
                p if i % 2 else re.sub(r"\b([ab])\.(\w+)", repl, p)
                for i, p in enumerate(parts)
            )
            return SelectOp(sel)._execute_impl(out)
        return out
