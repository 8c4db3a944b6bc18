"""The port's SQL layer (``alink_tpu_torch.operator.sql`` and
``operator.sqlengine``), held against ``alink_tpu``'s on the CPU.

The reference evaluates expressions, joins and group-bys through pandas; the
port over numpy with the standard library's ``ast``. Every op runs on the
same seeded tables — numbers, strings, NaN, missing strings and a vector
column — in both packages, and the outputs must be equal: the same column
names, the same schema types, and the same values (NaN equal to NaN,
vectors by their string form). ``sqlengine`` runs the reference's
``tests/test_sqlengine.py`` queries, its window function included, in
both packages. The SQL sugar on ``AlgoOperator`` (``select``, ``filter``/
``where``, ``distinct``, ``order_by``, ``group_by``, ``sample``,
``rename``) links the same ops.
"""

import importlib
import math

import numpy as np
import pytest

PKGS = ("alink_tpu", "alink_tpu_torch")


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("ALINK_TORCH_DEVICE", "cpu")


def _mods(pkg):
    return (importlib.import_module(f"{pkg}.common.mtable"),
            importlib.import_module(f"{pkg}.operator.sql"),
            importlib.import_module(f"{pkg}.operator.batch"))


def _tables(pkg, n=24, seed=0):
    """A seeded table with numbers (ints, floats with NaN, a float32), a
    string column with a missing value, a bool and a vector column, and a
    second table that shares keys with it."""
    mt, _, _ = _mods(pkg)
    linalg = importlib.import_module(f"{pkg}.common.linalg")
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(n).round(3)
    x[[2, 7]] = np.nan
    cat = np.asarray([["a", "b", "c"][i % 3] for i in range(n)], object)
    cat[5] = np.nan
    t = mt.MTable(
        {"id": np.arange(n, dtype=np.int64) % 9,
         "x": x,
         "f": rng.random(n).astype(np.float32),
         "cat": cat,
         "flag": rng.random(n) > 0.5,
         "vec": np.asarray([linalg.DenseVector(rng.random(2).round(2))
                            for _ in range(n)], object)},
        "id long, x double, f float, cat string, flag boolean, "
        "vec DENSE_VECTOR")
    u = mt.MTable(
        {"id": np.asarray([1, 2, 2, 4, 10, 0], np.int64),
         "w": np.asarray([0.5, 1.5, 2.5, np.nan, 9.0, 3.0]),
         "cat": np.asarray(["b", "a", "b", "c", "z", "a"], object)},
        "id long, w double, cat string")
    return t, u


def _canon(v):
    if v is None or (isinstance(v, float) and math.isnan(v)):
        return "<nan>"
    if isinstance(v, (np.floating, float)):
        return float(v)
    if isinstance(v, np.generic):
        return v.item()
    if isinstance(v, (str, int, bool)):
        return v
    return str(v)


def _dump(t):
    return (list(t.names), list(t.schema.types),
            {n: [_canon(v) for v in np.asarray(t.col(n), object)]
             for n in t.names})


def _run(fn):
    out = {}
    for pkg in PKGS:
        try:
            out[pkg] = ("ok", _dump(fn(pkg, *_mods(pkg))))
        except Exception as e:  # both packages must refuse alike
            out[pkg] = ("error", type(e).__name__)
    return out


def _same(fn):
    out = _run(fn)
    assert out["alink_tpu_torch"] == out["alink_tpu"]
    return out["alink_tpu_torch"]


SELECTS = [
    "id, x * 2 as dbl", "*", "x + f as s, id // 2 as h, id % 4 as m",
    "id / 4 as q, -x as neg, x ** 2 as sq", "abs(x) as a, sqrt(f) as r",
    "cat, vec, 'tag' as t, 1 + 2 as three", "id // 0 as z, id % 0 as zm",
    "exp(f) as e, log1p(f) as l, arctan2(f, x) as t2", "cat + 'z' as bad",
    "x > 0 as pos, cat == 'a' as isa", "f + 1.5 as f2",
]


@pytest.mark.parametrize("clause", SELECTS)
def test_select_matches_reference(clause):
    _same(lambda pkg, mt, sql, b: sql.SelectOp(clause)._execute_impl(
        _tables(pkg)[0]))


FILTERS = [
    "x > 0", "x > 0 and cat == 'a'", "x > 0 & id < 5 | cat == 'c'",
    "not (x > 0)", "cat != 'a'", "cat > 'a'", "cat in ['a', 'c']",
    "id in [1, 2, 3]", "id not in [1, 2]", "0 < id < 5", "id == [0, 4]",
    "flag", "x != x", "`id` >= 3 and f < 0.5", "id / 3 > 1",
    "abs(x) < 0.5 or cat == 'b'",
]


@pytest.mark.parametrize("predicate", FILTERS)
def test_filter_matches_reference(predicate):
    _same(lambda pkg, mt, sql, b: sql.FilterOp(predicate)._execute_impl(
        _tables(pkg)[0]))


def test_bad_expressions_refuse_in_both():
    for clause in ("nope > 1", "id >"):
        got = _run(lambda pkg, mt, sql, b: sql.FilterOp(clause)._execute_impl(
            _tables(pkg)[0]))
        assert got["alink_tpu_torch"] == got["alink_tpu"] \
            == ("error", "AkParseErrorException")


GROUPS = [
    ("cat", "cat, avg(x) as m, count(*) as c, count(x) as cx"),
    ("cat", "cat, sum(x) as s, min(id) as lo, max(f) as hi, std(x) as sd"),
    ("id", "id, first(cat) as fc, last(x) as lx, sum(id) as si"),
    ("cat, flag", "cat, flag, mean(f) as mf, stddev(id) as sid"),
]


@pytest.mark.parametrize("cols,clause", GROUPS)
def test_group_by_matches_reference(cols, clause):
    _same(lambda pkg, mt, sql, b: sql.GroupByOp(cols, clause)._execute_impl(
        _tables(pkg)[0].drop(["vec"])))


@pytest.mark.parametrize("how", ["inner", "left", "right", "full"])
@pytest.mark.parametrize("pred,select", [
    ("id = id", "*"), ("a.id = b.id", "a.id, a.x, b.w, b.cat"),
    ("cat = cat", "*"), ("a.id = b.id and a.cat = b.cat", "*"),
    ("b.id = a.id", "a.id, b.w, 'b.tag' as tag"),
])
def test_join_matches_reference(how, pred, select):
    _same(lambda pkg, mt, sql, b: sql.JoinOp(pred, select, how=how)
          ._execute_impl(*(t.drop(["vec"]) if "vec" in t.names else t
                           for t in _tables(pkg))))


def test_join_on_differently_named_keys_matches_reference():
    def run(pkg, mt, sql, b):
        t, u = _tables(pkg)
        return sql.JoinOp("a.id = b.k", how="full")._execute_impl(
            t.drop(["vec"]), u.rename({"id": "k"}))

    _same(run)


def test_set_ops_match_reference():
    def pair(pkg):
        t, _ = _tables(pkg)
        t = t.drop(["vec"])
        return t, t.filter_mask(np.arange(t.num_rows) % 2 == 0)

    for op in ("UnionAllOp", "UnionOp", "IntersectOp", "MinusAllOp",
               "MinusOp"):
        _same(lambda pkg, mt, sql, b: getattr(sql, op)()._execute_impl(
            *pair(pkg)))
    _same(lambda pkg, mt, sql, b: sql.DistinctOp()._execute_impl(
        mt.MTable.concat([pair(pkg)[1], pair(pkg)[0]])))


def test_order_sample_rename_match_reference():
    _same(lambda pkg, mt, sql, b: sql.OrderByOp("x", limit=10,
                                               ascending=False)
          ._execute_impl(_tables(pkg)[0]))
    _same(lambda pkg, mt, sql, b: sql.SampleOp(0.5, seed=3)._execute_impl(
        _tables(pkg)[0]))
    _same(lambda pkg, mt, sql, b: sql.RenameOp("x as y, cat as c")
          ._execute_impl(_tables(pkg)[0]))


def test_operator_sugar_links_the_same_ops():
    def run(pkg, mt, sql, b):
        src = b.TableSourceBatchOp(_tables(pkg)[0].drop(["vec"]))
        return src.where("id > 1").select("id, x, cat, f * 2 as f2") \
            .distinct().order_by("id").group_by(
                "cat", "cat, avg(f2) as m, count(*) as c").collect()

    _same(run)
    ops = _same(lambda pkg, mt, sql, b: b.SelectBatchOp(clause="cat, x AS r")
                .link_from(b.TableSourceBatchOp(_tables(pkg)[0])).collect())
    assert ops[1][0] == ["cat", "r"]


def test_static_schema_of_sql_ops_matches_reference():
    def run(pkg, mt, sql, b):
        src = b.TableSourceBatchOp(_tables(pkg)[0].drop(["vec"]))
        op = src.select("id, x * 2 as d, cat").filter("d > 0")
        return mt.MTable.empty(op.schema)

    _same(run)


# -- sqlengine: the reference's tests/test_sqlengine.py in both packages ------


def test_sql_query_function():
    def run(pkg, mt, sql, b):
        t = mt.MTable({"a": np.asarray([1, 2, 3], np.int64),
                       "b": np.asarray(["x", "y", "x"], object)})
        return b.sql_query(
            "SELECT b, SUM(a) AS total FROM t GROUP BY b ORDER BY b",
            {"t": t})

    assert _same(run)[1][2] == {"b": ["x", "y"], "total": [4, 2]}


def test_sql_query_op_joins_two_inputs_and_window_function():
    def run(pkg, mt, sql, b):
        left = b.MemSourceBatchOp([(1, "ann"), (2, "bob")],
                                  "id bigint, name string")
        right = b.MemSourceBatchOp([(1, 95.5), (2, 88.0), (1, 70.0)],
                                   "id bigint, score double")
        return b.SqlQueryBatchOp(
            query="SELECT t0.name, AVG(t1.score) AS avg_score "
                  "FROM t0 JOIN t1 ON t0.id = t1.id "
                  "GROUP BY t0.name ORDER BY t0.name").link_from(
            left, right).collect()

    assert _same(run)[1][2]["avg_score"] == [82.75, 88.0]

    def window(pkg, mt, sql, b):
        src = b.MemSourceBatchOp([(1, 10.0), (1, 20.0), (2, 5.0)],
                                 "g bigint, v double")
        return b.SqlQueryBatchOp(
            query="SELECT g, v, RANK() OVER (PARTITION BY g ORDER BY v "
                  "DESC) r FROM t ORDER BY g, r").link_from(src).collect()

    assert _same(window)[1][2]["r"] == [1, 2, 1]


def test_jdbc_roundtrip_catalog_and_static_schema(tmp_path):
    def run(pkg, mt, sql, b):
        db = str(tmp_path / f"{pkg}.db")
        src = b.MemSourceBatchOp([(1, 2.5, "a"), (2, float("nan"), "b")],
                                 "id bigint, v double, s string")
        b.JdbcSinkBatchOp(dbPath=db, tableName="stuff").link_from(
            src).collect()
        cat = b.SqliteCatalog(db)
        assert cat.list_tables() == ["stuff"]
        schema = cat.get_table_schema("stuff")
        assert (schema.type_of("id"), schema.type_of("v")) == ("LONG",
                                                              "DOUBLE")
        out = b.JdbcSourceBatchOp(dbPath=db, tableName="stuff").collect()
        q = b.JdbcSourceBatchOp(
            dbPath=db, query="SELECT s FROM stuff WHERE id = 2").collect()
        assert list(q.col("s")) == ["b"]
        cat.drop_table("stuff")
        assert cat.list_tables() == []
        typed = b.SqlQueryBatchOp(
            query="SELECT a + 1 AS b, v * 2 AS w FROM t").link_from(
            b.MemSourceBatchOp([(1, 2.5)], "a bigint, v double"))
        assert list(typed.schema.types) == ["LONG", "DOUBLE"]
        return out

    got = _same(run)
    assert got[1][2]["v"] == [2.5, "<nan>"]
