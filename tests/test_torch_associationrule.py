"""Parity of the port's association-rule ops (FpGrowth, Apriori,
PrefixSpan; host code copied) with ``alink_tpu`` on the CPU: the cases of
``tests/test_associationrule.py``, a seeded basket table and the empty
transaction set, through both packages. Itemsets, rules and sequences are
counts and ratios of counts: the tables are equal."""

import numpy as np
import pytest

from torch_table_parity import both, reference_session, remove_session, \
    same_table

BASKETS = ["milk,bread", "milk,bread,butter", "bread,butter",
           "milk,bread,butter", "beer,bread"]


@pytest.fixture(scope="module")
def sid():
    s = reference_session()
    yield s
    remove_session(s)


def _seeded_baskets(n=300, seed=0):
    rng = np.random.default_rng(seed)
    items = [f"i{j}" for j in range(12)]
    p = np.linspace(2.0, 0.2, 12)
    p /= p.sum()
    return [",".join(sorted(set(rng.choice(items, int(rng.integers(1, 6)),
                                           p=p)))) for _ in range(n)]


def _mine(sid, baskets, op, **params):
    cols = {"items": np.asarray(baskets, object)}

    def build(ops, extra, src):
        return getattr(ops, op)(selectedCol="items", **params,
                                **extra).link_from(src)

    out = []
    for side in (False, True):
        got = both(sid, cols, lambda ops, extra, src: (
            build(ops, extra, src).get_side_output(0) if side
            else build(ops, extra, src)))
        out.append(got)
    return out


@pytest.mark.parametrize("op", ["FpGrowthBatchOp", "AprioriBatchOp"])
@pytest.mark.parametrize("baskets, params", [
    (BASKETS, {"minSupportCount": 2}),
    (_seeded_baskets(), {"minSupportPercent": 0.05, "minConfidence": 0.3,
                         "maxConsequentLength": 2}),
    ([None, "", ","], {"minSupportCount": 1}),
])
def test_frequent_itemsets_and_rules(sid, op, baskets, params):
    (ref, port), (ref_rules, port_rules) = _mine(sid, baskets, op, **params)
    same_table(port, ref)
    same_table(port_rules, ref_rules)
    if baskets is BASKETS:
        freq = {r[0]: r[1] for r in port.rows()}
        assert freq["bread"] == 5 and freq["bread,butter,milk"] == 2
        rules = {r[0]: r for r in port_rules.rows()}
        assert rules["butter,milk=>bread"][4] == pytest.approx(1.0)
    if not any(baskets[:2]):
        assert port.num_rows == 0 and port_rules.num_rows == 0


def test_apriori_matches_fpgrowth():
    import alink_tpu_torch.operator.batch as P
    from alink_tpu_torch.common.mtable import MTable

    src = P.TableSourceBatchOp(MTable(
        {"items": np.asarray(_seeded_baskets(seed=1), object)}))
    f1, f2 = (sorted(op(selectedCol="items", minSupportCount=10)
                     .link_from(src).collect().rows())
              for op in (P.FpGrowthBatchOp, P.AprioriBatchOp))
    assert f1 == f2


@pytest.mark.parametrize("seqs", [
    ["a;b;c", "a;c", "a;b", "b;c"],
    ["a,b;c;d", "a;c,d;b", None, "b;a;c", "c;c;a,b"],
    [None, ""],
])
def test_prefixspan(sid, seqs):
    ref, port = both(sid, {"seq": np.asarray(seqs, object)},
                     lambda ops, extra, src: ops.PrefixSpanBatchOp(
                         selectedCol="seq", minSupportCount=2,
                         **extra).link_from(src))
    same_table(port, ref)
    if seqs[0] == "a;b;c":
        freq = {r[0]: r[1] for r in port.rows()}
        assert freq["a"] == 3 and freq["a;b"] == 2 and "c;a" not in freq
