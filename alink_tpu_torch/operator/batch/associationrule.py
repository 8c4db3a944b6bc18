"""Association rules: FpGrowth, Apriori, PrefixSpan (port of
``alink_tpu.operator.batch.associationrule``; host code, copied).

Capability parity with the reference associationrule package (reference:
core/src/main/java/com/alibaba/alink/operator/batch/associationrule/
FpGrowthBatchOp.java (+ common/associationrule/FpTree.java,
AssociationRule.java — rules as side output), AprioriBatchOp.java,
PrefixSpanBatchOp.java (common/associationrule/PrefixSpan.java)).

Host-side mining: frequent-pattern search is irreducibly dynamic (data-
dependent tree/projection shapes — SURVEY §7 hard-part #1), so these run on
the host exactly where the reference runs them on a single reduce node.
FpGrowth mines via recursive tid-set intersection (Eclat-style), which
produces the identical frequent-itemset lattice as the reference's FP-tree;
the op surface (params, outputs, rules side output) matches the reference.
"""

from __future__ import annotations

from itertools import combinations
from typing import Dict, FrozenSet, List, Optional, Tuple

import numpy as np

from ...common.mtable import AlinkTypes, MTable, TableSchema
from ...common.params import MinValidator, ParamInfo
from ...mapper import HasSelectedCol
from .base import BatchOperator

_ITEMSET_SCHEMA = TableSchema(
    ["itemset", "supportcount", "itemcount"],
    [AlinkTypes.STRING, AlinkTypes.LONG, AlinkTypes.LONG])

_RULE_SCHEMA = TableSchema(
    ["rule", "itemcount", "lift", "support_percent", "confidence_percent",
     "transaction_count"],
    [AlinkTypes.STRING, AlinkTypes.LONG, AlinkTypes.DOUBLE, AlinkTypes.DOUBLE,
     AlinkTypes.DOUBLE, AlinkTypes.LONG])


def _mine_frequent(transactions: List[FrozenSet[str]], min_count: int,
                   max_len: int) -> Dict[FrozenSet[str], int]:
    """Frequent itemsets by recursive tid-set intersection."""
    tidsets: Dict[str, set] = {}
    for tid, tx in enumerate(transactions):
        for item in tx:
            tidsets.setdefault(item, set()).add(tid)
    items = sorted([i for i, t in tidsets.items() if len(t) >= min_count])
    result: Dict[FrozenSet[str], int] = {}

    def recurse(prefix: Tuple[str, ...], prefix_tids: Optional[set],
                candidates: List[str]):
        for idx, item in enumerate(candidates):
            tids = (tidsets[item] if prefix_tids is None
                    else prefix_tids & tidsets[item])
            if len(tids) < min_count:
                continue
            itemset = frozenset(prefix + (item,))
            result[itemset] = len(tids)
            if len(itemset) < max_len:
                recurse(prefix + (item,), tids, candidates[idx + 1:])

    recurse((), None, items)
    return result


def _rules_from_itemsets(freq: Dict[FrozenSet[str], int], n_tx: int,
                         min_conf: float, max_consequent: int = 1):
    rows = []
    for itemset, count in freq.items():
        if len(itemset) < 2:
            continue
        for r in range(1, min(max_consequent, len(itemset) - 1) + 1):
            for consequent in combinations(sorted(itemset), r):
                antecedent = itemset - frozenset(consequent)
                ante_count = freq.get(antecedent)
                cons_count = freq.get(frozenset(consequent))
                if not ante_count or not cons_count:
                    continue
                conf = count / ante_count
                if conf < min_conf:
                    continue
                lift = conf / (cons_count / n_tx)
                rule = ",".join(sorted(antecedent)) + "=>" + ",".join(consequent)
                rows.append((rule, len(itemset), float(lift),
                             count / n_tx, conf, count))
    rows.sort(key=lambda r: (-r[5], r[0]))
    return rows


class _BaseFrequentItemsOp(BatchOperator, HasSelectedCol):
    """Shared frame for FpGrowth/Apriori: itemsets main output, rules side
    output 0."""

    ITEM_DELIMITER = ParamInfo("itemDelimiter", str, default=",")
    MIN_SUPPORT_COUNT = ParamInfo("minSupportCount", int, default=-1)
    MIN_SUPPORT_PERCENT = ParamInfo("minSupportPercent", float, default=0.02)
    MIN_CONFIDENCE = ParamInfo("minConfidence", float, default=0.05)
    MAX_PATTERN_LENGTH = ParamInfo("maxPatternLength", int, default=10,
                                   validator=MinValidator(1))
    MAX_CONSEQUENT_LENGTH = ParamInfo("maxConsequentLength", int, default=1,
                                      validator=MinValidator(1))

    _min_inputs = 1
    _max_inputs = 1

    def _mine(self, transactions: List[FrozenSet[str]], min_count: int,
              max_len: int) -> Dict[FrozenSet[str], int]:
        raise NotImplementedError

    def _execute_impl(self, t: MTable):
        delim = self.get(self.ITEM_DELIMITER)
        col = self.get(HasSelectedCol.SELECTED_COL)
        transactions = [
            frozenset(x for x in str(v).split(delim) if x)
            for v in t.col(col) if v is not None
        ]
        n_tx = max(len(transactions), 1)
        min_count = self.get(self.MIN_SUPPORT_COUNT)
        if min_count <= 0:
            min_count = max(1, int(np.ceil(
                self.get(self.MIN_SUPPORT_PERCENT) * n_tx)))
        freq = self._mine(transactions, min_count,
                          self.get(self.MAX_PATTERN_LENGTH))
        itemset_rows = sorted(
            ((",".join(sorted(s)), c, len(s)) for s, c in freq.items()),
            key=lambda r: (-r[1], r[2], r[0]))
        rules = _rules_from_itemsets(
            freq, n_tx, self.get(self.MIN_CONFIDENCE),
            self.get(self.MAX_CONSEQUENT_LENGTH))
        main = (MTable.from_rows(itemset_rows, _ITEMSET_SCHEMA)
                if itemset_rows else _empty(_ITEMSET_SCHEMA))
        side = (MTable.from_rows(rules, _RULE_SCHEMA)
                if rules else _empty(_RULE_SCHEMA))
        return main, [side]

    def _out_schema(self, in_schema):
        return _ITEMSET_SCHEMA

    def _side_schemas(self, in_schema):
        return [_RULE_SCHEMA]


def _empty(schema: TableSchema) -> MTable:
    return MTable({n: np.asarray([], object) for n in schema.names}, schema)


class FpGrowthBatchOp(_BaseFrequentItemsOp):
    """(reference: FpGrowthBatchOp.java)"""

    def _mine(self, transactions, min_count, max_len):
        return _mine_frequent(transactions, min_count, max_len)


class AprioriBatchOp(_BaseFrequentItemsOp):
    """Level-wise candidate generation (reference: AprioriBatchOp.java)."""

    def _mine(self, transactions, min_count, max_len):
        from collections import Counter

        counts = Counter()
        for tx in transactions:
            counts.update(tx)
        freq: Dict[FrozenSet[str], int] = {
            frozenset([i]): c for i, c in counts.items() if c >= min_count}
        current = sorted(freq.keys(), key=lambda s: sorted(s))
        k = 1
        while current and k < max_len:
            k += 1
            # join step: merge sets differing by one item
            candidates = set()
            for i in range(len(current)):
                for j in range(i + 1, len(current)):
                    u = current[i] | current[j]
                    if len(u) == k and all(
                            frozenset(sub) in freq
                            for sub in combinations(u, k - 1)):
                        candidates.add(u)
            next_level = []
            for cand in candidates:
                c = sum(1 for tx in transactions if cand <= tx)
                if c >= min_count:
                    freq[cand] = c
                    next_level.append(cand)
            current = next_level
        return freq


_SEQ_SCHEMA = TableSchema(
    ["itemset", "supportcount", "itemcount"],
    [AlinkTypes.STRING, AlinkTypes.LONG, AlinkTypes.LONG])


class PrefixSpanBatchOp(BatchOperator, HasSelectedCol):
    """Sequential pattern mining (reference: PrefixSpanBatchOp.java;
    sequence format "a,b;c;d" — ';' separates ordered itemsets, ',' items
    within one). Recursive projected-database growth."""

    MIN_SUPPORT_COUNT = ParamInfo("minSupportCount", int, default=-1)
    MIN_SUPPORT_PERCENT = ParamInfo("minSupportPercent", float, default=0.1)
    MAX_PATTERN_LENGTH = ParamInfo("maxPatternLength", int, default=10,
                                   validator=MinValidator(1))

    _min_inputs = 1
    _max_inputs = 1

    def _execute_impl(self, t: MTable) -> MTable:
        col = self.get(HasSelectedCol.SELECTED_COL)
        sequences = []
        for v in t.col(col):
            if v is None:
                continue
            seq = [tuple(x for x in part.split(",") if x)
                   for part in str(v).split(";") if part]
            sequences.append(seq)
        n_seq = max(len(sequences), 1)
        min_count = self.get(self.MIN_SUPPORT_COUNT)
        if min_count <= 0:
            min_count = max(1, int(np.ceil(
                self.get(self.MIN_SUPPORT_PERCENT) * n_seq)))
        max_len = self.get(self.MAX_PATTERN_LENGTH)
        results: List[Tuple[str, int, int]] = []

        def project(db, prefix_str, prefix_items):
            # db: list of (seq_index, itemset_pos, item_pos) suffix pointers
            # count support of each next single item (element-appended only —
            # the common simplified PrefixSpan over single-item elements)
            support: Dict[str, set] = {}
            for si, start in db:
                seq = sequences[si]
                seen = set()
                for pos in range(start, len(seq)):
                    for item in seq[pos]:
                        if item not in seen:
                            seen.add(item)
                            support.setdefault(item, set()).add(si)
            for item in sorted(support):
                sids = support[item]
                if len(sids) < min_count:
                    continue
                new_prefix = (prefix_str + ";" if prefix_str else "") + item
                results.append((new_prefix, len(sids), prefix_items + 1))
                if prefix_items + 1 >= max_len:
                    continue
                # project: first occurrence of item after start per sequence
                new_db = []
                for si, start in db:
                    if si not in sids:
                        continue
                    seq = sequences[si]
                    for pos in range(start, len(seq)):
                        if item in seq[pos]:
                            new_db.append((si, pos + 1))
                            break
                project(new_db, new_prefix, prefix_items + 1)

        project([(i, 0) for i in range(len(sequences))], "", 0)
        results.sort(key=lambda r: (-r[1], r[2], r[0]))
        return (MTable.from_rows(results, _SEQ_SCHEMA)
                if results else _empty(_SEQ_SCHEMA))

    def _out_schema(self, in_schema):
        return _SEQ_SCHEMA
