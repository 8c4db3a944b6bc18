"""Finance: scorecard training/serving + population stability index (port
of ``alink_tpu.operator.batch.finance``).

Capability parity with the reference finance package (reference:
core/src/main/java/com/alibaba/alink/operator/batch/finance/
ScorecardTrainBatchOp.java (binning + WOE + (constrained) LR + PDO score
scaling; common/finance/ScorecardModelMapper.java),
operator/common/finance/stepwise + VizStatistics PSI utilities).

A scorecard composes pieces that already exist here: BinningTrainBatchOp's
WOE encoding, the shared LR trainer (``optim.optimize`` on the session's
device, in float64 where the reference runs float32: the WOE columns of
uninformative features leave the loss flat along them, and float32 L-BFGS
on the card and on the CPU stopped 1.1 points apart on 522,911 rows), and
points scaling
score = scaledValue + B·(−s − ln(odds)) with B = pdo/ln2, where s is the
model's log-odds of the positive (bad) label — every pdo points doubles the
good:bad odds.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np

from ...common.model import model_to_table, table_to_model
from ...common.mtable import AlinkTypes, MTable, TableSchema
from ...common.params import MinValidator, ParamInfo
from ...mapper import (
    HasPredictionCol,
    HasReservedCols,
    HasSelectedCols,
    RichModelMapper,
)
from .base import BatchOperator
from .feature2 import BinningTrainBatchOp
from .utils import ModelMapBatchOp, ModelTrainOpMixin


class ScorecardTrainBatchOp(ModelTrainOpMixin, BatchOperator, HasSelectedCols):
    """(reference: ScorecardTrainBatchOp.java)"""

    LABEL_COL = ParamInfo("labelCol", str, optional=False)
    POSITIVE_LABEL = ParamInfo("positiveLabelValueString", str,
                               aliases=("positiveValue",))
    NUM_BUCKETS = ParamInfo("numBuckets", int, default=10,
                            validator=MinValidator(2))
    SCALED_VALUE = ParamInfo("scaledValue", float, default=600.0)
    ODDS = ParamInfo("odds", float, default=20.0)
    PDO = ParamInfo("pdo", float, default=50.0)
    L_2 = ParamInfo("l2", float, default=1e-4)
    MAX_ITER = ParamInfo("maxIter", int, default=100)

    _min_inputs = 1
    _max_inputs = 1

    def _execute_impl(self, t: MTable) -> MTable:
        from ...mapper import default_feature_cols
        from ...optim import logistic_obj, optimize

        label_col = self.get(self.LABEL_COL)
        cols = list(self.get(HasSelectedCols.SELECTED_COLS) or
                    default_feature_cols(t, exclude=[label_col]))

        # 1) binning + WOE on the training data
        binner = BinningTrainBatchOp(
            selectedCols=cols, labelCol=label_col,
            numBuckets=self.get(self.NUM_BUCKETS),
            positiveLabelValueString=self.get(self.POSITIVE_LABEL))
        bin_model = binner._execute_impl(t)
        bin_meta, _ = table_to_model(bin_model)

        cuts = {c: np.asarray(v) for c, v in bin_meta["cutsMap"].items()}
        woe = {c: np.asarray(v) for c, v in bin_meta["woeMap"].items()}
        X = np.stack([
            woe[c][np.searchsorted(cuts[c],
                                   np.asarray(t.col(c), np.float64),
                                   side="right")]
            for c in cols], axis=1).astype(np.float32)

        pos_label = bin_meta["positiveLabel"]
        y_raw = np.asarray(t.col(label_col), object).astype(str)
        y = np.where(y_raw == pos_label, 1.0, -1.0).astype(np.float32)

        # 2) logistic regression on the WOE features (+ intercept)
        Xb = np.concatenate([X, np.ones((X.shape[0], 1), np.float32)], axis=1)
        res = optimize(logistic_obj(Xb.shape[1]), Xb, y,
                       device=self.env.device, method="lbfgs",
                       max_iter=self.get(self.MAX_ITER),
                       l2=self.get(self.L_2), float64=True)
        w = np.asarray(res.weights, np.float64)

        factor = self.get(self.PDO) / math.log(2.0)
        offset = self.get(self.SCALED_VALUE) + factor * math.log(
            self.get(self.ODDS))
        meta = dict(bin_meta)
        meta.update({
            "modelName": "ScorecardModel",
            "scaledValue": self.get(self.SCALED_VALUE),
            "odds": self.get(self.ODDS),
            "pdo": self.get(self.PDO),
            "factor": factor,
            "offset": offset,
        })
        return model_to_table(meta, {
            "weights": w[:-1], "intercept": np.asarray([w[-1]])})

    def _static_meta_keys(self, in_schema):
        return {"modelName": "ScorecardModel"}


class ScorecardModelMapper(RichModelMapper):
    """Total score + per-feature point contributions (reference:
    common/finance/ScorecardModelMapper.java — predictionScoreCol plus
    per-variable score detail)."""

    PREDICTION_SCORE_COL = ParamInfo("predictionScoreCol", str,
                                     default="score")
    PREDICTION_DETAIL_COL2 = ParamInfo("predictionDetailCol", str)

    def load_model(self, model: MTable):
        self.meta, arrays = table_to_model(model)
        self.weights = arrays["weights"]
        self.intercept = float(arrays["intercept"][0])
        self.cuts = {c: np.asarray(v)
                     for c, v in self.meta["cutsMap"].items()}
        self.woe = {c: np.asarray(v) for c, v in self.meta["woeMap"].items()}
        return self

    def output_schema(self, input_schema):
        score_col = self.get(self.PREDICTION_SCORE_COL)
        names = [score_col]
        types = [AlinkTypes.DOUBLE]
        if self.get(self.PREDICTION_DETAIL_COL2):
            names.append(self.get(self.PREDICTION_DETAIL_COL2))
            types.append(AlinkTypes.STRING)
        return self._append_result_schema(input_schema, names, types)

    def map_table(self, t: MTable) -> MTable:
        import json

        cols = self.meta["selectedCols"]
        factor = self.meta["factor"]
        offset = self.meta["offset"]
        n = t.num_rows
        # per-feature WOE value then linear score
        contribs = {}
        s = np.full(n, self.intercept, np.float64)
        k = len(cols)
        for i, c in enumerate(cols):
            wv = self.woe[c][np.searchsorted(
                self.cuts[c], np.asarray(t.col(c), np.float64), side="right")]
            raw = self.weights[i] * wv
            s += raw
            # distribute the intercept evenly across features (reference
            # scorecard convention for per-variable points)
            contribs[c] = -factor * (raw + self.intercept / k)
        score = offset - factor * s
        out_cols = {self.get(self.PREDICTION_SCORE_COL): score}
        out_types = {self.get(self.PREDICTION_SCORE_COL): AlinkTypes.DOUBLE}
        detail_col = self.get(self.PREDICTION_DETAIL_COL2)
        if detail_col:
            details = [
                json.dumps({c: float(contribs[c][i]) for c in cols})
                for i in range(n)]
            out_cols[detail_col] = np.asarray(details, object)
            out_types[detail_col] = AlinkTypes.STRING
        return self._append_result(t, out_cols, out_types)


class ScorecardPredictBatchOp(ModelMapBatchOp, HasReservedCols):
    mapper_cls = ScorecardModelMapper
    PREDICTION_SCORE_COL = ScorecardModelMapper.PREDICTION_SCORE_COL
    PREDICTION_DETAIL_COL = ScorecardModelMapper.PREDICTION_DETAIL_COL2


_PSI_SCHEMA = TableSchema(["colName", "psi"],
                          [AlinkTypes.STRING, AlinkTypes.DOUBLE])


class PsiBatchOp(BatchOperator, HasSelectedCols):
    """Population stability index between a base and a test population
    (reference: the PSI computation in common/finance/VizStatisticsUtils /
    group scorecard stability reports). ``link_from(base, test)``."""

    NUM_BUCKETS = ParamInfo("numBuckets", int, default=10,
                            validator=MinValidator(2))

    _min_inputs = 2
    _max_inputs = 2

    def _execute_impl(self, base: MTable, test: MTable) -> MTable:
        from ...mapper import default_feature_cols

        cols = list(self.get(HasSelectedCols.SELECTED_COLS) or
                    default_feature_cols(base))
        nb = self.get(self.NUM_BUCKETS)
        rows = []
        for c in cols:
            b = np.asarray(base.col(c), np.float64)
            tst = np.asarray(test.col(c), np.float64)
            qs = np.quantile(b[~np.isnan(b)], np.linspace(0, 1, nb + 1)[1:-1])
            cuts = np.unique(qs)
            bi = np.searchsorted(cuts, b, side="right")
            ti = np.searchsorted(cuts, tst, side="right")
            k = len(cuts) + 1
            pb = np.maximum(np.bincount(bi, minlength=k) / len(b), 1e-6)
            pt = np.maximum(np.bincount(ti, minlength=k) / len(tst), 1e-6)
            psi = float(((pt - pb) * np.log(pt / pb)).sum())
            rows.append((c, psi))
        return MTable.from_rows(rows, _PSI_SCHEMA)

    def _out_schema(self, *in_schemas):
        return _PSI_SCHEMA


class GroupScorecardTrainBatchOp(BatchOperator, HasSelectedCols):
    """One scorecard per group value, all stages in one model table keyed
    by the group column (reference: finance/GroupScorecardTrainBatchOp.java
    — per-group binning+WOE+scaled LR)."""

    GROUP_COL = ParamInfo("groupCol", str, optional=False,
                          aliases=("groupCols",))
    LABEL_COL = ScorecardTrainBatchOp.LABEL_COL
    POSITIVE_LABEL = ScorecardTrainBatchOp.POSITIVE_LABEL
    NUM_BUCKETS = ScorecardTrainBatchOp.NUM_BUCKETS
    SCALED_VALUE = ScorecardTrainBatchOp.SCALED_VALUE
    ODDS = ScorecardTrainBatchOp.ODDS
    PDO = ScorecardTrainBatchOp.PDO
    L_2 = ScorecardTrainBatchOp.L_2
    MAX_ITER = ScorecardTrainBatchOp.MAX_ITER

    _min_inputs = 1
    _max_inputs = 1

    def _execute_impl(self, t: MTable) -> MTable:
        group_col = self.get(self.GROUP_COL)
        groups = np.asarray(t.col(group_col), object).astype(str)
        sub_params = self.get_params().clone()

        def one(g):
            sub = t.filter_mask(groups == g).drop([group_col])
            inner = ScorecardTrainBatchOp(sub_params.clone())
            model = inner._execute_impl(sub)
            return model.with_column(
                "group_value", np.asarray([g] * model.num_rows, object),
                AlinkTypes.STRING)

        from ..local import parallel_apply

        # one scorecard fit per group on the session pool
        return MTable.concat(parallel_apply(one, list(np.unique(groups)),
                                            env=self.env))

    def _out_schema(self, in_schema):
        from ...common.model import MODEL_SCHEMA

        return TableSchema(list(MODEL_SCHEMA.names) + ["group_value"],
                           list(MODEL_SCHEMA.types) + [AlinkTypes.STRING])


class GroupScorecardPredictBatchOp(BatchOperator, HasReservedCols):
    """Serve the per-group scorecards: each row routes to its group's model
    (reference: GroupScorecardPredictBatchOp.java)."""

    GROUP_COL = ParamInfo("groupCol", str, optional=False)
    PREDICTION_COL = ParamInfo("predictionCol", str, default="score")

    _min_inputs = 2
    _max_inputs = 2

    def _execute_impl(self, model: MTable, t: MTable) -> MTable:
        group_col = self.get(self.GROUP_COL)
        pred_col = self.get(self.PREDICTION_COL)
        model_groups = np.asarray(model.col("group_value"), object)
        data_groups = np.asarray(t.col(group_col), object).astype(str)
        scores = np.full(t.num_rows, np.nan)
        for g in np.unique(data_groups):
            sub_model = model.filter_mask(
                model_groups.astype(str) == g).drop(["group_value"])
            if sub_model.num_rows == 0:
                continue  # unseen group -> NaN scores
            rows = data_groups == g
            sub = t.filter_mask(rows).drop([group_col])
            mapper = ScorecardModelMapper(
                sub_model.schema, sub.schema,
                self.get_params().clone()).load_model(sub_model)
            out = mapper.map_table(sub)
            score_col = mapper.get(ScorecardModelMapper.PREDICTION_SCORE_COL)
            scores[rows] = np.asarray(out.col(score_col), np.float64)
        return t.with_column(pred_col, scores, AlinkTypes.DOUBLE)

    def _out_schema(self, in_schema):
        return TableSchema(
            list(in_schema.names) + [self.get(self.PREDICTION_COL)],
            list(in_schema.types) + [AlinkTypes.DOUBLE])
