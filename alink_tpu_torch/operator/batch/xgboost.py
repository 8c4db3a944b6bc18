"""XGBoost bridge — plugin-gated, with a native-GBDT pointer (port of
``alink_tpu.operator.batch.xgboost``).

Capability parity with the reference's XGBoost plugin (reference:
plugins/xgboost-bridge/.../TrackerImpl.java:11-15 (Rabit rendezvous),
XGBoostImpl.java, core side operator/common/tree/BaseXGBoostTrainBatchOp.java
— loaded through the plugin classloader framework).

The xgboost python package plays the plugin role and is imported when an op
runs; when it is absent the op raises :class:`AkPluginNotExistException`
naming it, and points at the port's histogram GBDT (GbdtTrainBatchOp, whose
level histograms are the card's ``tree_histogram`` kernel), the first-class
boosted-tree path here. The bridge stays single-process by design, as the
reference's does; :class:`XGBoostTracker` exposes the TrackerImpl-analog
rendezvous over xgboost's own tracker for users who run multi-worker
xgboost themselves."""

from __future__ import annotations

import json
import tempfile
from typing import List, Optional

import numpy as np

from ...common.exceptions import (AkPluginNotExistException,
                                  AkUnsupportedOperationException)
from ...common.model import model_to_table, table_to_model
from ...common.mtable import AlinkTypes, MTable
from ...common.params import MinValidator, ParamInfo
from ...mapper import (
    HasFeatureCols,
    HasPredictionCol,
    HasPredictionDetailCol,
    HasReservedCols,
    HasVectorCol,
    RichModelMapper,
    detail_json,
    get_feature_block,
    merge_feature_params,
    np_labels,
    resolve_feature_cols,
)
from .base import BatchOperator
from .utils import ModelMapBatchOp, ModelTrainOpMixin

_GUIDANCE = (
    "the 'xgboost' package is not installed in this environment. Either "
    "install it (the plugin role of the reference's xgboost-bridge jar) or "
    "use the port's histogram GBDT: GbdtTrainBatchOp / GbdtRegTrainBatchOp."
)


def _require_xgboost():
    try:
        import xgboost  # noqa: F401

        return xgboost
    except ImportError as e:
        raise AkPluginNotExistException(
            f"XGBoost bridge unavailable: {_GUIDANCE}") from e


class XGBoostTracker:
    """Multi-worker xgboost rendezvous (reference:
    plugins/xgboost-bridge/.../TrackerImpl.java:11-15 — start a Rabit
    tracker, hand each worker its env, join).

    Wraps xgboost's own tracker (``xgboost.tracker.RabitTracker``) rather
    than reimplementing the ring: the tracker is pure CPU-side
    coordination, so the plugin's implementation is the correct one to
    reuse. Plugin-gated like the ops; ``tracker_factory`` injects a double
    for offline tests."""

    def __init__(self, num_workers: int, host: str = "127.0.0.1",
                 port: int = 0, tracker_factory=None):
        self.num_workers = int(num_workers)
        if tracker_factory is None:
            xgb = _require_xgboost()
            from xgboost.tracker import RabitTracker

            def tracker_factory(host_ip, n_workers, port):
                return RabitTracker(host_ip=host_ip, n_workers=n_workers,
                                    port=port)
        self._tracker = tracker_factory(host, self.num_workers, port)
        self._started = False

    def start(self) -> None:
        self._tracker.start()
        self._started = True

    def worker_args(self) -> dict:
        """The per-worker rendezvous env (dmlc tracker URI/port + world
        size) each worker passes to ``xgboost.collective.init`` —
        TrackerImpl.getWorkerEnvs analog."""
        if not self._started:
            raise AkUnsupportedOperationException(
                "tracker not started; call start() first")
        args = dict(self._tracker.worker_args())
        args.setdefault("dmlc_num_worker", self.num_workers)
        return args

    def wait_for(self, timeout: Optional[int] = None) -> None:
        self._tracker.wait_for(timeout) if timeout is not None \
            else self._tracker.wait_for()

    def stop(self) -> None:
        free = getattr(self._tracker, "free", None)
        if free:
            free()


class XGBoostTrainBatchOp(ModelTrainOpMixin, BatchOperator, HasVectorCol,
                          HasFeatureCols):
    """(reference: operator/batch/classification/XGBoostTrainBatchOp.java)"""

    LABEL_COL = ParamInfo("labelCol", str, optional=False)
    NUM_ROUND = ParamInfo("numRound", int, default=100,
                          validator=MinValidator(1))
    MAX_DEPTH = ParamInfo("maxDepth", int, default=6)
    ETA = ParamInfo("eta", float, default=0.3)
    OBJECTIVE = ParamInfo("objective", str, default="binary:logistic")

    _min_inputs = 1
    _max_inputs = 1

    def _static_meta_keys(self, in_schema):
        return {"modelName": "XGBoostModel",
                "labelType": in_schema.type_of(self.get(self.LABEL_COL))}

    def _execute_impl(self, t: MTable) -> MTable:
        xgb = _require_xgboost()
        label_col = self.get(self.LABEL_COL)
        feature_cols = resolve_feature_cols(t, self, exclude=[label_col])
        X = t.to_numeric_block(feature_cols, dtype=np.float32)
        y_raw = np.asarray(t.col(label_col))
        objective = self.get(self.OBJECTIVE)
        labels: Optional[List] = None
        if objective.startswith(("binary", "multi")):
            labels = sorted(set(y_raw.tolist()), key=str)
            lab_to_idx = {v: i for i, v in enumerate(labels)}
            y = np.asarray([lab_to_idx[v] for v in y_raw], np.float32)
        else:
            y = y_raw.astype(np.float32)
        dtrain = xgb.DMatrix(X, label=y)
        params = {"max_depth": self.get(self.MAX_DEPTH),
                  "eta": self.get(self.ETA), "objective": objective}
        if objective.startswith("multi"):
            params["num_class"] = len(labels)
        booster = xgb.train(params, dtrain,
                            num_boost_round=self.get(self.NUM_ROUND))
        raw = booster.save_raw(raw_format="json")
        meta = {
            "modelName": "XGBoostModel",
            "objective": objective,
            "featureCols": feature_cols,
            "labelCol": label_col,
            "labelType": t.schema.type_of(label_col),
            "labels": labels,
            "dim": int(X.shape[1]),
        }
        return model_to_table(
            meta, {"booster": np.frombuffer(bytes(raw), np.uint8)})


class XGBoostModelMapper(RichModelMapper):
    def load_model(self, model: MTable):
        xgb = _require_xgboost()
        self.meta, arrays = table_to_model(model)
        self.booster = xgb.Booster()
        self.booster.load_model(bytearray(arrays["booster"].tobytes()))
        return self

    def _pred_type(self):
        if self.meta["objective"].startswith(("binary", "multi")):
            return self.meta.get("labelType", AlinkTypes.STRING)
        return AlinkTypes.DOUBLE

    def predict_block(self, t: MTable):
        xgb = _require_xgboost()
        X = get_feature_block(
            t, merge_feature_params(self.get_params(), self.meta),
            vector_size=self.meta["dim"]).astype(np.float32)
        raw = self.booster.predict(xgb.DMatrix(X))
        objective = self.meta["objective"]
        if objective.startswith("binary"):
            probs = np.stack([1 - raw, raw], axis=1)
        elif objective.startswith("multi"):
            if raw.ndim == 2:       # multi:softprob
                probs = raw
            else:                   # multi:softmax emits class indices
                k = len(self.meta["labels"])
                probs = np.eye(k, dtype=np.float64)[raw.astype(np.int64)]
        else:
            return raw.astype(np.float64), AlinkTypes.DOUBLE, None
        labels = self.meta["labels"]
        label_type = self.meta.get("labelType", AlinkTypes.STRING)
        pred = np_labels(labels, label_type, probs.argmax(axis=1))
        detail = None
        if self.get(HasPredictionDetailCol.PREDICTION_DETAIL_COL):
            detail = detail_json(labels, probs)
        return pred, label_type, detail


class XGBoostPredictBatchOp(ModelMapBatchOp, HasPredictionCol,
                            HasPredictionDetailCol, HasReservedCols,
                            HasVectorCol, HasFeatureCols):
    mapper_cls = XGBoostModelMapper
