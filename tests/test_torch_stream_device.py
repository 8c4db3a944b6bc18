"""The stream ops with device work (FTRL, OnlineFm and OnlineLearning train,
FTRL and OnlineFm predict) refuse the CPU unless it is asked for: with no
CUDA device and no ``ALINK_TORCH_DEVICE``, they raise; asked for the CPU,
they run there (the pattern of ``tests/test_torch_port_rules.py``)."""

import numpy as np
import pytest


def _ops():
    from alink_tpu_torch.common.model import model_to_table
    from alink_tpu_torch.common.mtable import MTable
    from alink_tpu_torch.operator.stream import (FtrlPredictStreamOp,
                                                 FtrlTrainStreamOp,
                                                 OnlineFmPredictStreamOp,
                                                 OnlineFmTrainStreamOp,
                                                 OnlineLearningStreamOp,
                                                 TableSourceStreamOp)

    rng = np.random.default_rng(0)
    t = MTable({"a": rng.normal(size=40), "b": rng.normal(size=40),
                "label": (rng.random(40) > 0.5).astype(np.int64)})
    lr = model_to_table(
        {"modelName": "LinearModel", "linearModelType": "LR",
         "vectorCol": None, "featureCols": ["a", "b"], "labelCol": "label",
         "labelType": "LONG", "labels": [0, 1], "hasIntercept": True,
         "dim": 2},
        {"weights": np.asarray([0.5, -0.5], np.float32),
         "intercept": np.asarray([0.1], np.float32)})

    def src():
        return TableSourceStreamOp(t, chunkSize=10)

    def ftrl():
        return FtrlTrainStreamOp(featureCols=["a", "b"], labelCol="label")

    def fm():
        return OnlineFmTrainStreamOp(featureCols=["a", "b"],
                                     labelCol="label", numFactor=2)

    return {
        "ftrl_train": lambda: list(ftrl().link_from(src())._stream()),
        "ftrl_predict": lambda: FtrlPredictStreamOp(
            predictionCol="p").link_from(
            TableSourceStreamOp(lr, numChunks=1), src()).collect(),
        "fm_train": lambda: list(fm().link_from(src())._stream()),
        "fm_predict": lambda: OnlineFmPredictStreamOp(
            predictionCol="p").link_from(fm().link_from(src()),
                                         src()).collect(),
        "online_learning": lambda: list(OnlineLearningStreamOp().link_from(
            TableSourceStreamOp(lr), src())._stream()),
    }


@pytest.mark.parametrize("name", ["ftrl_train", "ftrl_predict", "fm_train",
                                  "fm_predict", "online_learning"])
def test_stream_device_ops_refuse_cpu_without_request(monkeypatch, name):
    import torch

    from alink_tpu_torch.common.exceptions import AkIllegalStateException

    monkeypatch.delenv("ALINK_TORCH_DEVICE", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    run = _ops()[name]
    with pytest.raises(AkIllegalStateException):
        run()
    # asking for the CPU runs there
    monkeypatch.setenv("ALINK_TORCH_DEVICE", "cpu")
    out = run()
    assert out is not None and (len(out) if isinstance(out, list)
                                else out.num_rows) > 0


def test_ftrl_state_lives_on_the_session_device(monkeypatch):
    """The FTRL accumulators are a tensor on the resolved device; the
    snapshot hands back host float32 arrays."""
    import torch

    from alink_tpu_torch.common.mtable import MTable
    from alink_tpu_torch.operator.stream import (FtrlTrainStreamOp,
                                                 OnlineFmTrainStreamOp,
                                                 TableSourceStreamOp)

    monkeypatch.setenv("ALINK_TORCH_DEVICE", "cpu")
    rng = np.random.default_rng(1)
    t = MTable({"a": rng.normal(size=30),
                "label": (rng.random(30) > 0.5).astype(np.int64)})
    op = FtrlTrainStreamOp(featureCols=["a"], labelCol="label")
    list(op.link_from(TableSourceStreamOp(t, chunkSize=10))._stream())
    scan = op._fstate["scan"]
    assert isinstance(scan.S, torch.Tensor) and scan.S.device.type == "cpu"
    assert scan.S.dtype == torch.float32 and scan.S.shape == (4, 3)
    fm = OnlineFmTrainStreamOp(featureCols=["a"], labelCol="label",
                               numFactor=2)
    list(fm.link_from(TableSourceStreamOp(t, chunkSize=10))._stream())
    params, accum = fm._fmstate["state"]
    assert all(isinstance(p, torch.Tensor) and p.device.type == "cpu"
               for p in params + accum)
    snap = fm.state_snapshot()
    assert all(isinstance(a, np.ndarray) for tree in snap["state"]
               for a in tree)
