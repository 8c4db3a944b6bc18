"""The floor of chip_smoke.py's 12.5(a): ``alink_tpu``'s KerasSequential
classifier (Keras's mnist_mlp layers, ``chip_smoke.KERAS_DIGITS``) on
data/digits.csv's 80/20 split, on the CPU with the root conftest's 8
virtual devices. Its holdout accuracy is the constant the card's run is
held to (``KERAS_DIGITS_REFERENCE_ACC`` − 0.02); the port's CPU route must
clear that floor too. Dropout draws differ between the packages by design,
so the two accuracies are compared through the floor, not for equality."""

import importlib
import os

import numpy as np

import chip_smoke


def _holdout_acc(pkg):
    B = importlib.import_module(pkg + ".operator.batch")
    here = os.path.dirname(os.path.abspath(chip_smoke.__file__))
    dcols = [f"p{i}" for i in range(64)]
    digits = B.CsvSourceBatchOp(
        filePath=os.path.join(here, "data", "digits.csv"),
        schemaStr=", ".join(f"{c} double" for c in dcols)
        + ", label long").collect()
    tr, te = digits.shuffle(seed=0).split_at(int(digits.num_rows * 0.8))
    model = B.KerasSequentialClassifierTrainBatchOp(
        layers=chip_smoke.KERAS_LAYERS, labelCol="label",
        **chip_smoke.KERAS_DIGITS).link_from(B.TableSourceBatchOp(tr))
    pred = B.KerasSequentialClassifierPredictBatchOp(
        predictionCol="pred").link_from(model, B.TableSourceBatchOp(te)) \
        .collect()
    return float(np.mean(np.asarray(pred.col("pred"))
                         == np.asarray(te.col("label"))))


def test_reference_keras_digits_accuracy_is_the_smoke_constant():
    assert _holdout_acc("alink_tpu") == chip_smoke.KERAS_DIGITS_REFERENCE_ACC


def test_port_keras_digits_accuracy_clears_the_floor(monkeypatch):
    import torch

    monkeypatch.setenv("ALINK_TORCH_DEVICE", "cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)    # a small MLP: no pool to contend
    try:
        acc = _holdout_acc("alink_tpu_torch")
    finally:
        torch.set_num_threads(threads)
    assert acc >= \
        chip_smoke.KERAS_DIGITS_REFERENCE_ACC - chip_smoke.DIGITS_SLACK, acc
    # the card's run reads the same split through chip_smoke's own helper
    tr, te = chip_smoke.digits_table()
    assert (tr.num_rows, te.num_rows) == (1437, 360)
