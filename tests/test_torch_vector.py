"""The vector families of the port (``operator/batch/vector.py`` and
``vector2.py``) held against ``alink_tpu`` on the CPU, on data/digits.csv's
pixel rows and seeded numpy columns; the reference runs in a session on a
one-device mesh.

The ops are host-side copies of the reference's and must give the same
tables: floats and vector entries within 1e-12 relative, the rest exactly
(the vector scalers' statistics models too).
"""

import os

import numpy as np
import pytest

from torch_table_parity import (both, remove_session, reference_session,
                                same_model, same_table)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIGITS = os.path.join(REPO, "data", "digits.csv")


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("ALINK_TORCH_DEVICE", "cpu")


@pytest.fixture(scope="module")
def sid():
    sid = reference_session()
    yield sid
    remove_session(sid)


def _digits(rows=120):
    """The first ``rows`` rows of data/digits.csv: 64 pixel columns as two
    vector strings (the first and last 32 pixels) and the label."""
    data = np.loadtxt(DIGITS, delimiter=",", max_rows=rows)
    px, label = data[:, :64], data[:, 64].astype(np.int64)
    fmt = lambda b: np.asarray([" ".join(f"{v:g}" for v in r)  # noqa: E731
                                for r in b], object)
    return {"a": fmt(px[:, :32]), "b": fmt(px[:, 32:]), "label": label,
            "p0": px[:, 10], "p1": px[:, 20]}


def _map(op, **kw):
    def build(ops, x, src):
        return getattr(ops, op)(**kw, **x).link_from(src)
    return build


@pytest.mark.parametrize("op,kw", [
    ("VectorNormalizeBatchOp", dict(selectedCol="a", outputCol="o", p=1.0)),
    ("VectorNormalizeBatchOp", dict(selectedCol="a", outputCol="o")),
    ("VectorSliceBatchOp", dict(selectedCol="a", outputCol="o",
                                indices=[0, 5, 31])),
    ("VectorElementwiseProductBatchOp",
     dict(selectedCol="a", outputCol="o",
          scalingVector=" ".join(str(i % 3) for i in range(32)))),
    ("VectorInteractionBatchOp", dict(selectedCols=["a", "b"],
                                      outputCol="o")),
    ("VectorToColumnsBatchOp", dict(selectedCol="a",
                                    outputCols=[f"c{i}" for i in range(32)])),
    ("ColumnsToVectorBatchOp", dict(selectedCols=["p0", "p1", "label"],
                                    outputCol="o")),
])
def test_vector_mappers_match_reference(sid, op, kw):
    ref, port = both(sid, _digits(), _map(op, **kw))
    same_table(port, ref)


def test_udf_and_udtf_match_reference(sid):
    cols = _digits(40)
    for rtype, fn in (("DOUBLE", lambda a, b: a * 2.0 + b),
                      ("LONG", lambda a, b: int(a) + int(b)),
                      ("STRING", lambda a, b: f"{a:g}/{b:g}"),
                      ("BOOLEAN", lambda a, b: a > b)):
        ref, port = both(sid, cols, lambda ops, x, src: ops.UdfBatchOp(
            fn, selectedCols=["p0", "p1"], outputCol="u", resultType=rtype,
            **x).link_from(src))
        same_table(port, ref)

    def split(label, p0):
        for i in range(int(label) % 3):
            yield (i, f"{p0:g}")

    ref, port = both(sid, cols, lambda ops, x, src: ops.UdtfBatchOp(
        split, selectedCols=["label", "p0"], outputCols=["i", "s"],
        resultTypes=["LONG", "STRING"], **x).link_from(src))
    assert port.num_rows > 0
    same_table(port, ref)


@pytest.mark.parametrize("name,kw", [
    ("VectorStandardScaler", dict()),
    ("VectorStandardScaler", dict(withMean=False)),
    ("VectorMinMaxScaler", dict(min=-1.0, max=1.0)),
    ("VectorMaxAbsScaler", dict()),
    ("VectorImputer", dict(strategy="MEAN")),
    ("VectorImputer", dict(strategy="MAX")),
    ("VectorImputer", dict(strategy="VALUE", fillValue=3.0)),
])
def test_vector_scalers_match_reference(sid, name, kw):
    cols = _digits()
    if name == "VectorImputer":
        cols["a"] = np.asarray([s.replace(" 0 ", " nan ", 1)
                                for s in cols["a"]], object)

    def build(ops, x, src):
        model = getattr(ops, name + "TrainBatchOp")(selectedCol="a", **kw,
                                                    **x).link_from(src)
        return getattr(ops, name + "PredictBatchOp")(outputCol="o", **x) \
            .link_from(model, src)

    ref, port = both(sid, cols, build)
    same_table(port, ref)
    same_model(*both(sid, cols, lambda ops, x, src: getattr(
        ops, name + "TrainBatchOp")(selectedCol="a", **kw, **x)
        .link_from(src))[::-1])


@pytest.mark.parametrize("fn", ["Max", "Min", "Mean", "ArgMax", "ArgMin",
                                "NormL1", "NormL2", "NormL2Square",
                                "Normalize", "Scale", "Abs"])
def test_vector_function_matches_reference(sid, fn):
    ref, port = both(sid, _digits(60), _map(
        "VectorFunctionBatchOp", selectedCol="a", outputCol="o",
        funcName=fn, withVariable=0.5))
    same_table(port, ref)


@pytest.mark.parametrize("fn", ["Plus", "Minus", "ElementWiseMultiply",
                                "Merge", "Dot", "EuclidDistance", "Cosine"])
def test_vector_bi_function_matches_reference(sid, fn):
    ref, port = both(sid, _digits(60), _map(
        "VectorBiFunctionBatchOp", selectedCols=["a", "b"], outputCol="o",
        biFuncName=fn))
    same_table(port, ref)


def test_polynomial_expand_and_size_hint_match_reference(sid):
    cols = _digits(30)
    ref, port = both(sid, cols, lambda ops, x, src:
                     ops.VectorPolynomialExpandBatchOp(
                         selectedCol="s", outputCol="o", degree=3, **x)
                     .link_from(ops.VectorSliceBatchOp(
                         selectedCol="a", outputCol="s", indices=[2, 3, 4],
                         **x).link_from(src)))
    same_table(port, ref)
    for how in ("SKIP", "OPTIMISTIC"):
        ref, port = both(sid, cols, _map("VectorSizeHintBatchOp",
                                         selectedCol="a", outputCol="o",
                                         size=31, handleInvalidMethod=how))
        same_table(port, ref)


def test_vector_chisq_selector_matches_reference(sid):
    ref, port = both(sid, _digits(), _map(
        "VectorChiSqSelectorBatchOp", selectedCol="a", labelCol="label",
        numTopFeatures=5))
    same_model(port, ref)
