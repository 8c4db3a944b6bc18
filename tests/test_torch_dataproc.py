"""The data-preparation family of the port (``operator/batch/
dataproc.py``) held against ``alink_tpu`` on the CPU, on seeded numpy
columns; the reference runs in a session on a one-device mesh.

The ops are host-side copies of the reference's and must give the same
tables: floats within 1e-12 relative, the rest exactly; the samplers draw
the same rows from the same numpy seed. OverWindow runs on each package's
SQL engine over sqlite (the reference's and the port's
``operator/sqlengine.py``).
"""

import json

import numpy as np
import pytest

from torch_table_parity import (both, remove_session, reference_session,
                                same_model, same_table)


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("ALINK_TORCH_DEVICE", "cpu")


@pytest.fixture(scope="module")
def sid():
    sid = reference_session()
    yield sid
    remove_session(sid)


def _cols(seed=0, n=150):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=n)
    x[rng.random(n) < 0.1] = np.nan
    return {
        "user": np.asarray(rng.choice(["u1", "u2", "u3"], n), object),
        "ts": rng.permutation(n).astype(np.int64),
        "amount": rng.uniform(0, 100, n),
        "x": x,
        "k": rng.integers(0, 4, n).astype(np.int64),
        "city": np.asarray(rng.choice(["rome", "oslo", "lima", "kyiv"], n,
                                      p=[0.4, 0.3, 0.2, 0.1]), object),
        "w": rng.uniform(0.1, 5.0, n),
        "js": np.asarray([json.dumps({"a": {"b": [int(i), int(i) * 2]},
                                      "c": f"s{i % 7}"}) if i % 11 else None
                          for i in range(n)], object),
    }


def _fit_predict(train, predict, train_kw, predict_kw=None):
    def build(ops, x, src):
        model = getattr(ops, train)(**train_kw, **x).link_from(src)
        return getattr(ops, predict)(**(predict_kw or {}), **x) \
            .link_from(model, src)
    return build


def _map(op, **kw):
    def build(ops, x, src):
        return getattr(ops, op)(**kw, **x).link_from(src)
    return build


@pytest.mark.parametrize("order", ["ALPHABET_ASC", "ALPHABET_DESC",
                                   "FREQUENCY_ASC", "FREQUENCY_DESC",
                                   "RANDOM"])
def test_string_indexer_matches_reference(sid, order):
    cols = _cols()
    ref, port = both(sid, cols, _fit_predict(
        "StringIndexerTrainBatchOp", "StringIndexerPredictBatchOp",
        dict(selectedCols=["city", "user"], stringOrderType=order),
        dict(outputCols=["ci", "ui"])))
    same_table(port, ref)


@pytest.mark.parametrize("handle", ["KEEP", "SKIP", "ERROR"])
def test_string_indexer_unseen_tokens_match_reference(sid, handle):
    cols = _cols()
    test = dict(cols, city=np.asarray(["rome", "paris"] * 75, object))

    def build(ops, x, src, test_src):
        model = ops.StringIndexerTrainBatchOp(selectedCols=["city"], **x) \
            .link_from(src)
        return ops.StringIndexerPredictBatchOp(handleInvalid=handle, **x) \
            .link_from(model, test_src)

    if handle == "ERROR":
        import alink_tpu_torch.operator.batch as P
        from alink_tpu_torch.common.exceptions import \
            AkIllegalArgumentException
        from alink_tpu_torch.common.mtable import MTable

        model = P.StringIndexerTrainBatchOp(selectedCols=["city"]) \
            .link_from(P.TableSourceBatchOp(MTable(dict(cols))))
        with pytest.raises(AkIllegalArgumentException, match="paris"):
            P.StringIndexerPredictBatchOp(handleInvalid=handle).link_from(
                model, P.TableSourceBatchOp(MTable(dict(test)))).collect()
        return
    ref, port = both(sid, cols, build, test)
    same_table(port, ref)


@pytest.mark.parametrize("huge", ["HugeStringIndexerPredictBatchOp",
                                  "HugeMultiStringIndexerPredictBatchOp"])
def test_huge_string_indexers_match_reference(sid, huge):
    """The huge variants map the data in blocks (here of 40 rows) with
    one loaded dictionary: the same table as the reference's."""
    cols = _cols()

    def build(ops, x, src):
        model = ops.StringIndexerTrainBatchOp(
            selectedCols=["city", "user"], **x).link_from(src)
        return getattr(ops, huge)(blockSize=40, **x).link_from(model, src)

    ref, port = both(sid, cols, build)
    same_table(port, ref)


@pytest.mark.parametrize("strategy", ["MEAN", "MIN", "MAX", "VALUE"])
def test_imputer_matches_reference(sid, strategy):
    cols = _cols(1)
    kw = dict(selectedCols=["x", "amount"], strategy=strategy)
    if strategy == "VALUE":
        kw["fillValue"] = "-7.5"
    ref, port = both(sid, cols, _fit_predict(
        "ImputerTrainBatchOp", "ImputerPredictBatchOp", kw))
    same_table(port, ref)
    same_model(*both(sid, cols, lambda ops, x, src: ops.ImputerTrainBatchOp(
        **kw, **x).link_from(src))[::-1])


def test_json_value_matches_reference(sid):
    ref, port = both(sid, _cols(2), _map(
        "JsonValueBatchOp", selectedCol="js",
        jsonPath=["$.a.b[1]", "$.c", "$.a", "$.missing"],
        outputCols=["b1", "c", "a", "m"]))
    same_table(port, ref)


def test_lookup_matches_reference(sid):
    cols = _cols(3)
    dim = {"city": np.asarray(["rome", "oslo", "lima"], object),
           "country": np.asarray(["IT", "NO", "PE"], object),
           "pop": np.asarray([2.8, 0.7, 9.7])}

    def build(ops, x, src, dim_src):
        return ops.LookupBatchOp(mapKeyCols=["city"],
                                 mapValueCols=["country", "pop"],
                                 selectedCols=["city"], **x).link_from(
            dim_src, src)

    ref, port = both(sid, cols, build, dim)
    same_table(port, ref)


@pytest.mark.parametrize("target", ["STRING", "DOUBLE", "FLOAT", "LONG",
                                    "INT", "BOOLEAN"])
def test_type_convert_matches_reference(sid, target):
    cols = _cols(4)
    cols = {"k": cols["k"], "amount": cols["amount"], "city": cols["city"]}
    sel = ["k", "amount"] if target != "STRING" else ["k", "amount", "city"]
    ref, port = both(sid, cols, _map("TypeConvertBatchOp", selectedCols=sel,
                                     targetType=target))
    same_table(port, ref)


@pytest.mark.parametrize("kw", [dict(strataRatio=0.5),
                                dict(strataRatios="rome:0.2,oslo:1.0",
                                     strataRatio=0.5)])
def test_stratified_sample_matches_reference(sid, kw):
    ref, port = both(sid, _cols(5), _map("StratifiedSampleBatchOp",
                                         strataCol="city", randomSeed=3,
                                         **kw))
    assert 0 < port.num_rows < 150
    same_table(port, ref)


def test_weight_and_rebalance_samples_match_reference(sid):
    ref, port = both(sid, _cols(6), _map("WeightSampleBatchOp",
                                         weightCol="w", ratio=0.3,
                                         randomSeed=4))
    assert port.num_rows == 45
    same_table(port, ref)
    ref, port = both(sid, _cols(6), _map("RebalanceBatchOp", randomSeed=5))
    same_table(port, ref)


def test_over_window_matches_reference(sid):
    cols = _cols(7)
    ref, port = both(sid, cols, _map(
        "OverWindowBatchOp", groupCols=["user"], orderCol="ts",
        aggSpecs=["sum(amount)", "avg(amount)", "count(amount)",
                  "max(city)"], windowSize=3))
    same_table(port, ref)
