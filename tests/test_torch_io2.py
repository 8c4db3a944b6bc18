"""Parity of the port's io2 family (``alink_tpu_torch.operator.batch.io2``)
with the reference's on the CPU, after ``tests/test_io2.py``: the catalog
round trip and the named KV connectors give the reference's tables;
AggLookup under every handle, with missing keys, empty and null cells and a
key the model holds twice, gives the reference's vectors (MAX, MIN and
CONCAT exactly, SUM and AVG within 1e-12 relative) and the same rows with
no hit; WriteTensorToImage writes the reference's PNG bytes; the TF table
model, stepwise and BERT embedding names serve through the port's
trainers; InternalFullStats is Summarizer."""

import numpy as np
import pytest

from torch_table_parity import (both, reference_session, remove_session,
                                same_table)

pytestmark = pytest.mark.usefixtures("cpu_device")


@pytest.fixture
def cpu_device(monkeypatch):
    monkeypatch.setenv("ALINK_TORCH_DEVICE", "cpu")


@pytest.fixture(scope="module")
def sid():
    s = reference_session()
    yield s
    remove_session(s)


def test_catalog_source_sink_roundtrip(tmp_path, sid):
    cols = {"k": np.asarray(["a", "b"], object), "v": np.asarray([1.0, 2.0])}

    def build(ops, extra, src):
        db = str(tmp_path / f"{ops.__name__.split('.')[0]}.db")
        ops.CatalogSinkBatchOp(dbPath=db, tableName="t1", **extra
                               ).link_from(src).collect()
        return ops.CatalogSourceBatchOp(dbPath=db, tableName="t1", **extra)

    ref, port = both(sid, cols, build)
    same_table(port, ref, rtol=0)
    assert port.col("v").tolist() == [1.0, 2.0]


def test_named_kv_connectors(sid):
    cols = {"k": np.asarray(["a", "b", "missing"], object),
            "v": np.asarray([1.0, 2.0, 3.0])}

    def build(ops, extra, src):
        uri = f"memory://t19_io2_{ops.__name__.split('.')[0]}"
        head = ops.FirstNBatchOp(size=2, **extra).link_from(src)
        ops.RedisStringSinkBatchOp(storeUri=uri, keyCol="k",
                                   selectedCols=["v"], **extra
                                   ).link_from(head).collect()
        row = ops.LookupRedisRowBatchOp(
            storeUri=uri, selectedCols=["k"], outputCols=["v"],
            outputTypes=["DOUBLE"], **extra).link_from(src)
        return ops.LookupRedisStringBatchOp(
            storeUri=uri, selectedCols=["k"], outputCols=["raw"],
            **extra).link_from(row)

    ref, port = both(sid, cols, build)
    same_table(port, ref, rtol=0)
    assert list(port.col("raw")) == ["1.0", "2.0", None]


def _embeddings(seed=0, keys=60, dim=7):
    rng = np.random.default_rng(seed)
    names = [f"w{i}" for i in range(keys)] + ["w3", ""]   # w3 twice
    vecs = [" ".join(repr(float(x)) for x in rng.normal(size=dim))
            for _ in names]
    return {"key": np.asarray(names, object),
            "vec": np.asarray(vecs, object)}


def _queries(seed=1, rows=80, keys=60):
    rng = np.random.default_rng(seed)
    cells = []
    for _ in range(rows):
        k = rng.integers(1, 9)
        ws = [f"w{rng.integers(0, keys)}" if rng.random() > 0.1
              else f"nope{rng.integers(0, 5)}" for _ in range(k)]
        cells.append(" , ".join(ws) if rng.random() > 0.5 else ",".join(ws))
    cells += ["nope1,nope2", "", None, " , ,w5,", "w3"]
    return {"keys": np.asarray(cells, object)}


def _agg_tables(sid, handle, **kw):
    from alink_tpu.common.mtable import MTable as RT
    from alink_tpu_torch.common.mtable import MTable as PT
    import alink_tpu.operator.batch as R
    import alink_tpu_torch.operator.batch as P

    outs = []
    for ops, T, extra in ((R, RT, dict(MLEnvironmentId=sid)), (P, PT, {})):
        emb = ops.TableSourceBatchOp(T(_embeddings(), "key string, "
                                       "vec DENSE_VECTOR"))
        data = ops.TableSourceBatchOp(T(_queries()))
        outs.append(ops.AggLookupBatchOp(selectedCol="keys", handle=handle,
                                         outputCol="agg", **extra, **kw)
                    .link_from(emb, data).collect())
    return outs


@pytest.mark.parametrize("handle,rtol", [
    ("AVG", 1e-12), ("MEAN", 1e-12), ("SUM", 1e-12), ("MAX", 0),
    ("MIN", 0), ("CONCAT", 0)])
def test_agg_lookup_matches_the_reference(sid, handle, rtol):
    ref, port = _agg_tables(sid, handle)
    assert port.names == ref.names
    for a, b in zip(port.col("agg"), ref.col("agg")):
        assert (a is None) == (b is None)
        if b is not None:
            assert a.data.shape == b.data.shape
            np.testing.assert_allclose(a.data, b.data, rtol=rtol, atol=0)
    assert sum(v is None for v in port.col("agg")) >= 3


@pytest.mark.parametrize("handle", ["SUM", "MAX", "CONCAT"])
def test_agg_lookup_chunks_equal_one_pass(sid, handle, monkeypatch):
    """Cells reduced a few at a time give the one-pass vectors."""
    from alink_tpu_torch.operator.batch import io2

    _, whole = _agg_tables(sid, handle)
    monkeypatch.setattr(io2, "_AGG_CHUNK_ELEMS", 30)
    _, parts = _agg_tables(sid, handle)
    for a, b in zip(parts.col("agg"), whole.col("agg")):
        assert (a is None) == (b is None)
        if b is not None:
            np.testing.assert_array_equal(a.data, b.data)


def test_write_tensor_to_image_bytes_equal_the_references(tmp_path):
    import alink_tpu.operator.batch as R
    import alink_tpu_torch.operator.batch as P
    from alink_tpu.common.mtable import MTable as RT
    from alink_tpu_torch.common.mtable import MTable as PT

    rng = np.random.default_rng(0)
    cells = [np.arange(64, dtype=np.uint8).reshape(8, 8),
             rng.integers(0, 255, (4, 5, 3)).astype(np.uint8),
             rng.normal(size=(6, 3)), None]
    names = ["g.png", "c.png", "f.png", "none.png"]
    for ops, T, d in ((R, RT, "ref"), (P, PT, "port")):
        (tmp_path / d).mkdir()
        col = np.empty(len(cells), object)
        col[:] = cells
        t = T({"t": col, "p": np.asarray(names, object)},
              "t TENSOR, p string")
        ops.WriteTensorToImageBatchOp(
            selectedCol="t", rootFilePath=str(tmp_path / d),
            relativeFilePathCol="p").link_from(
            ops.TableSourceBatchOp(t)).collect()
    for name in names[:3]:
        data = (tmp_path / "port" / name).read_bytes()
        assert data[:8] == b"\x89PNG\r\n\x1a\n"
        assert data == (tmp_path / "ref" / name).read_bytes()
    assert not (tmp_path / "port" / "none.png").exists()


def test_tf_table_model_names_serve():
    """The TF table-model names train and serve through the port's
    KerasSequential ops."""
    import alink_tpu_torch.operator.batch as P
    from alink_tpu_torch.common.mtable import MTable

    assert issubclass(P.TFTableModelClassifierTrainBatchOp,
                      P.KerasSequentialClassifierTrainBatchOp)
    assert issubclass(P.TFTableModelRegressorTrainBatchOp,
                      P.KerasSequentialRegressorTrainBatchOp)
    assert issubclass(P.TFTableModelPredictBatchOp,
                      P.KerasSequentialRegressorPredictBatchOp)
    rng = np.random.RandomState(0)
    X = rng.rand(120, 2)
    y = (X[:, 0] > 0.5).astype(np.int64)
    src = P.TableSourceBatchOp(MTable({"a": X[:, 0], "b": X[:, 1], "y": y}))
    m = P.TFTableModelClassifierTrainBatchOp(
        featureCols=["a", "b"], labelCol="y",
        layers=["Dense(32, relu)", "Dense(2)"], numEpochs=120, batchSize=32,
        learningRate=3e-3).link_from(src)
    p = P.TFTableModelClassifierPredictBatchOp(predictionCol="p").link_from(
        m, src).collect()
    assert float(np.mean(np.asarray(p.col("p")) == y)) > 0.85
    r = P.TF2TableModelTrainBatchOp(
        featureCols=["a", "b"], labelCol="a", layers=["Dense(1)"],
        numEpochs=2, batchSize=32).link_from(src)
    out = P.TFTableModelPredictBatchOp(predictionCol="q").link_from(
        r, src).collect()
    assert np.isfinite(np.asarray(out.col("q"), float)).all()


def test_stepwise_reference_names():
    import alink_tpu_torch.operator.batch as P
    from alink_tpu_torch.common.mtable import MTable

    rng = np.random.default_rng(0)
    x = rng.normal(size=100)
    y = 2 * x + 0.01 * rng.normal(size=100)
    src = P.TableSourceBatchOp(MTable({"x": x, "noise": rng.normal(size=100),
                                       "y": y}))
    m = P.LinearRegStepwiseTrainBatchOp(labelCol="y").link_from(src)
    p = P.LinearRegStepwisePredictBatchOp(predictionCol="p").link_from(
        m, src).collect()
    assert np.corrcoef(p.col("p"), y)[0, 1] > 0.99
    assert issubclass(P.LinearRegStepwiseTrainBatchOp,
                      P.StepwiseLinearRegTrainBatchOp)


def test_internal_full_stats_is_the_summarizer(sid):
    rng = np.random.default_rng(2)
    cols = {"a": rng.normal(size=50), "b": rng.integers(0, 9, 50)}
    ref, port = both(sid, cols, lambda ops, extra, src:
                     ops.InternalFullStatsBatchOp(**extra).link_from(src))
    _, summ = both(sid, cols, lambda ops, extra, src:
                   ops.SummarizerBatchOp(**extra).link_from(src))
    same_table(port, summ, rtol=0)
    same_table(port, ref, rtol=1e-12)


def test_bert_text_embedding():
    import alink_tpu_torch.operator.batch as P
    from alink_tpu_torch.common.mtable import MTable

    texts = ["good great nice"] * 8 + ["bad awful poor"] * 8
    src = P.TableSourceBatchOp(MTable({
        "text": np.asarray(texts, object),
        "label": np.asarray([1] * 8 + [0] * 8, np.int64)}))
    model = P.BertTextClassifierTrainBatchOp(
        textCol="text", labelCol="label", bertSize="tiny", maxSeqLength=8,
        numEpochs=2, batchSize=8, vocabSize=64).link_from(src)
    out = P.BertTextEmbeddingBatchOp().link_from(model, src).collect()
    v, v2, v3 = (out.col("embedding")[i].data for i in (0, 1, -1))
    assert v.ndim == 1 and v.size > 8
    np.testing.assert_allclose(v, v2, atol=1e-5)
    assert not np.allclose(v, v3, atol=1e-5)


def test_xls_sink_names_openpyxl(tmp_path):
    import alink_tpu_torch.operator.batch as P
    from alink_tpu_torch.common.exceptions import AkPluginNotExistException
    from alink_tpu_torch.common.mtable import MTable

    op = P.XlsSinkBatchOp(filePath=str(tmp_path / "x.xlsx")).link_from(
        P.TableSourceBatchOp(MTable({"a": np.asarray([1.0])})))
    with pytest.raises(AkPluginNotExistException, match="openpyxl"):
        op.collect()


def test_all_batch_names_registered():
    import alink_tpu.operator.batch.io2 as R
    import alink_tpu_torch.operator.batch as P

    names = [n for n, c in vars(R).items() if isinstance(c, type)
             and n.endswith("BatchOp")]
    assert len(names) >= 30
    for n in names:
        assert hasattr(P, n), n
