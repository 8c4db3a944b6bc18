"""The port's scheme-dispatched filesystem (``alink_tpu_torch.io.filesystem``),
held against ``alink_tpu``'s on the CPU.

The cases of the reference's ``tests/test_filesystem.py`` run in both
packages: plain paths; ``memory://`` roundtrips of ``.ak`` files, the CSV
ops, the model-stream store and ``PipelineModel`` save/load; an unknown
scheme refused with the missing driver named; a custom scheme. The
reference's ``memory://`` is fsspec's store, the port's its own; each
package reads back what it wrote there. Across the packages: a ``.ak`` the
port writes to a local path reads back in the reference, and the other way
round, and both CSV sinks write the same bytes.
"""

import importlib

import numpy as np
import pytest

PKGS = ("alink_tpu", "alink_tpu_torch")


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("ALINK_TORCH_DEVICE", "cpu")


def _m(pkg, mod):
    return importlib.import_module(f"{pkg}.{mod}")


def _mem(pkg, path):
    fs = _m(pkg, "io.filesystem").get_file_system(path)
    fs.delete(path, recursive=True)
    return path


@pytest.mark.parametrize("pkg", PKGS)
def test_local_fs_plain_paths(pkg, tmp_path):
    fsm = _m(pkg, "io.filesystem")
    p = str(tmp_path / "x.txt")
    fs = fsm.get_file_system(p)
    with fs.open(p, "w") as f:
        f.write("hi")
    assert fs.exists(p) and "x.txt" in fs.listdir(str(tmp_path))
    fs.rename(p, str(tmp_path / "y.txt"))
    assert not fs.exists(p) and fs.exists(str(tmp_path / "y.txt"))
    fs.delete(str(tmp_path / "y.txt"))
    assert not fs.exists(str(tmp_path / "y.txt"))
    with fsm.file_open("file://" + str(tmp_path / "z.txt"), "w") as f:
        f.write("z")
    assert fsm.path_join(str(tmp_path), "z.txt") == str(tmp_path / "z.txt")
    with fsm.file_open(str(tmp_path / "z.txt")) as f:
        assert f.read() == "z"


@pytest.mark.parametrize("pkg", PKGS)
def test_memory_fs_roundtrip_and_layout(pkg):
    fsm = _m(pkg, "io.filesystem")
    p = _mem(pkg, "memory://fs-t1/f.txt")
    with fsm.file_open(p, "w") as f:
        f.write("payload")
    with fsm.file_open(p) as f:
        assert f.read() == "payload"
    fs = fsm.get_file_system(p)
    assert fs.exists(p) and fs.isdir("memory://fs-t1")
    assert fs.listdir("memory://fs-t1") == ["f.txt"]
    fs.rename(p, "memory://fs-t1/g.txt")
    assert not fs.exists(p) and fs.exists("memory://fs-t1/g.txt")
    fs.delete("memory://fs-t1", recursive=True)
    assert not fs.exists("memory://fs-t1/g.txt")


@pytest.mark.parametrize("pkg", PKGS)
def test_ak_on_memory_fs(pkg):
    ak = _m(pkg, "io.ak")
    p = _mem(pkg, "memory://fs-t2/model.ak")
    t = _m(pkg, "common.model").model_to_table(
        {"modelName": "M"}, {"w": np.arange(4, dtype=np.float32)})
    ak.write_ak(p, t)
    assert ak.read_ak(p).num_rows == t.num_rows
    assert ak.read_ak_meta(p)["num_rows"] == t.num_rows


def _csv_roundtrip(pkg, p):
    b = _m(pkg, "operator.batch")
    src = b.MemSourceBatchOp(
        [(1, "a", 0.5, True), (2, "b,c", float("nan"), False),
         (3, 'q"', 1 / 3, True)], "id long, s string, x double, ok boolean")
    src.link(b.CsvSinkBatchOp(filePath=p, overwriteSink=True)).collect()
    t = b.CsvSourceBatchOp(
        filePath=p, schemaStr="id long, s string, x double, ok boolean"
    ).collect()
    with pytest.raises(Exception):      # the overwrite guard fires there too
        src.link(b.CsvSinkBatchOp(filePath=p)).collect()
    return t


@pytest.mark.parametrize("pkg", PKGS)
def test_csv_ops_on_memory_fs(pkg):
    t = _csv_roundtrip(pkg, _mem(pkg, "memory://fs-t3/data.csv"))
    assert list(t.col("s")) == ["a", "b,c", 'q"']
    assert list(t.col("id")) == [1, 2, 3] and np.isnan(t.col("x")[1])


def test_csv_sinks_write_the_same_bytes(tmp_path):
    out = {}
    for pkg in PKGS:
        p = str(tmp_path / f"{pkg}.csv")
        t = _csv_roundtrip(pkg, p)
        with open(p, "rb") as f:
            out[pkg] = f.read(), [list(map(str, r)) for r in t.to_rows()]
    assert out["alink_tpu"] == out["alink_tpu_torch"]


@pytest.mark.parametrize("pkg", PKGS)
def test_ak_ops_on_memory_fs(pkg):
    b = _m(pkg, "operator.batch")
    p = _mem(pkg, "memory://fs-t4/tbl.ak")
    src = b.MemSourceBatchOp([(1, 2.0), (3, 4.0)], "a long, b double")
    src.link(b.AkSinkBatchOp(filePath=p, overwriteSink=True)).collect()
    assert list(b.AkSourceBatchOp(filePath=p).collect().col("a")) == [1, 3]


def test_modelstream_store_on_memory_fs():
    """The port's version store on ``memory://``: commits, ``latest``,
    retention and the blob's bytes, with no local file involved."""
    from alink_tpu_torch.common.model import model_to_table
    from alink_tpu_torch.common.metrics import metrics
    from alink_tpu_torch.io.ak import read_ak, write_ak
    from alink_tpu_torch.modelstream import ModelStreamStore

    d = _mem("alink_tpu_torch", "memory://fs-t6/stream")
    store = ModelStreamStore(d, keep=2)
    assert store.path == d
    t = model_to_table({"modelName": "M"}, {"w": np.ones(2, np.float32)})
    skipped = metrics.counter("modelstream.fsync_skipped")
    for epoch in (100, 200, 300):
        store.publish(epoch, lambda tmp: write_ak(tmp, t))
    assert store.versions() == [200, 300]
    epoch, manifest = store.latest()
    assert epoch == 300 and manifest["blob"] == "v-000000000300.ak"
    assert read_ak(store.blob_path(300)).num_rows == t.num_rows
    assert metrics.counter("modelstream.fsync_skipped") > skipped
    assert store.publish(300, lambda tmp: 1 / 0) == store.blob_path(300)


def test_pipeline_save_load_on_memory_fs():
    from alink_tpu_torch.operator.batch import MemSourceBatchOp
    from alink_tpu_torch.pipeline import (LogisticRegression, Pipeline,
                                          PipelineModel)

    p = _mem("alink_tpu_torch", "memory://fs-t7/pipe.ak")
    train = MemSourceBatchOp(
        [(1.0, 2.0, 0), (3.0, 4.0, 1), (5.0, 6.0, 1), (0.5, 1.0, 0)],
        "f0 double, f1 double, y long")
    model = Pipeline(LogisticRegression(
        featureCols=["f0", "f1"], labelCol="y", predictionCol="p",
        maxIter=5)).fit(train)
    model.save(p)
    out = PipelineModel.load(p).transform(train).collect()
    assert list(out.col("p")) == list(model.transform(train).collect()
                                      .col("p"))


@pytest.mark.parametrize("pkg", PKGS)
def test_unknown_scheme_raises_actionable(pkg):
    exc = _m(pkg, "common.exceptions").AkPluginNotExistException
    with pytest.raises(exc, match="driver"):
        _m(pkg, "io.filesystem").get_file_system(
            "definitelynotascheme://x/y")


@pytest.mark.parametrize("pkg", PKGS)
def test_register_custom_scheme(pkg, tmp_path):
    fsm = _m(pkg, "io.filesystem")

    class Rooted(fsm.BaseFileSystem):
        scheme = "rooted"

        def open(self, path, mode="r"):
            return open(tmp_path / path.split("://", 1)[1], mode)

        def exists(self, path):
            return (tmp_path / path.split("://", 1)[1]).exists()

    fsm.register_file_system("rooted", Rooted)
    with fsm.file_open("rooted://f.txt", "w") as f:
        f.write("z")
    assert fsm.get_file_system("rooted://f.txt").exists("rooted://f.txt")
    assert (tmp_path / "f.txt").read_text() == "z"


@pytest.mark.parametrize("writer,reader", [PKGS, PKGS[::-1]])
def test_ak_crosses_between_the_packages(writer, reader, tmp_path):
    p = str(tmp_path / "cross.ak")
    wt = _m(writer, "common.mtable").MTable(
        {"id": np.arange(5, dtype=np.int64), "x": np.linspace(0, 1, 5),
         "s": np.asarray(list("abcde"), object)})
    _m(writer, "io.ak").write_ak(p, wt, num_partitions=2)
    back = _m(reader, "operator.batch").AkSourceBatchOp(filePath=p).collect()
    assert back.names == ["id", "x", "s"]
    assert list(back.schema.types) == list(wt.schema.types)
    assert back.to_rows() == wt.to_rows()
