"""The file sources and sinks of the port (``operator/batch/sources.py``
and ``io/tfrecord.py``) held against ``alink_tpu`` on the CPU.

- LibSvm, Tsv and TFRecord: the same table written by each package gives
  byte-identical files, and each package reads the other's file into the
  same table. Text: both read the same file alike.
- TFRecord's CRC32C and the Example codec equal to the reference's; a
  corrupted record is refused by both.
- The port's ``memory://`` store takes every source and sink.
- Parquet and Xls raise ``AkPluginNotExistException`` naming pyarrow and
  openpyxl.
"""

import numpy as np
import pytest


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("ALINK_TORCH_DEVICE", "cpu")


PKGS = ("alink_tpu", "alink_tpu_torch")


def _mods(pkg):
    import importlib

    return (importlib.import_module(pkg + ".operator.batch"),
            importlib.import_module(pkg + ".common.mtable").MTable)


def _libsvm_table(pkg):
    _, MTable = _mods(pkg)
    rng = np.random.default_rng(1)
    vecs = []
    for _ in range(12):
        idx = sorted(rng.choice(20, rng.integers(1, 5), replace=False))
        vecs.append("$20$" + " ".join(f"{i}:{round(v, 3)}" for i, v in
                                      zip(idx, rng.normal(size=len(idx)))))
    return MTable({"label": rng.integers(0, 3, 12).astype(np.float64),
                   "vec": np.asarray(vecs, object)})


TSV_SCHEMA = "id long, name string, score double"


def _tsv_table(pkg):
    _, MTable = _mods(pkg)
    return MTable.from_rows([(1, "a b", 0.5), (2, "c", -1.25), (3, "", 3.0)],
                            TSV_SCHEMA)


TF_SCHEMA = "id long, name string, score double, vec DENSE_VECTOR"


def _tf_table(pkg):
    _, MTable = _mods(pkg)
    return MTable.from_rows([(7, "x", 0.25, "1.0 2.5 -3.0"),
                             (-8, "yé", 1.5, "0.0 0.5 4.0")], TF_SCHEMA)


def _write(pkg, kind, path):
    ops, _ = _mods(pkg)
    if kind == "libsvm":
        ops.LibSvmSinkBatchOp(filePath=path, labelCol="label",
                              vectorCol="vec").link_from(
            ops.TableSourceBatchOp(_libsvm_table(pkg))).collect()
    elif kind == "tsv":
        ops.TsvSinkBatchOp(filePath=path).link_from(
            ops.TableSourceBatchOp(_tsv_table(pkg))).collect()
    else:
        ops.TFRecordSinkBatchOp(filePath=path).link_from(
            ops.TableSourceBatchOp(_tf_table(pkg))).collect()


def _read(pkg, kind, path):
    ops, _ = _mods(pkg)
    if kind == "libsvm":
        op = ops.LibSvmSourceBatchOp(filePath=path)
    elif kind == "tsv":
        op = ops.TsvSourceBatchOp(filePath=path, schemaStr=TSV_SCHEMA)
    elif kind == "text":
        op = ops.TextSourceBatchOp(filePath=path, textCol="line")
    else:
        op = ops.TFRecordSourceBatchOp(filePath=path, schemaStr=TF_SCHEMA)
    t = op.collect()
    return t.names, t.schema.types, [tuple(str(v) for v in r)
                                     for r in t.rows()]


@pytest.mark.parametrize("writer", PKGS)
@pytest.mark.parametrize("kind", ["libsvm", "tsv", "tfrecord"])
def test_files_cross_packages(tmp_path, kind, writer):
    reader = PKGS[1 - PKGS.index(writer)]
    mine, other = str(tmp_path / "w"), str(tmp_path / "o")
    _write(writer, kind, mine)
    _write(reader, kind, other)
    with open(mine, "rb") as f, open(other, "rb") as g:
        assert f.read() == g.read()
    assert _read(reader, kind, mine) == _read(writer, kind, mine)


def test_text_source_matches_reference(tmp_path):
    path = str(tmp_path / "t.txt")
    with open(path, "w") as f:
        f.write("first line\n\nthird, with comma\nno newline at end")
    assert _read("alink_tpu_torch", "text", path) == \
        _read("alink_tpu", "text", path)


def test_tfrecord_codec_matches_reference(tmp_path):
    from alink_tpu.io import tfrecord as R
    from alink_tpu_torch.io import tfrecord as P

    blob = bytes(range(256)) * 3
    assert P.crc32c(blob) == R.crc32c(blob)
    assert P.crc32c(b"123456789") == 0xE3069283
    feats = {"b": ("bytes", ["é", b"\x00\x01"]), "f": ("float", [1.5, -2.0]),
             "i": ("int64", [-1, 2 ** 40, 0])}
    enc = P.encode_example(feats)
    assert enc == R.encode_example(feats)
    assert P.decode_example(enc) == R.decode_example(enc)
    path = str(tmp_path / "r.tfrecord")
    P.write_records(path, [enc, b"", b"x" * 300])
    assert R.read_records(path) == [enc, b"", b"x" * 300]
    data = bytearray(open(path, "rb").read())
    data[14] ^= 0xFF                    # a payload byte of the first record
    open(path, "wb").write(bytes(data))
    for mod in (P, R):
        with pytest.raises(ValueError, match="crc"):
            mod.read_records(path)


@pytest.mark.parametrize("kind", ["libsvm", "tsv", "tfrecord"])
def test_memory_scheme_round_trip(tmp_path, kind):
    path = f"memory://sources/{kind}"
    _write("alink_tpu_torch", kind, path)
    local = str(tmp_path / "f")
    _write("alink_tpu_torch", kind, local)
    assert _read("alink_tpu_torch", kind, path) == \
        _read("alink_tpu_torch", kind, local)


def test_parquet_and_xls_refused():
    from alink_tpu_torch.common.exceptions import AkPluginNotExistException

    ops, MTable = _mods("alink_tpu_torch")
    with pytest.raises(AkPluginNotExistException, match="pyarrow"):
        ops.ParquetSourceBatchOp(filePath="x.parquet").collect()
    with pytest.raises(AkPluginNotExistException, match="pyarrow"):
        ops.ParquetSinkBatchOp(filePath="x.parquet").link_from(
            ops.TableSourceBatchOp(_tsv_table("alink_tpu_torch"))).collect()
    with pytest.raises(AkPluginNotExistException, match="openpyxl"):
        ops.XlsSourceBatchOp(filePath="x.xlsx", schemaStr="a double") \
            .collect()
