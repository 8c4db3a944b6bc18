"""Parity of the port's format, tensor and ModelInfo families
(``alink_tpu_torch.operator.batch.format``, ``tensorops``, ``modelinfo``)
with the reference's, on the CPU: the same seeded columns through both
packages' operators, the tables held equal cell by cell and every rendered
string byte for byte (tolerance 0). Tensor strings written by one package
read back in the other."""

import json

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


def _columns():
    """Mixed cells: ints, floats that print long, a NaN, booleans, strings
    with the delimiters' neighbours, and a None."""
    rng = np.random.default_rng(19)
    n = 12
    x = rng.normal(size=n) * 10.0 ** rng.integers(-12, 12, n)
    x[3] = np.nan
    return {"id": np.arange(n, dtype=np.int64),
            "x": x,
            "flag": rng.random(n) > 0.5,
            "s": np.asarray([f"w{i}" if i % 5 else None
                             for i in range(n)], object)}


SCHEMA = "id long, x double, flag boolean, s string"


@pytest.mark.parametrize("dst", ["Csv", "Json", "Kv"])
def test_columns_to_string_formats_are_byte_equal(sid, dst):
    """ColumnsTo{Csv,Json,Kv}: the rendered strings equal the reference's
    (json.dumps of numpy scalars through ``_scalar``, repr of floats)."""
    ref, port = both(sid, _columns(), lambda ops, extra, src: getattr(
        ops, f"ColumnsTo{dst}BatchOp")(
        selectedCols=["id", "x", "flag", "s"], reservedCols=["id"],
        schemaStr=SCHEMA, **extra).link_from(src))
    same_table(port, ref)
    col = ref.names[-1]
    assert list(port.col(col)) == list(ref.col(col))


@pytest.mark.parametrize("src_fmt,dst", [
    ("Csv", "Columns"), ("Csv", "Json"), ("Csv", "Kv"), ("Json", "Columns"),
    ("Json", "Csv"), ("Json", "Kv"), ("Kv", "Columns"), ("Kv", "Json"),
    ("Kv", "Csv"), ("Json", "Vector"), ("Kv", "Vector"), ("Vector", "Json"),
    ("Vector", "Kv"), ("Vector", "Csv"), ("Csv", "Vector")])
def test_pair_ops_match_the_reference(sid, src_fmt, dst):
    """Every generated pair op on cells the reference rendered itself."""
    import alink_tpu.operator.batch as R
    from alink_tpu.common.mtable import MTable

    rsrc = R.TableSourceBatchOp(MTable(_columns(), SCHEMA))
    if src_fmt == "Vector":
        rng = np.random.default_rng(5)
        cells = [f"$8${i}:{rng.normal():.17g} {i + 3}:{rng.normal()!r}"
                 for i in range(5)] + [" ".join(
                     repr(float(v)) for v in rng.normal(size=4))]
        cols = {"vec": np.asarray(cells, object)}
    else:
        rendered = getattr(R, f"ColumnsTo{src_fmt}BatchOp")(
            selectedCols=["id", "x", "s"], schemaStr="id long, x double, "
            "s string", kvCol="kv", csvCol="csv", jsonCol="json",
            reservedCols=[], MLEnvironmentId=sid).link_from(rsrc).collect()
        cols = {c: rendered.col(c) for c in rendered.names}
    numeric = dst == "Vector" or src_fmt == "Vector"
    if numeric and src_fmt != "Vector":
        keys = {"Json": "json", "Kv": "kv", "Csv": "csv"}[src_fmt]
        cols = {keys: np.asarray(
            {"Json": ['{"0": 1.5, "3": -2.25}', '{"1": 1e-30}'],
             "Kv": ["0:1.5,3:-2.25", "1:1e-30"],
             "Csv": ["1.5,0.25", "3.0,-7.125"]}[src_fmt], object)}
    params = dict(schemaStr=("a double, b double" if numeric
                             else "id long, x double, s string"),
                  kvCol="kv", csvCol="csv", jsonCol="json", vectorCol="vec",
                  reservedCols=[])
    if src_fmt == "Csv" and dst == "Vector":
        params["schemaStr"] = "0 double, 1 double"
    ref, port = both(sid, cols, lambda ops, extra, src: getattr(
        ops, f"{src_fmt}To{dst}BatchOp")(**params, **extra).link_from(src))
    same_table(port, ref, rtol=0)


def test_columns_json_kv_roundtrip(sid):
    """tests/test_longtail.py's round trip, in both packages."""
    cols = {"id": np.asarray([1, 2], np.int64),
            "s": np.asarray(["a", "b"], object),
            "x": np.asarray([2.5, 3.5])}

    def build(ops, extra, src):
        kv = ops.ColumnsToKvBatchOp(selectedCols=["id", "x"], kvCol="f",
                                    reservedCols=[], **extra).link_from(src)
        return ops.KvToColumnsBatchOp(kvCol="f", schemaStr="id long, "
                                      "x double", reservedCols=[],
                                      **extra).link_from(kv)

    ref, port = both(sid, cols, build)
    same_table(port, ref, rtol=0)
    assert list(port.col("id")) == [1, 2]


def test_triples_round_trip_and_named_ops(sid):
    cols = {"a": np.asarray([10, 20], np.int64), "b": np.asarray([1.5, 2.5]),
            "kv": np.asarray(["a:1,b:2", "a:3,b:4.5"], object)}
    trip_r, trip_p = both(sid, cols, lambda ops, extra, src:
                          ops.ColumnsToTripleBatchOp(
                              selectedCols=["a", "b"], **extra)
                          .link_from(src))
    same_table(trip_p, trip_r, rtol=0)
    assert trip_p.num_rows == 4
    tcols = {n: trip_r.col(n) for n in trip_r.names}
    for to in ("Columns", "Csv", "Json", "Kv", "Vector"):
        back_r, back_p = both(sid, tcols, lambda ops, extra, src:
                              ops.TripleToAnyBatchOp(
                                  toFormat=to, schemaStr="a long, b double",
                                  handleInvalid="SKIP", **extra)
                              .link_from(src))
        same_table(back_p, back_r, rtol=0)
    names = ["Csv", "Json", "Kv", "Vector"]
    for fmt in names:
        r, p = both(sid, {"kv": cols["kv"]}, lambda ops, extra, src:
                    ops.KvToTripleBatchOp(selectedCols=["kv"], **extra)
                    .link_from(src))
        same_table(p, r, rtol=0)
        tc = {n: r.col(n) for n in r.names}
        r2, p2 = both(sid, tc, lambda ops, extra, src: getattr(
            ops, f"TripleTo{fmt}BatchOp")(schemaStr="a long, b double",
                                          handleInvalid="SKIP", **extra)
            .link_from(src))
        same_table(p2, r2, rtol=0)
    import alink_tpu.operator.batch.format as RF
    import alink_tpu_torch.operator.batch.format as PF

    assert sorted(PF.__all__) == sorted(RF.__all__)


def test_tensor_strings_cross_the_packages():
    """``tensor_to_string`` equals the reference's for every dtype tag, and
    each package parses the other's strings back to the same array."""
    from alink_tpu.operator.batch import tensorops as RT
    from alink_tpu_torch.operator.batch import tensorops as PT

    rng = np.random.default_rng(7)
    arrays = [rng.normal(size=(2, 3)).astype(np.float32),
              rng.normal(size=(4,)),
              rng.integers(-9, 9, (3, 1)).astype(np.int32),
              rng.integers(-2 ** 40, 2 ** 40, (2, 2)),
              rng.integers(0, 255, (5,)).astype(np.uint8),
              rng.random((2, 2)) > 0.5,
              np.float16([1.5, -2.0]),
              np.int16([3, -4]),
              np.zeros((0, 3), np.float32)]
    for a in arrays:
        s = PT.tensor_to_string(a)
        assert s == RT.tensor_to_string(a)
        for parse in (RT.string_to_tensor, PT.string_to_tensor):
            b = parse(s)
            want = RT.string_to_tensor(s)
            assert b.dtype == want.dtype and b.shape == want.shape
            np.testing.assert_array_equal(b, want)


def test_tensor_ops_match_the_reference(sid):
    """tests/test_op_longtail2.py's tensor chain, every step held equal."""
    from alink_tpu.operator.batch import tensorops as RT

    cols = {"v": np.asarray(["1 2 3 4", "5 6 7.5 8"], object)}
    def chain(ops, extra, src, step):
        t = ops.VectorToTensorBatchOp(selectedCol="v", outputCol="t",
                                      tensorShape=[2, 2], **extra)
        t.link_from(src)
        if step == 0:
            return t
        if step == 1:
            return ops.TensorSerializeBatchOp(selectedCol="t", outputCol="s",
                                              **extra).link_from(t)
        if step == 2:
            return ops.TensorReshapeBatchOp(selectedCol="t", outputCol="r",
                                            newShape=[4], **extra
                                            ).link_from(t)
        if step == 3:
            return ops.TensorToVectorBatchOp(selectedCol="t", outputCol="tv",
                                             convertMethod="MEAN", **extra
                                             ).link_from(t)
        if step == 4:
            return ops.ToVectorBatchOp(selectedCol="t", outputCol="tv2",
                                       **extra).link_from(t)
        s = ops.TensorSerializeBatchOp(selectedCol="t", outputCol="s",
                                       **extra).link_from(t)
        return ops.ToTensorBatchOp(selectedCol="s", outputCol="t2",
                                   tensorDataType="DOUBLE", **extra
                                   ).link_from(s)

    for step in range(6):
        ref, port = both(sid, cols, lambda ops, extra, src: chain(
            ops, extra, src, step))
        same_table(port, ref, rtol=0)
    # the port's serialized column reads back in the reference
    _, port = both(sid, cols, lambda ops, extra, src: chain(ops, extra,
                                                            src, 1))
    np.testing.assert_array_equal(
        RT.string_to_tensor(port.col("s")[1]),
        np.asarray([[5, 6], [7.5, 8]], np.float32))


def test_vector_and_mtable_serialize_match_the_reference(sid):
    import alink_tpu.common.mtable as RM
    import alink_tpu_torch.common.mtable as PM

    inner = {"i": np.asarray([1, 2], np.int64), "x": np.asarray([0.5, 1.5])}
    outs = []
    for M, mod in ((RM, "alink_tpu"), (PM, "alink_tpu_torch")):
        ops = __import__(f"{mod}.operator.batch", fromlist=["x"])
        t = M.MTable({"m": np.asarray([M.MTable(dict(inner)), None],
                                      object),
                      "v": np.asarray(["$3$0:1.0 2:0.1", "1 2"], object)},
                     "m MTABLE, v VECTOR")
        src = ops.TableSourceBatchOp(t)
        ser = ops.MTableSerializeBatchOp(selectedCol="m", outputCol="ms"
                                         ).link_from(src)
        vs = ops.VectorSerializeBatchOp(selectedCol="v", outputCol="vs"
                                        ).link_from(ser).collect()
        outs.append(vs)
    ref, port = outs
    assert list(port.col("vs")) == list(ref.col("vs"))
    assert json.loads(port.col("ms")[0])["schema"] == \
        json.loads(ref.col("ms")[0])["schema"]
    back = PM.MTable({"ms": np.asarray(list(ref.col("ms")), object)})
    from alink_tpu_torch.operator.batch import tensorops as PT

    cell = PT.ToMTableMapper(back.schema, None, selectedCol="ms").map_column(
        back.col("ms"), "STRING")[0][0]
    assert cell.col("i").tolist() == [1, 2]


def _port_table(ref_t):
    from alink_tpu_torch.common.mtable import MTable, TableSchema

    return MTable({n: ref_t.col(n) for n in ref_t.names},
                  TableSchema.parse(ref_t.schema.to_str()))


def test_model_info_reads_either_packages_models(sid):
    """ModelInfo of a KMeans model and a GBDT model: the port's op on the
    reference's model table gives the reference op's rows, and the named
    per-model classes are the same family."""
    import alink_tpu.operator.batch as R
    import alink_tpu_torch.operator.batch as P
    from alink_tpu.common.mtable import MTable

    rng = np.random.default_rng(0)
    cols = {f"f{i}": rng.standard_normal(60) for i in range(3)}
    cols["y"] = (cols["f0"] > 0).astype(np.int64)
    src = R.TableSourceBatchOp(MTable(cols))
    models = [R.KMeansTrainBatchOp(k=2, featureCols=["f0", "f1", "f2"],
                                   MLEnvironmentId=sid).link_from(src),
              R.GbdtTrainBatchOp(featureCols=["f0", "f1"], labelCol="y",
                                 numTrees=2, MLEnvironmentId=sid)
              .link_from(src)]
    for m in models:
        model = m.collect()
        ref = R.ModelInfoBatchOp(MLEnvironmentId=sid).link_from(
            R.TableSourceBatchOp(model)).collect()
        port = P.GbdtModelInfoBatchOp().link_from(
            P.TableSourceBatchOp(_port_table(model))).collect()
        same_table(port, ref, rtol=0)
    import alink_tpu.operator.batch.modelinfo as RI
    import alink_tpu_torch.operator.batch.modelinfo as PI

    assert PI.__all__ == RI.__all__
    assert issubclass(P.ExtractModelInfoBatchOp, P.ModelInfoBatchOp)
