"""The pipeline layer of the port (``alink_tpu_torch.pipeline``) and its
CSV source, held against ``alink_tpu`` on the CPU.

- The README quick-start, as written, on data/iris.csv's four feature
  columns in both packages: the same predictions.
- A PipelineModel saved by either package loads in the other and
  transforms identically (KMeans, Softmax and a decision tree stage; the
  Softmax detail's probabilities within 1e-6, its products summed in
  another order).
- ``LocalPredictor`` with the cached plan equal to ``cache_plan=False``.
- ``CsvSourceBatchOp`` equal to the reference's on data/iris.csv and
  data/digits.csv, with pandas blocked for the port.
- The reference's iris purity and digits holdout accuracy (bench.py's
  BASELINE #1 and #2 runs, on the 8 virtual devices of the root conftest)
  measured here, equal to the constants chip_smoke.py cites, and the
  port's equal to them.
- Every stage the port has fits through ``Pipeline`` as its operator does
  alone.
"""

import json
import os
import sys

import numpy as np
import pytest

import chip_smoke

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IRIS = os.path.join(REPO, "data", "iris.csv")
DIGITS = os.path.join(REPO, "data", "digits.csv")
DIGIT_COLS = [f"p{i}" for i in range(64)]
DIGITS_SCHEMA = ", ".join(f"{c} double" for c in DIGIT_COLS) + ", label long"


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("ALINK_TORCH_DEVICE", "cpu")


def _quick_start(pkg, path, save_to):
    """README.md's quick start, verbatim but for the package and paths."""
    import importlib

    ops = importlib.import_module(pkg + ".operator.batch")
    pl = importlib.import_module(pkg + ".pipeline")
    source = ops.CsvSourceBatchOp(
        filePath=path, schemaStr="sl double, sw double, pl double, pw double")
    model = pl.Pipeline(pl.KMeans(k=3, predictionCol="cluster")).fit(source)
    head = model.transform(source).collect().head(5)
    model.save(save_to)
    return head, np.asarray(model.transform(source).collect().col("cluster"))


def test_readme_quick_start_matches_reference(tmp_path):
    path = str(tmp_path / "iris.csv")
    with open(IRIS) as f, open(path, "w") as g:
        g.writelines(line.rsplit(",", 1)[0] + "\n" for line in f)
    ref_head, ref = _quick_start("alink_tpu", path, str(tmp_path / "r.ak"))
    port_head, port = _quick_start("alink_tpu_torch", path,
                                   str(tmp_path / "p.ak"))
    assert port_head.num_rows == 5 and len(port) == 150
    np.testing.assert_array_equal(port, ref)
    assert port_head.to_rows() == ref_head.to_rows()
    assert os.path.getsize(tmp_path / "p.ak") > 0


def _iris_pipeline(pl):
    feats = ["sl", "sw", "pl", "pw"]
    return pl.Pipeline(
        pl.KMeans(k=3, featureCols=feats, predictionCol="cluster"),
        pl.Softmax(featureCols=feats, labelCol="species", maxIter=5,
                   predictionCol="sp", predictionDetailCol="spd"),
        pl.DecisionTreeClassifier(featureCols=feats, labelCol="species",
                                  maxDepth=3, predictionCol="tree"))


def _iris_source(pkg):
    import importlib

    ops = importlib.import_module(pkg + ".operator.batch")
    return ops.CsvSourceBatchOp(filePath=IRIS,
                                schemaStr=chip_smoke.IRIS_SCHEMA)


def test_pipeline_model_crosses_packages(tmp_path):
    import alink_tpu.pipeline as R
    import alink_tpu_torch.pipeline as P

    for fit_pl, load_pl, fit_pkg, load_pkg in (
            (R, P, "alink_tpu", "alink_tpu_torch"),
            (P, R, "alink_tpu_torch", "alink_tpu")):
        path = str(tmp_path / f"{fit_pkg}.ak")
        model = _iris_pipeline(fit_pl).fit(_iris_source(fit_pkg))
        want = model.transform(_iris_source(fit_pkg)).collect()
        model.save(path)
        loaded = load_pl.PipelineModel.load(path)
        assert [type(s).__name__ for s in loaded.stages] == \
            ["KMeansModel", "LinearModel", "DecisionTreeModel"]
        got = loaded.transform(_iris_source(load_pkg)).collect()
        assert got.names == want.names
        for col in ("cluster", "sp", "tree", "species"):
            np.testing.assert_array_equal(got.col(col), want.col(col))
        # the same weights; the products behind the probabilities are
        # summed in another order
        detail = [[json.loads(d) for d in t.col("spd")] for t in (got, want)]
        assert [sorted(d) for d in detail[0]] == \
            [sorted(d) for d in detail[1]]
        np.testing.assert_allclose(
            [[d[k] for k in sorted(d)] for d in detail[0]],
            [[d[k] for k in sorted(d)] for d in detail[1]], rtol=0,
            atol=1e-6)


def _feature_source(pkg, cols):
    import importlib

    ops = importlib.import_module(pkg + ".operator.batch")
    mt = importlib.import_module(pkg + ".common.mtable")
    return ops.TableSourceBatchOp(mt.MTable(dict(cols)))


def _gmm_outputs(table):
    post = np.asarray([list(json.loads(s).values())
                       for s in table.col("posterior")])
    pca = np.stack([v.data for v in table.col("pca")])
    return np.asarray(table.col("component")), post, pca


def _decided_equal(got, want):
    """Components equal on every row whose top-two posterior gap exceeds
    chip_smoke.GMM_POSTERIOR_GAP (phase 19.1's rule), posteriors within
    1e-4, the PCA rows within 1e-5 of the largest (float32 projection in
    the reference, float64 in the port)."""
    (c, p, x), (wc, wp, wx) = _gmm_outputs(got), _gmm_outputs(want)
    top2 = np.sort(wp, axis=1)[:, -2:]
    decided = top2[:, 1] - top2[:, 0] > chip_smoke.GMM_POSTERIOR_GAP
    assert decided.mean() > 0.9
    np.testing.assert_array_equal(c[decided], wc[decided])
    np.testing.assert_allclose(p, wp, rtol=0, atol=1e-4)
    np.testing.assert_allclose(x, wx, rtol=0, atol=1e-5 * np.abs(wx).max())


def test_feature_pipeline_matches_reference_and_crosses(tmp_path):
    """chip_smoke.py phase 19.1's pipeline (StringIndexer → OneHotEncoder →
    StandardScaler → VectorAssembler → PCA → GaussianMixture) at 2,000
    seeded Covertype-layout rows: both packages' fits transform 400
    held-out rows alike, and each package's saved PipelineModel loads in
    the other and transforms as it did where it was fitted."""
    import alink_tpu.pipeline as R
    import alink_tpu_torch.pipeline as P

    X, _ = chip_smoke.covertype_data(2_400, 0)
    train = chip_smoke.covertype_categorical(X[:2_000])
    test = chip_smoke.covertype_categorical(X[2_000:])
    out = {}
    for pl, pkg in ((R, "alink_tpu"), (P, "alink_tpu_torch")):
        model = chip_smoke.feature_pipeline(pl, **chip_smoke.FEATURE_GMM) \
            .fit(_feature_source(pkg, train))
        path = str(tmp_path / f"{pkg}.ak")
        model.save(path)
        out[pkg] = (model.transform(_feature_source(pkg, test)).collect(),
                    path)
    (ref, ref_path), (port, port_path) = out["alink_tpu"], \
        out["alink_tpu_torch"]
    assert port.names == ref.names and str(port.schema) == str(ref.schema)
    _decided_equal(port, ref)
    for load_pl, pkg, path, want in ((P, "alink_tpu_torch", ref_path, ref),
                                     (R, "alink_tpu", port_path, port)):
        loaded = load_pl.PipelineModel.load(path)
        assert [type(s).__name__ for s in loaded.stages] == [
            "StringIndexerModel", "OneHotEncoderModel",
            "StandardScalerModel", "VectorAssembler", "PCAModel",
            "GaussianMixtureModel"]
        _decided_equal(loaded.transform(_feature_source(pkg, test))
                       .collect(), want)


def test_local_predictor_cached_plan_equals_rebuild(tmp_path):
    import alink_tpu_torch.pipeline as P

    model = _iris_pipeline(P).fit(_iris_source("alink_tpu_torch"))
    path = str(tmp_path / "m.ak")
    model.save(path)
    table = _iris_source("alink_tpu_torch").collect()
    cached = P.LocalPredictor(path, chip_smoke.IRIS_SCHEMA)
    rebuilt = P.LocalPredictor(P.PipelineModel.load(path),
                               chip_smoke.IRIS_SCHEMA, cache_plan=False)
    a, b = cached.predict_table(table), rebuilt.predict_table(table)
    assert a.to_rows() == b.to_rows()
    assert a.to_rows() == model.transform(table).collect().to_rows()
    rows = table.to_rows()
    for i in (0, 57, 149, 3):
        assert cached.predict_row(rows[i]) == rebuilt.predict_row(rows[i]) \
            == a.get_row(i)
    assert str(cached.get_output_schema()) == str(a.schema)


def test_csv_source_matches_reference_without_pandas(monkeypatch):
    from alink_tpu.operator.batch import CsvSourceBatchOp as RCsv
    from alink_tpu_torch.operator.batch import CsvSourceBatchOp as PCsv

    cases = ((IRIS, chip_smoke.IRIS_SCHEMA), (DIGITS, DIGITS_SCHEMA))
    refs = [RCsv(filePath=p, schemaStr=s).collect() for p, s in cases]
    monkeypatch.setitem(sys.modules, "pandas", None)
    with pytest.raises(ImportError):
        import pandas  # noqa: F401
    for (path, schema), ref in zip(cases, refs):
        got = PCsv(filePath=path, schemaStr=schema).collect()
        assert str(got.schema) == str(ref.schema)
        assert got.num_rows == ref.num_rows
        for name in ref.names:
            assert got.col(name).dtype == ref.col(name).dtype, name
            np.testing.assert_array_equal(got.col(name), ref.col(name))


def test_mem_source_matches_reference():
    from alink_tpu.operator.batch import MemSourceBatchOp as RMem
    from alink_tpu_torch.operator.batch import MemSourceBatchOp as PMem

    rows = [(1, "a", 0.5), (2, "b", 1.5), (3, "c", -2.0)]
    schema = "id long, name string, score double"
    ref, port = RMem(rows, schema), PMem(rows, schema)
    assert str(port.schema) == str(ref.schema)
    assert port.collect().to_rows() == ref.collect().to_rows()


def test_csv_source_header_quotes_and_blank_lines(tmp_path):
    """ignoreFirstLine, a quoted field holding the delimiter, spaces after
    delimiters, blank lines and a vector column."""
    from alink_tpu_torch.common.linalg import DenseVector
    from alink_tpu_torch.operator.batch import CsvSourceBatchOp

    path = tmp_path / "t.csv"
    path.write_text('id,name,score,vec\n1, "a, b",0.5,"1 2"\n\n'
                    '2,c, 1.5,"3 4"\n')
    t = CsvSourceBatchOp(filePath=str(path), ignoreFirstLine=True,
                         schemaStr="id long, name string, score double, "
                                   "vec dense_vector").collect()
    assert t.col("id").tolist() == [1, 2]
    assert t.col("name").tolist() == ["a, b", "c"]
    assert t.col("score").tolist() == [0.5, 1.5]
    assert t.col("vec")[1] == DenseVector([3.0, 4.0])
    path.write_text("1,2\n3\n")
    with pytest.raises(Exception, match="row 1 has 1 fields"):
        CsvSourceBatchOp(filePath=str(path),
                         schemaStr="a long, b long").collect()


def _bench_figures(pkg):
    """bench.py's BASELINE #1 purity and #2 digits holdout accuracy."""
    import importlib

    ops = importlib.import_module(pkg + ".operator.batch")
    pl = importlib.import_module(pkg + ".pipeline")
    src = _iris_source(pkg)
    out = pl.Pipeline(pl.KMeans(
        k=3, maxIter=50, featureCols=chip_smoke.IRIS_FEATURES,
        predictionCol="pred")).fit(src).transform(src).collect()
    purity = chip_smoke.purity(out.col("pred"), out.col("species"))
    digits = ops.CsvSourceBatchOp(filePath=DIGITS,
                                  schemaStr=DIGITS_SCHEMA).collect()
    tr, te = digits.shuffle(seed=0).split_at(int(digits.num_rows * 0.8))
    model = ops.SoftmaxTrainBatchOp(featureCols=DIGIT_COLS, labelCol="label",
                                    maxIter=60).link_from(
        ops.TableSourceBatchOp(tr))
    pred = ops.SoftmaxPredictBatchOp().link_from(
        model, ops.TableSourceBatchOp(te)).collect()
    acc = float(np.mean(np.asarray(pred.col("pred"))
                        == np.asarray(te.col("label"))))
    return purity, acc


def test_reference_figures_are_the_constants_chip_smoke_cites():
    """The reference's iris purity and digits holdout accuracy, measured
    here, are chip_smoke's IRIS_REFERENCE_PURITY and DIGITS_REFERENCE_ACC;
    the port's CPU route reaches the same."""
    ref = _bench_figures("alink_tpu")
    assert ref == (chip_smoke.IRIS_REFERENCE_PURITY,
                   chip_smoke.DIGITS_REFERENCE_ACC)
    assert _bench_figures("alink_tpu_torch") == ref


def test_port_stages_are_reference_stages():
    """Every stage class of the port is registered under a reference class
    name with the same parameters, so saved pipeline models cross."""
    import alink_tpu.pipeline as R
    import alink_tpu_torch.pipeline as P
    from alink_tpu.pipeline.base import STAGE_REGISTRY as REF
    from alink_tpu_torch.pipeline.base import STAGE_REGISTRY as PORT

    stages = [n for n in P.__all__ if n in PORT]
    assert sum(issubclass(PORT[n], (P.EstimatorBase, P.ModelBase))
               and PORT[n] not in (P.EstimatorBase, P.ModelBase)
               for n in stages) == 115
    for name in stages:
        assert name in REF, name
        assert set(getattr(P, name).param_infos()) <= \
            set(getattr(R, name).param_infos()), name


def _stage_cases():
    from alink_tpu_torch import pipeline as P
    from alink_tpu_torch.operator import batch as B

    feats = ["a", "b", "c"]
    tree = dict(featureCols=feats, labelCol="label", maxDepth=2)
    return {
        "DecisionTreeClassifier": (P.DecisionTreeClassifier, tree,
                                   B.DecisionTreeTrainBatchOp,
                                   B.DecisionTreePredictBatchOp),
        "RandomForestClassifier": (P.RandomForestClassifier,
                                   dict(tree, numTrees=3),
                                   B.RandomForestTrainBatchOp,
                                   B.RandomForestPredictBatchOp),
        "GbdtClassifier": (P.GbdtClassifier, dict(tree, numTrees=3),
                           B.GbdtTrainBatchOp, B.GbdtPredictBatchOp),
        "GbdtRegressor": (P.GbdtRegressor, dict(tree, numTrees=3,
                                                labelCol="y"),
                          B.GbdtRegTrainBatchOp, B.GbdtRegPredictBatchOp),
        "LinearSvm": (P.LinearSvm, dict(featureCols=feats, labelCol="label"),
                      B.LinearSvmTrainBatchOp, B.LinearSvmPredictBatchOp),
        "LinearSvr": (P.LinearSvr, dict(featureCols=feats, labelCol="y"),
                      B.LinearSvrTrainBatchOp, B.LinearSvrPredictBatchOp),
        "Ridge": (P.Ridge, dict(featureCols=feats, labelCol="y"),
                  B.RidgeRegTrainBatchOp, B.RidgeRegPredictBatchOp),
        "Lasso": (P.Lasso, dict(featureCols=feats, labelCol="y"),
                  B.LassoRegTrainBatchOp, B.LassoRegPredictBatchOp),
        "LinearRegression": (P.LinearRegression,
                             dict(featureCols=feats, labelCol="y"),
                             B.LinearRegTrainBatchOp,
                             B.LinearRegPredictBatchOp),
        "LogisticRegression": (P.LogisticRegression,
                               dict(featureCols=feats, labelCol="label"),
                               B.LogisticRegressionTrainBatchOp,
                               B.LogisticRegressionPredictBatchOp),
        "Word2Vec": (P.Word2Vec, dict(selectedCol="doc", vectorSize=4,
                                      numIter=1),
                     B.Word2VecTrainBatchOp, B.Word2VecPredictBatchOp),
        "GaussianMixture": (P.GaussianMixture, dict(featureCols=feats, k=2,
                                                    maxIter=5),
                            B.GmmTrainBatchOp, B.GmmPredictBatchOp),
        "BisectingKMeans": (P.BisectingKMeans, dict(featureCols=feats, k=3),
                            B.BisectingKMeansTrainBatchOp,
                            B.BisectingKMeansPredictBatchOp),
        "Lda": (P.Lda, dict(selectedCol="doc", topicNum=2, numIter=2),
                B.LdaTrainBatchOp, B.LdaPredictBatchOp),
    }


@pytest.mark.parametrize("name", sorted(_stage_cases()))
def test_stage_fits_through_pipeline_as_its_operator(name):
    from alink_tpu_torch.common.mtable import MTable
    from alink_tpu_torch.operator.batch import TableSourceBatchOp
    from alink_tpu_torch.pipeline import Pipeline

    stage_cls, kw, train_cls, predict_cls = _stage_cases()[name]
    rng = np.random.default_rng(0)
    X = rng.random((80, 3))
    words = np.asarray(["x", "y", "z", "w"])
    src = TableSourceBatchOp(MTable({
        "a": X[:, 0], "b": X[:, 1], "c": X[:, 2],
        "label": (X[:, 0] + X[:, 1] > 1).astype(np.int64),
        "y": X @ np.array([1.0, -2.0, 0.5]),
        "doc": np.asarray([" ".join(rng.choice(words, 5)) for _ in range(80)],
                          object)}))
    got = Pipeline(stage_cls(predictionCol="out", **kw)).fit(src) \
        .transform(src).collect()
    model = train_cls(**kw).link_from(src)
    want = predict_cls(predictionCol="out", **kw).link_from(
        model, src).collect()
    assert got.names == want.names
    out_got, out_want = got.col("out"), want.col("out")
    if out_got.dtype == object:
        assert [str(v) for v in out_got] == [str(v) for v in out_want]
    else:
        np.testing.assert_array_equal(out_got, out_want)


def _slice_stage_cases():
    """The ten stages of the feature3, feature4 and NLP families: each
    fitted through a ``Pipeline`` in both packages."""
    return {
        "MultiHotEncoder": ("MultiHotEncoder", dict(selectedCols=["tags"],
                                                    outputCol="out")),
        "TargetEncoder": ("TargetEncoder", dict(selectedCols=["cat"],
                                                labelCol="label",
                                                outputCols=["out"])),
        "MultiStringIndexer": ("MultiStringIndexer",
                               dict(selectedCols=["cat", "cat2"],
                                    outputCols=["o1", "o2"])),
        "Binarizer": ("Binarizer", dict(selectedCol="a", threshold=0.5,
                                        outputCol="out")),
        "Bucketizer": ("Bucketizer", dict(selectedCols=["a", "b"],
                                          cutsArray=[[0.3, 0.6], [0.5]],
                                          outputCols=["o1", "o2"])),
        "CrossFeature": ("CrossFeature", dict(selectedCols=["cat", "cat2"],
                                              outputCol="out")),
        "WoeEncoder": ("WoeEncoder", dict(selectedCols=["cat"],
                                          labelCol="label")),
        "NaiveBayesTextClassifier": (
            "NaiveBayesTextClassifier",
            dict(vectorCol="vec", labelCol="label", predictionCol="out",
                 predictionDetailCol="detail")),
        "Tokenizer": ("Tokenizer", dict(selectedCol="doc", outputCol="out")),
        "RegexTokenizer": ("RegexTokenizer", dict(
            selectedCol="doc", outputCol="out", pattern="[a-z]+",
            gaps=False)),
    }


@pytest.mark.parametrize("name", sorted(_slice_stage_cases()))
def test_slice_stage_matches_reference(name):
    """The stage's fitted pipeline transforms the seeded table as the
    reference's does (tables equal); the saved model crosses."""
    import importlib

    from torch_table_parity import reference_session, remove_session, \
        same_table

    stage, kw = _slice_stage_cases()[name]
    rng = np.random.default_rng(0)
    n = 60
    X = rng.random((n, 2))
    words = np.asarray(["Ab", "cd", "ef", "GH", "x"])
    cols = {
        "a": X[:, 0], "b": X[:, 1],
        "cat": np.asarray(rng.choice(["p", "q", "r"], n), object),
        "cat2": np.asarray(rng.choice(["u", "v"], n), object),
        "tags": np.asarray([",".join(rng.choice(["t1", "t2", "t3"], 2))
                            for _ in range(n)], object),
        "doc": np.asarray([" ".join(rng.choice(words, 4)) + " !"
                           for _ in range(n)], object),
        "vec": np.asarray([f"$6${int(i)}:{int(c)} {int(j)}:1"
                           for i, j, c in zip(rng.integers(0, 3, n),
                                              rng.integers(3, 6, n),
                                              rng.integers(1, 4, n))],
                          object),
        "label": (X[:, 0] > 0.5).astype(np.int64)}
    sid = reference_session()
    try:
        out = []
        for pkg, extra in (("alink_tpu", dict(MLEnvironmentId=sid)),
                           ("alink_tpu_torch", {})):
            ops = importlib.import_module(pkg + ".operator.batch")
            pl = importlib.import_module(pkg + ".pipeline")
            stages = importlib.import_module(pkg + ".pipeline.estimators")
            T = importlib.import_module(pkg + ".common.mtable")
            schema = T.TableSchema(
                list(cols), [T.AlinkTypes.SPARSE_VECTOR if c == "vec" else
                             T.MTable(dict(cols)).schema.type_of(c)
                             for c in cols])
            src = ops.TableSourceBatchOp(T.MTable(dict(cols), schema))
            model = pl.Pipeline(getattr(stages, stage)(**kw, **extra)) \
                .fit(src)
            out.append(model.transform(src).collect())
    finally:
        remove_session(sid)
    same_table(out[1], out[0])


def test_als_stage_matches_reference(tmp_path):
    """ALS through Pipeline: fit, transform, save, load — the port against
    the reference (predictions within 2e-4: the port's Gramians sum in
    float64, the reference's in float32), and the port's saved model loaded
    back."""
    from torch_table_parity import reference_session, remove_session

    import alink_tpu.pipeline as RP
    import alink_tpu_torch.pipeline as PP
    from alink_tpu.common.mtable import MTable as RT
    from alink_tpu_torch.common.mtable import MTable as PT

    rng = np.random.RandomState(4)
    U, V = rng.randn(15, 3) / np.sqrt(3), rng.randn(10, 3) / np.sqrt(3)
    us, is_ = np.nonzero(rng.rand(15, 10) < 0.6)
    cols = {"user": us.astype(np.int64), "item": is_.astype(np.int64),
            "rating": (U @ V.T)[us, is_]}
    sid = reference_session()
    kw = dict(userCol="user", itemCol="item", rateCol="rating", rank=3,
              numIter=20, predictionCol="p", **{"lambda": 0.01})
    try:
        ref = RP.Pipeline(RP.ALS(**kw, MLEnvironmentId=sid)).fit(
            RT(dict(cols)))
        r = np.asarray(ref.transform(RT(dict(cols))).collect().col("p"))
    finally:
        remove_session(sid)
    port = PP.Pipeline(PP.ALS(**kw)).fit(PT(dict(cols)))
    p = np.asarray(port.transform(PT(dict(cols))).collect().col("p"))
    np.testing.assert_allclose(p, r, atol=2e-4)
    assert np.sqrt(np.mean((p - cols["rating"]) ** 2)) < 0.15
    path = str(tmp_path / "als.ak")
    port.save(path)
    again = PP.PipelineModel.load(path).transform(PT(dict(cols))).collect()
    np.testing.assert_array_equal(np.asarray(again.col("p")), p)


def test_sparse_feature_indexer_stage_matches_reference():
    """The stage's fitted pipeline indexes the seeded strings as the
    reference's does (tables equal)."""
    from torch_table_parity import same_table

    import alink_tpu.pipeline as RP
    import alink_tpu_torch.pipeline as PP
    from alink_tpu.common.mtable import MTable as RT
    from alink_tpu_torch.common.mtable import MTable as PT

    sf = {"f": np.asarray(["a:1,b:2", "b:3,c:1", "c:4"], object)}
    outs = []
    for P, T in ((RP, RT), (PP, PT)):
        est = P.estimators.SparseFeatureIndexer(selectedCol="f",
                                                outputCol="v")
        outs.append(P.Pipeline(est).fit(T(dict(sf))).transform(
            T(dict(sf))).collect())
    same_table(outs[1], outs[0])
