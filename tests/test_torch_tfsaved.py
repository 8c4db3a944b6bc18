"""The port's TF SavedModel ingest (``onnx/tfsaved.py``, the SavedModel
predict ops) held against ``alink_tpu`` and TensorFlow itself on the CPU.
TensorFlow is needed at load time only, imported inside ``_require_tf``.

The MLP and CNN SavedModels of tests/test_tfsaved.py, built once a module:
the port's output within ATOL = 1e-5 (MLP) and 1e-4 (CNN, the reference
test's own tolerances) of both the reference's and TF's; the batch and
stream ops on DenseVector rows equal to the served function; the bfloat16
policy within the reference test's 0.03 of fp32 and moved off it; the op
manifest equal to the reference's; an unsupported op raising the same class
in both packages.
"""

import numpy as np
import pytest

tf = pytest.importorskip("tensorflow")

import torch  # noqa: E402

MLP_ATOL = 1e-5
CNN_ATOL = 1e-4
BF16_ATOL = 0.03


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("ALINK_TORCH_DEVICE", "cpu")


@pytest.fixture(scope="module")
def mlp_path(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("sm") / "mlp")
    inp = tf.keras.Input(shape=(4,), name="features")
    x = tf.keras.layers.Dense(8, activation="relu")(inp)
    out = tf.keras.layers.Dense(3, activation="softmax")(x)
    tf.saved_model.save(tf.keras.Model(inp, out), d)
    return d


@pytest.fixture(scope="module")
def cnn_path(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("sm") / "cnn")
    inp = tf.keras.Input(shape=(8, 8, 3))
    x = tf.keras.layers.Conv2D(4, 3, padding="same", activation="relu")(inp)
    x = tf.keras.layers.BatchNormalization()(x)
    x = tf.keras.layers.MaxPooling2D()(x)
    x = tf.keras.layers.Conv2D(4, 3, strides=2, padding="same")(x)
    x = tf.keras.layers.AveragePooling2D(3, strides=1, padding="same")(x)
    x = tf.keras.layers.GlobalAveragePooling2D()(x)
    out = tf.keras.layers.Dense(2)(x)
    tf.saved_model.save(tf.keras.Model(inp, out), d)
    return d


def _tf_ref(path, x):
    sig = tf.saved_model.load(path).signatures["serving_default"]
    return list(sig(tf.constant(x)).values())[0].numpy()


@pytest.mark.parametrize("which,atol", [("mlp", MLP_ATOL),
                                        ("cnn", CNN_ATOL)])
def test_savedmodel_matches_reference_and_tf(request, which, atol):
    from alink_tpu.onnx.tfsaved import load_saved_model_fn as ref_load
    from alink_tpu_torch.onnx import load_saved_model_fn

    path = request.getfixturevalue(f"{which}_path")
    shape = (6, 4) if which == "mlp" else (3, 8, 8, 3)
    x = np.random.default_rng(0).random(shape, dtype=np.float32)
    fn, in_names, out_info = load_saved_model_fn(path)
    rfn, r_in, r_out = ref_load(path)
    assert (in_names, out_info) == (r_in, r_out)
    got = fn(x)[0].numpy()
    np.testing.assert_allclose(got, np.asarray(rfn(x)[0]), atol=atol)
    np.testing.assert_allclose(got, _tf_ref(path, x), atol=atol)


def test_savedmodel_ops_batch_and_stream(mlp_path):
    from alink_tpu_torch.common.linalg import DenseVector
    from alink_tpu_torch.common.mtable import MTable
    from alink_tpu_torch.onnx import load_saved_model_fn
    from alink_tpu_torch.operator.batch import (TableSourceBatchOp,
                                                TFSavedModelPredictBatchOp)
    from alink_tpu_torch.operator.stream import (TableSourceStreamOp,
                                                 TFSavedModelPredictStreamOp)

    rng = np.random.default_rng(2)
    vecs = [DenseVector(rng.random(4)) for _ in range(7)]
    t = MTable.from_rows([(v,) for v in vecs], "features DENSE_VECTOR")
    kw = dict(modelPath=mlp_path, selectedCols=["features"],
              outputCols=["probs"], predictBatchSize=4)
    op = TFSavedModelPredictBatchOp(**kw).link_from(TableSourceBatchOp(t))
    assert op.schema.names[-1] == "probs"
    batch = np.stack(list(op.collect().col("probs")))
    stream = np.stack(list(TFSavedModelPredictStreamOp(**kw).link_from(
        TableSourceStreamOp(t, chunkSize=3)).collect().col("probs")))
    x = np.stack([np.asarray(v.data, np.float32) for v in vecs])
    want = load_saved_model_fn(mlp_path)[0](x)[0].numpy()
    np.testing.assert_array_equal(batch, want)
    np.testing.assert_array_equal(stream, want)


def test_savedmodel_bfloat16_policy(mlp_path):
    from alink_tpu_torch.onnx import load_saved_model_fn

    x = np.random.default_rng(4).random((6, 4), dtype=np.float32)
    o32 = load_saved_model_fn(mlp_path)[0](x)[0]
    o16 = load_saved_model_fn(mlp_path, dtype="bfloat16")[0](x)[0]
    assert o16.dtype == torch.float32
    np.testing.assert_allclose(o16.numpy(), o32.numpy(), atol=BF16_ATOL)
    assert not torch.equal(o16, o32)


def test_manifest_and_unsupported_op(tmp_path):
    from alink_tpu.onnx import supported_tf_ops as ref_ops
    from alink_tpu.onnx.tfsaved import load_saved_model_fn as ref_load
    from alink_tpu_torch.onnx import load_saved_model_fn, supported_tf_ops

    assert supported_tf_ops() == ref_ops()

    class Odd(tf.Module):
        @tf.function(input_signature=[tf.TensorSpec([None, 3], tf.float32)])
        def __call__(self, x):
            return tf.raw_ops.Cumsum(x=x, axis=tf.constant(1))

    d = str(tmp_path / "odd")
    tf.saved_model.save(Odd(), d)
    names = []
    for load in (ref_load, load_saved_model_fn):
        with pytest.raises(Exception, match="Cumsum") as e:
            load(d)
        names.append(type(e.value).__name__)
    assert names == ["AkUnsupportedOperationException"] * 2
