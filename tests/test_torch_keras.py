"""The KerasSequential family of the port (``dl/modules.py``
``KerasSequential``, ``dl/convert.py``'s Keras carry, model state in
``dl/train.py``, the ops in ``operator/batch/dl.py``) held against
``alink_tpu`` on the CPU.

- ``parse_layers`` gives the reference's parse.
- Every layer kind's forward from the reference's ``init`` weights carried
  across, fp32, within FWD_ATOL = 1e-5 (measured gaps are ~3e-8: the two
  frameworks sum the products in other orders); BatchNorm in training mode,
  its output and its updated running statistics within the same atol.
- ``train_model`` on the reference's three KerasSequential op recipes
  (tests/test_dl.py: the xor classifier, the regressor, the BatchNorm
  classifier) with sgd and dropout 0 from one flax init: the loss history
  within TRAIN_ATOL = 1e-5 of the reference's (as tests/test_torch_train.py
  holds BERT), and the final parameters and running statistics too.
- The three op recipes through the port's own ops, at the reference tests'
  accuracy and MSE floors.
- Model tables that load across both packages in both directions: the same
  predictions, probabilities within 1e-6.
"""

import json

import numpy as np
import pytest

import jax

FWD_ATOL = 1e-5
TRAIN_ATOL = 1e-5


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("ALINK_TORCH_DEVICE", "cpu")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The models are tiny: one intra-op thread beats a pool that contends
    with the other test workers' pools."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_parse_layers_matches_reference():
    from alink_tpu.dl.modules import parse_layers as ref
    from alink_tpu_torch.dl.modules import parse_layers

    specs = ["Dense(64)", "dense(8, activation=relu)", "Relu()", "Dropout",
             "Dropout(0.25)", "BatchNormalization()", "Conv1D(4, 5, strides=2)",
             "LSTM(16, return_sequences=True)", "Reshape(4, 'x')", "GRU(3)"]
    assert parse_layers(specs) == ref(specs)
    from alink_tpu_torch.common.exceptions import AkIllegalArgumentException

    with pytest.raises(AkIllegalArgumentException):
        parse_layers(["Dense(4"])


# every layer kind, in stacks that feed each its input rank
LAYER_CASES = {
    "dense_activations": (6, ["Dense(8, activation=relu)",
                              "Dense(8, activation=sigmoid)",
                              "Dense(8, activation=tanh)",
                              "Dense(8, activation=gelu)",
                              "Dense(8, activation=elu)",
                              "Dense(8, activation=softmax)"]),
    "activation_layers": (6, ["Dense(8)", "Relu()", "Dense(8)", "Sigmoid()",
                              "Dense(8)", "Tanh()", "Dense(8)", "Gelu()",
                              "Dense(8)", "Elu()", "Dense(8)", "Softmax()"]),
    "dropout_norms": (6, ["Dense(8)", "Dropout(0.3)", "BatchNorm()",
                          "LayerNorm()", "Dropout()"]),
    "conv_pool": (12, ["Reshape(6, 2)", "Conv1D(4, 3, activation=relu)",
                       "Conv1D(5, 2, strides=2)", "MaxPool1D(2)", "Flatten()"]),
    "conv_global_pool": (20, ["Reshape(10, 2)", "Conv1D(3, 4, strides=3)",
                              "GlobalAvgPool1D()"]),
    "lstm": (12, ["Reshape(4, 3)", "LSTM(5, return_sequences=true)",
                  "LSTM(4)"]),
    "gru": (12, ["Reshape(6, 2)", "GRU(5, return_sequences=true)",
                 "BatchNormalization()", "GRU(3)"]),
    "flatten_reshape": (12, ["Reshape(3, 4)", "Flatten()", "Reshape(2, 6)",
                             "LayerNormalization()", "Flatten()"]),
}


def _models(specs, d, out_dim=3, seed=1):
    from alink_tpu.dl.modules import KerasSequential as Ref
    from alink_tpu_torch.dl.convert import keras_flax_to_torch
    from alink_tpu_torch.dl.modules import KerasSequential

    ref = Ref(tuple(specs), out_dim=out_dim)
    x = np.random.default_rng(seed).normal(0, 1, (9, d)).astype(np.float32)
    v = jax.tree_util.tree_map(np.asarray,
                               ref.init(jax.random.PRNGKey(seed), x[:1]))
    rng = np.random.default_rng(seed + 1)
    for stats in v.get("batch_stats", {}).values():   # non-trivial stats
        stats["mean"] = rng.normal(0, 0.3, stats["mean"].shape).astype(
            np.float32)
        stats["var"] = rng.uniform(0.5, 2.0, stats["var"].shape).astype(
            np.float32)
    port = KerasSequential(specs, out_dim, d)
    port.load_state_dict(keras_flax_to_torch(v))
    return ref, v, port, x


@pytest.mark.parametrize("case", sorted(LAYER_CASES))
def test_layer_forward_matches_reference(case):
    import torch

    from alink_tpu_torch.dl.convert import keras_torch_to_flax

    d, specs = LAYER_CASES[case]
    ref, v, port, x = _models(specs, d)
    want = np.asarray(ref.apply(v, x))
    got = port(torch.from_numpy(x)).detach().numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=FWD_ATOL, rtol=0)
    back = keras_torch_to_flax(port.state_dict())
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(v)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(v)):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("case", ["dropout_norms", "gru"])
def test_batchnorm_training_mode_matches_reference(case):
    """Training mode, dropout 0: normalized by the batch's statistics (the
    biased variance, over every axis but the last), running mean and var
    moved with momentum 0.99."""
    import torch

    d, specs = LAYER_CASES[case]
    specs = [s.replace("Dropout(0.3)", "Dropout(0.0)").replace(
        "Dropout()", "Dropout(0.0)") for s in specs]
    ref, v, port, x = _models(specs, d)
    want, upd = ref.apply(v, x, deterministic=False,
                          mutable=["batch_stats"])
    got = port(torch.from_numpy(x), deterministic=False).detach().numpy()
    np.testing.assert_allclose(got, np.asarray(want), atol=FWD_ATOL, rtol=0)
    state = port.state_dict()
    for name, stats in upd["batch_stats"].items():
        for k in ("mean", "var"):
            np.testing.assert_allclose(state[f"{name}.{k}"].numpy(),
                                       np.asarray(stats[k]), atol=FWD_ATOL,
                                       rtol=0)


def test_unknown_layer_and_activation_raise():
    from alink_tpu_torch.common.exceptions import AkIllegalArgumentException
    from alink_tpu_torch.dl.modules import KerasSequential

    with pytest.raises(AkIllegalArgumentException, match="unknown layer"):
        KerasSequential(["Dense(4)", "Attention()"], 2, 3)
    with pytest.raises(AkIllegalArgumentException, match="activation"):
        KerasSequential(["Dense(4, activation=swish)"], 2, 3)


# ---------------------------------------------------------------------------
# training: the reference's three op recipes
# ---------------------------------------------------------------------------


def _xor(n=400, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.rand(n, 2).astype(np.float64)
    y = ((X[:, 0] > 0.5) ^ (X[:, 1] > 0.5)).astype(np.int64)
    return X, y


def _linear(n=300, seed=2):
    rng = np.random.RandomState(seed)
    X = rng.rand(n, 3).astype(np.float64)
    return X, X @ np.array([1.0, -2.0, 0.5]) + 0.3


RECIPES = {  # tests/test_dl.py's op tests: layers, data, op settings
    "classifier": (["Dense(32)", "Relu()", "Dense(16)", "Relu()"], _xor,
                   dict(numEpochs=150, batchSize=64, learningRate=1e-2)),
    "regressor": (["Dense(32)", "Relu()"], _linear,
                  dict(numEpochs=80, batchSize=64, learningRate=5e-3)),
    "batchnorm": (["Dense(32)", "BatchNorm()", "Relu()", "Dense(16)",
                   "Relu()"], lambda: _xor(300, seed=7),
                  dict(numEpochs=150, batchSize=64, learningRate=1e-2)),
}


@pytest.mark.parametrize("recipe", sorted(RECIPES))
def test_train_model_matches_reference_sgd(recipe):
    """sgd, dropout 0, 6 epochs from one flax init with a 0.2 eval split:
    the loss and eval histories, the final parameters and (with BatchNorm)
    the running statistics within TRAIN_ATOL."""
    from alink_tpu.dl.modules import KerasSequential as Ref
    from alink_tpu.dl.train import TrainConfig as RefConfig
    from alink_tpu.dl.train import train_model as ref_train
    from alink_tpu.parallel.mesh import default_mesh
    from alink_tpu_torch.dl.convert import keras_torch_to_flax
    from alink_tpu_torch.dl.modules import KerasSequential
    from alink_tpu_torch.dl.train import TrainConfig, train_model

    layers, data, _ = RECIPES[recipe]
    X, y = data()
    X = X.astype(np.float32)
    regression = recipe == "regressor"
    y = y.astype(np.float32 if regression else np.int32)
    out_dim = 1 if regression else 2
    ref = Ref(tuple(layers), out_dim=out_dim)
    init = jax.tree_util.tree_map(
        np.asarray, ref.init(jax.random.PRNGKey(3), X[:1]))
    kw = dict(num_epochs=6, batch_size=64, learning_rate=1e-2,
              optimizer="sgd", eval_ratio=0.2, seed=4)
    want_p, want = ref_train(ref, {"x": X}, y, RefConfig(**kw),
                             regression=regression, init_params=init,
                             seq_axis=None,
                             mesh=default_mesh(jax.devices()[:1]))
    state, hist = train_model(KerasSequential(layers, out_dim, 2 if
                                              recipe != "regressor" else 3),
                              {"x": X}, y, TrainConfig(feed="sync", **kw),
                              regression=regression, init_params=init)
    for key in ("loss", "eval_metric"):
        np.testing.assert_allclose(hist[key], want[key], atol=TRAIN_ATOL,
                                   rtol=0)
    got_p = keras_torch_to_flax(state)
    want_p = jax.tree_util.tree_map(np.asarray, want_p)
    assert set(got_p) == set(want_p) == (
        {"params", "batch_stats"} if recipe == "batchnorm" else {"params"})
    for a, b in zip(jax.tree_util.tree_leaves(got_p),
                    jax.tree_util.tree_leaves(want_p)):
        np.testing.assert_allclose(a, b, atol=TRAIN_ATOL, rtol=0)


def test_accumulation_refuses_model_state():
    from alink_tpu_torch.common.exceptions import AkIllegalArgumentException
    from alink_tpu_torch.dl.modules import KerasSequential
    from alink_tpu_torch.dl.train import TrainConfig, train_model

    X, y = _xor(64)
    with pytest.raises(AkIllegalArgumentException, match="params-only"):
        train_model(KerasSequential(["Dense(4)", "BatchNorm()"], 2, 2),
                    {"x": X.astype(np.float32)}, y.astype(np.int32),
                    TrainConfig(num_epochs=1, batch_size=16, accum_steps=2))


def _table(pkg, X, y, names):
    import importlib

    mt = importlib.import_module(pkg + ".common.mtable")
    cols = {n: X[:, i] for i, n in enumerate(names)}
    cols["label"] = y
    return mt.MTable(cols)


def _op_run(pkg, recipe, train_pkg=None, epochs=None):
    """Train ``recipe`` through ``train_pkg``'s op (default ``pkg``; for
    ``epochs`` if given), predict through ``pkg``'s op on the training
    rows."""
    import importlib

    layers, data, settings = RECIPES[recipe]
    if epochs:
        settings = dict(settings, numEpochs=epochs)
    X, y = data()
    names = ["a", "b", "c"][:X.shape[1]] if recipe == "regressor" \
        else ["f0", "f1"]
    kind = "Regressor" if recipe == "regressor" else "Classifier"
    T = importlib.import_module((train_pkg or pkg) + ".operator.batch")
    model = getattr(T, f"KerasSequential{kind}TrainBatchOp")(
        layers=layers, labelCol="label", **settings).link_from(
        T.TableSourceBatchOp(_table(train_pkg or pkg, X, y, names))).collect()
    B = importlib.import_module(pkg + ".operator.batch")
    if train_pkg and train_pkg != pkg:
        mt = importlib.import_module(pkg + ".common.mtable")
        model = mt.MTable({n: model.col(n) for n in model.schema.names},
                          mt.TableSchema(model.schema.names,
                                         model.schema.types))
    extra = {"predictionDetailCol": "pd"} if kind == "Classifier" else {}
    pred = getattr(B, f"KerasSequential{kind}PredictBatchOp")(
        predictionCol="p", **extra).link_from(
        B.TableSourceBatchOp(model),
        B.TableSourceBatchOp(_table(pkg, X, y, names))).collect()
    return pred, y, model


@pytest.mark.parametrize("recipe", sorted(RECIPES))
def test_op_recipes_on_the_port(recipe):
    """tests/test_dl.py's KerasSequential op tests, on the port's ops."""
    pred, y, _ = _op_run("alink_tpu_torch", recipe)
    p = np.asarray(pred.col("p"))
    if recipe == "regressor":
        assert float(np.mean((p - y) ** 2)) < 0.05
        return
    acc = float(np.mean(p == y))
    assert acc > (0.85 if recipe == "batchnorm" else 0.9), acc
    assert set(json.loads(pred.col("pd")[0])) == {"0", "1"}


@pytest.mark.parametrize("writer", ["alink_tpu", "alink_tpu_torch"])
def test_model_tables_cross_packages(writer):
    """A BatchNorm classifier's table written by either package predicts
    the same in the other (params and batch_stats as flax msgpack)."""
    reader = "alink_tpu" if writer == "alink_tpu_torch" else \
        "alink_tpu_torch"
    mine, _, _ = _op_run(writer, "batchnorm", epochs=3)
    other, _, _ = _op_run(reader, "batchnorm", train_pkg=writer, epochs=3)
    np.testing.assert_array_equal(np.asarray(other.col("p")),
                                  np.asarray(mine.col("p")))
    probs = [np.asarray([[json.loads(v)[k] for k in ("0", "1")]
                         for v in t.col("pd")]) for t in (mine, other)]
    np.testing.assert_allclose(probs[1], probs[0], atol=1e-6, rtol=0)
