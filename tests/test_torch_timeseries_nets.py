"""Parity of the port's timeseries nets (DeepAR, LSTNet, TFT) with the
reference on the CPU.

- The nets carry the reference's flax tree: forwards within 1e-5 (fp32
  products in another order), and a 2-epoch fit from the reference's
  initial tree within 2e-5 of the reference's parameters and forecasts
  (the reference's 8-device data-parallel sums and the port's one-device
  sums round differently, 2 epochs of Adam carry it); TFT's attention key
  bias gets no gradient, so Adam moves it by rounding noise in either
  package and it is held through the net's outputs.
- A model table written by either package is served by the other, and the
  port writes the reference's ``params_bytes`` byte for byte from the same
  tree.
"""

import numpy as np
import pytest

from test_torch_timeseries import _series

NET_ATOL = 1e-5
FIT2_ATOL = 2e-5


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("ALINK_TORCH_DEVICE", "cpu")


@pytest.fixture(scope="module")
def sid():
    from torch_table_parity import reference_session, remove_session

    s = reference_session()
    yield s
    remove_session(s)


def _ref_tft(hidden, heads):
    """The reference's TFT net (``alink_tpu/operator/batch/timeseries.py``,
    defined inside ``TFTBatchOp._forecast``)."""
    import flax.linen as nn

    class GRN(nn.Module):
        units: int

        @nn.compact
        def __call__(self, x):
            h = nn.elu(nn.Dense(self.units)(x))
            h = nn.Dense(self.units)(h)
            gate = nn.sigmoid(nn.Dense(self.units)(x))
            skip = (x if x.shape[-1] == self.units
                    else nn.Dense(self.units)(x))
            return nn.LayerNorm()(skip + gate * h)

    class Net(nn.Module):
        @nn.compact
        def __call__(self, x, deterministic=True):
            h = nn.Dense(hidden)(x)
            h = nn.RNN(nn.OptimizedLSTMCell(hidden))(h)
            attn = nn.SelfAttention(num_heads=heads, qkv_features=hidden,
                                    deterministic=True)(h)
            h = nn.LayerNorm()(h + attn)
            h = GRN(hidden)(h)[:, -1, :]
            return nn.Dense(1)(h)

    return Net()


def _nets(L):
    from alink_tpu.operator.batch import timeseries2 as R
    from alink_tpu_torch.operator.batch import timeseries2 as P

    return {"deepar": (R._deepar_net(8), P.DeepARNet(8)),
            "lstnet": (R._lstnet_net(8, 3, 4, 5, 2),
                       P.LSTNetNet(8, 3, 4, 5, 2)),
            "tft": (_ref_tft(8, 2), P.TFTNet(8, 2))}


def _numpy_tree(tree):
    return {k: _numpy_tree(v) if hasattr(v, "items") else np.asarray(v)
            for k, v in tree.items()}


@pytest.mark.parametrize("kind", ["deepar", "lstnet", "tft"])
def test_net_forwards_with_carried_weights(kind):
    import jax
    import jax.numpy as jnp
    import torch

    from alink_tpu_torch.dl.convert import from_flax, to_flax

    ref_net, net = _nets(10)[kind]
    x = np.random.default_rng(0).normal(size=(5, 10, 1)).astype(np.float32)
    tree = _numpy_tree(ref_net.init(jax.random.PRNGKey(1),
                                    jnp.zeros((1, 10, 1))))
    net.load_state_dict(from_flax(net, tree))
    want = np.asarray(ref_net.apply(tree, jnp.asarray(x)))
    with torch.no_grad():
        got = net(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=NET_ATOL)
    back = to_flax(net)
    paths = lambda t: [str(p) for p, _ in  # noqa: E731
                       jax.tree_util.tree_leaves_with_path(t)]
    assert paths(back) == paths(tree)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(tree)):
        np.testing.assert_array_equal(a, b)


def _windows(y, L):
    from alink_tpu.operator.batch.timeseries2 import _train_windows

    mu, sd = float(np.mean(y)), float(np.std(y) + 1e-9)
    return _train_windows((np.asarray(y) - mu) / sd, L)


def test_deepar_two_epoch_fit_from_carried_tree():
    import jax
    import jax.numpy as jnp

    from alink_tpu.dl.train import TrainConfig, train_model
    from alink_tpu.operator.batch import timeseries2 as R
    from alink_tpu_torch.operator.batch import timeseries2 as P
    from alink_tpu_torch.operator.batch.timeseries2 import params_from_bytes

    y = _series(k=1, n=60)[0]
    L = 12
    init = _numpy_tree(R._deepar_net(8).init(jax.random.PRNGKey(2),
                                             jnp.zeros((1, L, 1))))
    X, t = _windows(y, L)
    cfg = TrainConfig(num_epochs=2, batch_size=16, learning_rate=5e-3,
                      loss="gaussian_nll", seed=0)
    ref_params, _ = train_model(R._deepar_net(8), {"x": X}, t, cfg,
                                regression=True, seq_axis=None,
                                init_params=init)
    got = P.deepar_train(y, lookback=L, hidden=8, num_epochs=2,
                         batch_size=16, learning_rate=5e-3, seed=0,
                         init_params=init)
    got_tree = params_from_bytes(got["params_bytes"])
    for a, b in zip(jax.tree_util.tree_leaves(got_tree),
                    jax.tree_util.tree_leaves(_numpy_tree(ref_params))):
        np.testing.assert_allclose(a, b, rtol=0, atol=FIT2_ATOL)
    ref_model = dict(got, params_bytes=np.frombuffer(
        __import__("flax").serialization.to_bytes(ref_params),
        np.uint8).copy())
    want, want_sigma = R.net_forecast(ref_model, y, 5)
    mean, sigma = P.net_forecast(got, y, 5)
    np.testing.assert_allclose(mean, want, rtol=0,
                               atol=FIT2_ATOL * np.abs(y).max())
    assert abs(sigma - want_sigma) <= FIT2_ATOL * np.std(y) * 10


TFT = dict(n=40, L=8, hidden=8, heads=4)


@pytest.fixture(scope="module")
def ref_tft():
    """The reference's TFT net trained 2 epochs from a carried initial tree
    on TFTBatchOp's windows (its float32 z-scores): (y, init, trained
    params, X, targets)."""
    import jax
    import jax.numpy as jnp

    from alink_tpu.dl.train import TrainConfig, train_model

    y = _series(k=1, n=TFT["n"])[0]
    L = TFT["L"]
    mu, sd = float(np.mean(y)), float(np.std(y) + 1e-9)
    z32 = ((y - mu) / sd).astype(np.float32)
    X = np.stack([z32[s:s + L] for s in range(len(z32) - L)])[..., None]
    net = _ref_tft(TFT["hidden"], TFT["heads"])
    init = _numpy_tree(net.init(jax.random.PRNGKey(4),
                                jnp.zeros((1, L, 1))))
    params, _ = train_model(net, {"x": X}, z32[L:], TrainConfig(
        num_epochs=2, batch_size=16, learning_rate=5e-3, loss="mse",
        seed=0), regression=True, seq_axis=None, init_params=init)
    return y, init, params, X, z32[L:]


@pytest.mark.parametrize("kind", ["lstnet", "tft"])
def test_mse_nets_two_epoch_fit_from_carried_tree(kind, request):
    import jax
    import jax.numpy as jnp
    import torch

    from alink_tpu.dl.train import TrainConfig as RCfg
    from alink_tpu.dl.train import train_model as ref_train
    from alink_tpu_torch.dl.convert import from_flax
    from alink_tpu_torch.dl.train import TrainConfig, train_model

    kw = dict(num_epochs=2, batch_size=16, learning_rate=5e-3, loss="mse",
              seed=0)
    if kind == "tft":
        _, init, ref_params, X, t = request.getfixturevalue("ref_tft")
        ref_net = _ref_tft(TFT["hidden"], TFT["heads"])
        from alink_tpu_torch.operator.batch.timeseries2 import TFTNet

        net = TFTNet(TFT["hidden"], TFT["heads"])
    else:
        y = _series(k=1, n=60)[0]
        L = 10
        ref_net, net = _nets(L)[kind]
        X, t = _windows(y, L)
        t = np.stack([t[:-1], t[1:]], 1)     # the direct 2-step head
        X = X[:-1]
        init = _numpy_tree(ref_net.init(jax.random.PRNGKey(3),
                                        jnp.zeros((1, L, 1))))
        ref_params, _ = ref_train(ref_net, {"x": X}, t, RCfg(**kw),
                                  regression=True, seq_axis=None,
                                  init_params=init)
    state, _ = train_model(net, {"x": X}, t, TrainConfig(**kw),
                           regression=True, init_params=init)
    want = from_flax(net, _numpy_tree(ref_params))
    for k, v in want.items():
        if k == "SelfAttention_0.key.bias":
            # no gradient reaches it (softmax is blind to a per-query
            # shift): Adam turns each package's rounding noise into ±lr
            # steps, so it is held through the forward below instead
            continue
        np.testing.assert_allclose(state[k].numpy(), v.numpy(), rtol=0,
                                   atol=FIT2_ATOL, err_msg=k)
    with torch.no_grad():
        got = net(torch.as_tensor(X)).numpy()
    np.testing.assert_allclose(
        got, np.asarray(ref_net.apply(ref_params, jnp.asarray(X))), rtol=0,
        atol=FIT2_ATOL)


def test_tft_op_forecasts_from_carried_tree(ref_tft):
    """TFTBatchOp from the reference's initial tree: the reference's op
    draws its own, so the reference side is its op's steps by hand
    (train_model, then the recursive roll)."""
    import jax.numpy as jnp

    import alink_tpu_torch.operator.batch as P
    from alink_tpu_torch.common.mtable import MTable

    y, init, params, _, _ = ref_tft
    L = TFT["L"]
    mu, sd = float(np.mean(y)), float(np.std(y) + 1e-9)
    window = ((y - mu) / sd).astype(np.float32)[-L:].copy()
    net = _ref_tft(TFT["hidden"], TFT["heads"])
    want = []
    for _ in range(3):
        nxt = float(net.apply(params, jnp.asarray(window[None, :, None]))
                    [0, 0])
        want.append(nxt)
        window = np.roll(window, -1)
        window[-1] = nxt
    want = np.asarray(want) * sd + mu
    P.TFTBatchOp._init_params = init
    try:
        out = P.TFTBatchOp(valueCol="v", lookback=L, hiddenSize=TFT["hidden"],
                           numHeads=TFT["heads"], numEpochs=2, batchSize=16,
                           predictNum=3).link_from(
            P.TableSourceBatchOp(MTable({"v": y}))).collect()
    finally:
        P.TFTBatchOp._init_params = None
    np.testing.assert_allclose(out.col("forecast")[0].data, want, rtol=0,
                               atol=FIT2_ATOL * np.abs(y).max())


def _model_table(pkg, meta, arrays):
    import importlib

    return importlib.import_module(f"{pkg}.common.model").model_to_table(
        meta, arrays)


@pytest.mark.parametrize("kind", ["DeepAR", "LSTNet"])
def test_model_tables_cross_packages(sid, kind):
    import alink_tpu.operator.batch as R
    import alink_tpu_torch.operator.batch as P
    from alink_tpu.common.mtable import MTable as RT
    from alink_tpu_torch.common.mtable import MTable as PT
    from alink_tpu_torch.operator.batch.timeseries2 import (
        params_from_bytes, params_to_bytes)
    from alink_tpu_torch.dl.convert import keras_flax_to_torch

    y = _series(k=1, n=48)[0]
    kw = dict(valueCol="v", lookback=8, hiddenSize=4, numEpochs=1,
              batchSize=16)
    ref_model = getattr(R, f"{kind}TrainBatchOp")(
        **kw, MLEnvironmentId=sid).link_from(
        R.TableSourceBatchOp(RT({"v": y}))).collect()
    port_model = getattr(P, f"{kind}TrainBatchOp")(**kw).link_from(
        P.TableSourceBatchOp(PT({"v": y}))).collect()
    # the port writes the reference's bytes from the same tree
    from alink_tpu.common.model import table_to_model

    meta, arrays = table_to_model(ref_model)
    buf = arrays["params_bytes"]
    again = params_to_bytes(keras_flax_to_torch(params_from_bytes(buf)))
    assert again.tobytes() == np.asarray(buf, np.uint8).tobytes()
    hist = {"s": np.asarray([" ".join(map(str, y[-20:]))], object)}
    from alink_tpu.common.model import model_to_table as r_m2t
    from alink_tpu_torch.common.model import model_to_table as p_m2t
    from alink_tpu_torch.common.model import table_to_model as p_t2m

    # each model table decoded by its writer, re-encoded by the reader
    models = {"port": {P: port_model, R: r_m2t(*p_t2m(port_model))},
              "ref": {R: ref_model, P: p_m2t(*table_to_model(ref_model))}}
    outs = {}
    for writer in ("port", "ref"):
        for B, T, extra in ((R, RT, dict(MLEnvironmentId=sid)),
                            (P, PT, {})):
            outs[writer, B is P] = getattr(B, f"{kind}PredictBatchOp")(
                selectedCol="s", outputCol="fc", predictNum=3, **extra) \
                .link_from(B.TableSourceBatchOp(models[writer][B]),
                           B.TableSourceBatchOp(T(dict(hist)))) \
                .collect().col("fc")[0].data
    np.testing.assert_allclose(outs["port", False], outs["port", True],
                               rtol=0, atol=NET_ATOL * np.abs(y).max())
    np.testing.assert_allclose(outs["ref", True], outs["ref", False],
                               rtol=0, atol=NET_ATOL * np.abs(y).max())


