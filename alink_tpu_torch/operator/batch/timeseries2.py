"""Timeseries long-tail: DeepAR/LSTNet/Prophet train+predict pairs,
AutoGarch order search, and in-series lookup ops (port of
``alink_tpu.operator.batch.timeseries2``).

Capability parity (reference: operator/batch/timeseries/
DeepARTrainBatchOp.java / DeepARPredictBatchOp.java,
LSTNetTrainBatchOp.java / LSTNetPredictBatchOp.java,
ProphetTrainBatchOp.java / ProphetPredictBatchOp.java,
AutoGarchBatchOp.java, dataproc/LookupValueInTimeSeriesBatchOp.java,
LookupVectorInTimeSeriesBatchOp.java, LookupRecentDaysBatchOp.java).

The nets are torch modules with the reference's flax names and layouts
(``OptimizedLSTMCell_0``, ``GRUCell_<i>``, ``Conv_0``, ``Dense_<i>``; for
TFT ``SelfAttention_0``'s query/key/value/out, ``LayerNorm_<i>`` with ε
1e-6, ``GRN_0``), so :func:`~alink_tpu_torch.dl.convert.keras_flax_to_torch`
carries a trained tree across leaf by leaf. They train through the port's
``dl.train.train_model`` (the reference's row order, optax's schedule and
Adam). A model table's ``params_bytes`` is flax's msgpack of the parameter
tree with its keys sorted, as a trained flax tree has them
(:mod:`~alink_tpu_torch.common.flax_msgpack`), so each package serves the
other's tables. Prophet is not in the port: its ops raise the reference's
missing-plugin exception. AutoGarch fits every (p, q) candidate of every
series as lanes of one fit (:mod:`alink_tpu_torch.stats.lanefit`).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...common.exceptions import (
    AkIllegalArgumentException,
    AkIllegalDataException,
)
from ...common.linalg import DenseVector, parse_vector
from ...common.model import model_to_table, table_to_model
from ...common.mtable import AlinkTypes, MTable
from ...common.params import MinValidator, ParamInfo
from ...dl.modules import Dense, GRUCell, LayerNorm, LSTMCell, Conv1D, _Kernel
from ...mapper import (
    HasOutputCol,
    HasReservedCols,
    HasSelectedCol,
    ModelMapper,
    SISOMapper,
)
from .base import BatchOperator
from .utils import MapBatchOp, ModelMapBatchOp, ModelTrainOpMixin
from .timeseries import _BaseForecastOp


# ---------------------------------------------------------------------------
# shared net cores (used by the direct ops AND the train/predict pairs)
# ---------------------------------------------------------------------------


class _FlaxNet(nn.Module):
    """A net whose state dict maps onto the reference's flax variables by
    the KerasSequential rules (``dl/convert.py``)."""

    flax_layout = "keras"

    def init_weights(self, seed: int):
        """flax's default initialisers (lecun_normal kernels, orthogonal
        recurrent kernels, zero biases, unit norm scales) drawn on the host
        from a generator seeded by ``seed``, so the card and the CPU start
        from the same weights; the draws differ from JAX's."""
        dev = next(self.parameters()).device
        self.to("cpu")
        g = torch.Generator().manual_seed(int(seed))
        for mod in self.modules():
            if isinstance(mod, (Dense, LayerNorm, Conv1D, _Kernel,
                                _DenseGeneral)):
                mod.reset_parameters(g)
        return self.to(dev)


class DeepARNet(_FlaxNet):
    """``nn.RNN(OptimizedLSTMCell(hidden))`` → last step → ``Dense(2)``:
    (mu, log sigma) under ``gaussian_nll``."""

    def __init__(self, hidden: int):
        super().__init__()
        self.OptimizedLSTMCell_0 = LSTMCell(1, hidden)
        self.Dense_0 = Dense(hidden, 2, torch.float32)

    def forward(self, x, *, deterministic=True, rng=None):
        return self.Dense_0(self.OptimizedLSTMCell_0(x)[:, -1, :])


class LSTNetNet(_FlaxNet):
    """``relu(Conv(hidden, (kernel,)))`` (SAME), a GRU over all steps and a
    GRU over every ``skip``-th step ending at the last, their last states
    through ``Dense(out_dim)``, plus the ``Dense(out_dim)`` autoregressive
    highway over the last ``ar_w`` inputs."""

    def __init__(self, hidden: int, kernel: int, skip: int, ar_w: int,
                 out_dim: int = 1):
        super().__init__()
        self.skip, self.ar_w = skip, ar_w
        self.Conv_0 = Conv1D(1, hidden, kernel, 1)
        self.GRUCell_0 = GRUCell(hidden, hidden)
        self.GRUCell_1 = GRUCell(hidden, hidden // 2)
        self.Dense_0 = Dense(hidden + hidden // 2, out_dim, torch.float32)
        self.Dense_1 = Dense(ar_w, out_dim, torch.float32)

    def forward(self, x, *, deterministic=True, rng=None):
        c = F.relu(self.Conv_0(x))
        r = self.GRUCell_0(c)[:, -1, :]
        sk = c[:, (c.shape[1] - 1) % self.skip::self.skip, :]
        sk = self.GRUCell_1(sk)[:, -1, :]
        out = self.Dense_0(torch.cat([r, sk], -1))
        return out + self.Dense_1(x[:, -self.ar_w:, 0])


class _DenseGeneral(nn.Module):
    """flax ``DenseGeneral`` of the attention: ``in`` → (heads, head_dim)
    (weight (head_dim, heads, in), the transposed flax kernel, bias (heads,
    head_dim)), or with ``out=True`` (heads, head_dim) → ``features``
    (weight (features, head_dim, heads), bias (features,))."""

    def __init__(self, features: int, heads: int, head_dim: int,
                 out: bool = False):
        super().__init__()
        self.out = out
        shape = (features, head_dim, heads) if out \
            else (head_dim, heads, features)
        self.weight = nn.Parameter(torch.empty(shape))
        self.bias = nn.Parameter(torch.zeros(
            (features,) if out else (heads, head_dim)))

    def reset_parameters(self, generator=None):
        from ...dl.modules import _lecun_

        fan_in = self.weight.shape[1] * self.weight.shape[2] if self.out \
            else self.weight.shape[2]
        with torch.no_grad():
            _lecun_(self.weight, fan_in, generator)
            self.bias.zero_()

    def forward(self, x):
        if self.out:                    # (b, L, H, hd) -> (b, L, out)
            return torch.einsum("blhd,odh->blo", x, self.weight) + self.bias
        return torch.einsum("bli,dhi->blhd", x, self.weight) + self.bias


class _SelfAttention(nn.Module):
    """flax ``nn.SelfAttention(num_heads, qkv_features)``, deterministic,
    unmasked: the query scaled by 1/√head_dim, softmax over the keys."""

    def __init__(self, features: int, heads: int):
        super().__init__()
        hd = features // heads
        self.query = _DenseGeneral(features, heads, hd)
        self.key = _DenseGeneral(features, heads, hd)
        self.value = _DenseGeneral(features, heads, hd)
        self.out = _DenseGeneral(features, heads, hd, out=True)
        self.head_dim = hd

    def forward(self, x):
        q = self.query(x) / np.sqrt(self.head_dim).astype(np.float32)
        k, v = self.key(x), self.value(x)
        w = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q, k), dim=-1)
        return self.out(torch.einsum("bhqk,bkhd->bqhd", w, v))


class _GRN(nn.Module):
    """Gated residual network — the TFT building block; the skip is the
    input itself (its width is ``units`` here)."""

    def __init__(self, units: int):
        super().__init__()
        self.Dense_0 = Dense(units, units, torch.float32)
        self.Dense_1 = Dense(units, units, torch.float32)
        self.Dense_2 = Dense(units, units, torch.float32)
        self.LayerNorm_0 = LayerNorm(units, torch.float32)

    def forward(self, x):
        h = self.Dense_1(F.elu(self.Dense_0(x)))
        gate = torch.sigmoid(self.Dense_2(x))
        return self.LayerNorm_0(x + gate * h)


class TFTNet(_FlaxNet):
    """``Dense(hidden)`` → LSTM → self-attention with a post-attention
    residual ``LayerNorm`` → GRN on the last step → ``Dense(1)``."""

    def __init__(self, hidden: int, heads: int):
        super().__init__()
        self.Dense_0 = Dense(1, hidden, torch.float32)
        self.OptimizedLSTMCell_0 = LSTMCell(hidden, hidden)
        self.SelfAttention_0 = _SelfAttention(hidden, heads)
        self.LayerNorm_0 = LayerNorm(hidden, torch.float32)
        self.GRN_0 = _GRN(hidden)
        self.Dense_1 = Dense(hidden, 1, torch.float32)

    def forward(self, x, *, deterministic=True, rng=None):
        h = self.OptimizedLSTMCell_0(self.Dense_0(x))
        h = self.LayerNorm_0(h + self.SelfAttention_0(h))
        return self.Dense_1(self.GRN_0(h)[:, -1, :])


def _deepar_net(hidden: int):
    return DeepARNet(hidden)


def _lstnet_net(hidden: int, kernel: int, skip: int, ar_w: int,
                out_dim: int = 1):
    return LSTNetNet(hidden, kernel, skip, ar_w, out_dim)


def _sorted_tree(tree):
    return {k: _sorted_tree(tree[k]) if isinstance(tree[k], dict)
            else tree[k] for k in sorted(tree)}


def params_to_bytes(state: Dict[str, torch.Tensor]) -> np.ndarray:
    """A net's state as the reference's ``params_bytes``: flax's msgpack of
    ``{"params": tree}``, keys sorted as a trained flax tree has them."""
    from ...common import flax_msgpack
    from ...dl.convert import keras_torch_to_flax

    tree = _sorted_tree(keras_torch_to_flax(state))
    return np.frombuffer(flax_msgpack.dumps(tree), np.uint8).copy()


def params_from_bytes(buf) -> dict:
    from ...common import flax_msgpack

    return flax_msgpack.loads(bytes(np.asarray(buf, np.uint8)))


def _train_windows(z: np.ndarray, L: int, horizon: int = 1):
    """(X, targets) windows; ``horizon > 1`` builds direct multi-step
    targets ``z[s+L : s+L+h]`` per window (the LSTNet-paper contract —
    the net maps a window straight to the forecast path instead of
    compounding one-step recursion error)."""
    n_win = len(z) - L - horizon + 1
    X = np.stack([z[s:s + L] for s in range(n_win)])[..., None]
    if horizon == 1:
        return X.astype(np.float32), z[L:].astype(np.float32)
    t = np.stack([z[s + L:s + L + horizon] for s in range(n_win)])
    return X.astype(np.float32), t.astype(np.float32)


def _fit(net, X, t, cfg, init_params, device) -> np.ndarray:
    from ...dl.train import train_model

    state, _ = train_model(net, {"x": X}, t, cfg, regression=True,
                           init_params=init_params, device=device)
    return params_to_bytes(state)


def deepar_train(y: np.ndarray, *, lookback: int, hidden: int,
                 num_epochs: int, batch_size: int, learning_rate: float,
                 seed: int, device=None, init_params=None) -> Dict:
    """Fit the DeepAR net on ``device``; returns the serializable model
    dict. ``init_params``: a flax variables tree to start from (the tests
    carry the reference's)."""
    from ...dl.train import TrainConfig

    if len(y) < 8:
        raise AkIllegalArgumentException(
            f"DeepAR needs at least 8 observations, got {len(y)}")
    L = min(lookback, max(len(y) - 1, 2))
    mu_y, sd_y = float(np.mean(y)), float(np.std(y) + 1e-9)
    z = (np.asarray(y, np.float64) - mu_y) / sd_y
    X, t = _train_windows(z, L)
    cfg = TrainConfig(num_epochs=num_epochs, batch_size=batch_size,
                      learning_rate=learning_rate, loss="gaussian_nll",
                      seed=seed)
    return {"kind": "deepar", "L": L, "hidden": hidden,
            "mu": mu_y, "sd": sd_y,
            "params_bytes": _fit(_deepar_net(hidden), X, t, cfg,
                                 init_params, device)}


def lstnet_train(y: np.ndarray, *, lookback: int, hidden: int,
                 kernel: int, skip: int, ar_window: int, num_epochs: int,
                 batch_size: int, learning_rate: float, seed: int,
                 horizon: int = 1, device=None, init_params=None) -> Dict:
    """Fit LSTNet on ``device``. ``horizon > 1`` trains the paper's direct
    multi-horizon head (one forward pass emits the whole forecast path);
    ``horizon=1`` keeps the one-step head of the train/predict pair, whose
    horizon is unknown at train time."""
    from ...dl.train import TrainConfig

    if len(y) < 12:
        raise AkIllegalArgumentException(
            f"LSTNet needs at least 12 observations, got {len(y)}")
    L = min(lookback, max(len(y) - 1, 4))
    mu_y, sd_y = float(np.mean(y)), float(np.std(y) + 1e-9)
    z = (np.asarray(y, np.float64) - mu_y) / sd_y
    h = max(1, min(int(horizon), len(z) - L - 1))
    X, t = _train_windows(z, L, h)
    skip = max(1, min(skip, L - 1))
    ar_w = max(1, min(ar_window, L))
    cfg = TrainConfig(num_epochs=num_epochs, batch_size=batch_size,
                      learning_rate=learning_rate, loss="mse", seed=seed)
    net = _lstnet_net(hidden, kernel, skip, ar_w, out_dim=h)
    return {"kind": "lstnet", "L": L, "hidden": hidden, "kernel": kernel,
            "skip": skip, "arWindow": ar_w, "horizon": h,
            "mu": mu_y, "sd": sd_y,
            "params_bytes": _fit(net, X, t, cfg, init_params, device)}


def _restore_net(model: Dict, device=None):
    """The model dict's net with its parameters, on ``device``."""
    from ...common.env import resolve_device
    from ...dl.convert import keras_flax_to_torch

    if model["kind"] == "deepar":
        net = _deepar_net(int(model["hidden"]))
    else:
        net = _lstnet_net(int(model["hidden"]), int(model["kernel"]),
                          int(model["skip"]), int(model["arWindow"]),
                          out_dim=int(model.get("horizon", 1)))
    net.load_state_dict(keras_flax_to_torch(
        params_from_bytes(model["params_bytes"])))
    return net.to(resolve_device(device)).eval(), resolve_device(device)


@torch.no_grad()
def _predict(net, window: np.ndarray, dev) -> np.ndarray:
    x = torch.as_tensor(window[None, :, None], device=dev)
    return net(x)[0].cpu().numpy()


def roll_forecast(net, window: np.ndarray, horizon: int, dev) -> List[float]:
    """TFT's recursive roll: ``horizon`` one-step forwards, each
    prediction appended to the float32 window."""
    window = np.asarray(window, np.float32).copy()
    net.eval()
    preds = []
    for _ in range(horizon):
        nxt = float(_predict(net, window, dev)[0])
        preds.append(nxt)
        window = np.roll(window, -1)
        window[-1] = nxt
    return preds


def net_forecast(model: Dict, y_hist: np.ndarray, horizon: int,
                 device=None) -> Tuple[np.ndarray, Optional[float]]:
    """Roll the restored net forward ``horizon`` steps from the end of
    ``y_hist``. Returns (mean path, sigma of the first step for deepar)."""
    net, dev = _restore_net(model, device)
    L = int(model["L"])
    mu_y, sd_y = float(model["mu"]), float(model["sd"])
    z = ((np.asarray(y_hist, np.float64) - mu_y) / sd_y).astype(np.float32)
    if len(z) < L:
        z = np.concatenate([np.zeros(L - len(z), np.float32), z])
    window = z[-L:].copy()
    # direct multi-horizon heads emit their whole head per forward pass;
    # one-step heads roll step-wise — either way the loop consumes however
    # many steps the head emitted
    means: List[float] = []
    sigma0: Optional[float] = None
    while len(means) < horizon:
        out = _predict(net, window, dev)
        if model["kind"] == "deepar":
            mu_steps = [float(out[0])]
            if not means:
                sigma0 = float(np.exp(float(out[1]))) * sd_y
        else:
            mu_steps = [float(v) for v in np.asarray(out).reshape(-1)]
        take = mu_steps[:horizon - len(means)]
        means.extend(m * sd_y + mu_y for m in take)
        window = np.concatenate(
            [window, np.asarray(take, np.float32)])[-L:]
    return np.asarray(means, np.float64), sigma0


# ---------------------------------------------------------------------------
# train ops
# ---------------------------------------------------------------------------


class _NetForecastTrainOp(ModelTrainOpMixin, BatchOperator):
    VALUE_COL = ParamInfo("valueCol", str, optional=False,
                          aliases=("selectedCol",))
    LOOKBACK = ParamInfo("lookback", int, default=24,
                         validator=MinValidator(2))
    HIDDEN = ParamInfo("hiddenSize", int, default=32)
    NUM_EPOCHS = ParamInfo("numEpochs", int, default=40)
    BATCH_SIZE = ParamInfo("batchSize", int, default=64)
    LEARNING_RATE = ParamInfo("learningRate", float, default=5e-3)
    RANDOM_SEED = ParamInfo("randomSeed", int, default=0, aliases=("seed",))

    _min_inputs = 1
    _max_inputs = 1
    _model_name = None
    _init_params = None      # tests: the reference's initial tree, carried

    def _static_meta_keys(self, in_schema):
        return {"modelName": self._model_name}

    def _train(self, y: np.ndarray) -> Dict:
        raise NotImplementedError

    def _execute_impl(self, t: MTable) -> MTable:
        y = np.asarray(t.col(self.get(self.VALUE_COL)), np.float64)
        model = self._train(y)
        arrays = {"params_bytes": model.pop("params_bytes")}
        meta = {"modelName": self._model_name, **model}
        return model_to_table(meta, arrays)


class DeepARTrainBatchOp(_NetForecastTrainOp):
    """(reference: operator/batch/timeseries/DeepARTrainBatchOp.java — the
    akdl deepar estimator behind DLLauncher)."""

    _model_name = "DeepARModel"

    def _train(self, y):
        return deepar_train(
            y, lookback=self.get(self.LOOKBACK),
            hidden=self.get(self.HIDDEN),
            num_epochs=self.get(self.NUM_EPOCHS),
            batch_size=self.get(self.BATCH_SIZE),
            learning_rate=self.get(self.LEARNING_RATE),
            seed=self.get(self.RANDOM_SEED), device=self.env.device,
            init_params=self._init_params)


class LSTNetTrainBatchOp(_NetForecastTrainOp):
    """(reference: operator/batch/timeseries/LSTNetTrainBatchOp.java)."""

    _model_name = "LSTNetModel"

    KERNEL_SIZE = ParamInfo("kernelSize", int, default=3)
    SKIP = ParamInfo("skip", int, default=4)
    AR_WINDOW = ParamInfo("arWindow", int, default=8)

    def _train(self, y):
        return lstnet_train(
            y, lookback=self.get(self.LOOKBACK),
            hidden=self.get(self.HIDDEN),
            kernel=self.get(self.KERNEL_SIZE), skip=self.get(self.SKIP),
            ar_window=self.get(self.AR_WINDOW),
            num_epochs=self.get(self.NUM_EPOCHS),
            batch_size=self.get(self.BATCH_SIZE),
            learning_rate=self.get(self.LEARNING_RATE),
            seed=self.get(self.RANDOM_SEED), device=self.env.device,
            init_params=self._init_params)


# ---------------------------------------------------------------------------
# predict mappers/ops
# ---------------------------------------------------------------------------


def _numeric_series(cell) -> Optional[np.ndarray]:
    """A row's series: the last numeric column of an MTable cell, or a
    vector's values."""
    if isinstance(cell, MTable):
        for name, tp in zip(reversed(cell.names),
                            reversed(list(cell.schema.types))):
            if AlinkTypes.is_numeric(tp):
                return np.asarray(cell.col(name), np.float64)
        return None
    return parse_vector(cell).to_dense().data


class _NetForecastPredictMapper(ModelMapper, HasSelectedCol, HasOutputCol,
                                HasReservedCols):
    """Each row's history (vector or MTable series cell) → forecast vector
    (reference: DeepARPredictBatchOp.java over the persisted checkpoint),
    on the mapper's device."""

    PREDICT_NUM = ParamInfo("predictNum", int, default=12,
                            validator=MinValidator(1))

    def load_model(self, model: MTable):
        self.meta, arrays = table_to_model(model)
        self.model = dict(self.meta)
        self.model["params_bytes"] = arrays["params_bytes"]
        return self

    def output_schema(self, input_schema):
        out = self.get(HasOutputCol.OUTPUT_COL) or "forecast"
        return self._append_result_schema(
            input_schema, [out], [AlinkTypes.DENSE_VECTOR])

    @staticmethod
    def _history(cell) -> np.ndarray:
        y = _numeric_series(cell)
        if y is None:
            raise AkIllegalDataException("series MTable has no numeric col")
        return y

    def map_table(self, t: MTable) -> MTable:
        sel = self.get(HasSelectedCol.SELECTED_COL)
        out = self.get(HasOutputCol.OUTPUT_COL) or "forecast"
        horizon = self.get(self.PREDICT_NUM)
        vecs = np.empty(t.num_rows, object)
        for i, cell in enumerate(t.col(sel)):
            if cell is None:
                vecs[i] = None
                continue
            means, _sigma = net_forecast(self.model, self._history(cell),
                                         horizon, device=self.device)
            vecs[i] = DenseVector(means)
        return self._append_result(
            t, {out: vecs}, {out: AlinkTypes.DENSE_VECTOR})


class DeepARPredictBatchOp(ModelMapBatchOp, HasSelectedCol, HasOutputCol,
                           HasReservedCols):
    """(reference: operator/batch/timeseries/DeepARPredictBatchOp.java)"""

    mapper_cls = _NetForecastPredictMapper
    PREDICT_NUM = _NetForecastPredictMapper.PREDICT_NUM


class LSTNetPredictBatchOp(DeepARPredictBatchOp):
    """(reference: operator/batch/timeseries/LSTNetPredictBatchOp.java)"""


# ---------------------------------------------------------------------------
# Prophet train/predict (plugin-gated like the direct op)
# ---------------------------------------------------------------------------


def _no_prophet(what: str, alternatives: str = ""):
    from ...common.exceptions import AkPluginNotExistException

    return AkPluginNotExistException(
        f"{what} needs the 'prophet' package"
        + (f": pip install prophet. Built-in alternatives: {alternatives}"
           if alternatives else ""))


class ProphetTrainBatchOp(ModelTrainOpMixin, BatchOperator):
    """Fit prophet once and persist its JSON model (reference:
    operator/batch/timeseries/ProphetTrainBatchOp.java). The port carries
    no Prophet: the op raises the reference's missing-plugin exception."""

    VALUE_COL = ParamInfo("valueCol", str, optional=False,
                          aliases=("selectedCol",))
    FREQ = ParamInfo("freq", str, default="D")

    _min_inputs = 1
    _max_inputs = 1

    def _static_meta_keys(self, in_schema):
        return {"modelName": "ProphetModel"}

    def _execute_impl(self, t: MTable) -> MTable:
        raise _no_prophet("ProphetTrainBatchOp",
                          "AutoArimaBatchOp, DeepARTrainBatchOp, "
                          "LSTNetTrainBatchOp.")


class ProphetPredictMapper(ModelMapper, HasSelectedCol, HasOutputCol,
                           HasReservedCols):
    PREDICT_NUM = ParamInfo("predictNum", int, default=12,
                            validator=MinValidator(1))

    def load_model(self, model: MTable):
        self.meta, arrays = table_to_model(model)
        self._json = bytes(np.asarray(arrays["model_json"],
                                      np.uint8)).decode()
        return self

    def output_schema(self, input_schema):
        out = self.get(HasOutputCol.OUTPUT_COL) or "forecast"
        return self._append_result_schema(
            input_schema, [out], [AlinkTypes.DENSE_VECTOR])

    @staticmethod
    def _row_series(cell) -> "np.ndarray | None":
        return None if cell is None else _numeric_series(cell)

    def map_table(self, t: MTable) -> MTable:
        raise _no_prophet("ProphetPredictBatchOp")


class ProphetPredictBatchOp(ModelMapBatchOp, HasSelectedCol, HasOutputCol,
                            HasReservedCols):
    """(reference: operator/batch/timeseries/ProphetPredictBatchOp.java)"""

    mapper_cls = ProphetPredictMapper
    PREDICT_NUM = ProphetPredictMapper.PREDICT_NUM


# ---------------------------------------------------------------------------
# AutoGarch: (p, q) order search by AIC
# ---------------------------------------------------------------------------


def _garch_fit_lanes(rs: List[np.ndarray], orders: List[Tuple[int, int]],
                     device):
    """The reference's ``_garch_fit_pq`` for every (r, (p, q)) lane at once:
    300 Adam steps from the start ``max(p, q, 1)`` with the histories seeded
    at var0. Returns (nll, alphas, betas, omega) per lane."""
    from ...stats.lanefit import garch_fit_lanes

    ps = [p for p, _ in orders]
    qs = [q for _, q in orders]
    params, nll, var0 = garch_fit_lanes(
        rs, ps, qs, device, steps=300,
        alpha_scale=[0.5 / max(p, 1) for p in ps],
        beta_scale=[1.0 / max(q, 1) for q in qs],
        start=[max(p, q, 1) for p, q in orders], seed_r2=True)
    P = max(ps)
    out = []
    for i, (p, q) in enumerate(orders):
        th = params[i]
        omega = float(np.logaddexp(th[0], 0.0) * var0[i] * 0.1)
        alphas = 1 / (1 + np.exp(-th[1:1 + p])) * (0.5 / max(p, 1))
        betas = 1 / (1 + np.exp(-th[1 + P:1 + P + q])) / max(q, 1)
        out.append((float(nll[i]), np.atleast_1d(alphas),
                    np.atleast_1d(betas), omega))
    return out


class AutoGarchBatchOp(_BaseForecastOp):
    """GARCH with (p, q) order search by AIC over a small grid — the
    reference's headline auto-order op (reference: operator/batch/
    timeseries/AutoGarchBatchOp.java). Every candidate of every series is
    a lane of one fit."""

    MAX_ORDER = ParamInfo("maxOrder", int, default=2,
                          validator=MinValidator(1))

    def _extra_schema_keys(self):
        return ["p", "q", "aic"]

    def _forecast_series(self, ys, horizon):
        mo = int(self.get(self.MAX_ORDER))
        orders = [(p, q) for p in range(1, mo + 1) for q in range(0, mo + 1)]
        rs = [y - y.mean() for y in ys]
        fits = _garch_fit_lanes([r for r in rs for _ in orders],
                                orders * len(rs), self.env.device)
        fcs, extras = [], []
        for s, r in enumerate(rs):
            best = None
            for j, (p, q) in enumerate(orders):
                nll, alphas, betas, omega = fits[s * len(orders) + j]
                aic = 2 * (1 + p + q) + 2 * nll
                if best is None or aic < best["aic"]:
                    best = {"p": p, "q": q, "aic": aic, "alphas": alphas,
                            "betas": betas, "omega": omega}
            fcs.append(self._garch_forecast(r, best, horizon))
            extras.append({"p": float(best["p"]), "q": float(best["q"]),
                           "aic": float(best["aic"])})
        return fcs, extras

    @staticmethod
    def _garch_forecast(r, fit, horizon):
        p, q = fit["p"], fit["q"]
        omega, alphas, betas = fit["omega"], fit["alphas"], fit["betas"]
        m = max(p, q, 1)
        # reconstruct conditional variances to seed the forecast recursion
        var0 = float(np.var(r)) + 1e-8
        h_hist = [var0] * m
        r2_hist = [var0] * m
        for t in range(m, len(r)):
            h_new = omega
            for i in range(p):
                h_new += alphas[i] * r2_hist[i]
            for j in range(q):
                h_new += betas[j] * h_hist[j]
            h_hist = [h_new] + h_hist[:-1]
            r2_hist = [float(r[t] ** 2)] + r2_hist[:-1]
        out = []
        for _ in range(horizon):
            h_new = omega
            for i in range(p):
                h_new += alphas[i] * r2_hist[i]
            for j in range(q):
                h_new += betas[j] * h_hist[j]
            out.append(h_new)
            h_hist = [h_new] + h_hist[:-1]
            r2_hist = [h_new] + r2_hist[:-1]  # E[r²] = h
        return np.sqrt(np.asarray(out, np.float64))


# ---------------------------------------------------------------------------
# lookup in timeseries
# ---------------------------------------------------------------------------


def _series_cell(cell) -> Tuple[np.ndarray, MTable]:
    if not isinstance(cell, MTable):
        raise AkIllegalDataException(
            "timeseries lookup expects an MTable series cell "
            "(time column + value column)")
    times = np.asarray(cell.col(cell.names[0]))
    return times, cell


def _parse_time(v):
    try:
        return float(v)
    except (TypeError, ValueError):
        return np.datetime64(str(v)).astype("datetime64[s]").astype(float)


class LookupValueInTimeSeriesMapper(SISOMapper):
    """Row time → value at (or latest before) that time in the row's series
    cell (reference: operator/common/timeseries/
    LookupValueInTimeSeriesMapper.java)."""

    TIME_COL = ParamInfo("timeCol", str, optional=False)

    def map_table(self, t: MTable) -> MTable:
        sel = self.get(HasSelectedCol.SELECTED_COL)
        out = self.get(HasOutputCol.OUTPUT_COL) or "lookup_value"
        time_col = self.get(self.TIME_COL)
        res = np.full(t.num_rows, np.nan)
        for i in range(t.num_rows):
            cell = t.col(sel)[i]
            if cell is None:
                continue
            times, series = _series_cell(cell)
            tv = _parse_time(t.col(time_col)[i])
            ts = np.asarray([_parse_time(x) for x in times])
            value_col = series.names[-1]
            mask = ts <= tv
            if mask.any():
                res[i] = float(np.asarray(
                    series.col(value_col))[mask][np.argmax(ts[mask])])
        return self._append_result(
            t, {out: res}, {out: AlinkTypes.DOUBLE})

    def output_schema(self, input_schema):
        out = self.get(HasOutputCol.OUTPUT_COL) or "lookup_value"
        return self._append_result_schema(input_schema, [out],
                                          [AlinkTypes.DOUBLE])

    def map_column(self, values, type_tag):  # SISOMapper API unused
        raise NotImplementedError


class LookupValueInTimeSeriesBatchOp(MapBatchOp, HasSelectedCol,
                                     HasOutputCol, HasReservedCols):
    """(reference: operator/batch/dataproc/
    LookupValueInTimeSeriesBatchOp.java)"""

    mapper_cls = LookupValueInTimeSeriesMapper
    TIME_COL = LookupValueInTimeSeriesMapper.TIME_COL


class LookupVectorInTimeSeriesMapper(LookupValueInTimeSeriesMapper):
    """Same lookup, vector-valued series (reference: operator/common/
    timeseries/LookupVectorInTimeSeriesMapper.java)."""

    def map_table(self, t: MTable) -> MTable:
        sel = self.get(HasSelectedCol.SELECTED_COL)
        out = self.get(HasOutputCol.OUTPUT_COL) or "lookup_vector"
        time_col = self.get(self.TIME_COL)
        res = np.empty(t.num_rows, object)
        for i in range(t.num_rows):
            cell = t.col(sel)[i]
            if cell is None:
                res[i] = None
                continue
            times, series = _series_cell(cell)
            tv = _parse_time(t.col(time_col)[i])
            ts = np.asarray([_parse_time(x) for x in times])
            value_col = series.names[-1]
            mask = ts <= tv
            if mask.any():
                v = np.asarray(
                    series.col(value_col), object)[mask][np.argmax(ts[mask])]
                res[i] = parse_vector(v)
            else:
                res[i] = None
        return self._append_result(
            t, {out: res}, {out: AlinkTypes.DENSE_VECTOR})

    def output_schema(self, input_schema):
        out = self.get(HasOutputCol.OUTPUT_COL) or "lookup_vector"
        return self._append_result_schema(input_schema, [out],
                                          [AlinkTypes.DENSE_VECTOR])


class LookupVectorInTimeSeriesBatchOp(MapBatchOp, HasSelectedCol,
                                      HasOutputCol, HasReservedCols):
    """(reference: operator/batch/dataproc/
    LookupVectorInTimeSeriesBatchOp.java)"""

    mapper_cls = LookupVectorInTimeSeriesMapper
    TIME_COL = LookupVectorInTimeSeriesMapper.TIME_COL


class LookupRecentDaysMapper(SISOMapper):
    """Aggregate the last N days of the row's series before the row time:
    count/sum/mean/min/max as a stat vector (reference: operator/batch/
    dataproc/LookupRecentDaysBatchOp.java)."""

    TIME_COL = ParamInfo("timeCol", str, optional=False)
    NUM_DAYS = ParamInfo("numDays", int, default=7,
                         validator=MinValidator(1))

    def map_table(self, t: MTable) -> MTable:
        sel = self.get(HasSelectedCol.SELECTED_COL)
        out = self.get(HasOutputCol.OUTPUT_COL) or "recent_stats"
        time_col = self.get(self.TIME_COL)
        span = float(self.get(self.NUM_DAYS)) * 86400.0
        res = np.empty(t.num_rows, object)
        for i in range(t.num_rows):
            cell = t.col(sel)[i]
            if cell is None:
                res[i] = None
                continue
            times, series = _series_cell(cell)
            tv = _parse_time(t.col(time_col)[i])
            ts = np.asarray([_parse_time(x) for x in times])
            vals = np.asarray(series.col(series.names[-1]), np.float64)
            mask = (ts <= tv) & (ts > tv - span)
            w = vals[mask]
            if w.size:
                res[i] = DenseVector(np.asarray(
                    [float(w.size), w.sum(), w.mean(), w.min(), w.max()]))
            else:
                res[i] = DenseVector(np.asarray([0.0, 0, 0, 0, 0]))
        return self._append_result(
            t, {out: res}, {out: AlinkTypes.DENSE_VECTOR})

    def output_schema(self, input_schema):
        out = self.get(HasOutputCol.OUTPUT_COL) or "recent_stats"
        return self._append_result_schema(input_schema, [out],
                                          [AlinkTypes.DENSE_VECTOR])

    def map_column(self, values, type_tag):
        raise NotImplementedError


class LookupRecentDaysBatchOp(MapBatchOp, HasSelectedCol, HasOutputCol,
                              HasReservedCols):
    """Recent-days feature lookup (reference:
    operator/batch/feature/LookupRecentDaysBatchOp.java — a ModelMapBatchOp
    whose MODEL table carries group keys + precomputed recent-days feature
    columns, common/dataproc/LookupRecentDaysModelMapper.java).

    Two forms:
    - 2 inputs ``(model, data)`` — the reference contract: data rows are
      decorated by key lookup into the model table (keys = ``mapKeyCols``
      or the shared column names); misses yield NULLs.
    - 1 input — self-series convenience: count/sum/mean/min/max of the
      row's own series over the trailing ``numDays`` window.
    """

    mapper_cls = LookupRecentDaysMapper
    TIME_COL = LookupRecentDaysMapper.TIME_COL
    NUM_DAYS = LookupRecentDaysMapper.NUM_DAYS
    MAP_KEY_COLS = ParamInfo("mapKeyCols", list,
                             desc="model-table key columns; default: the "
                                  "columns shared with the data table")
    FEATURE_SCHEMA_STR = ParamInfo(
        "featureSchemaStr", str,
        desc="declared schema of the looked-up feature columns")

    _min_inputs = 1
    _max_inputs = 2

    def _lookup_cols(self, model_schema, data_schema):
        keys = self.get(self.MAP_KEY_COLS) or [
            n for n in model_schema.names if n in set(data_schema.names)]
        if not keys:
            raise AkIllegalArgumentException(
                "LookupRecentDays needs mapKeyCols (no shared columns "
                "between model and data)")
        feat = self.get(self.FEATURE_SCHEMA_STR)
        if feat:
            from ...common.mtable import TableSchema

            fs = TableSchema.parse(feat)
            feats = list(zip(fs.names, fs.types))
        else:
            feats = [(n, model_schema.type_of(n))
                     for n in model_schema.names if n not in set(keys)]
        return keys, feats

    def _execute_impl(self, *ins: MTable) -> MTable:
        if len(ins) == 1:
            return super()._execute_impl(ins[0])
        model, t = ins
        keys, feats = self._lookup_cols(model.schema, t.schema)
        index: Dict[tuple, tuple] = {}
        kcols = [model.col(k) for k in keys]
        vcols = [model.col(n) for n, _ in feats]
        for i in range(model.num_rows):
            index[tuple(c[i] for c in kcols)] = tuple(c[i] for c in vcols)
        dk = [t.col(k) for k in keys]
        cols = {n: t.col(n) for n in t.names}
        types = dict(zip(t.names, t.schema.types))
        from ...common.mtable import TableSchema

        for j, (n, tp) in enumerate(feats):
            vals = []
            for i in range(t.num_rows):
                hit = index.get(tuple(c[i] for c in dk))
                vals.append(None if hit is None else hit[j])
            if AlinkTypes.is_numeric(tp):
                cols[n] = np.asarray(
                    [np.nan if v is None else float(v) for v in vals])
                types[n] = AlinkTypes.DOUBLE
            else:
                cols[n] = np.asarray(vals, object)
                types[n] = tp
        names = list(t.names) + [n for n, _ in feats]
        return MTable(cols, TableSchema(names, [types[n] for n in names]))

    def _out_schema(self, *in_schemas):
        if len(in_schemas) == 1:
            return super()._out_schema(*in_schemas)
        model_schema, data_schema = in_schemas
        keys, feats = self._lookup_cols(model_schema, data_schema)
        from ...common.mtable import TableSchema

        names = list(data_schema.names) + [n for n, _ in feats]
        types = list(data_schema.types) + [
            AlinkTypes.DOUBLE if AlinkTypes.is_numeric(tp) else tp
            for _, tp in feats]
        return TableSchema(names, types)
