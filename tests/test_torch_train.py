"""Port parity of the BERT training slice: the optimizers and schedule, the
losses, one train step of a tiny BERT, the flash kernel route's gradient,
``train_model`` (plain and accumulated), checkpoint/resume and the
pretrained-checkpoint reader of ``alink_tpu_torch`` against ``alink_tpu``
on the CPU.

Inputs are made with numpy from fixed seeds and handed to both packages. The
reference's attention runs knob-off (``ALINK_ATTN_PALLAS=0``: its gradient
is XLA's autodiff of the plain scan); the port's runs its kernel route,
whose forward on CPU tensors is the plain version and whose backward is
``flash_blockwise_bwd``. Everything computes in fp32. Tolerances, each
stated where it is used: the two frameworks sum matmuls, softmax and
LayerNorm statistics in different orders (about 1e-7 relative per op), and
optax's fp32 scalar arithmetic differs from torch's in the last bit.
"""

import os

import numpy as np
import pytest
import torch

OPT_ATOL = 1e-6          # optimizer: 20 steps of the same gradients
LOSS_ATOL = 1e-6         # losses on the same logits
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6   # one step's gradient leaves
PARAM_ATOL = 1e-6        # parameters after two steps
ATTN_GRAD_ATOL = 1e-5    # dq, dk, dv of the flash route vs jax.grad
TRAIN_ATOL = 1e-5        # train_model: history and final parameters


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("ALINK_TORCH_DEVICE", "cpu")
    monkeypatch.delenv("ALINK_ATTN_PALLAS", raising=False)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _assert_trees_close(got, ref, **tol):
    got, ref = _flat(got), _flat(ref)
    assert sorted(got) == sorted(ref)
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], err_msg=k, **tol)


# ---------------------------------------------------------------------------
# optimizer, schedule and losses
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["adamw", "adam", "sgd"])
def test_optimizer_and_schedule_match_optax(kind):
    import jax.numpy as jnp
    import optax

    from alink_tpu.dl.train import TrainConfig as RefConfig
    from alink_tpu.dl.train import _make_optimizer
    from alink_tpu_torch.dl.train import TrainConfig, make_optimizer

    steps = 20
    g = np.random.default_rng(0)
    init = {"w": g.standard_normal((4, 3)).astype(np.float32),
            "b": g.standard_normal(3).astype(np.float32)}
    grads = [{k: g.standard_normal(v.shape).astype(np.float32)
              for k, v in init.items()} for _ in range(steps)]
    kw = dict(learning_rate=0.05, weight_decay=0.01, warmup_ratio=0.1,
              optimizer=kind)

    tx = _make_optimizer(RefConfig(**kw), steps)
    params = {k: jnp.asarray(v) for k, v in init.items()}
    state = tx.init(params)
    for gr in grads:
        upd, state = tx.update({k: jnp.asarray(v) for k, v in gr.items()},
                               state, params)
        params = optax.apply_updates(params, upd)

    mine = {k: torch.tensor(v) for k, v in init.items()}
    opt = make_optimizer(TrainConfig(**kw), steps, mine)
    for gr in grads:
        opt.step([torch.tensor(gr[k]) for k in opt.names])
    assert opt.schedule(0) == 0.0          # the first update runs at lr 0
    for k in init:
        np.testing.assert_allclose(mine[k].numpy(), np.asarray(params[k]),
                                   atol=OPT_ATOL, rtol=0, err_msg=k)


@pytest.mark.parametrize("weighted", [False, True, "sum"])
@pytest.mark.parametrize("kind,regression", [
    ("softmax", False), ("mse", True), ("gaussian_nll", True)])
def test_losses_match_reference(kind, regression, weighted):
    import jax.numpy as jnp

    from alink_tpu.dl.train import _loss_fn
    from alink_tpu_torch.dl.train import loss_fn

    g = np.random.default_rng(1)
    n = 9
    width = {"softmax": 3, "mse": 1, "gaussian_nll": 2}[kind]
    logits = g.standard_normal((n, width)).astype(np.float32)
    y = (g.integers(0, 3, n) if kind == "softmax"
         else g.standard_normal(n)).astype(np.float32)
    w = np.ones(n, np.float32)
    w[-2:] = 0.0
    ref_f = _loss_fn(kind, regression, weighted)
    got_f = loss_fn(kind, regression, weighted)
    args = (logits, y, w) if weighted else (logits, y)
    ref = float(ref_f(*map(jnp.asarray, args)))
    got = float(got_f(*map(torch.from_numpy, args)))
    assert abs(got - ref) <= LOSS_ATOL, (got, ref)


# ---------------------------------------------------------------------------
# one train step of a tiny BERT
# ---------------------------------------------------------------------------


def _bert_batch(b=8, s=16, vocab=64, seed=0, masked_row=False):
    g = np.random.default_rng(seed)
    ids = g.integers(0, vocab, (b, s)).astype(np.int32)
    mask = np.ones((b, s), np.int32)
    mask[1, s // 2:] = 0
    mask[2, 3:] = 0
    if masked_row:
        mask[3] = 0
    types = g.integers(0, 2, (b, s)).astype(np.int32)
    y = g.integers(0, 2, b).astype(np.int32)
    return {"input_ids": ids, "attention_mask": mask,
            "token_type_ids": types}, y


def _flax_tiny(batch, **kw):
    import jax
    import jax.numpy as jnp

    from alink_tpu.dl.modules import BertConfig, TransformerEncoder

    cfg = BertConfig.tiny(dtype=jnp.float32, vocab_size=64, max_position=32,
                          **kw)
    model = TransformerEncoder(cfg)
    params = model.init(jax.random.PRNGKey(0),
                        **{k: v[:1] for k, v in batch.items()})
    return model, jax.tree_util.tree_map(np.asarray, params)


def _torch_tiny(params, **kw):
    from alink_tpu_torch.dl.convert import flax_to_torch
    from alink_tpu_torch.dl.modules import BertConfig, TransformerEncoder

    cfg = BertConfig.tiny(dtype=torch.float32, vocab_size=64, max_position=32,
                          **kw)
    model = TransformerEncoder(cfg)
    model.load_state_dict(flax_to_torch(params))
    return model, cfg


def _knob_off(monkeypatch, fn, *a):
    """``fn(*a)`` on the reference's knob-off route."""
    monkeypatch.setenv("ALINK_ATTN_PALLAS", "0")
    try:
        return fn(*a)
    finally:
        monkeypatch.delenv("ALINK_ATTN_PALLAS")


@pytest.mark.parametrize("block,s", [(0, 16), (8, 20)])
def test_train_step_matches_reference(monkeypatch, block, s):
    """Loss, every gradient leaf and the parameters after two steps (the
    first runs at lr 0) of a tiny BERT, 2 zero-weight rows; on the blockwise
    route with a ragged S and a fully masked row. The steps take optax's
    sgd(momentum=0.9), whose update is linear in the gradient: adamw divides
    each element by its own magnitude, so the key bias, whose true gradient
    is zero (softmax is invariant to it), would turn rounding noise into
    ±lr steps in either package. adamw's arithmetic is held on its own
    above."""
    import jax
    import jax.numpy as jnp

    from alink_tpu.dl.train import TrainConfig as RefConfig
    from alink_tpu.dl.train import _loss_fn, _make_optimizer
    from alink_tpu.dl.train import make_train_step as ref_step
    from alink_tpu_torch.dl.convert import torch_to_flax
    from alink_tpu_torch.dl.train import (TrainConfig, loss_fn,
                                          make_optimizer, make_train_step)

    batch, y = _bert_batch(s=s, masked_row=bool(block))
    w = np.ones(len(y), np.float32)
    w[-2:] = 0.0
    kw = dict(attention_block_size=block)
    fmodel, params = _flax_tiny(batch, **kw)
    tc = dict(learning_rate=1e-2, warmup_ratio=0.1, optimizer="sgd")
    loss_of = _loss_fn("auto", False, weighted=True)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def run_ref():
        def loss(p):
            return loss_of(fmodel.apply({"params": p}, **jb,
                                        deterministic=True), y, w)

        l0, g0 = jax.value_and_grad(loss)(params["params"])
        tx = _make_optimizer(RefConfig(**tc), 10)
        step = ref_step(fmodel, tx, loss_of, weighted=True)
        v = jax.tree_util.tree_map(jnp.asarray, params)
        st = tx.init(v["params"])
        losses = []
        for _ in range(2):
            v, st, lv = step(v, st, jb, jnp.asarray(y), jnp.asarray(w))
            losses.append(float(lv))
        return (float(l0), jax.tree_util.tree_map(np.asarray, g0), losses,
                jax.tree_util.tree_map(np.asarray, v["params"]))

    l0, g0, ref_losses, ref_params = _knob_off(monkeypatch, run_ref)

    model, cfg = _torch_tiny(params, **kw)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    ty, tw = torch.from_numpy(y), torch.from_numpy(w)
    mine_loss = loss_fn("auto", False, weighted=True)
    loss = mine_loss(model(**tb), ty, tw)
    loss.backward()
    assert abs(loss.item() - l0) <= LOSS_ATOL
    grads = torch_to_flax({n: p.grad for n, p in model.named_parameters()},
                          cfg)["params"]
    _assert_trees_close(grads, g0, rtol=GRAD_RTOL, atol=GRAD_ATOL)

    params_t = dict(model.named_parameters())
    opt = make_optimizer(TrainConfig(**tc), 10, params_t)
    step = make_train_step(model, opt, mine_loss, weighted=True)
    losses = [float(step(tb, ty, tw)) for _ in range(2)]
    np.testing.assert_allclose(losses, ref_losses, atol=LOSS_ATOL, rtol=0)
    _assert_trees_close(torch_to_flax(model.state_dict(), cfg)["params"],
                        ref_params, atol=PARAM_ATOL, rtol=0)


# ---------------------------------------------------------------------------
# the flash kernel route's gradient
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("chunk_rows", [None, 5])
@pytest.mark.parametrize("label,s,causal", [
    ("masked", 24, False), ("causal", 24, True), ("ragged", 20, False)])
def test_flash_route_gradient_matches_jax_grad(monkeypatch, label, s, causal,
                                               chunk_rows):
    """dq, dk, dv of ``blockwise_attention``'s kernel route (the autograd
    Function around ``flash_blockwise``) against ``jax.grad`` of the
    reference's knob-off ``blockwise_attention``: a fully masked batch row,
    a partly masked one, blocks of 8; the backward's queries in one chunk,
    or in chunks of 5 rows."""
    import jax
    import jax.numpy as jnp

    from alink_tpu.dl.attention import blockwise_attention as ref_attn
    from alink_tpu_torch.dl import attn_cuda
    from alink_tpu_torch.dl.attention import blockwise_attention
    from alink_tpu_torch.native import kernels

    b, h, d = 3, 2, 8
    if chunk_rows:
        padded = -(-s // 8) * 8
        monkeypatch.setattr(attn_cuda, "BWD_CHUNK_ELEMS",
                            chunk_rows * b * h * padded)
    g = np.random.default_rng(7)
    q, k, v, ct = (g.standard_normal((b, s, h, d)).astype(np.float32)
                   for _ in range(4))
    mask = np.ones((b, s), np.int32)
    mask[0] = 0
    mask[1, 5:] = 0

    def f(q_, k_, v_):
        out = ref_attn(q_, k_, v_, jnp.asarray(mask), block_size=8,
                       causal=causal)
        return (out * ct).sum()

    ref = _knob_off(monkeypatch, lambda: jax.grad(f, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    before = kernels.launches()["flash_block_update"]
    out = blockwise_attention(tq, tk, tv, torch.from_numpy(mask),
                              block_size=8, causal=causal)
    (out * torch.from_numpy(ct)).sum().backward()
    assert kernels.launches()["flash_block_update"] == before   # CPU: plain
    for name, got, want in zip("qkv", (tq.grad, tk.grad, tv.grad), ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=ATTN_GRAD_ATOL, rtol=0,
                                   err_msg=f"d{name} [{label}]")
    # masked scores carry no gradient: batch row 0 attends to nothing
    assert float(tq.grad[0].abs().max()) == 0.0


# ---------------------------------------------------------------------------
# train_model
# ---------------------------------------------------------------------------


def _train_data(n=50, s=12, seed=3):
    """Rows with every position valid."""
    batch, _ = _bert_batch(b=n, s=s, seed=seed)
    batch["attention_mask"][:] = 1
    y = (batch["input_ids"][:, 0] % 2).astype(np.int32)
    return batch, y


@pytest.fixture(scope="module")
def reference_runs():
    """The reference's train_model over 2 epochs of 40 training rows in
    batches of 16 (a ragged tail of 8) with eval_ratio 0.2 from one flax
    init: adamw, sgd, and sgd with accum_steps=2 (micro)."""
    import jax

    from alink_tpu.dl.train import TrainConfig as RefConfig
    from alink_tpu.dl.train import train_model as ref_train

    os.environ["ALINK_ATTN_PALLAS"] = "0"
    try:
        inputs, y = _train_data()
        model, params = _flax_tiny(inputs)
        out = {}
        for opt, accum in (("adamw", 1), ("sgd", 1), ("sgd", 2)):
            tc = RefConfig(num_epochs=2, batch_size=16, eval_ratio=0.2,
                           learning_rate=3e-3, weight_decay=0.01, seed=5,
                           optimizer=opt, accum_steps=accum)
            p, hist = ref_train(model, inputs, y, tc, init_params=params)
            out[opt, accum] = (jax.tree_util.tree_map(np.asarray,
                                                      p["params"]), hist)
        return params, out
    finally:
        del os.environ["ALINK_ATTN_PALLAS"]


def _port_train(params, **kw):
    from alink_tpu_torch.dl.convert import torch_to_flax
    from alink_tpu_torch.dl.modules import BertConfig, TransformerEncoder
    from alink_tpu_torch.dl.train import TrainConfig, train_model

    inputs, y = _train_data()
    cfg = BertConfig.tiny(dtype=torch.float32, vocab_size=64, max_position=32)
    tc = dict(num_epochs=2, batch_size=16, eval_ratio=0.2, learning_rate=3e-3,
              weight_decay=0.01, seed=5)
    tc.update(kw)
    state, hist = train_model(TransformerEncoder(cfg), inputs, y,
                              TrainConfig(**tc), init_params=params)
    return state, torch_to_flax(state, cfg)["params"], hist


@pytest.mark.parametrize("opt", ["sgd", "adamw"])
def test_train_model_matches_reference(reference_runs, opt):
    """The history within 1e-5 of the reference's, and with sgd every final
    parameter too. adamw (the operators' optimizer) divides each gradient
    element by its own running magnitude, so an element whose step gradient
    is about zero (the attention's key bias always: softmax is invariant to
    it; elsewhere by cancellation) turns rounding noise into steps of up to
    lr in either package: its parameters are held through the history here
    and its arithmetic on fixed gradients above."""
    params, runs = reference_runs
    ref_params, ref_hist = runs[opt, 1]
    _, got, hist = _port_train(params, feed="sync", optimizer=opt)
    assert len(hist["loss"]) == 2 and len(hist["eval_metric"]) == 2
    np.testing.assert_allclose(hist["loss"], ref_hist["loss"],
                               atol=TRAIN_ATOL, rtol=0)
    np.testing.assert_allclose(hist["eval_metric"], ref_hist["eval_metric"],
                               atol=TRAIN_ATOL, rtol=0)
    assert abs(hist["final_loss"] - ref_hist["final_loss"]) <= TRAIN_ATOL
    if opt == "sgd":
        _assert_trees_close(got, ref_params, atol=TRAIN_ATOL, rtol=0)


def test_async_feed_gives_the_sync_run(reference_runs):
    params, _ = reference_runs
    sync, _, hist = _port_train(params, feed="sync", optimizer="sgd")
    asyn, _, hist_a = _port_train(params, feed="async", optimizer="sgd")
    # the async feed reports its transfer phases under "feed", as the
    # reference's does; the rest of the history is the sync run's
    feed = hist_a.pop("feed")
    assert "feed" not in hist
    assert feed["mode"] == "async" and feed["batches"] == 2 * 3
    assert hist == hist_a
    assert all(torch.equal(sync[k], asyn[k]) for k in sync)


def test_accumulation_micro_and_fused_bit_identical(reference_runs):
    """accum_steps=2: the port's micro and fused schedules bit-identical,
    and every parameter within 1e-5 of the reference's micro run (sgd,
    linear in the gradient)."""
    params, runs = reference_runs
    ref_params, ref_hist = runs["sgd", 2]
    kw = dict(optimizer="sgd", accum_steps=2)
    micro, got, hist = _port_train(params, accum_mode="micro", **kw)
    fused, _, hist_f = _port_train(params, accum_mode="fused", **kw)
    assert hist["loss"] == hist_f["loss"]
    assert all(torch.equal(micro[k], fused[k]) for k in micro)
    np.testing.assert_allclose(hist["loss"], ref_hist["loss"],
                               atol=TRAIN_ATOL, rtol=0)
    _assert_trees_close(got, ref_params, atol=TRAIN_ATOL, rtol=0)


def test_resumed_run_equals_uninterrupted(tmp_path):
    """A run that fails in its second epoch and is retried resumes from the
    first epoch's checkpoint (2 kept) and ends with the uninterrupted run's
    parameters and losses, bit for bit, dropout on."""
    from alink_tpu_torch.dl.checkpoint import (TrainCheckpointManager,
                                               run_with_retries)
    from alink_tpu_torch.dl.modules import BertConfig, TransformerEncoder
    from alink_tpu_torch.dl.train import TrainConfig, train_model

    inputs, y = _train_data()
    cfg = BertConfig.tiny(dtype=torch.float32, vocab_size=64, max_position=32,
                          dropout=0.1)

    def run(ckdir, crash_at=None):
        model = TransformerEncoder(cfg)
        calls = {"n": 0}
        forward = model.forward

        def flaky(*a, **kw):
            calls["n"] += 1
            if crash_at is not None and calls["n"] == crash_at:
                raise RuntimeError("injected failure")
            return forward(*a, **kw)

        model.forward = flaky
        tc = TrainConfig(num_epochs=3, batch_size=16, learning_rate=3e-3,
                         seed=2, checkpoint_dir=ckdir, checkpoint_keep=2)
        return train_model(model, inputs, y, tc)

    straight, hist = run(str(tmp_path / "a"))
    attempts = []
    resumed, hist_r = run_with_retries(
        lambda: run(str(tmp_path / "b"), crash_at=None if attempts else 7),
        retries=1, on_failure=lambda e, i: attempts.append(i))
    assert attempts == [0]
    assert all(torch.equal(straight[k], resumed[k]) for k in straight)
    assert hist_r["final_loss"] == hist["final_loss"]
    mgr = TrainCheckpointManager(str(tmp_path / "b"))
    assert mgr.all_steps() == [8, 12]     # 4 steps an epoch, 2 kept


def test_load_bert_checkpoint_returns_reference_tree():
    from alink_tpu.dl.pretrained import load_bert_checkpoint as ref_load
    from alink_tpu_torch.dl.data import data_path
    from alink_tpu_torch.dl.pretrained import load_bert_checkpoint

    path = data_path("bert_tiny_sst")
    cfg, tree = load_bert_checkpoint(path)
    ref_cfg, ref_tree = ref_load(path)
    assert cfg == ref_cfg
    got, want = _flat(tree), _flat(ref_tree)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k],
                                                                want[k]), k


def test_fresh_init_follows_flax_initialisers():
    """init_weights draws what flax's defaults draw: every kernel the
    truncated lecun_normal on its fan-in (bounded by 2 / 0.8796 of
    sqrt(1/fan_in)), embeddings normal with variance 1/dim, zero biases,
    LayerNorm ones; the same seed gives the same weights."""
    import jax

    from alink_tpu_torch.dl.convert import torch_to_flax
    from alink_tpu_torch.dl.modules import BertConfig, TransformerEncoder

    batch, _ = _bert_batch()
    _, ref = _flax_tiny(batch)
    cfg = BertConfig.tiny(dtype=torch.float32, vocab_size=64, max_position=32)
    model = TransformerEncoder(cfg).init_weights(3)
    again = TransformerEncoder(cfg).init_weights(3)
    assert all(torch.equal(a, b) for a, b in zip(model.state_dict().values(),
                                                 again.state_dict().values()))
    got, want = _flat(torch_to_flax(model.state_dict(), cfg)["params"]), \
        _flat(jax.tree_util.tree_map(np.asarray, ref)["params"])
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k]
        assert g.shape == w.shape, k
        if k.endswith("bias") or k.endswith("scale"):
            assert np.array_equal(g, w), k          # zeros and ones
            continue
        # the variance flax's initialiser gives the leaf: 1/fan_in for a
        # kernel, 1/dim for an embedding; a sample's std lies within 5
        # standard errors of it (1/sqrt(2n) relative), flax's own too
        std = (1 / g.shape[0 if k.endswith("kernel") else -1]) ** 0.5
        tol = 5 / (2 * g.size) ** 0.5
        for x in (g, w):
            assert abs(x.std() / std - 1) < tol, (k, x.std(), std)
        if k.endswith("kernel"):
            assert np.abs(g).max() <= 2 * std / 0.8796, k


def test_remat_replays_the_dropout_draws():
    """remat=True recomputes each layer in the backward pass with the same
    dropout masks: loss and gradients equal those without remat."""
    from alink_tpu_torch.dl.modules import BertConfig, TransformerEncoder
    from alink_tpu_torch.dl.train import dropout_generator, loss_fn

    batch, y = _bert_batch(s=20)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    out = []
    for remat in (False, True):
        cfg = BertConfig.tiny(dtype=torch.float32, vocab_size=64,
                              max_position=32, dropout=0.2, remat=remat,
                              attention_block_size=8)
        model = TransformerEncoder(cfg).init_weights(0)
        logits = model(**tb, deterministic=False,
                       rng=dropout_generator(0, 4, "cpu"))
        loss = loss_fn("softmax", False)(logits, torch.from_numpy(y))
        loss.backward()
        out.append((loss.item(), [p.grad.clone()
                                  for p in model.parameters()]))
    assert out[0][0] == out[1][0]
    assert all(torch.equal(a, b) for a, b in zip(out[0][1], out[1][1]))
