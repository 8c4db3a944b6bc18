"""Port parity: the BERT encoder, the weight carry-over and the flax msgpack
codec of ``alink_tpu_torch`` against ``alink_tpu``/flax on the CPU.

The encoder runs ``BertConfig.tiny`` in fp32 on both sides, initialised by
flax from ``PRNGKey(0)`` and carried across with ``flax_to_torch``. Logit
tolerance: atol 1e-4 in fp32 — the two frameworks sum matmuls, softmax and
LayerNorm statistics in different orders (measured gap about 4e-7 on logits
of magnitude below 1). Carry-over and codec round trips are exact.
"""

import numpy as np
import pytest
import torch

LOGIT_ATOL = 1e-4


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("ALINK_TORCH_DEVICE", "cpu")
    monkeypatch.delenv("ALINK_ATTN_PALLAS", raising=False)


def _batch(seed=0, b=3, s=24, vocab=512):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab, (b, s)).astype(np.int32)
    mask = np.ones((b, s), np.int32)
    mask[1, 10:] = 0
    mask[2, 3:] = 0
    types = rng.integers(0, 2, (b, s)).astype(np.int32)
    return ids, mask, types


def _flax_model(**kw):
    import jax
    import jax.numpy as jnp

    from alink_tpu.dl.modules import BertConfig, TransformerEncoder

    cfg = BertConfig.tiny(dtype=jnp.float32, **kw)
    model = TransformerEncoder(cfg)
    ids, mask, types = _batch()
    params = model.init(jax.random.PRNGKey(0), ids, mask, types)
    return model, jax.tree_util.tree_map(np.asarray, params)


def _torch_model(params, **kw):
    from alink_tpu_torch.dl.convert import flax_to_torch
    from alink_tpu_torch.dl.modules import BertConfig, TransformerEncoder

    model = TransformerEncoder(BertConfig.tiny(dtype=torch.float32, **kw))
    model.load_state_dict(flax_to_torch(params))
    return model.eval()


@pytest.mark.parametrize("block", [0, 8])
@pytest.mark.parametrize("pool", ["mean", "cls"])
def test_encoder_logits_match_flax(block, pool):
    kw = dict(attention_block_size=block, pool=pool)
    flax_model, params = _flax_model(**kw)
    ids, mask, types = _batch()
    ref = np.asarray(flax_model.apply(params, ids, mask, types,
                                      deterministic=True))
    model = _torch_model(params, **kw)
    with torch.no_grad():
        got = model(*map(torch.from_numpy, (ids, mask, types))).numpy()
    assert got.shape == ref.shape == (3, 2)
    np.testing.assert_allclose(got, ref, atol=LOGIT_ATOL)


@pytest.mark.parametrize("with_types", [True, False])
def test_regression_head_and_token_types_match_flax(with_types):
    kw = dict(regression=True, attention_block_size=8)
    flax_model, params = _flax_model(**kw)
    ids, mask, types = _batch(seed=5)
    tt = types if with_types else None
    ref = np.asarray(flax_model.apply(params, ids, mask, tt,
                                      deterministic=True))
    model = _torch_model(params, **kw)
    with torch.no_grad():
        got = model(torch.from_numpy(ids), torch.from_numpy(mask),
                    None if tt is None else torch.from_numpy(tt)).numpy()
    assert got.shape == (3, 1)
    np.testing.assert_allclose(got, ref, atol=LOGIT_ATOL)


def test_flax_to_torch_round_trip_is_exact():
    import jax

    from alink_tpu_torch.dl.convert import flax_to_torch, torch_to_flax
    from alink_tpu_torch.dl.modules import BertConfig

    _, params = _flax_model()
    back = torch_to_flax(flax_to_torch(params), BertConfig.tiny())
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(params)
    for a, b in zip(jax.tree_util.tree_leaves(params),
                    jax.tree_util.tree_leaves(back)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_flax_msgpack_decodes_and_encodes_flax_bytes():
    import jax
    from flax import serialization

    from alink_tpu_torch.common import flax_msgpack

    _, params = _flax_model()
    data = serialization.to_bytes(params)
    tree = flax_msgpack.loads(data)
    for a, b in zip(jax.tree_util.tree_leaves(params),
                    jax.tree_util.tree_leaves(tree)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    encoded = flax_msgpack.dumps(tree)
    assert encoded == data
    restored = serialization.from_bytes(params, encoded)
    for a, b in zip(jax.tree_util.tree_leaves(params),
                    jax.tree_util.tree_leaves(restored)):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_flax_msgpack_reads_bf16_leaves_and_scalars():
    import jax.numpy as jnp
    from flax import serialization

    from alink_tpu_torch.common import flax_msgpack

    rng = np.random.default_rng(3)
    w = rng.normal(size=(4, 5)).astype(np.float32)
    tree = {"a": {"w": jnp.asarray(w, jnp.bfloat16), "n": np.int64(-7),
                  "s": np.float32(2.5)}, "b": np.arange(300, dtype=np.int32)}
    got = flax_msgpack.loads(serialization.to_bytes(tree))
    np.testing.assert_array_equal(
        got["a"]["w"], np.asarray(jnp.asarray(w, jnp.bfloat16), np.float32))
    assert got["a"]["n"] == -7 and got["a"]["s"] == np.float32(2.5)
    np.testing.assert_array_equal(got["b"], tree["b"])
