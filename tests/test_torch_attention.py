"""Port parity: the flash block update and the attention functions of
``alink_tpu_torch`` against ``alink_tpu`` on the CPU.

Inputs come from a numpy seed and go to both packages as arrays. The JAX
kernel runs in Pallas interpret mode, as the reference's own tests run it on
the CPU; the port's wrapper takes its plain version because the tensors lie
on the CPU. Tolerances are fp32: atol 1e-5 for the block update (the
reference kernel's own contract, tests/test_kernels.py) and atol 2e-5 for the
attention outputs (the reference's blockwise-vs-full contract).
"""

import numpy as np
import pytest
import torch

BLOCK_ATOL = 1e-5
ATTN_ATOL = 2e-5


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("ALINK_TORCH_DEVICE", "cpu")
    monkeypatch.delenv("ALINK_ATTN_PALLAS", raising=False)


def _block_inputs(seed=1, B=2, H=3, Q=5, D=7, K=11, fresh=False):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, H, Q, D)).astype(np.float32)
    k = rng.normal(size=(B, H, K, D)).astype(np.float32)
    v = rng.normal(size=(B, H, K, D)).astype(np.float32)
    kvalid = rng.integers(0, 2, size=(B, K)).astype(np.int32)
    kvalid[0] = 0        # one batch row fully masked
    ok = rng.integers(0, 2, size=(Q, K)).astype(np.int32)
    o = rng.normal(size=(B, H, Q, D)).astype(np.float32)
    if fresh:            # the first block: accumulators at their start
        m = np.full((B, H, Q), -1e30, np.float32)
        l = np.zeros((B, H, Q), np.float32)
    else:
        m = rng.normal(size=(B, H, Q)).astype(np.float32)
        m[:, :, :2] = -1e30
        l = rng.uniform(0.5, 2.0, size=(B, H, Q)).astype(np.float32)
    return q, k, v, kvalid, ok, o, m, l


@pytest.mark.parametrize("fresh", [True, False])
def test_flash_block_update_matches_jax(fresh):
    import jax.numpy as jnp

    from alink_tpu.dl.attention import _NEG_INF, _online_softmax_update
    from alink_tpu.dl.attn_pallas import flash_block_update as jax_fbu
    from alink_tpu_torch.dl.attn_cuda import flash_block_update

    q, k, v, kvalid, ok, o, m, l = _block_inputs(fresh=fresh)
    scale = float(q.shape[-1]) ** -0.5
    got = [t.numpy() for t in flash_block_update(
        *map(torch.from_numpy, (q, k, v, kvalid, ok, o, m, l)), scale=scale)]

    kern = jax_fbu(*map(jnp.asarray, (q, k, v, kvalid, ok, o, m, l)),
                   scale=scale, interpret=True)
    s = jnp.einsum("bhqd,bhkd->bhqk", q, k).astype(jnp.float32) * scale
    s = jnp.where(kvalid[:, None, None, :] > 0, s, _NEG_INF)
    s = jnp.where(ok[None, None] > 0, s, _NEG_INF)
    o2, m2, l2 = _online_softmax_update(
        jnp.asarray(o).transpose(0, 2, 1, 3), jnp.asarray(m), jnp.asarray(l),
        s, jnp.asarray(v).transpose(0, 2, 1, 3), jnp.float32)
    plain = (o2.transpose(0, 2, 1, 3), m2, l2)
    for ref in (kern, plain):
        for a, b in zip(got, ref):
            np.testing.assert_allclose(a, np.asarray(b), atol=BLOCK_ATOL)
    assert np.isfinite(got[0]).all()


def test_wrapper_takes_plain_version_only_for_cpu_tensors(monkeypatch):
    # a tensor off the CPU goes to the kernel, whose failure propagates:
    # nothing falls back to the plain version
    from alink_tpu_torch.dl import attn_cuda
    from alink_tpu_torch.native import kernels

    calls = []

    def no_kernel():
        calls.append(1)
        raise RuntimeError("kernel unavailable")

    monkeypatch.setattr(kernels, "ops", no_kernel)
    kernels.reset_launches()
    args = _block_inputs()
    cpu = [torch.from_numpy(a) for a in args]
    attn_cuda.flash_block_update(*cpu, scale=0.5)
    assert calls == [] and kernels.launches()["flash_block_update"] == 0
    meta = [t.to("meta") for t in cpu]
    with pytest.raises(RuntimeError, match="kernel unavailable"):
        attn_cuda.flash_block_update(*meta, scale=0.5)
    assert calls == [1] and kernels.launches()["flash_block_update"] == 0


def _attn_inputs(with_mask, seed=2, b=4, s=32, h=2, d=8):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(b, s, h, d)).astype(np.float32)
               for _ in range(3))
    mask = rng.integers(0, 2, size=(b, s)).astype(np.int32) \
        if with_mask else None
    return q, k, v, mask


def _t(x):
    return None if x is None else torch.from_numpy(x)


@pytest.mark.parametrize("causal,with_mask", [(False, False), (False, True),
                                              (True, False), (True, True)])
def test_blockwise_attention_matches_jax(monkeypatch, causal, with_mask):
    import jax.numpy as jnp

    from alink_tpu.dl.attention import blockwise_attention as jax_bw
    from alink_tpu_torch.dl.attention import blockwise_attention

    q, k, v, mask = _attn_inputs(with_mask)
    jm = None if mask is None else jnp.asarray(mask)
    monkeypatch.setenv("ALINK_ATTN_PALLAS", "0")
    jax_off = np.asarray(jax_bw(q, k, v, jm, block_size=8, causal=causal))
    port_off = blockwise_attention(_t(q), _t(k), _t(v), _t(mask),
                                   block_size=8, causal=causal).numpy()
    monkeypatch.setenv("ALINK_ATTN_PALLAS", "1")
    jax_on = np.asarray(jax_bw(q, k, v, jm, block_size=8, causal=causal))
    port_on = blockwise_attention(_t(q), _t(k), _t(v), _t(mask),
                                  block_size=8, causal=causal).numpy()
    for port in (port_on, port_off):
        for ref in (jax_off, jax_on):
            np.testing.assert_allclose(port, ref, atol=ATTN_ATOL)


@pytest.mark.parametrize("causal,with_mask", [(False, False), (False, True),
                                              (True, False), (True, True)])
def test_full_attention_matches_jax(causal, with_mask):
    import jax.numpy as jnp

    from alink_tpu.dl.attention import blockwise_attention as jax_bw
    from alink_tpu.dl.attention import full_attention as jax_full
    from alink_tpu_torch.dl.attention import blockwise_attention, full_attention

    q, k, v, mask = _attn_inputs(with_mask)
    jm = None if mask is None else jnp.asarray(mask)
    ref = np.asarray(jax_full(q, k, v, jm, causal=causal))
    got = full_attention(_t(q), _t(k), _t(v), _t(mask), causal=causal).numpy()
    np.testing.assert_allclose(got, ref, atol=ATTN_ATOL)
    # a ragged last block (32 keys in blocks of 12): its padded keys count
    # on fully masked rows exactly as they do in the reference
    ref_bw = np.asarray(jax_bw(q, k, v, jm, block_size=12, causal=causal))
    bw = blockwise_attention(_t(q), _t(k), _t(v), _t(mask), block_size=12,
                             causal=causal).numpy()
    np.testing.assert_allclose(bw, ref_bw, atol=ATTN_ATOL)


# the fused route's plain version against the reference, on the cases that
# pin its padding, layout and masking rules; S = 30 in blocks of 8 leaves
# two zero keys in the last block, which count on the fully masked row
FUSED_CASES = {
    "ragged_masked_row": dict(causal=False, views=False),
    "strided_views": dict(causal=False, views=True),
    "causal_masked": dict(causal=True, views=True),
}


def _fused_inputs(views, seed=5, b=3, s=30, h=2, d=8):
    rng = np.random.default_rng(seed)
    qkv = rng.normal(size=(b, s, 3, h, d)).astype(np.float32)
    mask = rng.integers(0, 2, size=(b, s)).astype(np.int32)
    mask[0] = 0                      # a fully masked batch row
    mask[1, :3] = 1
    arrays = [np.ascontiguousarray(qkv[:, :, i]) for i in range(3)]
    if views:                        # as SelfAttention.forward hands them over
        tensors = list(torch.from_numpy(qkv).unbind(dim=2))
        assert tensors[0].stride(1) == 3 * h * d
    else:
        tensors = [torch.from_numpy(x) for x in arrays]
    return arrays, tensors, mask


@pytest.mark.parametrize("case", sorted(FUSED_CASES))
def test_flash_blockwise_matches_jax(monkeypatch, case):
    import jax.numpy as jnp

    from alink_tpu.dl.attention import blockwise_attention as jax_bw
    from alink_tpu_torch.dl.attention import blockwise_attention
    from alink_tpu_torch.dl.attn_cuda import flash_blockwise

    causal = FUSED_CASES[case]["causal"]
    (q, k, v), (tq, tk, tv), mask = _fused_inputs(FUSED_CASES[case]["views"])
    refs = []
    for knob in ("1", "0"):          # Pallas interpret mode, then plain XLA
        monkeypatch.setenv("ALINK_ATTN_PALLAS", knob)
        refs.append(np.asarray(jax_bw(q, k, v, jnp.asarray(mask),
                                      block_size=8, causal=causal)))
    monkeypatch.setenv("ALINK_ATTN_PALLAS", "1")
    got = [flash_blockwise(tq, tk, tv, torch.from_numpy(mask), block_size=8,
                           causal=causal, scale=8 ** -0.5).numpy(),
           blockwise_attention(tq, tk, tv, torch.from_numpy(mask),
                               block_size=8, causal=causal).numpy()]
    monkeypatch.setenv("ALINK_ATTN_PALLAS", "0")
    got.append(blockwise_attention(tq, tk, tv, torch.from_numpy(mask),
                                   block_size=8, causal=causal).numpy())
    for port in got:
        for ref in refs:
            np.testing.assert_allclose(port, ref, atol=ATTN_ATOL)
    # the fully masked row averages v over all 32 keys of the 4 blocks, the
    # two zero keys included
    np.testing.assert_allclose(got[0][0], np.broadcast_to(
        v[0].sum(0) / 32, got[0][0].shape), atol=ATTN_ATOL)


class _FakeOps:
    """Stands in for torch.ops.alink_tpu_torch: records each launch."""

    def __init__(self):
        self.calls = []

    def flash_blockwise(self, q, k, v, kmask, block_size, causal, scale):
        self.calls.append((q, k, v, kmask, block_size, causal, scale))
        return torch.empty_like(q)


def test_kernel_route_launches_once_on_the_qkv_views(monkeypatch):
    # off the CPU the kernel route is one launch per attention call, on q, k
    # and v exactly as handed over (no copies) and no per-block masks
    from alink_tpu_torch.dl.attention import blockwise_attention
    from alink_tpu_torch.native import kernels

    fake = _FakeOps()
    monkeypatch.setattr(kernels, "ops", lambda: fake)
    kernels.reset_launches()
    qkv = torch.empty((2, 40, 3, 4, 16), dtype=torch.bfloat16, device="meta")
    q, k, v = qkv.unbind(dim=2)
    mask = torch.ones((2, 40), dtype=torch.bool, device="meta")
    out = blockwise_attention(q, k, v, mask, block_size=16, causal=True)
    assert out.shape == q.shape and kernels.launches()["flash_block_update"] == 1
    (cq, ck, cv, km, bs, causal, scale), = fake.calls
    assert cq is q and ck is k and cv is v
    assert km.dtype == torch.int32 and km.shape == (2, 40)
    assert (bs, causal, scale) == (16, True, 0.25)


def test_encoder_makes_one_launch_per_layer(monkeypatch):
    from alink_tpu_torch.dl.modules import BertConfig, TransformerEncoder
    from alink_tpu_torch.native import kernels

    fake = _FakeOps()
    monkeypatch.setattr(kernels, "ops", lambda: fake)
    kernels.reset_launches()
    with torch.device("meta"):
        model = TransformerEncoder(BertConfig.tiny(num_layers=3,
                                                   attention_block_size=16))
        ids = torch.zeros((2, 40), dtype=torch.int64)
        model(ids, torch.ones((2, 40), dtype=torch.int32))
    assert kernels.launches()["flash_block_update"] == 3 == len(fake.calls)


def test_ring_attention_not_ported():
    from alink_tpu_torch.common.exceptions import AkUnsupportedOperationException
    from alink_tpu_torch.dl.attention import ring_attention

    q = torch.zeros(1, 4, 1, 2)
    with pytest.raises(AkUnsupportedOperationException):
        ring_attention(q, q, q)
