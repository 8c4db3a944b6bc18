"""The checks of chip_smoke.py, held on the CPU.

chip_smoke.py holds the CUDA kernel against its plain version on the card.
Here the same checks run on CPU tensors, with the kernel's arithmetic
re-done in plain torch and rounded to the input type at the kernel's points.
That stand-in must pass; broken updates that mishandle the carried state
must not. Shapes are cut to B=2..4 from the card's B=32; the tolerances are
chip_smoke's own (fp32 atol 1e-5, bf16 bound of its module docstring).
"""

import pytest
import torch

import chip_smoke
from alink_tpu_torch.dl.attn_cuda import NEG_INF

SCALE = 64 ** -0.5


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("ALINK_TORCH_DEVICE", "cpu")
    monkeypatch.delenv("ALINK_ATTN_PALLAS", raising=False)


def kernel_like(q, k, v, kvalid, ok, o, m, l, *, scale, mutant=None):
    """The kernel's update in plain torch; ``mutant`` breaks it on purpose:
    "drop_state" ignores the incoming o and l, "corr_one" never rescales.
    With bf16 inputs the sums run in fp64, in another order than the plain
    version's fp32 sums, so some scores land across a bf16 rounding boundary
    as the kernel's do; with fp32 inputs they run as the plain version's do
    (a more exact fp64 sum of 128 terms of size ~30 moves o by ~1e-5, the
    whole of the fp32 contract)."""
    def rnd(x):
        return x.to(q.dtype).float()

    acc = torch.float64 if q.dtype == torch.bfloat16 else torch.float32
    s = rnd(torch.einsum("bhqd,bhkd->bhqk", q.to(acc), k.to(acc)).float())
    s = s * scale
    s = torch.where((kvalid[:, None, None, :] > 0) & (ok[None, None] > 0),
                    s, NEG_INF)
    m_new = torch.maximum(m, s.amax(dim=-1))
    corr = torch.exp(torch.clamp(m - m_new, min=NEG_INF))
    if mutant == "corr_one":
        corr = torch.ones_like(corr)
    p = torch.exp(s - m_new[..., None])
    pv = rnd(torch.einsum("bhqk,bhkd->bhqd", rnd(p).to(acc),
                          v.to(acc)).float())
    lsum = p.to(acc).sum(dim=-1).float()
    if mutant == "drop_state":
        return pv, m_new, lsum
    return o * corr[..., None] + pv, m_new, l * corr + lsum


def _mismatch(dtype, fresh, causal=False, K=128, mutant=None):
    args = chip_smoke.block_inputs(3, 2, 128, K, 64, dtype, causal=causal,
                                   fresh=fresh, seed=7, device="cpu")
    got = kernel_like(*args, scale=SCALE, mutant=mutant)
    return max(chip_smoke.block_mismatch(args, got, SCALE)[1].values())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("fresh,causal,K", [(True, False, 128),
                                            (False, False, 128),
                                            (False, True, 100)])
def test_kernel_arithmetic_passes_the_smoke_check(dtype, fresh, causal, K):
    assert _mismatch(dtype, fresh, causal, K) <= 1.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mutant", ["drop_state", "corr_one"])
def test_smoke_check_rejects_a_mishandled_carried_state(dtype, mutant):
    assert _mismatch(dtype, fresh=False, mutant=mutant) > 1.0


def test_blockwise_kernel_route_passes_the_smoke_check():
    from alink_tpu_torch.dl.attention import blockwise_attention

    q, k, v, mask = chip_smoke.attn_inputs(4, 256, 2, 64, torch.bfloat16,
                                           seed=3, device="cpu")
    got = blockwise_attention(q, k, v, mask, block_size=64)
    assert chip_smoke.blockwise_mismatch(q, k, v, mask, got, 64)[1] <= 1.0


def test_card_peaks_refuses_an_unknown_card():
    assert chip_smoke.card_peaks("NVIDIA H100 80GB HBM3")[0] == "H100"
    with pytest.raises(SystemExit):
        chip_smoke.card_peaks("NVIDIA A100-SXM4-80GB")
