"""The checks of chip_smoke.py, held on the CPU.

chip_smoke.py holds each CUDA kernel against its plain version on the card;
the flash block update first, the tree histogram at the end of the file.
Here the same checks run on CPU tensors, with the kernel's arithmetic
re-done in plain torch and rounded to the input type at the kernel's points.
That stand-in must pass; broken updates that mishandle the carried state
must not. Shapes are cut to B=2..4 from the card's B=32; the tolerances are
chip_smoke's own (fp32 atol 1e-5, bf16 bound of its module docstring).
"""

import numpy as np
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


# -- the tree histogram (phase 5) ------------------------------------------
#
# chip_smoke.check_histogram holds tree_histogram against histogram_ref at
# n = 522,911 rows of Covertype-layout bins. Here the same check runs at
# n = 3,001 (not a multiple of any power-of-two row chunk) with
# histogram_ref standing in for the kernel; three broken histograms must
# fail it, with integer vals (exact) and with normal vals (the summation
# bound of chip_smoke's histogram_mismatch).

HIST_N = 3001


@pytest.fixture(scope="module")
def covertype_bins():
    from alink_tpu_torch.tree.binning import apply_bins, quantile_bins

    X, y = chip_smoke.covertype_data(HIST_N, seed=0)
    return apply_bins(X, quantile_bins(X, 64))


def test_covertype_data_keeps_the_file_layout():
    X, y = chip_smoke.covertype_data(HIST_N, seed=0)
    assert X.shape == (HIST_N, 54) and X.dtype == np.float32
    assert len(chip_smoke.COVTYPE_COLS) == 54
    # one wilderness area and one soil type per row
    np.testing.assert_array_equal(X[:, 10:14].sum(1), 1.0)
    np.testing.assert_array_equal(X[:, 14:].sum(1), 1.0)
    assert set(np.unique(y)) == {0, 1} and 0.2 < y.mean() < 0.8


def _drop_ragged_chunk(ids, vals, S, chunk=512):
    from alink_tpu_torch.tree.hist_cuda import histogram_ref

    keep = ids.shape[0] // chunk * chunk
    return histogram_ref(ids[:keep], vals[:keep], num_segments=S)


def _clamp_out_of_range(ids, vals, S):
    from alink_tpu_torch.tree.hist_cuda import histogram_ref

    return histogram_ref(torch.where(ids >= S, S - 1, ids), vals,
                         num_segments=S)


def _swap_two_features(ids, vals, S):
    from alink_tpu_torch.tree.hist_cuda import histogram_ref

    out = histogram_ref(ids, vals, num_segments=S)
    return out[:, [1, 0] + list(range(2, out.shape[1]))]


def _hist_ratio(bins, level, kind, fn, oob=True):
    ids, S, vals = chip_smoke.histogram_inputs(bins, level, seed=level,
                                               device="cpu", oob=oob)
    got = fn(ids, vals[kind], S)
    return chip_smoke.histogram_mismatch(ids, vals[kind], S, got,
                                         exact=kind != "normal")[1]


@pytest.mark.parametrize("kind", ["g", "count", "normal"])
@pytest.mark.parametrize("level,oob", [(0, False), (0, True), (6, True),
                                       (11, True)])
def test_histogram_ref_passes_the_smoke_check(covertype_bins, level, oob,
                                              kind):
    from alink_tpu_torch.tree.hist_cuda import histogram

    def kernel(ids, vals, S):
        return histogram(ids, vals, num_segments=S)

    assert _hist_ratio(covertype_bins, level, kind, kernel, oob) <= 1.0


@pytest.mark.parametrize("kind", ["g", "normal"])
@pytest.mark.parametrize("mutant", [_drop_ragged_chunk, _clamp_out_of_range,
                                    _swap_two_features])
def test_histogram_smoke_check_rejects_broken_histograms(covertype_bins,
                                                         mutant, kind):
    assert _hist_ratio(covertype_bins, 6, kind, mutant) > 1.0


def test_predict_oracle_matches_the_ensemble():
    from alink_tpu_torch.tree import train_forest

    X, y = chip_smoke.covertype_data(HIST_N, seed=1)
    ens = train_forest(X, y.astype(np.float32), task="binary", num_trees=4,
                       depth=5, num_bins=64)
    np.testing.assert_allclose(ens.raw_predict(X),
                               chip_smoke.predict_numpy(ens, X), rtol=0,
                               atol=1e-6)
