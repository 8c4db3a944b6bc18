"""Batched-lane likelihood fits of the timeseries family: ARIMA's conditional
sum of squares, GARCH(p, q)'s Gaussian likelihood and Holt-Winters'
smoothing, each for many series and candidate orders at once.

The reference runs each fit as a ``lax.scan`` over the series inside 400
optax-Adam steps under ``jax.grad``, one compiled program per (p, q). Here a
*lane* is one (series, order) fit: every lane of a call shares one padded
time axis, coefficients beyond a lane's order are masked to zero (their
gradient is zero, so Adam never moves them), and a lane's start and end are
masks too. One Adam loop then runs all lanes on the device.

The recurrences of ARIMA (the MA part of the residuals) and GARCH (the
conditional variance) are linear with constant coefficients,
``x_t = u_t + Σ_j c_j·x_{t-1-j}``, so :func:`linear_recurrence` evaluates
them in ⌈log₂ n⌉ steps: a Hillis–Steele scan of the companion matrix's
powers, ``S_t ← S_t + A^d·S_{t-d}`` for d = 1, 2, 4, ... Autograd
differentiates the scan; the step loop never reads the device. Holt-Winters
needs no gradient: its smoothing is a loop over t on a (lanes,) state, every
grid point a lane.

Everything runs in float64 where the reference runs float32 (ROADMAP,
"Differences by design"): the card and the CPU sum in other orders, and in
float32 400 Adam steps carry that into the fitted orders and grid points.
Each lane's arithmetic is elementwise but for sums over its own time axis,
so a lane of a batch equals its one-lane fit up to the order of those sums.
"""

from __future__ import annotations

from typing import Callable, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..common.env import resolve_device

DT = torch.float64


def lag(x: torch.Tensor, k: int) -> torch.Tensor:
    """``x`` (lanes, n) shifted k steps later along time, zeros in front."""
    return F.pad(x[:, :x.shape[1] - k], (k, 0))


def linear_recurrence(u: torch.Tensor, coefs: torch.Tensor) -> torch.Tensor:
    """``x_t = u_t + Σ_j coefs[:, j]·x_{t-1-j}`` with ``x_s = 0`` for s < 0,
    for every lane at once: ``u`` (lanes, n), ``coefs`` (lanes, q).

    The state ``S_t = (x_t, ..., x_{t-q+1})`` follows ``S_t = A·S_{t-1} +
    e₁·u_t`` with A the companion matrix of ``coefs``; after the scan's
    levels d = 1, 2, 4, ... ``S_t = Σ_k A^k·e₁·u_{t-k}``."""
    lanes, n = u.shape
    q = coefs.shape[1]
    if q == 0:
        return u
    shift = torch.eye(q - 1, q, dtype=u.dtype, device=u.device)
    A = torch.cat([coefs[:, None, :],
                   shift.expand(lanes, q - 1, q)], dim=1)      # (lanes, q, q)
    S = F.pad(u[..., None], (0, q - 1))                        # (lanes, n, q)
    d = 1
    while d < n:
        S = S + F.pad(S[:, :n - d] @ A.transpose(1, 2), (0, 0, d, 0))
        d *= 2
        if d < n:
            A = A @ A
    return S[..., 0]


def adam_fit(loss_of: Callable[[torch.Tensor], torch.Tensor],
             params0: torch.Tensor, steps: int, lr: float) -> torch.Tensor:
    """optax ``adam(lr)`` for ``steps`` steps on ``params0`` (lanes, k),
    minimising every lane's own ``loss_of(params)[lane]`` (their sum has
    the lanes' own gradients). Returns the final parameters, detached."""
    from ..dl.train import Optimizer

    p = params0.detach().clone().requires_grad_(True)
    opt = Optimizer("adam", lambda _count: lr, {"p": p})
    for _ in range(steps):
        (g,) = torch.autograd.grad(loss_of(p).sum(), [p])
        opt.step([g])
    return p.detach()


def pad_series(series: Sequence[np.ndarray], device) -> Tuple[
        torch.Tensor, torch.Tensor]:
    """(lanes, N) float64 series padded with zeros to the longest, and the
    lengths (lanes,) as an int64 tensor, on ``device``."""
    N = max(len(s) for s in series)
    W = np.zeros((len(series), N), np.float64)
    for i, s in enumerate(series):
        W[i, :len(s)] = s
    n = torch.as_tensor([len(s) for s in series], device=device)
    return torch.as_tensor(W, device=device), n


def _span_mask(start: torch.Tensor, end: torch.Tensor, N: int) -> torch.Tensor:
    t = torch.arange(N, device=start.device)
    return ((t[None, :] >= start[:, None])
            & (t[None, :] < end[:, None])).to(DT)


def _order_masks(orders: Sequence[int], width: int, device) -> torch.Tensor:
    k = np.arange(width)[None, :] < np.asarray(orders)[:, None]
    return torch.as_tensor(k.astype(np.float64), device=device)


# ---------------------------------------------------------------------------
# ARIMA: conditional sum of squares
# ---------------------------------------------------------------------------


def arma_css_fit_lanes(ws: Sequence[np.ndarray], ps: Sequence[int],
                       qs: Sequence[int], device, steps: int = 400,
                       lr: float = 0.05):
    """CSS fits of ARMA(p, q) on each (differenced) series ``ws[i]`` at
    order ``(ps[i], qs[i])`` (reference: ``_arma_css_fit``). The residual
    recursion starts at ``m = max(p, q)`` with zero histories, exactly as
    the reference's scan. Returns float64 host arrays ``(c (lanes,),
    phi (lanes, P), theta (lanes, Q), sigma2 (lanes,))``; entries beyond a
    lane's order are 0. ``device``: see
    :func:`~alink_tpu_torch.common.env.resolve_device`."""
    device = resolve_device(device)
    P, Q = max(ps), max(qs)
    W, n = pad_series(ws, device)
    N = W.shape[1]
    m = torch.as_tensor(np.maximum(ps, qs), device=device)
    valid = _span_mask(m, n, N)
    Wv = W * valid
    lags = [lag(Wv, i + 1) for i in range(P)]
    denom = (n - m).to(DT)
    pm = _order_masks(ps, P, device)
    qm = _order_masks(qs, Q, device)

    def css(params):
        a = W - params[:, :1]
        for i in range(P):
            a = a - (params[:, 1 + i:2 + i] * pm[:, i:i + 1]) * lags[i]
        a = a * valid
        e = linear_recurrence(a, -(params[:, 1 + P:] * qm))
        return (e * e * valid).sum(1) / denom

    params0 = torch.zeros((len(ws), 1 + P + Q), dtype=DT, device=device)
    params0[:, 0] = torch.as_tensor([float(w.mean()) for w in ws],
                                    dtype=DT, device=device)
    params = adam_fit(css, params0, steps, lr)
    with torch.no_grad():
        sigma2 = css(params)
    out = params.cpu().numpy()
    return (out[:, 0], out[:, 1:1 + P] * pm.cpu().numpy(),
            out[:, 1 + P:] * qm.cpu().numpy(), sigma2.cpu().numpy())


# ---------------------------------------------------------------------------
# GARCH(p, q): Gaussian negative log-likelihood
# ---------------------------------------------------------------------------


def softplus(x):
    """jax's ``nn.softplus``: ``logaddexp(x, 0)``."""
    return torch.logaddexp(x, torch.zeros_like(x))


def garch_fit_lanes(rs: Sequence[np.ndarray], ps: Sequence[int],
                    qs: Sequence[int], device, steps: int,
                    lr: float = 0.05, alpha_scale=None, beta_scale=None,
                    start=None, seed_r2: bool = True):
    """GARCH(p, q) fits of demeaned returns ``rs[i]``:
    ``h_t = ω + Σ_i α_i·r̃²_{t-1-i} + Σ_j β_j·h_{t-1-j}``, loss
    ``Σ_t ½(log h_t + r_t²/h_t)`` over t from ``start[i]``, with
    ``ω = softplus(θ₀)·var0·0.1``, ``α_i = σ(θ)·alpha_scale[i]``,
    ``β_j = σ(θ)·beta_scale[i]``. Before ``start`` the histories are
    ``var0 = var(r) + 1e-8`` (``h``, and ``r̃²`` with ``seed_r2``), as the
    reference's scans seed them. ``GarchBatchOp``'s (1, 1) fit is ``start
    = 1``, scales 0.5 and 1, ``r̃² = r²`` (``timeseries.py``);
    ``AutoGarchBatchOp``'s is ``start = max(p, q, 1)``, scales ``0.5/p``
    and ``1/max(q, 1)``, ``seed_r2``. Returns the parameters
    (lanes, 1+P+Q), the final losses (lanes,) and var0 (lanes,), float64 on
    the host."""
    device = resolve_device(device)
    P, Q = max(ps), max(qs)
    R, n = pad_series(rs, device)
    N = R.shape[1]
    var0 = torch.as_tensor([float(np.var(r)) + 1e-8 for r in rs],
                           dtype=DT, device=device)[:, None]
    m = torch.as_tensor(start, device=device)
    valid = _span_mask(m, n, N)
    r2 = R * R
    # r̃²_s: r_s², or var0 before the start under seed_r2
    r2t = torch.where((valid > 0) | (not seed_r2), r2, var0.expand(-1, N))
    r2lags = [lag(r2t, i + 1) for i in range(P)]
    # β_j·h_{t-1-j} with t-1-j before the start: var0, added into u_t
    seeds = [((torch.arange(N, device=device)[None, :] - 1 - j)
              < m[:, None]).to(DT) * var0 for j in range(Q)]
    pm = _order_masks(ps, P, device) * torch.as_tensor(
        np.asarray(alpha_scale, np.float64)[:, None], device=device)
    qm = _order_masks(qs, Q, device) * torch.as_tensor(
        np.asarray(beta_scale, np.float64)[:, None], device=device)

    def nll(params):
        omega = softplus(params[:, :1]) * var0 * 0.1
        alphas = torch.sigmoid(params[:, 1:1 + P]) * pm
        betas = torch.sigmoid(params[:, 1 + P:]) * qm
        u = omega.expand(-1, N)
        for i in range(P):
            u = u + alphas[:, i:i + 1] * r2lags[i]
        for j in range(Q):
            u = u + betas[:, j:j + 1] * seeds[j]
        h = linear_recurrence(u * valid, betas)
        hv = torch.where(valid > 0, h, torch.ones_like(h))
        return (0.5 * (torch.log(hv) + r2 / hv) * valid).sum(1)

    params0 = torch.zeros((len(rs), 1 + P + Q), dtype=DT, device=device)
    params = adam_fit(nll, params0, steps, lr)
    with torch.no_grad():
        final = nll(params)
    return (params.cpu().numpy(), final.cpu().numpy(),
            var0[:, 0].cpu().numpy())


# ---------------------------------------------------------------------------
# Holt-Winters: additive smoothing over every lane
# ---------------------------------------------------------------------------


def holt_winters_lanes(ys: np.ndarray, abg: np.ndarray, level0: np.ndarray,
                       trend0: np.ndarray, season0: np.ndarray,
                       do_trend: bool, do_seasonal: bool, device):
    """The reference's smoothing scan for every lane: ``ys`` (lanes, n),
    ``abg`` (lanes, 3) the (α, β, γ) of each lane, ``level0``/``trend0``
    (lanes,) and ``season0`` (lanes, freq) the initial state. The season is
    a ring: the entry read at t is the one written ``freq`` steps before.
    Returns (sse, level, trend, season) as float64 host arrays, the season
    in the reference's order (its entry k is used k+1 steps ahead)."""
    device = resolve_device(device)
    y = torch.as_tensor(ys, dtype=DT, device=device)
    lanes, n = y.shape
    a, b, g = (torch.as_tensor(abg[:, k], dtype=DT, device=device)
               for k in range(3))
    level = torch.as_tensor(level0, dtype=DT, device=device).clone()
    trend = torch.as_tensor(trend0, dtype=DT, device=device).clone()
    buf = torch.as_tensor(season0, dtype=DT, device=device).clone()
    freq = buf.shape[1]
    sse = torch.zeros(lanes, dtype=DT, device=device)
    zero = torch.zeros_like(level)
    for t in range(n):
        yt = y[:, t]
        s_t = buf[:, t % freq] if do_seasonal else zero
        err = yt - (level + trend + s_t)
        sse = sse + err * err
        new_level = a * (yt - s_t) + (1 - a) * (level + trend)
        trend = (b * (new_level - level) + (1 - b) * trend) if do_trend \
            else zero
        if do_seasonal:
            buf[:, t % freq] = g * (yt - new_level) + (1 - g) * s_t
        level = new_level
    season = torch.roll(buf, -(n % freq), dims=1)
    return (sse.cpu().numpy(), level.cpu().numpy(), trend.cpu().numpy(),
            season.cpu().numpy())
