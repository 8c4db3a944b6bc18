"""Constrained optimization: augmented Lagrangian + log-barrier (port of
``alink_tpu.optim.constrained``).

Capability parity with the reference's constrained solver family (reference:
core/src/main/java/com/alibaba/alink/operator/common/optim/activeSet/Sqp.java,
barrierIcq/LogBarrier.java, divergence/Alm.java — used by constrained
logistic regression in binning/scorecard flows).

The outer multiplier/barrier loop runs host-side; every inner
minimization is the same L-BFGS (optim/optimizers.py) with the constraint
penalty attached as the objective's data-independent ``global_term``.
Linear constraints ``A_eq·w = b_eq`` and ``A_ub·w ≤ b_ub``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from .objfunc import ObjFunc
from .optimizers import OptimResult, optimize


def constrained_optimize(
    obj: ObjFunc,
    X,
    y,
    *,
    A_eq: Optional[np.ndarray] = None,
    b_eq: Optional[np.ndarray] = None,
    A_ub: Optional[np.ndarray] = None,
    b_ub: Optional[np.ndarray] = None,
    method: str = "alm",
    device=None,
    max_outer: int = 12,
    rho: float = 1.0,
    tol: float = 1e-6,
    inner_max_iter: int = 60,
    w0: Optional[np.ndarray] = None,
    **inner_kwargs,
) -> OptimResult:
    """Minimize the objective under linear constraints.

    method="alm": augmented Lagrangian (equality + inequality; reference
    Alm.java / Sqp.java active-set role). method="barrier": logarithmic
    barrier (inequality only; reference LogBarrier.java).
    """
    import torch

    from ..common.env import resolve_device

    device = resolve_device(device)

    def dev(a):
        return (torch.as_tensor(np.asarray(a, np.float32), device=device)
                if a is not None else None)

    A_eq_t, A_ub_t = dev(A_eq), dev(A_ub)
    b_eq_t = dev(b_eq) if A_eq is not None else None
    b_ub_t = dev(b_ub) if A_ub is not None else None

    if method == "barrier":
        if A_ub_t is None:
            raise ValueError("barrier method needs A_ub/b_ub")
        if A_eq_t is not None:
            raise ValueError("barrier method handles inequalities only")
        return _barrier(obj, X, y, A_ub_t, b_ub_t, device=device,
                        max_outer=max_outer, tol=tol,
                        inner_max_iter=inner_max_iter, w0=w0,
                        **inner_kwargs)
    if method != "alm":
        raise ValueError(f"unknown constrained method {method!r}")

    n_eq = 0 if A_eq is None else A_eq.shape[0]
    n_ub = 0 if A_ub is None else A_ub.shape[0]
    lam = np.zeros(n_eq, np.float32)
    mu = np.zeros(n_ub, np.float32)
    w = w0  # optional explicit start (objectives with a stationary origin)
    res = None
    prev_viol = np.inf
    cur_rho = float(rho)
    for _ in range(max_outer):
        lam_t, mu_t = dev(lam), dev(mu)
        r = float(np.float32(cur_rho))

        def penalty(wv, lam_t=lam_t, mu_t=mu_t, r=r):
            total = torch.zeros((), dtype=torch.float32, device=device)
            if A_eq_t is not None:
                c = A_eq_t @ wv - b_eq_t
                total = total + (lam_t * c).sum() + 0.5 * r * (c * c).sum()
            if A_ub_t is not None:
                g = A_ub_t @ wv - b_ub_t
                shifted = torch.clamp(mu_t + r * g, min=0.0)
                total = total + (shifted * shifted
                                 - mu_t * mu_t).sum() / (2.0 * r)
            return total

        aug = ObjFunc(obj.local_loss, obj.num_params, penalty)
        res = optimize(aug, X, y, w0=w, device=device,
                       max_iter=inner_max_iter, tol=tol, **inner_kwargs)
        w = res.weights
        viol = 0.0
        if A_eq is not None:
            c = A_eq @ w - b_eq
            lam = lam + cur_rho * c.astype(np.float32)
            viol = max(viol, float(np.abs(c).max()))
        if A_ub is not None:
            g = A_ub @ w - b_ub
            mu = np.maximum(0.0, mu + cur_rho * g).astype(np.float32)
            viol = max(viol, float(np.maximum(g, 0.0).max()))
        if viol < tol:
            break
        if viol > 0.5 * prev_viol:
            cur_rho *= 4.0  # slow progress: tighten the penalty
        prev_viol = viol
    return res


def _barrier(obj, X, y, A_ub_t, b_ub_t, *, device, max_outer, tol,
             inner_max_iter, w0=None, **inner_kwargs) -> OptimResult:
    """Interior-point log barrier: t grows geometrically; infeasible iterates
    are pushed back by a quadratic wall outside the feasible region
    (reference: barrierIcq/LogBarrier.java)."""
    import torch

    w = w0
    res = None
    t = 1.0
    for _ in range(max_outer):
        t_f = float(np.float32(t))

        def penalty(wv, t_f=t_f):
            slack = b_ub_t - A_ub_t @ wv
            # -log(slack)/t inside the feasible region; outside, a strong
            # quadratic wall NOT scaled by t (a 1/t-scaled extension stops
            # being a barrier once t grows)
            eps = 1e-6
            safe = torch.clamp(slack, min=eps)
            wall = 1e4 * (torch.clamp(eps - slack, min=0.0) ** 2).sum()
            return -torch.log(safe).sum() / t_f + wall

        aug = ObjFunc(obj.local_loss, obj.num_params, penalty)
        res = optimize(aug, X, y, w0=w, device=device,
                       max_iter=inner_max_iter, tol=tol, **inner_kwargs)
        w = res.weights
        if A_ub_t.shape[0] / t < tol:
            break
        t *= 8.0
    return res
