"""First/second-order optimizers (port of ``alink_tpu.optim.optimizers``).

Capability parity with the reference's optimizer framework (reference:
core/src/main/java/com/alibaba/alink/operator/common/optim/ — Lbfgs.java:33,79-101
(two-loop recursion at :106+), Owlqn.java, Gd.java, Sgd.java, Newton.java,
OptimizerFactory.java, with ICQ sub-steps optim/subfunc/* (Preallocate*,
CalcGradient, CalcLosses, UpdateModel, IterTermination) and AllReduce between
each).

The reference runs the whole optimization as one ``lax.while_loop``. Here
each iteration is a few eager tensor ops on the device, issued from a
Python loop that waits on the device once per iteration: to read the
convergence flag. Nothing else in an iteration syncs — the two-loop
recursion runs over the iteration count the host already knows, and the
line search evaluates all ``num_search_step`` candidate steps in one
batched pass (``torch.func.vmap`` of the objective, the analog of the
reference's CalcLosses) and picks the first Armijo candidate with
``argmax`` on the device.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np

from ..common.linalg import SparseBlock
from ..parallel.comqueue import shard_rows
from .objfunc import ObjFunc


class OptimResult(NamedTuple):
    weights: np.ndarray
    loss: float
    grad_norm: float
    num_iters: int


_METHODS = ("lbfgs", "owlqn", "gd", "sgd", "newton")


def optimize(
    obj: ObjFunc,
    X,
    y: np.ndarray,
    w0: Optional[np.ndarray] = None,
    sample_weights: Optional[np.ndarray] = None,
    *,
    device=None,
    method: str = "lbfgs",
    max_iter: int = 100,
    l1: float = 0.0,
    l2=0.0,
    tol: float = 1e-6,
    learning_rate: float = 0.1,
    history: int = 10,
    num_search_step: int = 40,
    batch_size: int = 0,
    float64: bool = False,
) -> OptimResult:
    """Minimize ``sum(obj.local_loss)/N + l1·|w| + l2/2·|w|²`` over the
    ranks of the data axis, on ``device`` (see
    :func:`~alink_tpu_torch.common.env.resolve_device`).

    ``l2`` may be a scalar or a per-parameter vector of length
    ``obj.num_params`` (e.g. FM's separate lambda0/1/2 on intercept, linear
    weights, and factors — reference: optim/FmOptimizer.java).

    ``float64=True`` stages the data and runs every step in float64
    (the reference runs float32): where the loss is flat along some
    direction, float32 roundings let the card and the CPU stop at points
    that part along it."""
    import torch
    from torch.func import grad_and_value, hessian, vmap

    from ..common.env import resolve_device

    method = method.lower()
    if method not in _METHODS:
        raise ValueError(f"unknown optimizer {method!r}; expected one of {_METHODS}")
    if method == "owlqn" and l1 == 0.0:
        method = "lbfgs"
    if l1 > 0.0 and method == "lbfgs":
        method = "owlqn"

    device = resolve_device(device)
    npd = np.float64 if float64 else np.float32
    td = torch.float64 if float64 else torch.float32
    sparse = isinstance(X, SparseBlock)
    if sparse and method in ("sgd", "newton"):
        raise ValueError(f"sparse feature blocks unsupported for {method}")
    n = X.idx.shape[0] if sparse else X.shape[0]
    if sample_weights is None:
        sample_weights = np.ones(n, dtype=npd)
    if sparse:
        idx_s, mask = shard_rows(device, np.asarray(X.idx, np.int32),
                                 with_mask=True)
        Xs = SparseBlock(idx_s, shard_rows(device,
                                           np.asarray(X.val, npd)))
    else:
        Xs, mask = shard_rows(device, np.asarray(X, npd),
                              with_mask=True)
    ys = shard_rows(device, np.asarray(y, npd))
    wts = shard_rows(device, np.asarray(sample_weights, npd))
    if float64:  # staging lands 64-bit floats as float32
        Xs = (SparseBlock(Xs.idx, Xs.val.to(td)) if sparse else Xs.to(td))
        mask, ys, wts = mask.to(td), ys.to(td), wts.to(td)
    dim = obj.num_params
    w = (torch.zeros(dim, dtype=td, device=device) if w0 is None
         else torch.as_tensor(np.asarray(w0, npd), device=device))
    if np.ndim(l2):
        l2 = torch.as_tensor(np.asarray(l2, npd), device=device)
    m = history

    wt_eff = wts * mask  # zero out padded rows
    total_w = wt_eff.sum()

    def value_and_grad(w):
        g, l = grad_and_value(obj.local_loss)(w, Xs, ys, wt_eff)
        L = l / total_w + 0.5 * (l2 * w * w).sum()
        G = g / total_w + l2 * w
        if obj.global_term is not None:
            gg, gl = grad_and_value(obj.global_term)(w)
            L = L + gl
            G = G + gg
        return L, G

    def losses_at(cands):
        # the local losses of every candidate weight vector in one pass
        local = vmap(lambda c: obj.local_loss(c, Xs, ys, wt_eff))(cands)
        L = local / total_w + 0.5 * (l2 * cands * cands).sum(1)
        if obj.global_term is not None:
            L = L + vmap(obj.global_term)(cands)
        return L

    # ---------------- OWLQN pseudo-gradient -------------------------------
    def pseudo_grad(w, g):
        gp, gm = g + l1, g - l1
        pg = torch.where(w > 0, gp, torch.where(w < 0, gm, 0.0))
        at_zero = torch.where(gp < 0, gp, torch.where(gm > 0, gm, 0.0))
        return torch.where(w == 0, at_zero, pg)

    # ---------------- L-BFGS direction (two-loop) -------------------------
    # k (the iteration) is known on the host, so the loops visit only the
    # filled history slots; the reference masks the empty ones to no-ops
    def two_loop(g, S, Y, k):
        q = g
        alphas = {}
        for j in range(k - 1, max(k - m, 0) - 1, -1):
            slot = j % m
            sy = torch.clamp(S[slot] @ Y[slot], min=1e-10)
            alphas[slot] = (S[slot] @ q) / sy
            q = q - alphas[slot] * Y[slot]
        if k > 0:
            last = (k - 1) % m
            sy = S[last] @ Y[last]
            yy = Y[last] @ Y[last]
            r = (torch.clamp(sy, min=1e-10) / torch.clamp(yy, min=1e-10)) * q
        else:
            r = 1.0 * q
        for j in range(max(k - m, 0), k):
            slot = j % m
            sy = torch.clamp(S[slot] @ Y[slot], min=1e-10)
            beta = (Y[slot] @ r) / sy
            r = r + (alphas[slot] - beta) * S[slot]
        return -r

    # ---------------- line search (vectorized CalcLosses) -----------------
    steps = torch.pow(0.5, torch.arange(num_search_step, dtype=td,
                                        device=device))
    last_step = torch.tensor(num_search_step - 1, device=device)

    def l1_term(w):
        return l1 * w.abs().sum() if l1 > 0 else 0.0

    def line_search(w, d, loss, g, orthant=None):
        cands = w[None, :] + steps[:, None] * d[None, :]
        if orthant is not None:
            cands = torch.where(cands * orthant[None, :] > 0, cands, 0.0)
        L = losses_at(cands)
        if l1 > 0:
            L = L + l1 * cands.abs().sum(1)
        armijo = (loss + l1_term(w)) + 1e-4 * steps * (g @ d)
        ok = L <= armijo
        # first satisfying candidate, else the smallest step; on the device
        idx = torch.where(ok.any(), torch.argmax(ok.to(torch.uint8)),
                          last_step).reshape(1)
        w_new = cands.index_select(0, idx)[0]
        return w_new, L.index_select(0, idx)[0] - l1_term(w_new)

    def converged(loss, loss_new, gnorm):
        return (gnorm < tol) | ((loss - loss_new).abs()
                                < tol * torch.clamp(loss.abs(), min=1.0))

    # ---------------- main loops by method --------------------------------
    k = 0
    if method in ("lbfgs", "owlqn"):
        owlqn = method == "owlqn"
        loss, g = value_and_grad(w)
        S = torch.zeros((m, dim), dtype=td, device=device)
        Y = torch.zeros((m, dim), dtype=td, device=device)
        while k < max_iter:
            eff_g = pseudo_grad(w, g) if owlqn else g
            d = two_loop(eff_g, S, Y, k)
            # ensure descent direction on the pseudo-gradient
            d = torch.where(eff_g @ d < 0, d, -eff_g)
            if owlqn:
                orthant = torch.where(w != 0, torch.sign(w),
                                      -torch.sign(eff_g))
                d = torch.where(d * -eff_g >= 0, d, 0.0)  # orthant-aligned
                w_new, loss_new = line_search(w, d, loss, eff_g, orthant)
            else:
                w_new, loss_new = line_search(w, d, loss, eff_g)
            _, g_new = value_and_grad(w_new)
            S[k % m] = w_new - w
            Y[k % m] = g_new - g
            gnorm = torch.linalg.vector_norm(
                pseudo_grad(w_new, g_new) if owlqn else g_new)
            done = converged(loss, loss_new, gnorm)
            k, w, loss, g = k + 1, w_new, loss_new, g_new
            if bool(done):  # the iteration's one host sync
                break
    elif method in ("gd", "newton"):
        if method == "newton":
            eye = torch.eye(dim, dtype=td, device=device)

            def direction(w, g):
                H = hessian(obj.local_loss)(w, Xs, ys, wt_eff) / total_w
                H = H + l2 * eye  # eye*vec == diag(vec)
                if obj.global_term is not None:
                    H = H + hessian(obj.global_term)(w)
                return -torch.linalg.solve(H + 1e-8 * eye, g)
        else:
            def direction(w, g):
                return -learning_rate * g

        loss, g = value_and_grad(w)
        while k < max_iter:
            w_new, loss_new = line_search(w, direction(w, g), loss, g)
            _, g_new = value_and_grad(w_new)
            done = converged(loss, loss_new,
                             torch.linalg.vector_norm(g_new))
            k, w, loss, g = k + 1, w_new, loss_new, g_new
            if bool(done):
                break
    else:  # sgd: a fixed count of mini-batch steps, no sync until the end
        rows = Xs.shape[0]
        bs = batch_size if batch_size > 0 else max(1, rows // 8)
        for k in range(max_iter):
            start = (k * bs) % max(rows - bs + 1, 1)
            sl = slice(start, start + bs)
            g, _ = grad_and_value(obj.local_loss)(w, Xs[sl], ys[sl],
                                                  wt_eff[sl])
            G = g / torch.clamp(wt_eff[sl].sum(), min=1e-10) + l2 * w
            # the step size in float32, as the reference computes it
            eta = float(np.float32(learning_rate)
                        / np.sqrt(np.float32(1.0 + k)))
            w = w - eta * G
        k = max_iter
        loss, g = value_and_grad(w)

    out = torch.cat([w, loss.reshape(1),
                     torch.linalg.vector_norm(g).reshape(1)]).cpu().numpy()
    return OptimResult(out[:-2], float(out[-2]), float(out[-1]), int(k))
