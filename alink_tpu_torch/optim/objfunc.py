"""Objective functions for the optimizers (port of
``alink_tpu.optim.objfunc``).

Capability parity with the reference's pluggable objectives (reference:
core/src/main/java/com/alibaba/alink/operator/common/optim/objfunc/OptimObjFunc.java
and the unary loss functions under operator/common/linear/unarylossfunc/ —
LogLossFunc, SquareLossFunc, SvmHingeLossFunc, SmoothHingeLossFunc, ...).

An objective is a function over tensors of one rank's rows,
``loss_sum = f(w, X, y, wt)``; gradients come from autograd
(``torch.func.grad_and_value``) rather than hand-derived per-sample
formulas, and the optimizer all-reduces across ranks. Weights ``w`` are
flat vectors; multi-class objectives view them as (d, k). Every function
here is written with out-of-place tensor ops only, so ``torch.func`` can
differentiate and ``vmap`` it.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

from ..common.linalg import SparseBlock


def xw(X, w):
    """``X @ w`` generic over dense blocks and ELL SparseBlocks; ``w`` may
    be a vector (d,) or a matrix (d, k). The sparse path is a gather and a
    row sum whose gradient is a scatter-add — no dense materialization
    either way."""
    if isinstance(X, SparseBlock):
        if w.ndim == 1:
            return (X.val * w[X.idx]).sum(1)
        return (X.val[..., None] * w[X.idx]).sum(1)
    return X @ w


class ObjFunc(NamedTuple):
    """local_loss(w, X, y, wt) -> weighted sum of per-row losses on this rank.

    ``num_params`` is the flat weight dimension. ``global_term``, when set,
    is a data-independent penalty ``g(w) -> scalar`` added ONCE to the
    all-reduced average loss (constraint penalties, augmented-Lagrangian
    terms — reference: optim/objfunc/OptimObjFunc constraint hooks).
    """

    local_loss: Callable
    num_params: int
    global_term: "Callable | None" = None


def _weighted_sum(per_row, wt):
    return (per_row * wt).sum()


def _log1p_exp(x):
    """log(1 + exp(x)) stably, as ``jnp.logaddexp(0.0, x)``."""
    import torch

    return torch.logaddexp(torch.zeros_like(x), x)


def _cross_entropy(logits, y, wt):
    import torch

    logz = torch.logsumexp(logits, dim=1)
    true_logit = logits.gather(1, y.long()[:, None])[:, 0]
    return _weighted_sum(logz - true_logit, wt)


def logistic_obj(dim: int) -> ObjFunc:
    """Binary logistic loss; y in {-1, +1} (reference:
    unarylossfunc/LogLossFunc.java)."""

    def local_loss(w, X, y, wt):
        return _weighted_sum(_log1p_exp(-(y * xw(X, w))), wt)

    return ObjFunc(local_loss, dim)


def squared_obj(dim: int) -> ObjFunc:
    """Least squares (reference: unarylossfunc/SquareLossFunc.java)."""

    def local_loss(w, X, y, wt):
        r = xw(X, w) - y
        return _weighted_sum(0.5 * r * r, wt)

    return ObjFunc(local_loss, dim)


def hinge_obj(dim: int, smooth: bool = True) -> ObjFunc:
    """(Smoothed) hinge for linear SVM; y in {-1, +1} (reference:
    unarylossfunc/SvmHingeLossFunc.java, SmoothHingeLossFunc.java)."""
    import torch

    def local_loss(w, X, y, wt):
        margin = y * xw(X, w)
        if smooth:
            # quadratically smoothed hinge (differentiable everywhere)
            per_row = torch.where(
                margin >= 1.0,
                0.0,
                torch.where(margin <= 0.0, 0.5 - margin,
                            0.5 * (1.0 - margin) ** 2),
            )
        else:
            per_row = torch.clamp(1.0 - margin, min=0.0)
        return _weighted_sum(per_row, wt)

    return ObjFunc(local_loss, dim)


def softmax_obj(dim: int, num_classes: int) -> ObjFunc:
    """Multinomial cross-entropy; y is an int class index; flat weights view
    as (dim, k) (reference: operator/common/linear/SoftmaxObjFunc.java)."""

    def local_loss(w, X, y, wt):
        return _cross_entropy(xw(X, w.reshape(dim, num_classes)), y, wt)

    return ObjFunc(local_loss, dim * num_classes)


def perceptron_obj(dim: int) -> ObjFunc:
    """Perceptron loss (reference: unarylossfunc/PerceptronLossFunc.java)."""
    import torch

    def local_loss(w, X, y, wt):
        margin = y * xw(X, w)
        return _weighted_sum(torch.clamp(-margin, min=0.0), wt)

    return ObjFunc(local_loss, dim)


def svr_obj(dim: int, epsilon: float = 0.1) -> ObjFunc:
    """Quadratically smoothed ε-insensitive loss for linear SVR (reference:
    unarylossfunc/SvrLossFunc.java). 0 inside the ε-tube, 0.5·(|r|−ε)²
    outside — differentiable everywhere for L-BFGS."""
    import torch

    def local_loss(w, X, y, wt):
        r = xw(X, w) - y
        excess = torch.clamp(r.abs() - epsilon, min=0.0)
        return _weighted_sum(0.5 * excess * excess, wt)

    return ObjFunc(local_loss, dim)


def aft_obj(dim: int):
    """Weibull AFT survival objective (reference:
    operator/common/regression/AftRegObjFunc.java). The censor indicator rides
    as the LAST column of the feature block (1 = event observed, 0 =
    right-censored); ``y`` is log(survival time). Flat weights =
    [beta (dim), log_sigma]."""
    import torch

    def local_loss(w, X, y, wt):
        beta = w[:dim]
        log_sigma = w[dim]
        sigma = torch.exp(log_sigma)
        censor = X[:, dim]          # appended indicator column
        feats = X[:, :dim]
        z = (y - feats @ beta) / sigma
        # observed: log-pdf of the extreme-value dist; censored: log-survival
        log_pdf = z - torch.exp(z) - log_sigma
        log_surv = -torch.exp(z)
        per_row = -(censor * log_pdf + (1.0 - censor) * log_surv)
        return _weighted_sum(per_row, wt)

    return ObjFunc(local_loss, dim + 1)


def huber_obj(dim: int, delta: float = 1.0) -> ObjFunc:
    """Huber regression loss (reference: unarylossfunc/HuberLossFunc.java)."""
    import torch

    def local_loss(w, X, y, wt):
        r = xw(X, w) - y
        a = r.abs()
        per_row = torch.where(a <= delta, 0.5 * r * r,
                              delta * (a - 0.5 * delta))
        return _weighted_sum(per_row, wt)

    return ObjFunc(local_loss, dim)


def fm_pairwise(X, V):
    """FM second-order term via the O(n·d·k) identity 0.5·Σ_f((XV)² − X²V²) —
    two matmuls. Generic over numpy arrays and tensors; the single home of
    this formula for both training and serving."""
    xv = X @ V
    return 0.5 * ((xv * xv) - (X * X) @ (V * V)).sum(1)


def fm_obj(dim: int, num_factors: int, task: str = "binary") -> ObjFunc:
    """Factorization machine objective (reference:
    operator/common/optim/FmOptimizer.java:39 + common/fm/FmLossUtils.java).

    Flat weights = [w0 (1), w (dim), V (dim*num_factors)]; ``task`` is
    "binary" (logistic, y∈{−1,+1}) or "regression" (squared)."""

    def score(w, X):
        w0 = w[0]
        lin = w[1:1 + dim]
        V = w[1 + dim:].reshape(dim, num_factors)
        return w0 + X @ lin + fm_pairwise(X, V)

    def local_loss(w, X, y, wt):
        s = score(w, X)
        if task == "binary":
            per_row = _log1p_exp(-y * s)
        else:
            per_row = 0.5 * (s - y) ** 2
        return _weighted_sum(per_row, wt)

    return ObjFunc(local_loss, 1 + dim + dim * num_factors)


def mlp_obj(layer_sizes) -> ObjFunc:
    """Feed-forward network objective (reference:
    operator/common/classification/ann/FeedForwardTopology.java +
    FeedForwardTrainer.java — affine+sigmoid hidden layers, softmax output,
    trained through the same optimizer framework as linear models).

    Flat weights pack (W_i, b_i) per layer; the final layer is softmax
    cross-entropy."""
    sizes = list(layer_sizes)
    num_params = sum(
        sizes[i] * sizes[i + 1] + sizes[i + 1] for i in range(len(sizes) - 1)
    )

    def local_loss(w, X, y, wt):
        return _cross_entropy(mlp_forward(sizes, w, X), y, wt)

    return ObjFunc(local_loss, num_params)


def mlp_forward(layer_sizes, w, X):
    """Shared forward pass for mlp_obj's flat weight layout — used by both the
    training objective and the predict mapper so layouts cannot drift."""
    import torch

    sizes = list(layer_sizes)
    h = X
    off = 0
    for i in range(len(sizes) - 1):
        fan_in, fan_out = sizes[i], sizes[i + 1]
        W = w[off:off + fan_in * fan_out].reshape(fan_in, fan_out)
        off += fan_in * fan_out
        b = w[off:off + fan_out]
        off += fan_out
        h = h @ W + b
        if i < len(sizes) - 2:
            h = torch.sigmoid(h)
    return h
