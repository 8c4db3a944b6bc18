"""Optimizer framework of the port (``alink_tpu.optim``): objectives, the
five unconstrained methods and the constrained solvers."""

from .objfunc import (
    ObjFunc,
    aft_obj,
    fm_obj,
    fm_pairwise,
    hinge_obj,
    huber_obj,
    logistic_obj,
    mlp_forward,
    mlp_obj,
    perceptron_obj,
    softmax_obj,
    squared_obj,
    svr_obj,
    xw,
)
from .optimizers import OptimResult, optimize
from .constrained import constrained_optimize

__all__ = [
    "ObjFunc", "OptimResult", "aft_obj", "constrained_optimize", "fm_obj",
    "fm_pairwise", "hinge_obj", "huber_obj", "logistic_obj", "mlp_forward",
    "mlp_obj", "optimize", "perceptron_obj", "softmax_obj", "squared_obj",
    "svr_obj", "xw",
]
