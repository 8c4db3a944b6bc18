"""Recommendation core: ALS factorization + neighborhood CF + Swing (port of
``alink_tpu.recommendation``).

(reference: core/.../operator/common/recommendation/ — HugeMfAlsImpl,
ItemCf/UserCf kernels, Swing, and the RecommKernel serving layer.)
"""

from .als import AlsModelData, train_als
from .cf import interaction_similarity, swing_similarity

__all__ = [
    "AlsModelData", "train_als",
    "interaction_similarity", "swing_similarity",
]
