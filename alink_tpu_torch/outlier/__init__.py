"""Outlier detection core (port of ``alink_tpu.outlier``; reference:
operator/common/outlier/)."""

from .detectors import (
    boxplot,
    copod,
    ecod,
    esd,
    hbos,
    iforest,
    kde,
    ksigma,
    lof,
    mad,
    ocsvm,
    shesd,
    sos,
)

__all__ = [
    "boxplot", "copod", "ecod", "esd", "hbos", "iforest", "kde",
    "ksigma", "lof", "mad", "ocsvm", "shesd", "sos",
]
