"""Clustering operators — KMeans family (port of
``alink_tpu.operator.batch.clustering``).

Capability parity with the reference (reference:
core/src/main/java/com/alibaba/alink/operator/batch/clustering/
KMeansTrainBatchOp.java:59 — IterativeComQueue + AllReduce at :104-110;
KMeansPredictBatchOp + operator/common/clustering/kmeans/KMeansModelMapper.java;
KMeansModelInfoBatchOp).

Lloyd's iteration runs on the session's device: assignments are an
(n, k) distance matrix and the cluster sums one (k, n)×(n, d) product of
the one-hot assignment with the rows. The loop test (the largest centroid
shift against the tolerance) is read once per iteration — the loop's only
host sync — so the fit stops at the reference's iteration. k-means++
seeding runs host-side (numpy, copied from the reference).

Precision: the blocks, centroids and cluster sums are float32, as the
reference's; the distances an argmin decides on are taken in float64 from
those float32 values. A float32 squared distance of 784 pixel columns is
~2e6 with a rounding error of ~0.1 that depends on the device's summation
order, so a float32 argmin hands rows within that of a tie to whichever
centroid the device's rounding favours, and the fit's trajectory, its
iteration count and its centroids then depend on the device (a card and
the CPU stopped 3 iterations apart on 60,000 MNIST-layout rows). In
float64 the error is ~1e-9 and the argmin is the exact one on every
device; it differs from the reference's float32 argmin only for such rows.
That is a deliberate departure from the reference: where rows lie that
close to a tie, the two fits take different trajectories.
``scripts/compare_kmeans_argmin.py`` measures how far they part on the
MNIST-layout rows (PERF.md has the figures).
"""

from __future__ import annotations

import json

import numpy as np

from ...common.exceptions import AkIllegalDataException
from ...common.linalg import pairwise_sq_dists
from ...common.model import model_to_table, table_to_model
from ...common.mtable import AlinkTypes, MTable
from ...common.params import InValidator, MinValidator, ParamInfo
from ...mapper import (
    HasFeatureCols,
    HasPredictionCol,
    HasPredictionDetailCol,
    HasReservedCols,
    HasVectorCol,
    RichModelMapper,
    get_feature_block,
    merge_feature_params,
    resolve_feature_cols,
)
from ...parallel.comqueue import shard_rows
from .base import BatchOperator
from .utils import ModelMapBatchOp, ModelTrainOpMixin


class HasKMeansParams(HasVectorCol, HasFeatureCols):
    K = ParamInfo("k", int, default=2, validator=MinValidator(2))
    MAX_ITER = ParamInfo("maxIter", int, default=50, validator=MinValidator(1))
    EPSILON = ParamInfo("epsilon", float, default=1e-4)
    DISTANCE_TYPE = ParamInfo(
        "distanceType", str, default="EUCLIDEAN",
        validator=InValidator("EUCLIDEAN", "COSINE", "HAVERSINE"),
    )
    RANDOM_SEED = ParamInfo("randomSeed", int, default=0, aliases=("seed",))


def _kmeanspp_init(X: np.ndarray, k: int, seed: int) -> np.ndarray:
    """Greedy k-means++ seeding on (a subsample of) the data, host-side:
    each step draws 2+log2(k) candidates ∝ d² and keeps the one minimizing
    the resulting potential — robust to unlucky single draws."""
    rng = np.random.default_rng(seed)
    n = X.shape[0]
    if n > 10000:
        X = X[rng.choice(n, 10000, replace=False)]
        n = X.shape[0]
    n_cand = 2 + int(np.log2(max(k, 2)))
    centers = [X[rng.integers(n)]]
    d2 = ((X - centers[0]) ** 2).sum(axis=1)
    for _ in range(1, k):
        total = d2.sum()
        if total <= 0:
            centers.append(X[rng.integers(n)])
            continue
        cand_idx = np.searchsorted(
            np.cumsum(d2 / total), rng.random(n_cand)
        ).clip(0, n - 1)
        # candidate minimizing the new total potential wins
        cand_d2 = np.minimum(
            d2[None, :], ((X[None, :, :] - X[cand_idx, None, :]) ** 2).sum(axis=2)
        )
        best = int(np.argmin(cand_d2.sum(axis=1)))
        centers.append(X[cand_idx[best]])
        d2 = cand_d2[best]
    return np.stack(centers).astype(np.float32)


_EARTH_RADIUS_KM = 6371.0


def _haversine_dists(X, c):
    """(n, k) great-circle distances; rows are (lat, lon) in degrees
    (reference: common/distance/HaversineDistance.java)."""
    import torch

    a = torch.deg2rad(X)[:, None, :]     # (n, 1, 2)
    b = torch.deg2rad(c)[None, :, :]     # (1, k, 2)
    dlat = a[..., 0] - b[..., 0]
    dlon = a[..., 1] - b[..., 1]
    h = (torch.sin(dlat / 2) ** 2
         + torch.cos(a[..., 0]) * torch.cos(b[..., 0])
         * torch.sin(dlon / 2) ** 2)
    return 2.0 * _EARTH_RADIUS_KM * torch.arcsin(
        torch.sqrt(torch.clamp(h, 0.0, 1.0)))


def _unit_rows(x):
    import torch

    return x / torch.clamp(torch.linalg.vector_norm(x, dim=1, keepdim=True),
                           min=1e-12)


def _dists(X64, c, metric: str):
    """(n, k) float64 distances of rows (``X64``: the float32 rows in
    float64) to the float32 centroids ``c`` under ``metric``; COSINE
    expects unit rows."""
    c = c.double()
    if metric == "COSINE":
        return 1.0 - X64 @ _unit_rows(c).T
    if metric == "HAVERSINE":
        return _haversine_dists(X64, c)
    return pairwise_sq_dists(X64, c)


def _lloyd(device, X: np.ndarray, k: int, max_iter: int, tol: float,
           metric, seed: int):
    """The Lloyd loop on ``device``. Returns (centroids, num_iters, inertia).
    ``metric``: "EUCLIDEAN" | "COSINE" | "HAVERSINE" (bool accepted for the
    legacy cosine flag)."""
    import torch
    import torch.nn.functional as F

    from ...common.env import resolve_device

    device = resolve_device(device)
    if isinstance(metric, bool):
        metric = "COSINE" if metric else "EUCLIDEAN"
    if metric == "COSINE":
        X = X / np.maximum(np.linalg.norm(X, axis=1, keepdims=True), 1e-12)
    init = _kmeanspp_init(X, k, seed)
    Xs, mask = shard_rows(device, X, with_mask=True)
    X64 = Xs.double()
    c = torch.as_tensor(init, device=device)
    if metric == "HAVERSINE":
        # centroid = spherical mean (mean of unit 3-vectors): the
        # degree-mean breaks at the antimeridian
        lat = torch.deg2rad(Xs[:, 0])
        lon = torch.deg2rad(Xs[:, 1])
        xyz = torch.stack([torch.cos(lat) * torch.cos(lon),
                           torch.cos(lat) * torch.sin(lon),
                           torch.sin(lat)], dim=1)
    i = 0
    while i < max_iter:
        a = torch.argmin(_dists(X64, c, metric), dim=1)
        onehot = F.one_hot(a, k).to(Xs.dtype) * mask[:, None]
        counts = onehot.sum(0)                                # (k,)
        if metric == "HAVERSINE":
            m = _unit_rows(onehot.T @ xyz)                    # (k, 3)
            lat_c = torch.rad2deg(torch.arcsin(torch.clamp(m[:, 2], -1.0,
                                                           1.0)))
            lon_c = torch.rad2deg(torch.atan2(m[:, 1], m[:, 0]))
            c_new = torch.where(counts[:, None] > 0,
                                torch.stack([lat_c, lon_c], dim=1), c)
        else:
            c_new = torch.where(counts[:, None] > 0,
                                (onehot.T @ Xs) / counts[:, None], c)
            if metric == "COSINE":
                c_new = _unit_rows(c_new)
        go_on = (c_new - c).abs().max() > tol
        i, c = i + 1, c_new
        if not bool(go_on):  # the iteration's one host sync
            break
    # inertia against the FINAL centroids (the stored model), not the
    # pre-update centroids of the last step
    inertia = (torch.min(_dists(X64, c, metric), dim=1).values.float()
               * mask).sum()
    out = torch.cat([c.reshape(-1), inertia.reshape(1)]).cpu().numpy()
    return out[:-1].reshape(c.shape), i, float(out[-1])


class KMeansTrainBatchOp(ModelTrainOpMixin, BatchOperator, HasKMeansParams):
    """(reference: operator/batch/clustering/KMeansTrainBatchOp.java)"""

    _min_inputs = 1
    _max_inputs = 1

    def _static_meta_keys(self, in_schema):
        return {"modelName": "KMeansModel"}

    def _execute_impl(self, t: MTable) -> MTable:
        k = self.get(self.K)
        feature_cols = (
            None
            if self.get(HasVectorCol.VECTOR_COL)
            else resolve_feature_cols(t, self)
        )
        X = get_feature_block(t, self).astype(np.float32)
        if X.shape[0] < k:
            raise AkIllegalDataException(
                f"k={k} but only {X.shape[0]} rows of data"
            )
        c, iters, inertia = _lloyd(
            self.env.device, X, k, self.get(self.MAX_ITER),
            self.get(self.EPSILON), self.get(self.DISTANCE_TYPE),
            self.get(self.RANDOM_SEED),
        )
        meta = {
            "modelName": "KMeansModel",
            "k": k,
            "distanceType": self.get(self.DISTANCE_TYPE),
            "vectorCol": self.get(HasVectorCol.VECTOR_COL),
            "featureCols": feature_cols,
            "numIters": iters,
            "inertia": inertia,
            "dim": int(c.shape[1]),
        }
        return model_to_table(meta, {"centroids": c})


class KMeansModelMapper(RichModelMapper):
    """(reference: operator/common/clustering/kmeans/KMeansModelMapper.java)"""

    def load_model(self, model: MTable):
        import torch

        from ...common.env import resolve_device

        self.meta, arrays = table_to_model(model)
        self.centroids = arrays["centroids"].astype(np.float32)
        self._device = resolve_device(self.device)
        self._centroids_dev = torch.as_tensor(self.centroids,
                                              device=self._device)
        self._metric = self.meta.get("distanceType", "EUCLIDEAN")
        return self

    def _pred_type(self) -> str:
        return AlinkTypes.LONG

    def predict_block(self, t: MTable):
        import torch

        X = get_feature_block(
            t, merge_feature_params(self.get_params(), self.meta),
            vector_size=self.meta["dim"],
        ).astype(np.float32)
        Xd = torch.from_numpy(X).to(self._device)
        if self._metric == "COSINE":
            Xd = _unit_rows(Xd)
        d = _dists(Xd.double(), self._centroids_dev, self._metric)
        a = torch.argmin(d, dim=1).cpu().numpy()
        detail = None
        if self.get(HasPredictionDetailCol.PREDICTION_DETAIL_COL):
            detail = np.asarray(
                [json.dumps({str(i): float(x) for i, x in enumerate(row)})
                 for row in d.float().cpu().numpy()], dtype=object,
            )
        return a.astype(np.int64), AlinkTypes.LONG, detail


class KMeansPredictBatchOp(ModelMapBatchOp, HasPredictionCol,
                           HasPredictionDetailCol, HasReservedCols):
    """(reference: operator/batch/clustering/KMeansPredictBatchOp.java)"""

    mapper_cls = KMeansModelMapper


class KMeansModelInfoBatchOp(BatchOperator):
    """Cluster sizes/centroids view (reference: KMeansModelInfoBatchOp.java)."""

    _min_inputs = 1
    _max_inputs = 1

    def _execute_impl(self, model: MTable) -> MTable:
        meta, arrays = table_to_model(model)
        c = arrays["centroids"]
        return MTable(
            {
                "clusterId": np.arange(c.shape[0], dtype=np.int64),
                "center": [" ".join(format(v, "g") for v in row) for row in c],
            }
        )

    def _out_schema(self, in_schema):
        from ...common.mtable import TableSchema

        return TableSchema(["clusterId", "center"],
                           [AlinkTypes.LONG, AlinkTypes.STRING])


class GeoKMeansTrainBatchOp(KMeansTrainBatchOp):
    """KMeans over (lat, lon) degrees with great-circle distance
    (reference: operator/batch/clustering/GeoKMeansTrainBatchOp.java)."""

    LATITUDE_COL = ParamInfo("latitudeCol", str, optional=False)
    LONGITUDE_COL = ParamInfo("longitudeCol", str, optional=False)

    def _execute_impl(self, t: MTable) -> MTable:
        self.set(self.DISTANCE_TYPE, "HAVERSINE")
        self.set(HasFeatureCols.FEATURE_COLS,
                 [self.get(self.LATITUDE_COL), self.get(self.LONGITUDE_COL)])
        return super()._execute_impl(t)


class GeoKMeansPredictBatchOp(KMeansPredictBatchOp):
    pass
