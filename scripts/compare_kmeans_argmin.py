"""How far the port's KMeans (argmin on float64 distances) lands from
``alink_tpu``'s (argmin on float32 distances), both on the CPU.

Run from the repository root on a host that has both packages (JAX on the
CPU):

    JAX_PLATFORMS=cpu python3 scripts/compare_kmeans_argmin.py [--rows N]

Takes chip_smoke.py's 11.2 cell: ``--rows`` (default 60,000) seeded rows
of 784 pixel columns in MNIST's layout (``chip_smoke.mnist_layout``),
KMeans k=10, maxIter=50, the default tolerance, seed 0. The reference
runs in a session on a one-device mesh, the port with
``ALINK_TORCH_DEVICE=cpu``. Prints each package's numIters, inertia and
wall, the centroids' largest distance (relative to the reference's
largest entry), and the share of rows the two final models assign to
different clusters, plus the count of rows whose two nearest reference
centroids lie within float32 rounding of a tie (|d1 − d2| ≤ 2**-23 ·
4 · d1 · √784, a loose bound on the rounding of a 784-term squared
distance).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=60_000)
    args = ap.parse_args()
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    os.environ["ALINK_TORCH_DEVICE"] = "cpu"

    import jax

    import alink_tpu.operator.batch as R
    import alink_tpu_torch.operator.batch as T
    from alink_tpu.common.env import MLEnvironment, MLEnvironmentFactory
    from alink_tpu.common.model import table_to_model as r_table_to_model
    from alink_tpu.common.mtable import MTable as RTable
    from alink_tpu.parallel.mesh import default_mesh
    from alink_tpu_torch.common.model import table_to_model
    from alink_tpu_torch.common.mtable import MTable
    from chip_smoke import SEED, mnist_layout

    X, _ = mnist_layout(args.rows, SEED)
    feats = [f"p{i}" for i in range(X.shape[1])]
    cols = {f: X[:, i] for i, f in enumerate(feats)}
    kw = dict(featureCols=feats, k=10, maxIter=50)
    sid = MLEnvironmentFactory.get_new_environment_id(
        MLEnvironment(mesh=default_mesh(jax.devices()[:1])))

    t0 = time.perf_counter()
    rmeta, rarr = r_table_to_model(
        R.KMeansTrainBatchOp(**kw, MLEnvironmentId=sid)
        .link_from(R.TableSourceBatchOp(RTable(cols))).collect())
    ref_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    pmeta, parr = table_to_model(
        T.KMeansTrainBatchOp(**kw)
        .link_from(T.TableSourceBatchOp(MTable(cols))).collect())
    port_s = time.perf_counter() - t0

    c_ref = rarr["centroids"].astype(np.float64)
    c_port = parr["centroids"].astype(np.float64)
    Xd = X.astype(np.float64)

    def dists(c):
        return ((Xd * Xd).sum(1)[:, None] - 2.0 * Xd @ c.T
                + (c * c).sum(1)[None, :])

    d_ref = dists(c_ref)
    two = np.sort(d_ref, axis=1)[:, :2]
    near_ties = int((two[:, 1] - two[:, 0]
                     <= 2.0 ** -23 * 4 * two[:, 0] * np.sqrt(784)).sum())
    out = dict(
        rows=args.rows, k=10, max_iter=50,
        reference=dict(num_iters=int(rmeta["numIters"]),
                       inertia=float(rmeta["inertia"]), wall_s=ref_s),
        port=dict(num_iters=int(pmeta["numIters"]),
                  inertia=float(pmeta["inertia"]), wall_s=port_s),
        inertia_rel_diff=abs(pmeta["inertia"] - rmeta["inertia"])
        / rmeta["inertia"],
        centroid_rel_dist=float(np.abs(c_port - c_ref).max()
                                / np.abs(c_ref).max()),
        rows_assigned_otherwise=float(np.mean(
            d_ref.argmin(1) != dists(c_port).argmin(1))),
        rows_near_a_float32_tie=near_ties)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
