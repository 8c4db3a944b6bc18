"""How far GaussianMixture's EM and LDA's outer steps depend on summation
order in float32 and in float64: the reason the port runs both in float64
(``alink_tpu_torch/operator/batch/clustering2.py``).

Run from the repository root:

    python3 scripts/compare_clustering_precision.py [--rows N] [--docs D]
        [--device cuda]

GMM: the GaussianMixture input block of chip_smoke.py phase 19.1's
pipeline on N seeded Covertype-layout rows (default 200,000), 5 EM
iterations from the op's start through ``clustering2._gmm_step``. LDA: 3
outer iterations of ``clustering2._lda_outer`` on D seeded text8-layout
documents (default 500, vocabulary 10,000, 100 topics). Each in float32
and float64, on the CPU with the rows in order and permuted (another
summation order on the same device), and with ``--device cuda`` on the
card as well (the card's order against the CPU's). Prints one JSON line:
the log-likelihood's relative gap and the weights' and means' largest
|gap| for GMM, λ's largest elementwise relative gap for LDA, per pair.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def gmm_block(rows):
    import chip_smoke as cs
    from alink_tpu_torch.common.mtable import MTable
    from alink_tpu_torch.operator.batch import TableSourceBatchOp
    from alink_tpu_torch.operator.batch import clustering2 as c2

    X, _ = cs.covertype_data(rows, cs.SEED)
    kept = []
    undo = cs.keep_calls(c2, "_gmm_fit", kept)
    try:
        with cs.torch_device("cpu"):
            cs.feature_pipeline(**cs.FEATURE_GMM).fit(
                TableSourceBatchOp(MTable(cs.covertype_categorical(X))))
    finally:
        undo()
    return kept[0][0][1]


def gmm_run(block, dtype, device, perm=None):
    import torch

    import chip_smoke as cs
    from alink_tpu_torch.operator.batch import clustering2 as c2

    X = torch.as_tensor(block if perm is None else block[perm],
                        device=device).to(dtype)
    mask = torch.ones(X.shape[0], dtype=dtype, device=device)
    state = [torch.as_tensor(a, device=device).to(dtype) for a in
             c2._gmm_init(block, cs.FEATURE_GMM["k"], 0, cs.GMM_REG)]
    for _ in range(cs.FEATURE_GMM["maxIter"]):
        *state, ll = c2._gmm_step(X, mask, *state, mask.sum(), cs.GMM_REG)
    return float(ll), state[0].cpu().double().numpy(), \
        state[1].cpu().double().numpy()


def gmm_gap(a, b):
    return dict(ll_rel=abs(a[0] - b[0]) / abs(b[0]),
                weights=float(np.abs(a[1] - b[1]).max()),
                means=float(np.abs(a[2] - b[2]).max()))


def lda_run(X, dtype, device, perm=None):
    import torch

    import chip_smoke as cs
    from alink_tpu_torch.operator.batch import clustering2 as c2

    k = cs.LDA["topicNum"]
    lam = torch.as_tensor(c2._lda_init(k, X.shape[1], 0),
                          device=device).to(dtype)
    Xd = torch.as_tensor(X if perm is None else X[perm],
                         device=device).to(dtype)
    for _ in range(cs.LDA_CHECK_ITERS):
        lam, _ = c2._lda_outer(lam, Xd, 50.0 / k, 0.01, 50)
    return lam.cpu().double().numpy()


def lda_gap(a, b):
    return float((np.abs(a - b) / np.abs(b)).max())


def main() -> int:
    import torch

    import chip_smoke as cs
    from alink_tpu_torch.operator.batch import clustering2 as c2

    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=200_000)
    ap.add_argument("--docs", type=int, default=cs.LDA_CHECK_DOCS)
    ap.add_argument("--device", default="cpu")
    args = ap.parse_args()
    out = dict(rows=args.rows, docs=args.docs, device=args.device)
    if args.device != "cpu":
        out["card"] = torch.cuda.get_device_name(0)
    block = gmm_block(args.rows)
    perm = np.random.default_rng(1).permutation(block.shape[0])
    docs = cs.text8_corpus(args.docs * cs.SENTENCE, cs.SEED)
    X, _ = c2._build_corpus(docs, cs.LDA["vocabSize"])
    dperm = np.random.default_rng(1).permutation(X.shape[0])
    for name, dtype in (("float32", torch.float32),
                        ("float64", torch.float64)):
        g = gmm_run(block, dtype, "cpu")
        lam = lda_run(X, dtype, "cpu")
        res = dict(gmm_cpu_vs_permuted=gmm_gap(
            g, gmm_run(block, dtype, "cpu", perm)),
            lda_cpu_vs_permuted=lda_gap(lam, lda_run(X, dtype, "cpu",
                                                     dperm)))
        if args.device != "cpu":
            res["gmm_card_vs_cpu"] = gmm_gap(gmm_run(block, dtype,
                                                     args.device), g)
            res["lda_card_vs_cpu"] = lda_gap(lda_run(X, dtype, args.device),
                                             lam)
        out[name] = res
        out.setdefault("_runs", {})[name] = (g, lam)
    g32, lam32 = out["_runs"]["float32"]
    g64, lam64 = out.pop("_runs")["float64"]
    out["float32_vs_float64"] = dict(gmm=gmm_gap(g32, g64),
                                     lda=lda_gap(lam32, lam64))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
