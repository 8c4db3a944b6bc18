"""Runs chosen phases of chip_smoke.py's newer checks on the card, without
the rest of the smoke test: a quicker loop while one of them changes.

Run from the repository root on a machine with one CUDA device:

    python3 scripts/chip_phase_check.py [phase ...]

Phases (all when none is named): ``sgns`` (both SGNS entries at D = 1100
and 2048), ``hist`` (the level call at d = 300 and 784), ``bwd`` (the flash
route's backward against the plain route's autograd, and its timings),
``record`` (bench.py's BERT-base fine-tune configuration), ``kernel`` (5
training steps on the flash route at seq 512), ``sst2`` (the operator's
fine-tune of data/sst2_mini.csv), ``forest`` (the 784-column forest),
``families`` (phase 12, the model families, with the inputs it takes from
phase 4's BERT-base serving and phase 7's GBDT on the Covertype-layout
rows, both run first), ``ingest`` (phase 13, foreign-model ingest:
BASELINE #3 and #5; it builds no kernel), ``serving`` (phase 14, BERT-base
serving through ``ModelServer``, with phase 4's model and request, run
first), ``pretrain`` (phase 15, MLM pretraining: BERT-base width, the
corpus-scale loop, the contracts, bench.py's quality route; it builds no
kernel), ``fleet`` (phase 16, the serving fleet: two BERT-base replicas
of phase 4's model as a pipeline ``.ak`` with its sidecar, both written
first, with the serial predicts the rows are held against), ``dag``
(phase 17, the BERT-base evaluation DAG through the executor, with phase
4's model, run first), ``tuning`` (phase 18, model selection: the forest
search on both routes, the families on the card and their int8 scorers),
``features`` (phase 19, the clustering and feature-engineering families:
the Covertype feature pipeline with GaussianMixture, BisectingKMeans on the
MNIST layout, LDA on the text8 layout and Dbscan, each against the CPU
route; it builds no kernel), ``graph`` (phase 20: the graph engine's ops on
a scale-17 Graph 500 graph and the host graph ops at scale 12, BRUTE and
LSH vector neighbours in sift-128's shape, the text pipeline with
NaiveBayesText and TextRank keywords, and the constrained features on the
Covertype-layout rows, each against the CPU route; it builds no kernel),
``recomm`` (phase 21: ALS, ItemCF, Swing, FM and DeepFM on MovieLens-1M-
layout ratings, the outlier detectors on ODDS-mnist-layout rows and the
model ops on credit-card-layout rows, the grouped k-sigma, the scorecards,
PSI and the sparse indexer on the Covertype-layout rows, each against the
CPU route; it builds no kernel), ``walks`` (phase 20.5: LINE on the
scale-17 Graph 500 graph at orders 2 and 1, MetaPath2Vec on the
MovieLens-1M-layout user-item graph, each against the plain route, SimRank
and MDS against the CPU route), ``timeseries`` (phase 22: the forecasters
on the electricity layout and the window features on the credit-card
layout, against the CPU route or a numpy oracle; it builds no kernel),
``batch`` (phase 23: MFCC, AggLookup and AutoDiscovery against the CPU
route, the script op and the aliases, the host families and the plugin
gates; it builds no kernel).
Each
prints what chip_smoke.py prints for it; the results go to
``build/chip_phase_check.json``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

PHASES = ("sgns", "hist", "bwd", "record", "kernel", "sst2", "forest",
          "families", "ingest", "serving", "pretrain", "fleet", "dag",
          "tuning", "features", "graph", "recomm", "walks", "timeseries",
          "batch")


def main() -> int:
    import torch

    import chip_smoke as cs
    from alink_tpu_torch.native import kernels
    from alink_tpu_torch.tree.binning import apply_bins, quantile_bins

    if not torch.cuda.is_available():
        cs.fail("no CUDA device")
    phases = sys.argv[1:] or list(PHASES)
    unknown = set(phases) - set(PHASES)
    if unknown:
        cs.fail(f"unknown phases {sorted(unknown)}; choose from {PHASES}")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if not set(phases) <= {"ingest", "pretrain", "features", "graph",
                           "recomm", "timeseries", "batch"}:
        kernels.build()
        print(f"build {kernels.build_seconds:.1f} s", flush=True)
    _, peaks = cs.card_peaks(torch.cuda.get_device_name(0))
    workdir = os.path.join(ROOT, "build", "chip_smoke")
    os.makedirs(workdir, exist_ok=True)

    def wide_hist():
        X, _ = cs.mnist_layout(cs.WIDE_ROWS, cs.SEED)
        return cs.check_wide_histograms(
            peaks, apply_bins(X, quantile_bins(X, cs.HIST_BINS)))

    def phase4():
        """Phase 4's serving, with its model written first (as ``main``
        writes it beside the kernel build)."""
        cfg = cs.serving_config()
        model = cs.write_bert_model(workdir, cfg)
        return cs.main_path(workdir, cfg, model)[1]

    def families():
        served = phase4()
        X, y = cs.covertype_data(cs.COVTYPE_TRAIN + cs.COVTYPE_TEST, cs.SEED)
        gbdt = cs.gbdt_path(X, y)
        return cs.model_families(served, X, y, gbdt,
                                 card.splitlines()[0])

    def serving():
        served = phase4()
        with ThreadPoolExecutor(1) as ahead:   # as ``main`` writes it
            written = ahead.submit(cs.write_serving_pipeline, workdir, served)
            return cs.serving_path(workdir, served, card.splitlines()[0],
                                   written)[1]

    def fleet():
        served = phase4()
        return cs.fleet_path(workdir, card.splitlines()[0],
                             cs.fleet_inputs(workdir, served))

    def dag():
        served = phase4()
        return cs.dag_path(workdir, served, card.splitlines()[0])

    run = {"sgns": cs.check_sgns_wide, "hist": wide_hist,
           "bwd": lambda: cs.check_backward(peaks),
           "record": lambda: cs.train_metric_of_record(peaks),
           "kernel": cs.train_kernel_route,
           "sst2": lambda: cs.finetune_sst2(workdir),
           "forest": cs.wide_forest_path, "families": families,
           "ingest": lambda: cs.ingest_path(workdir, card.splitlines()[0]),
           "serving": serving, "fleet": fleet, "dag": dag,
           "tuning": lambda: cs.tuning_path(card.splitlines()[0])[0],
           "features": lambda: cs.clustering_features_path(
               card.splitlines()[0]),
           "graph": lambda: cs.graph_text_path(card.splitlines()[0]),
           "recomm": lambda: cs.recomm_outlier_path(card.splitlines()[0]),
           "walks": lambda: cs.walks_path(card.splitlines()[0]),
           "timeseries": lambda: cs.timeseries_path(card.splitlines()[0]),
           "batch": lambda: cs.batch_families_path(card.splitlines()[0],
                                                   workdir),
           "pretrain": lambda: cs.pretraining_path(workdir, peaks,
                                                   card.splitlines()[0])}
    out = {}
    for name in phases:
        t0 = time.perf_counter()
        out[name] = run[name]()
        print(f"== {name}: {time.perf_counter() - t0:.1f} s", flush=True)
    with open(os.path.join(ROOT, "build", "chip_phase_check.json"), "w") as f:
        json.dump(out, f, default=str, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
