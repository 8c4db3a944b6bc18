"""Where a Word2Vec training run spends its time on the card.

Run from the repository root on a machine with one CUDA device:

    python3 scripts/profile_word2vec_training.py

Takes chip_smoke.py's Word2Vec cell (1,000,000 tokens in text8's layout from
seed 0; vectorSize 100, window 5, negative 5, numIter 3, batchSize 1024,
learningRate 0.025, minCount 1, subsample 1e-3) and times on the host clock
what ``Word2VecTrainBatchOp`` does: ``build_vocab``, ``make_pairs`` and the
whole sharded step loop (``train_skipgram_sharded``). Then the first
``TRACED_STEPS`` steps of the same loop run under ``torch.profiler``: the
script prints the launches per step, device time by kernel group and the
device's idle share of the traced wall time; the Chrome trace goes to
``build/word2vec_training_trace.json``.
"""

from __future__ import annotations

import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

TRACED_STEPS = 200
GROUPS = (("sgns_block_grads", ("sgns_block_grads_kernel",)),
          ("negative draws", ("distribution", "searchsorted")),
          ("sort (dedup)", ("RadixSort", "radixSort")),
          ("cumsum (dedup)", ("DeviceScan", "cumsum")),
          ("index_add_ / scatter (dedup, push)", ("indexFunc", "scatter")),
          ("gather (pull, cache)", ("index_elementwise", "gather")),
          ("uploads (once a call)", ("HtoD",)),
          ("copies and fills", ("Memcpy", "Memset", "copy", "Fill",
                                "CatArrayBatched")))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("FAIL: no CUDA device")
        return 1
    import chip_smoke
    from alink_tpu_torch.embedding import skipgram
    from alink_tpu_torch.native import kernels

    kernels.build()
    docs = [d.split(" ") for d in chip_smoke.text8_corpus(
        chip_smoke.W2V_TOKENS, chip_smoke.SEED)]
    cfg = skipgram.SkipGramConfig()
    t0 = time.perf_counter()
    vocab, counts = skipgram.build_vocab(docs, 1)
    t1 = time.perf_counter()
    pairs = skipgram.make_pairs(docs, vocab, counts, cfg.window,
                                cfg.subsample, cfg.seed)
    t2 = time.perf_counter()
    skipgram.train_skipgram_sharded(pairs, len(vocab), counts, cfg)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    steps = max(1, len(pairs) // cfg.batch_size) * cfg.epochs
    print(f"{torch.cuda.get_device_name(0)}; host clock: build_vocab "
          f"{t1 - t0:.3f} s ({len(vocab)} types), make_pairs {t2 - t1:.3f} s "
          f"({len(pairs)} pairs), train_skipgram_sharded {t3 - t2:.3f} s "
          f"({steps} steps, {steps / (t3 - t2):.0f} steps/s)")

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    short = skipgram.SkipGramConfig(epochs=1)
    window = pairs[:TRACED_STEPS * cfg.batch_size]
    skipgram.train_skipgram_sharded(window, len(vocab), counts, short)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        skipgram.train_skipgram_sharded(window, len(vocab), counts, short)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = [(ev.self_device_time_total, ev.count, ev.key)
            for ev in prof.key_averages()
            if ev.device_type == DeviceType.CUDA
            and ev.self_device_time_total > 0]
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    launches = sum(r[1] for r in rows)
    to_host = sum(r[1] for r in rows if "DtoH" in r[2])
    print(f"traced {TRACED_STEPS} steps: wall {wall_us / 1e3:.1f} ms "
          f"({wall_us / TRACED_STEPS:.1f} us a step), device busy "
          f"{busy / 1e3:.1f} ms (kernel time summed; idle share "
          f"{max(0.0, 1 - busy / wall_us):.3f}); {launches} device "
          f"operations, {launches / TRACED_STEPS:.1f} a step; {to_host} "
          f"copies to the host (the cache's hit count, once a call)")
    sums = dict.fromkeys([g for g, _ in GROUPS] + ["other elementwise"], 0.0)
    counts_by = dict.fromkeys(sums, 0)
    for dev, count, key in rows:
        group = next((g for g, keys in GROUPS
                      if any(k in key for k in keys)), "other elementwise")
        sums[group] += dev
        counts_by[group] += count
    print("device us per step by group (operations per step, share): "
          + ", ".join(f"{g} {v / TRACED_STEPS:.2f} "
                      f"({counts_by[g] / TRACED_STEPS:.1f}, "
                      f"{v / max(busy, 1e-9):.3f})"
                      for g, v in sums.items()))
    for dev, count, key in rows[:20]:
        print(f"  {dev / 1e3:9.3f} ms  {count:6d}x  {dev / busy:6.3f}  "
              f"{key[:90]}")
    out = os.path.join(ROOT, "build")
    os.makedirs(out, exist_ok=True)
    prof.export_chrome_trace(os.path.join(out, "word2vec_training_trace.json"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
