"""Which of PyTorch's CUDA scatter and segment sums add in index order.

Run from the repository root on a machine with one CUDA device:

    python3 scripts/probe_scatter_order.py

For 5 seeded tables of 500 segments of 1 to 399 float32 values (scattered
in a random order), it compares each candidate on the card with a
sequential float32 fold in index order (``np.add.at`` on the CPU, the order
the port's CPU route and XLA's CPU scatter add in) and prints, per
candidate, how many segment sums are equal bit for bit, in all and among
the segments shorter than 32. The candidates: ``index_add_``, the same
and ``index_put_(accumulate=True)`` under
``torch.use_deterministic_algorithms``, ``torch.segment_reduce`` over the
stably sorted values, and ``scatter_reduce_(..., "sum")``.
"""

from __future__ import annotations

import sys

import numpy as np


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    rng = np.random.default_rng(0)
    res = {}
    for _ in range(5):
        n = 500
        lens = rng.integers(1, 400, n)
        dst = np.repeat(np.arange(n), lens)[rng.permutation(lens.sum())]
        vals = (rng.random(len(dst)) * rng.choice([1e-3, 1, 30], len(dst))) \
            .astype(np.float32)
        want = np.zeros(n, np.float32)
        np.add.at(want, dst, vals)
        d_t = torch.as_tensor(dst, device="cuda")
        v_t = torch.as_tensor(vals, device="cuda")
        order = torch.as_tensor(np.argsort(dst, kind="stable"), device="cuda")
        zeros = torch.zeros(n, device="cuda")
        got = {"index_add_": zeros.clone().index_add_(0, d_t, v_t)}
        torch.use_deterministic_algorithms(True)
        try:
            got["index_add_ (deterministic)"] = zeros.clone().index_add_(
                0, d_t, v_t)
            got["index_put_ (deterministic)"] = zeros.clone().index_put_(
                (d_t,), v_t, accumulate=True)
        finally:
            torch.use_deterministic_algorithms(False)
        got["segment_reduce"] = torch.segment_reduce(
            v_t[order], "sum", lengths=torch.as_tensor(
                np.bincount(dst, minlength=n), device="cuda"))
        got["scatter_reduce_ sum"] = zeros.clone().scatter_reduce_(
            0, d_t, v_t, "sum")
        short = lens < 32
        for name, t in got.items():
            eq = t.cpu().numpy() == want
            tot = res.setdefault(name, [0, 0, 0, 0])
            tot[0] += int(eq.sum())
            tot[1] += n
            tot[2] += int(eq[short].sum())
            tot[3] += int(short.sum())
    for name, (a, b, c, d) in res.items():
        print(f"{name}: {a} of {b} segment sums equal the in-order fold; "
              f"{c} of {d} segments shorter than 32", flush=True)
    print(f"torch {torch.__version__}, {torch.cuda.get_device_name(0)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
