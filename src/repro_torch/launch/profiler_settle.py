"""The kernel records ``torch.profiler`` loses right after it starts, and the
wait that keeps them.

Usage (from the repo root, on a machine with a card)::

    PYTHONPATH=src python src/repro_torch/launch/profiler_settle.py \\
        [--seed 0] [--reps 50]

CUPTI starts recording a few milliseconds after ``profile.__enter__``
returns, and the kernels launched in that time are missing from the
profile. A profile whose launches are counted against a wrapper's counter
therefore waits :data:`SETTLE_S` first (:func:`settle`).

The probe profiles one call of ``spkadd(..., algorithm="tree")`` over
``chip_smoke.py``'s phase 1 collection (k = 64 matrices of 65,536 x 512, 512
nonzeros a column, the same draws from ``--seed``; 63 two-way adds, each
with one segment-fold launch), ``--reps`` times launched at once and
``--reps`` times after :func:`settle`. It prints one JSON object: the card,
the wrapper's launch count, and for each way the profiles whose device
records or segment-fold records fall short of the most seen.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch

#: Seconds to wait after ``torch.profiler`` starts before launching what it
#: must see whole.
SETTLE_S = 0.05


def settle() -> None:
    """Wait, inside a just-started ``torch.profiler``, until CUPTI records:
    finish what is queued, then sleep :data:`SETTLE_S`."""
    torch.cuda.synchronize()
    time.sleep(SETTLE_S)


def profiled_counts(fn, settled: bool) -> tuple:
    """``(device records, segment-fold records)`` of one profiled call of
    ``fn``, launched at once or after :func:`settle`."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        if settled:
            settle()
        fn()
        torch.cuda.synchronize()
    records = folds = 0
    for ev in prof.key_averages():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            records += ev.count
            if "segment_fold" in ev.key:
                folds += ev.count
    return records, folds


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profiler_settle: needs a CUDA card")
    from repro_torch.core import sparse as S
    from repro_torch.core import spkadd as A
    from repro_torch.kernels import _build, segment

    _build.build_all()
    dev = torch.device("cuda")
    k, m, n, d = 64, 65536, 512, 512
    rng = np.random.default_rng(args.seed)
    rows = rng.integers(0, m, size=(k, n * d), dtype=np.int32)
    cols = np.repeat(np.arange(n, dtype=np.int32), d)
    vals = rng.standard_normal((k, n * d), dtype=np.float32)
    mats = [S.from_coords(rows[i], cols, vals[i], (m, n), device=dev)
            for i in range(k)]

    def tree():
        return A.spkadd(mats, algorithm="tree")

    tree()
    torch.cuda.synchronize()
    segment.segment_fold.launches = 0
    tree()
    torch.cuda.synchronize()
    launches = segment.segment_fold.launches
    report = {"card": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0],
        "torch": torch.__version__, "reps": args.reps,
        "segment_fold_launches": launches}
    for way, settled in (("at_once", False), ("settled", True)):
        counts = []
        for _ in range(args.reps):
            tree()
            torch.cuda.synchronize()
            counts.append(profiled_counts(tree, settled))
        most = max(r for r, _ in counts)
        report[way] = {
            "most_records": most,
            "short": [[r, f] for r, f in counts
                      if r < most or f != launches]}
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
