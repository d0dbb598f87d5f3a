"""Time the ordered segment fold on a CUDA card, against its yardsticks.

Usage (from the repo root, on a machine with a card)::

    PYTHONPATH=src python src/repro_torch/launch/fold_timing.py [--seed 0]

Prints one JSON object. It imports ``repro_torch.kernels.segment`` from
whatever ``PYTHONPATH`` names, so pointing ``PYTHONPATH`` at another
checkout's ``src`` times that checkout's kernel with the same inputs (it
uses ``segment.segment_fold`` alone). Two inputs:

- ``chip_smoke.py``'s phase 1 stream, plan-sorted: k = 64 ER matrices of
  65,536 x 512 with 512 nonzeros a column (16,777,216 elements) folded
  into as many segments, the same draws from ``--seed``. Timed: the
  wrapper (its zero fill included), the zero fill alone (``torch.zeros``
  of the output) and ``index_add_`` into an output allocated in advance,
  each bracketed by events (host time before a launch included), and the
  device time of one wrapper call split by ``torch.profiler``;
- one run of 2^24 f32 (:func:`long_run`): the wrapper, and the floor of
  its chain of dependent f32 adds at the card's top SM clock; the same
  values rounded to bf16, folded in bf16.

Times are medians of CUDA-event brackets after one warm-up.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess

import numpy as np
import torch

from repro_torch.core.sparse import stable_argsort

#: Cycles of one dependent f32 add on the card (the latency of FADD on
#: Hopper), the step of a strict left fold's chain.
ADD_CYCLES = 4


def cuda_ms(fn, reps: int) -> float:
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def smi(query: str) -> str:
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def chain_bound_ms(n_adds: int) -> float:
    """Floor of ``n_adds`` dependent f32 adds at the card's top SM clock."""
    mhz = float(smi("clocks.max.sm").split()[0])
    return n_adds * ADD_CYCLES / (mhz * 1e3)


def device_split(fn, reps: int = 5) -> dict:
    """``reps`` calls of ``fn`` (a wrapper call) under ``torch.profiler``,
    per call: device ms of the segment-fold kernel, of the output's zero
    fill (a fill kernel or a memset) and of everything on the device."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch.profiler_settle import settle

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        settle()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    split = {"kernel_ms": 0.0, "fill_ms": 0.0, "device_ms": 0.0}
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        ms = (getattr(ev, "self_device_time_total", 0) or 0) / 1e3 / reps
        split["device_ms"] += ms
        if "segment_fold" in ev.key:
            split["kernel_ms"] += ms
        elif "Fill" in ev.key or "Memset" in ev.key:
            split["fill_ms"] += ms
    return split


def phase1_stream(seed: int, dev):
    """``(vals, gid, segments)``: ``chip_smoke.py``'s phase 1 collection
    (the same draws) concatenated, stably sorted by key, each element's
    gid the rank of its key among the distinct keys."""
    k, m, n, d = 64, 65536, 512, 512
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, m, size=(k, n * d), dtype=np.int32)
    cols = np.repeat(np.arange(n, dtype=np.int32), d)
    vals = rng.standard_normal((k, n * d), dtype=np.float32)
    keys = (torch.from_numpy(cols).to(dev) * m
            + torch.from_numpy(rows).to(dev)).reshape(-1)
    order = stable_argsort(keys)
    sk = keys[order]
    is_new = torch.ones_like(sk, dtype=torch.bool)
    is_new[1:] = sk[1:] != sk[:-1]
    gid = (torch.cumsum(is_new, 0, dtype=torch.int32) - 1)
    v = torch.from_numpy(vals).to(dev).reshape(-1)[order]
    return v, gid, keys.numel()


def long_run(n: int, seed: int, dev):
    """``(vals, gid)``: ``n`` standard-normal f32 in one segment (id 0)."""
    rng = np.random.default_rng(seed)
    vals = torch.from_numpy(rng.standard_normal(n, dtype=np.float32)).to(dev)
    return vals, torch.zeros(n, dtype=torch.int32, device=dev)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("fold_timing: needs a CUDA card")
    from repro_torch.kernels import segment

    dev = torch.device("cuda")
    v, gid, segs = phase1_stream(args.seed, dev)
    acc = torch.zeros(segs, device=dev)
    gid_long = gid.long()
    lv, lg = long_run(1 << 24, args.seed, dev)
    lbf = lv.to(torch.bfloat16)
    report = {
        "card": smi("name,power.limit"),
        "segment_fold_ms": cuda_ms(
            lambda: segment.segment_fold(v, gid, segs), 20),
        "zero_fill_ms": cuda_ms(
            lambda: torch.zeros(segs, dtype=v.dtype, device=dev), 20),
        "index_add_ms": cuda_ms(lambda: acc.index_add_(0, gid_long, v), 20),
        "device_split": device_split(
            lambda: segment.segment_fold(v, gid, segs)),
        "elements": v.numel(), "segments": segs,
        "long_run_elements": lv.numel(),
        "long_run_ms": cuda_ms(lambda: segment.segment_fold(lv, lg, 1), 3),
        "long_run_chain_bound_ms": chain_bound_ms(lv.numel()),
        "long_run_bf16_ms": cuda_ms(lambda: segment.segment_fold(
            lbf, lg, 1), 3),
    }
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
