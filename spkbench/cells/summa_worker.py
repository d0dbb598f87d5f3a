"""``system: summa_worker``: one worker of a 2D sparse SUMMA grid, driven in
a closed loop.

The worker holds its A stripe ``(n / grid, n)`` and its B stripe ``(n, n /
grid)`` of a graph's adjacency matrix (``reference/generators.py``
``graph_stripes``; the configuration's ``graph`` names the law that places
the edges), dense f32; the gathers that bring them are not run. Each block
is one ``repro_torch.core.spgemm.summa_block`` call (the stage products,
the partials at the configuration's padded capacity, their SpKAdd
reduction and the dense C tile), synchronized after it. The traffic's
``pool`` of stripe pairs is drawn from the seed at set-up and cycled.

``correct``: a sample of the window's blocks, drawn from the seed by
reservoir sampling, is kept and compared once the window has closed with
the float64 reference (``reference/summa.py``) of its stripe pair: by the
largest entry of ``|C - C_ref|`` over the largest ``|C_ref|``, and by the
positions nonzero on one side only.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from spkbench.harness import Check, Window, percentile, sync
from spkbench.reference import generators as gens
from spkbench.reference import roofline
from spkbench.reference import summa as ref


def sizes(cfg: dict) -> tuple:
    """``(n, tile, stages, cap)``: the matrix side, the worker's block
    side, the stages, and each partial's padded capacity."""
    n = 1 << cfg["scale"]
    return n, n // cfg["grid"], cfg["grid"], cfg["partial_cap"]


def stripes(cfg: dict, seed: int, pair: int, device) -> tuple:
    """Stripe pair ``pair`` of the pool drawn from ``seed``."""
    _, tile, _, _ = sizes(cfg)
    gen = gens.torch_generator(seed, (1, pair), device)
    return gens.graph_stripes(gen, cfg["graph"], scale=cfg["scale"],
                              edgefactor=cfg["edgefactor"], tile=tile,
                              device=device)


def setup(cfg: dict, traffic: dict, seed: int, device) -> dict:
    from repro_torch.core import spgemm

    # the configuration states f32 products: TF32 off, as the port asks
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _, tile, stages, cap = sizes(cfg)
    t0 = time.perf_counter()
    pairs = [stripes(cfg, seed, p, device) for p in range(traffic["pool"])]
    sync(device)
    t1 = time.perf_counter()
    st = {"cfg": cfg, "traffic": traffic, "device": device, "G": spgemm,
          "pairs": pairs, "stages": stages, "cap": cap, "block": 0,
          "slots": torch.zeros((traffic["sample_blocks"], tile, tile),
                               dtype=torch.float32, device=device),
          "slot_pair": [], "rng": np.random.default_rng(
              gens.seed_sequence(seed, 3))}
    for _ in range(traffic["warmup_rounds"]):
        for p in range(len(pairs)):
            _block(st, p)
            sync(device)
    st["setup_parts"] = {"inputs_s": t1 - t0,
                         "warmup_s": time.perf_counter() - t1}
    return st


def _block(st: dict, pair: int) -> torch.Tensor:
    a, b = st["pairs"][pair]
    return st["G"].summa_block(a, b, st["stages"],
                               algorithm=st["traffic"]["algorithm"],
                               partial_cap_per_stage=st["cap"])


def _sample(st: dict, seen: int, pair: int, c: torch.Tensor) -> None:
    """Reservoir sampling over the window's blocks: block ``seen`` (0-based)
    is kept with probability ``slots / (seen + 1)``."""
    k = st["slots"].shape[0]
    j = seen if seen < k else int(st["rng"].integers(0, seen + 1))
    if j < k:
        st["slots"][j].copy_(c)
        if j < len(st["slot_pair"]):
            st["slot_pair"][j] = pair
        else:
            st["slot_pair"].append(pair)


def window(st: dict, seconds: float, spans: bool) -> Window:
    G, device = st["G"], st["device"]
    pool = len(st["pairs"])
    spans = spans and torch.device(device).type == "cuda"  # CUDA events
    block_ms, partials_ms, reduce_ms = [], [], []
    marks = []
    run_reduction = G.spkadd_run
    if spans:
        def marked(*args, **kw):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.append(ev)
            return run_reduction(*args, **kw)
        G.spkadd_run = marked
    try:
        sync(device)
        t_begin = time.perf_counter()
        deadline = t_begin + seconds
        while True:
            pair = st["block"] % pool
            t0 = time.perf_counter()
            if spans:
                e0 = torch.cuda.Event(enable_timing=True)
                e2 = torch.cuda.Event(enable_timing=True)
                e0.record()
            c = _block(st, pair)
            if spans:
                e2.record()
            _sample(st, len(block_ms), pair, c)
            sync(device)
            t1 = time.perf_counter()
            block_ms.append((t1 - t0) * 1e3)
            st["block"] += 1
            if spans:
                partials_ms.append(e0.elapsed_time(marks[-1]))
                reduce_ms.append(marks[-1].elapsed_time(e2))
            if t1 >= deadline:
                break
    finally:
        G.spkadd_run = run_reduction
    window_s = t1 - t_begin
    e2e = {"block_ms": window_s * 1e3 / len(block_ms),
           "block_p95_ms": percentile(block_ms, 95)}
    return Window(e2e=e2e, attempted=len(block_ms), failed=0,
                  spans={"partials_ms": partials_ms, "reduce_ms": reduce_ms}
                  if spans else {},
                  info={"blocks": len(block_ms), "window_s": window_s,
                        "block_ms_median": percentile(block_ms, 50)})


def traced(st: dict, tr) -> None:
    """``trace_blocks`` more blocks under the profiler; the partition
    kernel's launches note their bytes."""
    from repro_torch.kernels import partition

    n, tile, stages, _ = sizes(st["cfg"])
    launch = partition.partitioned_accumulate_raw
    valid, out_bytes = [], [0]

    def counted(keys, vals, chunk_id, part_id, *, mn, **kw):
        out = launch(keys, vals, chunk_id, part_id, mn=mn, **kw)
        valid.append((keys < mn).sum())
        out_bytes[0] += keys.shape[0] * mn * 4
        return out

    units = st["traffic"]["trace_blocks"]
    counted.launches = launch.launches  # the port counts its launches
    partition.partitioned_accumulate_raw = counted
    try:
        with tr.profile() as prof:
            tr.settle()
            with tr.range("spkbench.traced_window"):
                for _ in range(units):
                    with tr.range("spkbench.block"):
                        _block(st, st["block"] % len(st["pairs"]))
                        sync(st["device"])
                    st["block"] += 1
    finally:
        partition.partitioned_accumulate_raw = launch
        launch.launches = counted.launches
    tr.read(prof, "spkbench.traced_window")
    blk = n // stages
    tr.work["stage_matmul.flops"] = (units * stages
                                     * roofline.matmul_flops(tile, blk, tile))
    tr.work["partition.bytes"] = (8 * sum(int(v) for v in valid)
                                  + out_bytes[0])


def check(st: dict) -> dict:
    """The sampled blocks against the float64 reference of their pairs; a
    NaN, or no block kept, reads as an infinite gap."""
    stages = sizes(st["cfg"])[2]
    lim = st["cfg"]["limits"]
    refs = {}
    gap, support = (0.0, 0) if st["slot_pair"] else (float("inf"), 1)
    for j, pair in enumerate(st["slot_pair"]):
        if pair not in refs:
            a, b = st["pairs"][pair]
            refs[pair] = ref.worker_block(a, b, stages, "float64")[0]
        g = ref.relative_gap(st["slots"][j], refs[pair])
        gap = max(gap, g if g == g else float("inf"))
        support = max(support, ref.support_gap(st["slots"][j], refs[pair]))
    return {"c_gap": Check(gap, lim["c_gap"]),
            "c_support_gap": Check(support, lim["c_support_gap"])}


def control(cfg: dict, traffic: dict, seed: int, device) -> dict:
    """The control's readings on ``seed``'s pool: the reference computed in
    TF32 (``reference/summa.py``) in the port's place, against the float64
    reference, by the numbers ``check`` compares, and the largest stage
    partial's nonzeros (against the padded capacity)."""
    stages = sizes(cfg)[2]
    gap, support, fill = 0.0, 0, 0
    for p in range(traffic["pool"]):
        a, b = stripes(cfg, seed, p, device)
        want, f = ref.worker_block(a, b, stages, "float64")
        got = ref.worker_block(a, b, stages, "tf32")[0]
        gap = max(gap, ref.relative_gap(got, want))
        support = max(support, ref.support_gap(got, want))
        fill = max(fill, f)
    return {"c_gap": gap, "c_support_gap": support, "largest_partial": fill}
