#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's SpKAdd main path once on one CUDA card.

    python3 chip_smoke.py [--seed N]

Run from the root of a checkout; it imports ``src/repro_torch`` (never JAX,
never the reference package ``repro``) and exits non-zero, printing no
result, when no CUDA card is present or the package is missing.

0. Build the six CUDA kernel libraries from ``src/repro_torch/kernels/csrc``
   with ``nvcc`` (one process per source, in parallel) and print the build
   time, the compiler's register/shared-memory report and the card.
1. ``vec``: one collection through ``spkadd_auto`` — k = 64 ER matrices of
   65,536 × 512 with 512 nonzeros per column (16,777,216 nonzeros), the
   stage reduction of a sparse SUMMA. Dispatch must say ``vec``; the
   partition kernel must launch; one counted sort; the result must equal
   the ``sorted`` path bitwise and a float64 numpy sum to 1e-5.
2. ``sorted``: phase 1's collection through ``spkadd_run(..., "sorted")``;
   the segment-fold kernel must launch.
3. ``hash``: B = 512 collections (one per tenant, a stream-service
   co-flush) of k = 16 matrices of 65,536 × 256 with 512 nonzeros each,
   through ``spkadd_batched``. Dispatch must say ``hash``; the sliding-hash
   kernel must launch with zero sorts before compaction and one compaction
   sort; every row must equal the batched ``sorted`` path bitwise and a
   float64 numpy sum to 1e-5.
4. ``family``: phase 1's collection through the algorithm family's front
   door, ``spkadd(mats, a)`` for ``incremental``, ``tree``, ``sorted``,
   ``spa``, ``vec`` and ``blocked_spa``. Every result but ``tree``'s must
   equal ``sorted`` bitwise once exact zeros are dropped (the
   dense-accumulator members drop them, the merge paths keep them);
   ``tree`` adds pairwise and, like every member, must equal the float64
   numpy sum to 1e-5. ``vec`` and ``blocked_spa`` must launch the SPA
   kernels (count, offsets, scatter, fold).
5. ``hash_alg``: the faithful hash algorithm, ``spkadd(mats, "hash")``, on
   k = 64 ER matrices of 65,536 × 32 with 512 nonzeros per column
   (1,048,576 nonzeros, a 2^22-slot table): bitwise equal to ``sorted``
   (keys, values and nnz, nothing dropped); ``ops.hash_symbolic`` must
   equal ``symbolic_nnz`` and take the parallel route (a grid over the
   stream, the table in device memory); both hash kernels must launch.
6. ``delta_sync``: SmolLM-135M's parameter tree (:data:`SMOLLM_135M_SHAPES`,
   162,826,560 f32 parameters on the dyadic grid of
   ``benchmarks/delta_sync.py``) through ``DeltaPublisher`` (k_fraction
   0.01, block selector) to replica A (a sync every epoch) and replica B
   (a window-4 catch-up, one ragged SpKAdd) over 8 epochs: both replicas
   equal the publisher's shadow bitwise, the block top-k kernel and the
   engine's kernels launch, and epoch 1's frames equal those of the
   selection's plain version, byte for byte (:func:`run_delta_sync`).
7. One profiled call of each phase (device time by kernel, busy share),
   then each of the seven kernels against its plain PyTorch version on the
   card, on the inputs its path gives it: bitwise (tolerance 0). The SPA
   row adds each stage's time, the bytes its design moves and its time at
   other tile sizes; the symbolic row its route and the one-thread route's
   time on a table of ``cap`` slots. Then JSON lines of the phases'
   end-to-end times, the profiles and the kernel numbers (median ms by
   CUDA events, bound, plain and library times), the card's name and power
   limit, and as the last line ``{"ok": true, "device": {...}}``.

Every launch counter is set to 0 just before its path runs and read just
after; launches made to time or compare a kernel do not count.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "src")

# H100 SXM peaks (NVIDIA data sheet): device memory rate, and the float32
# rate outside the tensor cores (the kernels' f32 adds).
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12


def bound(nbytes: int, adds: int):
    """The least time the card could take: the larger of the bytes moved
    over the memory rate and the f32 adds over the f32 rate. Returns
    ``(ms, "bytes" | "operations")``."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = adds / F32_OPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                            "operations")


#: The parameter tree of SmolLM-135M (HF HuggingFaceTB/SmolLM-135M) as the
#: reference builds it (``build_model(get_config("smollm-135m")).init``,
#: config ``src/repro/configs/smollm_135m.py``): 12 f32 leaves, 162,826,560
#: parameters. Written out because this script imports nothing of the
#: reference; ``tests/test_torch_delta_sync.py`` holds it against
#: ``jax.eval_shape`` of that init.
SMOLLM_135M_SHAPES = {
    "embed": (49152, 576),
    "final_ln": (576,),
    "head": (576, 49152),
    "layers": {
        "ln1": (30, 576), "ln2": (30, 576),
        "w1": (30, 576, 1536), "w2": (30, 1536, 576), "w3": (30, 576, 1536),
        "wk": (30, 576, 192), "wo": (30, 576, 576), "wq": (30, 576, 576),
        "wv": (30, 576, 192),
    },
}


class SmokeFailure(Exception):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs a CUDA card", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print(f"chip_smoke: {SRC}/repro_torch not found; run this script "
              f"from the root of a checkout", file=sys.stderr)
        return 1
    sys.path.insert(0, SRC)
    try:
        return run(args, torch)
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        return 1


def cuda_ms(torch, fn, reps: int) -> float:
    """Median device time of ``fn`` over ``reps`` calls (after one warm-up),
    each bracketed by CUDA events."""
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


def host_ms(torch, fn, reps: int) -> float:
    """Median host time of ``fn`` ending in a device synchronize."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def device_profile(torch, fn, wall_ms: float, top: int = 6) -> dict:
    """One call of ``fn`` under ``torch.profiler``: device time summed by
    kernel name (the ``top`` largest) and the device's busy share of
    ``wall_ms``, the call's unprofiled median host time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return device_times(torch, prof, wall_ms, top)


def device_times(torch, prof, wall_ms: float, top: int = 6) -> dict:
    """A finished profile's device time summed by kernel name (the ``top``
    largest) and the device's busy share of ``wall_ms``."""
    rows = []
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total", 0) or 0
        if us > 0:
            rows.append((ev.key[:90], us / 1e3, ev.count))
    rows.sort(key=lambda r: -r[1])
    device_ms = sum(r[1] for r in rows)
    return {"device_ms": device_ms, "wall_ms": wall_ms,
            "busy_share": device_ms / wall_ms if wall_ms else None,
            "top": [list(r) for r in rows[:top]]}


def bitwise_equal(torch, a, b) -> bool:
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


def same_coo(torch, a, b) -> bool:
    return (a.shape == b.shape and bitwise_equal(torch, a.keys, b.keys)
            and bitwise_equal(torch, a.nnz, b.nnz)
            and bitwise_equal(torch, a.vals, b.vals))


GRID = 2.0 ** -10  # benchmarks/delta_sync.py's update quantum


def grid_tree(torch, seq, shapes, lo, hi, dev, pool):
    """``shapes`` (a nested dict) filled with multiples of 2^-10 drawn in
    ``[lo, hi)`` with numpy, as f32 tensors on ``dev``: the delta-sync
    benchmark's dyadic grid, on which every f32 sum of a few such trees is
    exact in any order. Each leaf draws from its own generator, spawned in
    order from the ``SeedSequence`` ``seq``, on the threads of ``pool``."""
    paths = []

    def walk(node, prefix):
        for name, shape in node.items():
            if isinstance(shape, dict):
                walk(shape, prefix + (name,))
            else:
                paths.append((prefix + (name,), shape))

    walk(shapes, ())
    gens = [np.random.default_rng(s) for s in seq.spawn(len(paths))]
    ints = pool.map(lambda g, p: g.integers(lo, hi, p[1], dtype=np.int16),
                    gens, paths)
    out: dict = {}
    for (path, _), a in zip(paths, ints):
        node = out
        for name in path[:-1]:
            node = node.setdefault(name, {})
        node[path[-1]] = torch.from_numpy(a).to(dev).to(torch.float32) * GRID
    return out


def tree_add(a, b):
    return {k: tree_add(a[k], b[k]) if isinstance(a[k], dict) else a[k] + b[k]
            for k in a}


class FanOut:
    """One publisher's frames to several replicas' wires (each replica
    polls its own ``InProcTransport``; resends come from the publisher's
    ring through the asking replica's wire)."""

    def __init__(self, *wires):
        self.wires = wires

    def attach_publisher(self, pub) -> None:
        for w in self.wires:
            w.attach_publisher(pub)

    def send(self, frame: bytes) -> None:
        for w in self.wires:
            w.send(frame)


def run_delta_sync(torch, seed: int, dev, kernels: dict):
    """Phase ``delta_sync``: SmolLM-135M's parameter tree through the port's
    ``DeltaPublisher`` -> ``InProcTransport`` -> two ``DeltaSubscriber``s.

    8 epochs of grid updates, k_fraction 0.01, the block selector (blocks of
    4,096). Replica A syncs after every epoch (window 1); replica B sleeps
    through epochs 1-4, catches up with one ragged SpKAdd (window 4), then
    syncs after every epoch. Both must equal the
    publisher's shadow bitwise after each of their syncs, and shadow plus
    error-feedback residual must equal the true parameters bitwise (grid
    arithmetic is exact); the block top-k kernel must launch on the path;
    B's catch-up must launch the engine's kernels; epoch 1's frames must
    equal, byte for byte, the frames the same publisher state gives with
    the selection's plain version on the card. Returns the phase's numbers, the top-k launches, and the epoch-1
    input of the embed leaf's selection (for the kernel line)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import tree as T
    from repro_torch.kernels import topk_block
    from repro_torch.runtime import (DeltaPublisher, DeltaSubscriber,
                                     InProcTransport, dense_sync_bytes)

    epochs, k_fraction = 8, 0.01
    engine_kernels = ("partition", "hash_slide", "segment_fold")
    seq = np.random.SeedSequence(seed)
    pool = ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1))

    def grid(lo, hi):
        return grid_tree(torch, seq, SMOLLM_135M_SHAPES, lo, hi, dev, pool)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    params = grid(-512, 512)
    n_params = sum(x.numel() for x in T.leaves(params))
    wire_a, wire_b = InProcTransport(), InProcTransport()
    kw = dict(k_fraction=k_fraction, selector="block", device=dev)
    pub = DeltaPublisher(params, FanOut(wire_a, wire_b), window_epochs=epochs,
                         **kw)
    plain_pub = DeltaPublisher(params, InProcTransport(), **kw)
    rep_a = DeltaSubscriber(params, wire_a, device=dev)
    rep_b = DeltaSubscriber(params, wire_b, device=dev)

    def same_as_shadow(rep) -> bool:
        return all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                   for a, b in zip(T.leaves(rep.params),
                                   T.leaves(pub.shadow_params())))

    publish_ms, sync_a_ms, wire_bytes = [], [], []
    topk_launches = 0
    embed_x = None
    for epoch in range(1, epochs + 1):
        update = grid(-256, 256)
        params = tree_add(params, update)
        torch.cuda.synchronize()
        for fn in kernels.values():
            fn.launches = 0
        t0 = time.perf_counter()
        stats = pub.publish(params)
        torch.cuda.synchronize()
        publish_ms.append((time.perf_counter() - t0) * 1e3)
        topk_launches += kernels["topk_block"].launches
        wire_bytes.append(stats.bytes)
        if epoch == 1:
            # the same epoch from the same state, the selection's plain
            # version swapped in for the kernel (ops calls it through the
            # module), must give the same bytes
            embed_x = update["embed"].reshape(-1).clone()
            kernel_fn = topk_block.topk_block_raw
            topk_block.topk_block_raw = topk_block.topk_block_plain
            try:
                plain_pub.publish(params)
            finally:
                topk_block.topk_block_raw = kernel_fn
            check(plain_pub.frames_for(1) == pub.frames_for(1),
                  "phase delta_sync: epoch-1 frames differ from the plain "
                  "top-k's")
            del plain_pub
        del update
        t0 = time.perf_counter()
        report = rep_a.sync()
        torch.cuda.synchronize()
        sync_a_ms.append((time.perf_counter() - t0) * 1e3)
        check(report.window == 1 and rep_a.applied_epoch == epoch,
              f"phase delta_sync: replica A at epoch {epoch}: {report}")
        check(same_as_shadow(rep_a), f"phase delta_sync: replica A differs "
              f"from the shadow at epoch {epoch}")
        if epoch == 4:
            # B's one catch-up, under the profiler: a single call that
            # cannot be repeated on the same state
            torch.cuda.synchronize()
            for fn in kernels.values():
                fn.launches = 0
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                report = rep_b.sync()
                torch.cuda.synchronize()
                catchup_ms = (time.perf_counter() - t0) * 1e3
            catchup_profile = device_times(torch, prof, catchup_ms)
            catchup_launches = {name: kernels[name].launches
                                for name in engine_kernels}
            check(report.window == 4 and rep_b.applied_epoch == epoch,
                  f"phase delta_sync: replica B at epoch {epoch}: {report}")
        elif epoch > 4:
            report = rep_b.sync()
            check(report.window == 1 and rep_b.applied_epoch == epoch,
                  f"phase delta_sync: replica B at epoch {epoch}: {report}")
        if epoch >= 4:
            check(same_as_shadow(rep_b), f"phase delta_sync: replica B "
                  f"differs from the shadow at epoch {epoch}")
    check(topk_launches > 0, "phase delta_sync: top-k kernel not launched")
    # error feedback loses nothing: what was not shipped is the residual
    for p, s, r in zip(T.leaves(params), pub._shadow, pub._residual):
        check(torch.equal(p.reshape(-1), s + r), "phase delta_sync: shadow "
              "+ residual differs from the parameters")
    check(sum(catchup_launches.values()) > 0, "phase delta_sync: the "
          "window-4 catch-up launched no engine kernel")
    dense = dense_sync_bytes(params)
    phase = {
        "model": "smollm-135m", "params": n_params, "leaves":
        len(T.leaves(params)), "epochs": epochs, "k_fraction": k_fraction,
        "selector": "block", "selected_per_epoch": stats.selected,
        "publish_ms": publish_ms, "sync_a_ms": sync_a_ms,
        "catchup_b_ms": catchup_ms, "catchup_b_profile": catchup_profile,
        "wire_bytes_per_sync": wire_bytes,
        "dense_sync_bytes": dense,
        "catchup_launches": catchup_launches,
        "peak_mem_bytes": torch.cuda.max_memory_allocated(dev)}
    log(f"phase delta_sync: {n_params} params, publish ms "
        f"{[round(t, 1) for t in publish_ms]}, sync A ms "
        f"{[round(t, 1) for t in sync_a_ms]}, catch-up B "
        f"{catchup_ms:.1f} ms, wire {wire_bytes[-1]} B of "
        f"{dense} B dense per sync, {stats.selected} selected, top-k "
        f"launches {topk_launches}, catch-up launches {catchup_launches}, "
        f"peak {phase['peak_mem_bytes'] / 2**30:.2f} GiB; replicas A and B "
        f"== shadow bitwise")
    pool.shutdown()

    def one_sync_round():
        # params unchanged: each round ships the residual's heaviest entries
        pub.publish(params)
        rep_a.sync()

    return phase, topk_launches, embed_x, one_sync_round


def run(args, torch) -> int:
    from repro_torch import obs
    from repro_torch.core import engine as E
    from repro_torch.core import sparse as S
    from repro_torch.core import spkadd as A
    from repro_torch.kernels import _build, hash_accum, hash_slide, ops as kops
    from repro_torch.kernels import partition, segment, spa_accum, topk_block

    dev = torch.device("cuda")
    card = nvidia_smi_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    # ---- 0. build -------------------------------------------------------
    t0 = time.monotonic()
    _build.build_all()
    build_s = time.monotonic() - t0
    log(f"kernel build: {build_s:.2f} s (nvcc {_build.find_nvcc()})")
    for name in _build.SOURCES:
        for line in _build.build_log(name).splitlines():
            if "Used" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")
    budget = kops.device_smem_budget(dev)
    log(f"shared-memory budget per block: {budget} B")
    kernels = {
        "partition": partition.partitioned_accumulate_raw,
        "hash_slide": hash_slide.hash_slide_raw,
        "segment_fold": segment.segment_fold,
        "spa_accum": spa_accum.spa_accumulate_raw,
        "hash_accum": hash_accum.hash_accumulate_raw,
        "hash_symbolic": hash_accum.hash_symbolic_raw,
        "topk_block": topk_block.topk_block_raw,
    }

    def reset_counts():
        for fn in kernels.values():
            fn.launches = 0
        hash_accum.hash_symbolic_raw.serial_launches = 0

    rng = np.random.default_rng(args.seed)
    phases = {}
    stamp = [time.monotonic()]

    def took() -> float:
        """Seconds since the last call (phase wall time, host clock)."""
        now = time.monotonic()
        stamp[0], elapsed = now, now - stamp[0]
        return elapsed

    # ---- 1. vec: one collection through spkadd_auto ---------------------
    k1, m1, n1, d1 = 64, 65536, 512, 512
    nnz1 = n1 * d1
    rows1 = rng.integers(0, m1, size=(k1, nnz1), dtype=np.int32)
    cols1 = np.repeat(np.arange(n1, dtype=np.int32), d1)
    vals1 = rng.standard_normal((k1, nnz1), dtype=np.float32)
    mats = [S.from_coords(rows1[i], cols1, vals1[i], (m1, n1))
            for i in range(k1)]
    sig, alg = E.explain_dispatch(mats)
    log(f"phase vec: k={sig.k} density={sig.density:.4f} "
        f"cf={sig.compression:.4f} -> {alg}")
    check(alg == "vec", f"phase vec dispatched {alg!r}, expected 'vec'")
    torch.cuda.synchronize()
    reset_counts()
    sorts0 = S.sort_calls()
    out_vec = E.spkadd_auto(mats)
    torch.cuda.synchronize()
    launches = {"partition": kernels["partition"].launches}
    vec_sorts = S.sort_calls() - sorts0
    check(launches["partition"] > 0, "phase vec: partition kernel not launched")
    check(vec_sorts == 1, f"phase vec: {vec_sorts} counted sorts, expected 1")
    geom1 = kops.partitioned_launch_geometry(
        out_vec.cap, m=m1, n=n1, smem_budget_bytes=budget)
    log(f"phase vec: partition launches={launches['partition']} "
        f"sorts={vec_sorts} geometry={geom1._asdict()}")

    # numpy float64 reference (independent of the port's folds)
    keys_np = (cols1[None, :].astype(np.int64) * m1 + rows1).reshape(-1)
    ref64 = np.bincount(keys_np, weights=vals1.reshape(-1).astype(np.float64),
                        minlength=m1 * n1)
    distinct = np.flatnonzero(np.bincount(keys_np, minlength=m1 * n1))
    nnz_out = int(out_vec.nnz)
    check(nnz_out == distinct.size,
          f"phase vec: nnz {nnz_out} != distinct keys {distinct.size}")
    ok_keys = out_vec.keys[:nnz_out].cpu().numpy()
    check(np.array_equal(ok_keys, distinct), "phase vec: keys differ from numpy")
    ok_vals = out_vec.vals[:nnz_out].cpu().numpy()
    check(np.isfinite(ok_vals).all(), "phase vec: non-finite values")
    check(np.allclose(ok_vals, ref64[distinct], rtol=1e-5, atol=1e-5),
          "phase vec: values differ from the float64 numpy sum beyond 1e-5")
    phases["vec"] = {"k": k1, "m": m1, "n": n1, "total_nnz": k1 * nnz1,
                     "out_nnz": nnz_out,
                     "ms": host_ms(torch, lambda: E.spkadd_auto(mats), 5)}
    phases["vec"]["phase_s"] = took()

    # ---- 2. sorted: the same collection through spkadd_run --------------
    torch.cuda.synchronize()
    reset_counts()
    out_sorted = E.spkadd_run(mats, algorithm="sorted")
    torch.cuda.synchronize()
    launches["segment_fold"] = kernels["segment_fold"].launches
    check(launches["segment_fold"] > 0,
          "phase sorted: segment-fold kernel not launched")
    check(same_coo(torch, out_vec, out_sorted),
          "phase vec: spkadd_auto (vec) is not bitwise equal to sorted")
    log(f"phase sorted: segment_fold launches={launches['segment_fold']}; "
        f"vec == sorted bitwise")
    phases["sorted"] = {
        "ms": host_ms(torch, lambda: E.spkadd_run(mats, algorithm="sorted"),
                      5)}
    phases["sorted"]["phase_s"] = took()

    # ---- 3. hash: B collections through spkadd_batched ------------------
    B2, k2, m2, n2, per2 = 512, 16, 65536, 256, 512
    rows2 = rng.integers(0, m2, size=(k2, B2, per2), dtype=np.int32)
    cols2 = np.tile(np.repeat(np.arange(n2, dtype=np.int32), per2 // n2),
                    (B2, 1))
    vals2 = rng.standard_normal((k2, B2, per2), dtype=np.float32)
    stacked = [S.from_coords(rows2[i], cols2, vals2[i], (m2, n2))
               for i in range(k2)]
    sig2, req2, eff2 = E.explain_batched_dispatch(stacked)
    log(f"phase hash: B={B2} k={sig2.k} cf={sig2.compression:.4f} -> "
        f"{req2}/{eff2}")
    check(eff2 == "hash", f"phase hash dispatched {eff2!r}, expected 'hash'")
    compactions0 = obs.counter("engine.hash.compaction_sorts").value
    torch.cuda.synchronize()
    reset_counts()
    out_hash = E.spkadd_batched(stacked)
    torch.cuda.synchronize()
    launches["hash_slide"] = kernels["hash_slide"].launches
    check(launches["hash_slide"] > 0, "phase hash: hash kernel not launched")
    presort = obs.gauge("engine.hash.presort_sorts").value
    compactions = obs.counter("engine.hash.compaction_sorts").value \
        - compactions0
    check(presort == 0, f"phase hash: {presort} sorts before compaction")
    check(compactions == 1, f"phase hash: {compactions} compaction sorts")
    geom2 = kops.hash_launch_geometry(out_hash.cap, m=m2, n=n2,
                                      smem_budget_bytes=budget)
    log(f"phase hash: hash_slide launches={launches['hash_slide']} "
        f"presort={presort} compactions={compactions} "
        f"geometry={geom2._asdict()}")
    out_hash_sorted = E.spkadd_batched(stacked, algorithm="sorted")
    check(same_coo(torch, out_hash, out_hash_sorted),
          "phase hash: a batch row differs bitwise from sorted")
    # host reference for the batch: distinct (row, key) pairs and f64 sums
    keys2 = (cols2[None].astype(np.int64) * m2 + rows2).transpose(1, 0, 2)
    comb = (np.arange(B2, dtype=np.int64)[:, None, None] * (m2 * n2)
            + keys2).reshape(-1)
    uniq, inv = np.unique(comb, return_inverse=True)
    sums = np.bincount(inv, weights=vals2.transpose(1, 0, 2).reshape(-1)
                       .astype(np.float64))
    hk = out_hash.keys.cpu().numpy()
    hv = out_hash.vals.cpu().numpy()
    hn = out_hash.nnz.cpu().numpy()
    got_keys = np.concatenate([b * (m2 * n2) + hk[b, :hn[b]].astype(np.int64)
                               for b in range(B2)])
    got_vals = np.concatenate([hv[b, :hn[b]] for b in range(B2)])
    check(np.array_equal(got_keys, uniq), "phase hash: keys differ from numpy")
    check(np.isfinite(got_vals).all(), "phase hash: non-finite values")
    check(np.allclose(got_vals, sums, rtol=1e-5, atol=1e-5),
          "phase hash: values differ from the float64 numpy sum beyond 1e-5")
    phases["hash"] = {"B": B2, "k": k2, "m": m2, "n": n2,
                      "nnz_per_collection": k2 * per2,
                      "ms": host_ms(torch, lambda: E.spkadd_batched(stacked),
                                    5)}
    phases["hash"]["phase_s"] = took()

    # ---- 4. family: the algorithm family's front door ------------------
    def nonzero_entries(out):
        """(keys, vals) of the entries that are valid and not exactly 0."""
        keep = out.valid_mask() & (out.vals != 0)
        return out.keys[keep], out.vals[keep]

    sorted_nz = nonzero_entries(out_sorted)
    family = {}
    for alg in ("incremental", "tree", "sorted", "spa", "vec", "blocked_spa"):
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        out = A.spkadd(mats, algorithm=alg)
        torch.cuda.synchronize()
        checked_ms = (time.perf_counter() - t0) * 1e3
        used = {k: fn.launches for k, fn in kernels.items() if fn.launches}
        nz_k, nz_v = nonzero_entries(out)
        if alg != "tree":
            check(bitwise_equal(torch, nz_k, sorted_nz[0])
                  and bitwise_equal(torch, nz_v, sorted_nz[1]),
                  f"phase family: {alg} differs bitwise from sorted")
        else:
            check(int(out.nnz) == distinct.size,
                  f"phase family: tree nnz {int(out.nnz)} != distinct keys "
                  f"{distinct.size}")
        hk_np, hv_np = nz_k.cpu().numpy(), nz_v.cpu().numpy()
        check(np.isfinite(hv_np).all(), f"phase family: {alg} non-finite")
        check(np.isin(hk_np, distinct).all(),
              f"phase family: {alg} keys differ from numpy")
        check(np.allclose(hv_np, ref64[hk_np], rtol=1e-5, atol=1e-5),
              f"phase family: {alg} values differ from the float64 numpy "
              f"sum beyond 1e-5")
        if alg in ("vec", "blocked_spa"):
            check(used.get("spa_accum", 0) > 0,
                  f"phase family: {alg} did not launch the SPA kernel")
            launches["spa_accum"] = launches.get("spa_accum", 0) \
                + used["spa_accum"]
        del out
        family[alg] = {
            "ms": host_ms(torch, lambda: A.spkadd(mats, algorithm=alg), 3),
            "checked_call_ms": checked_ms,
            "launches": used, "out_nnz": int(hk_np.size)}
        log(f"phase family: {alg} {family[alg]['ms']:.2f} ms, "
            f"launches {used}; equal to sorted"
            f"{' (tree: float64 only)' if alg == 'tree' else ''}")
    spa_budget = kops.spa_tile_budget(dev)
    spa_rows, spa_chunk = kops.vec_launch_geometry(
        k1 * nnz1, m=m1, n=n1, smem_budget_bytes=spa_budget)
    spa_parts = -(-m1 // spa_rows)
    phases["family"] = {"k": k1, "m": m1, "n": n1, "total_nnz": k1 * nnz1,
                        "algorithms": family,
                        "spa_geometry": {"block_rows": spa_rows,
                                         "parts": spa_parts,
                                         "chunk": spa_chunk,
                                         "tile_budget": spa_budget}}
    phases["family"]["phase_s"] = took()

    # ---- 5. hash_alg: the faithful hash algorithm -----------------------
    k3, m3, n3, d3 = 64, 65536, 32, 512
    nnz3 = n3 * d3
    rows3 = rng.integers(0, m3, size=(k3, nnz3), dtype=np.int32)
    cols3 = np.repeat(np.arange(n3, dtype=np.int32), d3)
    vals3 = rng.standard_normal((k3, nnz3), dtype=np.float32)
    mats3 = [S.from_coords(rows3[i], cols3, vals3[i], (m3, n3))
             for i in range(k3)]
    cat3 = S.concat(mats3)
    sent3 = S.sentinel_key((m3, n3))
    torch.cuda.synchronize()
    reset_counts()
    out_h = A.spkadd(mats3, algorithm="hash")
    torch.cuda.synchronize()
    launches["hash_accum"] = kernels["hash_accum"].launches
    check(launches["hash_accum"] > 0, "phase hash_alg: hash kernel not "
          "launched")
    reset_counts()
    sym = kops.hash_symbolic(cat3.keys, sent=sent3)
    torch.cuda.synchronize()
    launches["hash_symbolic"] = kernels["hash_symbolic"].launches
    check(launches["hash_symbolic"] > 0, "phase hash_alg: symbolic kernel "
          "not launched")
    table3 = hash_accum.hash_table_size(cat3.cap + 1)
    sym_route = hash_accum.symbolic_route(cat3.cap, table3, device=dev)
    check(sym_route == "device" and
          hash_accum.hash_symbolic_raw.serial_launches == 0,
          f"phase hash_alg: the symbolic count took the {sym_route!r} route "
          f"({hash_accum.hash_symbolic_raw.serial_launches} one-thread "
          f"launches), expected the parallel device-memory route")
    out_hs = A.spkadd(mats3, algorithm="sorted")
    check(same_coo(torch, out_h, out_hs),
          "phase hash_alg: hash is not bitwise equal to sorted")
    sym_ref = int(A.symbolic_nnz(mats3))
    check(int(sym) == sym_ref == int(out_h.nnz),
          f"phase hash_alg: hash_symbolic {int(sym)}, symbolic_nnz "
          f"{sym_ref}, nnz {int(out_h.nnz)}")
    keys3 = (cols3[None, :].astype(np.int64) * m3 + rows3).reshape(-1)
    ref3 = np.bincount(keys3, weights=vals3.reshape(-1).astype(np.float64),
                       minlength=m3 * n3)
    distinct3 = np.flatnonzero(np.bincount(keys3, minlength=m3 * n3))
    nh = int(out_h.nnz)
    check(np.array_equal(out_h.keys[:nh].cpu().numpy(), distinct3),
          "phase hash_alg: keys differ from numpy")
    hv3 = out_h.vals[:nh].cpu().numpy()
    check(np.isfinite(hv3).all() and np.allclose(hv3, ref3[distinct3],
                                                 rtol=1e-5, atol=1e-5),
          "phase hash_alg: values differ from the float64 numpy sum "
          "beyond 1e-5")
    phases["hash_alg"] = {
        "k": k3, "m": m3, "n": n3, "total_nnz": k3 * nnz3, "out_nnz": nh,
        "table_size": table3, "symbolic_route": sym_route,
        "ms": host_ms(torch, lambda: A.spkadd(mats3, algorithm="hash"), 3),
        "symbolic_ms": host_ms(torch, lambda: kops.hash_symbolic(
            cat3.keys, sent=sent3), 3)}
    log(f"phase hash_alg: hash == sorted bitwise, nnz {nh}, table "
        f"{table3} slots; {phases['hash_alg']['ms']:.2f} ms, symbolic "
        f"{phases['hash_alg']['symbolic_ms']:.3f} ms ({sym_route} route)")
    phases["hash_alg"]["phase_s"] = took()

    # ---- 6. delta_sync: SmolLM-135M's parameters, publisher -> replicas --
    del out_vec, out_sorted, out_hash, out_hash_sorted, out_h, out_hs
    phases["delta_sync"], launches["topk_block"], embed_x, ds_round = \
        run_delta_sync(torch, args.seed, dev, kernels)
    phases["delta_sync"]["round_ms"] = host_ms(torch, ds_round, 3)
    phases["delta_sync"]["phase_s"] = took()

    # where the time of each phase's engine call goes, on the device
    profiles = {
        "vec": device_profile(torch, lambda: E.spkadd_auto(mats),
                              phases["vec"]["ms"]),
        "sorted": device_profile(
            torch, lambda: E.spkadd_run(mats, algorithm="sorted"),
            phases["sorted"]["ms"]),
        "hash": device_profile(torch, lambda: E.spkadd_batched(stacked),
                               phases["hash"]["ms"]),
        "family_tree": device_profile(
            torch, lambda: A.spkadd(mats, algorithm="tree"),
            family["tree"]["ms"]),
        "family_blocked_spa": device_profile(
            torch, lambda: A.spkadd(mats, algorithm="blocked_spa"),
            family["blocked_spa"]["ms"]),
        "family_vec": device_profile(
            torch, lambda: A.spkadd(mats, algorithm="vec"),
            family["vec"]["ms"]),
        "hash_alg": device_profile(
            torch, lambda: A.spkadd(mats3, algorithm="hash"),
            phases["hash_alg"]["ms"]),
        "hash_alg_symbolic": device_profile(
            torch, lambda: kops.hash_symbolic(cat3.keys, sent=sent3),
            phases["hash_alg"]["symbolic_ms"]),
        "delta_sync_round": device_profile(
            torch, ds_round, phases["delta_sync"]["round_ms"]),
    }
    for name, prof in profiles.items():
        log(f"profile {name}: device {prof['device_ms']:.3f} ms of "
            f"{prof['wall_ms']:.3f} ms wall; top {prof['top'][:3]}")
    phases["profiles_s"] = took()

    # ---- 7. kernels against their plain versions ------------------------
    report = []

    # partition, at phase 1's step tables
    cat1 = S.concat(mats)
    plan, keys_p, steps = S.plan_and_partition(
        cat1.keys[None], cat1.shape, part_elems=geom1.part_elems,
        chunk=geom1.chunk)
    vals_p = torch.zeros(keys_p.shape, dtype=torch.float32, device=dev)
    vals_p[:, :cat1.cap] = torch.gather(cat1.vals[None], -1, plan.order)
    pkw = dict(mn=m1 * n1, part_elems=geom1.part_elems, parts=geom1.parts,
               chunk=geom1.chunk)
    got = partition.partitioned_accumulate_raw(
        keys_p, vals_p, steps.chunk_id, steps.part_id, **pkw)
    want = partition.partitioned_accumulate_plain(
        keys_p, vals_p, steps.chunk_id, steps.part_id, **pkw)
    check(bitwise_equal(torch, got, want),
          "partition kernel differs from its plain version")
    lib_acc = torch.zeros(max(got.shape[1], m1 * n1 + 1), device=dev)
    lib_idx = keys_p[0].long()
    part_bytes = 4 * (keys_p.numel() + vals_p.numel() + steps.chunk_id.numel()
                      + steps.part_id.numel() + got.numel())
    part_bound = bound(part_bytes, int((keys_p < m1 * n1).sum()))
    report.append({
        "name": "partition", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/partition.cu",
        "replaces": "src/repro/kernels/partition.py:62",
        "launches": launches["partition"],
        "max_abs_err": float((got - want).abs().max()),
        "ms": cuda_ms(torch, lambda: partition.partitioned_accumulate_raw(
            keys_p, vals_p, steps.chunk_id, steps.part_id, **pkw), 20),
        "plain_ms": cuda_ms(torch, lambda: partition.partitioned_accumulate_plain(
            keys_p, vals_p, steps.chunk_id, steps.part_id, **pkw), 3),
        "bound_ms": part_bound[0],
        "bound_by": part_bound[1],
        "library_ms": cuda_ms(torch, lambda: lib_acc.index_add_(
            0, lib_idx, vals_p[0]), 20),
        "bytes": part_bytes, "geometry": geom1._asdict(),
    })
    del got, want, lib_acc

    # hash_slide, at phase 2's padded streams
    cat2 = S.concat(stacked)
    hkw = dict(mn=m2 * n2, table_size=geom2.table_size,
               part_span=geom2.part_span, parts=geom2.parts,
               chunk=geom2.chunk)
    check(cat2.cap % geom2.chunk == 0, "phase hash stream is not chunk-aligned")
    tk, tv = hash_slide.hash_slide_raw(cat2.keys, cat2.vals, **hkw)
    t_plain = time.perf_counter()
    pk, pv = hash_slide.hash_slide_plain(cat2.keys, cat2.vals, **hkw)
    torch.cuda.synchronize()
    hash_plain_ms = (time.perf_counter() - t_plain) * 1e3
    check(bitwise_equal(torch, tk, pk) and bitwise_equal(torch, tv, pv),
          "hash_slide kernel tables differ from its plain version")
    hash_bytes = 4 * (cat2.keys.numel() + cat2.vals.numel() + tk.numel()
                      + tv.numel())
    hash_bound = bound(hash_bytes, int((cat2.keys < m2 * n2).sum()))
    report.append({
        "name": "hash_slide", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/hash_slide.cu",
        "replaces": "src/repro/kernels/hash_slide.py:83",
        "launches": launches["hash_slide"],
        "max_abs_err": float((tv - pv).abs().max()),
        "ms": cuda_ms(torch, lambda: hash_slide.hash_slide_raw(
            cat2.keys, cat2.vals, **hkw), 20),
        "plain_ms": hash_plain_ms,
        "bound_ms": hash_bound[0],
        "bound_by": hash_bound[1],
        "library_ms": None,
        "bytes": hash_bytes, "geometry": geom2._asdict(),
    })

    # segment_fold, on phase 1's plan-sorted stream
    v_s = torch.gather(cat1.vals, -1, plan.order[0])
    gid = plan.gid[0]
    got = segment.segment_fold(v_s, gid, cat1.cap)
    want = segment.segment_fold_plain(v_s, gid, cat1.cap)
    check(bitwise_equal(torch, got, want),
          "segment_fold kernel differs from its plain version")
    seg_acc = torch.zeros(cat1.cap, device=dev)
    gid_long = gid.long()
    seg_bytes = 4 * (v_s.numel() + gid.numel() + got.numel())
    seg_bound = bound(seg_bytes, v_s.numel())
    report.append({
        "name": "segment_fold", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/segment_fold.cu",
        "replaces": "src/repro/core/sparse.py:325",
        "launches": launches["segment_fold"],
        "max_abs_err": float((got - want).abs().max()),
        "ms": cuda_ms(torch, lambda: segment.segment_fold(v_s, gid, cat1.cap),
                      20),
        "plain_ms": cuda_ms(torch, lambda: segment.segment_fold_plain(
            v_s, gid, cat1.cap), 3),
        "bound_ms": seg_bound[0],
        "bound_by": seg_bound[1],
        "library_ms": cuda_ms(torch, lambda: seg_acc.index_add_(
            0, gid_long, v_s), 20),
        "bytes": seg_bytes,
    })

    # spa_accum, on the family's concatenated stream as given (the
    # blocked_spa path) and stable-sorted (the vec path)
    spa_keys, spa_vals = kops.pad_stream(cat1.keys, cat1.vals, m1 * n1,
                                          spa_chunk)
    spa_order = torch.argsort(spa_keys, stable=True)
    spa_sorted = (spa_keys[spa_order], spa_vals[spa_order])
    skw = dict(m=m1, n=n1, block_rows=spa_rows, chunk=spa_chunk)
    spa_err = 0.0
    for keys_, vals_ in ((spa_keys, spa_vals), spa_sorted):
        got = spa_accum.spa_accumulate_raw(keys_, vals_, **skw)
        want = spa_accum.spa_accumulate_plain(keys_, vals_, **skw)
        check(bitwise_equal(torch, got, want),
              "spa_accum kernel differs from its plain version")
        spa_err = max(spa_err, float((got - want).abs().max()))
        del got, want
    spa_valid = int((spa_keys < m1 * n1).sum())
    spa_bytes = 8 * spa_keys.numel() + 4 * m1 * n1
    spa_bound = bound(spa_bytes, spa_valid)
    spa_moved = spa_accum.moved_bytes(spa_keys.numel(), spa_valid, m=m1,
                                      n=n1, block_rows=spa_rows)
    spa_moved_total = sum(spa_moved.values())
    # the radix passes move a few times the bound's bytes; the all-pairs
    # grid moved parts times the stream
    check(spa_moved_total <= 4 * spa_bytes, f"spa_accum moves "
          f"{spa_moved_total} B, over 4x the bound's {spa_bytes} B")

    def spa_stage_ms(keys_, vals_, rows, reps=10):
        """Median device ms of each stage of one pipeline run, summed over
        the radix passes (CUDA events between the stages' launches)."""
        run = spa_accum.SpaLaunches(keys_, vals_, m=m1, n=n1,
                                    block_rows=rows)
        run.run()
        times = {name: [] for name, _ in run.stages}
        for _ in range(reps):
            events = [torch.cuda.Event(enable_timing=True)
                      for _ in range(len(run.stages) + 1)]
            events[0].record()
            for i, (_, launch) in enumerate(run.stages):
                launch()
                events[i + 1].record()
            events[-1].synchronize()
            rep = dict.fromkeys(times, 0.0)
            for i, (name, _) in enumerate(run.stages):
                rep[name] += events[i].elapsed_time(events[i + 1])
            for name, t in rep.items():
                times[name].append(t)
        return {name: statistics.median(t) for name, t in times.items()}

    # the result does not depend on the tile: time it at other tile sizes
    spa_limit_rows = kops.choose_block_rows(m1, n1, kops.spa_tile_limit(dev))
    spa_sweep = {}
    for rows in sorted({8, 16, 32, 64, spa_rows, spa_limit_rows}):
        rkw = dict(skw, block_rows=rows)
        spa_sweep[rows] = {
            "parts": -(-m1 // rows),
            "passes": spa_accum.bucket_geometry(spa_keys.numel(), m=m1,
                                                block_rows=rows).passes,
            "ms": cuda_ms(torch, lambda: spa_accum.spa_accumulate_raw(
                spa_keys, spa_vals, **rkw), 10),
            "sorted_stream_ms": cuda_ms(torch, lambda: spa_accum
                                        .spa_accumulate_raw(*spa_sorted,
                                                            **rkw), 10),
            "stage_ms": spa_stage_ms(spa_keys, spa_vals, rows, 5)}
        log(f"spa_accum at block_rows {rows}: {spa_sweep[rows]}")
    spa_lib = torch.zeros(m1 * n1 + 1, device=dev)
    spa_idx = spa_keys.long()
    report.append({
        "name": "spa_accum", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/spa_accum.cu",
        "replaces": "src/repro/kernels/spa_accum.py:55",
        "launches": launches["spa_accum"],
        "max_abs_err": spa_err,
        "ms": cuda_ms(torch, lambda: spa_accum.spa_accumulate_raw(
            spa_keys, spa_vals, **skw), 20),
        "sorted_stream_ms": cuda_ms(torch, lambda: spa_accum
                                    .spa_accumulate_raw(*spa_sorted, **skw),
                                    20),
        "stage_ms": spa_stage_ms(spa_keys, spa_vals, spa_rows),
        "sorted_stream_stage_ms": spa_stage_ms(*spa_sorted, spa_rows),
        "plain_ms": cuda_ms(torch, lambda: spa_accum.spa_accumulate_plain(
            spa_keys, spa_vals, **skw), 3),
        "bound_ms": spa_bound[0],
        "bound_by": spa_bound[1],
        "library_ms": cuda_ms(torch, lambda: spa_lib.index_add_(
            0, spa_idx, spa_vals), 20),
        "library": "index_add_",
        "bytes": spa_bytes,
        "moved_bytes": spa_moved, "moved_bytes_total": spa_moved_total,
        "bucket_geometry": spa_accum.bucket_geometry(
            spa_keys.numel(), m=m1, block_rows=spa_rows)._asdict(),
        "geometry": phases["family"]["spa_geometry"],
        "by_block_rows": spa_sweep,
    })
    del spa_lib, spa_idx, spa_sorted, spa_order

    # hash_accum and hash_symbolic: at the hash_alg phase's stream (a
    # device-memory table of 2^22 slots), and on its first 4,096 and
    # 16,384 elements (a shared-memory and a device-memory table); the
    # plain versions run on a CPU copy
    hash_cases = {}
    for cap in (4096, 16384, cat3.cap):
        hk_, hv_ = cat3.keys[:cap], cat3.vals[:cap]
        hk_cpu, hv_cpu = hk_.cpu(), hv_.cpu()
        tk_, tv_ = hash_accum.hash_accumulate_raw(hk_, hv_, sent=sent3)
        t_plain = time.perf_counter()
        pk_, pv_ = hash_accum.hash_accumulate_plain(hk_cpu, hv_cpu,
                                                    sent=sent3)
        acc_plain_ms = (time.perf_counter() - t_plain) * 1e3
        check(bitwise_equal(torch, tk_.cpu(), pk_)
              and bitwise_equal(torch, tv_.cpu(), pv_),
              f"hash_accum kernel table differs from its plain version at "
              f"cap {cap}")
        nz_ = hash_accum.hash_symbolic_raw(hk_, sent=sent3)
        t_plain = time.perf_counter()
        pnz_ = hash_accum.hash_symbolic_plain(hk_cpu, sent=sent3)
        sym_plain_ms = (time.perf_counter() - t_plain) * 1e3
        check(int(nz_) == int(pnz_), f"hash_symbolic kernel count differs "
              f"from its plain version at cap {cap}")
        size_ = hash_accum.hash_table_size(cap + 1)
        hash_cases[cap] = {
            "table_size": size_,
            "sym_route": hash_accum.symbolic_route(cap, size_, device=dev),
            "sym_err": float(abs(int(nz_) - int(pnz_))),
            "acc_in_smem": hash_accum.table_in_smem(size_, symbolic=False,
                                                    device=dev),
            "sym_in_smem": hash_accum.table_in_smem(size_, symbolic=True,
                                                    device=dev),
            "acc_ms": cuda_ms(torch, lambda: hash_accum.hash_accumulate_raw(
                hk_, hv_, sent=sent3), 3),
            "sym_ms": cuda_ms(torch, lambda: hash_accum.hash_symbolic_raw(
                hk_, sent=sent3), 10),
            "acc_plain_ms": acc_plain_ms, "sym_plain_ms": sym_plain_ms,
            "acc_err": float((tv_.cpu() - pv_).abs().max()),
            "valid": int((hk_ != sent3).sum())}
        log(f"hash kernels at cap {cap}: {hash_cases[cap]}")
    full = hash_cases[cat3.cap]
    acc_bytes = 8 * cat3.cap + 8 * full["table_size"]
    acc_bound = bound(acc_bytes, full["valid"])
    sym_bytes = 4 * cat3.cap + 4
    sym_bound = bound(sym_bytes, 0)
    # library yardstick for the symbolic count (the port never calls it):
    # the distinct non-sentinel keys of the same stream, which is what the
    # kernel counts in a table that is not undersized, as 2^22 slots is not
    def unique_count():
        return int((torch.unique(cat3.keys) != sent3).sum())
    check(unique_count() == int(sym), "hash_symbolic: torch.unique count "
          "differs from the kernel's")
    sym_library_ms = cuda_ms(torch, unique_count, 3)
    # the one-thread route, on a table of cap slots (table_size <= cap: it
    # could fill; this stream's 825,197 distinct keys do not fill it, so
    # its count is the parallel route's)
    under = cat3.cap
    check(hash_accum.symbolic_route(cat3.cap, under, device=dev) == "serial",
          "hash_symbolic: a table of cap slots should take the one-thread "
          "route")
    serial0 = hash_accum.hash_symbolic_raw.serial_launches
    under_nz = int(hash_accum.hash_symbolic_raw(cat3.keys, sent=sent3,
                                                table_size=under))
    check(under_nz == int(sym) and
          hash_accum.hash_symbolic_raw.serial_launches == serial0 + 1,
          f"hash_symbolic: the one-thread route on {under} slots counted "
          f"{under_nz}, the parallel route {int(sym)}")
    under_ms = cuda_ms(torch, lambda: hash_accum.hash_symbolic_raw(
        cat3.keys, sent=sent3, table_size=under), 1)
    small = {c: hash_cases[c] for c in (4096, 16384)}
    report.append({
        "name": "hash_accum", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/hash_accum.cu",
        "replaces": "src/repro/kernels/hash_accum.py:75",
        "launches": launches["hash_accum"],
        "max_abs_err": max(c["acc_err"] for c in hash_cases.values()),
        "ms": full["acc_ms"], "plain_ms": full["acc_plain_ms"],
        "bound_ms": acc_bound[0], "bound_by": acc_bound[1],
        "library_ms": None, "bytes": acc_bytes,
        "table_size": full["table_size"], "in_smem": full["acc_in_smem"],
        "smaller_caps": small,
    })
    report.append({
        "name": "hash_symbolic", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/hash_accum.cu",
        "replaces": "src/repro/kernels/hash_accum.py:126",
        "launches": launches["hash_symbolic"],
        "max_abs_err": max(c["sym_err"] for c in hash_cases.values()),
        "ms": full["sym_ms"], "plain_ms": full["sym_plain_ms"],
        "bound_ms": sym_bound[0], "bound_by": sym_bound[1],
        "library_ms": sym_library_ms, "library": "torch.unique",
        "bytes": sym_bytes, "route": full["sym_route"],
        "table_size": full["table_size"], "in_smem": full["sym_in_smem"],
        "smaller_caps": {c: {k: hash_cases[c][k] for k in (
            "table_size", "sym_route", "sym_ms", "sym_plain_ms")}
            for c in (4096, 16384)},
        "undersized": {"route": "serial", "table_size": under,
                       "ms": under_ms},
    })

    # topk_block, at the embed leaf's selection of epoch 1: 6,912 blocks of
    # 4,096, 40 per block
    nb_e, per_e, block_e = embed_x.numel() // 4096, 40, 4096
    tkw = dict(k=per_e, block=block_e)
    got_i, got_v = topk_block.topk_block_raw(embed_x, **tkw)
    want_i, want_v = topk_block.topk_block_plain(embed_x, **tkw)
    check(bitwise_equal(torch, got_i, want_i)
          and bitwise_equal(torch, got_v, want_v),
          "topk_block kernel differs from its plain version")
    embed_blocks = embed_x.view(nb_e, block_e)
    topk_bytes = 4 * embed_x.numel() + 8 * nb_e * per_e
    topk_bound = bound(topk_bytes, embed_x.numel())
    report.append({
        "name": "topk_block", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/topk_block.cu",
        "replaces": "src/repro/kernels/topk_block.py:21",
        "launches": launches["topk_block"],
        "max_abs_err": float((got_v - want_v).abs().max()),
        "ms": cuda_ms(torch, lambda: topk_block.topk_block_raw(
            embed_x, **tkw), 20),
        "plain_ms": cuda_ms(torch, lambda: topk_block.topk_block_plain(
            embed_x, **tkw), 3),
        "bound_ms": topk_bound[0], "bound_by": topk_bound[1],
        # a yardstick only: torch.topk orders ties otherwise
        "library_ms": cuda_ms(torch, lambda: torch.topk(
            embed_blocks.abs(), per_e, dim=1), 20),
        "library": "torch.topk", "bytes": topk_bytes,
        "geometry": {"blocks": nb_e, "block": block_e, "per": per_e},
    })
    del got_i, got_v, want_i, want_v

    for r in report:
        check(r["launches"] > 0, f"{r['name']}: no launch on its path")
        check(r["max_abs_err"] == 0.0, f"{r['name']}: max_abs_err "
              f"{r['max_abs_err']}")
        log(f"{r['name']}: {r['ms']:.4f} ms (bound {r['bound_ms']:.4f} ms, "
            f"plain {r['plain_ms']:.2f} ms, library {r['library_ms']}) "
            f"launches={r['launches']}")
    phases["kernel_checks_s"] = took()
    phases["build_s"] = build_s
    phases["peak_mem_bytes"] = torch.cuda.max_memory_allocated(dev)
    print(json.dumps({"phases": phases}), flush=True)
    print(json.dumps({"profile": profiles}), flush=True)
    print(json.dumps({"kernels": report}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
