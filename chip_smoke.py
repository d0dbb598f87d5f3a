#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's SpKAdd main path once on one CUDA card.

    python3 chip_smoke.py [--seed N]

Run from the root of a checkout; it imports ``src/repro_torch`` (never JAX,
never the reference package ``repro``) and exits non-zero, printing no
result, when no CUDA card is present or the package is missing.

0. Build the seven CUDA kernel libraries from ``src/repro_torch/kernels/csrc``
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
   kernels (count, offsets, scatter, fold). Each timed call's host time
   is kept.
5. ``hash_alg``: the faithful hash algorithm, ``spkadd(mats, "hash")``, on
   k = 64 ER matrices of 65,536 × 32 with 512 nonzeros per column
   (1,048,576 nonzeros, a 2^22-slot table): bitwise equal to ``sorted``
   (keys, values and nnz, nothing dropped); the accumulate must take its
   parallel route (no one-thread launch); ``ops.hash_symbolic`` must
   equal ``symbolic_nnz`` and take the parallel route (a grid over the
   stream, the table in device memory); both hash kernels must launch.
6. ``delta_sync``: SmolLM-135M's parameter tree (:data:`SMOLLM_135M_SHAPES`,
   162,826,560 f32 parameters on the dyadic grid of
   ``benchmarks/delta_sync.py``) through ``DeltaPublisher`` (k_fraction
   0.01, block selector) to replica A (a sync every epoch) and replica B
   (a window-4 catch-up, one ragged SpKAdd) over 8 epochs: both replicas
   equal the publisher's shadow bitwise, the block top-k kernel, the
   flushing add (``xla_add``) and the engine's kernels launch, and epoch
   1's frames equal those of the selection's plain version, byte for byte
   (:func:`run_delta_sync`). One round (publish + A's sync) is timed with
   the kernel, with the add's plain version swapped in, and with the
   kernel again.
   After the phase, each sliding-hash bucket of B's catch-up is replayed:
   its engine call (``hash``) and the ``vec`` regime on the same
   collections, timed, both bitwise equal to ``sorted``.
7. ``stream_service``: the multi-tenant stream service
   (:func:`run_stream_service`): the three chaos cells of
   ``benchmarks/stream_service.py --smoke`` on the card with the
   reference's counts, then 64 tenants (512 cut to fit the card's memory,
   :data:`STREAM_TENANTS`) of 65,536 x 256 (the deployment the ``hash``
   phase's co-flush stands for) driven open-loop through the
   port's ``StreamService`` with the journal on: every co-flush dispatches
   ``hash`` and launches the sliding-hash kernel, nothing is shed, the
   sums equal a ``sorted`` drive bitwise and float64 sums to 1e-5, and a
   drive that crashes at flush 2 recovers every tenant bitwise; one
   co-flush after recovery is profiled.
8. One profiled call of each phase (device time by kernel, busy share),
   ten profiled calls each of the family's ``vec`` and ``blocked_spa``
   (each call's host time and the CUDA runtime calls that took the most
   host time: where a slow call waits), then each of the eight kernels against its plain PyTorch version on the
   card, on the inputs its path gives it: bitwise (tolerance 0); the two
   hash kernels twice, with the same bits. The sliding-hash row adds its
   time at the catch-up's largest launch (inputs rebuilt by a replay), with
   a seeded sample of its parts checked against the plain version, and the
   hash rows their routes and one-thread launches (``null`` for the
   sliding-hash kernel, which has no one-thread route). The SPA
   row adds each stage's time, the bytes its design moves and its time at
   other tile sizes; the symbolic row its route and the one-thread route's
   time on a table of ``cap`` slots. The partition row adds its sub-tile,
   blocks per SM, the bytes its design moves and its time at the
   delta-sync catch-up's largest launch (its inputs rebuilt after the
   phase by a replay of that launch's engine call); the top-k row its
   radix passes and its time at each leaf shape of a publish beside
   ``torch.topk``. Then JSON lines of the phases'
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


def host_ms(torch, fn, reps: int, times: list | None = None) -> float:
    """Median host time of ``fn`` ending in a device synchronize; each
    call's time is appended to ``times`` when it is given."""
    times = [] if times is None else times
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def host_stall_probe(torch, fn, reps: int = 10, top: int = 4) -> dict:
    """``reps`` calls of ``fn`` under ``torch.profiler``, to see where a
    slow call waits: each call's host ms, the device ms of a call (its
    kernels and copies, averaged), and the CUDA runtime calls that took
    the most host time over all of them (name: [count, total ms, longest
    ms])."""
    from torch.profiler import ProfilerActivity, profile

    calls = []
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            calls.append((time.perf_counter() - t0) * 1e3)
    runtime, device_us = {}, 0.0
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            device_us += ev.device_time_total
        elif ev.name.startswith("cu"):
            ms = ev.time_range.elapsed_us() / 1e3
            n, total, longest = runtime.get(ev.name, (0, 0.0, 0.0))
            runtime[ev.name] = (n + 1, total + ms, max(longest, ms))
    ranked = sorted(runtime.items(), key=lambda r: -r[1][1])[:top]
    return {"calls_ms": calls, "device_ms": device_us / 1e3 / reps,
            "runtime": {name: list(r) for name, r in ranked}}


def device_profile(torch, fn, wall_ms: float, top: int = 6,
                   watch: tuple = ()) -> dict:
    """One call of ``fn`` under ``torch.profiler``: device time summed by
    kernel name (the ``top`` largest, and under ``"watch"`` the ms and
    launches of the kernels whose names hold each string of ``watch``) and
    the device's busy share of ``wall_ms``, the call's unprofiled median
    host time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return device_times(torch, prof, wall_ms, top, watch)


def device_times(torch, prof, wall_ms: float, top: int = 6,
                 watch: tuple = ()) -> dict:
    """A finished profile's device time summed by kernel name (the ``top``
    largest; ``watch`` as in :func:`device_profile`) and the device's busy
    share of ``wall_ms``."""
    rows, watched = [], {name: [0.0, 0] for name in watch}
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total", 0) or 0
        if us > 0:
            rows.append((ev.key[:90], us / 1e3, ev.count))
            for name in watch:
                if name in ev.key:
                    watched[name][0] += us / 1e3
                    watched[name][1] += ev.count
    rows.sort(key=lambda r: -r[1])
    device_ms = sum(r[1] for r in rows)
    out = {"device_ms": device_ms, "wall_ms": wall_ms,
           "busy_share": device_ms / wall_ms if wall_ms else None,
           "top": [list(r) for r in rows[:top]]}
    if watch:
        out["watch"] = watched
    return out


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
    the selection's plain version on the card. Returns the phase's
    numbers, the top-k launches, what the kernel line times the kernels at
    (``captured``: the embed leaf's epoch-1 update, the shape of each block
    top-k call of an epoch-1 publish, the inputs of the largest partition
    launch of B's catch-up, rebuilt after the phase by
    :func:`replay_catchup_launch`, and its sliding-hash buckets from
    :func:`catchup_hash_buckets`), and one round (publish + A's sync) to
    profile."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import tree as T
    from repro_torch.kernels import ops as kops
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
    topk_launches = xla_add_launches = 0
    captured = {"topk_leaves": []}
    catchup_part_calls, catchup_hash_calls = [], []
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
        xla_add_launches += kernels["xla_add"].launches
        wire_bytes.append(stats.bytes)
        if epoch == 1:
            # the same epoch from the same state, the selection's plain
            # version swapped in for the kernel (ops calls it through the
            # module), must give the same bytes
            # (and each call's shape is kept for the kernel line)
            captured["embed_x"] = update["embed"].reshape(-1).clone()
            kernel_fn = topk_block.topk_block_raw

            def plain_keeping_inputs(x, *, k, block):
                captured["topk_leaves"].append((x.numel(), k, block))
                return topk_block.topk_block_plain(x, k=k, block=block)

            topk_block.topk_block_raw = plain_keeping_inputs
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
            # only the partition and sliding-hash launches' shapes are
            # kept: their inputs are rebuilt after the phase
            # (replay_catchup_launch)
            part_fn = kops.partitioned_accumulate_flat
            hash_fn = kops.hash_slide_tables

            def part_keeping_shapes(*a, **kw):
                catchup_part_calls.append(
                    (tuple(tuple(t.shape) for t in a), kw))
                return part_fn(*a, **kw)

            def hash_keeping_shapes(*a, **kw):
                catchup_hash_calls.append(
                    (tuple(tuple(t.shape) for t in a), kw))
                return hash_fn(*a, **kw)

            kops.partitioned_accumulate_flat = part_keeping_shapes
            kops.hash_slide_tables = hash_keeping_shapes
            try:
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    t0 = time.perf_counter()
                    report = rep_b.sync()
                    torch.cuda.synchronize()
                    catchup_ms = (time.perf_counter() - t0) * 1e3
            finally:
                kops.partitioned_accumulate_flat = part_fn
                kops.hash_slide_tables = hash_fn
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
    check(xla_add_launches > 0, "phase delta_sync: xla_add kernel not "
          "launched")
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
        "xla_add_launches": xla_add_launches,
        "peak_mem_bytes": torch.cuda.max_memory_allocated(dev)}
    log(f"phase delta_sync: {n_params} params, publish ms "
        f"{[round(t, 1) for t in publish_ms]}, sync A ms "
        f"{[round(t, 1) for t in sync_a_ms]}, catch-up B "
        f"{catchup_ms:.1f} ms, wire {wire_bytes[-1]} B of "
        f"{dense} B dense per sync, {stats.selected} selected, top-k "
        f"launches {topk_launches}, xla_add launches {xla_add_launches}, "
        f"catch-up launches {catchup_launches}, "
        f"peak {phase['peak_mem_bytes'] / 2**30:.2f} GiB; replicas A and B "
        f"== shadow bitwise")
    pool.shutdown()
    check(catchup_part_calls, "phase delta_sync: the catch-up made no "
          "partition launch")
    captured["catchup_partition"] = replay_catchup_launch(
        pub, max(catchup_part_calls, key=launch_slots), dev,
        kops, "partitioned_accumulate_flat")
    captured["catchup_hash"] = catchup_hash_buckets(
        torch, pub, catchup_hash_calls, dev)

    def one_sync_round():
        # params unchanged: each round ships the residual's heaviest entries
        pub.publish(params)
        rep_a.sync()

    return phase, topk_launches, captured, one_sync_round


#: The stream-service chaos cells of ``benchmarks/stream_service.py
#: --smoke`` (32 x 8, 16 nonzeros a push, capacity 256) and the counts the
#: reference gives for them.
CELL_SHAPE, CELL_NNZ, CELL_CAP = (32, 8), 16, 256
CELL_COUNTS = {
    "crash_replay": {"replayed_records": 10, "bitwise": True,
                     "ref_flushes": 6, "ref_admitted": 57},
    "overload_shed": {"evicted_windows": 2, "deferred": 23,
                      "hot_flushes": 16, "admitted": 134},
    "torn_journal": {"quarantined": 4, "torn_injected": 14, "replayed": 11},
}
CELL_SHED_RATE = 0.09701


def coo_state(svc, tenants) -> dict:
    """Per tenant ``(keys, vals, nnz, flushes)`` of the flushed running sum,
    on the host: the bitwise-comparable state of a service."""
    out = {}
    for t in tenants:
        s = svc.value(t)
        out[t] = (s.keys.cpu().numpy(), s.vals.cpu().numpy(), int(s.nnz),
                  svc.stats()["tenants"][t]["flushes"])
    return out


def same_state(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(
        np.array_equal(a[t][0], b[t][0])
        and a[t][1].tobytes() == b[t][1].tobytes()
        and a[t][2:] == b[t][2:] for t in a)


def stream_cells(dev) -> dict:
    """The three chaos cells through the port on ``dev``, each at its own
    size and seed, with the numbers the reference's smoke reports."""
    import tempfile

    from repro_torch.core.stream_service import (REC_MAGIC, StreamService,
                                                 TornRecordError,
                                                 decode_journal)
    from repro_torch.launch import stream_serve as SV
    from repro_torch.runtime.faults import (ServiceFaultInjector,
                                            ServiceFaultSpec)

    def mk(a):
        return SV.make_matrix(CELL_SHAPE, CELL_NNZ, a.mat_seed, device=dev)

    def steady(root, fault_injector=None):
        return StreamService(soft_pending_nnz=1 << 20,
                             hard_pending_nnz=1 << 21, flush_deadline=0.5,
                             journal_root=root,
                             fault_injector=fault_injector, device=dev)

    def register(svc, names, batch_k):
        return sum(svc.register_tenant(n, CELL_SHAPE, cap_budget=CELL_CAP,
                                       batch_k=batch_k) for n in names)

    out = {}
    names = [SV.tenant_name(i) for i in range(4)]
    events = SV.build_workload(n_tenants=4, duration=6.0, rate=2.0,
                               tick_every=0.25, seed=17)
    with tempfile.TemporaryDirectory() as ref_dir, \
            tempfile.TemporaryDirectory() as crash_dir:
        ref = steady(ref_dir)
        register(ref, names, 3)
        ref_res = SV.drive(ref, events, make_mat=mk)
        ref.drain(6.0)
        inj = ServiceFaultInjector(ServiceFaultSpec(crash_at_flush=(3,),
                                                    seed=17))
        svc = steady(crash_dir, inj)
        register(svc, names, 3)
        res = SV.drive(svc, events, make_mat=mk)
        rec = steady(crash_dir)
        replayed = register(rec, names, 3)
        res2 = SV.drive(rec, events, make_mat=mk, start_index=res.next_index)
        rec.drain(6.0)
        out["crash_replay"] = {
            "crashed": not res.completed,
            "crashes_injected": inj.injected["crash"],
            "resumed_completed": res2.completed,
            "replayed_records": replayed,
            "quarantined": sum(t["quarantined_records"]
                               for t in rec.stats()["tenants"].values()),
            "bitwise": same_state(coo_state(ref, names),
                                  coo_state(rec, names)),
            "ref_flushes": ref.flush_ordinal,
            "ref_admitted": ref_res.admitted}

    cold = [SV.tenant_name(i) for i in range(4)]
    hot = [SV.tenant_name(4 + i) for i in range(4)]
    svc = StreamService(soft_pending_nnz=512, hard_pending_nnz=576,
                        flush_deadline=0.5, device=dev)
    register(svc, cold, 16)
    register(svc, hot, 4)
    events = SV.build_workload(
        n_tenants=8, duration=4.0, rate=10.0, tick_every=0.25, seed=25,
        cold_tenants=cold, cold_until=0.5,
        faults=ServiceFaultSpec(stall_tenants=tuple(hot), stall_from=0.0,
                                stall_until=0.5))
    res = SV.drive(svc, events, make_mat=mk)
    s = SV.summarize(svc, res, duration=4.0)
    st = svc.stats()["tenants"]
    out["overload_shed"] = {
        "admitted": res.admitted, "deferred": res.deferred,
        "evicted_nnz_hot": sum(st[n]["evicted_nnz"] for n in hot),
        "evicted_windows": sum(t["evicted_windows"] for t in st.values()),
        "hot_flushes": sum(st[n]["flushes"] for n in hot),
        "shed_rate": s["shed_rate"],
        "p99_flush_latency": s["p99_flush_latency"],
        "conserved": all(t["admitted_nnz"] == t["evicted_nnz"]
                         + t["buffered_nnz"] + t["flushed_nnz"]
                         for t in st.values())}

    names = [SV.tenant_name(i) for i in range(3)]
    events = SV.build_workload(n_tenants=3, duration=4.0, rate=4.0,
                               tick_every=0.25, seed=31)
    with tempfile.TemporaryDirectory() as root:
        inj = ServiceFaultInjector(ServiceFaultSpec(torn_write_p=0.3,
                                                    seed=31))
        svc = steady(root, inj)
        register(svc, names, 4)
        SV.drive(svc, events, make_mat=mk)
        torn = good = 0
        for n in names:
            for fn in sorted(os.listdir(os.path.join(root, n))):
                if fn.startswith("rec_"):
                    with open(os.path.join(root, n, fn), "rb") as f:
                        buf = f.read()
                    try:
                        decode_journal(buf, REC_MAGIC)
                        good += 1
                    except TornRecordError:
                        torn += 1
        rec = steady(root)
        replayed = register(rec, names, 4)
        quarantined = sum(t["quarantined_records"]
                          for t in rec.stats()["tenants"].values())
        rec.drain(4.0)
        out["torn_journal"] = {
            "torn_injected": inj.injected["torn_write"],
            "expected_torn": torn, "expected_good": good,
            "quarantined": quarantined, "replayed": replayed,
            "post_recovery_flushes": rec.flush_ordinal}
    return out


def host_push_sums(events, shape, nnz):
    """Per tenant, the float64 sum of its pushes by key (sorted keys and
    sums), from the load generator's draws made again here with numpy:
    ``rng.choice`` positions of the row-major ``m x n`` array, keyed
    column-major, and ``standard_normal`` values rounded to f32."""
    m, n = shape
    parts = {}
    for ev in events:
        if ev.kind != "push":
            continue
        rng = np.random.default_rng(ev.arrival.mat_seed)
        idx = rng.choice(m * n, size=min(nnz, m * n), replace=False)
        vals = rng.standard_normal(len(idx)).astype(np.float32)
        parts.setdefault(ev.arrival.tenant, []).append(
            ((idx % n) * m + idx // n, vals.astype(np.float64)))
    out = {}
    for t, ps in parts.items():
        keys = np.concatenate([k for k, _ in ps])
        uniq, inv = np.unique(keys, return_inverse=True)
        out[t] = (uniq, np.bincount(inv, weights=np.concatenate(
            [v for _, v in ps])))
    return out


#: Tenants of the stream-service drive: 512 cut to 64. On this card the
#: ``hash`` regime's sliding-hash geometry gives every row of a co-flush
#: 2 x m x n table slots (2,048 parts of 16,384 at 65,536 x 256: 268 MB of
#: tables and about 1 GB with the compaction's sort), so one co-flush holds
#: about 60 tenants in 80 GB; with 512 tenants the first co-flush (120 of
#: them) ran out of memory. At 64 the largest co-flush has 30.
STREAM_TENANTS = 64


def run_stream_service(torch, seed: int, dev, kernels: dict):
    """Phase ``stream_service``: the multi-tenant stream service through
    the port's entry points on the card.

    (a) The chaos cells of ``benchmarks/stream_service.py --smoke`` at
    their own sizes and seeds (:func:`stream_cells`): their counts must be
    the reference's (:data:`CELL_COUNTS`), crash_replay bitwise.

    (b) One deployment of the size the engine ``hash`` cell stands for:
    :data:`STREAM_TENANTS` tenants of 65,536 x 256 in one capacity bucket,
    512 nonzeros a push (``make_matrix``), windows of 15, a 32,768-entry
    f32 budget, open-loop arrivals at 8 a tenant a simulated second for 4.0 s
    from ``seed``, ticks every 0.25 s, a 0.5 s deadline, co-flushes of up
    to 512 windows, watermarks 2^24 / 2^25, the journal on. Drive 1 is the
    main path: every co-flush must dispatch ``hash`` and launch the
    sliding-hash kernel, nothing may be deferred or shed, and each tenant's
    final sum must equal float64 numpy sums of its pushes to 1e-5 with
    nothing truncated. Drive 2 replays the events with
    ``algorithm="sorted"`` (no journal) and must end bitwise equal;
    drive 3 crashes at flush 2, recovers every tenant over its journal,
    resumes at the crashed event and must end bitwise equal to drive 1
    (keys, values, nnz, flush counts). Its first co-flush after recovery
    runs under ``torch.profiler``, its sliding-hash launches timed by CUDA
    events, the largest one's inputs kept for the kernel line.

    Returns the phase's numbers and the kept launch ``((keys, vals),
    kwargs)`` of ``ops.hash_slide_tables``."""
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import engine as E
    from repro_torch.core.stream_service import StreamService
    from repro_torch.kernels import ops as kops
    from repro_torch.launch import stream_serve as SV
    from repro_torch.runtime.faults import (ServiceFaultInjector,
                                            ServiceFaultSpec)

    t_phase = time.monotonic()
    for fn in kernels.values():
        fn.launches = 0
    cells = stream_cells(dev)
    cell_launches = {k: fn.launches for k, fn in kernels.items()
                     if fn.launches}
    for name, want in CELL_COUNTS.items():
        got = {k: cells[name][k] for k in want}
        check(got == want, f"phase stream_service: cell {name} gave {got}, "
              f"the reference {want}")
    ov = cells["overload_shed"]
    check(abs(ov["shed_rate"] - CELL_SHED_RATE) < 5e-6
          and ov["evicted_nnz_hot"] == 0 and ov["conserved"],
          f"phase stream_service: cell overload_shed {ov}")
    cr, tj = cells["crash_replay"], cells["torn_journal"]
    check(cr["crashed"] and cr["crashes_injected"] == 1
          and cr["resumed_completed"] and cr["quarantined"] == 0,
          f"phase stream_service: cell crash_replay {cr}")
    check(tj["quarantined"] == tj["expected_torn"]
          and tj["replayed"] == tj["expected_good"]
          and tj["post_recovery_flushes"] >= 1,
          f"phase stream_service: cell torn_journal {tj}")
    check(cell_launches.get("segment_fold", 0) > 0, "phase stream_service: "
          "the cells' co-flushes launched no segment fold")
    log(f"phase stream_service: cells {cells}; launches {cell_launches}")
    cells_s = time.monotonic() - t_phase

    tenants, shape, nnz, cap = STREAM_TENANTS, (65536, 256), 512, 32768
    batch_k, duration, rate = 15, 4.0, 8.0
    names = [SV.tenant_name(i) for i in range(tenants)]
    events = SV.build_workload(n_tenants=tenants, duration=duration,
                               rate=rate, tick_every=0.25, seed=seed)
    offered = sum(ev.kind == "push" for ev in events)

    def make_service(root, algorithm="auto", fault_injector=None):
        return StreamService(soft_pending_nnz=1 << 24,
                             hard_pending_nnz=1 << 25, flush_deadline=0.5,
                             max_coflush_windows=512, journal_root=root,
                             fault_injector=fault_injector,
                             algorithm=algorithm, device=dev)

    def register(svc):
        return sum(svc.register_tenant(n, shape, cap_budget=cap,
                                       batch_k=batch_k) for n in names)

    def mk(a):
        return SV.make_matrix(shape, nnz, a.mat_seed, device=dev)

    def timed_flushes(svc, into: list, dispatched: list):
        """Wrap ``svc``'s co-flush to keep each one's report, host ms
        (ending in a synchronize) and the ``(k, regime)`` of each batched
        engine call it made (from ``dispatched``)."""
        inner = svc._flush_bucket

        def flush(key, ready, now):
            torch.cuda.synchronize()
            n0 = len(dispatched)
            t0 = time.perf_counter()
            report = inner(key, ready, now)
            torch.cuda.synchronize()
            into.append((report, (time.perf_counter() - t0) * 1e3,
                         dispatched[n0:]))
            return report
        svc._flush_bucket = flush

    def one_drive(svc, flushes, dispatched, start=0):
        timed_flushes(svc, flushes, dispatched)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = SV.drive(svc, events, make_mat=mk, start_index=start)
        if res.completed:
            svc.drain(duration)
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    def flush_summary(flushes):
        return {"count": len(flushes),
                "tenants": [r.tenants for r, _, _ in flushes],
                "windows": [r.windows for r, _, _ in flushes],
                "host_ms": [ms for _, ms, _ in flushes],
                "dispatch": [d for _, _, d in flushes]}

    out = {"tenants": tenants, "reduced": {"tenants": [512, tenants]},
           "shape": list(shape), "nnz_per_push": nnz,
           "batch_k": batch_k, "cap_budget": cap, "rate": rate,
           "duration": duration, "offered": offered, "cells": cells,
           "cell_launches": cell_launches, "cells_s": cells_s}
    with tempfile.TemporaryDirectory() as main_dir, \
            tempfile.TemporaryDirectory() as crash_dir:
        # ---- drive 1: the main path ------------------------------------
        svc = make_service(main_dir)
        register(svc)
        dispatched, flushes = [], []
        explain = E.explain_batched_dispatch

        def explain_keeping(*a, **kw):
            r = explain(*a, **kw)
            dispatched.append((r[0].k, r[2]))
            return r

        E.explain_batched_dispatch = explain_keeping
        torch.cuda.synchronize()
        for fn in kernels.values():
            fn.launches = 0
        try:
            res, wall = one_drive(svc, flushes, dispatched)
        finally:
            E.explain_batched_dispatch = explain
        launches = {k: fn.launches for k, fn in kernels.items()
                    if fn.launches}
        st = svc.stats()["tenants"]
        check(res.completed and res.admitted == offered and res.deferred == 0
              and res.rate_limited == 0, f"phase stream_service: drive 1 "
              f"admitted {res.admitted} of {offered} (deferred "
              f"{res.deferred}, rate-limited {res.rate_limited})")
        check(sum(t["evicted_windows"] for t in st.values()) == 0,
              "phase stream_service: drive 1 shed windows")
        # every co-flush runs its windows through ``hash``; the drain's
        # groups of a sum and one or two pushes (k <= 3) go to ``tree``,
        # the reference's tiny-k regime
        hashed = sum(alg == "hash" for _, alg in dispatched)
        check(flushes and all(
            any(alg == "hash" for _, alg in d)
            and all(alg == "hash" or (alg == "tree" and k <= 3)
                    for k, alg in d) for _, _, d in flushes),
              f"phase stream_service: co-flush dispatch "
              f"{[d for _, _, d in flushes]}: expected 'hash' in each, "
              f"'tree' only at k <= 3")
        check(launches.get("hash_slide", 0) == hashed,
              f"phase stream_service: {launches.get('hash_slide', 0)} "
              f"sliding-hash launches for {hashed} hash dispatches")
        state1 = coo_state(svc, names)
        out["drive1"] = {"wall_s": wall, "admitted": res.admitted,
                         "admitted_per_wall_s": res.admitted / wall,
                         "launches": launches,
                         "batched_calls": len(dispatched),
                         "hash_calls": hashed,
                         "coflushes": flush_summary(flushes),
                         "summary": SV.summarize(svc, res,
                                                 duration=duration)}
        del svc
        # the float64 numpy sums of every tenant's pushes; the budget must
        # have dropped nothing
        ref64 = host_push_sums(events, shape, nnz)
        worst = 0.0
        for t in names:
            keys, vals, n_out, _ = state1[t]
            uk, us = ref64.get(t, (np.zeros(0, np.int64), np.zeros(0)))
            check(uk.size <= cap and n_out == uk.size,
                  f"phase stream_service: tenant {t} holds {n_out} entries "
                  f"of {uk.size} distinct keys (budget {cap})")
            check(np.array_equal(keys[:n_out], uk), f"phase stream_service: "
                  f"tenant {t}'s keys differ from numpy")
            got = vals[:n_out]
            check(np.isfinite(got).all() and np.allclose(
                got, us, rtol=1e-5, atol=1e-5), f"phase stream_service: "
                f"tenant {t}'s sums differ from float64 beyond 1e-5")
            if n_out:
                worst = max(worst, float(np.abs(got - us).max()))
        out["drive1"]["max_abs_err_vs_f64"] = worst
        out["drive1"]["max_distinct_keys"] = max(
            (ref64[t][0].size for t in ref64), default=0)

        # ---- drive 2: the same events through the sorted path -----------
        svc = make_service(None, algorithm="sorted")
        register(svc)
        flushes2 = []
        res2, wall2 = one_drive(svc, flushes2, [])
        check(same_state(state1, coo_state(svc, names)),
              "phase stream_service: drive 1 differs bitwise from the "
              "sorted drive")
        out["drive2_sorted"] = {"wall_s": wall2, "admitted": res2.admitted,
                                "admitted_per_wall_s": res2.admitted / wall2,
                                "coflushes": flush_summary(flushes2)}
        del svc

        # ---- drive 3: a crash at flush 2, recovery, resume --------------
        inj = ServiceFaultInjector(ServiceFaultSpec(crash_at_flush=(2,)))
        svc = make_service(crash_dir, fault_injector=inj)
        register(svc)
        flushes3 = []
        res3, wall3 = one_drive(svc, flushes3, [])
        check(not res3.completed and inj.injected["crash"] == 1,
              "phase stream_service: drive 3 did not crash at flush 2")
        del svc
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rec = make_service(crash_dir)
        replayed = register(rec)
        torch.cuda.synchronize()
        recovery_ms = (time.perf_counter() - t0) * 1e3
        check(replayed > 0, "phase stream_service: recovery replayed "
              "nothing")
        # the first co-flush after recovery (the one the crash swallowed),
        # under the profiler, its sliding-hash launches timed by events
        kept, slides = [], []
        inner = rec._flush_bucket
        table_fn = kops.hash_slide_tables

        def slide_timed(*a, **kw):
            ev0 = torch.cuda.Event(enable_timing=True)
            ev1 = torch.cuda.Event(enable_timing=True)
            ev0.record()
            r = table_fn(*a, **kw)
            ev1.record()
            slides.append((ev0, ev1, kw["parts"], tuple(a[0].shape)))
            kept.append((a, kw))
            return r

        def profiled_flush(key, ready, now):
            rec._flush_bucket = inner
            kops.hash_slide_tables = slide_timed
            try:
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    report = inner(key, ready, now)
                    torch.cuda.synchronize()
                    wall_ms = (time.perf_counter() - t0) * 1e3
            finally:
                kops.hash_slide_tables = table_fn
            profiled.update(device_times(torch, prof, wall_ms, top=8))
            profiled.update(tenants=report.tenants, windows=report.windows,
                            slide_launches=[
                                {"ms": e0.elapsed_time(e1), "parts": p,
                                 "shape": list(s)}
                                for e0, e1, p, s in slides])
            return report

        profiled = {}
        rec._flush_bucket = profiled_flush
        t0 = time.perf_counter()
        res4 = SV.drive(rec, events, make_mat=mk, start_index=res3.next_index)
        rec.drain(duration)
        torch.cuda.synchronize()
        resumed_s = time.perf_counter() - t0
        check(res4.completed and profiled, "phase stream_service: the "
              "resumed drive did not complete a co-flush")
        check(same_state(state1, coo_state(rec, names)),
              "phase stream_service: the recovered drive differs bitwise "
              "from drive 1")
        out["drive3_crash"] = {
            "wall_s_to_crash": wall3, "crashed_at_event": res3.next_index,
            "recovery_ms": recovery_ms, "replayed_records": replayed,
            "resumed_wall_s": resumed_s,
            "coflushes_before_crash": flush_summary(flushes3)}
        out["coflush_profile"] = profiled
        del rec
    d1 = out["drive1"]
    log(f"phase stream_service: {tenants} tenants, {offered} pushes; drive "
        f"1 {d1['wall_s']:.2f} s ({d1['admitted_per_wall_s']:.0f} admitted "
        f"pushes a wall second), {d1['coflushes']['count']} co-flushes "
        f"(tenants {d1['coflushes']['tenants']}, windows "
        f"{d1['coflushes']['windows']}, host ms "
        f"{[round(t, 1) for t in d1['coflushes']['host_ms']]}), "
        f"{d1['batched_calls']} batched calls ({d1['hash_calls']} hash), "
        f"launches "
        f"{d1['launches']}; max |err| vs float64 {d1['max_abs_err_vs_f64']:.3g},"
        f" at most {d1['max_distinct_keys']} distinct keys a tenant")
    d2 = out["drive2_sorted"]
    log(f"phase stream_service: sorted drive {d2['wall_s']:.2f} s "
        f"({d2['admitted_per_wall_s']:.0f} admitted pushes a wall second), "
        f"bitwise equal; drive 3 crashed at event {res3.next_index} after "
        f"{wall3:.2f} s, recovery {recovery_ms:.1f} ms replaying {replayed} "
        f"records, resumed drive {resumed_s:.2f} s (the profiler's start "
        f"included), bitwise equal to drive 1")
    log(f"phase stream_service: profiled co-flush ({profiled['tenants']} "
        f"tenants, {profiled['windows']} windows): device "
        f"{profiled['device_ms']:.2f} ms of {profiled['wall_ms']:.2f} ms "
        f"(idle {1 - profiled['busy_share']:.0%}), top "
        f"{profiled['top'][:4]}; sliding-hash launches "
        f"{profiled['slide_launches']}")
    check(kept, "phase stream_service: the profiled co-flush made no "
          "sliding-hash launch")
    largest = max(kept, key=lambda c: c[0][0].numel() * c[1]["parts"])
    return out, largest


def catchup_frames(pub, size: int) -> list:
    """The frames of B's window-4 catch-up (epochs 1-4, ``pub``'s ring) of
    the leaves of ``size`` parameters, one collection per leaf."""
    from repro_torch.runtime.delta_sync import decode_frame

    frames = {}
    for epoch in range(1, 5):
        for buf in pub.frames_for(epoch):
            f = decode_frame(buf)
            if f.size == size:
                frames.setdefault(f.shard, []).append(f)
    return list(frames.values())


def replay_catchup_launch(pub, call, dev, module, name: str):
    """The inputs ``(args, kwargs)`` of one launch of B's catch-up whose
    shapes the phase kept (``call``: ``module.name``'s argument shapes and
    keyword arguments): the engine call of that launch's bucket made again,
    untimed, on the same window's frames of the leaves of its size. Fails
    unless the replay launches with the same shapes and arguments."""
    from repro_torch.core.engine import spkadd_batched_ragged
    from repro_torch.runtime.delta_sync import frame_to_coo

    shapes, fkw = call
    colls = [[frame_to_coo(f, dev) for f in fs]
             for fs in catchup_frames(pub, fkw["m"] * fkw["n"])]
    got = []
    fn = getattr(module, name)

    def keeping_inputs(*a, **kw):
        if tuple(tuple(t.shape) for t in a) == shapes and kw == fkw:
            got.append((a, kw))
        return fn(*a, **kw)

    setattr(module, name, keeping_inputs)
    try:
        spkadd_batched_ragged(colls)
    finally:
        setattr(module, name, fn)
    check(len(got) == 1, f"phase delta_sync: the replay of the catch-up did "
          f"not repeat its {name} launch")
    return got[0]


def catchup_hash_buckets(torch, pub, calls, dev) -> dict:
    """B's catch-up's sliding-hash buckets, after the phase: each bucket's
    engine call again (the ``hash`` regime its dispatch picks) beside the
    ``vec`` regime on the same collections (a measurement only: dispatch
    stays the reference's cost model), host ms of each, both checked
    bitwise against the ``sorted`` path; and the largest launch's
    ``ops.hash_slide_tables`` inputs, from its replay
    (:func:`replay_catchup_launch`; the kernel line times and checks it)."""
    from repro_torch.core.engine import spkadd_batched_ragged
    from repro_torch.kernels import ops as kops
    from repro_torch.runtime.delta_sync import frame_to_coo

    check(calls, "phase delta_sync: the catch-up made no sliding-hash "
          "launch")
    buckets = []
    for shapes, fkw in calls:
        size = fkw["m"] * fkw["n"]
        colls = [[frame_to_coo(f, dev) for f in fs]
                 for fs in catchup_frames(pub, size)]
        want = spkadd_batched_ragged(colls, algorithm="sorted")
        row = {"leaf_size": size, "collections": len(colls),
               "B": shapes[0][0], "cap": shapes[0][1],
               "parts": fkw["parts"], "table_size": fkw["table_size"]}
        for alg in ("auto", "vec"):
            out = spkadd_batched_ragged(colls, algorithm=alg)
            check(all(same_coo(torch, a, b) for a, b in zip(out, want)),
                  f"phase delta_sync: the catch-up's {size}-slot bucket "
                  f"through {alg} differs from sorted")
            del out
            row[f"{alg}_ms"] = host_ms(
                torch, lambda: spkadd_batched_ragged(colls, algorithm=alg), 3)
        buckets.append(row)
        del want, colls
    largest = max(calls, key=lambda c: c[0][0][0] * c[1]["parts"]
                  * c[1]["table_size"])
    return {"buckets": buckets, "largest": replay_catchup_launch(
        pub, largest, dev, kops, "hash_slide_tables")}


def launch_slots(call) -> int:
    """Dense slots a partition launch ``(shapes, kwargs)`` writes."""
    (key_shape, *_), fkw = call
    rows = key_shape[0] if len(key_shape) == 2 else 1
    return rows * fkw["parts"] * fkw["part_elems"]


def partition_design(torch, partition, keys, steps, kw, dev) -> dict:
    """The partition kernel's design numbers at one launch: its sub-tile
    cut, blocks per SM and the bytes it moves (modelled)."""
    sub_elems, subs = partition.sub_tile_geometry(kw["part_elems"])
    B, cap_pad = keys.shape
    max_steps = steps.chunk_id.shape[1]
    blocks = B * kw["parts"] * subs
    nvalid = int((keys < kw["mn"]).sum())
    out_elems = B * kw["parts"] * kw["part_elems"]
    # modelled: each round of a search reads one 32-byte sector per thread
    # and bound (two bounds, over the step table and then the part's span)
    rounds = (-(-int(np.log2(max(max_steps, 2))) // 8)
              + -(-int(np.log2(max(cap_pad // kw["parts"], 2))) // 8))
    return {
        "sub_elems": sub_elems, "subs": subs, "blocks": blocks,
        "blocks_per_sm": partition.blocks_per_sm(sub_elems, dev),
        "design_bytes": 8 * nvalid + 4 * out_elems + 8 * B * max_steps,
        "search_sector_bytes": blocks * 2 * 256 * 32 * rounds,
    }


def partition_catchup(torch, partition, call) -> dict:
    """The partition kernel at the delta-sync catch-up's largest launch
    (the embed/head ``vec`` bucket), against its plain version (bitwise)
    and ``index_add_`` on the same inputs. ``call``: the ``(args,
    kwargs)`` of that launch's ``ops.partitioned_accumulate_flat`` call
    (:func:`replay_catchup_launch`)."""
    args, fkw = call
    keys, vals, cid, pid = args
    if keys.dim() == 1:
        keys, vals, cid, pid = keys[None], vals[None], cid[None], pid[None]
    keys, vals = keys.to(torch.int32), vals.to(torch.float32)
    kw = dict(mn=fkw["m"] * fkw["n"], part_elems=fkw["part_elems"],
              parts=fkw["parts"], chunk=fkw["chunk"])
    got = partition.partitioned_accumulate_raw(keys, vals, cid, pid, **kw)
    want = partition.partitioned_accumulate_plain(keys, vals, cid, pid, **kw)
    check(bitwise_equal(torch, got, want), "partition kernel differs from "
          "its plain version at the catch-up's shape")
    # index_add_ of the valid elements (the sentinel padding would all hit
    # one slot) into a zero (B, slots) buffer made outside the timing
    B, stride = keys.shape[0], got.shape[1]
    valid = keys < kw["mn"]
    acc = torch.zeros(B * stride, device=keys.device)
    idx = (keys.long() + torch.arange(B, device=keys.device).unsqueeze(1)
           * stride)[valid]
    flat_vals = vals[valid]
    nbytes = 4 * (keys.numel() + vals.numel() + cid.numel() + pid.numel()
                  + got.numel())
    ms_bound = bound(nbytes, int(valid.sum()))
    return {"B": B, "cap_pad": keys.shape[1], "valid": int(valid.sum()),
            **kw,
            "sub_elems": partition.sub_tile_geometry(kw["part_elems"])[0],
            "ms": cuda_ms(torch, lambda: partition.partitioned_accumulate_raw(
                keys, vals, cid, pid, **kw), 20),
            "index_add_ms": cuda_ms(torch, lambda: acc.index_add_(
                0, idx, flat_vals), 20),
            "bound_ms": ms_bound[0], "bytes": nbytes}


def slide_catchup(torch, hash_slide, caught, seed, sample: int = 8,
                  what: str = "the catch-up's") -> dict:
    """The sliding-hash kernel at the delta-sync catch-up's largest launch
    (``caught["largest"]``: the ``(args, kwargs)`` of its
    ``ops.hash_slide_tables`` call, rebuilt after the phase by
    :func:`catchup_hash_buckets`, padded here as that call pads them), or
    at another launch the caller kept (``what`` names it): two
    launches with the same
    bits; ``sample`` parts drawn from ``seed`` checked bitwise against the
    plain version (each part's in-range elements, in stream order, as a
    one-part stream: the same hash, probes and fold); its time, blocks and
    bytes; and each hash bucket's engine call beside ``vec``."""
    from repro_torch.kernels import ops as kops

    (keys, vals), fkw = caught["largest"]
    kw = dict(mn=fkw["m"] * fkw["n"], table_size=fkw["table_size"],
              part_span=fkw["part_span"], parts=fkw["parts"],
              chunk=fkw["chunk"])
    keys, vals = kops.pad_stream(keys, vals, kw["mn"], kw["chunk"])
    B, cap = keys.shape
    runs = [hash_slide.hash_slide_raw(keys, vals, **kw) for _ in range(2)]
    check(all(bitwise_equal(torch, a, b) for a, b in zip(runs[0], runs[1])),
          f"hash_slide: two launches at {what} shape differ")
    tk, tv = runs[0]
    T, span, parts = kw["table_size"], kw["part_span"], kw["parts"]
    rng = np.random.default_rng(seed)
    picks = sorted({(int(rng.integers(B)), int(rng.integers(parts)))
                    for _ in range(sample)})
    k_cpu, v_cpu = keys.cpu(), vals.cpu()
    for b, p in picks:
        sel = ((k_cpu[b] >= p * span) & (k_cpu[b] < (p + 1) * span)
               & (k_cpu[b] < kw["mn"]))
        n = int(sel.sum())
        pad = -(-max(n, 1) // kw["chunk"]) * kw["chunk"]
        pk = torch.full((1, pad), kw["mn"], dtype=torch.int32)
        pv = torch.zeros((1, pad), dtype=torch.float32)
        pk[0, :n], pv[0, :n] = k_cpu[b][sel], v_cpu[b][sel]
        wk, wv = hash_slide.hash_slide_plain(
            pk, pv, mn=kw["mn"], table_size=T, part_span=kw["mn"], parts=1,
            chunk=kw["chunk"])
        lo = p * T
        check(bitwise_equal(torch, tk[b, lo:lo + T].cpu(), wk[0])
              and bitwise_equal(torch, tv[b, lo:lo + T].cpu(), wv[0]),
              f"hash_slide: part {p} of row {b} at {what} shape "
              f"differs from its plain version")
    del runs, tk, tv
    nbytes = 8 * B * cap + 8 * B * parts * T
    valid = int((keys < kw["mn"]).sum())
    return {"B": B, "cap": cap, "valid": valid, "parts": parts,
            "table_size": T, "blocks": B * parts, "sampled_parts": picks,
            "ms": cuda_ms(torch, lambda: hash_slide.hash_slide_raw(
                keys, vals, **kw), 5),
            "bound_ms": bound(nbytes, valid)[0], "bytes": nbytes,
            "moved_bytes": hash_slide.moved_bytes(B, cap, table_size=T,
                                                  parts=parts),
            "buckets": caught.get("buckets")}


def topk_design(torch, topk_block, x, k, block, leaves, dev, seed) -> dict:
    """The block top-k kernel's design numbers: the radix passes each block
    of ``x`` takes (``radix_passes``), and its time at each leaf shape
    ``(elements, k, block)`` of a delta-sync publish, on values of the
    delta-sync grid made from ``seed``, beside ``torch.topk`` (each checked
    bitwise against the plain version)."""
    passes = topk_block.radix_passes(x, k=k, block=block)
    per_leaf = []
    gen = torch.Generator(device=dev).manual_seed(seed)
    for numel, lk, lblock in leaves:
        lx = torch.randint(-256, 256, (numel,), generator=gen, device=dev,
                           dtype=torch.int32).float() * GRID
        gi, gv = topk_block.topk_block_raw(lx, k=lk, block=lblock)
        pi, pv = topk_block.topk_block_plain(lx, k=lk, block=lblock)
        check(bitwise_equal(torch, gi, pi) and bitwise_equal(torch, gv, pv),
              f"topk_block differs from its plain version at a leaf of "
              f"{lx.numel()}")
        lb = bound(4 * lx.numel() + 8 * gi.numel(), lx.numel())
        per_leaf.append({
            "elements": lx.numel(), "blocks": lx.numel() // lblock,
            "block": lblock, "k": lk, "bound_ms": lb[0],
            "ms": cuda_ms(torch, lambda: topk_block.topk_block_raw(
                lx, k=lk, block=lblock), 10),
            "torch_topk_ms": cuda_ms(torch, lambda: torch.topk(
                lx.view(-1, lblock).abs(), lk, dim=1), 10)})
    return {"radix_passes": {int(p): int(c) for p, c in enumerate(
                torch.bincount(passes.long()).tolist()) if c},
            "smem_bytes": topk_block.smem_bytes(block, k),
            "leaves": per_leaf, "leaves_ms": sum(r["ms"] for r in per_leaf),
            "leaves_torch_topk_ms": sum(r["torch_topk_ms"]
                                        for r in per_leaf)}


def run(args, torch) -> int:
    from repro_torch import obs
    from repro_torch.core import engine as E
    from repro_torch.core import sparse as S
    from repro_torch.core import spkadd as A
    from repro_torch.kernels import _build, hash_accum, hash_slide, ops as kops
    from repro_torch.kernels import partition, segment, spa_accum, topk_block
    from repro_torch.kernels import xla_add
    from repro_torch.launch import fold_timing

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
        "xla_add": xla_add.xla_add_raw,
    }

    def reset_counts():
        for fn in kernels.values():
            fn.launches = 0
        hash_accum.hash_symbolic_raw.serial_launches = 0
        hash_accum.hash_accumulate_raw.serial_launches = 0

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
        calls_ms = []
        family[alg] = {
            "ms": host_ms(torch, lambda: A.spkadd(mats, algorithm=alg), 3,
                          calls_ms),
            "calls_ms": calls_ms, "checked_call_ms": checked_ms,
            "launches": used, "out_nnz": int(hk_np.size)}
        log(f"phase family: {alg} {family[alg]['ms']:.2f} ms (calls "
            f"{[round(t, 2) for t in calls_ms]}), launches {used}; equal to "
            f"sorted"
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
    acc_serial = hash_accum.hash_accumulate_raw.serial_launches
    check(launches["hash_accum"] > 0, "phase hash_alg: hash kernel not "
          "launched")
    check(acc_serial == 0, f"phase hash_alg: the accumulate took the "
          f"one-thread route {acc_serial} times")
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
        "accumulate_route": hash_accum.accumulate_route(cat3.cap, table3),
        "accumulate_serial_launches": acc_serial,
        "symbolic_serial_launches":
        hash_accum.hash_symbolic_raw.serial_launches,
        "ms": host_ms(torch, lambda: A.spkadd(mats3, algorithm="hash"), 3),
        "symbolic_ms": host_ms(torch, lambda: kops.hash_symbolic(
            cat3.keys, sent=sent3), 3)}
    log(f"phase hash_alg: hash == sorted bitwise, nnz {nh}, table "
        f"{table3} slots; {phases['hash_alg']['ms']:.2f} ms, symbolic "
        f"{phases['hash_alg']['symbolic_ms']:.3f} ms ({sym_route} route)")
    phases["hash_alg"]["phase_s"] = took()

    # ---- 6. delta_sync: SmolLM-135M's parameters, publisher -> replicas --
    del out_vec, out_sorted, out_hash, out_hash_sorted, out_h, out_hs
    phases["delta_sync"], launches["topk_block"], captured, ds_round = \
        run_delta_sync(torch, args.seed, dev, kernels)
    embed_x = captured["embed_x"]
    launches["xla_add"] = phases["delta_sync"]["xla_add_launches"]
    # the round with the flushing add's plain version (xla_float's extra
    # passes) in turns with the kernel: kernel, plain, kernel
    ds = phases["delta_sync"]
    ds["round_ms"] = host_ms(torch, ds_round, 3)
    kernel_add = xla_add.xla_add_raw
    xla_add.xla_add_raw = xla_add.xla_add_plain
    try:
        ds["round_plain_add_ms"] = host_ms(torch, ds_round, 3)
    finally:
        xla_add.xla_add_raw = kernel_add
    ds["round_again_ms"] = host_ms(torch, ds_round, 3)
    log(f"phase delta_sync: round ms {ds['round_ms']:.2f}, with the plain "
        f"flushing add {ds['round_plain_add_ms']:.2f}, again "
        f"{ds['round_again_ms']:.2f}")
    phases["delta_sync"]["phase_s"] = took()

    # ---- 7. stream_service: the multi-tenant stream service -------------
    phases["stream_service"], stream_launch = run_stream_service(
        torch, args.seed, dev, kernels)
    phases["stream_service"]["phase_s"] = took()

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
            family["tree"]["ms"], watch=("segment_fold",)),
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
            f"{prof['wall_ms']:.3f} ms wall; top {prof['top'][:3]}"
            + (f"; {prof['watch']}" if "watch" in prof else ""))
    tree_fold = profiles["family_tree"]["watch"]["segment_fold"]
    check(tree_fold[1] == family["tree"]["launches"].get("segment_fold"),
          f"profile family_tree: {tree_fold[1]} segment-fold kernels, the "
          f"tree call launched {family['tree']['launches']}")
    # the two family members whose host time has jumped far above their
    # device time in some runs, ten calls each (after the delta-sync
    # phase, whose peak memory and profiler start-up it would change)
    for alg in ("vec", "blocked_spa"):
        probe = host_stall_probe(torch, lambda: A.spkadd(mats, algorithm=alg))
        profiles[f"family_{alg}_calls"] = probe
        runtime = {name: [n, round(total, 2), round(longest, 2)]
                   for name, (n, total, longest) in probe["runtime"].items()}
        log(f"profile family_{alg}_calls: host ms "
            f"{[round(t, 2) for t in probe['calls_ms']]}, device "
            f"{probe['device_ms']:.2f} ms a call, runtime {runtime}")
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
        **partition_design(torch, partition, keys_p, steps, pkw, dev),
        "catchup": partition_catchup(torch, partition,
                                     captured.pop("catchup_partition")),
    })
    del got, want, lib_acc

    # hash_slide, at phase 2's padded streams (one part: no bucketing)
    cat2 = S.concat(stacked)
    hkw = dict(mn=m2 * n2, table_size=geom2.table_size,
               part_span=geom2.part_span, parts=geom2.parts,
               chunk=geom2.chunk)
    check(cat2.cap % geom2.chunk == 0, "phase hash stream is not chunk-aligned")
    runs = [hash_slide.hash_slide_raw(cat2.keys, cat2.vals, **hkw)
            for _ in range(2)]
    t_plain = time.perf_counter()
    pk, pv = hash_slide.hash_slide_plain(cat2.keys, cat2.vals, **hkw)
    torch.cuda.synchronize()
    hash_plain_ms = (time.perf_counter() - t_plain) * 1e3
    # two launches, the same bits: no atomic decides a value or a slot
    check(all(bitwise_equal(torch, tk, pk) and bitwise_equal(torch, tv, pv)
              for tk, tv in runs),
          "hash_slide kernel tables differ from its plain version")
    tk, tv = runs[0]
    del runs
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
        # the kernel has one route (bucketing when parts > 1) and no
        # one-thread loop, so nothing to count
        "kernel_route": "bucketed" if geom2.parts > 1 else "one part",
        "serial_launches": None,
        "bytes": hash_bytes, "geometry": geom2._asdict(),
        "blocks": cat2.keys.shape[0] * geom2.parts,
        "smem_bytes": hash_slide.smem_bytes(geom2.table_size),
        "moved_bytes": hash_slide.moved_bytes(
            cat2.keys.shape[0], cat2.cap, table_size=geom2.table_size,
            parts=geom2.parts),
        "catchup": slide_catchup(torch, hash_slide,
                                 captured.pop("catchup_hash"), args.seed),
        "stream_service_launches":
        phases["stream_service"]["drive1"]["launches"]["hash_slide"],
        "stream_coflush": slide_catchup(
            torch, hash_slide, {"largest": stream_launch}, args.seed,
            what="the stream co-flush's"),
    })
    del stream_launch
    del tk, tv, pk, pv

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
    seg_ms = cuda_ms(torch, lambda: segment.segment_fold(v_s, gid, cat1.cap),
                     20)
    seg_lib_ms = cuda_ms(torch, lambda: seg_acc.index_add_(0, gid_long, v_s),
                         20)
    # the wrapper's zero fill of the output, inside its time (index_add_
    # adds into an output allocated beforehand)
    seg_fill_ms = cuda_ms(torch, lambda: torch.zeros(
        cat1.cap, dtype=v_s.dtype, device=dev), 20)
    seg_split = fold_timing.device_split(
        lambda: segment.segment_fold(v_s, gid, cat1.cap))
    log(f"segment_fold yardstick: kernel call {seg_ms:.4f} ms, of which "
        f"zero fill {seg_fill_ms:.4f} ms; index_add_ {seg_lib_ms:.4f} ms "
        f"(no fill); on the device a call takes {seg_split}")
    # one run of 2^24: a chain of dependent adds; checked bitwise against
    # the plain fold at 2^16 (which loops once per element of a run)
    lrun_v, lrun_g = fold_timing.long_run(1 << 24, args.seed, dev)
    lrun_ms = cuda_ms(torch, lambda: segment.segment_fold(lrun_v, lrun_g, 1),
                      3)
    lrun_got = segment.segment_fold(lrun_v, lrun_g, 1)
    check(bool(torch.isfinite(lrun_got).all()),
          "segment_fold: the 2^24 run's total is not finite")
    short_v, short_g = lrun_v[:1 << 16], lrun_g[:1 << 16]
    short_got = segment.segment_fold(short_v, short_g, 1)
    short_want = segment.segment_fold_plain(short_v, short_g, 1)
    check(bitwise_equal(torch, short_got, short_want),
          "segment_fold kernel differs from its plain version on one run "
          "of 2^16")
    report.append({
        "name": "segment_fold", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/segment_fold.cu",
        "replaces": "src/repro/core/sparse.py:325",
        "launches": launches["segment_fold"],
        "max_abs_err": max(float((got - want).abs().max()),
                           float((short_got - short_want).abs().max())),
        "ms": seg_ms,
        "plain_ms": cuda_ms(torch, lambda: segment.segment_fold_plain(
            v_s, gid, cat1.cap), 3),
        "bound_ms": seg_bound[0],
        "bound_by": seg_bound[1],
        "library_ms": seg_lib_ms,
        "library": "index_add_",
        "zero_fill_ms": seg_fill_ms,
        "device_split": seg_split,
        "bytes": seg_bytes,
        "geometry": segment.fold_geometry(1, v_s.numel())._asdict(),
        "long_run": {
            "elements": lrun_v.numel(), "ms": lrun_ms,
            "chain_bound_ms": fold_timing.chain_bound_ms(lrun_v.numel()),
            "checked_elements": short_v.numel(),
            "max_abs_err": float((short_got - short_want).abs().max())},
    })
    del lrun_v, lrun_g, lrun_got, short_got, short_want

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
        runs = [hash_accum.hash_accumulate_raw(hk_, hv_, sent=sent3)
                for _ in range(2)]
        t_plain = time.perf_counter()
        pk_, pv_ = hash_accum.hash_accumulate_plain(hk_cpu, hv_cpu,
                                                    sent=sent3)
        acc_plain_ms = (time.perf_counter() - t_plain) * 1e3
        # two launches, the same bits: no atomic decides a value or a slot
        check(all(bitwise_equal(torch, a.cpu(), pk_)
                  and bitwise_equal(torch, b.cpu(), pv_) for a, b in runs),
              f"hash_accum kernel table differs from its plain version at "
              f"cap {cap}")
        tk_, tv_ = runs[0]
        del runs
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
            "acc_route": hash_accum.accumulate_route(cap, size_),
            "sym_in_smem": hash_accum.table_in_smem(size_, symbolic=True,
                                                    device=dev),
            "acc_ms": cuda_ms(torch, lambda: hash_accum.hash_accumulate_raw(
                hk_, hv_, sent=sent3), 10),
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
    # the accumulate's one-thread route, kept for tables that can fill: on
    # the first 16,384 elements with a table of as many slots, against the
    # plain version
    under_cap = 16384
    uk, uv = cat3.keys[:under_cap], cat3.vals[:under_cap]
    check(hash_accum.accumulate_route(under_cap, under_cap) == "serial",
          "hash_accum: a table of cap slots should take the one-thread route")
    serial0 = hash_accum.hash_accumulate_raw.serial_launches
    gk_, gv_ = hash_accum.hash_accumulate_raw(uk, uv, sent=sent3,
                                              table_size=under_cap)
    wk_, wv_ = hash_accum.hash_accumulate_plain(uk.cpu(), uv.cpu(),
                                                sent=sent3,
                                                table_size=under_cap)
    check(bitwise_equal(torch, gk_.cpu(), wk_)
          and bitwise_equal(torch, gv_.cpu(), wv_)
          and hash_accum.hash_accumulate_raw.serial_launches == serial0 + 1,
          "hash_accum: the one-thread route differs from its plain version")
    acc_under_ms = cuda_ms(torch, lambda: hash_accum.hash_accumulate_raw(
        uk, uv, sent=sent3, table_size=under_cap), 3)
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
        "table_size": full["table_size"],
        "kernel_route": full["acc_route"],
        "serial_launches": phases["hash_alg"]["accumulate_serial_launches"],
        "scratch_bytes": hash_accum.parallel_scratch_bytes(
            cat3.cap, full["table_size"]),
        "fold_range": hash_accum.fold_range(full["table_size"]),
        "smaller_caps": small,
        "undersized": {"kernel_route": "serial", "cap": under_cap,
                       "table_size": under_cap, "ms": acc_under_ms},
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
        "bytes": sym_bytes, "kernel_route": full["sym_route"],
        "serial_launches": phases["hash_alg"]["symbolic_serial_launches"],
        "table_size": full["table_size"], "in_smem": full["sym_in_smem"],
        "smaller_caps": {c: {k: hash_cases[c][k] for k in (
            "table_size", "sym_route", "sym_ms", "sym_plain_ms")}
            for c in (4096, 16384)},
        "undersized": {"kernel_route": "serial", "table_size": under,
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
        **topk_design(torch, topk_block, embed_x, per_e, block_e,
                      captured["topk_leaves"], dev, args.seed),
    })
    captured["topk_leaves"].clear()
    del got_i, got_v, want_i, want_v

    # xla_add, at the embed leaf's size (a publish's largest pass): its
    # epoch-1 update against a seeded second operand, with subnormals of
    # both signs and pairs whose difference or sum is subnormal planted in
    # a seeded sample of slots
    xrng = np.random.default_rng(args.seed + 17)
    n_x = embed_x.numel()
    xb = torch.from_numpy(xrng.integers(-256, 256, n_x).astype(np.float32)
                          * np.float32(GRID)).to(dev)
    xa = embed_x.clone()
    plant = torch.from_numpy(xrng.choice(n_x, 4096, replace=False)).to(dev)
    pa = np.float32([1e-40, -1e-40, 1.5e-38, -1.4e-38, -0.0, 2.0, 1.4e-38,
                     -3e-39])
    pb = np.float32([1e-40, 0.0, 1.4e-38, -1.5e-38, -1e-40, 1e-40, -1.5e-38,
                     3e-39])
    pick = torch.from_numpy(xrng.integers(0, pa.size, 4096)).to(dev)
    xa[plant] = torch.from_numpy(pa).to(dev)[pick]
    xb[plant] = torch.from_numpy(pb).to(dev)[pick]
    xla_err = 0.0
    for sub in (False, True):
        got = xla_add.xla_add_raw(xa, xb, subtract=sub)
        want = xla_add.xla_add_plain(xa, xb, subtract=sub)
        check(bitwise_equal(torch, got, want),
              f"xla_add kernel differs from its plain version "
              f"(subtract={sub})")
        xla_err = max(xla_err, float((got - want).abs().max()))
    xla_bytes = 12 * n_x
    xla_bound = bound(xla_bytes, n_x)
    report.append({
        "name": "xla_add", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/xla_add.cu",
        "replaces": "src/repro/core/topk.py:95",
        "launches": launches["xla_add"],
        "max_abs_err": xla_err,
        "ms": cuda_ms(torch, lambda: xla_add.xla_add_raw(
            xa, xb, subtract=True), 20),
        "plain_ms": cuda_ms(torch, lambda: xla_add.xla_add_plain(
            xa, xb, subtract=True), 5),
        "bound_ms": xla_bound[0], "bound_by": xla_bound[1],
        # a yardstick only: torch.sub keeps subnormals
        "library_ms": cuda_ms(torch, lambda: torch.sub(xa, xb), 20),
        "library": "torch.sub", "bytes": xla_bytes,
        "elements": n_x, "planted_subnormal_slots": 4096,
    })
    del xa, xb, plant, pick

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
