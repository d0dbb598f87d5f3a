#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's SpKAdd main path once on one CUDA card.

    python3 chip_smoke.py [--seed N]

Run from the root of a checkout; it imports ``src/repro_torch`` (never JAX,
never the reference package ``repro``) and exits non-zero, printing no
result, when no CUDA card is present or the package is missing.

0. Build the eight CUDA kernel libraries from ``src/repro_torch/kernels/csrc``
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
8. ``allreduce`` (:func:`run_allreduce`), over ``torch.distributed``
   with one NCCL rank: one compressed data-parallel step of SmolLM-135M's
   gradient tree (k_fraction 0.01, block selector), less the model. (a)
   World size 1: ``compressed_gradient_mean`` for each schedule equals
   ``densify(u)`` bitwise, mean + new residual equals gradient + residual,
   the vec accumulator equals the scatter, the 2-D mean on a (1, 1) mesh
   equals the 1-D one. (b) P = 8 workers on the card: each schedule's
   local fold of the eight workers' streams in rank 5's ``stream_order``
   (vec and scatter bitwise equal, each equal to a float64 numpy sum to
   1e-5, the 2-way schedules to ``gather_kway`` to 1e-6; the vec fold's
   largest SPA launch replayed through the plain version). (c) One
   ``adamw_update`` with (b)'s mean. The top-k, ``xla_add``, segment-fold
   and SPA kernels must launch.
9. ``spgemm`` (:func:`run_spgemm`): ``spgemm_summa`` on a 1 x 1 mesh at
   4,096^2, then worker (0, 0) of a 16 x 16 grid on 65,536^2 matrices
   (its two 1 GiB stripes, 16 stages, Fig. 6's cap) through every
   reduction algorithm: C tiles equal the stripes' product at rtol 1e-4 /
   atol 1e-5 and (but ``tree``) ``sorted`` bitwise; ``auto``'s partition
   launch and ``hash``'s accumulate replayed through the plain versions;
   the segment-fold, SPA, hash-accumulate and partition kernels must
   launch.
10. ``workload`` (:func:`run_workload`): SmolLM-135M at full width and
   depth (30 layers, d 576, bf16 compute, f32 parameters; training
   batches of 8 x 2,048 tokens, ``train_4k``'s draws cut from 256 x
   4,096) through the port's train and serve entry points on the NCCL
   rank: three dense steps (the loss falls); four compressed steps, each
   published as parameter deltas (each mean ``densify(u)`` bitwise); a
   replica's window-4 catch-up, then 16 decoded tokens with a compressed
   step, a publish and a sync before each (the replica equal to the
   shadow after every sync); decode against prefill; the card's loss
   against the CPU's; the largest launch of each kernel on the path
   replayed through its plain version. The top-k, ``xla_add`` and
   segment-fold kernels must launch, and the catch-up an engine kernel.
11. ``families`` (:func:`run_families`): the MoE, gemma3 local:global
   and VLM decoders, the Mamba2 SSM, the Zamba2 hybrid and the Whisper
   encoder-decoder at full width, depth cut to fit the card
   (:data:`FAMILIES`; parameters drawn on the card, each family once):
   Moonshot-16B-A3B serves at depth 2 and takes one compressed step of
   8 x 2,048 tokens at depth 1; Mamba2-370M (48 layers), Zamba2-2.7B (54
   layers serving, 18 training) and Whisper-medium (24 + 24, on 8 x 1,500
   frame embeddings) take one compressed step of 8 x 2,048 tokens (each
   mean ``densify(u)`` bitwise at P = 1); Llama4-Scout at depth 1,
   gemma3-27B at depth 6 and Qwen2-VL-72B at depth 2 (M-RoPE on
   ``make_batch``'s embeddings) a loss and gradient on 1 x 4,096, all
   finite; each prefills its prompts through ``make_prefill_step``
   (gemma3 at depth 7, 2 x 1,536 tokens, past its window) and decodes 8
   tokens, held to a prefill of prompts plus tokens (``WL_DECODE_TOL``;
   the VLM's decode only finite; the MoE, SSM and hybrid models held in
   f32 compute on the same weights, their bf16 gap reported); each step's
   largest top-k, ``xla_add``, segment-fold and MoE combine launches are
   replayed through the plain versions, and Moonshot's first layer's
   combine (the ``moe_combine`` kernel) is held bitwise to the plain
   ordered fold and to the segment fold's route it replaced, and timed
   beside both and ``index_add_``.
   Mamba2, Zamba2 and Whisper hold the card's loss on 1 x 256 tokens to
   the CPU's at depths 2, 6 and 2 + 2 (``WL_CPU_LOSS_RTOL``); Zamba2 and
   Whisper quantize their first self-attention cache to int8
   (``repro_torch.serve``): codes and scales bitwise to the CPU's, one
   decode token's quantized attention within 5e-2 of the exact.
12. ``sharding`` (:func:`run_sharding`): the FSDP×TP placements of
   ``repro_torch.sharding`` on the same (1, 1) NCCL mesh (world 1: NCCL
   puts no two ranks on one card), under PyTorch's deterministic kernels:
   SmolLM-135M at full width and depth, params and AdamW state placed by
   ``params_shardings``, three dense steps of 8 x 2,048 tokens through the
   DTensor path bitwise to three plain steps (median step and peak memory
   of each); Moonshot-16B-A3B at depth 1 on 1 x 4,096 tokens, the sharded
   step's loss and gradients bitwise to the plain ones (the MoE combine's
   launches counted, the largest replayed); two publishes of
   ``DeltaPublisher(..., mesh=...)`` byte-identical to a publisher's
   without one (top-k and ``xla_add`` counted, the largest replayed); the
   sharded state saved, then restored onto its placements and onto plain
   tensors, bitwise; then this script in a subprocess as rank 0 of the
   16 x 16 production mesh under PyTorch's ``fake`` process group:
   gemma3-27B at full width and depth on one rank's rows of ``train_4k``,
   each layer gathered at use and the blocks on their ``model`` shards,
   its step ms, its peak above resident against the same cell's dry-run
   ``temp_bytes`` (run on the host meanwhile), and its counted FLOPs equal
   to the dry-run's; then (f) the same for Moonshot-16B-A3B at full depth,
   its experts on their ``model`` shards over the rank's block of the
   dispatch buffer's capacity, the combine's kernel launched and its
   largest call replayed bitwise through the plain fold and timed beside
   ``index_add_``; (g) the same for
   Zamba2-2.7B at full depth, its Mamba blocks on their SSM heads and its
   shared block on its heads and ``d_ff`` columns; (h) for Whisper-medium
   at 24 + 24 layers, every attention and MLP on its ``model`` shard.
   (i) The placed serving steps (parameters on the serving layout, the
   caches on the reference's) at world 1 bitwise to the plain ones:
   SmolLM-135M's 8 prompts of 512 and 16 tokens, Moonshot-16B-A3B at
   depth 2 on 4 x 512 and 8 tokens (its combines counted); then as
   rank 0 of the 16 x 16 mesh, each beside its dry-run: (j)
   Qwen2-VL-72B's ``decode_32k`` step over caches split along
   ``head_dim``, (k) Zamba2-2.7B's ``decode_32k`` step over the Mamba
   caches, (l) gemma3-27B's ``prefill_32k`` step, each at full depth with
   its counted FLOPs equal to the dry-run's; (m) Qwen2-VL-72B's
   ``train_4k`` step at full depth under sequence parallelism (``use_sp``,
   beside the dry-run's ``--sp`` cell): the residual stream's 4,096
   positions split over the 16 ``model`` ranks, this rank's 16 x 256, its
   FLOPs equal to the dry-run's, its peak above resident 1.00-1.05 x the
   fake ``temp_bytes``, on one card (the cell without SP needs more).
13. ``tools`` (:func:`run_tools`): on the same mesh, SmolLM-135M's dense
   step under ``launch/hlo_analysis.py``'s ``analyze_step`` on the card
   and on fake tensors of the same shapes (the FLOP counts equal as
   integers; ``model_flops``, the counted FLOPs and their share of
   989e12 x one step's time printed); the bytes resident after placing
   params, AdamW state and the batch equal to ``arg_bytes`` and to
   ``launch/shard_memory.py``'s count (plus AdamW's step and the batch),
   the step's peak above resident beside the fake ``temp_bytes``;
   spkaddlint's trace rules (``repro_torch.analysis``) on CUDA tensors,
   the index dtypes through a proxy over the built libraries, SPKJ204
   against the card's shared memory a block: no active finding; one
   dry-run cell (``python -m repro_torch.launch.dryrun``, a fake world of
   256 ranks on the host) whose record says ``ok``.
14. One profiled call of each phase (device time by kernel, busy share;
   the family's ``tree`` call profiled right after phase 4, its
   segment-fold records equal to its launches), ten profiled calls each
   of the family's ``vec`` and ``blocked_spa``
   (each call's host time and the CUDA runtime calls that took the most
   host time: where a slow call waits), then each of the nine kernels
   against its plain PyTorch version on the card, on the inputs its path
   gives it: bitwise (tolerance 0); the two
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
   ``torch.topk``. Each row also counts its launches in phases 8-13
   (``launches_allreduce``, ``launches_spgemm``, ``launches_workload``,
   ``launches_families``, ``launches_sharding``, ``launches_tools``), and
   the rows fold the replays of phases 8-12's launches (``replay_allreduce``,
   ``replay_spgemm``, ``replay_workload``, ``replay_families``,
   ``replay_sharding``) into their ``max_abs_err``. The MoE combine's row
   checks the kernel at (d)'s shape on bf16 values drawn on the card with
   subnormals, signed zeros, infinities and NaNs of both signs planted,
   its ``launches`` phase ``families``' (the MoE's own path), and carries
   (d)'s and (f)'s timings (``families_d``, ``sharding_f``). Then JSON
   lines of the phases' end-to-end times, the profiles and the kernel numbers (median ms by
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
    ap.add_argument("--sharding-rank0", metavar="OUT_JSON",
                    help=argparse.SUPPRESS)
    ap.add_argument("--rank0-arch", default=SH_TP_ARCH,
                    help=argparse.SUPPRESS)
    ap.add_argument("--rank0-shape", default=SH_TP_SHAPE,
                    help=argparse.SUPPRESS)
    ap.add_argument("--rank0-sp", action="store_true",
                    help=argparse.SUPPRESS)
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
    if args.sharding_rank0:
        sharding_rank0(torch, args.seed, args.sharding_rank0,
                       args.rank0_arch, args.rank0_shape, args.rank0_sp)
        return 0
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


def queued_ms(torch, fn, calls: int = 50, reps: int = 5) -> float:
    """Device ms a call of ``fn``: the median over ``reps`` of ``calls``
    calls queued back to back between two CUDA events, over ``calls``
    (after one warm-up). Where a call's host time is shorter than its
    device time it hides behind the card's work, which :func:`cuda_ms`
    counts."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def queued_times(torch, kernel, bound_ms: float, library=None,
                 calls: int = 50) -> dict:
    """A kernel row's queued times (:func:`queued_ms`): ``queued_ms`` of
    ``kernel``, its ``bound_share_queued`` (``bound_ms`` over it) and, where
    the row has a ``library`` call, ``library_queued_ms``."""
    out = {"queued_ms": queued_ms(torch, kernel, calls)}
    out["bound_share_queued"] = bound_ms / out["queued_ms"]
    if library is not None:
        out["library_queued_ms"] = queued_ms(torch, library, calls)
    return out


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

    from repro_torch.launch.profiler_settle import settle

    calls = []
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        settle()
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
    """One call of ``fn`` under ``torch.profiler``, launched after
    :func:`~repro_torch.launch.profiler_settle.settle` (the profiler loses
    what is launched in its first milliseconds): device time summed by
    kernel name (the ``top`` largest, and under ``"watch"`` the ms and
    launches of the kernels whose names hold each string of ``watch``) and
    the device's busy share of ``wall_ms``, the call's unprofiled median
    host time."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch.profiler_settle import settle

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        settle()
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
    if a.dtype == torch.bfloat16:
        return torch.equal(a.view(torch.int16), b.view(torch.int16))
    return torch.equal(a, b)


def same_coo(torch, a, b) -> bool:
    return (a.shape == b.shape and bitwise_equal(torch, a.keys, b.keys)
            and bitwise_equal(torch, a.nnz, b.nnz)
            and bitwise_equal(torch, a.vals, b.vals))


GRID = 2.0 ** -10  # benchmarks/delta_sync.py's update quantum


def seeded_tree(seq, shapes, draw, pool, to_tensor) -> dict:
    """``shapes`` (a nested dict) filled by ``draw(generator, shape)``
    (numpy), each leaf from its own generator spawned in order from the
    ``SeedSequence`` ``seq``, on the threads of ``pool``; each array goes
    through ``to_tensor``."""
    paths = []

    def walk(node, prefix):
        for name, shape in node.items():
            if isinstance(shape, dict):
                walk(shape, prefix + (name,))
            else:
                paths.append((prefix + (name,), shape))

    walk(shapes, ())
    gens = [np.random.default_rng(s) for s in seq.spawn(len(paths))]
    arrays = pool.map(lambda g, p: draw(g, p[1]), gens, paths)
    out: dict = {}
    for (path, _), a in zip(paths, arrays):
        node = out
        for name in path[:-1]:
            node = node.setdefault(name, {})
        node[path[-1]] = to_tensor(a)
    return out


def grid_tree(torch, seq, shapes, lo, hi, dev, pool):
    """:func:`seeded_tree` of multiples of 2^-10 drawn in ``[lo, hi)``, as
    f32 tensors on ``dev``: the delta-sync benchmark's dyadic grid, on
    which every f32 sum of a few such trees is exact in any order."""
    return seeded_tree(
        seq, shapes, lambda g, shape: g.integers(lo, hi, shape,
                                                 dtype=np.int16), pool,
        lambda a: torch.from_numpy(a).to(dev).to(torch.float32) * GRID)


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
    from repro_torch.launch.profiler_settle import settle
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
                    settle()
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
    from repro_torch.launch.profiler_settle import settle
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
                    settle()
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


def count_launches(torch, kernels: dict, launches: dict, fn):
    """``(fn(), {kernel: launches})``: every launch count is set to 0 just
    before ``fn`` runs and read just after; the counts of the kernels named
    in ``launches`` are added to it."""
    torch.cuda.synchronize()
    for k in kernels.values():
        k.launches = 0
    out = fn()
    torch.cuda.synchronize()
    for name in launches:
        launches[name] += kernels[name].launches
    return out, {k: f.launches for k, f in kernels.items() if f.launches}


class launches_uncounted:
    """A block whose kernel launches (a check or a replay inside a counted
    path) leave every launch count as it was."""

    def __init__(self, kernels: dict):
        self.kernels = kernels

    def __enter__(self):
        self.saved = {k: f.launches for k, f in self.kernels.items()}

    def __exit__(self, *exc):
        for k, f in self.kernels.items():
            f.launches = self.saved[k]
        return False


def keeping_largest(module, name: str, fn):
    """``(fn(), (args, kwargs))``: ``fn`` run with ``module.name`` wrapped
    to keep the inputs of its launch whose first argument has the most
    elements (the path's largest launch, replayed by
    :func:`replay_through_plain`); fails unless it launched."""
    out, kept = keeping_largest_each({name: (module, name)}, fn,
                                     required=(name,))
    return out, kept[name]


def keeping_largest_each(targets: dict, fn, required=()):
    """``(fn(), {label: (args, kwargs)})``: ``fn`` run with each
    ``module.name`` of ``targets`` (``label: (module, name)``) wrapped to
    keep the inputs of its launch whose first argument has the most
    elements. A label whose function was not called has no entry; each
    label of ``required`` must have one. Each kernel's own wrapper is put
    back while it runs (it counts its launches on its module's name), so
    launch counts are unchanged."""
    kept = {}

    def wrapping(label, module, name, kernel):
        def keeping(*a, **kw):
            if label not in kept or a[0].numel() > kept[label][0][0].numel():
                kept[label] = (a, kw)
            setattr(module, name, kernel)
            try:
                return kernel(*a, **kw)
            finally:
                setattr(module, name, keeping)
        return keeping

    originals = {label: getattr(m, n) for label, (m, n) in targets.items()}
    for label, (m, n) in targets.items():
        setattr(m, n, wrapping(label, m, n, originals[label]))
    try:
        out = fn()
    finally:
        for label, (m, n) in targets.items():
            setattr(m, n, originals[label])
    for label in required:
        check(label in kept, f"{label} did not launch on the path")
    return out, kept


def replay_through_plain(torch, raw, plain, call, what: str) -> dict:
    """One kept launch ``call`` (:func:`keeping_largest`) made again through
    the kernel and through its plain version on the same card inputs
    (outside any launch count): fails unless they agree bitwise, and
    returns the shapes and the max |kernel - plain|."""
    args, kw = call
    got, want = raw(*args, **kw), plain(*args, **kw)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    check(len(got) == len(want) and all(
        bitwise_equal(torch, g, w) for g, w in zip(got, want)),
        f"{what}: the kernel differs from its plain version")
    err = max((float((g.double() - w.double()).abs().max())
               for g, w in zip(got, want) if g.numel()), default=0.0)
    return {"what": what, "shapes": [list(a.shape) for a in args
                                     if hasattr(a, "shape")],
            "kwargs": {k: v for k, v in kw.items()
                       if isinstance(v, (int, float, str))},
            "max_abs_err": err}


def normal_tree(torch, seq, shapes, scale, dev, pool, flat=False):
    """:func:`seeded_tree` of f32 standard normals times ``scale``, on
    ``dev``, each leaf flat when ``flat``."""
    def to_tensor(a):
        t = torch.from_numpy(a).to(dev)
        return t.reshape(-1) if flat else t

    return seeded_tree(
        seq, shapes, lambda g, shape: g.standard_normal(
            shape, dtype=np.float32) * np.float32(scale), pool, to_tensor)


#: Data-parallel workers of the allreduce phase's P-worker folds, and its
#: compression (``chip_smoke``'s SmolLM-135M tree; ``final_ln``, 576
#: elements, is under ``MIN_COMPRESS_ELEMS`` and takes the dense mean).
ALLREDUCE_WORKERS, ALLREDUCE_K = 8, 0.01
#: The rank whose streams (b) folds: at rank 5 the three schedules' stream
#: orders all differ (at rank 0 ``tree_2way``'s is ``gather_kway``'s, at
#: rank 3 ``ring_2way``'s is ``tree_2way``'s).
ALLREDUCE_FOLD_RANK = 5
#: ``TrainHParams``' schedule (``src/repro/train/step.py``): AdamW's step
#: runs at the end of the warmup.
ADAMW_SCHEDULE = dict(peak_lr=3e-4, warmup=100, total=10_000)
ADAMW_STEP = 100


def run_allreduce(torch, seed: int, dev, kernels: dict, mesh):
    """Phase ``allreduce``: one compressed data-parallel step of
    SmolLM-135M's gradient tree, less the model.

    (a) World size 1 over NCCL: ``compressed_gradient_mean`` for each
    schedule (k 0.01, the block selector) and ``sparse_allreduce(...,
    accumulator="vec")`` of each compressed leaf; each mean equals
    ``densify(u)`` bitwise, mean + new residual equals gradient + residual
    under XLA's rules, ``final_ln`` takes the dense mean, and
    ``compressed_gradient_mean_2d`` on the (1, 1) ``mesh`` equals the 1-D
    mean. (b) P = 8 workers on the card: eight seeded gradient trees (a
    shared part plus each worker's own), each with its own residual tree,
    through ``sparsify_with_feedback``; each schedule's local fold of the
    streams in rank 5's ``stream_order`` (where the three orders differ;
    the vec fold's largest SPA launch is replayed through the plain
    version): ``scatter`` and ``vec`` bitwise
    equal, every schedule equal to a float64 numpy sum to 1e-5 and the
    2-way schedules to ``gather_kway`` to 1e-6. (c) One ``adamw_update``
    of seeded parameters with (b)'s mean; finite, and two leaves updated
    alone on the card equal the same update on the CPU to the tolerance of
    ``tests/test_torch_optim.py``. Returns the phase's numbers and the
    kernels' launches on its path."""
    from repro_torch import tree as TR
    from repro_torch.core import allreduce as AR
    from repro_torch.core import topk as T
    from repro_torch.kernels import spa_accum, xla_float
    from repro_torch.optim import adamw as OPT

    path_kernels = ("topk_block", "xla_add", "segment_fold", "spa_accum")
    seq = np.random.SeedSequence([seed, 19])
    s_grad, s_res, s_base, s_workers, s_params = seq.spawn(5)
    pool = ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    launches = dict.fromkeys(path_kernels, 0)

    def counted(fn):
        return count_launches(torch, kernels, launches, fn)

    # ---- (a) world size 1 ------------------------------------------------
    grads = normal_tree(torch, s_grad, SMOLLM_135M_SHAPES, 1.0, dev, pool)
    res = normal_tree(torch, s_res, SMOLLM_135M_SHAPES, 0.1, dev, pool,
                      flat=True)
    names = TR.flatten_with_names(grads)[1]
    g_leaves, r_leaves = TR.leaves(grads), TR.leaves(res)
    compressed = [i for i, g in enumerate(g_leaves)
                  if g.numel() >= AR.MIN_COMPRESS_ELEMS]
    check(len(compressed) == len(g_leaves) - 1, "phase allreduce: expected "
          "one leaf under MIN_COMPRESS_ELEMS")
    # each compressed leaf's update and residual, made once
    ups = {}
    for i in compressed:
        n = g_leaves[i].numel()
        ups[i] = T.sparsify_with_feedback(
            g_leaves[i].reshape(-1), r_leaves[i], T.global_k(n, ALLREDUCE_K),
            selector="block")
    kw = dict(k_fraction=ALLREDUCE_K, selector="block")
    world = {}
    for sched in AR.SCHEDULES:
        (mean, new_r), used = counted(lambda: AR.compressed_gradient_mean(
            grads, res, None, schedule=sched, **kw))
        m_leaves, nr_leaves = TR.leaves(mean), TR.leaves(new_r)
        for i, (g, r, m, nr) in enumerate(zip(g_leaves, r_leaves, m_leaves,
                                              nr_leaves)):
            if i not in compressed:
                check(bitwise_equal(torch, m, g) and nr is r,
                      f"phase allreduce: {sched}: the dense leaf "
                      f"{names[i]} is not its own mean at P = 1")
                continue
            u, want_r = ups[i]
            check(bitwise_equal(torch, m.reshape(-1), T.densify(u)),
                  f"phase allreduce: {sched}: {names[i]}'s mean is not "
                  f"densify(u) bitwise")
            check(bitwise_equal(torch, nr, want_r), f"phase allreduce: "
                  f"{sched}: {names[i]}'s new residual differs")
            check(torch.equal(xla_float.add(m.reshape(-1), nr),
                              xla_float.add(g.reshape(-1), r)),
                  f"phase allreduce: {sched}: mean + new residual differs "
                  f"from grad + residual at {names[i]}")
        del mean, new_r, m_leaves, nr_leaves
        world[sched] = {
            "launches": used,
            "ms": cuda_ms(torch, lambda: AR.compressed_gradient_mean(
                grads, res, None, schedule=sched, **kw), 3)}
        log(f"phase allreduce (a) {sched}: {world[sched]['ms']:.2f} ms, "
            f"launches {used}; mean == densify(u) bitwise")
    vecs, vec_used = counted(lambda: [AR.sparse_allreduce(
        ups[i][0], None, "gather_kway", accumulator="vec")
        for i in compressed])
    for i, vec in zip(compressed, vecs):
        check(bitwise_equal(torch, vec, T.densify(ups[i][0])),
              f"phase allreduce: the vec accumulator differs at {names[i]}")
    del vecs
    check(vec_used.get("spa_accum", 0) > 0, "phase allreduce: the vec "
          "accumulator did not launch the SPA kernel")
    world["gather_kway_vec"] = {"launches": vec_used, "ms": cuda_ms(
        torch, lambda: [AR.sparse_allreduce(ups[i][0], None, "gather_kway",
                                            accumulator="vec")
                        for i in compressed], 3)}
    (mean1, res1), _ = counted(lambda: AR.compressed_gradient_mean(
        grads, res, None, **kw))
    (mean2, res2), used_2d = counted(lambda: AR.compressed_gradient_mean_2d(
        grads, res, mesh.get_group("data"), mesh.get_group("model"), **kw))
    world["2d_mesh_1x1"] = {"launches": used_2d}
    check(all(bitwise_equal(torch, a, b) for a, b in zip(
        TR.leaves(mean1) + TR.leaves(res1), TR.leaves(mean2)
        + TR.leaves(res2))), "phase allreduce: the (1, 1) mesh's 2-D mean "
          "differs from the 1-D mean")
    prof_a = device_profile(torch, lambda: AR.compressed_gradient_mean(
        grads, res, None, **kw), world["gather_kway"]["ms"])
    del grads, res, g_leaves, r_leaves, ups, mean1, res1, mean2, res2
    log(f"phase allreduce (a): vec == scatter == densify(u); the (1, 1) "
        f"mesh equals the 1-D mean; launches so far {launches}")

    # ---- (b) P = 8 workers on the card -----------------------------------
    p = ALLREDUCE_WORKERS
    base = normal_tree(torch, s_base, SMOLLM_135M_SHAPES, 1.0, dev, pool)
    b_leaves = TR.leaves(base)
    streams = {i: [] for i in compressed}
    final_ln = []
    draw_s = 0.0
    for s_w in s_workers.spawn(p):
        s_noise, s_r = s_w.spawn(2)
        t0 = time.perf_counter()
        noise = TR.leaves(normal_tree(torch, s_noise, SMOLLM_135M_SHAPES, 0.5,
                                      dev, pool))
        r_w = TR.leaves(normal_tree(torch, s_r, SMOLLM_135M_SHAPES, 0.1, dev,
                                    pool, flat=True))
        grads_w = [b + x for b, x in zip(b_leaves, noise)]
        draw_s += time.perf_counter() - t0
        del noise

        def sparsify_worker():
            return {i: T.sparsify_with_feedback(
                grads_w[i].reshape(-1), r_w[i],
                T.global_k(grads_w[i].numel(), ALLREDUCE_K),
                selector="block")[0] for i in compressed}

        us, sparsify_used = counted(sparsify_worker)
        for i in compressed:
            streams[i].append(us[i])
        final_ln += [g for i, g in enumerate(grads_w) if i not in compressed]
        del grads_w, r_w, us
    sizes = {i: b_leaves[i].numel() for i in compressed}
    del base, b_leaves
    torch.cuda.synchronize()
    peak_b = torch.cuda.max_memory_allocated(dev)

    def fold(sched, acc="scatter"):
        order = AR.stream_order(sched, p, ALLREDUCE_FOLD_RANK)
        out = {}
        for i in compressed:
            us = [streams[i][w] for w in order]
            out[i] = AR.local_fold(torch.stack([u.idx for u in us]),
                                   torch.stack([u.val for u in us]),
                                   sizes[i], acc)
        return out

    # the float64 reference: numpy's bincount of the eight streams
    ref64 = {}
    for i in compressed:
        idx = torch.cat([u.idx for u in streams[i]]).cpu().numpy()
        val = torch.cat([u.val for u in streams[i]]).cpu().numpy()
        keep = idx < sizes[i]
        ref64[i] = np.bincount(idx[keep], weights=val[keep].astype(
            np.float64), minlength=sizes[i]) / p
    variants = [(s, "scatter") for s in AR.SCHEDULES] + [("gather_kway",
                                                          "vec")]
    orders = {sch: AR.stream_order(sch, p, ALLREDUCE_FOLD_RANK)
              for sch in AR.SCHEDULES}
    check(len({tuple(o) for o in orders.values()}) == len(orders),
          f"phase allreduce (b): the schedules' stream orders at rank "
          f"{ALLREDUCE_FOLD_RANK} should all differ: {orders}")
    folds, means, plain_replays = {}, {}, {}
    for sched, acc in variants:
        if acc == "vec":
            # the SPA kernel's largest launch (the embed leaf's fold) is
            # kept and replayed through its plain version below
            (got, spa_call), used = counted(lambda: keeping_largest(
                spa_accum, "spa_accumulate_raw", lambda: fold(sched, acc)))
        else:
            got, used = counted(lambda: fold(sched, acc))
        for i in compressed:
            host = got[i].cpu().numpy()
            check(np.isfinite(host).all() and np.allclose(
                host, ref64[i], rtol=1e-5, atol=1e-5),
                f"phase allreduce (b): {sched}/{acc} differs from the "
                f"float64 sum beyond 1e-5 at {names[i]}")
        label = f"{sched}/{acc}"
        means[label] = got
        folds[label] = {"launches": used,
                        "ms": cuda_ms(torch, lambda: fold(sched, acc), 5)}
        log(f"phase allreduce (b) {label}: {folds[label]['ms']:.3f} ms, "
            f"launches {used}; equal to the float64 sum to 1e-5")
    kway = means["gather_kway/scatter"]
    for i in compressed:
        check(bitwise_equal(torch, kway[i], means["gather_kway/vec"][i]),
              f"phase allreduce (b): vec differs from scatter bitwise at "
              f"{names[i]}")
        for sched in ("tree_2way", "ring_2way"):
            check(torch.allclose(means[f"{sched}/scatter"][i], kway[i],
                                 rtol=1e-6, atol=1e-6),
                  f"phase allreduce (b): {sched} differs from gather_kway "
                  f"beyond 1e-6 at {names[i]}")
    plain_replays["spa_accum"] = replay_through_plain(
        torch, spa_accum.spa_accumulate_raw, spa_accum.spa_accumulate_plain,
        spa_call, "phase allreduce (b): the vec fold's largest SPA launch")
    del spa_call
    log(f"phase allreduce (b): {plain_replays['spa_accum']}")
    stream_len = sum(streams[i][0].idx.numel() for i in compressed)
    modeled = {s: sum(AR.modeled_schedule_bytes(
        s, p, streams[i][0].idx.numel()) for i in compressed)
        for s in AR.SCHEDULES}
    log(f"phase allreduce (b): P = {p}, {stream_len} stream entries a "
        f"worker; modeled bytes a worker {modeled}; vec == scatter bitwise, "
        f"the 2-way schedules equal gather_kway to 1e-6")

    # ---- (c) one AdamW step with (b)'s mean -------------------------------
    params = normal_tree(torch, s_params, SMOLLM_135M_SHAPES, 0.02, dev, pool)
    p_leaves, treedef = TR.flatten(params)
    g_mean = [kway[i].reshape(p_leaves[i].shape) if i in compressed else
              xla_float.flush(torch.stack(final_ln).sum(0) / p)
              for i in range(len(p_leaves))]
    del means, kway, streams, final_ln
    grads_c = TR.unflatten(treedef, g_mean)
    state = OPT.adamw_init(params)._replace(step=torch.tensor(
        ADAMW_STEP, dtype=torch.int32, device=dev))

    def adamw_step(p_tree, g_tree, st):
        lr = OPT.cosine_schedule(st.step, **ADAMW_SCHEDULE)
        return OPT.adamw_update(p_tree, g_tree, st, lr=lr)

    new_p, new_s, gnorm = adamw_step(params, grads_c, state)
    torch.cuda.synchronize()
    check(all(bool(torch.isfinite(x).all()) for x in TR.leaves(new_p)
              + TR.leaves(new_s.mu) + TR.leaves(new_s.nu))
          and bool(torch.isfinite(gnorm)), "phase allreduce (c): AdamW "
          "gave a non-finite value")
    check(not all(torch.equal(a, b) for a, b in zip(TR.leaves(new_p),
                                                    p_leaves)),
          "phase allreduce (c): AdamW moved no parameter")
    adamw_ms = cuda_ms(torch, lambda: adamw_step(params, grads_c, state), 3)
    # two leaves (a 1-D one, undecayed, and a 3-D one) updated alone, on
    # the card and on the CPU: the tolerance of tests/test_torch_optim.py
    # (the sums' order and the last bit of pow and sqrt)
    pick = {"final_ln": params["final_ln"], "wk": params["layers"]["wk"]}
    pick_g = {"final_ln": grads_c["final_ln"],
              "wk": grads_c["layers"]["wk"]}
    sub_card = adamw_step(pick, pick_g, OPT.adamw_init(pick)._replace(
        step=state.step))
    cpu = torch.device("cpu")
    pick_cpu = TR.tree_map(lambda x: x.to(cpu), pick)
    sub_cpu = adamw_step(pick_cpu, TR.tree_map(lambda x: x.to(cpu), pick_g),
                         OPT.adamw_init(pick_cpu)._replace(
                             step=state.step.cpu()))
    adamw_err = 0.0
    for a, b in zip(TR.leaves(sub_card[0]) + TR.leaves(sub_card[1].mu)
                    + TR.leaves(sub_card[1].nu),
                    TR.leaves(sub_cpu[0]) + TR.leaves(sub_cpu[1].mu)
                    + TR.leaves(sub_cpu[1].nu)):
        scale = float(b.abs().max()) or 1.0
        err = float((a.cpu() - b).abs().max()) / scale
        adamw_err = max(adamw_err, err)
    check(adamw_err <= 1e-6, f"phase allreduce (c): card and CPU AdamW "
          f"differ by {adamw_err:.3g} of a leaf's scale (limit 1e-6)")
    log(f"phase allreduce (c): adamw_update {adamw_ms:.2f} ms, global norm "
        f"{float(gnorm):.4f}, card vs CPU on two leaves {adamw_err:.3g} of "
        f"the leaf's scale")
    del params, p_leaves, grads_c, new_p, new_s, state
    pool.shutdown()
    for name in path_kernels:
        check(launches[name] > 0, f"phase allreduce: the {name} kernel did "
              f"not launch")
    phase = {
        "model": "smollm-135m", "params": sum(sizes.values()) + 576,
        "k_fraction": ALLREDUCE_K, "selector": "block",
        "compressed_leaves": len(compressed),
        "world_size_1": world, "workers": p, "folds": folds,
        "sparsify_launches_per_worker": sparsify_used,
        "worker_draw_s": draw_s,
        "stream_entries_per_worker": stream_len,
        "modeled_bytes_per_worker": modeled,
        "adamw_ms": adamw_ms, "adamw_card_vs_cpu": adamw_err,
        "gnorm": float(gnorm), "launches": launches,
        "fold_rank": ALLREDUCE_FOLD_RANK, "stream_orders": orders,
        "plain_replays": plain_replays,
        "peak_mem_bytes": max(peak_b, torch.cuda.max_memory_allocated(dev))}
    return phase, prof_a


def er_stripe(rng, rows: int, cols: int, per_col: int, keep_rows: int):
    """The entries of rows ``[0, keep_rows)`` of an ``rows × cols``
    Erdős–Rényi matrix with ``per_col`` draws a column (rows with
    replacement, standard normal values, column by column): ``(rows,
    cols, vals)`` as numpy arrays."""
    r = rng.integers(0, rows, size=(cols, per_col), dtype=np.int64)
    v = rng.standard_normal((cols, per_col), dtype=np.float32)
    c = np.repeat(np.arange(cols, dtype=np.int64), per_col).reshape(cols,
                                                                    per_col)
    keep = r < keep_rows
    return r[keep], c[keep], v[keep]


def dense_from(torch, shape, rows, cols, vals, dev):
    """Dense f32 on ``dev`` with ``vals`` added at ``(rows, cols)``
    (repeated draws add)."""
    out = torch.zeros(shape, dtype=torch.float32, device=dev)
    idx = (torch.from_numpy(rows).to(dev), torch.from_numpy(cols).to(dev))
    return out.index_put_(idx, torch.from_numpy(vals).to(dev),
                          accumulate=True)


#: Phase ``spgemm``'s sizes: (a) the entry point at 4,096; (b) one worker
#: of the 16 x 16 grid ``examples/distributed_spgemm.py`` names, on
#: 65,536 x 65,536 matrices with 64 draws a column, Fig. 6's partial cap.
SPGEMM_A_N, SPGEMM_B_N, SPGEMM_GRID, SPGEMM_PER_COL = 4096, 65536, 16, 64
SPGEMM_ALGORITHMS = ("incremental", "tree", "sorted", "spa", "vec",
                     "blocked_spa", "hash", "auto")


def run_spgemm(torch, seed: int, dev, kernels: dict, mesh):
    """Phase ``spgemm``: the sparse SUMMA (graph squaring, the step Fig. 6
    speeds up).

    (a) ``spgemm_summa`` on the 1 x 1 NCCL ``mesh``, M = K = N = 4,096 with
    64 draws a column: C equal to ``torch.matmul`` (full f32) at the
    reference's tolerance (rtol 1e-4, atol 1e-5). (b) Worker (0, 0) of a
    16 x 16 grid: its A stripe (4,096 x 65,536) and B stripe (65,536 x
    4,096) of 65,536 x 65,536 matrices; ``summa_block`` with 16 stages and
    Fig. 6's cap (10 % of the 4,096 x 4,096 tile) for each algorithm: no
    partial reaches its cap, each C tile equals the stripes' product at the
    reference's tolerance, and every algorithm but ``tree`` (pairwise)
    equals ``sorted`` bitwise; ``auto``'s largest partition launch and
    ``hash``'s largest accumulate are replayed through their plain
    versions. Returns the phase's numbers, the kernels' launches on its
    path and one profiled reduction."""
    from repro_torch.core import engine as E
    from repro_torch.core import spgemm as G
    from repro_torch.kernels import hash_accum, partition

    path_kernels = ("segment_fold", "spa_accum", "hash_accum", "partition")
    launches = dict.fromkeys(path_kernels, 0)

    def counted(fn):
        return count_launches(torch, kernels, launches, fn)
    rng_a, rng_b, rng_c, rng_d = (np.random.default_rng(s) for s in
                                  np.random.SeedSequence([seed, 6]).spawn(4))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    tol = dict(rtol=1e-4, atol=1e-5)

    # ---- (a) the entry point on a 1 x 1 mesh ------------------------------
    n = SPGEMM_A_N
    a = dense_from(torch, (n, n), *er_stripe(rng_a, n, n, SPGEMM_PER_COL, n),
                   dev)
    b = dense_from(torch, (n, n), *er_stripe(rng_b, n, n, SPGEMM_PER_COL, n),
                   dev)
    c, used_a = counted(lambda: G.spgemm_summa(a, b, mesh, algorithm="auto"))
    want = G.spgemm_reference(a, b)
    check(bool(torch.isfinite(c).all()) and torch.allclose(c, want, **tol),
          "phase spgemm (a): C differs from torch.matmul beyond rtol 1e-4, "
          "atol 1e-5")
    entry = {"n": n, "per_col": SPGEMM_PER_COL, "launches": used_a,
             "c_nnz": int((c != 0).sum()),
             "max_abs_err": float((c - want).abs().max()),
             "ms": cuda_ms(torch, lambda: G.spgemm_summa(
                 a, b, mesh, algorithm="auto"), 3),
             "matmul_ms": cuda_ms(torch, lambda: G.spgemm_reference(a, b),
                                  3)}
    log(f"phase spgemm (a): spgemm_summa on a 1 x 1 mesh, {n}^2, "
        f"{entry['ms']:.2f} ms, C nnz {entry['c_nnz']}, max|err| "
        f"{entry['max_abs_err']:.3g}, launches {used_a}")
    del a, b, c, want

    # ---- (b) worker (0, 0) of a 16 x 16 grid ------------------------------
    big, grid = SPGEMM_B_N, SPGEMM_GRID
    tile = big // grid
    cap = int(tile * tile * 0.1)  # Fig. 6's rule: 10 % of the tile
    a_stripe = dense_from(torch, (tile, big), *er_stripe(
        rng_c, big, big, SPGEMM_PER_COL, tile), dev)
    # B's column stripe: the first ``tile`` columns, every row
    rows, cols, vals = er_stripe(rng_d, big, tile, SPGEMM_PER_COL, big)
    b_stripe = dense_from(torch, (big, tile), rows, cols, vals, dev)
    del rows, cols, vals
    want = G.spgemm_reference(a_stripe, b_stripe)
    partials = G.summa_partials(a_stripe, b_stripe, grid, cap)
    part_nnz = [int(p.nnz) for p in partials]
    check(max(part_nnz) < cap, f"phase spgemm (b): a partial reached its "
          f"cap {cap} ({max(part_nnz)} nonzeros)")
    sig, dispatch = E.explain_dispatch(partials)
    partials_ms = cuda_ms(torch, lambda: G.summa_partials(
        a_stripe, b_stripe, grid, cap), 3)
    # the launches kept for a replay through the plain version: auto's
    # partition launch and hash's accumulate
    keep = {"auto": (partition, "partitioned_accumulate_raw"),
            "hash": (hash_accum, "hash_accumulate_raw")}
    kept = {}
    algs, tiles = {}, {}
    for alg in SPGEMM_ALGORITHMS:
        def body():
            return G.summa_block(a_stripe, b_stripe, grid, algorithm=alg,
                                 partial_cap_per_stage=cap)

        t0 = time.perf_counter()
        if alg in keep:
            (c, kept[alg]), used = counted(lambda: keeping_largest(
                *keep[alg], body))
        else:
            c, used = counted(body)
        body_ms = (time.perf_counter() - t0) * 1e3
        check(bool(torch.isfinite(c).all()) and torch.allclose(c, want,
                                                              **tol),
              f"phase spgemm (b): {alg}'s C tile differs from the stripes' "
              f"product beyond rtol 1e-4, atol 1e-5")
        if alg != "tree":
            tiles[alg] = c
        reduce_ms = cuda_ms(torch, lambda: E.spkadd_run(
            partials, algorithm=alg).to_dense(), 3)
        algs[alg] = {"launches": used, "checked_body_ms": body_ms,
                     "reduce_ms": reduce_ms,
                     "reduce_share": reduce_ms / (reduce_ms + partials_ms),
                     "max_abs_err": float((c - want).abs().max())}
        log(f"phase spgemm (b) {alg}: reduction {reduce_ms:.2f} ms "
            f"({algs[alg]['reduce_share']:.0%} of the worker), launches "
            f"{used}")
        del c
    for alg, c in tiles.items():
        check(bitwise_equal(torch, c, tiles["sorted"]), f"phase spgemm (b): "
              f"{alg}'s C tile differs bitwise from sorted's")
    check(launches["spa_accum"] > 0 and launches["hash_accum"] > 0
          and launches["partition"] > 0 and launches["segment_fold"] > 0,
          f"phase spgemm: a kernel of its path did not launch: {launches}")
    plain_replays = {
        "partition": replay_through_plain(
            torch, partition.partitioned_accumulate_raw,
            partition.partitioned_accumulate_plain, kept.pop("auto"),
            "phase spgemm (b): auto's partition launch"),
        "hash_accum": replay_through_plain(
            torch, hash_accum.hash_accumulate_raw,
            hash_accum.hash_accumulate_plain, kept.pop("hash"),
            "phase spgemm (b): hash's accumulate launch")}
    log(f"phase spgemm (b): {plain_replays}")
    prof = device_profile(torch, lambda: E.spkadd_run(
        partials, algorithm="auto").to_dense(), algs["auto"]["reduce_ms"])
    worker = {"grid": grid, "n": big, "tile": tile, "stages": grid,
              "cap": cap, "a_stripe_nnz": int((a_stripe != 0).sum()),
              "b_stripe_nnz": int((b_stripe != 0).sum()),
              "partial_nnz": part_nnz, "dispatch": dispatch,
              "signals": sig._asdict(), "partials_ms": partials_ms,
              "matmul_ms": cuda_ms(torch, lambda: G.spgemm_reference(
                  a_stripe, b_stripe), 3),
              "algorithms": algs}
    log(f"phase spgemm (b): worker (0, 0) of {grid} x {grid}, partial nnz "
        f"{min(part_nnz)}-{max(part_nnz)} (cap {cap}), dispatch {dispatch}, "
        f"partials {partials_ms:.2f} ms; every algorithm but tree == "
        f"sorted bitwise")
    del a_stripe, b_stripe, want, partials, tiles
    phase = {"entry_point": entry, "worker": worker, "launches": launches,
             "plain_replays": plain_replays,
             "peak_mem_bytes": torch.cuda.max_memory_allocated(dev)}
    return phase, prof


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
            "queued_ms": queued_ms(
                torch, lambda: partition.partitioned_accumulate_raw(
                    keys, vals, cid, pid, **kw), 20),
            "index_add_ms": cuda_ms(torch, lambda: acc.index_add_(
                0, idx, flat_vals), 20),
            "index_add_queued_ms": queued_ms(
                torch, lambda: acc.index_add_(0, idx, flat_vals), 20),
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
    valid_mask = keys < kw["mn"]
    valid = int(valid_mask.sum())
    library = {"index_add_queued_ms": None}
    if B * kw["mn"] <= SLIDE_LIBRARY_MAX_SLOTS:
        # index_add_ of the valid elements into a dense zero (B, mn)
        # buffer made outside the timing: the same sums, another layout
        acc = torch.zeros(B * kw["mn"], device=keys.device)
        idx = (keys.long() + torch.arange(B, device=keys.device)
               .unsqueeze(1) * kw["mn"])[valid_mask]
        flat_vals = vals[valid_mask]
        library["index_add_queued_ms"] = queued_ms(
            torch, lambda: acc.index_add_(0, idx, flat_vals), 10)
        del acc, idx, flat_vals
    return {"B": B, "cap": cap, "valid": valid, "parts": parts,
            "table_size": T, "blocks": B * parts, "sampled_parts": picks,
            "ms": cuda_ms(torch, lambda: hash_slide.hash_slide_raw(
                keys, vals, **kw), 5),
            "queued_ms": queued_ms(torch, lambda: hash_slide.hash_slide_raw(
                keys, vals, **kw), 10),
            **library,
            "bound_ms": bound(nbytes, valid)[0], "bytes": nbytes,
            "moved_bytes": hash_slide.moved_bytes(B, cap, table_size=T,
                                                  parts=parts),
            "buckets": caught.get("buckets")}


#: Dense slots (f32) up to which :func:`slide_catchup` times
#: ``index_add_`` into a zero (B, m n) buffer beside the kernel (4 GiB).
SLIDE_LIBRARY_MAX_SLOTS = 1 << 30


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


#: Phase ``workload``: SmolLM-135M (``src/repro_torch/configs/smollm_135m.py``,
#: HF HuggingFaceTB/SmolLM-135M) at full width and depth on one NCCL rank.
#: Training batches are ``train_4k``'s draws cut from 256 x 4,096 to one
#: card's 8 x 2,048; the replica serves 8 prompts of 512 tokens.
WL_ARCH = "smollm_135m"
WL_TRAIN_BATCH = (8, 2048)
WL_PROMPTS = (8, 512)
WL_NEW_TOKENS = 16
WL_K = 0.01
WL_DENSE_STEPS, WL_COMPRESSED_STEPS = 3, 4
WL_CONSISTENCY_TOKENS = 8
WL_CPU_BATCH = (1, 256)
#: Decode against prefill in bf16 compute: the last decode logits within
#: this share of the prefill logits' largest magnitude. Each product
#: rounds its output to bf16 (8 bits), and a one-token product sums its
#: terms in another order than a 520-token one, so the 30 layers' residual
#: stream drifts by a few bf16 ulps (1.9 % on the CPU, PyTorch 2.13, 2
#: prompts of 64 tokens).
WL_DECODE_TOL = 0.05
#: The card's loss against the CPU's on the same parameters and tokens,
#: bf16 compute: the CPU tests' bound for bf16 against the reference.
WL_CPU_LOSS_RTOL = 2e-3
#: A replica whose catch-up folded an index that two epochs of the window
#: both carry rounds that sum once where the shadow rounded twice: then it
#: is held to the shadow at this tolerance (a few f32 ulps of a
#: parameter), and to the initial parameters plus the engine's ``sorted``
#: fold of the same frames bitwise.
WL_FOLD_RTOL, WL_FOLD_ATOL = 1e-6, 1e-7


def check_means_at_p1(torch, names, calls, k_fraction: float,
                      what: str) -> int:
    """A compressed step's means at P = 1, each call ``(grads, residuals,
    (mean, new residuals))`` as the step made it: each compressed leaf's
    mean is ``densify(u)`` of its EF sparsify bitwise, and mean + new
    residual equals gradient + residual; a leaf under
    ``MIN_COMPRESS_ELEMS`` is its own mean. Returns how many such dense
    leaves there were."""
    from repro_torch import tree as TR
    from repro_torch.core import topk as T
    from repro_torch.kernels import xla_float
    from repro_torch.train import step as ST

    n_dense_leaves = 0
    for grads, res, (mean, new_r) in calls:
        for name, g, r, m, nr in zip(names, TR.leaves(grads),
                                     TR.leaves(res), TR.leaves(mean),
                                     TR.leaves(new_r)):
            if g.numel() < ST.MIN_COMPRESS_ELEMS:
                n_dense_leaves += 1
                check(bitwise_equal(torch, m, g) and nr is r,
                      f"{what}: the dense leaf {name} is not its own mean "
                      f"at P = 1")
                continue
            u, want_r = T.sparsify_with_feedback(
                g.reshape(-1), r, T.global_k(g.numel(), k_fraction),
                selector="block")
            check(bitwise_equal(torch, m.reshape(-1), T.densify(u))
                  and bitwise_equal(torch, nr, want_r),
                  f"{what}: {name}'s mean is not densify(u)")
            check(torch.equal(xla_float.add(m.reshape(-1), nr),
                              xla_float.add(g.reshape(-1), r)),
                  f"{what}: mean + new residual differs from grad + "
                  f"residual at {name}")
    return n_dense_leaves


def run_workload(torch, seed: int, dev, kernels: dict):
    """Phase ``workload``: the dense decoder trained with the paper's
    compressed gradients and served with live parameter deltas, through
    the port's entry points (``repro_torch.models``, ``data``, ``train``,
    ``runtime``; the path of ``launch/train.py --compress --publish-deltas``
    and ``launch/serve.py --sync-spool``), at SmolLM-135M's full width
    and depth, on the default NCCL group of one rank.

    (a) Three ``make_train_step`` steps on one repeated batch (peak lr
    3e-3, no warmup or decay, as ``test_loss_decreases``): the loss falls.
    Four ``make_compressed_train_step`` steps (k 0.01, the block selector,
    ``gather_kway``), each followed by ``DeltaPublisher.publish`` (k 0.01,
    block selector) into a spool directory: at P = 1 each compressed
    leaf's mean is ``densify(u)`` bitwise and mean + new residual equals
    gradient + residual. (b) A replica (``DeltaSubscriber`` on the spool)
    built from the initial parameters prefills 8 prompts of 512 tokens;
    its first sync is a window-4 catch-up (one ragged SpKAdd); then 16
    tokens are decoded, the trainer taking a compressed step and
    publishing, and the replica syncing that epoch, before each. After
    every sync the replica equals the publisher's shadow bitwise, unless
    the catch-up folded an index two epochs carried (then within
    ``WL_FOLD_*``); the catch-up equals the initial parameters plus the
    engine's ``sorted`` fold of its frames bitwise. (c) Greedy decode of 8
    tokens against a prefill of the prompts plus those tokens
    (``WL_DECODE_TOL``). (d) One loss on 1 x 256 tokens on the card and on
    the CPU (``WL_CPU_LOSS_RTOL``). (e) The largest launch of the top-k,
    ``xla_add`` and segment-fold kernels of (a) and of each engine kernel
    of the catch-up, replayed through the plain versions. Returns the
    phase's numbers (launches on its path, the replays) and two profiles
    (one compressed step, one decode token)."""
    import tempfile

    from repro_torch import tree as TR
    from repro_torch.configs import get_config
    from repro_torch.core import engine as E
    from repro_torch.core import sparse as S
    from repro_torch.data import make_batch
    from repro_torch.kernels import hash_slide, ops as kops, partition
    from repro_torch.kernels import segment, spa_accum, topk_block, xla_add
    from repro_torch.models import build_model
    from repro_torch.models.common import SHAPES
    from repro_torch.models.layers import use_full_precision
    from repro_torch.optim import adamw_init
    from repro_torch.runtime import (DeltaPublisher, DeltaSubscriber,
                                     DirTransport, apply_delta_flat,
                                     decode_frame, frame_to_coo)
    from repro_torch.train import (TrainHParams, make_compressed_train_step,
                                   make_decode_step, make_train_step,
                                   rank_ef_state)
    from repro_torch.train import step as ST

    use_full_precision()
    launches = dict.fromkeys(("topk_block", "xla_add", "segment_fold",
                              "partition", "hash_slide", "spa_accum"), 0)

    def counted(fn):
        return count_launches(torch, kernels, launches, fn)

    def sync_ms(t0: float) -> float:
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    cfg = get_config(WL_ARCH)
    model = build_model(cfg)
    t0 = time.perf_counter()
    params0 = model.init(seed, device=dev)
    init_ms = sync_ms(t0)
    check(TR.tree_map(lambda x: tuple(x.shape), params0)
          == SMOLLM_135M_SHAPES, "phase workload: the port model's init "
          "shapes differ from SMOLLM_135M_SHAPES")
    n_params = sum(x.numel() for x in TR.leaves(params0))
    names = TR.flatten_with_names(params0)[1]
    B, S_len = WL_TRAIN_BATCH

    def batch(step):
        return make_batch(cfg, SHAPES["train_4k"], step, batch_override=B,
                          seq_override=S_len, device=dev)

    # ---- (a) train ------------------------------------------------------
    dense = make_train_step(model, TrainHParams(
        peak_lr=3e-3, warmup=0, total_steps=100, weight_decay=0.0))
    b0 = batch(0)
    dense_losses, dense_ms = [], []

    def dense_steps():
        p, o = params0, adamw_init(params0)
        for _ in range(WL_DENSE_STEPS):
            t = time.perf_counter()
            p, o, met = dense(p, o, b0)
            dense_losses.append(float(met["loss"]))
            dense_ms.append(sync_ms(t))

    _, dense_used = counted(dense_steps)
    check(all(np.isfinite(dense_losses))
          and dense_losses[-1] < dense_losses[0],
          f"phase workload (a): the dense loss did not fall: {dense_losses}")
    log(f"phase workload (a): dense steps {[round(t, 1) for t in dense_ms]} "
        f"ms, loss {[round(x, 4) for x in dense_losses]}")

    # the compressed mean, timed by CUDA events inside the step; during (a)
    # its inputs and outputs are kept for the P = 1 checks
    real_mean = ST.compressed_gradient_mean
    mean_log = {"keep": True, "calls": [], "ms": []}

    def timed_mean(grads, residuals, *a, **kw):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        out = real_mean(grads, residuals, *a, **kw)
        ev[1].record()
        mean_log["ms"].append(ev)
        if mean_log["keep"]:
            mean_log["calls"].append((grads, residuals, out))
        return out

    comp = make_compressed_train_step(
        model, None, TrainHParams(warmup=0, total_steps=100),
        k_fraction=WL_K, selector="block", schedule="gather_kway")
    spool_dir = tempfile.TemporaryDirectory(prefix="workload_spool_")
    pub = DeltaPublisher(params0, DirTransport(spool_dir.name),
                         k_fraction=WL_K, selector="block", device=dev)
    state = {"p": params0, "o": adamw_init(params0),
             "ef": rank_ef_state(params0), "step": 0}
    comp_ms, comp_losses, publish_ms, wire = [], [], [], []

    def train_and_publish():
        b = batch(1 + state["step"])
        t = time.perf_counter()
        p, o, ef, met = comp(state["p"], state["o"], state["ef"], b)
        comp_losses.append(float(met["loss"]))
        comp_ms.append(sync_ms(t))
        t = time.perf_counter()
        stats = pub.publish(p)
        publish_ms.append(sync_ms(t))
        wire.append(stats.bytes)
        state.update(p=p, o=o, ef=ef, step=state["step"] + 1)

    ST.compressed_gradient_mean = timed_mean
    try:
        (_, kept_a), used_a = counted(lambda: keeping_largest_each(
            {"topk_block": (topk_block, "topk_block_raw"),
             "xla_add": (xla_add, "xla_add_raw"),
             "segment_fold": (E, "segment_fold")},
            lambda: [train_and_publish()
                     for _ in range(WL_COMPRESSED_STEPS)],
            required=("topk_block", "xla_add", "segment_fold")))
        mean_log["keep"] = False
        n_dense_leaves = check_means_at_p1(torch, names, mean_log["calls"],
                                           WL_K, "phase workload (a)")
        check(n_dense_leaves == WL_COMPRESSED_STEPS, "phase workload (a): "
              "expected one leaf (final_ln) under MIN_COMPRESS_ELEMS")
        del mean_log["calls"][:]
        mean_ms = [a.elapsed_time(b) for a, b in mean_log["ms"]]
        log(f"phase workload (a): compressed steps "
            f"{[round(t, 1) for t in comp_ms]} ms (the mean "
            f"{[round(t, 1) for t in mean_ms]}), publish "
            f"{[round(t, 1) for t in publish_ms]} ms, loss "
            f"{[round(x, 4) for x in comp_losses]}; launches {used_a}; "
            f"mean == densify(u) bitwise")

        # ---- (b) serve: prefill, catch-up, then a sync before each token
        toks = torch.randint(0, cfg.vocab, WL_PROMPTS, generator=torch
                             .Generator().manual_seed(seed + 1),
                             dtype=torch.int32).to(dev)
        P_B, P_S = WL_PROMPTS
        sub = DeltaSubscriber(params0, DirTransport(spool_dir.name),
                              max_staleness=4, device=dev)
        t = time.perf_counter()
        logits, caches = model.prefill(params0, toks,
                                       max_len=P_S + WL_NEW_TOKENS,
                                       attn_chunk=32)
        prefill_ms = sync_ms(t)

        def same_as_shadow():
            shadow = TR.leaves(pub.shadow_params())
            got = TR.leaves(sub.params)
            bitwise = all(bitwise_equal(torch, a, b)
                          for a, b in zip(got, shadow))
            close = bitwise or all(torch.allclose(
                a, b, rtol=WL_FOLD_RTOL, atol=WL_FOLD_ATOL)
                for a, b in zip(got, shadow))
            err = max(float((a - b).abs().max())
                      for a, b in zip(got, shadow))
            return bitwise, close, err

        def catch_up():
            t = time.perf_counter()
            report = sub.sync()
            return report, sync_ms(t)

        ((report, catchup_ms), caught), catchup_used = counted(
            lambda: keeping_largest_each(
                {"partition": (partition, "partitioned_accumulate_raw"),
                 "hash_slide": (kops, "hash_slide_tables"),
                 "spa_accum": (spa_accum, "spa_accumulate_raw"),
                 "segment_fold": (E, "segment_fold"),
                 "segment_fold/sparse": (S, "segment_fold")}, catch_up))
        check(report.window == WL_COMPRESSED_STEPS
              and sub.applied_epoch == WL_COMPRESSED_STEPS,
              f"phase workload (b): the catch-up: {report}")
        check(sum(catchup_used.get(k, 0) for k in
                  ("partition", "hash_slide", "spa_accum")) > 0,
              f"phase workload (b): the catch-up launched no engine kernel: "
              f"{catchup_used}")
        # the catch-up against the engine's sorted fold of its frames, and
        # the count of indices that two epochs of the window both carry
        frames = {e: {f.shard: f for f in map(decode_frame,
                                              pub.frames_for(e))}
                  for e in range(1, WL_COMPRESSED_STEPS + 1)}
        repeats = 0
        for name, leaf0, got in zip(names, TR.leaves(params0),
                                    TR.leaves(sub.params)):
            fs = [frames[e][name] for e in sorted(frames)]
            idx = np.concatenate([f.idx for f in fs])
            repeats += idx.size - np.unique(idx).size
            s = E.spkadd_run([frame_to_coo(f, dev) for f in fs],
                             algorithm="sorted")
            check(bitwise_equal(torch, got.reshape(-1), apply_delta_flat(
                leaf0.reshape(-1), s.keys, s.vals)), f"phase workload (b): "
                f"the catch-up differs from the sorted fold at {name}")
        del frames
        bitwise, close, catchup_err = same_as_shadow()
        check(bitwise if repeats == 0 else close, f"phase workload (b): the "
              f"catch-up differs from the shadow by {catchup_err} with "
              f"{repeats} repeated indices")
        log(f"phase workload (b): prefill {P_B}x{P_S} {prefill_ms:.1f} ms; "
            f"catch-up (window {report.window}) {catchup_ms:.1f} ms, "
            f"launches {catchup_used}, {repeats} repeated indices, "
            f"== shadow bitwise: {bitwise} (max |diff| {catchup_err})")

        decode = make_decode_step(model, attn_chunk=128)
        tok = torch.argmax(logits, -1)
        token_ms, decode_ms, per_sync = [], [], []
        serve = {"params": sub.params, "caches": caches, "tok": tok}

        def serve_tokens():
            for _ in range(WL_NEW_TOKENS):
                train_and_publish()
                t = time.perf_counter()
                report = sub.sync()
                check(report.window == 1 and sub.applied_epoch == pub.epoch,
                      f"phase workload (b): a per-token sync: {report}")
                serve["params"] = sub.params  # hot-swap between tokens
                t_dec = time.perf_counter()
                logits, serve["caches"] = decode(serve["params"],
                                                 serve["caches"],
                                                 serve["tok"])
                serve["tok"] = torch.argmax(logits, -1)
                decode_ms.append(sync_ms(t_dec))
                token_ms.append(sync_ms(t))
                per_sync.append(same_as_shadow())
                check(per_sync[-1][0] if bitwise else per_sync[-1][1],
                      f"phase workload (b): the replica differs from the "
                      f"shadow at epoch {pub.epoch}")

        _, serve_used = counted(serve_tokens)
        log(f"phase workload (b): {WL_NEW_TOKENS} tokens, token ms (sync + "
            f"decode) {[round(x, 1) for x in token_ms]}, decode ms "
            f"{[round(x, 1) for x in decode_ms]}; launches {serve_used}")
        mean_ms = [a.elapsed_time(b) for a, b in mean_log["ms"]]
    finally:
        ST.compressed_gradient_mean = real_mean
        spool_dir.cleanup()
    decode_med = statistics.median(decode_ms)
    prof_decode = device_profile(torch, lambda: decode(
        serve["params"], serve["caches"], serve["tok"]), decode_med)
    step_b = batch(1 + state["step"])
    prof_step = device_profile(torch, lambda: comp(
        state["p"], state["o"], state["ef"], step_b),
        statistics.median(comp_ms))
    del step_b

    # ---- (c) decode against prefill, no sync ------------------------------
    params_c = sub.params
    with torch.no_grad():
        lg, cc = model.prefill(params_c, toks,
                               max_len=P_S + WL_CONSISTENCY_TOKENS,
                               attn_chunk=32)
        tok, fed = torch.argmax(lg, -1), []
        for _ in range(WL_CONSISTENCY_TOKENS):
            fed.append(tok)
            lg, cc = decode(params_c, cc, tok)
            tok = torch.argmax(lg, -1)
        full = torch.cat([toks, torch.stack(fed, 1).to(torch.int32)], 1)
        lp, _ = model.prefill(params_c, full, attn_chunk=32)
    gap = float((lp - lg).abs().max())
    scale = float(lp.abs().max())
    argmax_agree = float((lp.argmax(-1) == lg.argmax(-1)).float().mean())
    check(bool(torch.isfinite(lg).all()) and gap <= WL_DECODE_TOL * scale,
          f"phase workload (c): decode differs from prefill by {gap} "
          f"(largest logit {scale}, limit {WL_DECODE_TOL} of it)")
    del cc, lg, lp, full

    # ---- (d) the card against the CPU --------------------------------------
    cpu = torch.device("cpu")
    bc = make_batch(cfg, SHAPES["train_4k"], 0,
                    batch_override=WL_CPU_BATCH[0],
                    seq_override=WL_CPU_BATCH[1], device=cpu)
    with torch.no_grad():
        t = time.perf_counter()
        loss_cpu = float(model.loss(TR.tree_map(lambda x: x.to(cpu),
                                                params_c), bc, remat=False))
        cpu_loss_s = time.perf_counter() - t
        loss_card = float(model.loss(params_c, {k: v.to(dev) for k, v in
                                                bc.items()}, remat=False))
    check(np.isfinite(loss_card) and abs(loss_card - loss_cpu)
          <= WL_CPU_LOSS_RTOL * abs(loss_cpu), f"phase workload (d): the "
          f"card's loss {loss_card} against the CPU's {loss_cpu}")
    log(f"phase workload (c): decode vs prefill max |diff| {gap:.4f} of "
        f"{scale:.3f} (argmax agree {argmax_agree:.3f}); (d) loss card "
        f"{loss_card:.6f}, CPU {loss_cpu:.6f} ({cpu_loss_s:.1f} s)")

    # ---- (e) replays through the plain versions ---------------------------
    plain_replays = {}

    def replay(name, raw, plain, call, what):
        r = replay_through_plain(torch, raw, plain, call, what)
        if name in plain_replays:  # one kernel replayed twice
            prev = plain_replays[name]
            r = {"what": f"{prev['what']}; {r['what']}",
                 "each": prev.get("each", [prev]) + [r],
                 "max_abs_err": max(prev["max_abs_err"], r["max_abs_err"])}
        plain_replays[name] = r

    replay("topk_block", topk_block.topk_block_raw,
           topk_block.topk_block_plain, kept_a.pop("topk_block"),
           "phase workload (a): the largest top-k launch")
    replay("xla_add", xla_add.xla_add_raw, xla_add.xla_add_plain,
           kept_a.pop("xla_add"), "phase workload (a): the largest xla_add")
    replay("segment_fold", segment.segment_fold, segment.segment_fold_plain,
           kept_a.pop("segment_fold"),
           "phase workload (a): the largest segment fold")
    if "partition" in caught:
        replay("partition", partition.partitioned_accumulate_raw,
               partition.partitioned_accumulate_plain,
               caught.pop("partition"),
               "phase workload (b): the catch-up's largest partition launch")
    if "spa_accum" in caught:
        replay("spa_accum", spa_accum.spa_accumulate_raw,
               spa_accum.spa_accumulate_plain, caught.pop("spa_accum"),
               "phase workload (b): the catch-up's largest SPA launch")
    folds = [caught.pop(k) for k in ("segment_fold", "segment_fold/sparse")
             if k in caught]
    if folds:
        replay("segment_fold", segment.segment_fold,
               segment.segment_fold_plain,
               max(folds, key=lambda c: c[0][0].numel()),
               "phase workload (b): the catch-up's largest segment fold")
    if "hash_slide" in caught:
        # the plain sliding hash takes seconds a bucket: a seeded sample of
        # the largest launch's parts, each bitwise (slide_catchup)
        sl = slide_catchup(torch, hash_slide,
                           {"largest": caught.pop("hash_slide")}, seed,
                           what="the workload catch-up's")
        plain_replays["hash_slide"] = {
            "what": "phase workload (b): the catch-up's largest sliding-hash "
                    "launch, sampled parts", "sampled_parts":
            sl["sampled_parts"], "shapes": [sl["B"], sl["cap"]],
            "max_abs_err": 0.0}
    log(f"phase workload (e): {plain_replays}")
    for name in ("topk_block", "xla_add", "segment_fold"):
        check(launches[name] > 0, f"phase workload: the {name} kernel did "
              f"not launch")
    step_med = statistics.median(comp_ms)
    phase = {
        "model": "smollm-135m", "params": n_params, "compute": "bfloat16",
        "reduced": [f"train batch {B} x {S_len} tokens against train_4k's "
                    f"256 x 4,096", "one chip (one NCCL rank, P = 1)",
                    f"serving: {P_B} prompts of {P_S} tokens, "
                    f"{WL_NEW_TOKENS} new tokens",
                    "no shadow checkpoints (the CPU tests cover them)"],
        "init_ms": init_ms,
        "dense_step_ms": dense_ms, "dense_losses": dense_losses,
        "dense_step_median_ms": statistics.median(dense_ms),
        "compressed_step_ms": comp_ms, "compressed_losses": comp_losses,
        "compressed_step_median_ms": step_med,
        "train_tokens_per_s": B * S_len / (step_med / 1e3),
        "dense_train_tokens_per_s":
        B * S_len / (statistics.median(dense_ms) / 1e3),
        "mean_ms": mean_ms, "mean_share_median": statistics.median(
            m / s for m, s in zip(mean_ms, comp_ms)),
        "publish_ms": publish_ms, "wire_bytes": wire,
        "prefill_ms": prefill_ms, "catchup_ms": catchup_ms,
        "catchup_window": WL_COMPRESSED_STEPS,
        "catchup_launches": catchup_used, "catchup_repeats": repeats,
        "catchup_bitwise_to_shadow": bitwise,
        "catchup_max_abs_diff": catchup_err,
        "token_ms": token_ms, "decode_ms": decode_ms,
        "decode_median_ms": decode_med,
        "decode_tokens_per_s": P_B / (decode_med / 1e3),
        "worst_hot_swap_token_ms": max(token_ms),
        "syncs_bitwise_to_shadow": sum(1 for s in per_sync if s[0]),
        "syncs": len(per_sync),
        "decode_vs_prefill_max_abs": gap, "decode_logit_scale": scale,
        "decode_vs_prefill_argmax_agree": argmax_agree,
        "loss_card": loss_card, "loss_cpu": loss_cpu,
        "cpu_loss_s": cpu_loss_s,
        "launches": launches, "launches_dense": dense_used,
        "launches_train": used_a, "launches_serve": serve_used,
        "plain_replays": plain_replays,
        "peak_mem_bytes": torch.cuda.max_memory_allocated(dev)}
    log(f"phase workload: dense step {phase['dense_step_median_ms']:.1f} ms, "
        f"compressed {step_med:.1f} ms ({phase['train_tokens_per_s']:.0f} "
        f"tokens/s, mean {phase['mean_share_median']:.1%}), publish "
        f"{statistics.median(publish_ms):.1f} ms, decode {decode_med:.2f} "
        f"ms/token, worst hot-swap token {max(token_ms):.1f} ms, peak "
        f"{phase['peak_mem_bytes'] / 2**30:.2f} GiB; launches {launches}")
    return phase, {"workload_compressed_step": prof_step,
                   "workload_decode_token": prof_decode}


#: Phase ``families``: the other families of the port at full width
#: (``src/repro_torch/configs/``), depth cut to fit one card by
#: ``tree_param_count`` (16 B a parameter for f32 weights, gradients and
#: AdamW moments, 20 B with the compressed step's residual, 8 B for a loss
#: and gradient). Each family's parameters are drawn once, on the card
#: (``init(on_device=True)``); a shallower tree is cut from the deeper one
#: (gemma3's depth-6 training tree is its depth-7 serving tree without
#: ``extra_local``; Moonshot's depth-1 training tree is the first layer of
#: its depth-2 serving tree; Zamba2's depth-18 training tree the first 3
#: of its 9 groups). ``step``: ``"compressed"`` one
#: ``make_compressed_train_step`` step, ``"grad"`` a loss and gradient
#: (the compressed step of those would not fit). Moonshot's step trains
#: at depth 1: at depth 2, AdamW holding the old and new parameters,
#: moments and residuals at once with the mean reckons 65 GB (1.24 G
#: parameters at depth 1: 45 GB) before its temporaries and the earlier
#: phases' tensors, too close to the card's 79.2 GiB. Zamba2's step trains
#: at depth 18 (3 shared-block sites): at 54 it reckons 48.4 GB (2.42 G
#: parameters) plus the mean's temporaries, 5.8 GB a copy of the stacked
#: ``in_proj`` leaf (1.44 G f32 elements); 18 layers reckon 19.7 GB.
#: ``cpu_cut``: the config fields of the small depth at which the card's
#: loss is held to the CPU's (``FAM_CPU_BATCH``); ``kv_quant``: whether
#: the first self-attention cache is quantized to int8
#: (:func:`family_kv_quant`).
FAMILIES = {
    "moonshot_v1_16b_a3b": dict(train_depth=1, train=(8, 2048),
                                serve_depth=2, prompts=(4, 512),
                                step="compressed"),
    "llama4_scout_17b_a16e": dict(train_depth=1, train=(1, 4096),
                                  serve_depth=1, prompts=(4, 512),
                                  step="grad"),
    "gemma3_27b": dict(train_depth=6, train=(1, 4096), serve_depth=7,
                       prompts=(2, 1536), step="grad"),
    "qwen2_vl_72b": dict(train_depth=2, train=(1, 4096), serve_depth=2,
                         prompts=(4, 512), step="grad"),
    "mamba2_370m": dict(train_depth=48, train=(8, 2048), serve_depth=48,
                        prompts=(4, 512), step="compressed",
                        cpu_cut=dict(n_layers=2)),
    "zamba2_2_7b": dict(train_depth=18, train=(8, 2048), serve_depth=54,
                        prompts=(4, 512), step="compressed",
                        cpu_cut=dict(n_layers=6), kv_quant=True),
    "whisper_medium": dict(train_depth=24, train=(8, 2048), serve_depth=24,
                           prompts=(4, 512), step="compressed",
                           cpu_cut=dict(n_layers=2, n_enc_layers=2),
                           kv_quant=True),
}
FAM_NEW_TOKENS = 8
FAM_K = 0.01
#: The card's loss against the CPU's: one sequence of 256 tokens
#: (``train_4k``'s draws; Whisper's 1,500 frames beside them).
FAM_CPU_BATCH = (1, 256)
#: ``attention_with_quant_cache`` against the exact attention: the
#: reference's bound (``tests/test_extensions.py``: rtol and atol 5e-2).
FAM_KV_QUANT_TOL = 5e-2


def family_decode(torch, model, params, batch, counted=None):
    """Prefill ``batch``'s prompts (``make_prefill_step``, chunks of 32,
    caches of prompt + :data:`FAM_NEW_TOKENS`) and decode that many greedy
    tokens (``make_decode_step``, chunks of 128). Returns ``(prefill ms,
    decode ms each, the fed tokens, the last logits, the caches, the decode
    step, launches)``; launches are counted when ``counted`` is given."""
    from repro_torch.train import make_decode_step, make_prefill_step

    P_S = batch["tokens" if "tokens" in batch else "embeds"].shape[1]
    prefill = make_prefill_step(model, attn_chunk=32,
                                max_len=P_S + FAM_NEW_TOKENS)
    decode = make_decode_step(model, attn_chunk=128)
    counted = counted or (lambda fn: (fn(), {}))
    torch.cuda.synchronize()
    t = time.perf_counter()
    (lg, caches), used = counted(lambda: prefill(params, batch))
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t) * 1e3
    tok, fed, decode_ms, used = torch.argmax(lg, -1), [], [], dict(used)
    for _ in range(FAM_NEW_TOKENS):
        fed.append(tok)
        t = time.perf_counter()
        (lg, caches), more = counted(lambda: decode(params, caches, tok))
        torch.cuda.synchronize()
        decode_ms.append((time.perf_counter() - t) * 1e3)
        tok = torch.argmax(lg, -1)
        for k, n in more.items():
            used[k] = used.get(k, 0) + n
    return prefill_ms, decode_ms, fed, lg, caches, decode, used


def decode_vs_prefill(torch, model, params, prompts, fed, lg,
                      embeds=None) -> dict:
    """The last decode logits ``lg`` against ``model``'s prefill of the
    prompts plus the ``fed`` tokens (an encoder-decoder's on the same
    frame ``embeds``): max |diff|, the largest logit, the share of
    sequences whose argmax agrees and, for a MoE model, the assignments
    each layer of that prefill dropped."""
    from repro_torch.models import moe as MOE

    drops = []
    real_dispatch = MOE.dispatch

    def counting(expert, n_experts, capacity, **kw):
        d = real_dispatch(expert, n_experts, capacity, **kw)
        drops.append(int((~d.keep).sum()))
        return d

    full = torch.cat([prompts, torch.stack(fed, 1).to(torch.int32)], 1)
    MOE.dispatch = counting
    try:
        lp, _ = model.prefill(params, full, embeds=embeds, attn_chunk=32)
    finally:
        MOE.dispatch = real_dispatch
    return {"max_abs": float((lp - lg).abs().max()),
            "logit_scale": float(lp.abs().max()),
            "argmax_agree": float((lp.argmax(-1) == lg.argmax(-1)).float()
                                  .mean()),
            "dropped_assignments": drops}


def family_serve(torch, model, params, spec, dev, counted):
    """Prefill the family's prompts and decode :data:`FAM_NEW_TOKENS`
    greedy tokens (:func:`family_decode`), timed, and profile one more
    token. (b) But for the VLM, whose prompts are embeddings and whose
    decode is only held finite, the last decode logits are held to a
    prefill of the prompts plus those tokens within ``WL_DECODE_TOL`` (the
    encoder-decoder's on the same seeded frames, ``make_batch``'s). A
    MoE model at its capacity factor drops assignments in a prefill of
    thousands of tokens that a decode of a few keeps, and in bf16 the two
    paths' rounding flips a token's near-tied experts (a jump, not a
    drift), so its gap there is only reported; it is held on the same
    weights in f32 compute at a capacity factor of ``n_experts /
    moe_topk``, where no expert can overflow. An SSM or hybrid model's
    chunked prefill and recurrent decode round differently in bf16 at
    every layer, and over Mamba2's 48 and Zamba2's 54 layers the gap
    compounds to a few percent, as the reference's own does
    (``tests/test_torch_ssm.py``, ``tests/test_torch_hybrid_encdec.py``:
    ``test_*bf16_decode_drift_is_the_references``), near the tolerance at
    Zamba2's depth: it too is only reported in bf16 and held on the same
    weights in f32 compute. Returns the numbers and the decode profile."""
    import dataclasses

    from repro_torch.data import make_batch
    from repro_torch.models import build_model
    from repro_torch.models.common import SHAPES

    cfg = model.cfg
    what = f"phase families (b) {cfg.arch_id}"
    P_B, P_S = spec["prompts"]
    batch = make_batch(cfg, SHAPES["prefill_32k"], 0, batch_override=P_B,
                       seq_override=P_S, device=dev)
    batch.pop("labels")
    prefill_ms, decode_ms, fed, lg, caches, decode, used = family_decode(
        torch, model, params, batch, counted)
    check(bool(torch.isfinite(lg).all()), f"{what}: decode logits are not "
          f"finite")
    decode_med = statistics.median(decode_ms)
    tok = torch.argmax(lg, -1)
    prof = device_profile(torch, lambda: decode(params, caches, tok),
                          decode_med)
    del caches
    out = {"prompts": [P_B, P_S], "prefill_ms": prefill_ms,
           "decode_ms": decode_ms, "decode_median_ms": decode_med,
           "decode_tokens_per_s": P_B / (decode_med / 1e3),
           "decode_idle_share": 1.0 - prof["busy_share"],
           "launches_serve": used,
           "ring": (min(cfg.sliding_window, P_S + FAM_NEW_TOKENS)
                    if cfg.sliding_window else None)}
    idle = f"{1 - prof['busy_share']:.0%} idle"
    if cfg.family == "vlm":
        log(f"{what}: prefill {P_B}x{P_S} (embeddings) {prefill_ms:.1f} "
            f"ms, decode {decode_med:.2f} ms a token ({idle}), finite "
            f"logits (no prefill to hold decode to: the prompts are "
            f"embeddings)")
        return out, prof
    held = decode_vs_prefill(torch, model, params, batch["tokens"], fed, lg,
                             batch.get("embeds"))
    if cfg.family in ("moe", "ssm", "hybrid"):
        out["decode_vs_prefill_at_config"] = held
        exact_kw = {"compute_dtype": "float32"}
        if cfg.family == "moe":
            exact_kw["capacity_factor"] = cfg.n_experts / cfg.moe_topk
        exact = build_model(dataclasses.replace(cfg, **exact_kw))
        _, _, fed, lg, caches, _, _ = family_decode(torch, exact, params,
                                                    batch)
        del caches
        held = decode_vs_prefill(torch, exact, params, batch["tokens"], fed,
                                 lg)
        held.update(exact_kw)
        check(not any(held["dropped_assignments"]), f"{what}: the lossless "
              f"capacity dropped {held['dropped_assignments']}")
    out["decode_vs_prefill"] = held
    at_cfg = out.get("decode_vs_prefill_at_config")
    log(f"{what}: prefill {P_B}x{P_S} {prefill_ms:.1f} ms, decode "
        f"{decode_med:.2f} ms a token ({idle}); decode vs prefill {held}"
        + (f" (at the config, bf16: {at_cfg})" if at_cfg else ""))
    check(np.isfinite(held["max_abs"])
          and held["max_abs"] <= WL_DECODE_TOL * held["logit_scale"],
          f"{what}: decode differs from prefill by {held['max_abs']} "
          f"(largest logit {held['logit_scale']}, limit {WL_DECODE_TOL} of "
          f"it)")
    return out, prof


def family_grad(torch, model, params, spec, dev, counted):
    """A loss and gradient of ``model.loss`` (remat, the train step's
    chunks) on ``train_4k``'s draws cut to ``spec["train"]``: all finite."""
    from repro_torch import tree as TR
    from repro_torch.data import make_batch
    from repro_torch.models.common import SHAPES
    from repro_torch.train import TrainHParams

    hp = TrainHParams()
    B, S_len = spec["train"]
    batch = make_batch(model.cfg, SHAPES["train_4k"], 0, batch_override=B,
                       seq_override=S_len, device=dev)
    leaves, treedef = TR.flatten(params)
    leaves = [x.detach().requires_grad_() for x in leaves]

    def loss_and_grads():
        with torch.enable_grad():
            loss = model.loss(TR.unflatten(treedef, leaves), batch,
                              remat=hp.remat, ce_chunk=hp.ce_chunk,
                              attn_chunk=hp.attn_chunk)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        return loss.detach(), grads

    torch.cuda.synchronize()
    t = time.perf_counter()
    (loss, grads), used = counted(loss_and_grads)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t) * 1e3
    finite = all(g is None or bool(torch.isfinite(g).all()) for g in grads)
    check(bool(torch.isfinite(loss)) and finite,
          f"phase families (a) {model.cfg.arch_id}: loss {float(loss)} or a "
          f"gradient is not finite")
    return {"train": [B, S_len], "loss": float(loss), "loss_grad_ms": ms,
            "train_tokens_per_s": B * S_len / (ms / 1e3),
            "launches_train": used,
            "unused_leaves": sum(g is None for g in grads)}


def shallower_tree(TR, model, cut, params) -> dict:
    """``params`` of ``model`` cut to ``cut``'s depth, sharing storage: the
    first layers of an all-global or SSM stack, the first groups of a
    hybrid (its shared block kept), the first encoder and decoder layers,
    or a grouped tree without its extra local layers (one whole group
    kept)."""
    family = model.cfg.family

    def first(key, n):
        return TR.tree_map(lambda x: x[:n], params[key])

    if family == "hybrid":
        return {**params, "mamba_layers": first("mamba_layers",
                                                cut.n_groups)}
    if family == "encdec":
        return {**params, "enc_layers": first("enc_layers",
                                              cut.cfg.n_enc_layers),
                "dec_layers": first("dec_layers", cut.cfg.n_layers)}
    if getattr(model, "n_groups", 0) == 0:
        return {**params, "layers": first("layers", cut.cfg.n_layers)}
    check(cut.n_extra_local == 0 and cut.n_groups == model.n_groups,
          f"phase families: {model.cfg.arch_id}'s depth cut is not its "
          f"extra local layers")
    return {k: v for k, v in params.items() if k != "extra_local"}


def run_families(torch, seed: int, dev, kernels: dict):
    """Phase ``families``: the MoE, gemma3 local:global and VLM decoders,
    the Mamba2 SSM, the Zamba2 hybrid and the Whisper encoder-decoder at
    full width (:data:`FAMILIES`, depths cut to fit the card), through the
    port's entry points (``build_model``, ``make_batch``,
    ``make_prefill_step``, ``make_decode_step``,
    ``make_compressed_train_step``, ``repro_torch.serve``) on the default
    NCCL group of one rank.

    (a) Llama4's, gemma3's and Qwen2-VL's loss and gradient are finite;
    Moonshot (its first layer), Mamba2, Zamba2 (its first 3 groups) and
    Whisper take one compressed step (k 0.01, block selector,
    ``gather_kway``), whose means at P = 1 are ``densify(u)`` bitwise with
    mean + new residual equal to gradient + residual
    (:func:`check_means_at_p1`). (b) Greedy decode of 8 tokens against a
    prefill of the prompts plus those tokens (``WL_DECODE_TOL``), but for
    the VLM, whose decode is only held finite, and the MoE, SSM and hybrid
    models, held on the same weights in f32 compute, their bf16 gap
    reported (:func:`family_serve`); gemma3's prompts are longer than its
    window, so the rings are rolled and every decoded token wraps them.
    (c) Each step's largest launch of the top-k, ``xla_add``,
    segment-fold and MoE combine kernels replayed through the plain
    versions. (d) The combine of Moonshot's first MoE layer held bitwise
    to the plain ordered fold (``moe.combine_plain``) and to the segment
    fold's route, and timed beside them and ``index_add_`` on the same
    contributions (:func:`combine_times`). (e) Mamba2,
    Zamba2 and Whisper: the card's loss against the CPU's at a small depth
    (:func:`family_cpu_loss`). (f) Zamba2 and Whisper: the first
    self-attention cache quantized to int8 (:func:`family_kv_quant`).
    Returns the phase's numbers and one decode token's profile a
    family."""
    import dataclasses
    import gc

    from repro_torch import tree as TR
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_param_count
    from repro_torch.models.layers import use_full_precision

    use_full_precision()
    launches = dict.fromkeys(("topk_block", "xla_add", "segment_fold",
                              "moe_combine"), 0)

    def counted(fn):
        return count_launches(torch, kernels, launches, fn)

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    free()
    resident = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    fams, profiles, plain_replays, combine = {}, {}, {}, {}
    for arch, spec in FAMILIES.items():
        t_fam = time.monotonic()
        torch.cuda.reset_peak_memory_stats(dev)
        full = get_config(arch)
        depth = max(spec["train_depth"], spec["serve_depth"])
        model = build_model(dataclasses.replace(full, n_layers=depth))
        torch.cuda.synchronize()
        t = time.perf_counter()
        params = model.init(seed, device=dev, on_device=True)
        torch.cuda.synchronize()
        res = {"depth_serve": spec["serve_depth"],
               "depth_train": spec["train_depth"],
               "layers_full": full.n_layers, "params": sum(
                   x.numel() for x in TR.leaves(params)),
               "init_ms": (time.perf_counter() - t) * 1e3,
               "compute": full.compute_dtype}
        check(res["params"] == tree_param_count(model.cfg), f"phase "
              f"families: {arch}'s tree holds {res['params']} parameters, "
              f"its config {tree_param_count(model.cfg)}")
        smodel, sparams = model, params
        if spec["serve_depth"] != depth:
            smodel = build_model(dataclasses.replace(
                full, n_layers=spec["serve_depth"]))
            sparams = shallower_tree(TR, model, smodel, params)
        serve, profiles[f"families_{arch}_decode_token"] = family_serve(
            torch, smodel, sparams, spec, dev, counted)
        res.update(serve)
        if spec.get("kv_quant"):
            res["kv_quant"] = family_kv_quant(torch, smodel, sparams, spec,
                                              dev)
        if "cpu_cut" in spec:
            res["cpu_loss"] = family_cpu_loss(torch, model, params, full,
                                              spec, dev)
        tmodel, tparams = model, params
        if spec["train_depth"] != depth:
            # a copy of the cut, so that the deeper tree's storage is freed
            tmodel = build_model(dataclasses.replace(
                full, n_layers=spec["train_depth"]))
            tparams = TR.tree_map(torch.clone, shallower_tree(
                TR, model, tmodel, params))
            params = None
            free()
        res["train_params"] = sum(x.numel() for x in TR.leaves(tparams))
        del smodel, sparams
        if spec["step"] == "grad":
            res.update(family_grad(torch, tmodel, tparams, spec, dev,
                                   counted))
            log(f"phase families (a) {arch}: depth {spec['train_depth']}, "
                f"loss {res['loss']:.4f}, loss and gradient on "
                f"{spec['train']} in {res['loss_grad_ms']:.1f} ms; "
                f"launches {res['launches_train']}")
        else:
            res.update(compressed_step(torch, tmodel, tparams, spec, dev,
                                       kernels, counted, plain_replays,
                                       combine))
        del tmodel, tparams, params, model
        free()
        res["peak_mem_bytes"] = torch.cuda.max_memory_allocated(dev)
        res["wall_s"] = time.monotonic() - t_fam
        fams[arch] = res
        log(f"phase families {arch}: {res['wall_s']:.1f} s, peak "
            f"{res['peak_mem_bytes'] / 2**30:.2f} GiB")
    for name in launches:
        check(launches[name] > 0, f"phase families: the {name} kernel did "
              f"not launch")
    phase = {
        "families": fams, "launches": launches,
        "plain_replays": plain_replays, "moe_combine": combine,
        "resident_before_bytes": resident,
        "peak_mem_bytes": max(f["peak_mem_bytes"] for f in fams.values()),
        "reduced": [f"{a}: depth {s['train_depth']} (train) and "
                    f"{s['serve_depth']} (serve) of "
                    f"{fams[a]['layers_full']}; train batch "
                    f"{s['train'][0]} x {s['train'][1]} of train_4k's "
                    f"256 x 4,096; {s['prompts'][0]} prompts of "
                    f"{s['prompts'][1]}, {FAM_NEW_TOKENS} new tokens"
                    for a, s in FAMILIES.items()]
        + ["parameters drawn on the card (other values than the CPU draw)",
           "one chip (one NCCL rank, P = 1)",
           "llama4, gemma3, qwen2-vl: a loss and gradient, no optimizer "
           "step (their compressed step needs 67-106 GB)",
           "zamba2: the compressed step at depth 18 (3 shared-block sites) "
           "of 54: at 54 it reckons 48.4 GB plus the mean's temporaries",
           "the card's loss held to the CPU's at depths "
           + ", ".join(f"{a} {s['cpu_cut']}" for a, s in FAMILIES.items()
                       if "cpu_cut" in s)]}
    log(f"phase families: launches {launches}; replays {plain_replays}")
    return phase, profiles


def compressed_step(torch, model, params, spec, dev, kernels, counted,
                    plain_replays, combine):
    """Phase ``families`` (a), (c) and, for a MoE model, (d): one
    compressed step. Its mean at P = 1 is checked, and its largest top-k,
    ``xla_add`` and segment-fold launches replayed through the plain
    versions, inside the mean's call, before AdamW builds the new state
    (kept until the step's end, the gradients and those inputs would not
    fit beside the old and new state); that aside is not counted in
    launches and is taken off the step's time. A MoE model's combine: its
    largest ``moe_combine`` launch is replayed after the step, and its first
    layer's combine held to the plain fold and timed
    (:func:`combine_times`, the route before the kernel too). Fills
    ``plain_replays`` and ``combine``; returns the step's numbers."""
    from repro_torch import tree as TR
    from repro_torch.core import engine as E
    from repro_torch.data import make_batch
    from repro_torch.kernels import moe_combine as MC
    from repro_torch.kernels import segment, topk_block, xla_add
    from repro_torch.models import moe as MOE
    from repro_torch.models.common import SHAPES
    from repro_torch.optim import adamw_init
    from repro_torch.train import (TrainHParams, make_compressed_train_step,
                                   rank_ef_state)
    from repro_torch.train import step as ST

    what = f"phase families {model.cfg.arch_id}"
    is_moe = model.cfg.family == "moe"
    B, S_len = spec["train"]
    batch = make_batch(model.cfg, SHAPES["train_4k"], 0, batch_override=B,
                       seq_override=S_len, device=dev)
    comp = make_compressed_train_step(
        model, None, TrainHParams(warmup=0, total_steps=100),
        k_fraction=FAM_K, selector="block", schedule="gather_kway")
    names = TR.flatten_with_names(params)[1]
    real_mean, real_combine = ST.compressed_gradient_mean, MOE.combine
    log_ = {"ev": [], "contrib": None, "aside_s": 0.0, "dense": 0}

    def replay(name, raw, plain, call, what_):
        r = replay_through_plain(torch, raw, plain, call, what_)
        if name in plain_replays:  # one kernel replayed twice
            prev = plain_replays[name]
            r = {"what": f"{prev['what']}; {r['what']}",
                 "each": prev.get("each", [prev]) + [r],
                 "max_abs_err": max(prev["max_abs_err"], r["max_abs_err"])}
        plain_replays[name] = r

    def timed_mean(grads, residuals, *a, **kw):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        out, kept = keeping_largest_each(
            {"topk_block": (topk_block, "topk_block_raw"),
             "xla_add": (xla_add, "xla_add_raw"),
             "segment_fold": (E, "segment_fold")},
            lambda: real_mean(grads, residuals, *a, **kw),
            required=("topk_block", "xla_add", "segment_fold"))
        ev[1].record()
        log_["ev"].append(ev)
        torch.cuda.synchronize()
        t = time.perf_counter()
        with launches_uncounted(kernels):
            log_["dense"] += check_means_at_p1(
                torch, names, [(grads, residuals, out)], FAM_K,
                f"{what} (a)")
            replay("topk_block", topk_block.topk_block_raw,
                   topk_block.topk_block_plain, kept.pop("topk_block"),
                   f"{what} (c): the step's largest top-k launch")
            replay("xla_add", xla_add.xla_add_raw, xla_add.xla_add_plain,
                   kept.pop("xla_add"),
                   f"{what} (c): the step's largest xla_add")
            replay("segment_fold", segment.segment_fold,
                   segment.segment_fold_plain, kept.pop("segment_fold"),
                   f"{what} (c): the mean's largest segment fold")
            del kept
            torch.cuda.synchronize()
        log_["aside_s"] += time.perf_counter() - t
        return out

    def first_combine(contrib):
        if log_["contrib"] is None:
            log_["contrib"] = contrib.detach()
        return real_combine(contrib)

    state = {"p": params, "o": adamw_init(params),
             "ef": rank_ef_state(params)}
    del params

    def one_step():
        p, o, ef = state.pop("p"), state.pop("o"), state.pop("ef")
        return comp(p, o, ef, batch)

    moe_fold = ({"moe_combine": (MOE, "moe_combine_raw")} if is_moe
                else {})
    ST.compressed_gradient_mean = timed_mean
    if is_moe:
        MOE.combine = first_combine
    try:
        torch.cuda.synchronize()
        t = time.perf_counter()
        (out, kept), used = counted(lambda: keeping_largest_each(
            moe_fold, one_step, required=tuple(moe_fold)))
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t - log_["aside_s"]) * 1e3
    finally:
        ST.compressed_gradient_mean, MOE.combine = real_mean, real_combine
    metrics = out[3]
    loss = float(metrics["loss"])
    del out, state
    check(np.isfinite(loss) and bool(torch.isfinite(metrics["grad_norm"])),
          f"{what} (a): loss {loss}, grad norm {metrics['grad_norm']}")
    mean_ms = log_["ev"][0][0].elapsed_time(log_["ev"][0][1])
    res = {"train": [B, S_len], "loss": loss,
           "grad_norm": float(metrics["grad_norm"]),
           "compressed_step_ms": step_ms,
           "train_tokens_per_s": B * S_len / (step_ms / 1e3),
           "mean_ms": mean_ms, "mean_share": mean_ms / step_ms,
           "checks_in_step_s": log_["aside_s"],
           "dense_leaves": log_["dense"], "launches_train": used}
    log(f"{what} (a): compressed step {step_ms:.1f} ms "
        f"({res['train_tokens_per_s']:.0f} tokens/s; the mean "
        f"{mean_ms:.1f} ms, {res['mean_share']:.2%}), loss {loss:.4f}; "
        f"means == densify(u) bitwise ({log_['dense']} dense leaves); "
        f"launches {used}")
    if not is_moe:
        return res
    replay("moe_combine", MC.moe_combine_raw, MC.moe_combine_plain,
           kept.pop("moe_combine"),
           f"{what} (c): the MoE combine's largest launch")
    del kept

    # ---- (d) the first layer's combine against the plain ordered fold ----
    contrib = log_["contrib"]
    T, K, d = contrib.shape
    got = MOE.combine(contrib)
    want = MOE.combine_plain(contrib)
    check(bitwise_equal(torch, got, want), f"{what} (d): the combine "
          f"differs from the plain ordered fold")
    check(bitwise_equal(torch, got, segment_route(torch, segment.segment_fold,
                                                  contrib)),
          f"{what} (d): the combine differs from the segment-fold route")
    del got, want
    combine.update(combine_times(torch, contrib,
                                 segment_fold=segment.segment_fold))
    combine["bitwise_to_plain"] = True
    log(f"{what} (d): combine {combine['ms']:.3f} ms (queued "
        f"{combine['queued_ms']:.3f}; plain {combine['plain_ms']:.3f}, "
        f"index_add_ "
        f"{combine['library_ms']:.3f}, the segment-fold route "
        f"{combine['segment_route_ms']:.3f}, bound "
        f"{combine['bound_ms']:.3f}) on {T} x {K} x {d} {combine['dtype']}, "
        f"bitwise to the plain fold")
    return res


def segment_route(torch, fold, contrib):
    """The route the MoE combine took before it had a kernel of its own:
    the contributions laid out token by token, K to a feature (a copy), an
    int32 id for every element (made contiguous by the wrapper) and the
    ordered segment fold of each feature's run of K into a zero-filled
    output, by ``fold`` (``segment.segment_fold``, or its plain version).
    Kept here as the yardstick of the combine's kernel."""
    T, K, d = contrib.shape
    vals = contrib.transpose(1, 2).reshape(T, d * K)
    gid = torch.arange(d, dtype=torch.int32,
                       device=contrib.device).repeat_interleave(K)
    return fold(vals, gid.expand(T, d * K), d)


def combine_times(torch, contrib, plain: bool = True,
                  segment_fold=None) -> dict:
    """The MoE combine's kernel on ``contrib`` (T, K, d) on the card:
    CUDA-event medians of the wrapper (``ms``), ``index_add_``
    into a zero-filled output (``library_ms``: one PyTorch call of the
    same sum, in no fixed order), the plain fold's (with ``plain``) and,
    given the segment fold, the route before the kernel
    (:func:`segment_route`); the kernel's, ``index_add_``'s and the
    route's calls queued back to back too (``*queued_ms``,
    :func:`queued_ms`: the device's time without the host's between
    calls); the bound and the launch's geometry."""
    from repro_torch.kernels import moe_combine as MC

    T, K, d = contrib.shape
    dev = contrib.device
    flat = contrib.reshape(T * K, d)
    tok = torch.arange(T, device=dev).repeat_interleave(K)
    nbytes = contrib.element_size() * (T * K * d + T * d)
    b_ms, b_by = bound(nbytes, T * K * d)
    out = {"shape": [T, K, d], "dtype": str(contrib.dtype).split(".")[-1],
           "bytes": nbytes, "bound_ms": b_ms, "bound_by": b_by,
           "geometry": MC.launch_geometry(
               T, K, d, contrib.dtype, contrib.data_ptr() % 16 == 0)}
    out["ms"] = cuda_ms(torch, lambda: MC.moe_combine_raw(contrib), 20)

    def library():
        return torch.zeros((T, d), dtype=contrib.dtype,
                           device=dev).index_add_(0, tok, flat)

    out["library_ms"] = cuda_ms(torch, library, 20)
    out["library"] = "index_add_"
    out["queued_ms"] = queued_ms(torch, lambda: MC.moe_combine_raw(contrib))
    out["library_queued_ms"] = queued_ms(torch, library, 10)
    if plain:
        out["plain_ms"] = cuda_ms(
            torch, lambda: MC.moe_combine_plain(contrib), 5)
    if segment_fold is not None:
        def route():
            return segment_route(torch, segment_fold, contrib)

        out["segment_route_ms"] = cuda_ms(torch, route, 20)
        out["segment_route_queued_ms"] = queued_ms(torch, route, 10)
    out["bound_share"] = b_ms / out["ms"]
    out["bound_share_queued"] = b_ms / out["queued_ms"]
    return out


def family_cpu_loss(torch, model, params, full, spec, dev) -> dict:
    """(e) The card's loss against the CPU's on the same parameters, cut to
    ``spec["cpu_cut"]``'s depth, and the same ``FAM_CPU_BATCH`` tokens
    (and frames), bf16 compute, no remat: within ``WL_CPU_LOSS_RTOL``."""
    import dataclasses

    from repro_torch import tree as TR
    from repro_torch.data import make_batch
    from repro_torch.models import build_model
    from repro_torch.models.common import SHAPES

    cut = build_model(dataclasses.replace(full, **spec["cpu_cut"]))
    p = shallower_tree(TR, model, cut, params)
    cpu = torch.device("cpu")
    bc = make_batch(cut.cfg, SHAPES["train_4k"], 0,
                    batch_override=FAM_CPU_BATCH[0],
                    seq_override=FAM_CPU_BATCH[1], device=cpu)
    with torch.no_grad():
        loss_card = float(cut.loss(p, {k: v.to(dev) for k, v in bc.items()},
                                   remat=False))
        t = time.perf_counter()
        loss_cpu = float(cut.loss(TR.tree_map(lambda x: x.to(cpu), p), bc,
                                  remat=False))
        cpu_s = time.perf_counter() - t
    what = f"phase families (e) {full.arch_id}"
    check(np.isfinite(loss_card) and abs(loss_card - loss_cpu)
          <= WL_CPU_LOSS_RTOL * abs(loss_cpu), f"{what}: the card's loss "
          f"{loss_card} against the CPU's {loss_cpu}")
    log(f"{what}: loss on {FAM_CPU_BATCH} at {spec['cpu_cut']}: card "
        f"{loss_card:.6f}, CPU {loss_cpu:.6f} ({cpu_s:.1f} s)")
    return {"cut": spec["cpu_cut"], "batch": list(FAM_CPU_BATCH),
            "loss_card": loss_card, "loss_cpu": loss_cpu, "cpu_s": cpu_s}


def family_kv_quant(torch, model, params, spec, dev) -> dict:
    """(f) int8 KV quantization of the first self-attention cache
    (Whisper's decoder layer 0, Zamba2's shared-block site 0): the
    family's prompts are prefilled and one token decoded, the first
    ``blockwise_attention`` call of that decode kept (its query, the
    cache with the new token, its output). The prompts' keys and values
    quantized on the card (``quantize_kv``) equal their quantization on
    the CPU bitwise, codes and scales; the new token is written by
    ``quant_cache_update_decode``, and ``attention_with_quant_cache`` of
    the kept query is within ``FAM_KV_QUANT_TOL`` of the kept exact
    output."""
    from repro_torch.data import make_batch
    from repro_torch.models import layers as L
    from repro_torch.models.common import SHAPES
    from repro_torch.serve import kv_quant as Q

    what = f"phase families (f) {model.cfg.arch_id}"
    P_B, P_S = spec["prompts"]
    batch = make_batch(model.cfg, SHAPES["prefill_32k"], 0,
                       batch_override=P_B, seq_override=P_S, device=dev)
    lg, caches = model.prefill(params, batch["tokens"],
                               embeds=batch.get("embeds"),
                               max_len=P_S + FAM_NEW_TOKENS, attn_chunk=32)
    real, kept = L.blockwise_attention, {}

    def keeping(q, k, v, **kw):
        out = real(q, k, v, **kw)
        if not kept:
            kept.update(q=q, k=k, v=v, out=out, kw=kw)
        return out

    L.blockwise_attention = keeping
    try:
        model.decode_step(params, caches, torch.argmax(lg, -1),
                          attn_chunk=128)
    finally:
        L.blockwise_attention = real
    del caches
    k, v = kept["k"], kept["v"]
    check(int(kept["kw"]["kv_len"]) == P_S + 1, f"{what}: the first decode "
          f"attention is not the first self-attention's")
    qc = Q.quantize_kv(k[:, :P_S], v[:, :P_S])
    cpu = Q.quantize_kv(k[:, :P_S].cpu(), v[:, :P_S].cpu())
    check(all(torch.equal(a.cpu(), b) for a, b in zip(qc, cpu)),
          f"{what}: int8 codes or scales differ from the CPU's")
    # the prefill's codes in a cache of S_max slots, then the new token
    S_max = k.shape[1]
    pad = S_max - P_S
    qc = Q.QuantKVCache(
        torch.nn.functional.pad(qc.k_q, (0, 0, 0, 0, 0, pad)),
        torch.nn.functional.pad(qc.v_q, (0, 0, 0, 0, 0, pad)),
        torch.nn.functional.pad(qc.k_scale, (0, 0, 0, pad)),
        torch.nn.functional.pad(qc.v_scale, (0, 0, 0, pad)), qc.length)
    qc = Q.quant_cache_update_decode(qc, k[:, P_S:P_S + 1],
                                     v[:, P_S:P_S + 1])
    approx = Q.attention_with_quant_cache(kept["q"], qc, chunk=128)
    exact = kept["out"]
    gap = (approx.float() - exact.float()).abs()
    limit = FAM_KV_QUANT_TOL * (1 + exact.float().abs())
    worst = float((gap - limit).max())
    check(worst <= 0, f"{what}: quantized attention differs from the exact "
          f"by {float(gap.max())} (rtol and atol {FAM_KV_QUANT_TOL})")
    out = {"cache": [list(k[:, :P_S].shape), str(k.dtype).split(".")[-1]],
           "codes_bitwise_to_cpu": True,
           "attention_max_abs": float(gap.max()),
           "attention_scale": float(exact.float().abs().max()),
           "int8_bytes": qc.k_q.numel() * 2 + qc.k_scale.numel() * 8,
           "cache_bytes": k.numel() * k.element_size() * 2}
    log(f"{what}: codes of {out['cache']} bitwise to the CPU's; quantized "
        f"attention within {out['attention_max_abs']:.4f} of the exact "
        f"(largest {out['attention_scale']:.3f})")
    return out


#: Phase ``sharding``: SmolLM-135M's dense steps through the DTensor path
#: (``WL_ARCH``, ``WL_TRAIN_BATCH``), Moonshot-16B-A3B's loss and gradient
#: at depth 1 on 1 x 4,096 tokens, the publisher's epochs and the save.
SH_STEPS = 3
SH_MOE_ARCH = "moonshot_v1_16b_a3b"
SH_MOE_BATCH = (1, 4096)
SH_EPOCHS = 2
#: Phase ``sharding`` (e): rank 0 of the 16 x 16 production mesh under
#: PyTorch's ``fake`` process group on the card, gemma3-27B at full depth
#: on ``train_4k``'s rows for one rank (its dry-run count, 55.4 GiB, is
#: under 72 GiB), in a subprocess of this script (one process holds one
#: process group); beside it the same cell's dry-run on the host. Their
#: time limit.
SH_TP_ARCH = "gemma3_27b"
SH_TP_SHAPE = "train_4k"
SH_TP_TIMEOUT_S = 300
#: Phase ``sharding`` (f): the same for Moonshot-16B-A3B, its experts on
#: their ``model`` shards (4 of 64 a rank) over this rank's block of the
#: capacity (7,680 of 122,880 slots): at its full depth of 48, since its
#: dry-run count (27.4 GiB) is under a card's 74.5 GiB.
SH_EP_ARCH = "moonshot_v1_16b_a3b"
#: Phase ``sharding`` (g): the same for Zamba2-2.7B at its full depth of
#: 54, its Mamba blocks on 5 of 80 SSM heads a rank and its shared block
#: on 2 of 32 heads and 640 of 10,240 ``d_ff`` columns at each of its 9
#: sites; (h) for Whisper-medium at 24 + 24 layers, 1 of 16 heads and 256
#: of 4,096 GELU columns a rank in every attention and MLP.
SH_SSM_ARCH = "zamba2_2_7b"
SH_ED_ARCH = "whisper_medium"
#: Phase ``sharding`` (j)-(l): the serving steps on the same rank of the
#: production mesh, on the serving layout (bf16 parameters split over
#: ``model`` only) and the reference's cache layout: (j) Qwen2-VL-72B's
#: decode over caches split along ``head_dim`` (its 8 KV heads do not
#: divide 16 ranks), (k) Zamba2-2.7B's decode (the Mamba caches: 5 of 80
#: heads' states, 328 of 5,248 conv channels), (l) gemma3-27B's prefill of
#: 32,768-token prompts (ring and global caches on 1 of 16 KV heads).
SH_SERVE_PARTS = (("j", "qwen2_vl_72b", "decode_32k", "rank0_vlm_decode"),
                  ("k", SH_SSM_ARCH, "decode_32k", "rank0_hybrid_decode"),
                  ("l", SH_TP_ARCH, "prefill_32k", "rank0_prefill"))
#: Phase ``sharding`` (m): sequence parallelism (``use_sp``, the dry-run's
#: ``--sp``) on the same rank: Qwen2-VL-72B's ``train_4k`` at its full
#: depth of 80, the residual stream's 4,096 positions split over the 16
#: ``model`` ranks (this rank's rows 16 x 256), every weight gathered whole
#: at use; without SP a rank of this cell needs 110.1 GiB (the dry-run,
#: PERF.md section 5), more than a card holds.
SH_SP_ARCH = "qwen2_vl_72b"
#: The one rank-0 part whose config takes ``use_sp``.
SH_SP_PART = "m"
#: The rank-0 parts of phase ``sharding``: (part, arch, cell, the phase's
#: key).
SH_RANK0_PARTS = (("e", SH_TP_ARCH, SH_TP_SHAPE, "rank0"),
                  ("f", SH_EP_ARCH, SH_TP_SHAPE, "rank0_moe"),
                  ("g", SH_SSM_ARCH, SH_TP_SHAPE, "rank0_hybrid"),
                  ("h", SH_ED_ARCH, SH_TP_SHAPE, "rank0_encdec")
                  ) + SH_SERVE_PARTS + (
                  (SH_SP_PART, SH_SP_ARCH, SH_TP_SHAPE, "rank0_sp"),)
#: Part (m)'s peak above resident, as a share of the fake ``temp_bytes``
#: of the same cell's dry-run: the bounds it must fall within.
SH_SP_PEAK_RATIO = (1.00, 1.05)
#: Phase ``sharding`` (i): the placed serving steps at world 1 bitwise to
#: the plain ones: SmolLM-135M as phase ``workload``'s replica serves it
#: (its prompts and tokens) and Moonshot-16B-A3B at phase ``families``'
#: serving depth, prompts and tokens.
SH_SERVE_WORLD1 = ((WL_ARCH, None, WL_PROMPTS, WL_NEW_TOKENS),
                   (SH_MOE_ARCH, FAMILIES[SH_MOE_ARCH]["serve_depth"],
                    FAMILIES[SH_MOE_ARCH]["prompts"], FAM_NEW_TOKENS))


def first_mismatch(torch, names, want, got) -> str:
    """The first leaf of ``got`` whose bits differ from ``want``'s, with
    its largest difference ("" when every leaf agrees)."""
    for name, a, b in zip(names, want, got):
        if not bitwise_equal(torch, a, b):
            diff = float((a.double() - b.double()).abs().max())
            return f"{name}: largest |difference| {diff!r}"
    return ""


def run_sharding(torch, seed: int, dev, kernels: dict, mesh):
    """Phase ``sharding``: the port's FSDP×TP placements
    (``repro_torch.sharding``) on the script's (1, 1) NCCL mesh, held
    bitwise to the unsharded path (every collective is the identity at
    world 1; NCCL will not put two ranks on one card).

    (a) SmolLM-135M at full width and depth, params placed by
    ``params_shardings`` and AdamW state by ``adamw_init`` (the moments take
    the placements): three ``make_train_step`` steps on phase
    ``workload``'s 8 x 2,048 batches through the DTensor path (cast,
    gather, local loss and gradients, reduce, AdamW on shards), bitwise to
    three plain steps from the same params; each path's median step (host
    ms ending in a synchronize) and peak memory. (b) Moonshot-16B-A3B at
    depth 1 (drawn on the card) on 1 x 4,096 tokens: the loss and
    gradients of ``sharded_loss_and_grads`` bitwise to the plain ones; the
    MoE combine's kernel launches counted, its largest replayed through the
    plain fold. (c) ``DeltaPublisher(..., mesh=mesh)`` on (a)'s
    trajectory, two epochs: frames byte-identical to a publisher without a
    mesh; its top-k and ``xla_add`` launches counted, the largest replayed.
    (d) (a)'s sharded state saved, then restored onto its placements and
    onto plain tensors, both bitwise; save and restore ms. (e) One rank of
    the production mesh (:func:`sharding_rank0`, a subprocess on the
    card): gemma3-27B's dense step at full depth on one rank's rows of
    ``train_4k``, each layer's weights gathered at use and its blocks on
    their ``model`` shards; its ms, its peak above resident against the
    fake ``temp_bytes`` of the same cell's dry-run (started on the host at
    the phase's start, read last), and its counted FLOPs, which must equal
    the dry-run's as integers. (f) The same for Moonshot-16B-A3B at full
    depth (:data:`SH_EP_ARCH`): the MoE's experts on their ``model``
    shards over this rank's block of the capacity; the combine's kernel
    must launch (its launches join the phase's), and its largest call is
    replayed through the plain fold at its shape with values drawn on the
    card, and timed beside ``index_add_`` there. (g) and (h) the same for
    Zamba2-2.7B at
    full depth (:data:`SH_SSM_ARCH`: its Mamba blocks on their SSM heads,
    its shared block on its heads and ``d_ff`` columns at each site) and
    Whisper-medium (:data:`SH_ED_ARCH`, 24 + 24 layers on ``train_4k``'s
    frame embeddings too: every attention and MLP on its ``model``
    shard). (i) The placed prefill and decode at world 1, bitwise to the
    plain ones (:func:`serve_world1`, :data:`SH_SERVE_WORLD1`); (j)-(l)
    serving cells on the same production rank (:data:`SH_SERVE_PARTS`:
    the serving layout's bf16 parameters, a decode's caches on the
    reference's cache layout, drawn on the card), held to their dry-runs
    as (e); (m) Qwen2-VL-72B's train step under ``use_sp``
    (:data:`SH_SP_ARCH`, the dry-run beside it under ``--sp``), held as
    (e), its peak above resident within :data:`SH_SP_PEAK_RATIO` of the
    fake ``temp_bytes`` and within the card's memory. The fake collectives move nothing and hand back uninitialized
    memory, so (e)-(h) and (j)-(l) hold no value of the step to
    anything. Two runs
    of one path agree bitwise only on deterministic kernels, so (a) and (b)
    run under ``torch.use_deterministic_algorithms(True, warn_only=True)``
    (the sorted ``index_put_`` accumulate of the embedding's and the MoE
    dispatch's backward). Returns the phase's numbers."""
    import gc

    from repro_torch.models.layers import use_full_precision

    import tempfile

    use_full_precision()
    gc.collect()
    torch.cuda.empty_cache()
    # (e)-(h)'s and (j)-(l)'s fake counts, on the host's CPU while (a)-(d)
    # and (i) run on the card
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_sharding_")
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    drys = {}
    try:
        for part, arch, cell, _ in SH_RANK0_PARTS:
            dry_json = os.path.join(out_dir, f"dryrun_{part}.json")
            sp = part == SH_SP_PART
            drys[part] = (arch, cell, sp, subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.dryrun",
                 "--arch", arch, "--shape", cell, "--mesh", "single",
                 "--out", dry_json] + (["--sp"] if sp else []),
                env=dict(env, CUDA_VISIBLE_DEVICES=""),
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
                dry_json, time.perf_counter())
        was_deterministic = torch.are_deterministic_algorithms_enabled()
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            phase = _run_sharding(torch, seed, dev, kernels, mesh)
        finally:
            torch.use_deterministic_algorithms(was_deterministic)
        for part, _, _, key in SH_RANK0_PARTS:
            gc.collect()
            torch.cuda.empty_cache()
            phase[key] = _sharding_rank0_on_card(
                torch, seed, env, os.path.join(out_dir, f"rank0_{part}.json"),
                part, *drys[part])
    finally:
        for _, _, _, dry, _, _ in drys.values():
            if dry.poll() is None:
                dry.kill()
                dry.communicate()
    moe = phase["rank0_moe"]
    check(moe["launches"].get("moe_combine", 0) > 0, "phase sharding (f): "
          "the MoE combine's kernel did not launch")
    check("moe_combine" in moe["plain_replays"], "phase sharding (f): the "
          "MoE combine's largest launch was not replayed")
    for name, n in moe["launches"].items():
        phase["launches"][name] = phase["launches"].get(name, 0) + n
    for name, r in moe["plain_replays"].items():
        prev = phase["plain_replays"].get(name)
        if prev is not None:  # one kernel replayed twice
            r = {"what": f"{prev['what']}; {r['what']}",
                 "each": prev.get("each", [prev]) + [r],
                 "max_abs_err": max(prev["max_abs_err"], r["max_abs_err"])}
        phase["plain_replays"][name] = r
    sp = phase["rank0_sp"]
    lo, hi = SH_SP_PEAK_RATIO
    check(lo <= sp["peak_over_fake_temp"] <= hi, f"phase sharding (m): the "
          f"peak above resident is {sp['peak_over_fake_temp']:.4f} x the "
          f"fake temp_bytes, outside [{lo}, {hi}]")
    check(sp["resident_bytes"] + sp["peak_above_resident_bytes"]
          <= sp["card_bytes"], "phase sharding (m): the step held more "
          "than the card's memory")
    for part, arch, _, _ in SH_RANK0_PARTS:
        phase["reduced"].append(
            f"{arch} ({part}): one rank of 256 under a fake process group "
            f"(the other ranks' work and the wire not run)")
    return phase


def _sharding_rank0_on_card(torch, seed, env, out_json, part, arch, cell,
                            sp, dry, dry_json, t_dry) -> dict:
    """Part ``part`` ((e)-(h), (j)-(m)) of phase ``sharding``:
    :func:`sharding_rank0` on ``arch`` and ``cell`` (under ``use_sp`` when
    ``sp``) in a subprocess on the card, held to the host's dry-run of the
    same cell (the FLOPs as integers; the peak above resident against
    ``temp_bytes`` as a ratio, gated for (m) alone, by
    :func:`run_sharding`)."""
    what = f"phase sharding ({part})"
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, os.path.join(HERE, "chip_smoke.py"), "--seed",
         str(seed), "--sharding-rank0", out_json, "--rank0-arch", arch,
         "--rank0-shape", cell] + (["--rank0-sp"] if sp else []),
        env=env, capture_output=True, text=True, timeout=SH_TP_TIMEOUT_S)
    wall_s = time.perf_counter() - t0
    check(proc.returncode == 0, f"{what}: the rank-0 process exited "
          f"{proc.returncode}:\n{proc.stdout[-2000:]}{proc.stderr[-2000:]}")
    with open(out_json) as f:
        e = json.load(f)
    text, _ = dry.communicate(timeout=SH_TP_TIMEOUT_S)
    check(dry.returncode == 0, f"{what}: the dry-run exited "
          f"{dry.returncode}:\n{text[-2000:]}")
    with open(dry_json) as f:
        (rec,) = json.load(f)
    check(rec["status"] == "ok", f"{what}: the dry-run cell says "
          f"{rec['status']}")
    check(rec["sp"] == sp == e["sp"], f"{what}: use_sp {e['sp']} on the "
          f"card, {rec['sp']} in the dry-run, {sp} asked")
    check(int(e["flops"]) == int(rec["flops"]), f"{what}: the card counted "
          f"{int(e['flops'])} FLOPs, the fake tensors {int(rec['flops'])}")
    e.update(fake_flops=rec["flops"], fake_temp_bytes=rec["temp_bytes"],
             fake_arg_bytes=rec["arg_bytes"],
             fake_coll_bytes=rec["coll_bytes"],
             peak_over_fake_temp=e["peak_above_resident_bytes"]
             / rec["temp_bytes"],
             useful_flops_ratio=rec["useful_flops_ratio"],
             wall_s=wall_s, dry_wall_s=time.perf_counter() - t_dry,
             card=nvidia_smi_line())
    log(f"{what}: {e['arch']} {e['cell']}{' under use_sp' if sp else ''} "
        f"depth {e['depth']} on rank 0 of {e['mesh']} ({e['rows']} x "
        f"{e['seq_block']} tokens a rank), on {e['card']}: step "
        f"{e['step_ms']:.1f} ms (the fake collectives move nothing); peak "
        f"above resident "
        f"{e['peak_above_resident_bytes'] / 2**30:.2f} GiB = "
        f"{e['peak_over_fake_temp']:.4f} x the fake temp_bytes "
        f"({rec['temp_bytes'] / 2**30:.2f} GiB; resident "
        f"{e['resident_bytes'] / 2**30:.2f} GiB, fake arg_bytes "
        f"{rec['arg_bytes'] / 2**30:.2f} GiB); counted FLOPs "
        f"{int(e['flops'])} = the fake count; launches {e['launches']} "
        f"({wall_s:.1f} s, the dry-run {e['dry_wall_s']:.1f} s on the "
        f"host)")
    return e


def _placed_draws(torch, gen, mesh, metas, shardings, fill=None):
    """DTensors of the ``meta`` tensors' global shapes on ``shardings``
    (flat lists), this rank's shards drawn on the card: normals times
    0.02 in each leaf's dtype, or ``fill`` for an integer leaf."""
    from torch.distributed.tensor import DTensor

    from repro_torch.sharding.params import local_region

    out = []
    for x, sh in zip(metas, shardings):
        region = local_region(tuple(x.shape), mesh, sh.placements)
        shape = tuple(r.stop - r.start for r in region)
        if x.dtype.is_floating_point:
            local = (torch.randn(shape, generator=gen, device=gen.device,
                                 dtype=x.dtype) * 0.02)
        else:
            local = torch.full(shape, fill, dtype=x.dtype, device=gen.device)
        out.append(DTensor.from_local(local, mesh, sh.placements,
                                      run_check=False, shape=x.shape,
                                      stride=x.stride()))
    return out


def _rank0_train(torch, gen, mesh, model, cell, arch):
    """``(step, args)`` of a train cell on rank 0: f32 parameters and
    AdamW state on ``params_shardings``, the global batch on
    ``batch_shardings``."""
    from repro_torch import tree as TR
    from repro_torch.data.synthetic import input_specs
    from repro_torch.launch.shard_memory import fake_params
    from repro_torch.optim import adamw_init
    from repro_torch.sharding.params import (batch_shardings, distribute,
                                             params_shardings)
    from repro_torch.train import TrainHParams, make_train_step

    cfg, dev = model.cfg, gen.device
    meta = fake_params(arch)
    leaves, treedef = TR.flatten(meta)
    shs = TR.flatten_up_to(treedef, params_shardings(meta, mesh))
    params = TR.unflatten(treedef, _placed_draws(torch, gen, mesh, leaves,
                                                 shs))
    opt = adamw_init(params)
    specs = input_specs(cfg, cell)
    if "mrope_positions" in specs:
        # the VLM: labels, M-RoPE positions, and this rank's rows of the
        # patch embeddings drawn on the card (the global batch's are 17 GB)
        B, S = cell.global_batch, cell.seq_len
        batch = distribute(
            {"labels": torch.randint(0, cfg.vocab, (B, S), generator=gen,
                                     device=dev, dtype=torch.int32),
             "mrope_positions": torch.arange(
                 S, dtype=torch.int32, device=dev).expand(3, B, S)
             .contiguous()},
            batch_shardings({"labels": specs["labels"],
                             "mrope_positions": specs["mrope_positions"]},
                            mesh))
        emb = {"embeds": specs["embeds"]}
        (batch["embeds"],) = _placed_draws(
            torch, gen, mesh, [emb["embeds"]],
            [batch_shardings(emb, mesh)["embeds"]])
        return make_train_step(model, TrainHParams()), (params, opt, batch)
    toks = torch.randint(0, cfg.vocab, (cell.global_batch, cell.seq_len + 1),
                         generator=gen, device=dev, dtype=torch.int32)
    batch = {"tokens": toks[:, :-1].contiguous(),
             "labels": toks[:, 1:].contiguous()}
    frames = specs.get("embeds")
    if frames is not None:  # the encoder-decoder's frame embeddings
        batch["embeds"] = torch.randn(tuple(frames.shape), generator=gen,
                                      device=dev).to(frames.dtype)
    batch = distribute(batch, batch_shardings(batch, mesh))
    return make_train_step(model, TrainHParams()), (params, opt, batch)


def _rank0_serving(torch, gen, mesh, model, cell, arch):
    """``(step, args)`` of a serving cell on rank 0, as the dry-run lays
    it out: bf16 parameters on ``serve_shardings``, a prefill's prompts on
    ``batch_shardings``, a decode's caches on ``cache_shardings`` (every
    cache length at the cell's last position) and its tokens on
    ``batch_shardings``."""
    from repro_torch import tree as TR
    from repro_torch.data.synthetic import decode_inputs, input_specs
    from repro_torch.launch.dryrun import serve_param_sds, serve_shardings
    from repro_torch.launch.shard_memory import fake_params
    from repro_torch.sharding.params import (_map_caches, batch_shardings,
                                             cache_shardings, distribute)
    from repro_torch.train import (TrainHParams, make_decode_step,
                                   make_prefill_step)

    cfg, dev = model.cfg, gen.device
    meta = serve_param_sds(fake_params(arch))
    leaves, treedef = TR.flatten(meta)
    shs = TR.flatten_up_to(treedef, serve_shardings(meta, mesh))
    params = TR.unflatten(treedef, _placed_draws(torch, gen, mesh, leaves,
                                                 shs))
    if cell.kind == "prefill":
        batch = {}
        for k, x in input_specs(cfg, cell).items():
            batch[k] = (torch.randn(tuple(x.shape), generator=gen,
                                    device=dev).to(x.dtype)
                        if x.dtype.is_floating_point else
                        torch.randint(0, cfg.vocab, tuple(x.shape),
                                      generator=gen, device=dev,
                                      dtype=x.dtype))
        batch = distribute(batch, batch_shardings(batch, mesh))
        step = make_prefill_step(model, attn_chunk=TrainHParams().attn_chunk)
        return step, (params, batch)
    cache_meta, tok_meta = decode_inputs(cfg, cell, model)
    metas, flat_sh = [], []
    _map_caches(metas.append, cache_meta)
    _map_caches(flat_sh.append, cache_shardings(cache_meta, cfg, mesh,
                                                cell.global_batch))
    it = iter(_placed_draws(torch, gen, mesh, metas, flat_sh,
                            fill=cell.seq_len - 1))
    caches = _map_caches(lambda _: next(it), cache_meta)
    tok = torch.randint(0, cfg.vocab, tuple(tok_meta.shape), generator=gen,
                        device=dev, dtype=tok_meta.dtype)
    tok = distribute({"tok": tok}, batch_shardings({"tok": tok}, mesh))["tok"]
    return make_decode_step(model), (params, caches, tok)


def sharding_rank0(torch, seed: int, out_json: str,
                   arch: str = SH_TP_ARCH, cell_name: str = SH_TP_SHAPE,
                   use_sp: bool = False) -> None:
    """This process as rank 0 of the 16 x 16 production mesh under
    PyTorch's ``fake`` process group, on the card, on the cell
    ``cell_name`` (``arch``'s config under ``use_sp`` when asked, as the
    dry-run's ``--sp`` sets it): for a train cell ``arch``'s parameters
    (this rank's shards only, drawn on the card) and AdamW state placed by
    ``params_shardings`` and the global batch (:func:`_rank0_train`), for
    a serving cell the serving layout's bf16 parameters and a prefill's
    prompts or a decode's caches and tokens (:func:`_rank0_serving`); one
    step under ``analyze_step`` (its FLOPs and ``temp_bytes``), then one
    step timed (host ms ending in a synchronize) with its peak above
    resident and the kernels' launches, each count set to 0 just before
    it. The timed step's largest MoE combine, if any, is replayed through
    the plain fold afterwards at its shape on values drawn on the card,
    bitwise, and timed (:func:`combine_times`). Writes the numbers to
    ``out_json``."""
    import dataclasses
    import gc

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch import compat
    from repro_torch.configs import get_config
    from repro_torch.kernels import moe_combine as MC
    from repro_torch.launch import hlo_analysis as HA
    from repro_torch.launch.mesh import chips, production_mesh_shape
    from repro_torch.models import build_model
    from repro_torch.models import moe as MOE
    from repro_torch.models.common import SHAPES
    from repro_torch.models.layers import use_full_precision

    use_full_precision()
    dev = torch.device("cuda")
    torch.cuda.set_device(0)
    shape = production_mesh_shape()
    dist.init_process_group("fake", store=compat.fake_store()(), rank=0,
                            world_size=chips(shape))
    try:
        mesh = init_device_mesh("cuda", tuple(shape.shape),
                                mesh_dim_names=tuple(shape.axis_names))
        cfg = get_config(arch)
        if use_sp:
            cfg = dataclasses.replace(cfg, use_sp=True)
        cell = SHAPES[cell_name]
        model = build_model(cfg)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        if cell.kind == "train":
            step, args = _rank0_train(torch, gen, mesh, model, cell, arch)
        else:
            step, args = _rank0_serving(torch, gen, mesh, model, cell,
                                        arch)
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated(dev)
        out, roof = HA.analyze_step(step, *args)
        del out
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        # the largest combine's shape and type, not its values: those come
        # over the fake collectives, uninitialized
        largest, combine = {}, MOE.moe_combine_raw

        def keeping_combine(contrib):
            if contrib.numel() > largest.get("numel", 0):
                largest.update(numel=contrib.numel(),
                               shape=tuple(contrib.shape),
                               dtype=contrib.dtype)
            return combine(contrib)

        MOE.moe_combine_raw = keeping_combine
        MC.moe_combine_raw.launches = 0
        try:
            t0 = time.perf_counter()
            out = step(*args)
            torch.cuda.synchronize()
            step_ms = (time.perf_counter() - t0) * 1e3
        finally:
            MOE.moe_combine_raw = combine
        peak = torch.cuda.max_memory_allocated(dev) - resident
        launches = {"moe_combine": MC.moe_combine_raw.launches}
        del out, args
        gc.collect()
        torch.cuda.empty_cache()
        plain_replays, combine_t = {}, None
        if largest:  # values drawn on the card, replayed outside the count
            vals = torch.randn(largest["shape"], generator=gen,
                               device=dev).to(largest["dtype"])
            plain_replays["moe_combine"] = replay_through_plain(
                torch, MC.moe_combine_raw, MC.moe_combine_plain,
                ((vals,), {}),
                f"phase sharding: {cfg.arch_id}'s largest MoE combine on "
                f"rank 0 (its shape; values drawn)")
            combine_t = combine_times(torch, vals, plain=False)
            del vals
        rows = (cell.global_batch // mesh.size(0)
                if cell.global_batch % mesh.size(0) == 0
                else cell.global_batch)
        seq = 1 if cell.kind == "decode" else cell.seq_len
        res = {"arch": cfg.arch_id, "cell": cell.name, "sp": use_sp,
               "depth": cfg.n_layers, "enc_depth": cfg.n_enc_layers,
               "mesh": "x".join(str(n) for n in shape.shape),
               "rows": rows, "seq": seq,
               "seq_block": (seq // mesh.size(mesh.ndim - 1) if use_sp
                             else seq),
               "card_bytes": torch.cuda.get_device_properties(
                   dev).total_memory, "step_ms": step_ms,
               "resident_bytes": resident,
               "peak_above_resident_bytes": peak, "flops": roof.flops,
               "temp_bytes": roof.temp_bytes, "arg_bytes": roof.arg_bytes,
               "coll_bytes": roof.coll_bytes, "launches": launches,
               "plain_replays": plain_replays, "moe_combine": combine_t}
    finally:
        dist.destroy_process_group()
    with open(out_json, "w") as f:
        json.dump(res, f)


def serve_world1(torch, seed: int, dev, mesh, arch: str, depth, prompts,
                 n_tok: int) -> dict:
    """Phase ``sharding`` (i): ``arch`` (cut to ``depth`` layers, or
    whole) prefills ``prompts`` (B, S) and decodes ``n_tok`` greedy tokens
    through ``make_prefill_step`` / ``make_decode_step`` (chunks of 32 and
    128, as ``launch/serve.py``) on plain parameters, then on the same
    parameters placed by ``serve_shardings`` on the (1, 1) mesh with the
    prompts and tokens on ``batch_shardings``: every step's logits and
    the caches after prefill and after the last token bitwise. Host ms
    of each path's prefill and median token."""
    import dataclasses

    from torch.distributed.tensor import DTensor

    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import serve_shardings
    from repro_torch.models import build_model
    from repro_torch.sharding.params import (_map_caches, batch_shardings,
                                             distribute)
    from repro_torch.train import make_decode_step, make_prefill_step

    cfg = get_config(arch)
    if depth is not None:
        cfg = dataclasses.replace(cfg, n_layers=depth)
    model = build_model(cfg)
    params = model.init(seed, device=dev, on_device=True)
    B, S = prompts
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 28)
    toks = torch.randint(0, cfg.vocab, (B, S), generator=gen, device=dev,
                         dtype=torch.int32)
    prefill = make_prefill_step(model, attn_chunk=32, max_len=S + n_tok)
    decode = make_decode_step(model, attn_chunk=128)

    def whole(x):
        return x.full_tensor() if isinstance(x, DTensor) else x

    def flat(caches):
        out = []
        _map_caches(lambda x: out.append(whole(x)), caches)
        return out

    def run(p, place):
        t0 = time.perf_counter()
        lg, c = prefill(p, {"tokens": place(toks)})
        torch.cuda.synchronize()
        ms = [(time.perf_counter() - t0) * 1e3]
        logits, caches = [whole(lg)], [flat(c)]
        for _ in range(n_tok):
            tok = torch.argmax(logits[-1], -1).to(torch.int32)
            t0 = time.perf_counter()
            lg, c = decode(p, c, place(tok))
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            logits.append(whole(lg))
        caches.append(flat(c))
        return logits, caches, ms

    def plain(t):
        return t

    def placed(t):
        return distribute({"t": t}, batch_shardings({"t": t}, mesh))["t"]

    want_lg, want_c, plain_ms = run(params, plain)
    sp = distribute(params, serve_shardings(params, mesh))
    got_lg, got_c, placed_ms = run(sp, placed)
    what = f"phase sharding (i) {cfg.arch_id}"
    for n, (a, b) in enumerate(zip(want_lg, got_lg)):
        check(bitwise_equal(torch, a, b), f"{what}: step {n}'s logits "
              f"differ from the plain step's by "
              f"{float((a - b).abs().max())!r}")
    for label, a, b in (("prefill", want_c[0], got_c[0]),
                        ("the last token", want_c[1], got_c[1])):
        names = [f"cache leaf {k}" for k in range(len(a))]
        bad = first_mismatch(torch, names, a, b)
        check(not bad, f"{what}: the caches after {label} differ at {bad}")
    res = {"arch": cfg.arch_id, "depth": cfg.n_layers, "prompts": [B, S],
           "tokens": n_tok, "cache_leaves": len(want_c[0]),
           "plain_prefill_ms": plain_ms[0],
           "placed_prefill_ms": placed_ms[0],
           "plain_token_ms": statistics.median(plain_ms[1:]),
           "placed_token_ms": statistics.median(placed_ms[1:]),
           "bitwise": True}
    log(f"{what}: depth {cfg.n_layers}, {B} x {S} prompts and {n_tok} "
        f"tokens; the placed prefill and decode bitwise to the plain ones "
        f"(logits of every step, {res['cache_leaves']} cache leaves); "
        f"prefill {placed_ms[0]:.1f} ms placed, {plain_ms[0]:.1f} plain; "
        f"median token {res['placed_token_ms']:.2f} ms placed, "
        f"{res['plain_token_ms']:.2f} plain")
    return res


def _run_sharding(torch, seed, dev, kernels, mesh):
    """The body of :func:`run_sharding`."""
    import dataclasses
    import gc
    import tempfile

    from torch.distributed.tensor import DTensor

    from repro_torch import tree as TR
    from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
    from repro_torch.configs import get_config
    from repro_torch.data import make_batch
    from repro_torch.kernels import moe_combine as MC
    from repro_torch.kernels import topk_block, xla_add
    from repro_torch.models import build_model
    from repro_torch.models import moe as MOE
    from repro_torch.models.common import SHAPES
    from repro_torch.optim import adamw_init
    from repro_torch.runtime import DeltaPublisher, InProcTransport
    from repro_torch.sharding.params import (distribute, gathered,
                                             params_shardings)
    from repro_torch.train import TrainHParams, make_train_step
    from repro_torch.train import step as ST

    launches = dict.fromkeys(("topk_block", "xla_add", "moe_combine"), 0)
    plain_replays = {}

    def counted(fn):
        return count_launches(torch, kernels, launches, fn)

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    def sync_ms(t0: float) -> float:
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    # ---- (a) dense steps, plain and through the DTensor path -----------
    cfg = get_config(WL_ARCH)
    model = build_model(cfg)
    params0 = model.init(seed, device=dev, on_device=True)
    names = TR.flatten_with_names(params0)[1]
    B, S_len = WL_TRAIN_BATCH
    batches = [make_batch(cfg, SHAPES["train_4k"], s, batch_override=B,
                          seq_override=S_len, device=dev)
               for s in range(SH_STEPS)]
    step = make_train_step(model, TrainHParams(warmup=0, total_steps=100))
    sh = params_shardings(params0, mesh)

    def steps(p, label):
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        o, ms, mets, traj = adamw_init(p), [], [], []
        for b in batches:
            t = time.perf_counter()
            p, o, met = step(p, o, b)
            ms.append(sync_ms(t))
            mets.append(met)
            traj.append(p)
        peak = torch.cuda.max_memory_allocated(dev) - resident
        log(f"phase sharding (a) {label}: steps "
            f"{[round(x, 1) for x in ms]} ms, loss "
            f"{[round(float(m['loss']), 4) for m in mets]}, peak above "
            f"resident {peak / 2**30:.2f} GiB")
        return p, o, mets, traj, {"step_ms": ms,
                                  "median_step_ms": statistics.median(ms),
                                  "peak_above_resident_bytes": peak}

    p, o, mets, traj, plain_t = steps(params0, "plain")
    sp0 = distribute(params0, sh)
    check(all(isinstance(x, DTensor) for x in TR.leaves(sp0)),
          "phase sharding (a): a leaf was not placed as a DTensor")
    (sp, so, smets, _, sharded_t), used_a = counted(
        lambda: steps(sp0, "DTensor"))
    check(all(isinstance(m, DTensor) and m.placements == x.placements
              for x, m in zip(TR.leaves(sp) * 2, TR.leaves(so.mu)
                              + TR.leaves(so.nu))),
          "phase sharding (a): the moments do not take the params' "
          "placements")
    for i, (m, sm) in enumerate(zip(mets, smets)):
        for k in ("loss", "grad_norm", "lr"):
            check(bitwise_equal(torch, m[k], sm[k]), f"phase sharding (a): "
                  f"step {i}'s {k} {float(sm[k])!r} differs from the plain "
                  f"step's {float(m[k])!r}")
    full = gathered((sp, so.mu, so.nu))
    for kind, want, got in (("params", p, full[0]), ("mu", o.mu, full[1]),
                            ("nu", o.nu, full[2])):
        bad = first_mismatch(torch, names, TR.leaves(want), TR.leaves(got))
        check(not bad, f"phase sharding (a): the DTensor path's {kind} "
              f"differ from the plain path's at {bad}")
    a = {"arch": cfg.arch_id, "batch": [B, S_len], "steps": SH_STEPS,
         "params": sum(x.numel() for x in TR.leaves(params0)),
         "placements": sorted({repr(tuple(x.placements))
                               for x in TR.leaves(sp)}),
         "plain": plain_t, "dtensor": sharded_t,
         "step_ratio": (sharded_t["median_step_ms"]
                        / plain_t["median_step_ms"]),
         "launches": used_a, "bitwise": True}
    log(f"phase sharding (a): DTensor path bitwise to the plain path over "
        f"{SH_STEPS} steps; median step {sharded_t['median_step_ms']:.1f} "
        f"ms vs plain {plain_t['median_step_ms']:.1f} ms (ratio "
        f"{a['step_ratio']:.3f})")

    # ---- (c) the publisher with a mesh, on (a)'s trajectory -------------
    pubs = {}
    for label, m in (("none", None), ("mesh", mesh)):
        wire = InProcTransport()
        pub = DeltaPublisher(params0, wire, k_fraction=WL_K,
                             selector="block", device=dev, mesh=m)
        t = time.perf_counter()
        if m is None:
            for e in range(SH_EPOCHS):
                pub.publish(traj[e], epoch=e + 1)
            kept = {}
        else:
            (_, kept), used_c = counted(lambda: keeping_largest_each(
                {"topk_block": (topk_block, "topk_block_raw"),
                 "xla_add": (xla_add, "xla_add_raw")},
                lambda: [pub.publish(traj[e], epoch=e + 1)
                         for e in range(SH_EPOCHS)],
                required=("topk_block", "xla_add")))
        pubs[label] = {"frames": wire.poll(), "ms": sync_ms(t),
                       "placements": pub.ef_placements}
        del pub
    check(pubs["none"]["frames"] == pubs["mesh"]["frames"],
          "phase sharding (c): the publisher's frames with a mesh differ "
          "from those without one")
    with launches_uncounted(kernels):
        plain_replays["topk_block"] = replay_through_plain(
            torch, topk_block.topk_block_raw, topk_block.topk_block_plain,
            kept.pop("topk_block"), "phase sharding (c): the largest top-k")
        plain_replays["xla_add"] = replay_through_plain(
            torch, xla_add.xla_add_raw, xla_add.xla_add_plain,
            kept.pop("xla_add"), "phase sharding (c): the largest xla_add")
    del kept
    c = {"epochs": SH_EPOCHS, "frames": len(pubs["mesh"]["frames"]),
         "frame_bytes": sum(len(f) for f in pubs["mesh"]["frames"]),
         "byte_identical": True, "launches": used_c,
         "ef_placements": sorted({repr(tuple(x))
                                  for x in pubs["mesh"]["placements"]}),
         "publish_ms": {k: v["ms"] for k, v in pubs.items()}}
    log(f"phase sharding (c): {c['frames']} frames, {c['frame_bytes']} B, "
        f"byte-identical with and without the mesh; residuals "
        f"{c['ef_placements']}; launches {used_c}")
    del pubs, traj

    # ---- (d) the elastic checkpoint of (a)'s sharded state --------------
    state_sh = (sh, (None, sh, sh))
    with tempfile.TemporaryDirectory(prefix="sharding_ckpt_") as tmp:
        t = time.perf_counter()
        save_checkpoint(tmp, SH_STEPS, (sp, tuple(so)))
        save_ms = sync_ms(t)
        t = time.perf_counter()
        back = restore_checkpoint(tmp, SH_STEPS, (sp, tuple(so)), state_sh)
        restore_sharded_ms = sync_ms(t)
        t = time.perf_counter()
        flat = restore_checkpoint(tmp, SH_STEPS, (p, tuple(o)))
        restore_plain_ms = sync_ms(t)
    want = TR.leaves((p, tuple(o)))
    check(all(isinstance(x, DTensor) and x.placements == y.placements
              for x, y in zip(TR.leaves(back[0]), TR.leaves(sp))),
          "phase sharding (d): the restore did not land on the placements")
    for label, got in (("onto its placements", gathered(back)),
                       ("onto plain tensors", flat)):
        bad = first_mismatch(torch, names + ["step"] + names * 2, want,
                             TR.leaves(got))
        check(not bad, f"phase sharding (d): the restore {label} differs "
              f"at {bad}")
    d = {"leaves": len(want),
         "bytes": sum(x.numel() * x.element_size() for x in want),
         "save_ms": save_ms, "restore_sharded_ms": restore_sharded_ms,
         "restore_plain_ms": restore_plain_ms, "bitwise": True}
    log(f"phase sharding (d): {d['bytes'] / 2**30:.2f} GiB saved in "
        f"{save_ms:.0f} ms; restored onto the placements in "
        f"{restore_sharded_ms:.0f} ms and onto plain tensors in "
        f"{restore_plain_ms:.0f} ms, both bitwise")
    del back, flat, want, full, p, o, sp, so, sp0, params0, batches
    free()

    # ---- (b) Moonshot-16B-A3B at depth 1: the sharded gather and reduce -
    full_cfg = get_config(SH_MOE_ARCH)
    moe_model = build_model(dataclasses.replace(full_cfg, n_layers=1))
    mp = moe_model.init(seed, device=dev, on_device=True)
    mnames = TR.flatten_with_names(mp)[1]
    B2, S2 = SH_MOE_BATCH
    mb = make_batch(moe_model.cfg, SHAPES["train_4k"], 0, batch_override=B2,
                    seq_override=S2, device=dev)
    hp = TrainHParams()
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t = time.perf_counter()
    loss, grads = ST._accumulated_grads(moe_model, hp, TR.tree_map(
        lambda x: ST._to_compute(x, moe_model.cfg.cdtype), mp), mb)
    plain_ms = sync_ms(t)
    smp = distribute(mp, params_shardings(mp, mesh))
    del mp
    free()
    t = time.perf_counter()
    ((sloss, sgrads), kept), used_b = counted(lambda: keeping_largest_each(
        {"moe_combine": (MOE, "moe_combine_raw")},
        lambda: ST.sharded_loss_and_grads(moe_model, hp, smp, mb),
        required=("moe_combine",)))
    sharded_ms = sync_ms(t)
    peak = torch.cuda.max_memory_allocated(dev) - resident
    check(bitwise_equal(torch, loss, sloss), f"phase sharding (b): the "
          f"sharded loss {float(sloss)!r} differs from the plain "
          f"{float(loss)!r}")
    bad = first_mismatch(torch, mnames, grads,
                         TR.leaves(gathered(sgrads)))
    check(not bad, f"phase sharding (b): the sharded gradients differ at "
          f"{bad}")
    with launches_uncounted(kernels):
        plain_replays["moe_combine"] = replay_through_plain(
            torch, MC.moe_combine_raw, MC.moe_combine_plain,
            kept.pop("moe_combine"),
            "phase sharding (b): the MoE combine's largest launch")
    check(used_b.get("moe_combine", 0) > 0, "phase sharding (b): the MoE "
          "combine's kernel did not launch")
    b = {"arch": full_cfg.arch_id, "depth": 1,
         "layers_full": full_cfg.n_layers, "batch": [B2, S2],
         "params": sum(x.numel() for x in TR.leaves(smp)),
         "loss": float(loss), "plain_loss_grad_ms": plain_ms,
         "sharded_loss_grad_ms": sharded_ms,
         "peak_above_resident_bytes": peak, "launches": used_b,
         "bitwise": True}
    log(f"phase sharding (b): {b['arch']} depth 1, {b['params']} params, "
        f"loss {b['loss']:.4f}; sharded loss and gradients bitwise to the "
        f"plain ones ({sharded_ms:.0f} ms vs {plain_ms:.0f} ms, first "
        f"calls); launches {used_b}")
    del kept, smp, sgrads, grads, mb, moe_model
    free()

    # ---- (i) the placed serving steps at world 1 -------------------------
    i = {}
    for arch, depth, prompts, n_tok in SH_SERVE_WORLD1:
        i[arch], used_i = counted(lambda: serve_world1(
            torch, seed, dev, mesh, arch, depth, prompts, n_tok))
        i[arch]["launches"] = used_i
        free()
    check(i[SH_MOE_ARCH]["launches"].get("moe_combine", 0) > 0,
          "phase sharding (i): the MoE combine's kernel did not launch")
    for name in launches:
        check(launches[name] > 0, f"phase sharding: the {name} kernel did "
              f"not launch")
    return {"launches": launches, "plain_replays": plain_replays,
            "dense": a, "moe": b, "publisher": c, "checkpoint": d,
            "serving": i,
            "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)),
            "reduced": ["one chip: world 1 on a (1, 1) NCCL mesh (NCCL puts "
                        "no two ranks on one card)",
                        f"{SH_MOE_ARCH}: depth 1 of {full_cfg.n_layers}, "
                        f"batch {B2} x {S2} of train_4k's 256 x 4,096; "
                        f"serving (i) at depth "
                        f"{FAMILIES[SH_MOE_ARCH]['serve_depth']}",
                        f"{WL_ARCH}: batch {B} x {S_len} of train_4k's "
                        f"256 x 4,096"]}


#: Phase ``tools``: the dry-run cell run as a subprocess on the card's
#: host (a fake world; no card), and its time limit.
TOOLS_DRYRUN_CELL = ("--arch", "smollm-135m", "--shape", "train_4k",
                     "--mesh", "single")
TOOLS_DRYRUN_TIMEOUT_S = 600
#: The kernels the lint's geometry matrix must launch on the card: the
#: partitioned regimes', the sliding hash's, the merge paths' fold and the
#: allreduce's vec accumulator.
TOOLS_LINT_KERNELS = ("partition", "hash_slide", "segment_fold", "spa_accum")


def requested_bytes(torch, dev) -> int:
    """Bytes the caching allocator's live blocks were asked for (unrounded:
    the tensors' own sizes)."""
    return int(torch.cuda.memory_stats(dev)["requested_bytes.all.current"])


def run_tools(torch, seed: int, dev, kernels: dict, mesh):
    """Phase ``tools``: the port's dry-run, cost analysis and lint held to
    what the card does, on the script's (1, 1) NCCL mesh.

    (a) FLOPs: SmolLM-135M's dense step (phase ``workload``'s 8 x 2,048
    tokens) through the DTensor path under ``launch/hlo_analysis.py``'s
    ``analyze_step`` on the card, and on fake tensors of the same shapes:
    the two FLOP counts equal as integers; ``model_flops``, the counted
    FLOPs and their share of 989e12 x one unanalysed step's time. (b)
    Memory: the bytes the allocator holds for the params, AdamW state and
    batch placed on the mesh equal the analysed step's ``arg_bytes``, the
    fake step's, and ``launch/shard_memory.py``'s count (plus AdamW's
    step and the batch); the step's peak above resident beside the fake
    ``temp_bytes`` (their ratio reported, not gated). (c) Lint on the card:
    SPKJ201 and SPKJ202 over the geometry matrix on CUDA tensors (both sort
    counts, the wrappers' arguments and, through a recording proxy, the
    built libraries' C entry points), SPKJ203, and SPKJ204 against the
    card's opt-in shared memory a block: no active finding, and the proxy
    must have seen the kernels' calls. (d) ``python -m
    repro_torch.launch.dryrun`` on one cell (smollm-135m x train_4k x
    16x16, a fake world of 256 ranks on the host), started first and read
    last: its record must say ``ok``. Returns the phase's numbers."""
    import dataclasses
    import gc
    import tempfile

    from repro_torch import tree as TR
    from repro_torch.analysis import findings as LF
    from repro_torch.analysis import smem, trace_rules
    from repro_torch.compat import fake_tensor_mode
    from repro_torch.configs import get_config
    from repro_torch.data import make_batch
    from repro_torch.launch import hlo_analysis as HA
    from repro_torch.launch.dryrun import model_flops
    from repro_torch.launch.shard_memory import (STATE_BYTES,
                                                 per_rank_elements)
    from repro_torch.models import build_model
    from repro_torch.models.common import SHAPES
    from repro_torch.optim import adamw_init
    from repro_torch.sharding.params import distribute, params_shardings
    from repro_torch.train import TrainHParams, make_train_step

    # ---- (d) started first: the dry-run cell on the host's CPU ----------
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_dryrun_")
    out_json = os.path.join(out_dir, "dryrun.json")
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep
               + os.environ.get("PYTHONPATH", ""), CUDA_VISIBLE_DEVICES="")
    t_d = time.perf_counter()
    dry = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun",
         *TOOLS_DRYRUN_CELL, "--print-hlo-collectives", "--out", out_json],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    try:
        gc.collect()
        torch.cuda.empty_cache()
        cfg = get_config(WL_ARCH)
        model = build_model(cfg)
        B, S_len = WL_TRAIN_BATCH
        shape = dataclasses.replace(SHAPES["train_4k"], global_batch=B,
                                    seq_len=S_len)
        step = make_train_step(model, TrainHParams(warmup=0, total_steps=100))

        # ---- (b) what the placed state holds on the card ----------------
        torch.cuda.synchronize()
        req0 = requested_bytes(torch, dev)
        params0 = model.init(seed, device=dev, on_device=True)
        sp = distribute(params0, params_shardings(params0, mesh))
        del params0
        opt = adamw_init(sp)
        batch = make_batch(cfg, SHAPES["train_4k"], 0, batch_override=B,
                           seq_override=S_len, device=dev)
        gc.collect()
        torch.cuda.synchronize()
        resident = requested_bytes(torch, dev) - req0
        local = per_rank_elements(sp, mesh)
        batch_bytes = sum(x.numel() * x.element_size()
                          for x in batch.values())
        reckoned = local * STATE_BYTES + 4 + batch_bytes  # + AdamW's step

        # ---- (a) the analysed step on the card and on fake tensors ------
        _, real = HA.analyze_step(step, sp, opt, batch)
        torch.cuda.synchronize()
        gc.collect()
        alloc0 = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        t = time.perf_counter()
        step(sp, opt, batch)
        torch.cuda.synchronize()
        step_s = time.perf_counter() - t
        peak_above = torch.cuda.max_memory_allocated(dev) - alloc0
        with fake_tensor_mode()():
            fp = model.init(seed, device=dev)
            fsp = distribute(fp, params_shardings(fp, mesh))
            fbatch = {k: torch.empty(v.shape, dtype=v.dtype, device=dev)
                      for k, v in batch.items()}
            _, fake = HA.analyze_step(step, fsp, adamw_init(fsp), fbatch)
            del fp, fsp, fbatch
        check(int(real.flops) == int(fake.flops) and real.flops > 0,
              f"phase tools (a): {int(real.flops)} FLOPs counted on the card, "
              f"{int(fake.flops)} on fake tensors")
        mf = model_flops(cfg, shape, 1)
        a = {"arch": cfg.arch_id, "batch": [B, S_len],
             "flops_counted": int(real.flops),
             "flops_fake": int(fake.flops), "model_flops": mf,
             "step_ms": step_s * 1e3,
             "counted_share_of_peak": real.flops / (HA.PEAK_FLOPS * step_s),
             "model_share_of_peak": mf / (HA.PEAK_FLOPS * step_s),
             "hbm_bytes_counted": real.hbm_bytes,
             "hbm_bytes_fake": fake.hbm_bytes,
             "coll_by_kind": real.coll_by_kind}
        log(f"phase tools (a): {cfg.arch_id} dense step on {B} x {S_len}: "
            f"model_flops {mf:.4e}, counted {int(real.flops)} (card) = "
            f"{int(fake.flops)} (fake); one step {step_s * 1e3:.1f} ms: "
            f"counted {a['counted_share_of_peak']:.4f}, model "
            f"{a['model_share_of_peak']:.4f} of 989e12 FLOP/s; unfused bytes "
            f"{real.hbm_bytes:.4e} (fake {fake.hbm_bytes:.4e})")
        check(resident == real.arg_bytes == fake.arg_bytes == reckoned,
              f"phase tools (b): resident {resident} B, arg_bytes "
              f"{real.arg_bytes} (card) / {fake.arg_bytes} (fake), "
              f"shard_memory {local} x {STATE_BYTES} + 4 + batch "
              f"{batch_bytes} = {reckoned}")
        b = {"resident_bytes": resident, "arg_bytes": real.arg_bytes,
             "params": local, "state_bytes": local * STATE_BYTES + 4,
             "batch_bytes": batch_bytes,
             "peak_above_resident_bytes": peak_above,
             "temp_bytes_fake": fake.temp_bytes,
             "temp_bytes_card": real.temp_bytes,
             "peak_over_temp": peak_above / fake.temp_bytes}
        log(f"phase tools (b): resident {resident} B = arg_bytes = "
            f"shard_memory's {local} x {STATE_BYTES} + 4 + {batch_bytes}; "
            f"peak above resident {peak_above / 2**30:.3f} GiB, fake "
            f"temp_bytes {fake.temp_bytes / 2**30:.3f} GiB (ratio "
            f"{b['peak_over_temp']:.3f}; card temp_bytes "
            f"{real.temp_bytes / 2**30:.3f} GiB)")
        del sp, opt, batch
        gc.collect()
        torch.cuda.empty_cache()

        # ---- (c) the lint's trace rules on the card ---------------------
        def lint():
            return (trace_rules.trace_entry_points("cuda"),
                    trace_rules.check_step_tables(), smem.check_all("cuda"))

        t = time.perf_counter()
        (cells, steps_f, smem_f), used = count_launches(torch, kernels, {},
                                                        lint)
        lint_s = time.perf_counter() - t
        entry_f = trace_rules.entry_point_findings(cells)
        active = [f.render() for f in LF.active(entry_f + steps_f + smem_f)]
        check(not active, f"phase tools (c): active findings on the card: "
              f"{active[:4]}")
        entry_calls = sum(r["entry_calls"] for r in cells)
        wrapper_calls = sum(r["wrapper_calls"] for r in cells)
        check(entry_calls > 0 and wrapper_calls > 0,
              f"phase tools (c): the proxy saw {entry_calls} C entry calls "
              f"under {wrapper_calls} wrapper calls")
        missing = [k for k in TOOLS_LINT_KERNELS if not used.get(k)]
        check(not missing, f"phase tools (c): the geometry matrix launched "
              f"no {missing} kernel on the card")
        cap = smem.backend_cap("cuda")
        c = {"cells": len(cells), "wrapper_calls": wrapper_calls,
             "entry_calls": entry_calls, "launches": used,
             "smem_cap": cap, "smem_budget": smem.runtime_budget("cuda"),
             "lint_s": lint_s, "active_findings": 0}
        log(f"phase tools (c): SPKJ201-204 on the card: {len(cells)} cells, "
            f"{wrapper_calls} wrapper calls, {entry_calls} C entry calls, "
            f"launches {used}; shared-memory cap {cap} B a block (budget "
            f"{c['smem_budget']} B); no active finding ({lint_s:.1f} s)")

        # ---- (d) the dry-run cell's record ------------------------------
        text, _ = dry.communicate(timeout=TOOLS_DRYRUN_TIMEOUT_S)
    except BaseException:
        dry.kill()
        dry.communicate()
        raise
    dry_s = time.perf_counter() - t_d
    check(dry.returncode == 0, f"phase tools (d): the dry-run exited "
          f"{dry.returncode}:\n{text[-2000:]}")
    with open(out_json) as f:
        (rec,) = json.load(f)
    check(rec["status"] == "ok", f"phase tools (d): the dry-run cell "
          f"says {rec['status']}")
    d = {k: rec[k] for k in ("arch", "shape", "mesh", "chips", "status",
                             "trace_s", "model_flops_per_chip",
                             "useful_flops_ratio", "flops", "hbm_bytes",
                             "coll_bytes", "coll_by_kind", "coll_counts",
                             "bottleneck", "arg_bytes", "temp_bytes")}
    d["wall_s"] = dry_s
    log(f"phase tools (d): dry-run {rec['arch']} x {rec['shape']} x "
        f"{rec['mesh']}: {rec['status']}, flops/chip {rec['flops']:.4e}, "
        f"coll {rec['coll_bytes']:.4e} B, arg + temp "
        f"{(rec['arg_bytes'] + rec['temp_bytes']) / 2**30:.2f} GiB, "
        f"{rec['bottleneck']}-bound; traced in {rec['trace_s']} s "
        f"({dry_s:.1f} s with start-up)")
    return {"a": a, "b": b, "c": c, "d": d, "launches": used}


def run(args, torch) -> int:
    from repro_torch import obs
    from repro_torch.core import engine as E
    from repro_torch.core import sparse as S
    from repro_torch.core import spkadd as A
    from repro_torch.kernels import _build, hash_accum, hash_slide, ops as kops
    from repro_torch.kernels import moe_combine, partition, segment
    from repro_torch.kernels import spa_accum, topk_block, xla_add
    from repro_torch.launch import fold_timing, xla_add_timing

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
        "moe_combine": moe_combine.moe_combine_raw,
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
    # the tree call's profile, whose segment-fold records phase 14 holds to
    # its launches, taken while the process is young
    tree_profile = device_profile(
        torch, lambda: A.spkadd(mats, algorithm="tree"), family["tree"]["ms"],
        watch=("segment_fold",))
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

    # ---- 8. allreduce, 9. spgemm: over torch.distributed, one NCCL rank --
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = init_device_mesh("cuda", (1, 1),
                                mesh_dim_names=("data", "model"))
        phases["allreduce"], prof_allreduce = run_allreduce(
            torch, args.seed, dev, kernels, mesh)
        phases["allreduce"]["phase_s"] = took()
        phases["spgemm"], prof_spgemm = run_spgemm(torch, args.seed, dev,
                                                   kernels, mesh)
        phases["spgemm"]["phase_s"] = took()
        phases["workload"], prof_workload = run_workload(
            torch, args.seed, dev, kernels)
        phases["workload"]["phase_s"] = took()
        phases["families"], prof_families = run_families(
            torch, args.seed, dev, kernels)
        phases["families"]["phase_s"] = took()
        phases["sharding"] = run_sharding(torch, args.seed, dev, kernels,
                                          mesh)
        phases["sharding"]["phase_s"] = took()
        phases["tools"] = run_tools(torch, args.seed, dev, kernels, mesh)
        phases["tools"]["phase_s"] = took()
    finally:
        dist.destroy_process_group()

    # where the time of each phase's engine call goes, on the device
    profiles = {
        "vec": device_profile(torch, lambda: E.spkadd_auto(mats),
                              phases["vec"]["ms"]),
        "sorted": device_profile(
            torch, lambda: E.spkadd_run(mats, algorithm="sorted"),
            phases["sorted"]["ms"]),
        "hash": device_profile(torch, lambda: E.spkadd_batched(stacked),
                               phases["hash"]["ms"]),
        "family_tree": tree_profile,
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
        "allreduce_gather_kway": prof_allreduce,
        "spgemm_reduce_auto": prof_spgemm,
        **prof_workload,
        **prof_families,
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
    # the phases' xla_add launches are the publishers' and the means' adds
    # (DeltaPublisher.publish, sparsify_with_feedback) and their replays,
    # all on fresh allocations: every one must take the vector route
    xla_routes = dict(xla_add.xla_add_raw.routes)
    check(xla_routes["scalar"] == 0 and xla_routes["vector"] > 0,
          f"xla_add: the phases' launches took the routes {xla_routes}; "
          f"all should be vector")

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
        "library": "index_add_",
        **queued_times(
            torch, lambda: partition.partitioned_accumulate_raw(
                keys_p, vals_p, steps.chunk_id, steps.part_id, **pkw),
            part_bound[0],
            lambda: lib_acc.index_add_(0, lib_idx, vals_p[0])),
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
        **queued_times(torch, lambda: hash_slide.hash_slide_raw(
            cat2.keys, cat2.vals, **hkw), hash_bound[0]),
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
        **queued_times(
            torch, lambda: segment.segment_fold(v_s, gid, cat1.cap),
            seg_bound[0], lambda: seg_acc.index_add_(0, gid_long, v_s)),
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
        **queued_times(
            torch, lambda: spa_accum.spa_accumulate_raw(spa_keys, spa_vals,
                                                        **skw),
            spa_bound[0], lambda: spa_lib.index_add_(0, spa_idx, spa_vals),
            20),
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
        **queued_times(torch, lambda: hash_accum.hash_accumulate_raw(
            cat3.keys, cat3.vals, sent=sent3), acc_bound[0], calls=20),
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
        **queued_times(torch, lambda: hash_accum.hash_symbolic_raw(
            cat3.keys, sent=sent3), sym_bound[0],
            lambda: torch.unique(cat3.keys), 10),
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
        **queued_times(
            torch, lambda: topk_block.topk_block_raw(embed_x, **tkw),
            topk_bound[0],
            lambda: torch.topk(embed_blocks.abs(), per_e, dim=1)),
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
    # the wrapper's host time a call: 2,000 calls of final_ln's 576-element
    # add enqueued back to back, shorter on the card than on the host
    small_a, small_b = xa[:576].clone(), xb[:576].clone()
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
        **queued_times(torch, lambda: xla_add.xla_add_raw(
            xa, xb, subtract=True), xla_bound[0],
            lambda: torch.sub(xa, xb)),
        "host_us_576": xla_add_timing.host_us(
            lambda: xla_add.xla_add_raw(small_a, small_b)),
        "library_host_us_576": xla_add_timing.host_us(
            lambda: torch.add(small_a, small_b)),
        "geometry": xla_add.launch_geometry(n_x, True),
        "routes_main_path": xla_routes,
        "elements": n_x, "planted_subnormal_slots": 4096,
    })
    del xa, xb, plant, pick, small_a, small_b

    # moe_combine, at the families' combine shape (Moonshot's first layer
    # on 8 x 2,048 tokens), on bf16 values drawn on the card with
    # subnormals, signed zeros, infinities and NaNs of both signs planted
    # in a seeded sample of elements
    cshape = phases["families"]["moe_combine"]["shape"]
    cgen = torch.Generator(device=dev)
    cgen.manual_seed(args.seed + 29)
    contrib = torch.randn(cshape, generator=cgen, device=dev).to(
        torch.bfloat16)
    cplant = torch.randint(0, contrib.numel(), (65536,), generator=cgen,
                           device=dev)
    cedges = torch.tensor([0x0001, 0x8001, 0x007F, 0x807F, 0x8000, 0x7F80,
                           0xFF80, 0x7FC0, 0xFFC0, 0x7FA1], device=dev)
    cpick = torch.randint(0, cedges.numel(), (cplant.numel(),),
                          generator=cgen, device=dev)
    contrib.view(-1).view(torch.int16)[cplant] = (
        cedges[cpick] - ((cedges[cpick] & 0x8000) << 1)).to(torch.int16)
    got = moe_combine.moe_combine_raw(contrib)
    want = moe_combine.moe_combine_plain(contrib)
    check(bitwise_equal(torch, got, want),
          "moe_combine kernel differs from its plain version")
    both = torch.isfinite(got) & torch.isfinite(want)
    ctimes = combine_times(torch, contrib)
    report.append({
        "name": "moe_combine", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/moe_combine.cu",
        "replaces": "src/repro/models/moe.py:102",
        # the MoE's own path: phase families' decoders, counted from 0
        "launches": phases["families"]["launches"]["moe_combine"],
        "max_abs_err": float((got.float() - want.float())[both].abs().max()),
        **ctimes, "planted_elements": cplant.numel(),
        "families_d": phases["families"]["moe_combine"],
        "sharding_f": phases["sharding"]["rank0_moe"]["moe_combine"],
    })
    del contrib, cplant, cpick, got, want, both

    for r in report:
        # the later slices' paths, each counted from 0 around its run
        r["launches_allreduce"] = phases["allreduce"]["launches"].get(
            r["name"], 0)
        r["launches_spgemm"] = phases["spgemm"]["launches"].get(r["name"], 0)
        r["launches_workload"] = phases["workload"]["launches"].get(
            r["name"], 0)
        r["launches_families"] = phases["families"]["launches"].get(
            r["name"], 0)
        r["launches_sharding"] = phases["sharding"]["launches"].get(
            r["name"], 0)
        r["launches_tools"] = phases["tools"]["launches"].get(r["name"], 0)
        for ph in ("allreduce", "spgemm", "workload", "families",
                   "sharding"):
            # a launch of the later paths replayed through the plain version
            replay = phases[ph]["plain_replays"].get(r["name"])
            if replay is not None:
                r[f"replay_{ph}"] = replay
                r["max_abs_err"] = max(r["max_abs_err"],
                                       replay["max_abs_err"])
        check(r["launches"] > 0, f"{r['name']}: no launch on its path")
        check(r["max_abs_err"] == 0.0, f"{r['name']}: max_abs_err "
              f"{r['max_abs_err']}")
        check("queued_ms" in r and (r["library_ms"] is None
                                    or "library_queued_ms" in r),
              f"{r['name']}: a row without its queued times")
        log(f"{r['name']}: {r['ms']:.4f} ms, queued {r['queued_ms']:.4f} "
            f"(bound {r['bound_ms']:.4f} ms, plain {r['plain_ms']:.2f} ms, "
            f"library {r['library_ms']}, queued "
            f"{r.get('library_queued_ms')}) launches={r['launches']}")
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
