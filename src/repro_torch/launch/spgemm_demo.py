"""Distributed SpGEMM (sparse SUMMA) with each SpKAdd reduction, timed.

The twin of ``examples/distributed_spgemm.py`` and
``benchmarks/fig6_spgemm.py``: C = A @ B for two seeded sparse matrices
(A 512 × 512 and B 512 × 256 at 5 % density, the reference scripts'
draws), through :func:`repro_torch.core.spgemm.spgemm_summa` once for
each reduction algorithm, printing its time and its max|err| against
``A @ B``; then the Fig. 6 lines, with each stage's partial capped at
10 % of the C block.

    PYTHONPATH=src python -m repro_torch.launch.spgemm_demo            # the card
    PYTHONPATH=src python -m repro_torch.launch.spgemm_demo --device cpu

On the CPU it spawns a 2 × 2 grid of gloo ranks
(:func:`repro_torch.launch.world.spawn_world`); on the card it runs one
NCCL rank, a 1 × 1 grid, the only world one card allows.
"""
from __future__ import annotations

import argparse
import statistics
import time
from typing import Dict, List, Sequence, Tuple

import numpy as np

#: The reduction algorithms of ``examples/distributed_spgemm.py``.
ALGORITHMS = ("incremental", "tree", "sorted", "spa", "vec", "auto")
#: Those of ``benchmarks/fig6_spgemm.py``, with its partial cap: 10 % of
#: the C block.
FIG6_ALGORITHMS = ("incremental", "tree", "sorted", "spa")
FIG6_CAP_FRACTION = 0.1
#: The reference scripts' draws: A is M × K, B is K × N, at this density
#: from this seed.
SHAPE = (512, 512, 256)
DENSITY = 0.05
SEED = 0

#: ``(label, algorithm, partial_cap_per_stage or None)``.
Case = Tuple[str, str, object]


def sprand_pair(seed: int, m: int, k: int, n: int, density: float
                ) -> Tuple[np.ndarray, np.ndarray]:
    """A (m × k) and B (k × n), f32, ``int(rows·cols·density)`` standard
    normal nonzeros each at distinct positions: the draws of the reference
    scripts' ``sprand`` from ``np.random.default_rng(seed)``."""
    rng = np.random.default_rng(seed)

    def sprand(rows, cols):
        d = np.zeros((rows, cols), np.float32)
        nz = int(rows * cols * density)
        idx = rng.choice(rows * cols, nz, replace=False)
        d.flat[idx] = rng.standard_normal(nz)
        return d

    a = sprand(m, k)
    return a, sprand(k, n)


def summa_rank(rank: int, world: int, grid: Tuple[int, int], device: str,
               shape: Tuple[int, int, int], density: float, seed: int,
               cases: Sequence[Case], reps: int) -> Dict[str, dict]:
    """One rank of the grid: its blocks of A and B, then for each case a
    warm-up call, ``reps`` timed calls (median ms, host clock ending in a
    device synchronize) and the whole C gathered from every rank's block.
    Returns ``{label: {"c": C, "ms": ms}}``."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.core.spgemm import gather_tiled, spgemm_summa

    p_r, p_c = grid
    m, k, n = shape
    mesh = init_device_mesh(device, grid, mesh_dim_names=("data", "model"))
    d, t = mesh.get_coordinate()
    a_np, b_np = sprand_pair(seed, m, k, n, density)
    mb, kb_a, kb_b, nb = m // p_r, k // p_c, k // p_r, n // p_c
    a = torch.from_numpy(a_np[d * mb:(d + 1) * mb,
                              t * kb_a:(t + 1) * kb_a].copy()).to(device)
    b = torch.from_numpy(b_np[d * kb_b:(d + 1) * kb_b,
                              t * nb:(t + 1) * nb].copy()).to(device)

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()
        dist.barrier()

    out = {}
    for label, alg, cap in cases:
        def call():
            return spgemm_summa(a, b, mesh, algorithm=alg,
                                partial_cap_per_stage=cap)

        c = call()
        times = []
        for _ in range(reps):
            sync()
            t0 = time.perf_counter()
            c = call()
            sync()
            times.append((time.perf_counter() - t0) * 1e3)
        blocks = gather_tiled(c, None, axis=0)  # rank-major blocks
        full = blocks.view(p_r, p_c, mb, nb).permute(0, 2, 1, 3)
        out[label] = {"c": full.reshape(m, n).cpu().numpy(),
                      "ms": statistics.median(times)}
    return out


def cases_for(m: int, n: int, grid: Tuple[int, int],
              algorithms: Sequence[str] = ALGORITHMS,
              fig6_algorithms: Sequence[str] = FIG6_ALGORITHMS) -> List[Case]:
    """The example's cases (no cap), then Fig. 6's (cap 10 % of the C
    block, ``int(M·N·0.1 / (p_r·p_c))`` as the benchmark writes it)."""
    cap = int(m * n * FIG6_CAP_FRACTION / (grid[0] * grid[1]))
    return ([(alg, alg, None) for alg in algorithms]
            + [(f"fig6/{alg}", alg, cap) for alg in fig6_algorithms])


def run(device: str, shape: Tuple[int, int, int] = SHAPE, *,
        density: float = DENSITY, seed: int = SEED,
        cases: Sequence[Case] | None = None, reps: int = 3,
        timeout: float = 600.0) -> Tuple[Tuple[int, int], Dict[str, dict]]:
    """``(grid, rank 0's results)``: a 2 × 2 gloo world on the CPU, one
    NCCL rank on the card."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch.world import spawn_world

    grid = (2, 2) if device == "cpu" else (1, 1)
    cases = list(cases if cases is not None else cases_for(
        shape[0], shape[2], grid))
    args = (grid, device, shape, density, seed, cases, reps)
    if device == "cpu":
        return grid, spawn_world(summa_rank, 4, *args, timeout=timeout)[0]
    if device != "cuda":
        raise ValueError(f"device {device!r}: choose 'cuda' or 'cpu'")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --device cpu")
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        return grid, summa_rank(0, 1, *args)
    finally:
        dist.destroy_process_group()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    m, k, n = SHAPE
    grid, res = run(args.device, SHAPE, density=DENSITY, seed=SEED)
    a, b = sprand_pair(SEED, m, k, n, DENSITY)
    ref = a @ b
    print(f"C = A({m}x{k}, {DENSITY:.0%} dense) @ B({k}x{n}) on a "
          f"{grid[0]}x{grid[1]} SUMMA grid ({args.device}); the fig6 lines "
          f"(us) keep each stage's {cases_for(m, n, grid)[-1][2]} heaviest "
          f"entries, so their error includes what the cap drops")
    for label, r in res.items():
        err = float(np.abs(r["c"] - ref).max())
        if label.startswith("fig6/"):
            print(f"fig6/summa_reduction={label[5:]},{r['ms'] * 1e3:.1f},"
                  f"{grid[0]}x{grid[1]}grid max|err|={err:.2e}")
        else:
            print(f"  reduction={label:12s} {r['ms']:8.1f} ms  "
                  f"max|err|={err:.2e}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
