"""Input generators, drawn from a seed, made on the device in a few large
calls so set-up stays short. The laws that place nonzeros are files of
their own (``laws/<law>.py``), named by a configuration or traffic file.

* :func:`graph_stripes`: a SUMMA worker's stripes of a graph's adjacency
  matrix, as Graph500's specification builds the graph (edges placed by a
  law, labels permuted, weights uniform in [0, 1));
* :func:`coo_pushes` is ``launch/stream_serve.py``'s ``make_matrix``
  (``nnz`` distinct positions of an ``m x n`` block, standard normal f32
  values, keyed ``col * m + row`` and sorted), drawn as COO directly, its
  positions by a law (``make_matrix``'s is ``uniform``);
* :func:`stream_events` is ``launch/stream_serve.py``'s ``build_workload``
  (exponential interarrivals a tenant, scheduler ticks, pushes before ticks
  at equal times).

The same seed gives the same inputs; the draws differ from the originals'
(numpy there, a ``torch.Generator`` on the device here).
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from spkbench.reference import laws

#: Smallest normal float32: a smaller value is zero to the port's adds.
F32_TINY = 2.0 ** -126


def seed_sequence(seed: int, *path: int) -> np.random.SeedSequence:
    """A SeedSequence for ``seed`` (any whole number) and a purpose path."""
    return np.random.SeedSequence([seed % (1 << 64), *path])


def torch_generator(seed: int, path: Sequence[int], device) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded from ``seed`` and
    ``path``."""
    state = int(seed_sequence(seed, *path).generate_state(1, np.uint64)[0])
    gen = torch.Generator(device=device)
    gen.manual_seed(state)
    return gen


def graph_stripes(gen: torch.Generator, graph: dict, *, scale: int,
                  edgefactor: int, tile: int, device) -> tuple:
    """Worker (0, 0)'s stripes of the symmetric adjacency matrix ``A = E +
    E^T`` of a graph on ``2^scale`` vertices: ``A[:tile, :]`` and ``A[:,
    :tile]``, dense f32. ``E`` holds ``edgefactor * 2^scale`` edges placed
    by the law ``graph["positions"]``, their labels permuted where
    ``graph["permute_labels"]`` says so, with weights uniform in [0, 1)
    (Graph500's SSSP weights); edges that meet add. The adds run in
    float64, where they are exact, so the stripes do not depend on the
    order the device adds them in."""
    nv = 1 << scale
    ne = edgefactor * nv
    i, j = laws.positions(graph["positions"], gen, ne, m=nv, n=nv,
                          device=device)
    if graph["permute_labels"]:
        perm = torch.randperm(nv, generator=gen, device=device)
        i, j = perm[i], perm[j]
    w = torch.rand(ne, generator=gen, device=device).double()
    rows, cols, vals = torch.cat([i, j]), torch.cat([j, i]), torch.cat([w, w])
    keep = rows < tile
    a = torch.zeros((tile, nv), dtype=torch.float64, device=device)
    a.index_put_((rows[keep], cols[keep]), vals[keep], accumulate=True)
    a = a.float()
    return a, a.T.contiguous()


class Pushes(NamedTuple):
    """``count`` pushes of ``nnz`` entries each: ``keys`` int32 ``(count,
    nnz)`` sorted and distinct in each row, ``vals`` f32 ``(count, nnz)``,
    every value normal (none is zero to the port's adds)."""
    keys: torch.Tensor
    vals: torch.Tensor


def _draw_keys(gen, rows: int, nnz: int, *, m: int, n: int, law: dict,
               device) -> torch.Tensor:
    row, col = laws.positions(law, gen, rows * nnz, m=m, n=n, device=device)
    return (col * m + row).view(rows, nnz)


def coo_pushes(gen: torch.Generator, count: int, *, m: int, n: int,
               nnz: int, law: dict, device,
               block: int = 8192, max_rounds: int = 256) -> Pushes:
    """``count`` pushes of ``nnz`` distinct positions each, drawn by the law
    ``law`` (``laws/<law>.py``), in blocks of ``block`` pushes:
    a position drawn twice in one push is drawn again until none is."""
    if nnz > m * n:
        raise ValueError(f"{nnz} distinct positions do not fit {m} x {n}")
    out_k = torch.empty((count, nnz), dtype=torch.int32, device=device)
    for lo in range(0, count, block):
        rows = min(block, count - lo)
        k = _draw_keys(gen, rows, nnz, m=m, n=n, law=law, device=device)
        for _ in range(max_rounds):
            k = torch.sort(k, dim=1).values
            dup = torch.zeros_like(k, dtype=torch.bool)
            dup[:, 1:] = k[:, 1:] == k[:, :-1]
            if not bool(dup.any()):
                break
            fresh = _draw_keys(gen, rows, nnz, m=m, n=n, law=law,
                               device=device)
            k = torch.where(dup, fresh, k)
        else:
            raise RuntimeError(f"no {nnz} distinct positions after "
                               f"{max_rounds} rounds of draws")
        out_k[lo:lo + rows] = k.to(torch.int32)
    vals = torch.randn((count, nnz), generator=gen, device=device)
    for _ in range(max_rounds):
        tiny = vals.abs() < F32_TINY
        if not bool(tiny.any()):
            break
        vals = torch.where(tiny, torch.randn(vals.shape, generator=gen,
                                             device=device), vals)
    return Pushes(keys=out_k, vals=vals)


class Events(NamedTuple):
    """The merged event stream, sorted by time: ``t`` (simulated seconds),
    ``tenant`` (-1 for a scheduler tick) and ``push`` (the index of the
    push an arrival carries, -1 for a tick). Arrivals come before ticks
    at equal times, then in the order they were drawn."""
    t: np.ndarray
    tenant: np.ndarray
    push: np.ndarray


def stream_events(seed: int, *, tenants: int, rate: float, sim_seconds: float,
                  tick_every: float) -> Events:
    """Open-loop arrivals at ``rate`` a tenant a simulated second, for
    ``sim_seconds``, and a tick every ``tick_every`` (``build_workload``).
    Arrival ``i`` in time order carries push ``i``."""
    if tenants < 1 or rate <= 0 or sim_seconds <= 0 or tick_every <= 0:
        raise ValueError("need tenants >= 1 and positive rate, sim_seconds "
                         "and tick_every")
    rng = np.random.default_rng(seed_sequence(seed, 2))
    expect = rate * sim_seconds
    draws = int(expect + 8 * np.sqrt(expect) + 16)
    ts, who = [], []
    for i in range(tenants):
        t = np.cumsum(rng.exponential(1.0 / rate, size=draws))
        if t[-1] < sim_seconds:
            raise RuntimeError("too few interarrival draws")  # never at 8 sigma
        t = t[t < sim_seconds]
        ts.append(t)
        who.append(np.full(t.size, i, dtype=np.int64))
    n_ticks = int(np.ceil(sim_seconds / tick_every))
    t = np.concatenate(ts + [tick_every * np.arange(1, n_ticks + 1)])
    tenant = np.concatenate(who + [np.full(n_ticks, -1, dtype=np.int64)])
    is_tick = tenant < 0
    order = np.lexsort((np.arange(t.size), is_tick, t))
    t, tenant = t[order], tenant[order]
    push = np.full(t.size, -1, dtype=np.int64)
    arrivals = tenant >= 0
    push[arrivals] = np.arange(int(arrivals.sum()))
    return Events(t=t, tenant=tenant, push=push)
