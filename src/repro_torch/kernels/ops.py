"""Launch geometry and public wrappers around the port's main-path kernels.

The port of the main-path half of ``src/repro/kernels/ops.py``: the
geometry formulas are the reference's, line for line, so at equal budgets
the port launches the same parts, tiles, tables and chunks. What differs is
the budget: the reference sizes tiles to 16 MiB of TPU VMEM, the port to
one thread block's shared memory on the card (:func:`device_smem_budget`).
``spa_accumulate*``, ``vec_accumulate*`` and ``hash_accumulate`` /
``hash_symbolic`` wait with their kernels.
"""
from __future__ import annotations

import typing as _t

import torch

from repro_torch import obs
from repro_torch.core.sparse import next_pow2 as _next_pow2
from repro_torch.kernels import hash_accum as _hash
from repro_torch.kernels import partition as _part

#: Default input chunk (the reference's ``spa_accum.DEFAULT_CHUNK``).
DEFAULT_CHUNK = 1024

#: The reference's VMEM budget, used for tensors on the CPU (see
#: :func:`device_smem_budget`).
REFERENCE_VMEM_BUDGET = 16 * 1024 * 1024


def _round_up(x: int, mult: int) -> int:
    return ((x + mult - 1) // mult) * mult


def _round_down(x: int, mult: int) -> int:
    return (x // mult) * mult


def device_smem_budget(device=None) -> int:
    """The launch-geometry budget for tensors on ``device`` (default: the
    current CUDA device).

    On a CUDA device: the per-block opt-in shared-memory limit (232,448 B on
    H100) less the main-path kernels' static shared memory — the bytes one
    block's tile or table plus its staged chunk may take. On the CPU, where
    the plain versions run and no such limit exists: the reference's 16 MiB
    VMEM budget, so that geometry and modelled counts there equal the
    reference's.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        return REFERENCE_VMEM_BUDGET
    if dev.type != "cuda":
        raise ValueError(f"no shared-memory budget for device {dev}")
    from repro_torch.kernels import _build

    index = dev.index if dev.index is not None else torch.cuda.current_device()
    return min(_build.max_dynamic_smem(name, index)
               for name in ("partition", "hash_slide"))


def choose_block_rows(m: int, n: int, smem_budget_bytes: int,
                      dtype_bytes: int = 4, lane_mult: int = 8) -> int:
    """Paper Alg. 7 line 3, with M := the budget: the largest sublane
    multiple of rows whose ``(rows, n)`` tile fits, rounded **down**,
    floored at ``lane_mult``."""
    budget_rows = max(1, smem_budget_bytes // max(1, n * dtype_bytes))
    block = min(_round_up(m, lane_mult), budget_rows)
    return max(lane_mult, _round_down(block, lane_mult))


def fold_working_set_bytes(fold: str, *, tile_elems: int, chunk: int) -> int:
    """The reference's working-set estimate of ONE step of a partitioned
    launch: the f32 tile, two in-flight ``(chunk,)`` key/value blocks (8 B
    per element) and, for the one-hot fold only, the ``(chunk, tile_elems)``
    one-hot plus its iota (8 B per cell). It describes the reference's
    launches; the port's partition kernel holds only the tile in shared
    memory."""
    out_tile = tile_elems * 4
    inputs = 2 * chunk * 8
    inter = chunk * tile_elems * 8 if fold == "onehot" else 0
    return out_tile + inputs + inter


# ---------------------------------------------------------------------------
# one-pass stream-partitioned launch (kernels/partition.py)
# ---------------------------------------------------------------------------

class PartitionGeometry(_t.NamedTuple):
    """Static launch geometry of the one-pass partitioned launch."""

    part_elems: int  # flat accumulator tile size (f32 elements)
    parts: int       # number of tiles covering m*n
    chunk: int       # input chunk length (power of two)
    num_chunks: int  # padded stream length / chunk
    max_steps: int   # static bound on (chunk, part) steps


def partitioned_launch_geometry(cap: int, *, m: int, n: int,
                                part_elems: int | None = None,
                                smem_budget_bytes: int = REFERENCE_VMEM_BUDGET,
                                chunk: int | None = None) -> PartitionGeometry:
    """Geometry the partitioned launch uses for a ``cap``-long stream.

    The reference's formula: the two in-flight ``(chunk,)`` key/value
    blocks get at most half the budget (``chunk`` halves, staying a power
    of two, floored at 8), and ``part_elems`` is the largest lane multiple
    whose f32 tile fits the rest, rounded down, floored at the lane
    multiple, clipped to the accumulator. On the card the kernel reads
    chunks straight from device memory, so the tile alone is what must fit
    shared memory — and it does, with the input term to spare.
    """
    mn = m * n
    if chunk is None:
        chunk = min(DEFAULT_CHUNK, _next_pow2(max(cap, 8)))
        while chunk > 8 and 2 * chunk * 8 > smem_budget_bytes // 2:
            chunk //= 2
    if part_elems is None:
        input_bytes = 2 * chunk * 8
        budget_elems = max(1, (smem_budget_bytes - input_bytes) // 4)
        part_elems = max(_part.LANE_MULT,
                         _round_down(budget_elems, _part.LANE_MULT))
        part_elems = min(part_elems, _round_up(mn, _part.LANE_MULT))
    parts = max(1, (mn + part_elems - 1) // part_elems)
    cap_pad = _round_up(max(cap, 1), chunk)
    num_chunks = cap_pad // chunk
    obs.counter("kernels.partition.geometry_calls").inc()
    obs.gauge("kernels.partition.parts").set(parts)
    obs.gauge("kernels.partition.part_elems").set(part_elems)
    obs.gauge("kernels.partition.chunk").set(chunk)
    obs.gauge("kernels.partition.num_chunks").set(num_chunks)
    return PartitionGeometry(part_elems=part_elems, parts=parts, chunk=chunk,
                             num_chunks=num_chunks,
                             max_steps=num_chunks + parts)


def partitioned_accumulate_flat(keys_sorted: torch.Tensor,
                                vals_sorted: torch.Tensor,
                                chunk_id: torch.Tensor, part_id: torch.Tensor,
                                *, m: int, n: int, part_elems: int, parts: int,
                                chunk: int) -> torch.Tensor:
    """One-pass partitioned accumulate -> flat f32 in key order (col-major),
    so ``flat[..., key]`` is the accumulated value of ``key``.

    Does **not** sort: it takes the canonically sorted, sentinel-padded
    stream and the step tables straight from ``sparse.plan_and_partition``.
    Accepts ``(cap_pad,)`` streams or ``(B, cap_pad)`` batched stacks (with
    ``(B, max_steps)`` tables).
    """
    squeeze = keys_sorted.dim() == 1
    if squeeze:
        keys_sorted, vals_sorted = keys_sorted[None], vals_sorted[None]
        chunk_id, part_id = chunk_id[None], part_id[None]
    flat = _part.partitioned_accumulate_raw(
        keys_sorted.to(torch.int32), vals_sorted.to(torch.float32),
        chunk_id, part_id, mn=m * n, part_elems=part_elems, parts=parts,
        chunk=chunk)[:, :m * n]
    return flat[0] if squeeze else flat


# ---------------------------------------------------------------------------
# sort-free sliding-hash launch (kernels/hash_slide.py)
# ---------------------------------------------------------------------------

class HashGeometry(_t.NamedTuple):
    """Static launch geometry of the sliding-hash launch."""

    table_size: int  # slots per part table (power of two, 8 B per slot)
    parts: int       # number of key-range parts covering m*n
    part_span: int   # key-range width owned by one part
    chunk: int       # input chunk length (power of two)
    num_chunks: int  # padded stream length / chunk


def hash_launch_geometry(cap: int, *, m: int, n: int,
                         smem_budget_bytes: int = REFERENCE_VMEM_BUDGET,
                         chunk: int | None = None) -> HashGeometry:
    """Geometry the sliding-hash launch uses for a ``cap``-long stream.

    The reference's formula: the input blocks get at most half the budget,
    then the table takes the rest at 8 bytes per slot. If one table sized by
    ``hash_table_size`` for the whole stream fits, ``parts == 1`` and the
    stream is read once. Otherwise the table is the largest fitting power of
    two (floored at 128 slots), each part owns ``table_size // 2`` keys, and
    the stream is read once per part. On the card the kernel stages one
    chunk (half the input term) beside its table.
    """
    mn = m * n
    if chunk is None:
        chunk = min(DEFAULT_CHUNK, _next_pow2(max(cap, 8)))
        while chunk > 8 and 2 * chunk * 8 > smem_budget_bytes // 2:
            chunk //= 2
    input_bytes = 2 * chunk * 8
    full_table = _hash.hash_table_size(min(max(cap, 1), mn))
    if full_table * 8 + input_bytes <= smem_budget_bytes:
        table_size, part_span, parts = full_table, mn, 1
    else:
        budget_slots = max(1, (smem_budget_bytes - input_bytes) // 8)
        table_size = max(128, _next_pow2(budget_slots + 1) // 2)
        part_span = table_size // 2
        parts = (mn + part_span - 1) // part_span
    cap_pad = _round_up(max(cap, 1), chunk)
    num_chunks = cap_pad // chunk
    obs.counter("kernels.hash_slide.geometry_calls").inc()
    obs.gauge("kernels.hash_slide.table_size").set(table_size)
    obs.gauge("kernels.hash_slide.parts").set(parts)
    obs.gauge("kernels.hash_slide.chunk").set(chunk)
    obs.gauge("kernels.hash_slide.num_chunks").set(num_chunks)
    return HashGeometry(table_size=table_size, parts=parts,
                        part_span=part_span, chunk=chunk,
                        num_chunks=num_chunks)


def hash_slide_tables(keys: torch.Tensor, vals: torch.Tensor, *, m: int,
                      n: int, table_size: int, part_span: int, parts: int,
                      chunk: int):
    """Sort-free sliding-hash accumulate -> raw part tables.

    Takes ``(B, cap)`` streams in **arbitrary order**, masks keys outside
    ``[0, m*n)`` to the sentinel, pads to a chunk multiple with sentinels,
    launches, and returns ``(tkeys, tvals)`` of shape
    ``(B, parts * table_size)`` with ``tkeys == -1`` marking empty slots.
    Compaction (the single counted sort) is the caller's job.
    """
    from repro_torch.kernels import hash_slide as _hslide

    B, cap = keys.shape
    mn = m * n
    valid = keys < mn
    cap_pad = _round_up(max(cap, 1), chunk)
    keys_p = torch.full((B, cap_pad), mn, dtype=torch.int32,
                        device=keys.device)
    vals_p = torch.zeros((B, cap_pad), dtype=torch.float32,
                         device=keys.device)
    keys_p[:, :cap] = torch.where(valid, keys, mn)
    vals_p[:, :cap] = torch.where(valid, vals.to(torch.float32), 0.0)
    return _hslide.hash_slide_raw(keys_p, vals_p, mn=mn,
                                  table_size=table_size, part_span=part_span,
                                  parts=parts, chunk=chunk)
