"""Launch geometry and public wrappers around the port's kernels.

The port of ``src/repro/kernels/ops.py``: the geometry formulas are the
reference's, line for line, so at equal budgets the port launches the same
parts, tiles, tables and chunks. What differs is the budget: the reference
sizes tiles to 16 MiB of TPU VMEM, the port to one thread block's shared
memory on the card (:func:`device_smem_budget`; for the dense SPA tile,
:func:`spa_tile_budget`). The wrappers pad streams, launch, and compact raw
kernel outputs back to the PaddedCOO calling convention.
"""
from __future__ import annotations

import typing as _t

import torch

from repro_torch import obs
from repro_torch.core.sparse import next_pow2 as _next_pow2
from repro_torch.core.sparse import stable_argsort as _stable_argsort
from repro_torch.kernels import hash_accum as _hash
from repro_torch.kernels import partition as _part
from repro_torch.kernels import spa_accum as _spa
from repro_torch.kernels import topk_block as _topk
from repro_torch.kernels import vec_accum as _vec
from repro_torch.kernels.spa_accum import DEFAULT_CHUNK

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


#: The dense SPA tile the port sizes to on a CUDA card (bytes): one warp
#: folds each part's bucket into its tile, so a small tile keeps many warps
#: on each SM (see :func:`spa_tile_budget`).
SPA_TILE_BYTES = 16 * 1024


def spa_tile_limit(device=None) -> int:
    """The largest dense SPA tile (bytes) the fold kernel takes on a CUDA
    ``device``: :func:`device_smem_budget` less the stage the fold keeps
    beside its tile (``spa_accum.stage_bytes``)."""
    return device_smem_budget(device) - _spa.stage_bytes()


def spa_tile_budget(device=None) -> int:
    """The budget the dense SPA tile is sized to (paper Alg. 7's M) for
    tensors on ``device``: on the CPU the reference's 16 MiB, so that the
    geometry there is the reference's; on the card :data:`SPA_TILE_BYTES`,
    within :func:`spa_tile_limit`, since ``choose_block_rows`` counts the
    tile alone and the tile and the fold's stage must fit one block
    together."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        return min(SPA_TILE_BYTES, spa_tile_limit(dev))
    return device_smem_budget(dev)


def pad_stream(keys: torch.Tensor, vals: torch.Tensor, mn: int, chunk: int):
    """Pad a stream to a chunk multiple with sentinel keys ``mn`` and zero
    values; keys ``>= mn`` become the sentinel, their values ``0.0``."""
    cap = keys.shape[0]
    cap_pad = _round_up(max(cap, 1), chunk)
    valid = keys < mn
    keys_p = torch.full((cap_pad,), mn, dtype=torch.int32, device=keys.device)
    vals_p = torch.zeros((cap_pad,), dtype=torch.float32, device=keys.device)
    keys_p[:cap] = torch.where(valid, keys, mn)
    vals_p[:cap] = torch.where(valid, vals.to(torch.float32), 0.0)
    return keys_p, vals_p


# ---------------------------------------------------------------------------
# sliding dense SPA and vec launches (kernels/spa_accum.py)
# ---------------------------------------------------------------------------

def spa_accumulate(keys: torch.Tensor, vals: torch.Tensor, *, m: int, n: int,
                   block_rows: int | None = None,
                   smem_budget_bytes: int | None = None,
                   chunk: int = DEFAULT_CHUNK) -> torch.Tensor:
    """Sliding blocked-SPA accumulate -> dense ``(m, n)`` f32.

    Pads the stream to a chunk multiple (sentinel keys), sizes the row block
    to the budget (default :func:`spa_tile_budget` of the keys' device),
    accumulates with the ``serial`` fold on the stream **as given** (no
    sort), and crops the result.
    """
    if block_rows is None:
        budget = (spa_tile_budget(keys.device) if smem_budget_bytes is None
                  else smem_budget_bytes)
        block_rows = choose_block_rows(m, n, budget)
    block_rows = min(block_rows, _round_up(m, 8))
    keys_p, vals_p = pad_stream(keys, vals, m * n, chunk)
    return _spa.spa_accumulate_raw(keys_p, vals_p, m=m, n=n,
                                   block_rows=block_rows, chunk=chunk)


def spa_accumulate_flat(keys: torch.Tensor, vals: torch.Tensor, *, m: int,
                        n: int, **kw) -> torch.Tensor:
    """:func:`spa_accumulate` -> flat ``(m*n,)`` f32 in key order
    (col-major), so ``flat[key]`` is the accumulated value of ``key``."""
    return spa_accumulate(keys, vals, m=m, n=n, **kw).T.reshape(-1)


#: The reference's tile-size limit for its one-hot fold, mirrored for
#: readers of both packages. It selects nothing in the port, whose kernel
#: runs one fold for every fold name.
DEFAULT_ONEHOT_MAX_BLOCK_ELEMS = 4096


def vec_launch_geometry(cap: int, *, m: int, n: int,
                        block_rows: int | None = None,
                        smem_budget_bytes: int = REFERENCE_VMEM_BUDGET,
                        chunk: int | None = None) -> tuple[int, int]:
    """``(block_rows, chunk)`` the vec launch uses for a ``cap``-long
    stream: the reference's formula, shared with :func:`vec_store_counts`."""
    if block_rows is None:
        block_rows = choose_block_rows(m, n, smem_budget_bytes)
    block_rows = min(block_rows, _round_up(m, 8))
    if chunk is None:
        chunk = min(DEFAULT_CHUNK, _next_pow2(max(cap, 8)))
    return block_rows, chunk


def vec_accumulate(keys: torch.Tensor, vals: torch.Tensor, *, m: int, n: int,
                   fold: str = "auto", block_rows: int | None = None,
                   smem_budget_bytes: int | None = None,
                   chunk: int | None = None) -> torch.Tensor:
    """Sliding accumulate of the **stable-sorted** stream -> dense
    ``(m, n)`` f32.

    The reference's vec launch: one counted stable sort of the keys, then
    the SPA accumulation of ``kernels/spa_accum``. ``fold`` is checked as the reference checks it
    (``"auto"`` or a name in ``vec_accum.FOLDS``, power-of-two chunk for the
    vectorized folds); every name gives the same bits, and ``"auto"`` is
    checked as ``"sort"``. The budget defaults to :func:`spa_tile_budget`
    of the keys' device.
    """
    mn = m * n
    valid = keys < mn
    keys_c = torch.where(valid, keys, mn).to(torch.int32)
    vals_c = torch.where(valid, vals.to(torch.float32), 0.0)
    order = _stable_argsort(keys_c)
    budget = (spa_tile_budget(keys.device) if smem_budget_bytes is None
              else smem_budget_bytes)
    block_rows, chunk = vec_launch_geometry(
        keys.shape[0], m=m, n=n, block_rows=block_rows,
        smem_budget_bytes=budget, chunk=chunk)
    keys_p, vals_p = pad_stream(keys_c[order], vals_c[order], mn, chunk)
    return _spa.spa_accumulate_raw(keys_p, vals_p, m=m, n=n,
                                   block_rows=block_rows, chunk=chunk,
                                   fold="sort" if fold == "auto" else fold)


def vec_accumulate_flat(keys: torch.Tensor, vals: torch.Tensor, *, m: int,
                        n: int, **kw) -> torch.Tensor:
    """:func:`vec_accumulate` -> flat ``(m*n,)`` f32 in key order
    (col-major)."""
    return vec_accumulate(keys, vals, m=m, n=n, **kw).T.reshape(-1)


def vec_store_counts(keys, *, m: int, n: int, block_rows: int | None = None,
                     smem_budget_bytes: int = REFERENCE_VMEM_BUDGET,
                     chunk: int | None = None) -> dict:
    """Host-side serial-store counts (serial vs sort-fold vs one-hot) the
    reference's TPU folds would issue at the geometry
    :func:`vec_accumulate` uses for this stream; also set as the
    ``kernels.vec.stores.*`` gauges. Observability only."""
    block_rows, chunk = vec_launch_geometry(
        len(keys), m=m, n=n, block_rows=block_rows,
        smem_budget_bytes=smem_budget_bytes, chunk=chunk)
    counts = _vec.chunk_store_counts(keys, m=m, n=n, block_rows=block_rows,
                                     chunk=chunk)
    obs.gauge("kernels.vec.stores.serial").set(counts["serial"])
    obs.gauge("kernels.vec.stores.sort_fold").set(counts["sort_fold"])
    obs.gauge("kernels.vec.stores.onehot_fold").set(counts["onehot_fold"])
    return counts


# ---------------------------------------------------------------------------
# faithful hash launch (kernels/hash_accum.py)
# ---------------------------------------------------------------------------

def hash_accumulate(keys: torch.Tensor, vals: torch.Tensor, *, sent: int,
                    table_size: int | None = None):
    """Faithful hash SpKAdd -> ``(keys[cap], vals[cap], nnz)``, compacted.

    The raw table is compacted by moving occupied slots to the front (one
    counted stable sort on emptiness, so occupied slots keep table order),
    then truncated or padded to the input capacity.
    """
    cap = keys.shape[0]
    tkeys, tvals = _hash.hash_accumulate_raw(keys, vals, sent=sent,
                                             table_size=table_size)
    occupied = tkeys != -1
    order = _stable_argsort(torch.logical_not(occupied))
    occ = occupied[order]
    ck = torch.where(occ, tkeys[order], sent)[:cap]
    cv = torch.where(occ, tvals[order], 0.0)[:cap]
    nnz = occupied.sum(dtype=torch.int32)
    return ck.to(torch.int32), cv, nnz


def hash_symbolic(keys: torch.Tensor, *, sent: int,
                  table_size: int | None = None) -> torch.Tensor:
    """Faithful symbolic phase (distinct-key count, int32 scalar)."""
    return _hash.hash_symbolic_raw(keys, sent=sent, table_size=table_size)


# ---------------------------------------------------------------------------
# block top-k selection (kernels/topk_block.py)
# ---------------------------------------------------------------------------

def topk_block(flat: torch.Tensor, *, k: int, block: int):
    """Top ``k`` by ``|x|`` in each ``block``-element block of the 1-D
    ``flat``, zero-padded to a block multiple. Padding ranks after every
    real element of its block (a real zero ties it at the lower index), so
    it is taken only where ``k`` exceeds the block's real elements. Returns
    global ``(idx int32 (nb*k,), val (nb*k,))``, values in ``flat``'s type;
    the selection runs in f32, which holds bf16 and f16 exactly."""
    size = flat.shape[0]
    nb = -(-size // block)
    xp = torch.zeros(nb * block, dtype=torch.float32, device=flat.device)
    xp[:size] = flat
    idx, val = _topk.topk_block_raw(xp, k=k, block=block)
    return idx, val.to(flat.dtype)


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
