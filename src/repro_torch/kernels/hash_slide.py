"""Sort-free sliding-hash accumulation: ``csrc/hash_slide.cu`` and its plain
version.

The port of ``src/repro/kernels/hash_slide.py``. Each (batch, part) owns a
linear-probing table (keys ``-1`` = empty, values ``0.0``); part ``p`` owns
the keys ``[p * part_span, (p + 1) * part_span)``. Every in-part key of the
**unsorted** stream is inserted or accumulated in stream order, so each
key's value is its stream-order left fold from ``+0.0`` and no sort runs
before the engine compacts the tables (the ``hash`` regime's one counted
sort). The hash is ``(uint32(key) * HASH_PRIME) & (table_size - 1)`` and a
probe walks at most ``table_size`` slots. Adds follow XLA's float rules
(:mod:`xla_float`).

Slot placement depends on insertion order, so the raw tables of the kernel,
the plain version and the reference are compared bitwise, not only after
compaction. On the card the stream is bucketed by part once (when there is
more than one part) and one block builds each table in parallel: the
layout of first-come insertion is the unique layout of ordered linear
probing with priority = a key's first stream position, which threads reach
in any interleaving; then the block folds each slot's values in stream
order (the kernel's source note). :func:`placement_model` is a host model
of that placement for the tests. On the CPU the wrapper takes
:func:`hash_slide_plain`.
"""
from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from repro_torch.kernels import _build, xla_float
from repro_torch.kernels.hash_accum import (HASH_PRIME, check_rb_tile,
                                            first_positions, hash_table_size,
                                            ordered_placement, rb_scratch_ints)

__all__ = [
    "hash_table_size",
    "hash_slide_raw",
    "hash_slide_plain",
    "modeled_insert_stats",
    "placement_model",
]

_P = ctypes.c_void_p
_ARGTYPES = [_P, _P, _P, _P, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, _P, ctypes.c_int, _P]


def _check_args(keys, vals, *, mn, table_size, part_span, parts, chunk):
    if keys.dim() != 2 or keys.shape != vals.shape:
        raise ValueError(f"keys/vals must be matching (B, cap) streams, got "
                         f"{tuple(keys.shape)} vs {tuple(vals.shape)}")
    cap = keys.shape[1]
    if cap % chunk != 0:
        raise ValueError(f"cap {cap} must be a multiple of chunk {chunk}")
    if table_size & (table_size - 1) != 0:
        raise ValueError("table size must be 2^q")
    if table_size < 2 * min(part_span, cap):
        raise ValueError(
            f"table_size {table_size} violates load factor <= 0.5 for "
            f"part_span {part_span} / cap {cap} "
            f"(need >= {2 * min(part_span, cap)})")
    if part_span * parts < mn:
        raise ValueError(f"parts {parts} x span {part_span} must cover "
                         f"key space {mn}")


def hash_slide_plain(keys: torch.Tensor, vals: torch.Tensor, *, mn: int,
                     table_size: int, part_span: int, parts: int, chunk: int):
    """Plain version: serial over stream positions, vectorised over the
    ``B * parts`` tables. Each position inserts (or accumulates) its key
    into the table of its part in every batch row at once; a probe step
    advances every row whose slot holds another key. Same contract and
    same tables as :func:`hash_slide_raw`."""
    _check_args(keys, vals, mn=mn, table_size=table_size,
                part_span=part_span, parts=parts, chunk=chunk)
    B, cap = keys.shape
    dev = keys.device
    R = B * parts
    mask = table_size - 1
    tk = torch.full((R, table_size), -1, dtype=torch.int64, device=dev)
    tv = torch.zeros((R, table_size), dtype=torch.float32, device=dev)
    rows = torch.arange(R, device=dev)
    lo = (rows % parts) * part_span
    k_rows = keys.long().repeat_interleave(parts, dim=0)     # (R, cap)
    v_rows = vals.float().repeat_interleave(parts, dim=0)
    for e in range(cap):
        k = k_rows[:, e]
        active = (k >= lo) & (k - lo < part_span) & (k < mn)
        if not bool(active.any()):
            continue
        # uint32 hash in int64: key < 2^31, so the product stays < 2^63
        h = ((k & 0xFFFFFFFF) * HASH_PRIME) & mask
        searching = active
        for _ in range(table_size):
            cur = tk[rows, h]
            moving = searching & (cur != -1) & (cur != k)
            if not bool(moving.any()):
                break
            h = torch.where(moving, (h + 1) & mask, h)
            searching = moving
        r, s = rows[active], h[active]
        tk[r, s] = k[active]
        tv[r, s] = xla_float.add(tv[r, s], v_rows[active, e])
    return (tk.to(torch.int32).reshape(B, parts * table_size),
            tv.reshape(B, parts * table_size))


def placement_model(keys: torch.Tensor, *, mn: int, table_size: int,
                    part_span: int, parts: int, rng=None) -> torch.Tensor:
    """Host model of the kernel's placement: each (row, part)'s distinct
    in-part keys with their first stream positions (:func:`first_positions`)
    inserted by ordered linear probing (:func:`ordered_placement`), in an
    order and interleaving drawn from ``rng`` (numpy), or in list order.
    Returns the ``(B, parts * table_size)`` int32 key tables, which equal
    :func:`hash_slide_plain`'s in every interleaving. Used by the tests
    only."""
    ks = np.asarray(keys.cpu(), dtype=np.int64)
    B = ks.shape[0]
    out = np.full((B, parts, table_size), -1, np.int64)
    for b in range(B):
        for p in range(parts):
            lo = p * part_span
            sel = (ks[b] >= lo) & (ks[b] - lo < part_span) & (ks[b] < mn)
            first = first_positions(ks[b][sel])
            out[b, p] = ordered_placement(first, table_size, rng)
    return torch.from_numpy(out.reshape(B, parts * table_size)
                            .astype(np.int32))


def scratch_bytes(batch: int, cap: int, parts: int) -> int:
    """Device scratch of a launch: for more than one part, the bucketing's
    count matrix, two ``(B, cap)`` key / value buffer pairs and the
    buckets' first positions (the kernel's entry point lays them out)."""
    if parts <= 1:
        return 0
    check_rb_tile("hash_slide")
    return (4 * rb_scratch_ints(batch, cap) + 16 * batch * cap
            + 4 * batch * (parts + 2))


@functools.lru_cache(maxsize=None)
def stage_bytes() -> int:
    """Shared memory the fold stages beside a table (12 B a slot)."""
    return int(_build.entry("hash_slide", "spk_hash_slide_stage_bytes", [])())


def smem_bytes(table_size: int) -> int:
    """Dynamic shared memory of one (batch, part) block: the table (8 B a
    slot), the distinct-key list and then the values (4 B a slot) and the
    fold's stage."""
    return 12 * table_size + stage_bytes()


def moved_bytes(batch: int, cap: int, *, table_size: int, parts: int) -> int:
    """Device-memory bytes the launch reads and writes: without bucketing
    the stream once (8 B an element) and the tables once (8 B a slot); with
    it, each radix pass reads the keys twice (count, scatter) and the
    values once and writes both, and the bounds pass reads the keys, before
    the blocks read the bucketed stream and write the tables. The count
    matrices (1/32 of a pass's stream bytes) are left out."""
    stream = 8 * batch * cap
    tables = 8 * batch * parts * table_size
    if parts <= 1:
        return stream + tables
    passes = max(1, -(-(parts).bit_length() // 8))
    return passes * (12 * batch * cap + 8 * batch * cap) \
        + 4 * batch * cap + stream + tables


def hash_slide_raw(keys: torch.Tensor, vals: torch.Tensor, *, mn: int,
                   table_size: int, part_span: int, parts: int, chunk: int):
    """Accumulate batched streams into per-part hash tables.

    ``keys``/``vals`` are ``(B, cap)`` with ``cap`` a multiple of ``chunk``;
    keys ``>= mn`` are sentinels and never inserted. Returns raw tables
    ``(B, parts * table_size)`` (int32 keys, -1 = empty; f32 values) —
    concatenated part tables are key-range ordered, so one final stable
    sort yields the canonical layout. CPU tensors take the plain version;
    CUDA tensors launch the kernel (``chunk`` is checked as the reference
    checks it; the kernel stages no chunks).
    """
    if keys.device.type == "cpu":
        return hash_slide_plain(keys, vals, mn=mn, table_size=table_size,
                                part_span=part_span, parts=parts, chunk=chunk)
    _check_args(keys, vals, mn=mn, table_size=table_size,
                part_span=part_span, parts=parts, chunk=chunk)
    if keys.device.type != "cuda":
        raise ValueError(f"hash_slide_raw: unsupported device {keys.device}")
    if (keys.dtype != torch.int32 or vals.dtype != torch.float32
            or vals.device != keys.device):
        raise TypeError(f"hash_slide kernel takes int32 keys and f32 vals on "
                        f"one device, got {keys.dtype} / {vals.dtype}")
    B, cap = keys.shape
    if B > 65535:
        raise ValueError(f"batch {B} exceeds the grid's y limit 65535")
    if B * cap >= 2 ** 31:
        raise ValueError(f"a ({B}, {cap}) stream does not fit int32 "
                         f"positions")
    limit = _build.max_dynamic_smem("hash_slide", keys.device.index or 0)
    if smem_bytes(table_size) > limit:
        raise ValueError(f"a {table_size}-slot table needs "
                         f"{smem_bytes(table_size)} B of shared memory, "
                         f"over the block limit {limit} B: size the "
                         f"geometry with ops.device_smem_budget()")
    keys, vals = keys.contiguous(), vals.contiguous()
    dev = keys.device
    tkeys = torch.empty((B, parts * table_size), dtype=torch.int32,
                        device=dev)
    tvals = torch.empty((B, parts * table_size), dtype=torch.float32,
                        device=dev)
    if B == 0:
        return tkeys, tvals
    scratch = torch.empty(scratch_bytes(B, cap, parts), dtype=torch.uint8,
                          device=dev)
    fn = _build.entry("hash_slide", "spk_hash_slide", _ARGTYPES)
    _build.check(fn(keys.data_ptr(), vals.data_ptr(), tkeys.data_ptr(),
                    tvals.data_ptr(), B, cap, mn, table_size, part_span,
                    parts, scratch.data_ptr(), dev.index or 0,
                    _build.stream_ptr(keys)), "hash_slide launch")
    hash_slide_raw.launches += 1
    return tkeys, tvals


#: Launches of the CUDA kernel (the plain version does not count).
hash_slide_raw.launches = 0


def modeled_insert_stats(keys, *, mn: int, table_size: int, part_span: int,
                         parts: int, chunk: int) -> dict:
    """Host-side oracle: replay the exact kernel hash/probe sequence.

    A copy of the reference's oracle: one table touch per probe,
    ``inserts`` is the compute lower bound (one insert per valid nonzero),
    ``chunk_loads`` is the stream I/O (``parts`` passes) vs the one-pass
    lower bound, and ``load_factor_max`` certifies the <= 0.5 sizing
    invariant held.
    """
    flat = np.asarray(keys).reshape(-1).astype(np.int64)
    valid = flat[flat < mn]
    mask = table_size - 1
    inserts = 0
    probes_total = 0
    max_probes = 0
    occ_max = 0
    for p in range(parts):
        lo = p * part_span
        part_keys = valid[(valid >= lo) & (valid < lo + part_span)]
        table = np.full(table_size, -1, np.int64)
        occ = 0
        for k in part_keys:
            h = (int(k) * HASH_PRIME) & mask
            probes = 1
            while table[h] != -1 and table[h] != k and probes <= table_size:
                h = (h + 1) & mask
                probes += 1
            if table[h] == -1:
                occ += 1
            table[h] = k
            inserts += 1
            probes_total += probes
            max_probes = max(max_probes, probes)
        occ_max = max(occ_max, occ)

    cap = flat.shape[0] if keys is not None else 0
    num_chunks = max(1, math.ceil(max(cap, 1) / chunk))
    chunk_loads = parts * num_chunks
    stats = {
        "inserts": inserts,
        "probes": probes_total,
        "probes_per_insert": probes_total / max(inserts, 1),
        "max_probes": max_probes,
        "table_size": table_size,
        "parts": parts,
        "load_factor_max": occ_max / table_size,
        "chunk_loads": chunk_loads,
        "chunk_loads_lower_bound": num_chunks,
    }
    return stats
