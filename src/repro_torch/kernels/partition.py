"""One-pass stream-partitioned accumulation: ``csrc/partition.cu`` and its
plain version.

The port of ``src/repro/kernels/partition.py``. The accumulator is cut into
key-aligned parts (``part = key // part_elems``), so the canonical plan's
one stable sort also groups the stream by part
(``core.sparse.plan_and_partition``), and the step tables of
``core.sparse.partition_steps`` say which chunk each step reads and which
part's tile it folds into. Step ``t`` folds chunk ``chunk_id[b, t]`` into
the tile of part ``part_id[b, t]``; keys outside the part, sentinels and
padding steps (``part_id == parts``) add nothing; a part with no keys comes
out as zeros. The output is the flat col-major dense accumulator,
``flat[b, key]`` = that key's values folded left to right in stream order
from ``+0.0``.

On the CUDA card each part is cut into sub-tiles of about
:data:`SUB_TILE_TARGET` slots (:func:`sub_tile_geometry`), one block each:
a block finds its own elements by searching the part's chunk span and
folds each run into its sub-tile in shared memory (the kernel's source
note says why and what bounds it). On the CPU the wrapper takes
:func:`partitioned_accumulate_plain`, which reads the same step tables and
folds with ``vec_accum.fold_runs``.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.vec_accum import fold_runs

#: Lane multiple of flat f32 accumulator tiles (kept from the reference, so
#: the port's geometry equals the reference's at equal budgets).
LANE_MULT = 128

#: Slots of one block's sub-tile the kernel aims at: a 24 KiB tile, so that
#: eight blocks of 256 threads share an SM.
SUB_TILE_TARGET = 6144

#: Sub-tile sizes are multiples of this, so that every sub-tile of a part
#: whose size is a multiple of 4 starts on a 16-byte boundary.
SUB_TILE_MULT = 32

_P = ctypes.c_void_p
_ARGTYPES = [_P, _P, _P, _P, _P, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, _P]


def sub_tile_geometry(part_elems: int) -> tuple[int, int]:
    """``(sub_elems, subs)``: the card's cut of a ``part_elems``-slot part
    into ``subs`` sub-tiles of ``sub_elems`` slots (the last may be
    shorter), as even as a multiple of :data:`SUB_TILE_MULT` allows, each
    at most about :data:`SUB_TILE_TARGET` slots."""
    if part_elems < 1:
        raise ValueError(f"part_elems {part_elems} must be positive")
    subs = -(-part_elems // SUB_TILE_TARGET)
    sub_elems = -(-part_elems // subs)
    sub_elems = -(-sub_elems // SUB_TILE_MULT) * SUB_TILE_MULT
    return sub_elems, -(-part_elems // sub_elems)


def blocks_per_sm(sub_elems: int, device=None) -> int:
    """Blocks of the CUDA kernel one SM of ``device`` holds at once with a
    ``sub_elems``-slot tile (the CUDA occupancy calculator)."""
    dev = torch.device("cuda" if device is None else device)
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    out = ctypes.c_int(0)
    fn = _build.entry("partition", "spk_partition_blocks_per_sm",
                      [ctypes.c_int, ctypes.c_int,
                       ctypes.POINTER(ctypes.c_int)])
    _build.check(fn(sub_elems, index, ctypes.byref(out)),
                 "partition occupancy query")
    return int(out.value)


def _check_args(keys, vals, chunk_id, part_id, chunk):
    if keys.dim() != 2 or keys.shape != vals.shape:
        raise ValueError(f"keys/vals must be matching 2-D streams, got "
                         f"{tuple(keys.shape)} vs {tuple(vals.shape)}")
    if chunk_id.shape != part_id.shape or chunk_id.shape[0] != keys.shape[0]:
        raise ValueError("step tables must share shape and batch the streams")
    if keys.shape[1] % chunk != 0:
        raise ValueError("pad streams to a chunk multiple")


def partitioned_accumulate_plain(keys: torch.Tensor, vals: torch.Tensor,
                                 chunk_id: torch.Tensor, part_id: torch.Tensor,
                                 *, mn: int, part_elems: int, parts: int,
                                 chunk: int) -> torch.Tensor:
    """Plain version of the kernel, on the same step tables.

    Lays the steps out as one stream (each step's chunk, masked to the
    step's part), in step order. Every key's elements are contiguous in it
    and its targets are non-decreasing, so the round-robin run fold from a
    zero tile gives each key its stream-order left fold, exactly as the
    kernel's tile does step after step.
    """
    _check_args(keys, vals, chunk_id, part_id, chunk)
    B = keys.shape[0]
    lane = torch.arange(chunk, device=keys.device)
    pos = (chunk_id.long().unsqueeze(-1) * chunk + lane).reshape(B, -1)
    k = torch.gather(keys, 1, pos).long()
    v = torch.gather(vals, 1, pos).float()
    p = part_id.long().unsqueeze(-1).expand(-1, -1, chunk).reshape(B, -1)
    lo = p * part_elems
    valid = (k >= lo) & (k < lo + part_elems) & (k < mn) & (p < parts)
    tile = torch.zeros((B, parts * part_elems), dtype=torch.float32,
                       device=keys.device)
    return fold_runs(tile, k, v, valid)  # a key's tile slot is the key


def partitioned_accumulate_raw(keys: torch.Tensor, vals: torch.Tensor,
                               chunk_id: torch.Tensor, part_id: torch.Tensor,
                               *, mn: int, part_elems: int, parts: int,
                               chunk: int) -> torch.Tensor:
    """One-pass partitioned accumulate -> flat ``(B, parts*part_elems)`` f32.

    ``keys``/``vals`` are ``(B, cap_pad)`` **sorted** streams (ascending,
    sentinel-padded to a chunk multiple); ``chunk_id``/``part_id`` are the
    ``(B, max_steps)`` step tables from ``sparse.partition_steps``. CPU
    tensors take the plain version; CUDA tensors launch the kernel, one
    block a sub-tile of :func:`sub_tile_geometry` (the cut changes no bit
    of the result).
    """
    if keys.device.type == "cpu":
        return partitioned_accumulate_plain(
            keys, vals, chunk_id, part_id, mn=mn, part_elems=part_elems,
            parts=parts, chunk=chunk)
    _check_args(keys, vals, chunk_id, part_id, chunk)
    if keys.device.type != "cuda":
        raise ValueError(f"partitioned_accumulate_raw: unsupported device "
                         f"{keys.device}")
    for name, t, dt in (("keys", keys, torch.int32), ("vals", vals, torch.float32),
                        ("chunk_id", chunk_id, torch.int32),
                        ("part_id", part_id, torch.int32)):
        if t.dtype != dt or t.device != keys.device:
            raise TypeError(f"{name} must be {dt} on {keys.device}, got "
                            f"{t.dtype} on {t.device}")
    B, cap_pad = keys.shape
    if B > 65535:
        raise ValueError(f"batch {B} exceeds the grid's y limit 65535")
    if max(cap_pad, chunk_id.shape[1]) > 2 ** 31 - 2 ** 10:
        raise ValueError("the kernel indexes a row with int32: stream or "
                         "step table too long")
    # the geometry is sized to one block's shared memory
    # (ops.device_smem_budget), though a block holds only a sub-tile
    limit = _build.max_dynamic_smem("partition", keys.device.index or 0)
    if part_elems * 4 > limit:
        raise ValueError(f"a {part_elems}-element f32 tile needs "
                         f"{part_elems * 4} B of shared memory, over the "
                         f"block limit {limit} B: size the geometry with "
                         f"ops.device_smem_budget()")
    sub_elems, subs = sub_tile_geometry(part_elems)
    keys, vals = keys.contiguous(), vals.contiguous()
    chunk_id, part_id = chunk_id.contiguous(), part_id.contiguous()
    out = torch.empty((B, parts * part_elems), dtype=torch.float32,
                      device=keys.device)
    fn = _build.entry("partition", "spk_partition_accumulate", _ARGTYPES)
    _build.check(fn(keys.data_ptr(), vals.data_ptr(), chunk_id.data_ptr(),
                    part_id.data_ptr(), out.data_ptr(), B, cap_pad,
                    chunk_id.shape[1], mn, part_elems, parts, chunk,
                    sub_elems, subs, keys.device.index or 0,
                    _build.stream_ptr(keys)),
                 "partition launch")
    partitioned_accumulate_raw.launches += 1
    return out


#: Launches of the CUDA kernel (the plain version does not count).
partitioned_accumulate_raw.launches = 0


# ---------------------------------------------------------------------------
# host-side I/O oracle (benchmark observability)
# ---------------------------------------------------------------------------

def modeled_chunk_loads(keys, *, mn: int, part_elems: int, parts: int,
                        chunk: int) -> dict:
    """Modeled input-chunk loads for a stream at a given launch geometry —
    the reference's oracle, computed from this package's step tables.

    A chunk is loaded when ``chunk_id`` differs from the previous step's
    (the Pallas pipelining rule). Returns ``onepass`` (the partitioned
    grid), ``legacy_all_pairs`` (``parts × num_chunks``), ``lower_bound``
    (each non-empty chunk once), ``num_chunks``, ``parts`` and ``steps``.
    On the card each block reads only its own elements (found by a search
    of the part's chunk span), so no chunk is read twice but for the few
    keys either side of a block's range.
    """
    from repro_torch.core.sparse import partition_steps

    keys = np.asarray(keys)
    cap = len(keys)
    cap_pad = ((max(cap, 1) + chunk - 1) // chunk) * chunk
    num_chunks = cap_pad // chunk
    keys_p = np.full(cap_pad, mn, dtype=np.int32)
    keys_p[:cap] = np.minimum(keys, mn)
    keys_s = np.sort(keys_p, kind="stable")
    nvalid = int(np.searchsorted(keys_s, mn, side="left"))
    nonempty_chunks = max(1, -(-nvalid // chunk)) if nvalid else 1

    steps = partition_steps(torch.from_numpy(keys_s), mn=mn,
                            part_elems=part_elems, parts=parts, chunk=chunk)
    chunk_id = steps.chunk_id.numpy()
    part_id = steps.part_id.numpy()
    loads = 1 + int((np.diff(chunk_id) != 0).sum())
    return {
        "onepass": loads,
        "legacy_all_pairs": parts * num_chunks,
        "lower_bound": nonempty_chunks,
        "num_chunks": num_chunks,
        "parts": parts,
        "steps": int((part_id < parts).sum()),
    }
