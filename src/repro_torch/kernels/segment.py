"""Ordered segmented fold: ``csrc/segment_fold.cu`` and its plain version.

The reference leaves three folds to XLA, which applies them in operand
order: ``jax.ops.segment_sum`` in ``sparse.compress``, and the scatter-add
``.at[].add`` in ``PaddedCOO.to_dense`` and ``engine.scatter_accumulate``.
On CUDA, ``index_add_``/``scatter_add_`` and float atomics add in no fixed
order, which breaks the canonical contract's bit-identity. The port sorts
the stream by segment first (the plan it already has, or one counted stable
sort) and folds each segment's run left to right from ``+0.0`` here.

:func:`segment_fold` takes the plain version for a tensor on the CPU and
the CUDA kernel for a tensor on the card, and has no other path.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.vec_accum import fold_runs

_P = ctypes.c_void_p
_ARGTYPES = [_P, _P, _P, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, _P]
#: Value types the kernel folds, by the code its C entry point takes.
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

#: The kernel's block: 256 threads of 8 elements (``csrc/segment_fold.cu``
#: ``SF_THREADS``, ``SF_ITEMS``); a row's tiles start at its first
#: 8-element boundary, so 16-byte loads read whole chunks.
THREADS, ITEMS = 256, 8
TILE = THREADS * ITEMS
#: Rows beyond this many share a grid row (the kernel strides over them).
MAX_GRID_ROWS = 65535


class FoldGeometry(NamedTuple):
    tile: int           # elements a block folds
    tiles_per_row: int  # grid x
    grid_rows: int      # grid y
    blocks: int


def fold_geometry(rows: int, length: int) -> FoldGeometry:
    """The kernel's launch for ``rows`` streams of ``length``: the grid the
    C entry point computes. A row's first tile starts up to 7 elements
    before it (at ``8 * floor(row * length / 8)``)."""
    tiles = -(-(length + ITEMS - 1) // TILE)
    grid_rows = min(rows, MAX_GRID_ROWS)
    return FoldGeometry(TILE, tiles, grid_rows, tiles * grid_rows)


def _as_rows(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(1, -1) if x.dim() == 1 else x


def segment_fold_plain(vals: torch.Tensor, gid: torch.Tensor,
                       num_segments: int) -> torch.Tensor:
    """Plain version: the round-robin run fold (``vec_accum.fold_runs``)
    into a zero tile. Same contract as :func:`segment_fold`."""
    v2, g2 = _as_rows(vals), _as_rows(gid)
    tile = torch.zeros((v2.shape[0], num_segments), dtype=vals.dtype,
                       device=vals.device)
    valid = (g2 >= 0) & (g2 < num_segments)
    out = fold_runs(tile, g2, v2, valid)
    return out.reshape(vals.shape[:-1] + (num_segments,))


def segment_fold(vals: torch.Tensor, gid: torch.Tensor,
                 num_segments: int) -> torch.Tensor:
    """``out[..., g]`` = left fold from ``+0.0``, in stream order, of the
    ``vals`` whose ``gid == g``; ``gid`` outside ``[0, num_segments)`` is
    dropped. ``vals``/``gid`` are ``(L,)`` or ``(B, L)`` with ``gid``
    non-decreasing along the last axis (a plan-sorted stream), which is what
    makes each segment one contiguous run. Values are f32 or bf16; bf16
    rounds after every add, as PyTorch's bf16 add does.

    The reference's ``jax.ops.segment_sum`` over a sorted stream, bitwise.
    On the card a run is one chain of adds in stream order, however long.
    Callers give sentinel padding the id ``num_segments``: the kernel reads
    the keys of a dropped run and not its values.
    """
    if vals.shape != gid.shape or vals.dim() not in (1, 2):
        raise ValueError(f"vals/gid must be matching 1-D or 2-D streams, got "
                         f"{tuple(vals.shape)} vs {tuple(gid.shape)}")
    if vals.device.type == "cpu":
        return segment_fold_plain(vals, gid, num_segments)
    if vals.device.type != "cuda" or gid.device != vals.device:
        raise ValueError(f"segment_fold: unsupported devices {vals.device} / "
                         f"{gid.device}")
    if vals.dtype not in _DTYPE_CODES or gid.dtype != torch.int32:
        raise TypeError(f"segment_fold kernel takes f32 or bf16 vals and "
                        f"int32 gid, got {vals.dtype} / {gid.dtype}")
    v2 = _as_rows(vals).contiguous()
    g2 = _as_rows(gid).contiguous()
    rows, length = v2.shape
    out = torch.zeros((rows, num_segments), dtype=vals.dtype,
                      device=vals.device)
    if v2.numel() == 0:
        return out.reshape(vals.shape[:-1] + (num_segments,))  # no launch
    fn = _build.entry("segment_fold", "spk_segment_fold", _ARGTYPES)
    _build.check(fn(v2.data_ptr(), g2.data_ptr(), out.data_ptr(), rows, length,
                    num_segments, _DTYPE_CODES[vals.dtype],
                    vals.device.index or 0,
                    _build.stream_ptr(vals)), "segment_fold launch")
    segment_fold.launches += 1
    return out.reshape(vals.shape[:-1] + (num_segments,))


#: Launches of the CUDA kernel (the plain version does not count).
segment_fold.launches = 0
