"""Sliding dense SPA accumulation (the all-pairs grid): ``csrc/spa_accum.cu``
and its plain version.

The port of ``src/repro/kernels/spa_accum.py``. The row space is cut into
``parts = ceil(m / block_rows)`` row blocks; each part owns a dense
``(block_rows, n)`` f32 tile, and **every** element of the stream passes
every part, so the stream is read ``parts`` times. That is the reference's
legacy grid, kept as its fidelity baseline and for unsorted streams: the
one-pass grid is ``kernels/partition``. Keys are CSC-linearized
(``key = col * m + row``); keys outside ``[0, m*n)`` are sentinels and add
nothing. The result is the dense ``(m, n)`` sum in which each slot's values
fold left to right, in stream order, from ``+0.0``: what the reference's
``serial`` fold gives on any stream and its ``sort``/``onehot`` folds give
on a stable-sorted one, so one kernel serves all three fold names.

On the CUDA card one block owns each part's tile in shared memory and
walks the whole stream (the kernel's source note says how it keeps stream
order); on the CPU the wrapper takes :func:`spa_accumulate_plain`.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.vec_accum import FOLDS, apply_fold

#: Default input chunk, the reference's.
DEFAULT_CHUNK = 1024

_P = ctypes.c_void_p
_ARGTYPES = [_P, _P, _P, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, _P]


@functools.lru_cache(maxsize=None)
def stage_bytes() -> int:
    """Shared memory the kernel takes beside its tile (one compacted step
    of the stream and its scan counts), from the built library."""
    return int(_build.entry("spa_accum", "spk_spa_stage_bytes", [])())


def _check_args(keys, vals, *, chunk, fold):
    if keys.shape != vals.shape or keys.dim() != 1:
        raise ValueError(f"keys/vals must be matching 1-D streams, got "
                         f"{tuple(keys.shape)} vs {tuple(vals.shape)}")
    if keys.shape[0] % chunk != 0:
        raise ValueError("pad inputs to a chunk multiple")
    if fold not in FOLDS:
        raise ValueError(f"unknown fold {fold!r}; one of {FOLDS}")
    if fold != "serial" and chunk & (chunk - 1) != 0:
        raise ValueError(
            "vectorized folds need a power-of-two chunk (bitonic network)")


def spa_accumulate_plain(keys: torch.Tensor, vals: torch.Tensor, *, m: int,
                         n: int, block_rows: int, chunk: int = DEFAULT_CHUNK,
                         fold: str = "serial") -> torch.Tensor:
    """Plain version: the stream-order fold of every slot at once, through
    ``vec_accum.apply_fold`` (a stable sort by key, uncounted, then the run
    fold) into a zero ``(m*n,)`` accumulator in key order. Same contract
    and same bits as :func:`spa_accumulate_raw`; ``block_rows`` only sizes
    the kernel's tiles, which do not change the sum."""
    _check_args(keys, vals, chunk=chunk, fold=fold)
    mn = m * n
    valid = (keys >= 0) & (keys < mn)
    flat = torch.zeros((1, mn), dtype=torch.float32, device=keys.device)
    flat = apply_fold(fold, flat, torch.where(valid, keys, 0)[None],
                      vals.float()[None], valid[None])
    return flat.reshape(n, m).T.contiguous()


def spa_accumulate_raw(keys: torch.Tensor, vals: torch.Tensor, *, m: int,
                       n: int, block_rows: int, chunk: int = DEFAULT_CHUNK,
                       fold: str = "serial") -> torch.Tensor:
    """Scatter-accumulate a (key, val) stream into a dense ``(m, n)`` f32.

    ``keys``/``vals`` must already be padded to a multiple of ``chunk``
    with sentinel keys (>= m*n) and zero values; ``fold`` is checked as the
    reference checks it (a known name; a power-of-two ``chunk`` for
    ``sort``/``onehot``). CPU tensors take the plain version; CUDA tensors
    launch the kernel, which raises if a ``block_rows``-row tile and its
    stage do not fit one block's shared memory.
    """
    if keys.device.type == "cpu":
        return spa_accumulate_plain(keys, vals, m=m, n=n,
                                    block_rows=block_rows, chunk=chunk,
                                    fold=fold)
    _check_args(keys, vals, chunk=chunk, fold=fold)
    if keys.device.type != "cuda":
        raise ValueError(f"spa_accumulate_raw: unsupported device "
                         f"{keys.device}")
    if (keys.dtype != torch.int32 or vals.dtype != torch.float32
            or vals.device != keys.device):
        raise TypeError(f"spa_accum kernel takes int32 keys and f32 vals on "
                        f"one device, got {keys.dtype} / {vals.dtype}")
    limit = _build.max_dynamic_smem("spa_accum", keys.device.index or 0)
    need = block_rows * n * 4 + stage_bytes()
    if need > limit:
        raise ValueError(f"a ({block_rows}, {n}) f32 tile and the kernel's "
                         f"{stage_bytes()}-byte stage need {need} B of shared "
                         f"memory, over the block limit {limit} B: n is too "
                         f"wide for the dense tile, or size block_rows with "
                         f"ops.spa_tile_budget()")
    parts = (m + block_rows - 1) // block_rows
    keys, vals = keys.contiguous(), vals.contiguous()
    out = torch.empty((parts * block_rows, n), dtype=torch.float32,
                      device=keys.device)
    fn = _build.entry("spa_accum", "spk_spa_accumulate", _ARGTYPES)
    _build.check(fn(keys.data_ptr(), vals.data_ptr(), out.data_ptr(),
                    keys.shape[0], m, n, block_rows, parts,
                    keys.device.index or 0, _build.stream_ptr(keys)),
                 "spa_accum launch")
    spa_accumulate_raw.launches += 1
    return out[:m]


#: Launches of the CUDA kernel (the plain version does not count).
spa_accumulate_raw.launches = 0
