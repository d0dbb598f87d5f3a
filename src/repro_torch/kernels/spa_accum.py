"""Sliding dense SPA accumulation: ``csrc/spa_accum.cu`` and its plain
versions.

The port of ``src/repro/kernels/spa_accum.py``. The row space is cut into
``parts = ceil(m / block_rows)`` row blocks; each part owns a dense
``(block_rows, n)`` f32 tile. Keys are CSC-linearized (``key = col * m +
row``); keys outside ``[0, m*n)`` are sentinels and add nothing. The result
is the dense ``(m, n)`` sum in which each slot's values fold left to right,
in stream order, from ``+0.0``: what the reference's ``serial`` fold gives
on any stream and its ``sort``/``onehot`` folds give on a stable-sorted
one, so one pipeline serves all three fold names.

The reference passes every element of the stream by every part (its
legacy grid, ``parts`` reads of the stream). On the CUDA card the stream is
put in part order once instead (:func:`spa_bucket_raw`: a stable radix
partition on the part number, count, offsets and scatter for each 8 bits of
it, whose plain version is :func:`spa_bucket_plain`), and one warp per part
folds its own bucket into its tile (the kernels' source note says how order
and bits are kept). On the CPU :func:`spa_accumulate_raw`
takes :func:`spa_accumulate_plain`.
"""
from __future__ import annotations

import ctypes
import functools
import typing as _t

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.vec_accum import FOLDS, apply_fold

#: Default input chunk, the reference's.
DEFAULT_CHUNK = 1024

#: Stream elements per tile of the count and scatter kernels (the
#: library's ``SPA_TILE``), and the bits of the part number each radix pass
#: takes.
TILE = 4096
RADIX_BITS = 8

_P = ctypes.c_void_p
_I = ctypes.c_int
_U = ctypes.c_uint32
_I64 = ctypes.c_int64
_DIMS = [_I, _I, _I, _I, _U, _I, _U, _I]  # m, n, block_rows, parts, magics
_COUNT_ARGTYPES = [_P, _P, _I64, *_DIMS, _I, _P, _I, _I, _P]
_OFFSETS_ARGTYPES = [_P, _I, _P, _P, _I, _P]
_SCATTER_ARGTYPES = [_P, _P, _P, _I64, *_DIMS, _I, _P, _I, _P, _P, _I, _P]
_BOUNDS_ARGTYPES = [_P, _P, *_DIMS, _P, _I, _P]
_FOLD_ARGTYPES = [_P, _P, _P, *_DIMS, _I, _P, _I, _P]


@functools.lru_cache(maxsize=None)
def stage_bytes() -> int:
    """Shared memory the fold kernel takes beside its tile (its staged
    windows of values), from the built library."""
    return int(_build.entry("spa_accum", "spk_spa_stage_bytes", [])())


@functools.lru_cache(maxsize=None)
def _library_tile() -> int:
    return int(_build.entry("spa_accum", "spk_spa_tile", [])())


def fast_div(d: int) -> tuple[int, int]:
    """``(magic, shift)`` with ``floor(x / d) == (umulhi(x, magic) + x) >>
    shift`` for every ``0 <= x < 2**31`` (a 33-bit round-up multiplier whose
    top bit is the ``+ x``), as the kernels divide by ``m`` and
    ``block_rows``."""
    if d < 1 or d >= 2 ** 31:
        raise ValueError(f"divisor {d} outside [1, 2^31)")
    shift = (d - 1).bit_length()
    magic = ((1 << 32) * ((1 << shift) - d)) // d + 1
    return magic, shift


class BucketGeometry(_t.NamedTuple):
    parts: int    # row parts, ceil(m / block_rows)
    passes: int   # radix passes of RADIX_BITS bits over the part number
    ntile: int    # tiles of TILE stream elements, ceil(cap / TILE)


def bucket_geometry(cap: int, *, m: int, block_rows: int) -> BucketGeometry:
    """The bucketing's geometry for a ``cap``-long stream: enough radix
    passes to cover ``parts - 1``, each over ``ceil(cap / TILE)`` tiles with
    a ``(2**RADIX_BITS, ntile)`` int32 count matrix (1/32 of the stream's
    8 bytes per element)."""
    parts = -(-m // block_rows)
    passes = max(1, -(-(parts - 1).bit_length() // RADIX_BITS))
    return BucketGeometry(parts, passes, -(-cap // TILE))


def moved_bytes(cap: int, valid: int, *, m: int, n: int,
                block_rows: int) -> dict:
    """Bytes each stage of the CUDA pipeline reads and writes for a
    ``cap``-long stream with ``valid`` elements in ``[0, m*n)``, summed over
    the radix passes: the count reads the pass's keys and writes its count
    matrix; the offsets read it twice and write it once, and the part
    bounds read a few keys per part (not counted); the scatter reads the
    pass's keys, values and offsets and writes the valid elements; the fold
    reads the buckets and writes the dense output."""
    g = bucket_geometry(cap, m=m, block_rows=block_rows)
    matrix = 4 * (1 << RADIX_BITS) * g.ntile
    first = {"count": 4 * cap + matrix, "offsets": 3 * matrix,
             "scatter": 8 * cap + matrix + 8 * valid}
    later = {"count": 4 * valid + matrix, "offsets": 3 * matrix,
             "scatter": 8 * valid + matrix + 8 * valid}
    out = {k: first[k] + (g.passes - 1) * later[k] for k in first}
    out["offsets"] += 4 * (g.parts + 1)
    out["fold"] = 8 * valid + 4 * (g.parts + 1) + 4 * g.parts * block_rows * n
    return out


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


def _check_cuda_stream(keys, vals):
    if keys.device.type != "cuda":
        raise ValueError(f"spa_accum: unsupported device {keys.device}")
    if (keys.dtype != torch.int32 or vals.dtype != torch.float32
            or vals.device != keys.device or keys.dim() != 1
            or keys.shape != vals.shape):
        raise TypeError(f"spa_accum kernels take matching 1-D int32 keys "
                        f"and f32 vals on one device, got {keys.dtype} "
                        f"{tuple(keys.shape)} on {keys.device} / "
                        f"{vals.dtype} {tuple(vals.shape)} on {vals.device}")
    if keys.shape[0] >= 2 ** 31:
        raise ValueError(f"spa_accum: a stream of {keys.shape[0]} elements "
                         f"does not fit int32 positions")


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


def spa_bucket_plain(keys: torch.Tensor, vals: torch.Tensor, *, m: int,
                     n: int, block_rows: int):
    """Plain version of the bucketing: the elements with keys in
    ``[0, m*n)``, stably partitioned by row part ``(key % m) //
    block_rows``. Returns ``(keys, vals, base)``: the keys (int32) and
    values (f32) in part order and, within a part, in stream order; and
    each part's first position (int32, ``parts + 1`` entries, the last the
    element count)."""
    mn = m * n
    k = keys.long()
    valid = (k >= 0) & (k < mn)
    k, v = k[valid], vals[valid].float()
    part = (k % m) // block_rows
    # the plain twin of the kernel's radix bucketing: a sort inside the
    # kernel's work, counted neither here nor on the card
    order = torch.sort(part, stable=True).indices  # spkaddlint: disable=SPK101
    parts = -(-m // block_rows)
    base = torch.zeros(parts + 1, dtype=torch.int64, device=keys.device)
    base[1:] = torch.cumsum(torch.bincount(part, minlength=parts), 0)
    return k[order].to(torch.int32), v[order], base.to(torch.int32)


class SpaLaunches:
    """The CUDA pipeline for one stream, its scratch allocated (no launch
    yet): ``stages`` is the ordered list of ``(name, launch)`` pairs —
    ``count``, ``offsets`` and ``scatter`` for each radix pass, then
    ``offsets`` (the part bounds) and, unless ``fold=False``, ``fold`` —
    and :meth:`run` launches them in order. The outputs are ``keys`` /
    ``vals`` (the buckets, ``cap`` long, the first ``base[-1]``
    meaningful), ``base`` and ``out``. Launches made here count nowhere;
    the wrappers count their calls."""

    def __init__(self, keys: torch.Tensor, vals: torch.Tensor, *, m: int,
                 n: int, block_rows: int, fold: bool = True):
        _check_cuda_stream(keys, vals)
        if _library_tile() != TILE:
            raise RuntimeError(f"spa_accum: the library's tile is "
                               f"{_library_tile()} elements, this module's "
                               f"{TILE}")
        cap, dev = keys.shape[0], keys.device
        g = bucket_geometry(cap, m=m, block_rows=block_rows)
        self.geom, self.device_index = g, dev.index or 0
        self.dims = (m, n, block_rows, g.parts, *fast_div(m),
                     *fast_div(block_rows))
        self.block_rows, self.n = block_rows, n
        matrix = (1 << RADIX_BITS) * g.ntile
        self.counts = torch.empty(matrix, dtype=torch.int32, device=dev)
        self.partial = torch.empty(max(1, -(-matrix // TILE)),
                                   dtype=torch.int32, device=dev)
        self.total = torch.empty(1, dtype=torch.int32, device=dev)
        self.base = torch.empty(g.parts + 1, dtype=torch.int32, device=dev)
        bufs = [(torch.empty(cap, dtype=torch.int32, device=dev),
                 torch.empty(cap, dtype=torch.float32, device=dev))
                for _ in range(min(g.passes, 2))]
        self.stages = []
        src = (keys.contiguous(), vals.contiguous(), None)
        for i in range(g.passes):
            dst = bufs[i % 2]
            self.stages += self._pass(src, dst, cap, RADIX_BITS * i)
            src = (dst[0], dst[1], self.total)
        self.keys, self.vals = src[0], src[1]
        self.stages.append(("offsets", self._bounds))
        self.out = None
        if fold:
            self.out = torch.empty((g.parts * block_rows, n),
                                   dtype=torch.float32, device=dev)
            self.stages.append(("fold", self._fold))

    def _stream(self):
        return _build.stream_ptr(self.counts)

    def _pass(self, src, dst, cap, shift):
        keys, vals, length = src
        len_ptr = None if length is None else length.data_ptr()
        ntile, ix = self.geom.ntile, self.device_index

        def count():
            fn = _build.entry("spa_accum", "spk_spa_pass_count",
                              _COUNT_ARGTYPES)
            _build.check(fn(keys.data_ptr(), len_ptr, cap, *self.dims, shift,
                            self.counts.data_ptr(), ntile, ix,
                            self._stream()), "spa_accum count launch")

        def offsets():
            fn = _build.entry("spa_accum", "spk_spa_pass_offsets",
                              _OFFSETS_ARGTYPES)
            _build.check(fn(self.counts.data_ptr(), ntile,
                            self.partial.data_ptr(), self.total.data_ptr(),
                            ix, self._stream()), "spa_accum offsets launch")

        def scatter():
            fn = _build.entry("spa_accum", "spk_spa_pass_scatter",
                              _SCATTER_ARGTYPES)
            _build.check(fn(keys.data_ptr(), vals.data_ptr(), len_ptr, cap,
                            *self.dims, shift, self.counts.data_ptr(), ntile,
                            dst[0].data_ptr(), dst[1].data_ptr(), ix,
                            self._stream()), "spa_accum scatter launch")

        return [("count", count), ("offsets", offsets), ("scatter", scatter)]

    def _bounds(self):
        fn = _build.entry("spa_accum", "spk_spa_bounds", _BOUNDS_ARGTYPES)
        _build.check(fn(self.keys.data_ptr(), self.total.data_ptr(),
                        *self.dims, self.base.data_ptr(), self.device_index,
                        self._stream()), "spa_accum bounds launch")

    def _fold(self):
        slot_bits = (self.block_rows * self.n - 1).bit_length()
        fn = _build.entry("spa_accum", "spk_spa_fold", _FOLD_ARGTYPES)
        _build.check(fn(self.keys.data_ptr(), self.vals.data_ptr(),
                        self.base.data_ptr(), *self.dims, slot_bits,
                        self.out.data_ptr(), self.device_index,
                        self._stream()), "spa_accum fold launch")

    def run(self) -> "SpaLaunches":
        for _, launch in self.stages:
            launch()
        return self


def spa_bucket_raw(keys: torch.Tensor, vals: torch.Tensor, *, m: int,
                   n: int, block_rows: int):
    """The bucketing of :func:`spa_bucket_plain` (same contract, same
    bits). CPU tensors take the plain version; CUDA tensors launch the
    count, offsets and scatter kernels."""
    if keys.device.type == "cpu":
        return spa_bucket_plain(keys, vals, m=m, n=n, block_rows=block_rows)
    run = SpaLaunches(keys, vals, m=m, n=n, block_rows=block_rows,
                      fold=False).run()
    spa_bucket_raw.launches += 1
    total = int(run.base[-1])
    return run.keys[:total], run.vals[:total], run.base


#: Calls that launched the bucketing kernels (the plain version does not
#: count; :func:`spa_accumulate_raw` counts its own calls).
spa_bucket_raw.launches = 0


def spa_accumulate_raw(keys: torch.Tensor, vals: torch.Tensor, *, m: int,
                       n: int, block_rows: int, chunk: int = DEFAULT_CHUNK,
                       fold: str = "serial") -> torch.Tensor:
    """Scatter-accumulate a (key, val) stream into a dense ``(m, n)`` f32.

    ``keys``/``vals`` must already be padded to a multiple of ``chunk``
    with sentinel keys (>= m*n) and zero values; ``fold`` is checked as the
    reference checks it (a known name; a power-of-two ``chunk`` for
    ``sort``/``onehot``). CPU tensors take the plain version; CUDA tensors
    launch the four-stage pipeline, which raises if a ``block_rows``-row
    tile and the fold's stage do not fit one block's shared memory.
    """
    if keys.device.type == "cpu":
        return spa_accumulate_plain(keys, vals, m=m, n=n,
                                    block_rows=block_rows, chunk=chunk,
                                    fold=fold)
    _check_args(keys, vals, chunk=chunk, fold=fold)
    _check_cuda_stream(keys, vals)
    limit = _build.max_dynamic_smem("spa_accum", keys.device.index or 0)
    need = block_rows * n * 4 + stage_bytes()
    if need > limit:
        raise ValueError(f"a ({block_rows}, {n}) f32 tile and the fold's "
                         f"{stage_bytes()}-byte stage need {need} B of shared "
                         f"memory, over the block limit {limit} B: n is too "
                         f"wide for the dense tile, or size block_rows with "
                         f"ops.spa_tile_budget()")
    out = SpaLaunches(keys, vals, m=m, n=n, block_rows=block_rows).run().out
    spa_accumulate_raw.launches += 1
    return out[:m]


#: Calls that launched the CUDA pipeline (the plain version does not count).
spa_accumulate_raw.launches = 0
