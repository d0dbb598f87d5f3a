"""Block-local top-k selection: ``csrc/topk_block.cu`` and its plain version.

The port of ``src/repro/kernels/topk_block.py``. The selector of gradient
and parameter-delta sparsification (``core/topk.topk_block``): for each
block of ``block`` elements of a flat array, the ``k`` entries of largest
``|x|``, largest first, ties to the lower index. Indices come out global
(offset by the block's start).

:func:`topk_block_raw` takes the plain version for a tensor on the CPU and
the CUDA kernel for a tensor on the card, and has no other path. On the
card one CTA stages a block's order keys (:func:`order_key`) in shared
memory, finds the k-th largest by a radix select of up to
:data:`RADIX_PASSES` passes (:func:`radix_passes` counts them), picks the
winners in index order and sorts them; a ``block`` and ``k`` whose
:func:`smem_bytes` exceed the kernel's budget raise before any launch.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.sparse import top_k
from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref

_P = ctypes.c_void_p
_ARGTYPES = [_P, _P, _P, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, _P]

#: The kernel's radix digit width and passes.
DIGIT_BITS = 8
RADIX_PASSES = 32 // DIGIT_BITS
_NAN_KEY = 0xFFFFFFFF


def _check_args(x: torch.Tensor, k: int, block: int) -> int:
    if x.dim() != 1 or block < 1 or x.shape[0] % block != 0:
        raise ValueError(f"input length {tuple(x.shape)} must be a 1-D "
                         f"multiple of block {block}")
    if not 0 <= k <= block:
        raise ValueError(f"k={k} must lie in [0, block={block}]")
    if x.shape[0] >= 2 ** 31:
        raise ValueError("global indices are int32: input too long")
    return x.shape[0] // block


def order_key(x: torch.Tensor) -> torch.Tensor:
    """The kernel's order key of f32 ``x``, as int64: the bits of ``|x|``
    as an unsigned integer, every NaN (any sign, any payload) mapped to
    ``0xFFFFFFFF``. A larger key ranks first, ties to the lower index, so a
    stable descending sort of the keys gives :func:`topk_block_plain`'s
    order; ``-0.0`` and ``+0.0`` share key 0."""
    bits = x.to(torch.float32).abs().view(torch.int32).to(torch.int64)
    return torch.where(torch.isnan(x), torch.full_like(bits, _NAN_KEY),
                       bits & 0xFFFFFFFF)


def radix_passes(x: torch.Tensor, *, k: int, block: int) -> torch.Tensor:
    """Radix passes the kernel's select takes for each block (int32
    ``(nb,)``): it stops after the first pass ``d`` at which the elements
    whose top ``d`` digits are at least the k-th largest key's are exactly
    ``k``, else after :data:`RADIX_PASSES`. Zero where ``k == 0``."""
    nb = _check_args(x, k, block)
    out = torch.zeros(nb, dtype=torch.int32, device=x.device)
    if k == 0 or nb == 0:
        return out
    keys = order_key(x).view(nb, block)
    kth = top_k(keys, k)[0][:, k - 1:k]
    out.fill_(RADIX_PASSES)
    for d in range(RADIX_PASSES - 1, 0, -1):
        mask = ((1 << (DIGIT_BITS * d)) - 1) << (32 - DIGIT_BITS * d)
        done = ((keys & mask) >= (kth & mask)).sum(dim=1) == k
        out = torch.where(done, d, out)
    return out


def smem_bytes(block: int, k: int) -> int:
    """Dynamic shared memory one CTA of the kernel stages: the block's
    order keys and the winners' index buffer, padded to a power of two
    (4 bytes each)."""
    return 4 * (block + (1 << max(k - 1, 0).bit_length()))


def topk_block_plain(x: torch.Tensor, *, k: int, block: int):
    """Plain version: the oracle ``ref.topk_block_ref``, a stable
    descending sort of each block's ``|x|`` (the tie rule of
    ``lax.top_k``). Same contract as :func:`topk_block_raw`, on the input's
    device."""
    _check_args(x, k, block)
    idx, val = _ref.topk_block_ref(x, k, block)
    return idx, val.to(torch.float32)


def topk_block_raw(x: torch.Tensor, *, k: int, block: int):
    """``x``: f32 ``(nb*block,)`` -> ``(idx int32 (nb*k,), val f32
    (nb*k,))``, the top ``k`` by ``|x|`` of each block, largest first, ties
    to the lower index. CPU tensors take the plain version; CUDA tensors
    launch the kernel."""
    if x.device.type == "cpu":
        return topk_block_plain(x, k=k, block=block)
    nb = _check_args(x, k, block)
    if x.device.type != "cuda":
        raise ValueError(f"topk_block_raw: unsupported device {x.device}")
    if x.dtype != torch.float32:
        raise TypeError(f"topk_block kernel takes f32, got {x.dtype}")
    limit = _build.max_dynamic_smem("topk_block", x.device.index or 0)
    need = smem_bytes(block, k)
    if need > limit:
        raise ValueError(f"topk_block: a block of {block} f32 at k={k} "
                         f"({need} B of keys and indices) exceeds the "
                         f"kernel's shared memory ({limit} B)")
    x = x.contiguous()
    idx = torch.empty(nb * k, dtype=torch.int32, device=x.device)
    val = torch.empty(nb * k, dtype=torch.float32, device=x.device)
    if nb * k == 0:
        return idx, val  # nothing to select: no launch
    fn = _build.entry("topk_block", "spk_topk_block", _ARGTYPES)
    _build.check(fn(x.data_ptr(), idx.data_ptr(), val.data_ptr(), nb, block,
                    k, x.device.index or 0, _build.stream_ptr(x)),
                 "topk_block launch")
    topk_block_raw.launches += 1
    return idx, val


#: Launches of the CUDA kernel (the plain version does not count).
topk_block_raw.launches = 0
