"""Top-k sparsification with error feedback.

The port of ``src/repro/core/topk.py``: the paper's deep-learning
motivation (§I), "algorithmic sparsification of the gradient updates".
Two selectors:

- ``topk_global``: exact top-k by |value| over the flat tensor, through
  ``sparse.top_k_abs`` (largest first, ties to the lower index, as the
  reference's ``lax.top_k``).
- ``topk_block``: top-(k/blocks) within fixed-size blocks, the form real
  systems ship; on the card the selection is the block top-k kernel
  (``kernels/csrc/topk_block.cu``), on the CPU its plain version.

Error feedback: the untransmitted residual is carried into the next step
so compression error doesn't bias the descent direction. Every function
follows its input's device and returns the reference's bits.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from repro_torch.core.sparse import top_k_abs
from repro_torch.kernels import ops as _ops


class SparseUpdate(NamedTuple):
    """Flat sparse tensor update: fixed-width (idx, val) streams."""
    idx: torch.Tensor  # int32[k], position in the flat tensor; size marks pad
    val: torch.Tensor  # float[k], 0 in pad slots
    size: int          # flat tensor length


def topk_global(x: torch.Tensor, k: int) -> SparseUpdate:
    flat = x.reshape(-1)
    k = min(k, flat.shape[0])
    idx = top_k_abs(flat, k)
    return SparseUpdate(idx.to(torch.int32), flat[idx], flat.shape[0])


def topk_block(x: torch.Tensor, k: int, block: int = 4096) -> SparseUpdate:
    """Per-block top-k; total budget ~= k (rounded to a block multiple).

    The flat tensor is zero-padded to ``nb * block``; each block gives
    ``max(1, k // nb)`` entries, largest ``|x|`` first, ties to the lower
    index; selected padding comes back as index ``size``, value 0."""
    flat = x.reshape(-1)
    size = flat.shape[0]
    if size <= block or k >= size:
        return topk_global(x, k)
    nb = (size + block - 1) // block
    per = max(1, k // nb)
    flat_idx, vals = _ops.topk_block(flat, k=per, block=block)
    valid = flat_idx < size
    flat_idx = torch.where(valid, flat_idx, size)
    vals = torch.where(valid, vals, 0.0)
    return SparseUpdate(flat_idx, vals, size)


def global_k(n: int, k_fraction: float) -> int:
    """The unsharded top-k budget for a flat tensor of ``n`` elements."""
    return max(1, int(n * k_fraction))


def per_shard_k(n: int, k_fraction: float, n_shards: int) -> int:
    """Per-shard top-k budget under 1/``n_shards`` tensor sharding:
    ``ceil(global_k / n_shards)``, so every shard runs the same budget and
    the global one is kept to rounding; lossless at ``k_fraction == 1.0``."""
    if n_shards <= 1:
        return global_k(n, k_fraction)
    return max(1, -(-global_k(n, k_fraction) // n_shards))


def densify(u: SparseUpdate) -> torch.Tensor:
    """The dense ``(size,)`` tensor of ``u``: each value **added** into a
    zero, as the reference's ``.at[].add`` does (``0.0 + -0.0`` is
    ``+0.0``), with padding dropped.

    Precondition (held by both selectors): indices below ``size`` are
    unique, so a gather, an add and a scatter give the in-order add's bits
    with no atomics; only padding repeats, at slot ``size``, with +0.0."""
    out = torch.zeros(u.size + 1, dtype=u.val.dtype, device=u.val.device)
    i = torch.clamp(u.idx, 0, u.size).long()
    out[i] = out[i] + u.val
    return out[: u.size]


def sparsify_with_feedback(grad: torch.Tensor, residual: torch.Tensor, k: int,
                           selector: str = "global",
                           block: int = 4096) -> Tuple[SparseUpdate,
                                                       torch.Tensor]:
    """EF: compress (grad + residual); return update + new residual."""
    corrected = grad.reshape(-1) + residual
    if selector == "global":
        u = topk_global(corrected, k)
    elif selector == "block":
        u = topk_block(corrected, k, block=block)
    else:
        raise ValueError(f"unknown selector {selector!r}")
    new_residual = corrected - densify(u)
    return u, new_residual
