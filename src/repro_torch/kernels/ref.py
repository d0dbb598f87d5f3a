"""Plain PyTorch oracles, one per reference kernel (the port of
``src/repro/kernels/ref.py``).

Every fold here goes through the counted stable sort and the ordered
segment fold, so a value is its stream-order left fold from ``+0.0``, as
XLA's in-order scatter gives it in the reference.
"""
from __future__ import annotations

import torch

from repro_torch.core import sparse as _sparse
from repro_torch.kernels.segment import segment_fold


def spa_accumulate_ref(keys: torch.Tensor, vals: torch.Tensor, *, m: int,
                       n: int) -> torch.Tensor:
    """Dense scatter-add oracle: keys are CSC-linearized, >= m*n means
    padding. Returns the dense ``(m, n)`` f32 accumulator."""
    valid = keys < m * n
    k = torch.where(valid, keys, m * n).to(torch.int32)  # m*n: dropped
    v = torch.where(valid, vals, 0.0).to(torch.float32)
    order = _sparse.stable_argsort(k)
    flat = segment_fold(v[order], k[order], m * n)
    return flat.reshape(n, m).T


def hash_accumulate_ref(keys: torch.Tensor, vals: torch.Tensor, *, sent: int):
    """Key-grouped sums, returned sorted by key: (sorted unique keys padded
    with ``sent``, their summed values, distinct count)."""
    cap = keys.shape[0]
    order = _sparse.stable_argsort(keys)
    k_s = keys[order]
    valid = k_s != sent
    v_s = torch.where(valid, vals[order], 0.0).to(torch.float32)
    first = torch.ones_like(valid)
    first[1:] = k_s[1:] != k_s[:-1]
    is_new = first & valid
    gid = torch.clamp(torch.cumsum(is_new, 0, dtype=torch.int32) - 1, 0,
                      max(cap - 1, 0))
    out_vals = segment_fold(v_s, torch.where(valid, gid, cap), cap)
    out_keys = torch.full((cap + 1,), sent, dtype=torch.int32,
                          device=keys.device)
    out_keys[torch.where(is_new, gid, cap).long()] = k_s.to(torch.int32)
    nnz = is_new.sum(dtype=torch.int32)
    return out_keys[:cap], out_vals, nnz


def hash_symbolic_ref(keys: torch.Tensor, *, sent: int) -> torch.Tensor:
    """Distinct-valid-key count."""
    k_s = _sparse.stable_sort(keys)
    valid = k_s != sent
    first = torch.ones_like(valid)
    first[1:] = k_s[1:] != k_s[:-1]
    return (first & valid).sum(dtype=torch.int32)


def topk_block_ref(x: torch.Tensor, k: int, block: int):
    """Per-block top-k by |value| over a flat array reshaped to (-1, block).
    Returns (indices into flat x, values), both (num_blocks*k,)."""
    nb = x.shape[0] // block
    xb = x[: nb * block].reshape(nb, block)
    idx = _sparse.top_k_abs(xb, k)
    base = (torch.arange(nb, device=x.device) * block).unsqueeze(1)
    flat_idx = (base + idx).reshape(-1).to(torch.int32)
    return flat_idx, x[flat_idx.long()]
