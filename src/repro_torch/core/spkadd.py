"""The SpKAdd algorithm family (paper §II–III).

The port of ``src/repro/core/spkadd.py``. Each algorithm returns
``B = sum_i A_i`` for a list of PaddedCOO matrices of one logical shape:

=====================  ===============================================
paper algorithm        this module
=====================  ===============================================
2-way incremental      ``spkadd_incremental`` (fold-left of 2-way adds)
2-way tree             ``spkadd_tree`` (balanced reduction)
k-way heap             ``spkadd_sorted`` (sort + ordered segment fold)
k-way SPA              ``spkadd_spa`` (dense accumulator, ordered fold)
k-way hash             ``spkadd_hash`` (``kernels/hash_accum``)
k-way sliding SPA      ``spkadd_blocked_spa`` (``kernels/spa_accum``)
k-way sliding, vec     ``spkadd_vec`` (the same kernel, sorted stream)
=====================  ===============================================

The dense-accumulator members (``spa``, ``blocked_spa``, ``vec``) end in
:func:`_resparsify_flat`, which keeps the ``out_cap`` heaviest entries and
drops exact zeros; ``sorted`` and ``hash`` keep keys whose sum is exactly
zero. The engine's regimes (``core/engine.py``) are the production paths.
"""
from __future__ import annotations

from typing import List, Sequence

import torch

from repro_torch.core.sparse import (PaddedCOO, compress, concat,
                                     sentinel_key, sort_by_key,
                                     stable_argsort, stable_sort, top_k_abs,
                                     with_capacity)


# ---------------------------------------------------------------------------
# symbolic phase
# ---------------------------------------------------------------------------

def _distinct_flags(mats: Sequence[PaddedCOO]):
    keys = stable_sort(torch.cat([a.keys for a in mats], dim=-1))
    valid = keys != sentinel_key(mats[0].shape)
    first = torch.ones(keys.shape, dtype=torch.bool, device=keys.device)
    first[..., 1:] = keys[..., 1:] != keys[..., :-1]
    return keys, valid, first & valid


def symbolic_nnz(mats: Sequence[PaddedCOO]) -> torch.Tensor:
    """Exact nnz of the sum (distinct valid keys across all inputs); paper
    Alg. 6 with the hash table replaced by sort + adjacent compare."""
    _, _, is_new = _distinct_flags(mats)
    return is_new.sum(-1, dtype=torch.int32)


def symbolic_nnz_per_column(mats: Sequence[PaddedCOO]) -> torch.Tensor:
    """Per-column distinct-key counts — the load-balancing signal the paper
    uses for dynamic scheduling (§III-A). Integer counts, so any summation
    order is exact."""
    m, n = mats[0].shape
    keys, _, is_new = _distinct_flags(mats)
    col = torch.where(is_new, keys // m, n).long()
    return torch.bincount(col, minlength=n + 1)[:n].to(torch.int32)


# ---------------------------------------------------------------------------
# 2-way addition (the paper's ColAdd, whole-matrix because keys linearize CSC)
# ---------------------------------------------------------------------------

def two_way_add(a: PaddedCOO, b: PaddedCOO, cap: int | None = None) -> PaddedCOO:
    """Merge-add two sparse matrices. Output capacity defaults to
    cap_a + cap_b, the worst case nnz(A+B) = nnz(A) + nnz(B)."""
    out = compress(concat([a, b]))
    if cap is not None:
        out = with_capacity(out, cap)
    return out


# ---------------------------------------------------------------------------
# k-way algorithms
# ---------------------------------------------------------------------------

def spkadd_incremental(mats: Sequence[PaddedCOO]) -> PaddedCOO:
    """Paper Alg. 1: fold-left of 2-way adds (the O(k²) baseline)."""
    acc = mats[0]
    for a in mats[1:]:
        acc = two_way_add(acc, a)
    return acc


def spkadd_tree(mats: Sequence[PaddedCOO]) -> PaddedCOO:
    """Paper §II-B2: balanced binary reduction of 2-way adds (lg k levels)."""
    level: List[PaddedCOO] = list(mats)
    while len(level) > 1:
        nxt: List[PaddedCOO] = []
        for i in range(0, len(level) - 1, 2):
            nxt.append(two_way_add(level[i], level[i + 1]))
        if len(level) % 2 == 1:
            nxt.append(level[-1])
        level = nxt
    return level[0]


def spkadd_sorted(mats: Sequence[PaddedCOO]) -> PaddedCOO:
    """k-way merge analogue (paper's heap, §II-C1): one global stable sort of
    all input nonzeros + the ordered segment fold of duplicate keys."""
    return compress(concat(mats))


def _resparsify_flat(flat: torch.Tensor, shape, out_cap: int) -> PaddedCOO:
    """Dense ``(m*n,)`` key-ordered accumulator -> key-sorted PaddedCOO
    keeping the ``out_cap`` heaviest entries (exact when the true nnz
    fits), ties to the lower key as the reference's ``lax.top_k`` keeps
    them; exact zeros are dropped. The shared back half of every
    dense-accumulator algorithm."""
    idx = top_k_abs(flat, out_cap)
    vals = flat[idx]
    valid = vals != 0.0
    keys = torch.where(valid, idx.to(torch.int32), sentinel_key(shape))
    order = stable_argsort(keys)
    return PaddedCOO(keys=keys[order],
                     vals=torch.where(valid, vals, 0.0)[order],
                     nnz=valid.sum(dtype=torch.int32), shape=shape)


def _spa_flat(mats: Sequence[PaddedCOO]) -> torch.Tensor:
    """The dense SPA accumulator, flat in key order, in the inputs' value
    type. The reference scatter-adds each matrix in turn, which folds every
    key's values in operand order; a CUDA scatter-add does not keep that
    order, so the port takes the concatenated stream through one counted
    stable sort and the ordered segment fold (``PaddedCOO.to_dense``)."""
    return concat(mats).to_dense().T.reshape(-1)


def spkadd_spa(mats: Sequence[PaddedCOO], out_cap: int | None = None) -> PaddedCOO:
    """k-way SPA (paper Alg. 4): dense ``m×n`` accumulator, then one
    re-sparsification keeping at most ``out_cap`` entries (default: the sum
    of the input capacities, clipped to ``m*n``)."""
    m, n = mats[0].shape
    if out_cap is None:
        out_cap = sum(a.cap for a in mats)
    return _resparsify_flat(_spa_flat(mats), mats[0].shape,
                            min(out_cap, m * n))


def spkadd_spa_dense(mats: Sequence[PaddedCOO]) -> torch.Tensor:
    """SPA variant returning the dense ``(m, n)`` accumulator: the form the
    gradient-allreduce path consumes."""
    m, n = mats[0].shape
    return _spa_flat(mats).reshape(n, m).T


def spkadd_blocked_spa(mats: Sequence[PaddedCOO], block_rows: int | None = None,
                       smem_budget_bytes: int | None = None) -> PaddedCOO:
    """Sliding SPA (paper Alg. 7/8 with the cache as shared memory):
    ``kernels/spa_accum`` buckets the concatenated stream, unsorted, by row
    part and folds each part into its ``(block_rows, n)`` row tile; then
    one re-sparsification. ``smem_budget_bytes`` defaults to
    ``kernels.ops.spa_tile_budget`` of the inputs' device."""
    from repro_torch.kernels import ops as kops

    m, n = mats[0].shape
    cat = concat(mats)
    flat = kops.spa_accumulate_flat(cat.keys, cat.vals, m=m, n=n,
                                    block_rows=block_rows,
                                    smem_budget_bytes=smem_budget_bytes)
    return _resparsify_flat(flat, cat.shape, min(cat.cap, m * n))


def spkadd_vec(mats: Sequence[PaddedCOO], block_rows: int | None = None,
               smem_budget_bytes: int | None = None,
               fold: str = "auto") -> PaddedCOO:
    """The reference's lane-parallel sliding SpKAdd: the same SPA
    accumulation on the stable-sorted stream (one counted sort), with the fold
    name checked as the reference checks it; then one re-sparsification."""
    from repro_torch.kernels import ops as kops

    m, n = mats[0].shape
    cat = concat(mats)
    flat = kops.vec_accumulate_flat(cat.keys, cat.vals, m=m, n=n,
                                    block_rows=block_rows,
                                    smem_budget_bytes=smem_budget_bytes,
                                    fold=fold)
    return _resparsify_flat(flat, cat.shape, min(cat.cap, m * n))


def spkadd_hash(mats: Sequence[PaddedCOO]) -> PaddedCOO:
    """Faithful hash-table SpKAdd (paper Alg. 5) through
    ``kernels/hash_accum``: one table takes the concatenated stream in
    order, is compacted by one counted sort, and the result is sorted by
    key."""
    from repro_torch.kernels import ops as kops

    cat = concat(mats)
    keys, vals, nnz = kops.hash_accumulate(cat.keys, cat.vals,
                                           sent=sentinel_key(cat.shape))
    return sort_by_key(PaddedCOO(keys=keys, vals=vals, nnz=nnz,
                                 shape=cat.shape))


ALGORITHMS = {
    "incremental": spkadd_incremental,
    "tree": spkadd_tree,
    "sorted": spkadd_sorted,
    "spa": spkadd_spa,
    "vec": spkadd_vec,
    "blocked_spa": spkadd_blocked_spa,
    "hash": spkadd_hash,
}


def spkadd(mats: Sequence[PaddedCOO], algorithm: str = "sorted", **kw) -> PaddedCOO:
    """Front door: ``B = sum_i A_i`` with a selectable algorithm."""
    if algorithm not in ALGORITHMS:
        raise ValueError(f"unknown SpKAdd algorithm {algorithm!r}; "
                         f"choose from {sorted(ALGORITHMS)}")
    return ALGORITHMS[algorithm](mats, **kw)
