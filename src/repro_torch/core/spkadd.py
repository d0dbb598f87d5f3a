"""The SpKAdd algorithm family (paper §II–III), kernel-free half.

The port of the part of ``src/repro/core/spkadd.py`` that needs no kernel
of its own: the symbolic phase, 2-way addition, and the incremental, tree
and sorted k-way algorithms. Each returns ``B = sum_i A_i`` for a list of
PaddedCOO matrices of one logical shape. The engine's regimes
(``core/engine.py``) carry the accumulator kernels; the family's
kernel-backed members (``spa``, ``vec``, ``blocked_spa``, ``hash``) are not
ported yet and raise a ``ValueError`` that says so.
"""
from __future__ import annotations

from typing import List, Sequence

import torch

from repro_torch.core.sparse import (PaddedCOO, compress, concat,
                                     sentinel_key, stable_sort, with_capacity)


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


ALGORITHMS = {
    "incremental": spkadd_incremental,
    "tree": spkadd_tree,
    "sorted": spkadd_sorted,
}

#: Members of the reference's family whose kernels are not ported yet.
NOT_YET_PORTED = ("spa", "vec", "blocked_spa", "hash")


def spkadd(mats: Sequence[PaddedCOO], algorithm: str = "sorted", **kw) -> PaddedCOO:
    """Front door: ``B = sum_i A_i`` with a selectable algorithm."""
    if algorithm in NOT_YET_PORTED:
        raise ValueError(
            f"SpKAdd algorithm {algorithm!r} is not yet ported to repro_torch "
            f"(not yet ported: {list(NOT_YET_PORTED)}); ported: "
            f"{sorted(ALGORITHMS)}; the engine's regime of that name is "
            f"reached through engine.spkadd_auto")
    if algorithm not in ALGORITHMS:
        raise ValueError(f"unknown SpKAdd algorithm {algorithm!r}; "
                         f"choose from {sorted(ALGORITHMS)}")
    return ALGORITHMS[algorithm](mats, **kw)
