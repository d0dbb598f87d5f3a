"""Hash-table helpers shared by the port's hash kernels.

The port's copy of the sizing rule and hash constant of
``src/repro/kernels/hash_accum.py``. The reference's Alg. 5/6 kernels in
that file (the faithful single-table hash accumulate and symbolic count)
are not ported yet; only the sliding-hash kernel (``hash_slide``) uses
these helpers so far.
"""
from __future__ import annotations

HASH_PRIME = 2654435761  # Knuth multiplicative constant


def hash_table_size(distinct_bound: int) -> int:
    """The table-sizing rule every hash kernel shares: the smallest power of
    two ``>= 2 * distinct_bound``, so the load factor can never exceed 0.5
    and expected probes stay O(1)."""
    size = 1
    while size < 2 * max(int(distinct_bound), 1):
        size *= 2
    return size
