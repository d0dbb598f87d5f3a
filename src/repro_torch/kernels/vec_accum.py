"""The in-tile fold, as one plain PyTorch function, and the store-count oracle.

The reference (``src/repro/kernels/vec_accum.py``) has three in-tile folds
for the TPU — a serial scatter, a bitonic sort-fold and a one-hot MXU fold —
and pins them bitwise equal to each other: each key's values fold left to
right, in stream order, continuing from the tile's current value. The
bitonic network and the one-hot matmul are TPU lane tricks; what they
compute is that one fold. So the port has one plain fold,
:func:`fold_runs`, which is the semantics of all three, and the CUDA
kernels (``csrc/partition.cu``, ``csrc/segment_fold.cu``,
``csrc/spa_accum.cu``) fold each slot's values in the same order.

:data:`FOLDS` keeps the reference's fold names, all of which name this one
fold; :func:`apply_fold` validates a name and folds a stream in any order. The reference's per-fold counters (``engine.partitioned.fold.*``)
have no counterpart in the port.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import xla_float

#: The reference's fold names (all three are one fold here).
FOLDS = ("serial", "sort", "onehot")


def fold_runs(tile: torch.Tensor, slot: torch.Tensor, vals: torch.Tensor,
              valid: torch.Tensor) -> torch.Tensor:
    """Fold a stream into a tile, each run left to right in stream order,
    starting from the tile's current value. Returns a new tile.

    ``tile`` is ``(B, T)``; ``slot``/``vals``/``valid`` are ``(B, L)``:
    element ``(b, i)`` adds ``vals[b, i]`` to ``tile[b, slot[b, i]]`` when
    ``valid[b, i]``. Precondition (held by every caller: the stream is
    sorted): among the valid elements of a row, equal slots are contiguous.

    The round-robin fold of the reference's ``vec_accum.fold_runs``,
    vectorised over runs: step ``j`` adds element ``j`` of every run still
    longer than ``j`` to that run's total, so each total is built strictly
    left to right and the serial depth is the longest run. Runs already
    exhausted are left untouched (not given ``+ 0.0``), so a ``-0.0`` in the
    tile keeps its sign. Each add is XLA's (:func:`xla_float.add_as`):
    subnormals flushed, a bf16 total rounded after every add, a NaN to the
    quiet NaN of its sign.
    """
    B, T = tile.shape
    out = tile.clone().reshape(-1)
    row = torch.arange(B, device=tile.device).unsqueeze(1) * T
    tgt = (slot.long() + row)[valid]   # row-major: stream order per row
    v = vals[valid].to(tile.dtype)
    n = tgt.numel()
    if n == 0:
        return out.view(B, T)
    head = torch.ones(n, dtype=torch.bool, device=tile.device)
    head[1:] = tgt[1:] != tgt[:-1]
    starts = head.nonzero().squeeze(1)
    lengths = torch.diff(starts, append=starts.new_tensor([n]))
    heads = tgt[starts]
    totals = out[heads]
    for j in range(int(lengths.max())):
        live = lengths > j
        step = xla_float.add_as(totals, v[(starts + j).clamp(max=n - 1)])
        totals = torch.where(live, step, totals)
    out[heads] = totals
    return out.view(B, T)


def apply_fold(fold: str, tile: torch.Tensor, slot: torch.Tensor,
               vals: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """The reference's in-tile fold by name, on a stream in **any** order.

    ``fold`` must be one of :data:`FOLDS`; all three name one result: each
    slot's valid values folded left to right in stream order, continuing
    from the tile's value. The stream is first sorted stably by slot (not a
    counted sort: the reference's in-kernel folds are not counted either),
    which groups each slot's values without reordering them, then
    :func:`fold_runs` folds the runs. Shapes as in :func:`fold_runs`.
    """
    if fold not in FOLDS:
        raise ValueError(f"unknown fold {fold!r}; one of {FOLDS}")
    T = tile.shape[-1]
    order = torch.argsort(torch.where(valid, slot.long(), T), dim=-1,
                          stable=True)
    return fold_runs(tile, torch.gather(slot, -1, order),
                     torch.gather(vals, -1, order),
                     torch.gather(valid, -1, order))


def chunk_store_counts(keys, *, m: int, n: int, block_rows: int,
                       chunk: int) -> dict:
    """Serial-store counts per TPU fold for a given input stream, as the
    reference's row-tiled sliding grid would see it: the serial scatter
    issues ``chunk`` stores per (part, chunk) cell; the sort-fold one store
    per distinct in-band slot per cell; the one-hot fold none.

    Host-side numpy, a copy of the reference's oracle — observability only.
    """
    keys = np.asarray(keys)
    parts = (m + block_rows - 1) // block_rows
    cap = len(keys)
    cap_pad = ((max(cap, 1) + chunk - 1) // chunk) * chunk
    num_chunks = cap_pad // chunk
    keys_p = np.full(cap_pad, m * n, dtype=np.int64)
    keys_p[:cap] = keys
    keys_sorted = np.sort(keys_p, kind="stable")
    serial = parts * num_chunks * chunk
    vec = 0
    for p in range(parts):
        row_lo, row_hi = p * block_rows, (p + 1) * block_rows
        for c in range(num_chunks):
            ck = keys_sorted[c * chunk:(c + 1) * chunk]
            rows = ck % m
            in_band = (ck < m * n) & (rows >= row_lo) & (rows < row_hi)
            vec += len(np.unique(ck[in_band]))
    return {"serial": serial, "sort_fold": vec, "onehot_fold": 0,
            "parts": parts, "num_chunks": num_chunks}
