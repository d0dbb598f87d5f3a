"""Streaming SpKAdd — the paper's stated future work (§V).

The port of ``src/repro/core/streaming.py``. "When [the in-memory
assumption] is not true (because the memory is limited or matrices arrive
in batches), we can still arrange input matrices in multiple batches and
then use SpKAdd for each batch."

``StreamingAccumulator`` implements exactly that: matrices arrive one at a
time; every ``batch_k`` arrivals form a *window* that is combined with a
k-way SpKAdd into the running sum, whose capacity is budgeted (heavy-entry
truncation when the running nnz would exceed it — the same budget discipline
as top-k gradient sparsification). The batch buffer bounds resident memory
at O(batch_k · window_batch · nnz_in + cap_budget) independent of the
stream length.

Additions go through the regime engine (``spkadd_run``; default
``algorithm="auto"`` dispatches per the paper's Fig. 2 regions), and with
``window_batch > 1`` the accumulator buffers several windows and reduces
them with **one** batched engine call (``spkadd_batched_ragged`` —
capacities may differ across windows) before a single k-way merge into the
running sum. Every result is the reference's, bit for bit.

Use cases mirrored from the paper: streaming graph-snapshot accumulation,
mini-batched sparse gradient aggregation.
"""
from __future__ import annotations

from typing import List, Tuple

import torch

from repro_torch import obs
from repro_torch.core.engine import spkadd_batched_ragged, spkadd_run
from repro_torch.core.sparse import (PaddedCOO, make_empty, resolve_device,
                                     sentinel_key, stable_argsort, top_k)


def truncate_by_magnitude(a: PaddedCOO, cap: int) -> PaddedCOO:
    """Keep the ``cap`` heaviest entries (|value|); output key-sorted.

    The reference ranks ``where(valid, |vals|, -1.0)`` with ``lax.top_k``:
    largest first, ties to the lower index, a NaN above every number, and
    the sentinel slots' ``-1.0`` below every valid magnitude. The port ranks
    the same masked magnitudes by a stable descending sort (not
    ``sparse.top_k_abs``, whose ``abs`` would lift the ``-1.0`` to ``1.0``);
    the key sort after it is the counted ``stable_argsort``, as in the
    reference."""
    if cap >= a.cap:
        return a
    sent = sentinel_key(a.shape)
    mag = torch.where(a.keys != sent, a.vals.abs(), -1.0)
    _, idx = top_k(mag, cap)
    keys = torch.gather(a.keys, -1, idx)
    vals = torch.gather(a.vals, -1, idx)
    valid = keys != sent
    vals = torch.where(valid, vals, 0.0)
    order = stable_argsort(keys)
    return PaddedCOO(keys=torch.gather(keys, -1, order),
                     vals=torch.gather(vals, -1, order),
                     nnz=torch.minimum(a.nnz, valid.sum(-1)).to(torch.int32),
                     shape=a.shape)


class StreamingAccumulator:
    """Windowed streaming sum with a budgeted running state.

    ``batch_k`` matrices per window; ``window_batch`` windows are buffered
    and reduced together through the batched engine (one call for all
    buffered windows) — set it > 1 when arrivals are bursty and you want the
    reduction amortized across windows. The running sum lives on
    ``device`` (``None``: the CUDA card).
    """

    def __init__(self, shape: Tuple[int, int], *, batch_k: int = 8,
                 cap_budget: int = 1 << 16, algorithm: str = "auto",
                 window_batch: int = 1, dtype=torch.float32, device=None):
        self.shape = shape
        self.batch_k = batch_k
        self.cap_budget = min(cap_budget, shape[0] * shape[1])
        self.algorithm = algorithm
        self.window_batch = max(1, window_batch)
        self._buffer: List[PaddedCOO] = []
        self._sum: PaddedCOO = make_empty(shape, self.cap_budget, dtype,
                                          device=resolve_device(device))
        self.device = self._sum.keys.device  # cuda -> cuda:N
        self.n_seen = 0
        self.n_flushes = 0

    def push(self, a: PaddedCOO) -> None:
        if a.shape != self.shape:
            raise ValueError(f"stream matrices must share the shape: got "
                             f"{a.shape}, accumulator is {self.shape}")
        if a.vals.dtype != self._sum.vals.dtype:
            # a float64 push would silently upcast the running sum on the
            # next flush and break the bitwise contract downstream
            raise ValueError(f"stream matrices must share the accumulator "
                             f"dtype: got {a.vals.dtype}, accumulator is "
                             f"{self._sum.vals.dtype}")
        if a.keys.device != self.device:
            raise ValueError(f"stream matrices must lie on the accumulator's "
                             f"device: got {a.keys.device}, accumulator is "
                             f"on {self.device}")
        self._buffer.append(a)
        self.n_seen += 1
        if len(self._buffer) >= self.batch_k * self.window_batch:
            self.flush()

    def flush(self) -> None:
        if not self._buffer:
            return
        buffered = len(self._buffer)
        windows_n = -(-buffered // self.batch_k)
        with obs.span("streaming.flush", buffered=buffered,
                      windows=windows_n, batch_k=self.batch_k,
                      algorithm=self.algorithm, cap_budget=self.cap_budget):
            if buffered <= self.batch_k:
                # single window: one k-way add folds buffer and running sum
                combined = spkadd_run([self._sum] + self._buffer,
                                      algorithm=self.algorithm)
            else:
                # several buffered windows: reduce them all in one batched
                # engine call (ragged: window capacities may differ), then
                # one k-way merge into the running sum
                windows = [self._buffer[i:i + self.batch_k]
                           for i in range(0, len(self._buffer), self.batch_k)]
                sums = spkadd_batched_ragged(windows,
                                             algorithm=self.algorithm)
                combined = spkadd_run([self._sum] + sums,
                                      algorithm=self.algorithm)
            # re-budget: keep the heaviest-by-|value| cap_budget entries
            # (exact when the true nnz fits; a documented approximation when
            # it does not)
            new_sum = truncate_by_magnitude(combined, self.cap_budget)
        # commit point: everything below is exception-free, so a flush that
        # raised above leaves the accumulator coherent — buffer retained for
        # re-flush, counters still in sync with the untouched running sum
        self._sum = new_sum
        self._buffer = []
        self.n_flushes += 1
        obs.counter("streaming.flushes").inc()
        obs.histogram("streaming.flush_size").observe(buffered)

    @property
    def value(self) -> PaddedCOO:
        self.flush()
        return self._sum

    def dense(self) -> torch.Tensor:
        return self.value.to_dense()
