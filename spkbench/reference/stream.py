"""Plain reference of the multi-tenant stream service's results, and its
control in bfloat16.

The semantics (DESIGN.md §12, the service's contract): every tenant holds a
running sum of at most ``cap_budget`` entries. A push is admitted unless
the pending nonzeros would pass the soft watermark and the push would open
a new window (then it is deferred), or would pass the hard watermark.
Every ``batch_k`` admitted pushes of a tenant seal a window. A tick at time
``t`` flushes the bucket when it holds ``max_coflush_windows`` sealed
windows or its oldest sealed window was sealed ``flush_deadline`` or more
before ``t``: each tenant with sealed windows folds its sum and then every
sealed window's pushes, in order, key by key from +0.0 in float32, and
keeps the ``cap_budget`` heaviest entries (ties to the lower key). A drain
seals every open window and flushes every tenant that has one.

The simulation is NumPy on the host and shares no code with the service.
Load shedding (past the hard watermark) is not modelled: it raises.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np


def bf16_round(x: np.ndarray) -> np.ndarray:
    """float32 ``x`` rounded to bfloat16 (nearest even), kept as float32."""
    bits = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    lsb = (bits >> 16) & 1
    return ((bits + 0x7FFF + lsb) & 0xFFFF0000).astype(np.uint32).view(
        np.float32)


class _Tenant:
    def __init__(self):
        self.keys = np.zeros(0, dtype=np.int64)
        self.vals = np.zeros(0, dtype=np.float32)
        self.open: List[int] = []
        self.sealed: List[tuple] = []   # (t_sealed, [push indices])
        self.counts = {"admitted": 0, "deferred": 0, "flushed_windows": 0,
                       "flushes": 0}


class StreamReference:
    """The service's results on a replayed event stream. ``keys``/``vals``
    are the pushes (host arrays, ``(count, nnz)``); ``precision`` is
    ``"float32"`` for the reference and ``"bfloat16"`` for the control, which
    holds every pushed value and every running sum in bfloat16."""

    def __init__(self, cfg: dict, keys: np.ndarray, vals: np.ndarray,
                 precision: str = "float32"):
        if precision not in ("float32", "bfloat16"):
            raise ValueError(f"unknown precision {precision!r}")
        self.cap = min(int(cfg["cap_budget"]),
                       cfg["shape"][0] * cfg["shape"][1])
        self.batch_k = int(cfg["batch_k"])
        self.soft = int(cfg["soft_pending_nnz"])
        self.hard = int(cfg["hard_pending_nnz"])
        self.deadline = float(cfg["flush_deadline"])
        self.max_windows = int(cfg["max_coflush_windows"])
        self.keys = keys
        self.vals = bf16_round(vals) if precision == "bfloat16" else vals
        self.precision = precision
        self.tenants = [_Tenant() for _ in range(int(cfg["tenants"]))]
        self.pending = 0
        self.flushes = 0

    def push(self, tenant: int, push: int) -> bool:
        st = self.tenants[tenant]
        nnz = self.keys.shape[1]
        if self.pending + nnz > self.hard:
            raise NotImplementedError("the reference does not model load "
                                      "shedding past the hard watermark")
        if self.pending + nnz > self.soft and not st.open:
            st.counts["deferred"] += 1
            return False
        st.counts["admitted"] += 1
        self.pending += nnz
        st.open.append(push)
        return True

    def seal_full(self, tenant: int, t: float) -> None:
        st = self.tenants[tenant]
        if len(st.open) >= self.batch_k:
            st.sealed.append((t, st.open))
            st.open = []

    def tick(self, t: float) -> int:
        ready = [st for st in self.tenants if st.sealed]
        if not ready:
            return 0
        total = sum(len(st.sealed) for st in ready)
        oldest = min(w[0] for st in ready for w in st.sealed)
        if total >= self.max_windows or t - oldest >= self.deadline:
            return self._flush(ready)
        return 0

    def drain(self, t: float) -> int:
        for st in self.tenants:
            if st.open:
                st.sealed.append((t, st.open))
                st.open = []
        ready = [st for st in self.tenants if st.sealed]
        return self._flush(ready) if ready else 0

    def _flush(self, ready) -> int:
        self.flushes += 1
        folded = 0
        for st in ready:
            pushes = [p for _, w in st.sealed for p in w]
            keys = np.concatenate([st.keys] + [self.keys[p] for p in pushes])
            vals = np.concatenate([st.vals] + [self.vals[p] for p in pushes])
            uniq, inv = np.unique(keys, return_inverse=True)
            out = np.zeros(uniq.size, dtype=np.float32)
            np.add.at(out, inv, vals)  # in stream order, from +0.0
            if uniq.size > self.cap:
                heavy = np.argsort(-np.abs(out), kind="stable")[:self.cap]
                keep = np.sort(heavy)
                uniq, out = uniq[keep], out[keep]
            st.keys = uniq
            st.vals = bf16_round(out) if self.precision == "bfloat16" else out
            n = len(pushes) * self.keys.shape[1]
            self.pending -= n
            folded += n
            st.counts["flushed_windows"] += len(st.sealed)
            st.counts["flushes"] += 1
            st.sealed = []
        return folded


def replay(cfg: dict, events, upto: int, keys: np.ndarray, vals: np.ndarray,
           drain_t: float, precision: str = "float32") -> StreamReference:
    """The reference after events ``[0, upto)`` of ``events`` and a drain."""
    ref = StreamReference(cfg, keys, vals, precision)
    for i in range(upto):
        tenant, t = int(events.tenant[i]), float(events.t[i])
        if tenant < 0:
            ref.tick(t)
        elif ref.push(tenant, int(events.push[i])):
            ref.seal_full(tenant, t)
    ref.drain(drain_t)
    return ref


def value_gap(got: Dict[int, tuple], ref: StreamReference) -> float:
    """The largest gap, over tenants and over the union of their keys,
    between the service's value and the reference's (a key that one side
    lacks counts as 0 there), over the largest reference magnitude of that
    tenant. ``got`` maps a tenant to its (keys, vals) host arrays."""
    worst = 0.0
    for i, st in enumerate(ref.tenants):
        gk, gv = got[i]
        keys = np.union1d(gk, st.keys)
        a = np.zeros(keys.size, dtype=np.float64)
        b = np.zeros(keys.size, dtype=np.float64)
        a[np.searchsorted(keys, gk)] = gv
        b[np.searchsorted(keys, st.keys)] = st.vals
        scale = float(np.abs(b).max()) if b.size else 0.0
        diff = float(np.abs(a - b).max()) if keys.size else 0.0
        gap = diff / scale if scale > 0 else diff
        worst = max(worst, gap if gap == gap else float("inf"))  # NaN: worst
    return worst


def count_gap(got: Dict[int, dict], ref: StreamReference) -> int:
    """How many of the tenants' counts (admitted, deferred, flushed
    windows, flushes) differ from the reference's."""
    return sum(int(got[i][k] != st.counts[k])
               for i, st in enumerate(ref.tenants) for k in st.counts)
