"""Roofline counts of one eager step: FLOPs, bytes, collectives, memory.

The counterpart of ``src/repro/launch/hlo_analysis.py``, under its name and
public names so that a reader finds it. PyTorch has no HLO: nothing is
compiled, so there is no module to parse. What this module counts instead
is what a step *dispatches*, by running it once under two dispatch modes
(:func:`analyze_step`):

- FLOPs: ``torch.utils.flop_counter.FlopCounterMode``, matrix products at
  2·M·N·K (``mm``, ``bmm``, ``addmm``, convolutions, attention), the
  forward, a checkpointed layer's recompute and the backward alike.
  Elementwise work is not counted (the reference adds one FLOP an output
  element of a fusion: noise next to the matmuls).
- HBM bytes: operand plus result bytes of every materialising ATen op, the
  *unfused* upper bound (the reference counts at XLA's fusion boundaries,
  which the eager port does not have). Views, aliases and allocations
  without a write are free.
- Collective bytes and counts by kind (:data:`COLLECTIVES`) at the
  ``torch.distributed`` ops (``c10d`` and DTensor's functional
  collectives): each call's operand, the bytes this rank hands to it.
- ``arg_bytes``, ``out_bytes``, ``temp_bytes`` from live storage:
  the arguments' storages, the results', and the peak of the storages the
  step itself held at once (its results included: the port donates no
  argument, so a step's new parameters live beside its old ones).

All quantities are per rank. The counts are the same on fake tensors
(``FakeTensorMode``: shapes without memory), CPU and CUDA tensors. Not
carried over: ``parse_module``, ``ModuleAnalyzer``, the trip-count rule and
``xla_flops_once`` — an eager step runs every layer and loop trip, so
nothing is counted once; ``xla_flops_once`` stays in
:meth:`Roofline.to_dict` as ``None``.

The rates are one card's, NVIDIA H100 80GB HBM3 at 700.00 W (NVIDIA's data
sheet, SXM part, dense, without sparsity).
"""
from __future__ import annotations

import weakref
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor

from repro_torch import compat

PEAK_FLOPS = 989e12          # bf16 dense FLOP/s, NVIDIA H100 80GB HBM3, 700.00 W
HBM_BW = 3.35e12             # bytes/s, NVIDIA H100 80GB HBM3, 700.00 W
LINK_BW = 450e9              # NVLink bytes/s a direction, NVIDIA H100 80GB HBM3

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "send/recv")

#: ATen collective op -> (kind, index of its operand argument).
_COLLECTIVE_OPS = {
    "_c10d_functional::all_gather_into_tensor": ("all-gather", 0),
    "_c10d_functional::all_gather_into_tensor_coalesced": ("all-gather", 0),
    "_c10d_functional::all_reduce": ("all-reduce", 0),
    "_c10d_functional::all_reduce_coalesced": ("all-reduce", 0),
    "_c10d_functional::reduce_scatter_tensor": ("reduce-scatter", 0),
    "_c10d_functional::reduce_scatter_tensor_coalesced": ("reduce-scatter",
                                                          0),
    "_c10d_functional::all_to_all_single": ("all-to-all", 0),
    "c10d::allgather_": ("all-gather", 1),
    "c10d::_allgather_base_": ("all-gather", 1),
    "c10d::allgather_into_tensor_coalesced_": ("all-gather", 1),
    "c10d::allreduce_": ("all-reduce", 0),
    "c10d::allreduce_coalesced_": ("all-reduce", 0),
    "c10d::reduce_scatter_": ("reduce-scatter", 1),
    "c10d::_reduce_scatter_base_": ("reduce-scatter", 1),
    "c10d::reduce_scatter_tensor_coalesced_": ("reduce-scatter", 1),
    "c10d::alltoall_": ("all-to-all", 1),
    "c10d::alltoall_base_": ("all-to-all", 1),
    "c10d::send": ("send/recv", 0),
}

#: Ops that move no bytes: allocation without a write, waits, metadata.
_FREE_OPS = {
    "aten::empty", "aten::empty_like", "aten::empty_strided",
    "aten::new_empty", "aten::new_empty_strided", "aten::detach",
    "aten::lift_fresh", "aten::_local_scalar_dense", "aten::sym_size",
    "aten::sym_stride", "aten::sym_numel", "aten::sym_storage_offset",
    "aten::is_same_size", "_c10d_functional::wait_tensor",
    "_c10d_functional::_wrap_tensor_autograd", "c10d::recv_",
    "c10d::barrier", "c10d::monitored_barrier_",
    "prim::device", "prim::layout",  # a fake tensor's metadata queries
}


def _tensors(x):
    """Every tensor in ``x`` (nested lists, tuples and dicts), a DTensor
    as its local shard."""
    if isinstance(x, DTensor):
        yield x.to_local()
    elif isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from _tensors(y)
    elif isinstance(x, dict):
        for y in x.values():
            yield from _tensors(y)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _is_view(func) -> bool:
    """Whether every result of ``func`` aliases an input it does not
    write (a view: no bytes move)."""
    returns = func._schema.returns
    return bool(returns) and all(
        r.alias_info is not None and not r.alias_info.is_write
        for r in returns)


@dataclass
class Cost:
    """Bytes and collectives of the ops dispatched under :func:`analyze_step`
    (the reference's ``Cost`` less its FLOPs, which ``FlopCounterMode``
    counts, and its trip-count ``add``)."""
    bytes: float = 0.0
    coll: Dict[str, float] = field(default_factory=dict)
    coll_n: Dict[str, int] = field(default_factory=dict)

    @property
    def coll_bytes(self) -> float:
        return sum(self.coll.values())


class _Counter(compat.torch_dispatch_mode()):
    """Bytes, collectives and live storage of every op dispatched under
    it (FLOPs come from ``FlopCounterMode`` beside it)."""

    def __init__(self):
        super().__init__()
        self.cost = Cost()
        self.live = 0
        self.peak = 0
        self._seen: "weakref.WeakSet" = weakref.WeakSet()

    def exclude(self, tree) -> None:
        """Never count the storages of ``tree``'s tensors (the arguments,
        and whatever views of them the step makes)."""
        for t in _tensors(tree):
            self._seen.add(t.untyped_storage())

    def own(self, storage) -> None:
        """Count ``storage`` as the step's from now until it dies."""
        if storage in self._seen:
            return
        self._seen.add(storage)
        n = storage.nbytes()
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(storage, self._free, n)

    def _free(self, n: int) -> None:
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func._schema.name
        coll = _COLLECTIVE_OPS.get(name)
        if coll is not None:
            kind, at = coll
            operand = sum(_nbytes(t) for t in _tensors(args[at]))
            self.cost.coll[kind] = self.cost.coll.get(kind, 0.0) + operand
            self.cost.coll_n[kind] = self.cost.coll_n.get(kind, 0) + 1
        if name not in _FREE_OPS and not _is_view(func):
            self.cost.bytes += (sum(_nbytes(t) for t in _tensors(args))
                                + sum(_nbytes(t) for t in _tensors(kwargs))
                                + sum(_nbytes(t) for t in _tensors(out)))
        for t in _tensors(out):
            self.own(t.untyped_storage())
        return out


def _storage_bytes(tree) -> int:
    """The bytes of the distinct storages of the tensors in ``tree``."""
    seen, total = set(), 0
    for t in _tensors(tree):
        s = t.untyped_storage()
        if id(s) not in seen:
            seen.add(id(s))
            total += s.nbytes()
    return total


@dataclass
class Roofline:
    flops: float                 # per rank
    hbm_bytes: float             # per rank
    coll_bytes: float            # per rank
    coll_by_kind: Dict[str, float]
    coll_counts: Dict[str, int]
    xla_flops_once: Optional[float]  # not applicable: always None
    arg_bytes: int
    out_bytes: int
    temp_bytes: int

    @property
    def t_compute(self) -> float:
        return self.flops / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.coll_bytes / LINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def roofline_fraction(self) -> float:
        """compute-term share of the critical path: T_comp / max(terms).
        1.0 = compute-bound at the roofline."""
        worst = max(self.t_compute, self.t_memory, self.t_collective)
        return self.t_compute / worst if worst > 0 else 0.0

    def to_dict(self) -> dict:
        return {
            "flops": self.flops, "hbm_bytes": self.hbm_bytes,
            "coll_bytes": self.coll_bytes, "coll_by_kind": self.coll_by_kind,
            "coll_counts": self.coll_counts,
            "xla_flops_once": self.xla_flops_once,
            "t_compute": self.t_compute, "t_memory": self.t_memory,
            "t_collective": self.t_collective, "bottleneck": self.bottleneck,
            "roofline_fraction": self.roofline_fraction,
            "arg_bytes": self.arg_bytes, "out_bytes": self.out_bytes,
            "temp_bytes": self.temp_bytes,
        }


def analyze_step(fn, *args, **kwargs) -> Tuple[Any, Roofline]:
    """``(fn(*args, **kwargs), its Roofline)``: ``fn`` run once under the
    counting modes, on whatever tensors it is given (fake, CPU or CUDA;
    under a ``FakeTensorMode`` the caller has entered, the counts come
    without memory or time)."""
    from torch.utils.flop_counter import FlopCounterMode

    arg_bytes = _storage_bytes((args, kwargs))
    counter = _Counter()
    counter.exclude((args, kwargs))
    with FlopCounterMode(display=False) as flops, counter:
        out = fn(*args, **kwargs)
    c = counter.cost
    return out, Roofline(
        flops=float(flops.get_total_flops()), hbm_bytes=c.bytes,
        coll_bytes=c.coll_bytes, coll_by_kind=dict(c.coll),
        coll_counts=dict(c.coll_n), xla_flops_once=None,
        arg_bytes=arg_bytes, out_bytes=_storage_bytes(out),
        temp_bytes=counter.peak)
