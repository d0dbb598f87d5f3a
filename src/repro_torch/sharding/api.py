"""Sharding rules, the mesh context and the logical-axis constraint helper.

The port of ``src/repro/sharding/api.py`` onto ``torch.distributed.tensor``
(DTensor). Models are written against *logical* axes (batch, seq, heads,
dff, vocab, experts, …); :data:`RULES` maps them to mesh axes. A spec is
data: a :class:`PartitionSpec`, one entry per tensor dim, each ``None``, a
mesh-axis name or a tuple of names (JAX's ``PartitionSpec`` as a tuple).
Placement is DTensor's: :func:`spec_placements` turns a spec on a mesh into
one ``Placement`` per mesh dim.

A mesh is a ``DeviceMesh`` with named dims or a :class:`MeshShape` (names
and sizes, no ranks): every function that builds a spec works from the
axis names and sizes alone, so the specs of a 16 x 16 or 2 x 16 x 16
production mesh can be worked out without its 256 or 512 ranks.

Default mapping (FSDP×TP, MaxText-style):
  batch    -> data        heads/dff/vocab/experts -> model
  fsdp     -> data (parameter second-dim sharding = ZeRO-3 gather-at-use)
  pod      -> composes with data (batch/fsdp shard over ('pod', 'data'))

The port's models do not call :func:`shard` where the reference's call
its ``shard``: those calls are GSPMD layout hints that change no value,
and the port's sharded train step (``train/step.py``) computes on gathered
local tensors, where a hint would do nothing. :func:`shard` is kept for
code that holds DTensors: with no mesh, or on a plain tensor, it returns
its input.

A statistic the reference takes over the whole batch under ``jit`` (the
MoE's capacity and router load) needs the other ranks' rows when each
rank computes on its own: the sharded step says where they are with
:func:`row_split_context`, and the model reads it with
:func:`get_row_split`.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard

_state = threading.local()

RULES = {
    "batch": "data",
    "fsdp": "data",
    "seq": None,          # sequence kept unsharded by default (SP opt-in)
    "seq_sp": "model",    # SP: residual-stream sequence dim on the TP axis
    "heads": "model",
    "kv_heads": "model",
    "dff": "model",
    "vocab": "model",
    "experts": "model",
    "capacity": "data",
    "d_model": None,
    "head_dim": None,
    "state": None,
}


class PartitionSpec(tuple):
    """One entry per tensor dim: ``None`` (unsharded), a mesh-axis name, or
    a tuple of names (sharded over their product, the first major)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


class MeshShape(NamedTuple):
    """A mesh's axis names and sizes, without ranks."""
    axis_names: Tuple[str, ...]
    shape: Tuple[int, ...]


def mesh_axes(mesh) -> Dict[str, int]:
    """``{axis name: size}`` in mesh-dim order, of a ``DeviceMesh`` or a
    :class:`MeshShape`."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is None:
        names = getattr(mesh, "axis_names", None)
    if names is None:
        raise ValueError("the mesh has no axis names")
    return dict(zip(names, tuple(mesh.shape)))


def spec_placements(spec, mesh) -> tuple:
    """One DTensor ``Placement`` per dim of ``mesh``: ``Shard(d)`` where
    ``spec`` puts that mesh axis on tensor dim ``d``, else ``Replicate()``.
    A tuple entry such as ``("pod", "data")`` shards its dim over each of
    those mesh dims, the first major (JAX's device order for that spec),
    so its axes must come in mesh-dim order."""
    names = list(mesh_axes(mesh))
    out = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        axes = (() if entry is None else (entry,) if isinstance(entry, str)
                else tuple(entry))
        for ax in axes:
            if ax not in names:
                raise ValueError(f"spec {spec} names {ax!r}, not an axis "
                                 f"of the mesh {names}")
        idx = [names.index(ax) for ax in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry} is not in mesh-dim order "
                             f"{names}")
        for i in idx:
            if isinstance(out[i], Shard):
                raise ValueError(f"spec {spec} uses axis {names[i]!r} twice")
            out[i] = Shard(dim)
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh: where each tensor dim goes, and as DTensor
    placements (:func:`spec_placements`)."""
    mesh: Any
    spec: PartitionSpec

    @property
    def placements(self) -> tuple:
        return spec_placements(self.spec, self.mesh)


def set_mesh(mesh) -> None:
    _state.mesh = mesh


def get_mesh():
    return getattr(_state, "mesh", None)


@contextlib.contextmanager
def mesh_context(mesh):
    prev = get_mesh()
    set_mesh(mesh)
    try:
        yield mesh
    finally:
        set_mesh(prev)


def logical_to_physical(*logical: Optional[str]) -> PartitionSpec:
    """Translate logical axis names to a spec under RULES. A logical axis
    of None (or one that maps to None) stays unsharded. When the mesh has
    a 'pod' axis, 'batch'/'fsdp' shard over ('pod', 'data') jointly."""
    mesh = get_mesh()
    pod = mesh is not None and "pod" in mesh_axes(mesh)
    out = []
    for name in logical:
        ax = RULES.get(name) if name else None
        if ax == "data" and pod and name in ("batch", "fsdp"):
            out.append(("pod", "data"))
        else:
            out.append(ax)
    return P(*out)


def named_sharding(*logical: Optional[str]) -> Optional[NamedSharding]:
    """The logical spec on the active mesh (its ``mesh`` and
    ``placements``), or ``None`` with no mesh."""
    mesh = get_mesh()
    if mesh is None:
        return None
    return NamedSharding(mesh, logical_to_physical(*logical))


def shard(x, *logical: Optional[str]):
    """``x`` redistributed to the logical spec when a mesh context is active
    and ``x`` is a DTensor; ``x`` itself otherwise."""
    sh = named_sharding(*logical)
    if sh is None or not isinstance(x, DTensor):
        return x
    return x.redistribute(sh.mesh, sh.placements)


@dataclasses.dataclass(frozen=True)
class RowSplit:
    """A global batch's rows in blocks over the mesh dims ``dims`` of
    ``mesh`` (the first major), one block a rank: the layout the sharded
    train step computes on."""
    mesh: Any
    dims: Tuple[int, ...]

    @property
    def count(self) -> int:
        return math.prod(self.mesh.size(i) for i in self.dims)

    @property
    def index(self) -> int:
        """This rank's block."""
        idx = 0
        for i in self.dims:
            idx = idx * self.mesh.size(i) + self.mesh.get_local_rank(i)
        return idx

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """``(count, *x.shape)``: every block's ``x`` in row order, the
        same on every rank (all-gathers over the dims, the last first)."""
        out = x.contiguous()
        for i in reversed(self.dims):
            parts = [torch.empty_like(out) for _ in range(self.mesh.size(i))]
            dist.all_gather(parts, out, group=self.mesh.get_group(i))
            out = torch.stack(parts)
        return out.reshape((self.count,) + tuple(x.shape))


# Process-wide, not thread-local: the recompute of a checkpointed layer
# runs on autograd's device thread.
_row_split: Optional[RowSplit] = None


def get_row_split() -> Optional[RowSplit]:
    """The layout of the batch rows the model is being run on, or ``None``
    (this rank holds the whole batch)."""
    return _row_split


@contextlib.contextmanager
def row_split_context(split: Optional[RowSplit]):
    # a layout the model reads (on autograd's device thread too), not a
    # counter or a gauge
    global _row_split  # spkaddlint: disable=SPK103
    prev, _row_split = _row_split, split
    try:
        yield split
    finally:
        _row_split = prev
