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

The reference's models call its ``shard`` with GSPMD layout hints, and
XLA then gathers each layer's weights over ``data`` where it uses them and
splits heads, ``d_ff`` and the vocabulary over ``model``. The port says
the same in its models' own code (the last section of this module): the
sharded train step (``train/step.py``) hands a model each parameter leaf
as a :class:`Placed` (this rank's shard and its placement); a layer
gathers its leaves where it uses them (:func:`gather_at_use`: over the
data axes, and over ``model`` too unless the block computes on its
``model`` shard), and the gradient comes back as the mean over the data
axes into the leaf's own shard when that use's backward ends. A block
that computes on its ``model`` shard (every family's attention on its
heads, by :func:`attn_split` and :func:`attn_weights`; the MLPs on their
``d_ff`` columns; the Mamba2 block on its SSM heads; the MoE's experts;
the embedding and loss on the vocabulary) takes :func:`model_split`'s
layout and brackets its products with the Megatron pair
:func:`copy_to_model` and :func:`sum_over_model`; a statistic over a dim
split over ``model`` that each rank uses for its own part (the Mamba2
gated norm's mean of squares) is summed by :func:`total_over_model`.
:func:`shard` itself is kept for code that holds DTensors: with no mesh,
or on a plain tensor (every activation of the port's models), it returns
its input.

A statistic the reference takes over the whole batch under ``jit`` (the
MoE's capacity and router load) needs the other ranks' rows when each
rank computes on its own: the sharded step says where they are with
:func:`row_split_context`, and the model reads it with
:func:`get_row_split`. A movement whose output each rank uses for rows of
its own (the MoE's tokens to their slot's owner and back) is
:func:`redistributed`, whose backward placements are stated.

The serving steps hand a model the same :class:`Placed` leaves on the
TP-only serving layout, in the leaves' own dtype. A decode step moves no
weight: a token's activation whose ``model`` block is no block of heads
is all-gathered (:func:`gather_over_model`), and the KV caches lie as the
reference's ``cache_spec`` splits them.

Sequence parallelism (the reference's ``seq_sp``, a model config's
``use_sp``) splits the residual stream's positions over ``model``
(:func:`seq_split`, :func:`seq_block`): each rank computes its block of
them on weights gathered whole, whose gradients are each rank's part
summed over ``model`` (``gather_at_use(..., model_partial=True)``). The
sequence moves along its dim: :func:`gather_seq` (an all-gather whose
backward reduce-scatters: attention's keys and values),
:func:`gather_seq_equal` (an all-gather whose backward keeps the block of
a gradient already equal on every rank: the MoE's input, the loss's),
:func:`scatter_seq` (a reduce-scatter of partial sums: the
vocabulary-parallel embedding's) and :func:`slice_seq` (the block, whose
backward all-gathers: the MoE's output).
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch import tree as _tree

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
    and ``x`` is a DTensor; ``x`` itself otherwise. The port's models call
    no ``shard``: on a mesh their blocks gather their weights where they
    use them and split their products over ``model`` themselves
    (:func:`gather_at_use`, :func:`model_split`), and every activation
    they hold is a plain tensor, which this returns as it is."""
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


# ---------------------------------------------------------------------------
# compute on local shards: each leaf gathered at its use, and the Megatron
# pair over ``model``
# ---------------------------------------------------------------------------

def _dim_of(mesh, name: str) -> Optional[int]:
    names = tuple(mesh.mesh_dim_names or ())
    return names.index(name) if name in names else None


@_tree.register_leaf_type
@dataclasses.dataclass(frozen=True, eq=False)
class Placed:
    """A parameter leaf as the sharded train step hands it to a model:
    ``local``, this rank's shard (the tensor the step differentiates), of a
    tensor of global ``shape`` placed on ``placements`` of the
    ``DeviceMesh`` ``mesh``; ``mean_dims``, the mesh dims the batch rows
    are split over (a gradient is the mean over them); ``dtype``, the
    compute dtype an f32 shard is cast to before it is gathered. A layer
    stack's leading dims are never sharded: :meth:`unbind` and
    :meth:`flatten` give its layers (``models.common.per_layer``)."""
    local: torch.Tensor
    mesh: Any
    placements: tuple
    shape: tuple
    mean_dims: tuple
    dtype: torch.dtype

    def _lead(self, n: int) -> tuple:
        """The placements with ``n`` leading dims taken off (they must be
        unsharded)."""
        if any(isinstance(pl, Shard) and pl.dim < n
               for pl in self.placements):
            raise ValueError(f"a stack's leading dims are sharded: "
                             f"{self.placements}")
        return tuple(Shard(pl.dim - n) if isinstance(pl, Shard) else pl
                     for pl in self.placements)

    def unbind(self, dim: int = 0) -> list:
        if dim != 0:
            raise ValueError("a Placed leaf unbinds its leading dim only")
        pls = self._lead(1)
        return [dataclasses.replace(self, local=x, placements=pls,
                                    shape=self.shape[1:])
                for x in self.local.unbind(0)]

    def flatten(self, start: int, end: int) -> "Placed":
        if start != 0:
            raise ValueError("a Placed leaf flattens its leading dims only")
        n = end + 1
        pls = self._lead(n)
        lead = math.prod(self.shape[:n])
        return dataclasses.replace(
            self, local=self.local.flatten(0, end),
            placements=tuple(Shard(pl.dim + 1) if isinstance(pl, Shard)
                             else pl for pl in pls),
            shape=(lead,) + tuple(self.shape[n:]))


class ModelSplit(NamedTuple):
    """This rank's place on the mesh's ``model`` dim: ``size`` ranks,
    this one ``rank``, their process ``group``."""
    size: int
    rank: int
    group: Any


def model_split(x, dim: int) -> Optional[ModelSplit]:
    """The ``model`` dim's layout when ``x`` is a :class:`Placed` leaf
    whose tensor dim ``dim`` (negative from the end) that dim alone
    shards over more than one rank; ``None`` otherwise (a plain tensor,
    or a leaf the spec leaves whole over ``model``: its block computes on
    the whole leaf)."""
    if not isinstance(x, Placed):
        return None
    m = _dim_of(x.mesh, "model")
    if m is None or x.mesh.size(m) == 1:
        return None
    d = dim % len(x.shape)
    if x.placements[m] != Shard(d):
        return None
    if any(pl == Shard(d) for i, pl in enumerate(x.placements) if i != m):
        return None
    return ModelSplit(x.mesh.size(m), x.mesh.get_local_rank(m),
                      x.mesh.get_group(m))


def _moved(t: torch.Tensor, mesh, src, dst, shape) -> torch.Tensor:
    """This rank's part of ``dst`` of a tensor of global ``shape`` whose
    part on ``src`` is ``t`` (DTensor's redistribution: all-gathers,
    reduce-scatters and all-reduces over the dims that change)."""
    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(
        t.contiguous(), mesh, src, run_check=False, shape=torch.Size(shape),
        stride=stride).redistribute(mesh, dst).to_local()


def _gathered(x: "Placed", y: torch.Tensor, dst: tuple) -> torch.Tensor:
    """The forward all-gather of :func:`gather_at_use`."""
    return _moved(y, x.mesh, x.placements, dst, x.shape)


def _reduced(x: "Placed", g: torch.Tensor, src: tuple) -> torch.Tensor:
    """The backward reduction of :func:`gather_at_use` into ``x``'s
    shard."""
    return _moved(g, x.mesh, src, x.placements, x.shape)


class _GatherAtUse(torch.autograd.Function):
    @staticmethod
    def forward(ctx, local, x, dst, grad_src):
        ctx.leaf, ctx.grad_src = x, grad_src
        ctx.local_dtype = local.dtype
        y = local.to(x.dtype) if local.dtype == torch.float32 else local
        return y if dst == x.placements else _gathered(x, y, dst)

    @staticmethod
    def backward(ctx, g):
        x = ctx.leaf
        g = g.to(ctx.local_dtype)
        if ctx.grad_src != x.placements:
            g = _reduced(x, g, ctx.grad_src)
        return g, None, None, None


def gather_at_use(x, *, keep_model: bool = False,
                  model_partial: bool = False):
    """``x`` as its block uses it: a plain tensor as it is; a
    :class:`Placed` leaf cast to the compute dtype (an f32 shard), then
    all-gathered over every mesh dim that shards it but ``model`` when
    ``keep_model`` (the block then computes on its ``model`` shard). In
    backward the gradient, cast to the shard's dtype, is reduced into the
    leaf's own shard: the mean over ``mean_dims``, the sum over ``model``
    when ``model_partial`` (each rank's product used only its part of the
    gathered leaf), else taken as equal there. Call it inside the body a
    checkpoint recomputes: the gathered value is then not saved for
    backward, and backward gathers again."""
    if not isinstance(x, Placed):
        return x
    m = _dim_of(x.mesh, "model")
    dst, src = [], []
    for i, pl in enumerate(x.placements):
        if x.mesh.size(i) == 1:
            dst.append(pl)
            src.append(pl)
            continue
        kept = keep_model and i == m
        dst.append(pl if kept else Replicate())
        if i in x.mean_dims:
            src.append(Partial("avg"))
        elif kept:
            src.append(pl)
        elif model_partial and i == m:
            src.append(Partial("sum"))
        else:
            src.append(Replicate())
    dst, src = tuple(dst), tuple(src)
    if dst == x.placements and src == x.placements:
        return (x.local.to(x.dtype) if x.local.dtype == torch.float32
                else x.local)
    return _GatherAtUse.apply(x.local, x, dst, src)


def at_use(tree):
    """Every :class:`Placed` leaf of ``tree`` gathered whole
    (:func:`gather_at_use`); plain leaves as they are."""
    return _tree.tree_map(gather_at_use, tree)


class _Redistributed(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, shape, places, grad_places):
        ctx.mesh, ctx.shape, ctx.grad_places = mesh, shape, grad_places
        return _moved(t, mesh, *places, shape)

    @staticmethod
    def backward(ctx, g):
        return (_moved(g, ctx.mesh, *ctx.grad_places, ctx.shape), None, None,
                None, None)


def redistributed(t: torch.Tensor, mesh, shape, places: tuple,
                  grad_places: tuple) -> torch.Tensor:
    """This rank's part of a tensor of global ``shape`` moved from
    placements ``places[0]`` (``t`` its part there) to ``places[1]``, and
    in backward its gradient from ``grad_places[0]`` to
    ``grad_places[1]``. For a movement whose output each rank uses for
    rows of its own: the output's gradients then differ between ranks
    that hold the same block, which DTensor's own backward of a
    replicated output takes as equal."""
    return _Redistributed.apply(t, mesh, tuple(shape), places, grad_places)


def _all_reduce(t: torch.Tensor, group, op=dist.ReduceOp.SUM
                ) -> torch.Tensor:
    """``t`` reduced over ``group`` (a new tensor). An all-reduce hands
    every rank the same bits."""
    out = t.contiguous().clone()
    dist.all_reduce(out, op=op, group=group)
    return out


class _SumOverModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        return _all_reduce(t, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return t

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


def sum_over_model(t: torch.Tensor, split: Optional[ModelSplit]
                   ) -> torch.Tensor:
    """The sum of ``t`` over ``split``'s ranks, after a row-parallel
    product (identity in backward); ``t`` itself with no split."""
    return t if split is None else _SumOverModel.apply(t, split.group)


def copy_to_model(t: torch.Tensor, split: Optional[ModelSplit]
                  ) -> torch.Tensor:
    """``t`` at the input of a column-parallel block: itself in forward,
    its gradient summed over ``split``'s ranks in backward."""
    return t if split is None else _CopyToModel.apply(t, split.group)


def total_over_model(t: torch.Tensor, split: Optional[ModelSplit]
                     ) -> torch.Tensor:
    """The sum of ``t`` over ``split``'s ranks, whose gradient is summed
    over them too: for a statistic each rank uses only for its own part
    (the gated norm's mean of squares over channels split over
    ``model``), so that each rank's share of the gradient reaches every
    rank's ``t``. After a row-parallel product, whose sum every rank uses
    alike, a caller wants :func:`sum_over_model` (identity in backward).
    ``t`` itself with no split."""
    return copy_to_model(sum_over_model(t, split), split)


def gather_over_model(t: torch.Tensor, split: Optional[ModelSplit],
                      dim: int) -> torch.Tensor:
    """Every ``model`` rank's ``t`` concatenated along ``dim`` in rank
    order (an all-gather; no gradient): a small activation whose ``model``
    block is no block of heads, such as one token's products on a
    weight's column blocks. ``t`` itself with no split."""
    if split is None:
        return t
    t = t.detach().contiguous()
    parts = [torch.empty_like(t) for _ in range(split.size)]
    dist.all_gather(parts, t, group=split.group)
    return torch.cat(parts, dim=dim)


def max_over_model(t: torch.Tensor, split: Optional[ModelSplit]
                   ) -> torch.Tensor:
    """The elementwise max of ``t`` over ``split``'s ranks (no
    gradient)."""
    t = t.detach()
    return t if split is None else _all_reduce(t, split.group,
                                               dist.ReduceOp.MAX)


# ---------------------------------------------------------------------------
# sequence parallelism: the residual stream's sequence split over ``model``
# ---------------------------------------------------------------------------

def seq_split(x) -> Optional[ModelSplit]:
    """The ``model`` dim's layout when ``x`` is a :class:`Placed` leaf
    whose mesh has more than one rank on ``model``: the split a
    sequence-parallel block's positions take there (``RULES["seq_sp"]``),
    each rank a block of ``S / size`` in rank order; ``None`` otherwise (a
    plain tensor, or one ``model`` rank, where SP is the plain path)."""
    if not isinstance(x, Placed):
        return None
    m = _dim_of(x.mesh, "model")
    if m is None or x.mesh.size(m) == 1:
        return None
    return ModelSplit(x.mesh.size(m), x.mesh.get_local_rank(m),
                      x.mesh.get_group(m))


def seq_block(S: int, split: ModelSplit) -> slice:
    """This rank's positions of a sequence of ``S`` split over ``split``;
    ``ValueError`` unless its ranks divide ``S``."""
    if S % split.size:
        raise ValueError(f"sequence parallelism splits {S} positions over "
                         f"{split.size} model ranks, which do not divide "
                         f"them")
    n = S // split.size
    return slice(split.rank * n, (split.rank + 1) * n)


def _block_of(t: torch.Tensor, split: ModelSplit, dim: int) -> torch.Tensor:
    n = t.shape[dim] // split.size
    return t.narrow(dim, split.rank * n, n).contiguous()


def _gather_dim(t: torch.Tensor, split: ModelSplit, dim: int
                ) -> torch.Tensor:
    """Every rank's ``t`` concatenated along ``dim`` in rank order (an
    all-gather: every rank the same bits)."""
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(split.size)]
    dist.all_gather(parts, t, group=split.group)
    return torch.cat(parts, dim=dim)


def _scatter_dim(t: torch.Tensor, split: ModelSplit, dim: int
                 ) -> torch.Tensor:
    """The sum of every rank's ``t``, this rank's block along ``dim`` (a
    reduce-scatter)."""
    x = t.movedim(dim, 0).contiguous()
    out = x.new_empty((x.shape[0] // split.size,) + tuple(x.shape[1:]))
    scatter = getattr(dist, "reduce_scatter_single",
                      dist.reduce_scatter_tensor)
    scatter(out, x, group=split.group)
    return out.movedim(0, dim)


class _SeqGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, split, dim, equal):
        ctx.split, ctx.dim, ctx.equal = split, dim, equal
        return _gather_dim(t, split, dim)

    @staticmethod
    def backward(ctx, g):
        if ctx.equal:
            return _block_of(g, ctx.split, ctx.dim), None, None, None
        return _scatter_dim(g, ctx.split, ctx.dim), None, None, None


class _SeqScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, split, dim):
        ctx.split, ctx.dim = split, dim
        return _scatter_dim(t, split, dim)

    @staticmethod
    def backward(ctx, g):
        return _gather_dim(g, ctx.split, ctx.dim), None, None


class _SeqSlice(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, split, dim):
        ctx.split, ctx.dim = split, dim
        return _block_of(t, split, dim)

    @staticmethod
    def backward(ctx, g):
        return _gather_dim(g, ctx.split, ctx.dim), None, None


def gather_seq(t: torch.Tensor, split: Optional[ModelSplit], dim: int = 1
               ) -> torch.Tensor:
    """Every rank's block of a sequence concatenated along ``dim`` (an
    all-gather), for a tensor each rank then uses for rows of its own
    (attention's keys and values under its block of queries): in backward
    the gradients summed over ``split``'s ranks, each rank keeping its
    block (a reduce-scatter). ``t`` itself with no split."""
    return t if split is None else _SeqGather.apply(t, split, dim, False)


def gather_seq_equal(t: torch.Tensor, split: Optional[ModelSplit],
                     dim: int = 1) -> torch.Tensor:
    """:func:`gather_seq` for a block that runs alike on every ``model``
    rank (the MoE, the loss on the vocabulary's shards), whose input's
    gradient comes back already summed over ``model``, equal on every
    rank: in backward each rank keeps its block of it, and nothing
    moves."""
    return t if split is None else _SeqGather.apply(t, split, dim, True)


def scatter_seq(t: torch.Tensor, split: Optional[ModelSplit], dim: int = 1
                ) -> torch.Tensor:
    """Each rank's partial sums of a whole sequence summed over
    ``split``'s ranks, this rank keeping its block along ``dim`` (a
    reduce-scatter; the vocabulary-parallel embedding's); in backward the
    blocks' gradients all-gathered. ``t`` itself with no split."""
    return t if split is None else _SeqScatter.apply(t, split, dim)


def slice_seq(t: torch.Tensor, split: Optional[ModelSplit], dim: int = 1
              ) -> torch.Tensor:
    """This rank's block along ``dim`` of a whole sequence equal on every
    ``model`` rank (the MoE's output); in backward the blocks' gradients
    all-gathered, so that the block before it sees the whole gradient on
    every rank. ``t`` itself with no split."""
    return t if split is None else _SeqSlice.apply(t, split, dim)


def attn_split(p, n_heads: int, n_kv_heads: int):
    """``(split, kv)`` of an attention block whose leaves ``p`` hold
    ``wq``/``wk``/``wv``/``wo``: the ``model`` layout it runs on its heads
    with, where ``model`` divides ``n_heads`` and the spec splits ``wq``'s
    columns and ``wo``'s rows (``None``: on its weights gathered whole);
    and ``kv``, the one KV head this rank takes of ``wk``/``wv`` gathered
    whole when there are fewer KV heads than ranks and they divide them
    (Megatron's rule; ``None``: its own KV heads, from its columns). With
    fewer KV heads that do not divide the ranks, the block runs whole."""
    split = model_split(p["wq"], -1)
    if (split is None or n_heads % split.size
            or model_split(p["wo"], -2) is None):
        return None, None
    T = split.size
    if (n_kv_heads % T == 0 and model_split(p["wk"], -1)
            and model_split(p["wv"], -1)):
        return split, None
    if T % n_kv_heads == 0:
        return split, split.rank // (T // n_kv_heads)
    return None, None


def attn_weights(p, split: Optional[ModelSplit], kv: Optional[int],
                 head_dim: int, model_partial: bool = False):
    """``(wq, wk, wv, wo)`` as the attention of :func:`attn_split`'s
    ``(split, kv)`` uses them: on their ``model`` shards with a split
    (``wk``/``wv``: KV head ``kv``'s columns of the whole leaves, whose
    gradient is each rank's part summed over ``model``), gathered whole
    without (their gradients each rank's part, summed over ``model``,
    when ``model_partial``: sequence parallelism)."""
    keep = split is not None
    whole = dict(keep_model=keep, model_partial=model_partial)
    wq, wo = (gather_at_use(p[n], **whole) for n in ("wq", "wo"))
    if kv is None:
        wk, wv = (gather_at_use(p[n], **whole) for n in ("wk", "wv"))
    else:
        wk, wv = (gather_at_use(p[n], model_partial=True)
                  [:, kv * head_dim:(kv + 1) * head_dim]
                  for n in ("wk", "wv"))
    return wq, wk, wv, wo
