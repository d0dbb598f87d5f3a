"""The steps: train, serve (prefill/decode), and the paper-technique
path: compressed-gradient training (top-k + SpKAdd sparse allreduce over
the data group).

The port of ``src/repro/train/step.py``. Every step is a plain function of
parameter trees (``repro_torch.tree``) and a model from
``repro_torch.models``:

- :func:`make_train_step` casts the f32 parameters to the compute dtype
  *outside* the gradient and differentiates with respect to that copy, as
  the reference does (its gradients are rounded to the compute dtype, then
  cast to f32), with optional microbatch accumulation; AdamW and the cosine
  schedule are ``repro_torch.optim``'s. On parameters placed as DTensors
  (``repro_torch.sharding.params``: FSDP×TP over a ``("data", "model")``
  or ``("pod", "data", "model")`` ``DeviceMesh``) the same step is the
  reference's ``jit`` of it over a mesh, made explicit
  (:func:`sharded_loss_and_grads`): each rank takes its rows of the global
  batch and hands the model its shards (``sharding.api.Placed``); each
  layer casts and gathers its weights where it uses them, the dense
  decoder's blocks split over ``model``, and each use's gradient is
  reduced as the mean over the data axes into its leaf's shard when that
  use's backward ends; the model's batch-wide statistics (the MoE's
  capacity and load) are taken over every rank's rows; AdamW updates each
  rank's shards.
- :func:`make_prefill_step` and :func:`make_decode_step` serve on plain
  parameters, or on DTensors placed by the TP-only serving layout: each
  rank then runs its ``model`` shard on its rows, the caches on the
  reference's ``cache_shardings``.
- :func:`make_compressed_train_step` is the reference's ``shard_map`` body
  run on every rank of a ``torch.distributed`` world: each rank takes its
  slice of the global batch (the reference's ``batch_spec``: the batch split
  over the data group, or over the flattened data × model grid, data
  major), differentiates the f32 parameters directly, and reduces its
  gradients with :func:`~repro_torch.core.allreduce.compressed_gradient_mean`
  (a 1-D data group) or
  :func:`~repro_torch.core.allreduce.compressed_gradient_mean_2d` (a 2-D
  ``("data", "model")`` ``DeviceMesh`` whose model dim is larger than 1).
  Its error-feedback state is this rank's shard of :func:`init_ef_state`'s
  layout, leading dims of 1 kept (:func:`rank_ef_state`), the view the
  reference's ``shard_map`` gives a device.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch
import torch.distributed as dist
from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                      distribute_tensor)

from repro_torch import compat
from repro_torch import tree as _tree
from repro_torch.core.allreduce import (MIN_COMPRESS_ELEMS,
                                        compressed_gradient_mean,
                                        compressed_gradient_mean_2d)
from repro_torch.kernels import xla_float
from repro_torch.models.common import torch_dtype
from repro_torch.optim import adamw_update, cosine_schedule
from repro_torch.sharding.api import Placed, RowSplit, row_split_context
from repro_torch.sharding.params import (_map_caches, cache_shardings,
                                         local_of, local_region, placed_like)


@dataclasses.dataclass(frozen=True)
class TrainHParams:
    peak_lr: float = 3e-4
    warmup: int = 100
    total_steps: int = 10_000
    weight_decay: float = 0.1
    max_grad_norm: float = 1.0
    remat: bool = True
    ce_chunk: int = 512
    attn_chunk: int = 1024
    grad_accum: int = 1   # microbatches per step (activation memory / N)
    accum_dtype: str = "float32"  # bfloat16 halves grad-reduce traffic


def _local(x) -> torch.Tensor:
    """The tensor a leaf's gradient is taken for: a
    :class:`~repro_torch.sharding.api.Placed` leaf's shard, a plain leaf
    itself."""
    return x.local if isinstance(x, Placed) else x


def _loss_and_grads(model, hp: TrainHParams, params, batch):
    """``(loss, grads)`` of ``model.loss`` at ``params`` (a tree of
    tensors or of :class:`~repro_torch.sharding.api.Placed` shards), the
    gradients a list in leaf order, each in its leaf's (its shard's)
    type."""
    leaves, treedef = _tree.flatten(params)
    wrt = [_local(x).detach().requires_grad_() for x in leaves]
    leaves = [dataclasses.replace(x, local=w) if isinstance(x, Placed)
              else w for x, w in zip(leaves, wrt)]
    with torch.enable_grad():
        loss = model.loss(_tree.unflatten(treedef, leaves), batch,
                          remat=hp.remat, ce_chunk=hp.ce_chunk,
                          attn_chunk=hp.attn_chunk)
        grads = torch.autograd.grad(loss, wrt, allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g
             for g, x in zip(grads, wrt)]
    return loss.detach(), grads


def _micro_batches(batch: dict, n: int):
    """The batch split into ``n`` microbatches along its batch dim (a
    ``(3, B, S)`` M-RoPE position leaf along its second)."""
    def split(x):
        if x.dim() >= 2 and x.shape[0] == 3:  # (3, B, S)
            return list(x.chunk(n, dim=1))
        return list(x.chunk(n, dim=0))

    parts = {k: split(v) for k, v in batch.items()}
    return [{k: v[i] for k, v in parts.items()} for i in range(n)]


def _accumulated_grads(model, hp: TrainHParams, params_c, batch):
    """``(loss, f32 gradients in leaf order)`` of the compute copy
    ``params_c`` on ``batch``, over ``hp.grad_accum`` microbatches."""
    if hp.grad_accum <= 1:
        loss, grads = _loss_and_grads(model, hp, params_c, batch)
        return loss, [g.to(torch.float32) for g in grads]
    n = hp.grad_accum
    adt = torch_dtype(hp.accum_dtype)
    leaves = [_local(x) for x in _tree.leaves(params_c)]
    loss = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
    acc = [torch.zeros(p.shape, dtype=adt, device=p.device) for p in leaves]
    for b in _micro_batches(batch, n):
        loss_i, g = _loss_and_grads(model, hp, params_c, b)
        acc = [a + x.to(adt) for a, x in zip(acc, g)]
        loss = loss + loss_i
    return (xla_float.div_const(loss, n),
            [xla_float.div_const(g.to(torch.float32), n) for g in acc])


def _to_compute(x, compute_dtype):
    return x.to(compute_dtype) if x.dtype == torch.float32 else x


def _reduce(g: torch.Tensor, mesh, mean_dims, placements) -> DTensor:
    """This rank's value ``g`` of a whole tensor, as the mean over the
    mesh dims ``mean_dims`` (equal on the others), placed on
    ``placements``."""
    src = [Partial("avg") if i in mean_dims else Replicate()
           for i in range(mesh.ndim)]
    return DTensor.from_local(g, mesh, src, run_check=False).redistribute(
        mesh, placements)


def _batch_dim(key: str) -> int:
    """The dim of a batch leaf that holds its rows: dim 1 of the ``(3, B,
    S)`` M-RoPE positions, dim 0 of every other leaf. (``batch_spec`` tells
    the positions by a leading 3, so it takes a 2-D batch of 3 rows for
    them and splits its sequence: a layout hint under ``jit``, but rows
    taken by it would change the loss.)"""
    return 1 if key == "mrope_positions" else 0


def _interleave(x: torch.Tensor, dim: int, n_micro: int, n_blocks: int
                ) -> torch.Tensor:
    """``x``'s rows along ``dim`` reordered so that its ``n_blocks``
    contiguous blocks each hold, microbatch by microbatch, that block's
    share of every one of the ``n_micro`` microbatches."""
    s = tuple(x.shape)
    per = s[dim] // (n_micro * n_blocks)
    y = x.reshape(s[:dim] + (n_micro, n_blocks, per) + s[dim + 1:])
    return y.transpose(dim, dim + 1).reshape(s)


def _local_rows(batch: dict, mesh, n_micro: int = 1):
    """``(this rank's rows of the global batch, the mesh dims of more than
    one rank they are split over)``: the rows split over the data axes
    (``pod`` major) when every leaf's row count divides over them and its
    ``n_micro`` microbatches, else replicated and split over no dim. With
    microbatches, a rank's ``i``-th holds its block of the global batch's
    ``i``-th (the rows the reference's microbatch takes). A DTensor leaf
    placed otherwise is gathered first."""
    names = mesh.mesh_dim_names
    dp = [i for i, n in enumerate(names) if n in ("pod", "data")]
    n_dp = 1
    for i in dp:
        n_dp *= mesh.size(i)
    n_micro = max(1, n_micro)
    split = all(x.shape[_batch_dim(k)] % (n_dp * n_micro) == 0
                for k, x in batch.items())
    reorder = split and n_dp > 1 and n_micro > 1
    local = {}
    for k, x in batch.items():
        want = tuple(Shard(_batch_dim(k)) if split and i in dp
                     else Replicate() for i in range(mesh.ndim))
        if isinstance(x, DTensor):
            if tuple(x.placements) == want and not reorder:
                local[k] = x.to_local()
                continue
            x = x.full_tensor()
        if reorder:
            x = _interleave(x, _batch_dim(k), n_micro, n_dp)
        local[k] = distribute_tensor(x, mesh, want,
                                     src_data_rank=None).to_local()
    return local, tuple(i for i in dp if split and mesh.size(i) > 1)


def sharded_loss_and_grads(model, hp: TrainHParams, params, batch):
    """``(loss, grads)`` of :func:`make_train_step` on a tree of DTensor
    parameters (one ``DeviceMesh``): each rank takes its rows of the
    global ``batch`` and hands the model each leaf as a
    :class:`~repro_torch.sharding.api.Placed` (its shard and placement);
    each layer casts its leaves to the compute dtype, then gathers them
    where it uses them (cast first: the same bits, half the bytes in
    bf16), the dense decoder's blocks on their ``model`` shards; and each
    use's gradient is reduced as the mean over the mesh dims the batch is
    split over into its leaf's shard as that use's backward ends, so the
    gradients reach each leaf already placed. The loss and its gradients
    are taken on plain local tensors (no kernel sees a DTensor), under a
    :class:`~repro_torch.sharding.api.RowSplit` that lets the MoE take its
    capacity and load statistics over the whole batch, as the reference's
    ``jit`` does, and place its capacity blocks over ``data``. A batch
    that is replicated takes no mean: every rank already holds the same
    value, and a mean of equal f32 values need not give it back. ``loss``
    is the mean over the same dims (a plain tensor)."""
    leaves, treedef = _tree.flatten(params)
    if not all(isinstance(x, DTensor) for x in leaves):
        raise ValueError("a sharded step needs every parameter leaf as a "
                         "DTensor")
    mesh = leaves[0].device_mesh
    local, split = _local_rows(batch, mesh, hp.grad_accum)
    placed = [Placed(x.to_local(), mesh, tuple(x.placements),
                     tuple(x.shape), split, model.cfg.cdtype)
              for x in leaves]
    with row_split_context(RowSplit(mesh, split) if split else None):
        loss, grads = _accumulated_grads(
            model, hp, _tree.unflatten(treedef, placed), local)
    grads = [placed_like(x, g) for x, g in zip(leaves, grads)]
    if split:
        loss = _reduce(loss, mesh, split,
                       [Replicate()] * mesh.ndim).to_local()
    return loss, _tree.unflatten(treedef, grads)


def make_train_step(model, hp: TrainHParams = TrainHParams()) -> Callable:
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)`` with metrics ``loss``, ``grad_norm`` and ``lr``. ``params``
    is a tree of plain tensors, or of DTensors on one mesh
    (:func:`sharded_loss_and_grads`; ``batch`` is then the global batch,
    plain or placed by ``batch_shardings``, and the moments take the
    parameters' placements)."""
    compute_dtype = model.cfg.cdtype

    def train_step(params, opt_state, batch):
        p_leaves, treedef = _tree.flatten(params)
        if any(isinstance(x, DTensor) for x in p_leaves):
            loss, grads = sharded_loss_and_grads(model, hp, params, batch)
        else:
            # cast OUTSIDE the gradient and differentiate w.r.t. the
            # compute copy; accumulation and the optimizer stay fp32
            params_c = _tree.tree_map(
                lambda x: _to_compute(x, compute_dtype), params)
            loss, grads = _accumulated_grads(model, hp, params_c, batch)
            grads = _tree.unflatten(treedef, grads)
        lr = cosine_schedule(opt_state.step, peak_lr=hp.peak_lr,
                             warmup=hp.warmup, total=hp.total_steps)
        new_params, new_state, gnorm = adamw_update(
            params, grads, opt_state, lr=lr,
            weight_decay=hp.weight_decay, max_grad_norm=hp.max_grad_norm)
        metrics = {"loss": loss, "grad_norm": gnorm, "lr": lr}
        return new_params, new_state, metrics

    return train_step


def _serving_leaves(params, batch: dict):
    """``(mesh, params as Placed leaves, this rank's rows of batch, the
    mesh dims they are split over)`` for a serving step on DTensor
    parameters (``None`` for the mesh on plain ones, everything else as
    it is). A leaf keeps its own dtype: the serving steps compute on the
    leaves as the plain steps do, which cast them at each product."""
    leaves, treedef = _tree.flatten(params)
    if not any(isinstance(x, DTensor) for x in leaves):
        return None, params, batch, ()
    if not all(isinstance(x, DTensor) for x in leaves):
        raise ValueError("a placed serving step needs every parameter leaf "
                         "as a DTensor")
    mesh = leaves[0].device_mesh
    local, split = _local_rows(batch, mesh)
    placed = [Placed(x.to_local(), mesh, tuple(x.placements),
                     tuple(x.shape), split, x.dtype) for x in leaves]
    return mesh, _tree.unflatten(treedef, placed), local, split


def _placed_rows(t: torch.Tensor, mesh, split, rows: int) -> DTensor:
    """This rank's rows ``t`` of a (rows, ...) output whole over every
    mesh dim but the ``split`` ones, as a DTensor."""
    shape = (rows,) + tuple(t.shape[1:])
    placements = [Shard(0) if i in split else Replicate()
                  for i in range(mesh.ndim)]
    return DTensor.from_local(t, mesh, placements, run_check=False,
                              shape=torch.Size(shape),
                              stride=torch.empty(shape,
                                                 device="meta").stride())


def _cache_leaves(caches) -> list:
    leaves = []
    _map_caches(leaves.append, caches)
    return leaves


def make_prefill_step(model, attn_chunk: int = 1024,
                      max_len: int | None = None) -> Callable:
    """``prefill_step(params, batch) -> (logits, caches)`` on the batch's
    ``tokens`` or ``embeds``, with caches of ``max_len`` positions (``None``:
    the prompt's length, the reference's step).

    On DTensor parameters placed by the serving layout
    (``launch.dryrun.serve_shardings``, TP-only) and a batch placed by
    ``batch_shardings`` (or plain), each rank runs its ``model`` shard on
    its rows (``sharding.api.Placed`` leaves, as the train step hands
    them, under a ``RowSplit`` for the MoE's capacity), gathering a leaf
    only where the train step does. The caches come back as DTensors on
    ``cache_shardings`` (the reference's cache layout), the logits as a
    DTensor whose rows are split like the batch's, whole over ``model``."""
    def prefill_step(params, batch):
        mesh, params, local, split = _serving_leaves(params, batch)
        if mesh is None:
            return model.prefill(params, tokens=batch.get("tokens"),
                                 embeds=batch.get("embeds"),
                                 max_len=max_len, attn_chunk=attn_chunk)
        with row_split_context(RowSplit(mesh, split) if split else None):
            logits, caches = model.prefill(
                params, tokens=local.get("tokens"),
                embeds=local.get("embeds"), max_len=max_len,
                attn_chunk=attn_chunk)
        rows, S = batch.get("tokens", batch.get("embeds")).shape[:2]
        with compat.beneath_dispatch_modes():  # shapes, not the step's work
            meta = model.init_cache(rows, max_len or S, device="meta")
        shs = _cache_leaves(cache_shardings(meta, model.cfg, mesh, rows))
        it = iter(zip(_cache_leaves(meta), shs))
        return (_placed_rows(logits, mesh, split, rows),
                _map_caches(lambda t: _placed_cache(t, *next(it)), caches))

    return prefill_step


def _placed_cache(t: torch.Tensor, meta, sh) -> DTensor:
    """This rank's cache leaf ``t`` as a DTensor of ``meta``'s global
    shape on the sharding ``sh``; ``ValueError`` unless ``t`` has the
    shape of its local region there."""
    region = local_region(tuple(meta.shape), sh.mesh, sh.placements)
    want = tuple(r.stop - r.start for r in region)
    if tuple(t.shape) != want:
        raise ValueError(f"a cache shard of shape {tuple(t.shape)} is not "
                         f"the local region {want} of {tuple(meta.shape)} "
                         f"on {sh.spec}")
    return DTensor.from_local(t, sh.mesh, sh.placements, run_check=False,
                              shape=meta.shape, stride=meta.stride())


def make_decode_step(model, attn_chunk: int = 4096) -> Callable:
    """``decode_step(params, caches, tokens) -> (logits, caches)``, one
    token for every sequence. On DTensor parameters placed by the serving
    layout, the caches on ``cache_shardings`` and the tokens on
    ``batch_shardings`` (or plain), each rank decodes its rows on its
    ``model`` shard and its part of the caches, and no weight moves: only
    the token's activations and the split attention's score sums do. The
    caches come back on their placements (decode chains on its own
    output), the logits as :func:`make_prefill_step`'s."""
    def decode_step(params, caches, tokens):
        mesh, params, local, split = _serving_leaves(params,
                                                     {"tokens": tokens})
        if mesh is None:
            return model.decode_step(params, caches, tokens,
                                     attn_chunk=attn_chunk)
        with row_split_context(RowSplit(mesh, split) if split else None):
            logits, new = model.decode_step(
                params, _map_caches(local_of, caches), local["tokens"],
                attn_chunk=attn_chunk)
        it = iter(_cache_leaves(caches))
        return (_placed_rows(logits, mesh, split, tokens.shape[0]),
                _map_caches(lambda t: placed_like(next(it), t), new))

    return decode_step


# ---------------------------------------------------------------------------
# the paper's technique as a first-class training feature
# ---------------------------------------------------------------------------

def _shard_len(size: int, model_shards: int) -> int:
    return -(-size // model_shards)


def init_ef_state(params, n_workers: int, model_shards: int = 1):
    """Error-feedback residuals, one flat fp32 residual per *shard* per leaf,
    each on its leaf's device.

    - ``model_shards == 1`` (DP-only): ``(P, size)`` — one full-length
      residual per data worker.
    - ``model_shards > 1`` (DP×TP): ``(D, T, ceil(size / T))`` — each model
      shard carries only the residual of the slice it owns.
    """
    def zeros(p: torch.Tensor) -> torch.Tensor:
        shape = ((n_workers, p.numel()) if model_shards <= 1 else
                 (n_workers, model_shards, _shard_len(p.numel(),
                                                      model_shards)))
        return torch.zeros(shape, dtype=torch.float32, device=p.device)

    return _tree.tree_map(zeros, params)


def rank_ef_state(params, model_shards: int = 1):
    """This rank's shard of :func:`init_ef_state`'s layout, its leading
    dims of 1 kept: ``(1, size)`` a leaf on a 1-D data group, ``(1, 1,
    ceil(size / T))`` on a 2-D mesh with ``T`` model shards — what
    :func:`make_compressed_train_step` takes and returns."""
    if model_shards <= 1:
        return init_ef_state(params, 1)

    def zeros(p: torch.Tensor) -> torch.Tensor:
        return torch.zeros((1, 1, _shard_len(p.numel(), model_shards)),
                           dtype=torch.float32, device=p.device)

    return _tree.tree_map(zeros, params)


def _mesh_groups(mesh):
    """``(data group, model group or None)`` of a ``DeviceMesh`` (``None``:
    the default group as the data group)."""
    if mesh is None:
        return None, None
    names = mesh.mesh_dim_names or ()
    if "data" not in names:
        raise ValueError(f"the mesh needs a 'data' dim, has {names}")
    data = mesh.get_group("data")
    if "model" in names and mesh.size(names.index("model")) > 1:
        return data, mesh.get_group("model")
    return data, None


def _pmean(x: torch.Tensor, group) -> torch.Tensor:
    """The mean of a 0-d f32 value over ``group`` (the reference's
    ``pmean``)."""
    total = x.detach().clone()
    dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
    return xla_float.div_const(total, dist.get_world_size(group))


def make_compressed_train_step(model, mesh=None,
                               hp: TrainHParams = TrainHParams(), *,
                               k_fraction: float = 0.01,
                               schedule: str = "gather_kway",
                               selector: str = "block",
                               model_reduce: str = "reduce_scatter",
                               min_compress_elems: int = MIN_COMPRESS_ELEMS
                               ) -> Callable:
    """Training with top-k sparsified gradients reduced via SpKAdd.

    ``mesh`` is a ``torch.distributed`` ``DeviceMesh`` with a ``"data"``
    dim (``None``: the default group is the data group); params and the
    optimizer state are replicated on every rank. On a data-only mesh this
    is the paper's sparse-allreduce setting. On a ``("data", "model")`` mesh
    with a model dim T > 1 the step runs the DP×TP composition: the batch
    splits over the flattened D×T grid, gradients combine densely over the
    model group (``model_reduce``: "reduce_scatter" | "psum"), and each
    model shard sparse-reduces its 1/T slice over the data group against
    its own residual. Returns ``fn(params, opt_state, ef, batch) ->
    (params, opt_state, ef, metrics)``: ``batch`` is the global batch (every
    rank passes the same one), ``ef`` this rank's residuals
    (:func:`rank_ef_state`), metrics ``loss`` (the mean over the grid) and
    ``grad_norm``.
    """
    data_group, model_group = _mesh_groups(mesh)
    use_2d = model_group is not None

    def local_batch(batch):
        d = dist.get_rank(data_group)
        n = dist.get_world_size(data_group)
        if use_2d:
            t = dist.get_world_size(model_group)
            d, n = d * t + dist.get_rank(model_group), n * t

        def take(x):
            axis = 1 if x.dim() >= 2 and x.shape[0] == 3 else 0
            per = x.shape[axis] // n
            return x.narrow(axis, d * per, per)

        return {k: take(v) for k, v in batch.items()}

    def step(params, opt_state, ef, batch):
        loss, grads = _loss_and_grads(model, hp, params, local_batch(batch))
        grads = _tree.unflatten(_tree.flatten(params)[1], grads)
        kw = dict(schedule=schedule, selector=selector,
                  min_compress_elems=min_compress_elems)
        if use_2d:
            residuals = _tree.tree_map(lambda r: r[0, 0], ef)
            mean_grads, new_res = compressed_gradient_mean_2d(
                grads, residuals, data_group, model_group, k_fraction,
                model_reduce=model_reduce, **kw)
            loss = _pmean(_pmean(loss, model_group), data_group)
            new_ef = _tree.tree_map(lambda r: r[None, None], new_res)
        else:
            residuals = _tree.tree_map(lambda r: r[0], ef)
            mean_grads, new_res = compressed_gradient_mean(
                grads, residuals, data_group, k_fraction, **kw)
            loss = _pmean(loss, data_group)
            new_ef = _tree.tree_map(lambda r: r[None], new_res)
        # the mean replaces the gradients: free them before AdamW builds
        # the new state (as XLA frees a dead buffer)
        del grads
        lr = cosine_schedule(opt_state.step, peak_lr=hp.peak_lr,
                             warmup=hp.warmup, total=hp.total_steps)
        new_params, new_state, gnorm = adamw_update(
            params, mean_grads, opt_state, lr=lr,
            weight_decay=hp.weight_decay, max_grad_norm=hp.max_grad_norm)
        return new_params, new_state, new_ef, {"loss": loss,
                                               "grad_norm": gnorm}

    return step
