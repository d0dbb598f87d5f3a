"""Name-based parameter/batch/cache/EF partition specs (FSDP×TP), and the
placement of trees as DTensors.

The port of ``src/repro/sharding/params.py``. Specs are derived from leaf
*names* (the last dict key of the leaf's path: a ``keystr`` of
:func:`repro_torch.tree.flatten_with_names`, or a sequence of keys),
padded with None for leading stack dims (layers/groups). A spec axis is
dropped whenever it does not evenly divide the corresponding dimension —
batch=1 long-context cells simply replicate over 'data' instead of
failing. A leaf is anything with a ``shape`` (a tensor, a ``meta`` or fake
tensor). ``mesh`` is a ``DeviceMesh`` or a
:class:`~repro_torch.sharding.api.MeshShape`.

The ``*_shardings`` functions give trees of
:class:`~repro_torch.sharding.api.NamedSharding`; :func:`distribute` places
a plain tree on them as DTensors (``interop.params_from_numpy`` then
:func:`distribute` is how weights cross into a sharded port).
"""
from __future__ import annotations

import math
import re

import numpy as np
import torch
from torch.distributed.tensor import DTensor, Shard, distribute_tensor

from repro_torch import tree as _tree
from repro_torch.sharding.api import NamedSharding, P, mesh_axes


def _dp_axes(mesh):
    return ("pod", "data") if "pod" in mesh_axes(mesh) else "data"


# trailing-dim logical rules per parameter name: each entry lists the spec for
# the LAST ndim dims (None-padded at the front for layer stacks).
def _rules(dp):
    return {
        "embed": ("model", dp),          # (vocab, d): vocab-parallel
        "head": (dp, "model"),           # (d, vocab)
        "wq": (dp, "model"),
        "wk": (dp, "model"),
        "wv": (dp, "model"),
        "wo": ("model", dp),
        "w1": (dp, "model"),
        "w3": (dp, "model"),
        "w2": ("model", dp),
        "router": (dp, None),
        "we1": ("model", dp, None),      # (E, d, ff)
        "we3": ("model", dp, None),
        "we2": ("model", None, dp),      # (E, ff, d)
        "in_proj": (dp, "model"),
        "out_proj": ("model", dp),
        "conv_w": (None, None),
        "conv_b": (None,),
        "A_log": (None,),
        "D": (None,),
        "dt_bias": (None,),
    }


_KEY = re.compile(r"\[(['\"])(.*?)\1\]")


def _leaf_name(path) -> str:
    """The last dict key of ``path``: a ``keystr`` such as
    ``"['layers']['wq']"``, or a sequence of keys (ints are positions)."""
    if isinstance(path, str):
        names = [m.group(2) for m in _KEY.finditer(path)]
    else:
        names = [k for k in path if isinstance(k, str)]
    return names[-1] if names else ""


def _shape(leaf) -> tuple:
    return tuple(int(d) for d in leaf.shape)


def param_spec(path, leaf, mesh) -> P:
    shape = _shape(leaf)
    ndim = len(shape)
    rules = _rules(_dp_axes(mesh))
    name = _leaf_name(path)
    if name in rules:
        tail = rules[name]
        tail = tail[-ndim:] if len(tail) >= ndim else tail
        spec = (None,) * (ndim - len(tail)) + tuple(tail)
    else:
        spec = (None,) * ndim  # norms & scalars replicated
    return _validated(spec, shape, mesh)


def _axis_size(mesh, ax) -> int:
    if ax is None:
        return 1
    sizes = mesh_axes(mesh)
    if isinstance(ax, tuple):
        return math.prod(sizes[a] for a in ax)
    return sizes[ax]


def _validated(spec, shape, mesh) -> P:
    out = []
    for dim, ax in zip(shape, spec):
        out.append(ax if ax and dim % _axis_size(mesh, ax) == 0 else None)
    return P(*out)


def _named_map(fn, tree):
    """``fn(name, leaf)`` over ``tree``'s leaves, in its structure."""
    leaves, names, treedef = _tree.flatten_with_names(tree)
    return _tree.unflatten(treedef, [fn(n, x) for n, x in zip(names, leaves)])


def params_shardings(params, mesh):
    return _named_map(
        lambda name, leaf: NamedSharding(mesh, param_spec(name, leaf, mesh)),
        params)


def batch_spec(leaf, mesh) -> P:
    """Batch arrays: leading dim is (global) batch -> dp axes; mrope position
    arrays carry a leading 3-stream dim instead."""
    shape = _shape(leaf)
    dp = _dp_axes(mesh)
    if len(shape) >= 2 and shape[0] == 3:  # (3, B, S) mrope positions
        spec = (None, dp) + (None,) * (len(shape) - 2)
    else:
        spec = (dp,) + (None,) * (len(shape) - 1)
    return _validated(spec, shape, mesh)


def batch_shardings(batch, mesh):
    return _tree.tree_map(
        lambda leaf: NamedSharding(mesh, batch_spec(leaf, mesh)), batch)


def ef_spec(leaf, mesh) -> P:
    """Error-feedback residual specs for the compressed training path.

    DP-only layout ``(P, size)`` shards the worker dim over 'data'; the DP×TP
    layout ``(D, T, shard_len)`` (``init_ef_state(..., model_shards=T)``)
    shards (worker, model-shard) over ('data', 'model') so each device holds
    exactly its own per-shard residual slice.
    """
    shape = _shape(leaf)
    if len(shape) >= 3 and "model" in mesh_axes(mesh):
        spec = ("data", "model") + (None,) * (len(shape) - 2)
    else:
        spec = ("data",) + (None,) * (len(shape) - 1)
    return _validated(spec, shape, mesh)


def ef_shardings(ef_tree, mesh):
    return _tree.tree_map(
        lambda leaf: NamedSharding(mesh, ef_spec(leaf, mesh)), ef_tree)


def cache_spec(leaf, cfg, mesh, batch: int) -> P:
    """KV / SSM cache specs, cfg-aware (trailing-shape matched):

      KVCache k/v (..., B, S, Hkv, hd): batch->dp, kv->model if divisible,
        else head_dim->model (GQA kv < TP width: shard the contraction dim).
      Mamba ssm  (..., B, H, P, N): batch->dp, heads->model.
      Mamba conv (..., B, W-1, C):  batch->dp, channels->model.
      lengths / scalars: replicated.
    """
    shape = _shape(leaf)
    ndim = len(shape)
    dp = _dp_axes(mesh)
    if ndim <= 1:
        return P()
    model_n = mesh_axes(mesh).get("model", 1)
    spec = [None] * ndim

    def mark(idx_from_end: int, ax):
        spec[ndim - idx_from_end] = ax

    if (ndim >= 4 and shape[-2] == cfg.n_kv_heads
            and shape[-1] == cfg.head_dim and cfg.n_kv_heads > 0):
        mark(4, dp)  # batch
        if cfg.n_kv_heads % model_n == 0:
            mark(2, "model")
        elif cfg.head_dim % model_n == 0:
            mark(1, "model")
    elif (ndim >= 4 and cfg.ssm_state > 0 and shape[-1] == cfg.ssm_state
          and shape[-2] == cfg.ssm_head_dim):
        mark(4, dp)
        mark(3, "model")
    elif ndim >= 3 and shape[-3] == batch:
        mark(3, dp)
        mark(1, "model")
    return _validated(tuple(spec), shape, mesh)


def _map_caches(fn, node):
    """``fn`` over a cache tree's tensors, in its structure: dicts, lists,
    tuples and the models' cache NamedTuples (which :mod:`repro_torch.tree`
    does not walk), ``None`` kept."""
    if node is None:
        return None
    if isinstance(node, dict):
        return {k: _map_caches(fn, v) for k, v in node.items()}
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return type(node)(*(_map_caches(fn, c) for c in node))
    if isinstance(node, (list, tuple)):
        return type(node)(_map_caches(fn, c) for c in node)
    return fn(node)


def cache_shardings(cache_tree, cfg, mesh, batch: int):
    return _map_caches(
        lambda leaf: NamedSharding(mesh, cache_spec(leaf, cfg, mesh, batch)),
        cache_tree)


def distribute(tree, shardings):
    """``tree`` placed as DTensors on ``shardings`` (a tree of
    :class:`NamedSharding` on a ``DeviceMesh``, or ``None`` where a leaf
    stays as it is), on the mesh's device. Every rank passes the same
    global values and keeps its own slice of them: no collective runs."""
    leaves, treedef = _tree.flatten(tree)
    out = []
    for x, sh in zip(leaves, _tree.flatten_up_to(treedef, shardings)):
        if sh is None:
            out.append(x)
            continue
        out.append(distribute_tensor(torch.as_tensor(x), sh.mesh,
                                     sh.placements, src_data_rank=None))
    return _tree.unflatten(treedef, out)


def local_region(shape, mesh, placements) -> tuple:
    """This rank's slice of each dim of a tensor of global ``shape`` on
    ``placements``, as DTensor cuts it: mesh dims in order, each
    ``Shard(d)`` splitting what the dims before it left of dim ``d`` into
    chunks of ``ceil(size / n)``."""
    start, size = [0] * len(shape), list(shape)
    coord = mesh.get_coordinate()
    for i, pl in enumerate(placements):
        if isinstance(pl, Shard):
            d, n = pl.dim, mesh.size(i)
            chunk = -(-size[d] // n)
            lo = min(coord[i] * chunk, size[d])
            start[d] += lo
            size[d] = min(chunk, size[d] - lo)
    return tuple(slice(a, a + n) for a, n in zip(start, size))


def from_global(arr, sh) -> DTensor:
    """An array's global value (numpy, memory-mapped or not) placed on
    the :class:`NamedSharding` ``sh``: this rank copies only its own slice
    to the device. No collective runs."""
    region = local_region(arr.shape, sh.mesh, sh.placements)
    local = torch.from_numpy(np.ascontiguousarray(arr[region]))
    return DTensor.from_local(
        local.to(sh.mesh.device_type), sh.mesh, sh.placements,
        run_check=False, shape=torch.Size(arr.shape),
        stride=torch.empty(arr.shape, device="meta").stride())


def sharding_of(x):
    """The :class:`NamedSharding` a DTensor lies on (``None`` for a plain
    tensor): its mesh and the spec its placements give."""
    if not isinstance(x, DTensor):
        return None
    mesh = x.device_mesh
    spec = [[] for _ in range(x.dim())]
    for name, pl in zip(mesh.mesh_dim_names, x.placements):
        if pl.is_shard():
            spec[pl.dim].append(name)
    return NamedSharding(mesh, P(*(None if not s else s[0] if len(s) == 1
                                   else tuple(s) for s in spec)))


def local_of(x):
    """This rank's shard of a DTensor; a plain tensor itself."""
    return x.to_local() if isinstance(x, DTensor) else x


def placed_like(ref, local):
    """``local`` as this rank's shard of a DTensor placed as ``ref`` (a
    plain ``ref``: ``local`` itself). No collective runs."""
    if not isinstance(ref, DTensor):
        return local
    return DTensor.from_local(local, ref.device_mesh, ref.placements,
                              run_check=False, shape=ref.shape,
                              stride=ref.stride())


def counted_once(x) -> bool:
    """Whether this rank's shard of ``x`` is the one copy a sum over the
    mesh counts: its coordinate is 0 along every mesh dim that does not
    shard ``x`` (a plain tensor, a copy on every rank: rank 0's)."""
    if not isinstance(x, DTensor):
        return not torch.distributed.is_initialized() \
            or torch.distributed.get_rank() == 0
    coord = x.device_mesh.get_coordinate()
    return all(c == 0 for c, pl in zip(coord, x.placements)
               if not pl.is_shard())


def gathered(tree):
    """``tree`` with each DTensor leaf gathered whole (a collective: every
    rank of its mesh calls this); plain leaves as they are."""
    return _tree.tree_map(
        lambda x: x.full_tensor() if isinstance(x, DTensor) else x, tree)
