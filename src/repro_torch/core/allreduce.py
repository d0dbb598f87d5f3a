"""Sparse allreduce schedules over a process group — SpKAdd in the collective.

The port of ``src/repro/core/allreduce.py``. The paper's three addition
schedules reduce top-k-sparsified gradients across P data-parallel workers:

=====================  ==========================================  ==============
paper schedule          collective realization                     rounds × bytes
=====================  ==========================================  ==============
k-way (hash/SPA)        ``allgather_kway``: all_gather the (idx,    1 × P·s
                        val) streams, one local k-way SpKAdd
2-way tree              ``halving_2way``: recursive halving with    lg P, (P−1)·s
                        pairwise exchanges
2-way incremental       ``ring_2way``: ring fold, one hop a round   (P−1) × s
=====================  ==========================================  ==============

(s = per-worker stream entries.) All return the *dense mean* update.

Where the reference names a mesh axis, the port takes a
``torch.distributed`` process group (``None`` = the default group); the
2-D entry takes the two groups of a ``DeviceMesh`` with dims
``("data", "model")`` (``mesh.get_group("data")``,
``mesh.get_group("model")``). Tensors stay on their device: with NCCL
they are CUDA tensors, with gloo CPU tensors.

Each schedule is its exchange, which leaves every rank P streams of ``s``
entries, followed by one local fold (:func:`local_fold`) of those streams
in the order the reference concatenates them. :func:`stream_order` says
which worker's stream sits in which row for each schedule and rank, so the
same fold can be driven from P workers' streams held in one process. The
fold adds each key's values in stream order (the segment-fold kernel, or
the SPA kernel for ``accumulator="vec"``), so the port's bits are the
reference's. XLA flushes a subnormal input or result of its float
arithmetic to a zero of its sign; the means here do the same
(:mod:`repro_torch.kernels.xla_float`).
"""
from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import torch
import torch.distributed as dist

from repro_torch import obs
from repro_torch import tree as _tree
from repro_torch.core.engine import scatter_accumulate
from repro_torch.core.topk import (SparseUpdate, global_k, per_shard_k,
                                   sparsify_with_feedback)
from repro_torch.kernels import ops as _ops
from repro_torch.kernels import xla_float


# ---------------------------------------------------------------------------
# collectives (every byte a schedule moves goes through these three)
# ---------------------------------------------------------------------------

def all_gather_flat(x: torch.Tensor, group) -> torch.Tensor:
    """``(P * x.numel(),)``: every rank's flat ``x`` in rank order."""
    p = dist.get_world_size(group)
    x = x.contiguous().reshape(-1)
    out = torch.empty(p * x.numel(), dtype=x.dtype, device=x.device)
    # newer torch releases deprecate ``all_gather_into_tensor`` (and
    # ``reduce_scatter_tensor``); older ones lack the ``_single`` names
    gather = getattr(dist, "all_gather_single", dist.all_gather_into_tensor)
    gather(out, x, group=group)
    return out


def _reduce_scatter_flat(x: torch.Tensor, group) -> torch.Tensor:
    """This rank's ``1/P`` slice of the sum of every rank's flat ``x``."""
    p = dist.get_world_size(group)
    out = torch.empty(x.numel() // p, dtype=x.dtype, device=x.device)
    scatter = getattr(dist, "reduce_scatter_single",
                      dist.reduce_scatter_tensor)
    scatter(out, x.contiguous(), op=dist.ReduceOp.SUM, group=group)
    return out


def _exchange(send: Tuple[torch.Tensor, ...], to: int, frm: int,
              group) -> Tuple[torch.Tensor, ...]:
    """Send ``send`` to group rank ``to`` and receive tensors of the same
    shapes from group rank ``frm``, as one batch of point-to-point ops
    (each receive buffer paired with its own send)."""
    peer_to = dist.get_global_rank(group, to) if group is not None else to
    peer_frm = dist.get_global_rank(group, frm) if group is not None \
        else frm
    recv = tuple(torch.empty_like(t) for t in send)
    ops = [dist.P2POp(dist.isend, t.contiguous(), peer_to, group)
           for t in send]
    ops += [dist.P2POp(dist.irecv, r, peer_frm, group) for r in recv]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return recv


# ---------------------------------------------------------------------------
# the local fold and the streams' order
# ---------------------------------------------------------------------------

def local_fold(idx: torch.Tensor, val: torch.Tensor, size: int,
               accumulator: str = "scatter") -> torch.Tensor:
    """The dense mean of ``P`` streams, ``idx``/``val`` of ``(P, s)`` in
    the order a schedule concatenates them (:func:`stream_order`): one
    k-way SpKAdd of the flat stream, each key's values added in stream
    order from +0.0, then ``/ P``.

    ``accumulator="scatter"`` is the engine's ordered scatter
    (:func:`engine.scatter_accumulate`, the segment-fold kernel on the
    card); ``"vec"`` is ``kernels.ops.vec_accumulate_flat`` (the SPA
    kernel). Both give the same bits."""
    p = idx.shape[0]
    flat_idx, flat_val = idx.reshape(-1), val.reshape(-1)
    if accumulator == "vec":
        dense = _ops.vec_accumulate_flat(flat_idx, flat_val, m=size, n=1)
    elif accumulator == "scatter":
        dense = scatter_accumulate(flat_idx, flat_val, size)
    else:
        raise ValueError(f"unknown accumulator {accumulator!r}; choose "
                         f"'scatter' or 'vec'")
    return xla_float.div_const(dense, p)


def stream_order(schedule: str, p: int, rank: int) -> List[int]:
    """The worker whose stream sits in each row of ``rank``'s folded
    stream under ``schedule``:

    - ``gather_kway``: rank order, ``[0, 1, …, P−1]`` (the all-gather);
    - ``tree_2way``: ``[rank ^ j for j in range(P)]`` (each round appends
      the partner's stream, itself built the same way);
    - ``ring_2way``: ``[rank, rank − 1, rank − 2, …]`` mod P (hop ``h``
      brings the stream of the worker ``h`` places back)."""
    if schedule == "gather_kway":
        return list(range(p))
    if schedule == "tree_2way":
        _check_pow2(p)
        return [rank ^ j for j in range(p)]
    if schedule == "ring_2way":
        return [(rank - h) % p for h in range(p)]
    raise ValueError(f"unknown schedule {schedule!r}; "
                     f"choose from {sorted(SCHEDULES)}")


def _check_pow2(p: int) -> None:
    if p & (p - 1) != 0:
        raise ValueError("halving_2way needs a power-of-two group")


# ---------------------------------------------------------------------------
# schedules (u is this rank's SparseUpdate)
# ---------------------------------------------------------------------------

def gather_streams(u: SparseUpdate, group=None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every rank's ``(idx, val)`` as ``(P, s)`` in rank order."""
    p = dist.get_world_size(group)
    return (all_gather_flat(u.idx, group).view(p, -1),
            all_gather_flat(u.val, group).view(p, -1))


def halving_streams(u: SparseUpdate, group=None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Recursive halving: in round ``r`` exchange the whole stream with
    the partner ``rank ^ 2^r`` and append its stream to this one's (no
    re-top-k between rounds, so widths double). ``(P, s)`` in
    :func:`stream_order` ``"tree_2way"``."""
    p = dist.get_world_size(group)
    _check_pow2(p)
    me = dist.get_rank(group)
    idx, val = u.idx, u.val
    for r in range(p.bit_length() - 1):
        partner = me ^ (1 << r)
        o_idx, o_val = _exchange((idx, val), partner, partner, group)
        idx = torch.cat([idx, o_idx])
        val = torch.cat([val, o_val])
    return idx.view(p, -1), val.view(p, -1)


def ring_streams(u: SparseUpdate, group=None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Ring: P − 1 hops, each forwarding the stream last received to
    ``rank + 1`` and receiving from ``rank − 1``; the accumulated stream
    is ``[own, hop 1, hop 2, …]``, ``(P, s)`` in :func:`stream_order`
    ``"ring_2way"``."""
    p = dist.get_world_size(group)
    me = dist.get_rank(group)
    idx, val = u.idx, u.val
    acc_idx, acc_val = [idx], [val]
    for _ in range(p - 1):
        idx, val = _exchange((idx, val), (me + 1) % p, (me - 1) % p, group)
        acc_idx.append(idx)
        acc_val.append(val)
    return torch.stack(acc_idx), torch.stack(acc_val)


def allgather_kway(u: SparseUpdate, group=None,
                   accumulator: str = "scatter") -> torch.Tensor:
    """All-gather the sparse streams, then one local k-way SpKAdd (the
    paper's work-optimal k-way accumulation; k = group size)."""
    return local_fold(*gather_streams(u, group), u.size, accumulator)


def halving_2way(u: SparseUpdate, group=None) -> torch.Tensor:
    """Recursive halving (the paper's balanced-tree schedule); raises on
    a group whose size is not a power of two."""
    return local_fold(*halving_streams(u, group), u.size)


def ring_2way(u: SparseUpdate, group=None) -> torch.Tensor:
    """Ring fold (the paper's incremental schedule)."""
    return local_fold(*ring_streams(u, group), u.size)


SCHEDULES: Dict[str, Callable[..., torch.Tensor]] = {
    "gather_kway": allgather_kway,
    "tree_2way": halving_2way,
    "ring_2way": ring_2way,
}


def modeled_schedule_bytes(schedule: str, p: int, s: int,
                           entry_bytes: int = 8) -> int:
    """Modeled per-worker collective payload of a schedule: ``p`` workers,
    ``s``-entry streams, ``entry_bytes`` per (idx, val) pair (int32 + f32).

    ``gather_kway`` receives all P streams (P·s); ``tree_2way`` exchanges
    doubling widths over lg P rounds (s·(P−1) total); ``ring_2way`` forwards
    an s-entry payload on each of the P−1 hops. A copy of the reference's
    model, kept identical.
    """
    if schedule == "gather_kway":
        return p * s * entry_bytes
    return (p - 1) * s * entry_bytes  # tree_2way and ring_2way both sum to it


def _group_name(group) -> str:
    return "default" if group is None else str(group.group_name)


def sparse_allreduce(u: SparseUpdate, group=None,
                     schedule: str = "gather_kway",
                     accumulator: str = "scatter") -> torch.Tensor:
    """Reduce-mean a SparseUpdate across ``group``.

    ``accumulator`` selects the local k-way fold for the ``gather_kway``
    schedule ("scatter" | "vec"); the 2-way schedules ignore it.

    Observability, under the reference's names: each call records an
    ``allreduce.sparse`` span and bumps the per-schedule call counter and
    the modeled traffic-bytes counter (:func:`modeled_schedule_bytes`).
    """
    try:
        fn = SCHEDULES[schedule]
    except KeyError:
        raise ValueError(f"unknown schedule {schedule!r}; "
                         f"choose from {sorted(SCHEDULES)}") from None
    p = dist.get_world_size(group)
    s = int(u.idx.shape[0])
    nbytes = modeled_schedule_bytes(schedule, p, s)
    obs.counter(f"allreduce.calls.{schedule}").inc()
    obs.counter("allreduce.modeled_bytes").inc(nbytes)
    with obs.span("allreduce.sparse", schedule=schedule,
                  axis=_group_name(group), p=p, stream_len=s,
                  accumulator=accumulator, modeled_bytes=nbytes):
        if schedule == "gather_kway":
            return fn(u, group, accumulator=accumulator)
        return fn(u, group)


#: Leaves smaller than this fall back to a dense mean — the sparse stream +
#: schedule overhead only pays for itself on real tensors. Overridable per
#: call via ``min_compress_elems`` (tests compress tiny models).
MIN_COMPRESS_ELEMS = 16384


def _pmean(g: torch.Tensor, group) -> torch.Tensor:
    """The dense mean over ``group`` (the reference's ``pmean``): inputs
    flushed as XLA reads them, summed by the collective, ``/ P``. The sum's
    order is the backend's, not XLA's."""
    total = xla_float.flush(g).clone()
    dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
    return xla_float.div_const(total, dist.get_world_size(group))


def _astype(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x.astype(dtype)`` as XLA casts (bf16 rounded by XLA's rule)."""
    if dtype == torch.bfloat16 and x.dtype != torch.bfloat16:
        return xla_float.round_bf16(x)
    return x.to(dtype)


def _leafwise(grads, residuals, one_leaf):
    flat_g, treedef = _tree.flatten(grads)
    flat_r, treedef_r = _tree.flatten(residuals)
    if treedef_r != treedef:
        raise ValueError(f"residuals {_tree.describe(treedef_r)} do not "
                         f"match grads {_tree.describe(treedef)}")
    out = [one_leaf(g, r) for g, r in zip(flat_g, flat_r)]
    return (_tree.unflatten(treedef, [o[0] for o in out]),
            _tree.unflatten(treedef, [o[1] for o in out]))


def compressed_gradient_mean(grads, residuals, group=None,
                             k_fraction: float = 0.01,
                             schedule: str = "gather_kway",
                             selector: str = "block",
                             min_compress_elems: int = MIN_COMPRESS_ELEMS):
    """DP gradient reduction with the paper's technique, per tree leaf.

    ``grads`` are this rank's local dense gradients, ``residuals`` its
    error-feedback state (same tree, flat fp32 leaves). Returns (mean dense
    grads, new residuals), leaves in JAX's order. Leaves smaller than
    ``min_compress_elems`` fall back to a dense mean.
    """
    def one_leaf(g, r):
        flat = g.reshape(-1)
        n = flat.shape[0]
        if n < min_compress_elems:
            return _pmean(g, group), r
        u, new_r = sparsify_with_feedback(flat.to(torch.float32), r,
                                          global_k(n, k_fraction),
                                          selector=selector)
        mean = sparse_allreduce(u, group, schedule)
        return _astype(mean.reshape(g.shape), g.dtype), new_r

    return _leafwise(grads, residuals, one_leaf)


def compressed_gradient_mean_2d(grads, residuals, data_group, model_group,
                                k_fraction: float = 0.01,
                                schedule: str = "gather_kway",
                                selector: str = "block",
                                model_reduce: str = "reduce_scatter",
                                min_compress_elems: int = MIN_COMPRESS_ELEMS):
    """Sparse-DP × TP gradient reduction, per tree leaf, on a 2-D
    ``("data", "model")`` mesh: ``data_group`` and ``model_group`` are the
    mesh's two groups through this rank. Every rank holds the gradient of
    its own microbatch (or a tensor-parallel partial).

    1. **model group (dense)**: ``model_reduce="reduce_scatter"`` gives
       each model shard only its 1/T slice of the sum; ``"psum"`` sums the
       full vector and slices locally. Then ``/ T``.
    2. **data group (sparse)**: each model shard top-k-sparsifies its
       slice against its *own* residual (``per_shard_k``) and reduces it
       with the chosen schedule.
    3. **model group (gather)**: the dense slice means are all-gathered
       back, so every rank returns the full dense mean.

    ``residuals`` leaves are per-shard: flat fp32 of ``ceil(leaf.size /
    T)``. Leaves smaller than ``min_compress_elems`` fall back to a dense
    two-group mean. Returns (mean dense grads, new per-shard residuals).
    """
    if model_reduce not in ("reduce_scatter", "psum"):
        raise ValueError(f"unknown model_reduce {model_reduce!r}; "
                         "choose 'reduce_scatter' or 'psum'")
    t = dist.get_world_size(model_group)

    def one_leaf(g, r):
        flat = g.reshape(-1)
        n = flat.shape[0]
        if n < min_compress_elems:
            return _pmean(_pmean(g, model_group), data_group), r
        shard_len = -(-n // t)
        # inputs flushed as XLA reads them; with T = 2 the sum is then the
        # reference's bits (a + b in either order), and a subnormal sum is
        # flushed by the division below
        flat = xla_float.flush(flat)
        pad = shard_len * t - n
        if pad:
            flat = torch.cat([flat, flat.new_zeros(pad)])
        if model_reduce == "reduce_scatter":
            part = _reduce_scatter_flat(flat, model_group)
        else:  # psum: combine full, slice locally
            full = flat.clone()
            dist.all_reduce(full, op=dist.ReduceOp.SUM, group=model_group)
            me = dist.get_rank(model_group)
            part = full[me * shard_len:(me + 1) * shard_len]
        part = xla_float.div_const(part, t)  # mean over the model partials
        u, new_r = sparsify_with_feedback(part.to(torch.float32), r,
                                          per_shard_k(n, k_fraction, t),
                                          selector=selector)
        mean_shard = sparse_allreduce(u, data_group, schedule)
        mean = all_gather_flat(mean_shard, model_group)
        return _astype(mean[:n].reshape(g.shape), g.dtype), new_r

    return _leafwise(grads, residuals, one_leaf)

