"""Mixture-of-Experts FFN with sort-based capacity dispatch.

The port of ``src/repro/models/moe.py``. Tokens' (token, expert)
assignments are sorted by expert id with the counted stable sort
(``core.sparse.stable_argsort``, one a call); each expert takes its first
``capacity`` assignments and the rest drop. The dispatch buffer (E, C, d)
is built by a gather through the inverse permutation (slot -> assignment),
the experts' SwiGLU runs as batched products, and the outputs return to
their tokens.

The **combine step is an SpKAdd**: the K expert outputs of a token are K
sparse token-update matrices summed into the dense activation. The
reference's ``y.at[tok].add(contrib)`` applies its updates in operand
order (expert-sorted, stable), so each token's contributions fold left to
right from ``+0.0`` in the compute dtype, in ascending expert order (a
token's experts are distinct). ``index_add_`` on the card adds in no fixed
order, so :func:`combine` lays the contributions out token by token, K to
a feature, and folds each feature's run of K with the ordered segment fold
(``kernels/segment.py``: ``csrc/segment_fold.cu`` on the card, its plain
version on the CPU), XLA's float rules included. A dropped assignment
contributes ``+0.0``, which leaves a running sum that started at ``+0.0``
unchanged (such a sum is never ``-0.0``).

When the sharded train step runs the model on each rank's own rows
(``repro_torch.sharding.api.get_row_split``), the capacity, the ranks
within an expert and the load-balance statistics are still the whole
batch's, as under the reference's ``jit``: each rank all-gathers its
expert counts and probability sums.

The sharded train step hands the layer its leaves as
``sharding.api.Placed`` shards, and then each rank computes only its
block of the reference's buffer, whose hint is ``("experts", "capacity",
None)``: experts over ``model``, capacity over ``data`` (over ``data``
alone on a ``pod`` mesh, so the block is replicated over ``pod``). Slot
``(e, c)`` lives on ``model`` rank ``e // (E / tp)`` and ``data`` rank
``c // ceil(C / dp)``; the rank gathers only its own experts (over the
data axes) and runs their SwiGLU over its slots. Routing, the aux loss
and the global dispatch stay replicated over ``model``. The tokens move
with static shapes: each rank lays its own assignments to its ``model``
rank's experts into a buffer of every ``data`` rank's slots (zero where
another rank's token sits) and a reduce-scatter over ``data`` (then an
all-reduce over ``pod``) hands each rank its block, every slot summed
from one nonzero source; the outputs come back by an all-gather over
``data``, each rank takes its tokens' contributions from its experts,
zero elsewhere, and a sum over ``model`` gives every rank all ``K`` of
each of its tokens, exactly (one nonzero source a position), for the
ordered fold.

The router's top-k is a stable descending sort of the probabilities (the
rule of ``lax.top_k``: ties to the lower expert index), not a counted sort.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import Partial, Replicate, Shard

from repro_torch.core.sparse import stable_argsort, top_k
from repro_torch.kernels import xla_float
from repro_torch.kernels.segment import segment_fold
from repro_torch.models.common import ModelConfig, dense_init
from repro_torch.sharding.api import (ModelSplit, Placed, RowSplit,
                                      copy_to_model, gather_at_use,
                                      get_row_split, model_split,
                                      redistributed, sum_over_model)


def init_moe_params(gen: torch.Generator, cfg: ModelConfig) -> dict:
    d, ff, e, pdt = cfg.d_model, cfg.d_ff, cfg.n_experts, cfg.pdtype
    return {
        "router": dense_init(gen, (d, e), pdt),
        "we1": dense_init(gen, (e, d, ff), pdt, fan_in=d),
        "we3": dense_init(gen, (e, d, ff), pdt, fan_in=d),
        "we2": dense_init(gen, (e, ff, d), pdt, fan_in=ff),
    }


def expert_counts(expert: torch.Tensor, E: int) -> torch.Tensor:
    """The assignments of each of the ``E`` experts (int64 ``(E,)``): ones
    scattered into a buffer of static shape, the reference's ``zeros((E,))
    .at[expert].add(1.0)``. (``bincount``'s size depends on the values,
    which a trace on fake tensors cannot know.)"""
    flat = expert.reshape(-1)
    return torch.zeros(E, dtype=torch.int64, device=flat.device).scatter_add_(
        0, flat, torch.ones_like(flat))


def capacity_for(tokens: int, cfg: ModelConfig) -> int:
    c = math.ceil(tokens * cfg.moe_topk / cfg.n_experts * cfg.capacity_factor)
    return max(8, ((c + 7) // 8) * 8)  # sublane-align


def route(router: torch.Tensor, xf: torch.Tensor, k: int):
    """``(probs (T, E), gate (T, k), expert (T, k))``: the f32 router's
    softmax, its top ``k`` (largest first, ties to the lower expert) and
    the gates renormalised to sum to 1."""
    logits = xf.to(torch.float32) @ router.to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    gate, expert = top_k(probs, k)
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    return probs, gate, expert


class Dispatch(NamedTuple):
    """The sort-based dispatch of ``T * K`` assignments into ``E * C``
    slots, every tensor indexed as the reference's."""
    order: torch.Tensor       # (T*K,) assignment of each sorted position
    slot: torch.Tensor        # (T*K,) its slot in the buffer (see dispatch)
    keep: torch.Tensor        # (T*K,) the rank is under the capacity
    tok: torch.Tensor         # (T*K,) token of each sorted position
    src_tok: torch.Tensor     # (slots,) token a slot reads (0 if empty)
    slot_valid: torch.Tensor  # (slots,) the slot holds an assignment


class Block(NamedTuple):
    """This rank's block of the global ``(E, C)`` slots: experts
    ``first`` to ``first + experts`` (its ``model`` rank's), in each of
    ``blocks`` capacity blocks of ``ceil(C / blocks)`` slots (one a
    ``data`` rank)."""
    first: int
    experts: int
    blocks: int


def dispatch(expert: torch.Tensor, n_experts: int, capacity: int,
             offset: torch.Tensor | None = None,
             slots: int | None = None,
             block: Block | None = None) -> Dispatch:
    """Sort the assignments by expert (one counted stable sort) and give
    each expert's first ``capacity`` of them a slot. ``offset`` (E,): each
    expert's assignments in the rows before these, which rank ahead of
    them; ``slots``: the buffer's slots an expert (``capacity`` by
    default; it must hold every assignment kept here); a slot is then
    ``expert * slots + rank among these rows``. With a ``block`` the
    buffer is the send layout of :func:`moe_ffn` on shards: every
    capacity block of ``block``'s experts, ``(blocks, experts,
    ceil(C / blocks))``, each assignment at its global rank (``offset``
    added), and an assignment to another rank's experts, or dropped, at
    one past the end."""
    T, K = expert.shape
    E, C, TK = n_experts, capacity, expert.numel()
    dev = expert.device
    flat_e = expert.reshape(TK).to(torch.int32)
    order = stable_argsort(flat_e)
    sorted_e = flat_e[order]
    starts = torch.searchsorted(sorted_e, torch.arange(
        E, dtype=torch.int32, device=dev))
    pos = torch.arange(TK, device=dev) - starts[sorted_e.long()]
    rank = pos if offset is None else pos + offset[sorted_e.long()]
    if block is None:
        S = C if slots is None else slots
        n = E * S
        keep = rank < C
        slot = sorted_e.long() * S + pos
    else:
        S = -(-C // block.blocks)
        n = block.blocks * block.experts * S
        # ``offset`` comes over a collective (uninitialized memory under a
        # fake process group): the rank is bounded, every index clamped
        keep = (rank >= 0) & (rank < C)
        c = rank.clamp(0, C - 1)
        e = sorted_e.long() - block.first
        ours = keep & (e >= 0) & (e < block.experts)
        slot = torch.where(ours, ((c // S) * block.experts
                                  + e.clamp(0, block.experts - 1)) * S
                           + c % S, n)
    tok = order // K
    # inverse permutation (slot -> assignment): unique slots, any scatter;
    # an assignment without a slot here writes one slot past the end, cut
    # off after (a scatter of static shape, where a boolean mask's size
    # depends on the values)
    inv = torch.full((n + 1,), TK, dtype=torch.int64, device=dev)
    inv[torch.where(keep, slot, n) if block is None
        else slot] = torch.arange(TK, device=dev)
    inv = inv[:n]
    slot_valid = inv < TK
    src_tok = torch.where(slot_valid, tok[inv.clamp(0, TK - 1)], 0)
    return Dispatch(order, slot, keep, tok, src_tok, slot_valid)


def token_order(d: Dispatch, T: int, K: int) -> torch.Tensor:
    """``(T, K)`` sorted positions, token by token and in stream (expert)
    order within a token: position ``[t, r]`` holds the sorted position of
    token ``t``'s ``r``-th assignment in the reference's operand order."""
    TK = T * K
    dev = d.order.device
    inv = torch.empty(TK, dtype=torch.int64, device=dev)
    inv[d.order] = torch.arange(TK, device=dev)
    per_tok = inv.reshape(T, K)
    # rank of each of a token's sorted positions among its K (distinct)
    rank = (per_tok[:, None, :] < per_tok[:, :, None]).sum(-1)
    out = torch.empty_like(per_tok)
    out.scatter_(1, rank, per_tok)
    return out


class _Combine(torch.autograd.Function):
    """``y[t] = fold(+0.0, c[t, 0], ..., c[t, K-1])`` in ``c``'s type; each
    contribution's gradient is its token's."""

    @staticmethod
    def forward(ctx, contrib):
        T, K, d = contrib.shape
        ctx.shape = contrib.shape
        vals = contrib.transpose(1, 2).reshape(T, d * K)
        gid = torch.arange(d, dtype=torch.int32,
                           device=contrib.device).repeat_interleave(K)
        return segment_fold(vals, gid.expand(T, d * K), d)

    @staticmethod
    def backward(ctx, dy):
        return dy[:, None, :].expand(ctx.shape)


def combine(contrib: torch.Tensor) -> torch.Tensor:
    """The combine of ``contrib`` (T, K, d): each token's K contributions
    folded left to right from ``+0.0``, rounding after every add, by the
    ordered segment fold (the kernel on the card)."""
    return _Combine.apply(contrib)


def combine_plain(contrib: torch.Tensor) -> torch.Tensor:
    """:func:`combine` as K passes of XLA's add over the tokens, each pass
    adding every token's next contribution: the plain left-to-right fold."""
    T, K, d = contrib.shape
    y = torch.zeros((T, d), dtype=contrib.dtype, device=contrib.device)
    for r in range(K):
        y = xla_float.add_as(y, contrib[:, r])
    return y


def _routed_over_rows(split: RowSplit, probs: torch.Tensor,
                      expert: torch.Tensor, cfg: ModelConfig):
    """``(f, P, offset, C)`` of this rank's rows as the reference takes
    them over the whole batch, whose rows lie in ``split``'s blocks: the
    capacity ``C`` and the load ``f`` from the global token count,
    ``offset`` each expert's assignments in the blocks before this one
    (which rank ahead of this block's), and ``P`` the global mean
    probability. ``P``'s gradient is ``split.count`` times this block's
    share of it, so that the mean of the ranks' gradients (the sharded
    step's reduction) is the global one."""
    T, K = expert.shape
    E, n = cfg.n_experts, split.count
    Tg = T * n
    C = capacity_for(Tg, cfg)
    counts = expert_counts(expert, E)
    psum = probs.sum(0)
    all_counts = split.gather(counts)
    f = all_counts.sum(0).to(torch.float32) / (Tg * K)
    pbar = split.gather(psum.detach()).sum(0) / Tg
    pbar = pbar + (psum - psum.detach()) / T  # the value stays pbar's
    offset = all_counts[:split.index].sum(0)
    return f, pbar, offset, C


def experts_swiglu(buf: torch.Tensor, we1: torch.Tensor, we3: torch.Tensor,
                   we2: torch.Tensor) -> torch.Tensor:
    """The experts' SwiGLU on their slots: ``buf`` (E, C, d) with the
    experts' ``we1``, ``we3`` (E, d, ff) and ``we2`` (E, ff, d), cast to
    ``buf``'s type, as batched products."""
    h = F.silu(torch.einsum("ecd,edf->ecf", buf, we1.to(buf.dtype)))
    h = h * torch.einsum("ecd,edf->ecf", buf, we3.to(buf.dtype))
    return torch.einsum("ecf,efd->ecd", h, we2.to(buf.dtype))


class Shards(NamedTuple):
    """Where the sharded train step puts this rank's block of the
    dispatch buffer: ``block`` (:class:`Block`), the ``experts``' split
    over ``model`` (``None``: every rank holds all of them), and the dims
    of ``mesh`` the batch rows are split over: ``data``, the capacity
    blocks' (``None``: one block), and ``pods``, over which the block is
    replicated."""
    block: Block
    experts: Optional[ModelSplit]
    mesh: Any
    data: Optional[int]
    pods: Tuple[int, ...]


_EXPERT_LEAVES = ("we1", "we3", "we2")


def shards_of(p: dict, split: Optional[RowSplit],
              cfg: ModelConfig) -> Optional[Shards]:
    """The :class:`Shards` of the MoE leaves ``p`` when the sharded step
    hands them as ``Placed`` shards on a mesh with more than one rank on
    ``model`` (the experts split there, when all three leaves are) or on
    the dims the rows are split over; ``None`` otherwise (plain leaves:
    serving and the plain step; world 1), which keeps the whole buffer."""
    if not isinstance(p["we1"], Placed):
        return None
    splits = [model_split(p[n], 0) for n in _EXPERT_LEAVES]
    experts = splits[0] if all(splits) else None
    dims = () if split is None else split.dims
    if experts is None and not dims:
        return None
    mesh = p["we1"].mesh
    names = tuple(mesh.mesh_dim_names)
    data = next((i for i in dims if names[i] == "data"), None)
    pods = tuple(i for i in dims if i != data)
    E = cfg.n_experts
    n = E if experts is None else E // experts.size
    first = 0 if experts is None else experts.rank * n
    blocks = 1 if data is None else mesh.size(data)
    return Shards(Block(first, n, blocks), experts, mesh, data, pods)


def _placements(sh: Shards, data, pods) -> tuple:
    return tuple(data if i == sh.data else pods if i in sh.pods
                 else Replicate() for i in range(sh.mesh.ndim))


def _to_owners(send: torch.Tensor, sh: Shards) -> torch.Tensor:
    """Every rank's send buffer (``(blocks * experts * slots, d)``, each
    slot nonzero on one rank at most) summed, each rank keeping its
    capacity block: a reduce-scatter over ``data``, then an all-reduce
    over ``pods``. In backward, each block's gradient summed over
    ``pods`` and gathered over ``data``."""
    shape = tuple(send.shape)
    sum_, rep, blk = Partial("sum"), Replicate(), Shard(0)
    if sh.data is not None:
        send = redistributed(
            send, sh.mesh, shape,
            (_placements(sh, sum_, sum_), _placements(sh, blk, sum_)),
            (_placements(sh, blk, rep), _placements(sh, rep, rep)))
    if sh.pods:
        send = redistributed(
            send, sh.mesh, shape,
            (_placements(sh, blk, sum_), _placements(sh, blk, rep)),
            (_placements(sh, blk, sum_), _placements(sh, blk, rep)))
    return send


def _from_owners(out: torch.Tensor, sh: Shards) -> torch.Tensor:
    """Each rank's block of outputs gathered over ``data`` into every
    capacity block of its experts; in backward each block's gradient
    summed over ``data`` into its owner (a reduce-scatter). The ``pods``
    hold the same blocks and use them for their own rows: nothing moves
    there."""
    if sh.data is None:
        return out
    shape = (out.shape[0] * sh.block.blocks,) + tuple(out.shape[1:])
    sum_, rep, blk = Partial("sum"), Replicate(), Shard(0)
    return redistributed(
        out, sh.mesh, shape,
        (_placements(sh, blk, rep), _placements(sh, rep, rep)),
        (_placements(sh, sum_, rep), _placements(sh, blk, rep)))


class _Rows(torch.autograd.Function):
    """``x``'s rows at ``index``, zero where not ``valid``. Its backward is
    the gather ``back`` (for each of ``x``'s rows, the ``m`` rows of the
    output it went to, zero where not ``back_valid``) summed over ``m``:
    the transpose as a gather, where autograd's would scatter-add the
    gradient (an accumulating ``index_put_``, which on the card runs the
    many skipped rows that all read one row one after another)."""

    @staticmethod
    def forward(ctx, x, index, valid, back, back_valid):
        ctx.save_for_backward(back, back_valid)
        return torch.where(valid[:, None], x[index], 0.0)

    @staticmethod
    def backward(ctx, g):
        back, back_valid = ctx.saved_tensors
        gx = torch.where(back_valid[..., None], g[back], 0.0).sum(1)
        return gx, None, None, None, None


def _on_shards(p: dict, xf: torch.Tensor, gate: torch.Tensor,
               expert: torch.Tensor, C: int, offset, sh: Shards,
               cfg: ModelConfig) -> torch.Tensor:
    """The experts' part of :func:`moe_ffn` on this rank's block of the
    buffer (:class:`Shards`): ``(T, d)``, each token's ``K`` contributions
    folded in order, the same on every ``model`` rank."""
    T, K = expert.shape
    d = xf.shape[1]
    blk = sh.block
    we = [gather_at_use(p[n], keep_model=sh.experts is not None)
          for n in _EXPERT_LEAVES]
    disp = dispatch(expert, cfg.n_experts, C, offset=offset, block=blk)
    n = disp.slot_valid.numel()
    # each token's K slots in the send layout (n: not this rank's), and
    # each slot's reader among the token-major positions
    pos = token_order(disp, T, K).reshape(-1)
    slot = disp.slot[pos]
    ours = slot < n
    slot = slot.clamp(max=n - 1)
    reader = torch.zeros(n + 1, dtype=torch.int64, device=xf.device)
    reader[torch.where(ours, slot, n)] = torch.arange(T * K,
                                                      device=xf.device)
    # the routing's gradient is the same on every model rank; only the
    # experts' part is summed over model
    xe = copy_to_model(xf, sh.experts)
    send = _Rows.apply(xe, disp.src_tok, disp.slot_valid, slot.view(T, K),
                       ours.view(T, K))
    buf = _to_owners(send, sh).reshape(blk.experts, -1, d)
    out = _from_owners(experts_swiglu(buf, *we).reshape(-1, d), sh)

    # ---- combine: SpKAdd of K sparse token-update matrices --------------
    sorted_gate = gate.reshape(T * K)[disp.order].to(xf.dtype)
    contrib = _Rows.apply(out, slot, ours, reader[:n, None],
                          disp.slot_valid[:, None])
    contrib = sum_over_model(contrib, sh.experts) * sorted_gate[pos, None]
    return combine(contrib.reshape(T, K, d))


def moe_ffn(p: dict, x: torch.Tensor, cfg: ModelConfig
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (out (B, S, d), aux load-balance loss scalar).
    ``p``'s leaves are tensors, or the sharded step's ``Placed`` shards:
    the router is then gathered whole and the experts computed on this
    rank's block of the buffer (:func:`shards_of`)."""
    B, S, d = x.shape
    T = B * S
    E, K = cfg.n_experts, cfg.moe_topk

    split = get_row_split()
    sh = shards_of(p, split, cfg)
    xf = x.reshape(T, d)
    probs, gate, expert = route(gather_at_use(p["router"]), xf, K)
    offset = None
    if split is None:
        C = capacity_for(T, cfg)
        # aux loss (Switch-style): E * sum_e f_e * P_e
        f = expert_counts(expert, E).to(torch.float32) / (T * K)
        pbar = probs.mean(0)
    else:
        f, pbar, offset, C = _routed_over_rows(split, probs, expert, cfg)
    aux = E * torch.sum(f * pbar)
    if sh is not None:
        y = _on_shards(p, xf, gate, expert, C, offset, sh, cfg)
        return y.reshape(B, S, d), aux

    # ---- sort-based dispatch -------------------------------------------
    # under a row split this block gives an expert at most T assignments
    disp = dispatch(expert, E, C, offset=offset,
                    slots=None if split is None else min(C, T))
    del offset  # not held past the dispatch
    C = disp.slot_valid.numel() // E
    buf = xf[disp.src_tok] * disp.slot_valid[:, None].to(x.dtype)
    buf = buf.reshape(E, C, d)

    # ---- expert FFN (SwiGLU) --------------------------------------------
    out_buf = experts_swiglu(buf, *(gather_at_use(p[n])
                                    for n in _EXPERT_LEAVES))

    # ---- combine: SpKAdd of K sparse token-update matrices --------------
    yflat = out_buf.reshape(E * C, d)
    sorted_gate = gate.reshape(T * K)[disp.order].to(x.dtype)
    pos = token_order(disp, T, K).reshape(-1)
    contrib = yflat[disp.slot.clamp(0, E * C - 1)[pos]] * sorted_gate[pos,
                                                                      None]
    contrib = torch.where(disp.keep[pos, None], contrib, 0.0)
    y = combine(contrib.reshape(T, K, d))
    return y.reshape(B, S, d), aux
