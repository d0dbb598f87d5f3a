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

The router's top-k is a stable descending sort of the probabilities (the
rule of ``lax.top_k``: ties to the lower expert index), not a counted sort.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.sparse import stable_argsort, top_k
from repro_torch.kernels import xla_float
from repro_torch.kernels.segment import segment_fold
from repro_torch.models.common import ModelConfig, dense_init
from repro_torch.sharding.api import RowSplit, get_row_split


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
    slot: torch.Tensor        # (T*K,) sorted_e * C + rank within expert
    keep: torch.Tensor        # (T*K,) the rank is under the capacity
    tok: torch.Tensor         # (T*K,) token of each sorted position
    src_tok: torch.Tensor     # (E*C,) token a slot reads (0 if empty)
    slot_valid: torch.Tensor  # (E*C,) the slot holds an assignment


def dispatch(expert: torch.Tensor, n_experts: int, capacity: int,
             offset: torch.Tensor | None = None,
             slots: int | None = None) -> Dispatch:
    """Sort the assignments by expert (one counted stable sort) and give
    each expert's first ``capacity`` of them a slot. ``offset`` (E,): each
    expert's assignments in the rows before these, which rank ahead of
    them; ``slots``: the buffer's slots an expert (``capacity`` by
    default; it must hold every assignment kept here)."""
    T, K = expert.shape
    E, C, TK = n_experts, capacity, expert.numel()
    S = C if slots is None else slots
    dev = expert.device
    flat_e = expert.reshape(TK).to(torch.int32)
    order = stable_argsort(flat_e)
    sorted_e = flat_e[order]
    starts = torch.searchsorted(sorted_e, torch.arange(
        E, dtype=torch.int32, device=dev))
    pos = torch.arange(TK, device=dev) - starts[sorted_e.long()]
    keep = (pos if offset is None else pos + offset[sorted_e.long()]) < C
    slot = sorted_e.long() * S + pos
    tok = order // K
    # inverse permutation (slot -> assignment): unique slots, any scatter;
    # a dropped assignment writes one slot past the end, cut off after (a
    # scatter of static shape, where a boolean mask's size depends on the
    # values)
    inv = torch.full((E * S + 1,), TK, dtype=torch.int64, device=dev)
    inv[torch.where(keep, slot, E * S)] = torch.arange(TK, device=dev)
    inv = inv[:E * S]
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
    """``(f, P, dispatch)`` of this rank's rows as the reference takes them
    over the whole batch, whose rows lie in ``split``'s blocks: the
    capacity and the load ``f`` from the global token count, each
    expert's assignments ranked after those of the blocks before this
    one, and ``P`` the global mean probability. ``P``'s gradient is
    ``split.count`` times this block's share of it, so that the mean of
    the ranks' gradients (the sharded step's reduction) is the global
    one. The buffer has ``min(capacity, T)`` slots an expert: this block
    gives an expert at most ``T`` assignments."""
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
    return f, pbar, dispatch(expert, E, C, offset=offset, slots=min(C, T))


def moe_ffn(p: dict, x: torch.Tensor, cfg: ModelConfig
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (out (B, S, d), aux load-balance loss scalar)."""
    B, S, d = x.shape
    T = B * S
    E, K = cfg.n_experts, cfg.moe_topk

    xf = x.reshape(T, d)
    probs, gate, expert = route(p["router"], xf, K)
    split = get_row_split()
    if split is None:
        C = capacity_for(T, cfg)
        # aux loss (Switch-style): E * sum_e f_e * P_e
        f = expert_counts(expert, E).to(torch.float32) / (T * K)
        pbar = probs.mean(0)
        # ---- sort-based dispatch ---------------------------------------
        disp = dispatch(expert, E, C)
    else:
        f, pbar, disp = _routed_over_rows(split, probs, expert, cfg)
        C = disp.slot_valid.numel() // E
    aux = E * torch.sum(f * pbar)

    buf = xf[disp.src_tok] * disp.slot_valid[:, None].to(x.dtype)
    buf = buf.reshape(E, C, d)

    # ---- expert FFN (SwiGLU) --------------------------------------------
    h = F.silu(torch.einsum("ecd,edf->ecf", buf, p["we1"].to(x.dtype)))
    h = h * torch.einsum("ecd,edf->ecf", buf, p["we3"].to(x.dtype))
    out_buf = torch.einsum("ecf,efd->ecd", h, p["we2"].to(x.dtype))

    # ---- combine: SpKAdd of K sparse token-update matrices --------------
    yflat = out_buf.reshape(E * C, d)
    sorted_gate = gate.reshape(T * K)[disp.order].to(x.dtype)
    pos = token_order(disp, T, K).reshape(-1)
    contrib = yflat[disp.slot.clamp(0, E * C - 1)[pos]] * sorted_gate[pos,
                                                                      None]
    contrib = torch.where(disp.keep[pos, None], contrib, 0.0)
    y = combine(contrib.reshape(T, K, d))
    return y.reshape(B, S, d), aux
