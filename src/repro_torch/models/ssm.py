"""Mamba2 (SSD — state-space duality) blocks and LM.

The port of ``src/repro/models/ssm.py``. Training and prefill use the
chunked SSD algorithm: the sequence is split into chunks of L tokens; each
chunk computes its quadratic intra-chunk term (the "attention-like" dual
form) and passes an f32 (H, headdim, N) state on to the next. The chunks
run one after another in a Python loop (the reference's ``lax.scan``),
and under autograd each chunk's body is recomputed in backward
(``torch.utils.checkpoint``, the reference's ``jax.checkpoint`` of its
scan body), so live memory holds one chunk's (B, L, L, H) f32 decay, not
one a chunk. All decay exponents are ≤ 0 (A < 0, dt > 0), so every exp()
is ≤ 1: f32-stable without rescaling tricks. The causal mask is applied
to the exponent before the ``exp`` (``-inf`` above the diagonal), as the
reference does: a mask after it would give ``inf * 0 = NaN`` in backward.

Decode is the O(1) recurrent form: state ← dA·state + dt·B⊗x, y = C·state.

The reference's arithmetic is kept: the depthwise causal convolution is
four f32 taps accumulated from zeros in tap order, and the softplus is
``jax.nn.softplus``'s ``max(x, 0) + log1p(exp(-|x|))`` (no threshold).
The reference's three-operand products are written as two steps each (a
per-token or per-head factor applied beside one two-operand contraction),
an order XLA may not pick: a matter of f32 rounding. The products must be
full f32 (``layers.require_full_precision``: TF32 off).

On the sharded train step's leaves (``sharding.api.Placed``) a block
gathers its leaves where it uses them and, where the spec splits
``out_proj``'s rows over ``model`` into whole heads, runs on this rank's
SSM heads (:func:`mamba_split`, :func:`_heads_of`): the SSD scan on (B,
S, H / model, P), B and C whole on every rank, the gated norm's mean of
squares summed over ``model`` and ``out_proj``'s product summed over
``model``. The serving steps' leaves (TP-only) run the same way: prefill
returns this rank's part of the reference's cache layout (the state on
its heads, the conv window on its block of the conv channels), and
decode runs on its heads with no weight moved (:func:`_decode_on_heads`).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.core.sparse import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.common import (ModelConfig, TreeModel, dense_init,
                                       embed_lookup, maybe_remat, per_layer,
                                       stacked)
from repro_torch.models.transformer import chunked_ce
from repro_torch.sharding.api import (ModelSplit, at_use, copy_to_model,
                                      gather_at_use, gather_over_model,
                                      model_split, sum_over_model,
                                      total_over_model)


class MambaCache(NamedTuple):
    conv: torch.Tensor   # (B, W-1, conv_dim) most-recent inputs, oldest first
    ssm: torch.Tensor    # (B, H, headdim, N) running state, f32


def _conv_dim(cfg: ModelConfig) -> int:
    return cfg.d_inner + 2 * cfg.ssm_state  # x + B + C (G=1 group)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus`` (``logaddexp(x, 0)``): no threshold."""
    return torch.clamp(x, min=0) + torch.log1p(torch.exp(-x.abs()))


def init_mamba_params(gen: torch.Generator, cfg: ModelConfig) -> dict:
    d, di, N, H = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads
    cdim = _conv_dim(cfg)
    dev, pdt = gen.device, cfg.pdtype
    lo, hi = math.log(1e-3), math.log(1e-1)
    u = torch.rand((H,), generator=gen, dtype=torch.float32, device=dev)
    dt = torch.exp(lo + (hi - lo) * u)
    return {
        "ln": torch.zeros((d,), dtype=pdt, device=dev),
        "in_proj": dense_init(gen, (d, 2 * di + 2 * N + H), pdt),
        "conv_w": dense_init(gen, (cfg.conv_width, cdim), pdt,
                             fan_in=cfg.conv_width),
        "conv_b": torch.zeros((cdim,), dtype=pdt, device=dev),
        "A_log": torch.log(torch.linspace(1.0, 16.0, H, device=dev)).to(pdt),
        "D": torch.ones((H,), dtype=pdt, device=dev),
        "dt_bias": torch.log(torch.expm1(dt)).to(pdt),
        "gn": torch.zeros((di,), dtype=pdt, device=dev),
        "out_proj": dense_init(gen, (di, d), pdt),
    }


def _split_proj(cfg: ModelConfig, zxbcdt: torch.Tensor, T: int = 1):
    """``(z, xBC, dt)`` of ``in_proj``'s product on ``1 / T`` of the
    heads (:func:`_heads_of`): ``d_inner / T`` channels of z, of x and
    ``H / T`` of dt, all of B and C."""
    di, H = cfg.d_inner // T, cfg.n_ssm_heads // T
    cdim = di + 2 * cfg.ssm_state
    z = zxbcdt[..., :di]
    xBC = zxbcdt[..., di:di + cdim]
    dt = zxbcdt[..., di + cdim:]
    if dt.shape[-1] != H:
        raise ValueError(f"dt trailing dim {dt.shape[-1]} must equal the "
                         f"head count {H}")
    return z, xBC, dt


def _causal_conv_full(xBC: torch.Tensor, w: torch.Tensor,
                      b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over (B, S, C) with kernel (W, C)."""
    W, S = w.shape[0], xBC.shape[1]
    pad = F.pad(xBC, (0, 0, W - 1, 0))
    out = torch.zeros_like(xBC)
    for i in range(W):
        out = out + pad[:, i:i + S, :] * w[i]
    return F.silu(out + b)


def _chunk_step(state, xc, dtc, Bc, Cc, A, tril):
    """One chunk of the SSD scan: (B,L,H,P), (B,L,H), (B,L,N) inputs and
    the (B,H,P,N) state in; (new state, the chunk's y (B,L,H,P)) out."""
    dA = dtc * A                                      # (B,L,H) ≤ 0
    cum = torch.cumsum(dA, dim=1)                     # (B,L,H)
    seg = cum[:, :, None, :] - cum[:, None, :, :]     # (B,L,L,H), i≥j ≤ 0
    decay = torch.exp(torch.where(tril[None, :, :, None], seg,
                                  float("-inf")))
    CB = torch.einsum("bln,bmn->blm", Cc, Bc)         # (B,L,L)
    att = CB[..., None] * decay                       # (B,L,L,H)
    xdt = xc * dtc[..., None]                         # (B,L,H,P)
    y_intra = torch.einsum("blmh,bmhp->blhp", att, xdt)
    # the reference's three-operand products, as two steps each: its
    # per-token factor applied outside the contraction over n, inside the
    # one over l (no (B, L, N, H, P) intermediate)
    y_inter = (torch.einsum("bln,bhpn->blhp", Cc, state)
               * torch.exp(cum)[..., None])
    dec_end = torch.exp(cum[:, -1:, :] - cum)         # (B,L,H)
    s_new = torch.einsum("bln,blhp->bhpn", Bc, xdt * dec_end[..., None])
    state = state * torch.exp(cum[:, -1, :])[:, :, None, None] + s_new
    return state, y_intra + y_inter


def _ssd_chunk_scan(x, dt, Bm, Cm, A, chunk: int, state0=None):
    """Chunked SSD. x: (B,S,H,P); dt: (B,S,H); Bm/Cm: (B,S,N); A: (H,)<0.
    Returns (y (B,S,H,P), final_state (B,H,P,N))."""
    L.require_full_precision(x)
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    # pad S to a chunk multiple (a prompt under one chunk to one whole
    # chunk): dt=0 padding is exact (dA=0 -> decay 1, contribution
    # dt·B·x = 0), so state and outputs are untouched
    S_pad = ((S + chunk - 1) // chunk) * chunk if S > chunk else chunk
    if S_pad != S:
        pad = S_pad - S
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, pad))
    nc = S_pad // chunk
    tril = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=x.device))
    state = (torch.zeros((Bsz, H, P, N), dtype=torch.float32,
                         device=x.device) if state0 is None else state0)
    # backward recomputes each chunk's (L, L) intra-chunk kernel rather
    # than saving one per chunk
    remat = torch.is_grad_enabled() and any(
        t.requires_grad for t in (x, dt, Bm, Cm, A, state))
    ys = []
    for c in range(nc):
        sl = slice(c * chunk, (c + 1) * chunk)
        args = (state, x[:, sl], dt[:, sl], Bm[:, sl], Cm[:, sl], A, tril)
        if remat:
            state, y = checkpoint(_chunk_step, *args, use_reentrant=False)
        else:
            state, y = _chunk_step(*args)
        ys.append(y)
    y = torch.cat(ys, dim=1)[:, :S]
    return y, state


def mamba_split(p, cfg: ModelConfig) -> Optional[ModelSplit]:
    """The ``model`` layout a Mamba2 block runs on its SSM heads with: its
    leaves' (the sharded train step's ``sharding.api.Placed``) when the
    spec splits ``out_proj``'s rows over ``model`` and ``model`` divides
    the heads, so that each rank's rows are whole heads (``d_inner = H x
    P``); ``None`` (the block runs whole) otherwise."""
    split = model_split(p["out_proj"], -2)
    if split is None or cfg.n_ssm_heads % split.size:
        return None
    return split


def _heads_of(p, cfg: ModelConfig, split: ModelSplit) -> dict:
    """The block's leaves as this rank's ``H / T`` heads use them.
    ``in_proj``'s ``model`` shard is no block of heads (its columns pack
    ``[z | x | B | C | dt]``), so it is gathered whole and this rank takes
    its ``d_inner / T`` columns of z and of x, all of B and C (every head
    reads them in Mamba2's one group) and its ``H / T`` of dt; the
    replicated conv its channels of x and B's and C's; ``A_log``, ``D``,
    ``dt_bias`` their heads and ``gn`` its channels. Each of these is the
    whole leaf's gradient in backward, each rank's part summed over
    ``model`` (B's and C's columns a partial sum on every rank).
    ``out_proj`` stays on its ``model`` shard: its rows are this rank's
    heads; ``ln`` is gathered whole."""
    di, N, H = cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads
    T, r = split.size, split.rank
    dl, hl = di // T, H // T
    own = (r * dl, (r + 1) * dl)

    def whole(name):
        return gather_at_use(p[name], model_partial=True)

    def cols(w, spans):
        return torch.cat([w[..., a:b] for a, b in spans], dim=-1)

    dt0 = 2 * di + 2 * N
    conv = (own, (di, di + 2 * N))
    w = {"ln": gather_at_use(p["ln"]),
         "in_proj": cols(whole("in_proj"),
                         (own, (di + own[0], di + own[1]),
                          (2 * di, dt0), (dt0 + r * hl, dt0 + (r + 1) * hl))),
         "conv_w": cols(whole("conv_w"), conv),
         "conv_b": cols(whole("conv_b"), conv),
         "gn": whole("gn")[own[0]:own[1]],
         "out_proj": gather_at_use(p["out_proj"], keep_model=True)}
    for name in ("A_log", "D", "dt_bias"):
        w[name] = whole(name)[r * hl:(r + 1) * hl]
    return w


def _rms_norm_over_model(x: torch.Tensor, scale: torch.Tensor,
                         split: Optional[ModelSplit], width: int,
                         eps: float = 1e-6) -> torch.Tensor:
    """``layers.rms_norm`` of rows whose ``width`` channels are split
    over ``model``, ``x`` and ``scale`` this rank's: the mean of squares
    is the sum over ``model`` of each rank's sum of squares over
    ``width``, and its gradient each rank's share summed
    (``total_over_model``). ``layers.rms_norm`` itself with no split."""
    if split is None:
        return L.rms_norm(x, scale, eps)
    dt = x.dtype
    x32 = x.to(torch.float32)
    var = total_over_model(torch.sum(x32 * x32, dim=-1, keepdim=True),
                           split) / width
    return ((x32 * torch.rsqrt(var + eps))
            * (1.0 + scale.to(torch.float32))).to(dt)


def mamba_block_full(p, u: torch.Tensor, cfg: ModelConfig,
                     state0=None, collect_cache: bool = False
                     ) -> Tuple[torch.Tensor, Optional[MambaCache]]:
    """Full-sequence Mamba2 block. Returns (out, cache for decode). The
    leaves are gathered where they are used (``sharding.api``). On a
    :func:`mamba_split` the block runs on this rank's heads
    (:func:`_heads_of`): ``h`` copied to ``model``, the SSD scan on (B, S,
    H / T, P), the gated norm's mean of squares summed over ``model``,
    ``out_proj``'s product summed over ``model``; its cache, built only
    when ``collect_cache`` (else ``None``), is this rank's part of the
    reference's layout (:func:`_split_cache`)."""
    N, P = cfg.ssm_state, cfg.ssm_head_dim
    split = mamba_split(p, cfg)
    T = 1 if split is None else split.size
    di, H = cfg.d_inner // T, cfg.n_ssm_heads // T
    Bsz, S, _ = u.shape
    f32 = torch.float32
    w = at_use(p) if split is None else _heads_of(p, cfg, split)
    h = copy_to_model(L.rms_norm(u, w["ln"]), split)
    zxbcdt = h @ w["in_proj"].to(h.dtype)
    z, xBC_raw, dt = _split_proj(cfg, zxbcdt, T)
    xBC = _causal_conv_full(xBC_raw.to(f32), w["conv_w"].to(f32),
                            w["conv_b"].to(f32))
    x = xBC[..., :di].reshape(Bsz, S, H, P)
    Bm = xBC[..., di:di + N]
    Cm = xBC[..., di + N:]
    dt_s = softplus(dt.to(f32) + w["dt_bias"].to(f32))
    A = -torch.exp(w["A_log"].to(f32))
    y, final_state = _ssd_chunk_scan(x, dt_s, Bm, Cm, A, cfg.ssm_chunk,
                                     state0)
    y = y + x * w["D"].to(f32)[:, None]
    y = y.reshape(Bsz, S, di)
    y = _rms_norm_over_model((y * F.silu(z.to(f32))).to(u.dtype), w["gn"],
                             split, cfg.d_inner)
    out = sum_over_model(y @ w["out_proj"].to(u.dtype), split)
    if split is not None:
        return u + out, (_split_cache(xBC_raw, final_state, cfg, split)
                         if collect_cache else None)
    # decode cache: last W-1 conv inputs (zeros in front of a shorter
    # sequence) + final ssm state
    W = cfg.conv_width
    tail = xBC_raw[:, -(W - 1):, :]
    pad = max(0, (W - 1) - S)
    if pad:
        tail = F.pad(tail, (0, 0, pad, 0))
    cache = MambaCache(conv=tail.to(cfg.cdtype),
                       ssm=final_state.to(f32))
    return u + out, cache


def _conv_block(t: torch.Tensor, cfg: ModelConfig,
                split: ModelSplit) -> torch.Tensor:
    """This rank's block of the conv channels (the last dim of ``t``, all
    ``d_inner + 2 N`` of them) where the reference's ``cache_spec``
    splits them over ``model``; ``t`` whole where ``model`` does not
    divide them. The block straddles x, B and C as ``in_proj``'s
    ``model`` block straddles z, x, B, C and dt."""
    C = _conv_dim(cfg)
    if C % split.size:
        return t
    n = C // split.size
    return t[..., split.rank * n:(split.rank + 1) * n]


def _split_cache(xBC_raw: torch.Tensor, final_state: torch.Tensor,
                 cfg: ModelConfig, split: ModelSplit) -> MambaCache:
    """A split block's decode cache on the reference's layout: the state
    on this rank's heads, and this rank's channel block of the last W - 1
    raw conv inputs (zeros in front of a shorter sequence), whose x
    channels the other ranks' heads hold: the tail of this rank's x
    channels is all-gathered over ``model`` (B, W - 1, d_inner / T at a
    time), B's and C's are whole on every rank."""
    W, dl = cfg.conv_width, cfg.d_inner // split.size
    tail = xBC_raw[:, -(W - 1):, :]
    tail = torch.cat([gather_over_model(tail[..., :dl], split, -1),
                      tail[..., dl:]], dim=-1)
    pad = max(0, (W - 1) - xBC_raw.shape[1])
    if pad:
        tail = F.pad(tail, (0, 0, pad, 0))
    return MambaCache(conv=_conv_block(tail, cfg, split).to(cfg.cdtype),
                      ssm=final_state.to(torch.float32))


def _decode_on_heads(p, u: torch.Tensor, cache: MambaCache,
                     cfg: ModelConfig, split: ModelSplit
                     ) -> Tuple[torch.Tensor, MambaCache]:
    """:func:`mamba_block_decode` on this rank's ``H / T`` heads and its
    cache on the reference's layout, moving no weight: ``in_proj``'s
    product on its column block, the token's ``zxbcdt`` all-gathered over
    ``model`` and this rank's heads' columns taken (as :func:`_heads_of`
    takes them); the (B, W - 1, C) conv window all-gathered where its
    channels are split, the conv on this rank's x channels and on B and
    C, the window written back as this rank's channel block; the gated
    norm's mean of squares summed over ``model``; ``out_proj``
    row-parallel, then summed over ``model``."""
    di, N, H, P = cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads, cfg.ssm_head_dim
    T, r = split.size, split.rank
    dl, hl = di // T, H // T
    Bsz = u.shape[0]
    f32 = torch.float32
    w = {n: gather_at_use(p[n], keep_model=True) for n in p}
    h = L.rms_norm(u, w["ln"])
    zxbcdt = gather_over_model(h @ w["in_proj"].to(h.dtype),
                               model_split(p["in_proj"], -1), -1)[:, 0]
    z, xBC_raw, dt = _split_proj(cfg, zxbcdt)

    def own(t):  # this rank's x channels, then B's and C's
        return torch.cat([t[..., r * dl:(r + 1) * dl], t[..., di:]], -1)

    conv = cache.conv
    if conv.shape[-1] < _conv_dim(cfg):
        conv = gather_over_model(conv, split, -1)
    win = torch.cat([conv.to(f32), xBC_raw[:, None, :].to(f32)], dim=1)
    new_conv = _conv_block(win[:, 1:].to(cfg.cdtype), cfg, split)
    xBC = F.silu((own(win) * own(w["conv_w"].to(f32))[None]).sum(1)
                 + own(w["conv_b"].to(f32)))
    heads = slice(r * hl, (r + 1) * hl)
    x = xBC[:, :dl].reshape(Bsz, hl, P)
    Bm = xBC[:, dl:dl + N]
    Cm = xBC[:, dl + N:]
    dt_s = softplus(dt[:, heads].to(f32) + w["dt_bias"].to(f32)[heads])
    A = -torch.exp(w["A_log"].to(f32)[heads])
    dA = torch.exp(dt_s * A)                               # (B, H / T)
    state = cache.ssm * dA[:, :, None, None] + torch.einsum(
        "bn,bhp->bhpn", Bm, x * dt_s[..., None])
    y = torch.einsum("bn,bhpn->bhp", Cm, state)
    y = y + x * w["D"].to(f32)[heads][:, None]
    y = y.reshape(Bsz, 1, dl)
    zl = z[:, r * dl:(r + 1) * dl]
    y = _rms_norm_over_model(
        (y * F.silu(zl.to(f32))[:, None]).to(u.dtype),
        w["gn"][r * dl:(r + 1) * dl], split, di)
    out = sum_over_model(y @ w["out_proj"].to(u.dtype), split)
    return u + out, MambaCache(conv=new_conv, ssm=state)


def mamba_block_decode(p, u: torch.Tensor, cache: MambaCache,
                       cfg: ModelConfig) -> Tuple[torch.Tensor, MambaCache]:
    """Single-token recurrent step. u: (B, 1, d). On the serving steps'
    ``Placed`` leaves with a :func:`mamba_split`, on this rank's heads
    (:func:`_decode_on_heads`)."""
    split = mamba_split(p, cfg)
    if split is not None:
        return _decode_on_heads(p, u, cache, cfg, split)
    p = at_use(p)
    di, N, H, P = cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads, cfg.ssm_head_dim
    Bsz = u.shape[0]
    f32 = torch.float32
    h = L.rms_norm(u, p["ln"])
    zxbcdt = (h @ p["in_proj"].to(h.dtype))[:, 0]        # (B, ...)
    z, xBC_raw, dt = _split_proj(cfg, zxbcdt)
    # conv over [cache.conv ; xBC_raw], in f32
    win = torch.cat([cache.conv.to(f32), xBC_raw[:, None, :].to(f32)], dim=1)
    w = p["conv_w"].to(f32)
    xBC = F.silu((win * w[None]).sum(1) + p["conv_b"].to(f32))
    new_conv = win[:, 1:].to(cfg.cdtype)
    x = xBC[:, :di].reshape(Bsz, H, P)
    Bm = xBC[:, di:di + N]
    Cm = xBC[:, di + N:]
    dt_s = softplus(dt.to(f32) + p["dt_bias"].to(f32))
    A = -torch.exp(p["A_log"].to(f32))
    dA = torch.exp(dt_s * A)                               # (B, H)
    state = cache.ssm * dA[:, :, None, None] + torch.einsum(
        "bn,bhp->bhpn", Bm, x * dt_s[..., None])
    y = torch.einsum("bn,bhpn->bhp", Cm, state)
    y = y + x * p["D"].to(f32)[:, None]
    y = y.reshape(Bsz, 1, di)
    y = L.rms_norm((y * F.silu(z.to(f32))[:, None]).to(u.dtype), p["gn"])
    out = y @ p["out_proj"].to(u.dtype)
    return u + out, MambaCache(conv=new_conv, ssm=state)


def stack_mamba_caches(caches, lead: Tuple[int, ...]) -> MambaCache:
    """Per-layer caches stacked into one of leading shape ``lead``."""
    return MambaCache(*(torch.stack(x).reshape(lead + x[0].shape)
                        for x in zip(*caches)))


def zero_mamba_cache(cfg: ModelConfig, B: int, lead: Tuple[int, ...],
                     device) -> MambaCache:
    """An empty stack of caches of leading shape ``lead`` on ``device``."""
    return MambaCache(
        conv=torch.zeros(lead + (B, cfg.conv_width - 1, _conv_dim(cfg)),
                         dtype=cfg.cdtype, device=device),
        ssm=torch.zeros(lead + (B, cfg.n_ssm_heads, cfg.ssm_head_dim,
                                cfg.ssm_state),
                        dtype=torch.float32, device=device))


class MambaLM(TreeModel):
    """Pure-SSM LM (mamba2-370m). Params: ``embed``, ``head``,
    ``final_ln`` and ``layers`` (leaves stacked along a leading layer
    dimension, :func:`init_mamba_params`'s keys)."""

    _stacks = ("layers",)

    def _init_tree(self, gen: torch.Generator) -> dict:
        cfg = self.cfg
        return {
            "embed": dense_init(gen, (cfg.vocab, cfg.d_model), cfg.pdtype,
                                fan_in=cfg.d_model),
            "head": dense_init(gen, (cfg.d_model, cfg.vocab), cfg.pdtype),
            "final_ln": torch.zeros((cfg.d_model,), dtype=cfg.pdtype,
                                    device=gen.device),
            "layers": stacked(lambda g: init_mamba_params(g, cfg), gen,
                              cfg.n_layers),
        }

    def backbone(self, params, x, *, remat: bool = False,
                 collect_cache: bool = False):
        """All layers; returns (x, stacked :class:`MambaCache` or None)."""
        L.require_full_precision(x)
        cfg = self.cfg
        block = maybe_remat(
            lambda p_l, xc: mamba_block_full(
                p_l, xc, cfg, collect_cache=collect_cache), remat)
        caches = []
        for p_l in per_layer(params["layers"]):
            x, cache = block(p_l, x)
            if collect_cache:
                caches.append(cache)
        if not collect_cache:
            return x, None
        return x, stack_mamba_caches(caches, (len(caches),))

    def loss(self, params, batch, *, remat: bool = True, ce_chunk: int = 512,
             **_):
        tokens, labels = batch["tokens"], batch["labels"]
        x = embed_lookup(params["embed"], tokens, self.cfg.cdtype)
        x, _ = self.backbone(params, x, remat=remat)
        x = L.rms_norm(x, gather_at_use(params["final_ln"]))
        return chunked_ce(x, params["head"], labels, chunk=ce_chunk)

    @torch.no_grad()
    def prefill(self, params, tokens=None, embeds=None,
                max_len: Optional[int] = None, **_):
        """Full-sequence forward that also builds the decode caches;
        returns (last-position logits (B, vocab) f32, caches stacked
        (n_layers, ...)). ``max_len`` is ignored, as the reference
        ignores it: the state is O(1) in the sequence."""
        x = embed_lookup(params["embed"], tokens, self.cfg.cdtype)
        x, caches = self.backbone(params, x, collect_cache=True)
        return self.logits_last(params, x), caches

    def init_cache(self, B: int, max_len: Optional[int] = None,
                   device=None) -> MambaCache:
        return zero_mamba_cache(self.cfg, B, (self.cfg.n_layers,),
                                resolve_device(device))

    @torch.no_grad()
    def decode_step(self, params, caches: MambaCache, tokens, **_):
        """One token for every sequence. tokens: (B,) integers. Returns
        (logits (B, vocab) f32, new caches)."""
        cfg = self.cfg
        x = embed_lookup(params["embed"], tokens[:, None], cfg.cdtype)
        L.require_full_precision(x)
        new = []
        for i, p_l in enumerate(per_layer(params["layers"])):
            x, c = mamba_block_decode(
                p_l, x, MambaCache(caches.conv[i], caches.ssm[i]), cfg)
            new.append(c)
        return (self.logits_last(params, x),
                stack_mamba_caches(new, (cfg.n_layers,)))
