"""Zamba2-style hybrid: Mamba2 backbone + one SHARED attention block.

The port of ``src/repro/models/hybrid.py``. 54 mamba2 layers in 9 groups
of 6; after every group the *shared* transformer block (one parameter set,
9 invocation sites) runs. Parameter reuse means its gradient is the SUM of
the per-site gradients; autograd sums them in its own order, XLA's scan
transpose in another (a matter of f32 rounding).

The params tree is the reference's: ``mamba_layers`` leaves of shape
``(n_groups, attn_every, ...)``, each layer's view taken by unbinding the
leaf's first two dims (so backward returns the gradient in that shape),
and ``shared`` {``ln1``, ``wq``, ``wk``, ``wv``, ``wo``, ``ln2``, ``w1``,
``w3``, ``w2``}.

On the sharded train step's leaves (``sharding.api.Placed``) each Mamba
layer runs on its SSM heads (``models/ssm.py``) and the shared block on
its heads and ``d_ff`` columns at each site (``sharding.api.attn_split``,
``models.common.mlp``), its leaves gathered at every site and each site's
gradient reduced into the leaves' shards. The serving steps run the same
blocks on the TP-only layout, each site's cache on this rank's KV heads
and the Mamba caches on its SSM heads and conv channels.

Decode keeps one :class:`~repro_torch.models.ssm.MambaCache` per mamba
layer, stacked ``(n_groups, attn_every, ...)``, plus one KV cache per
shared-block site (``(n_groups, B, S_max, ...)``, ``length`` of shape
``(n_groups,)``: same parameters, one cache a site).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch import tree as _tree
from repro_torch.core.sparse import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.common import (ModelConfig, TreeModel, attn_decode,
                                       cache_kv, dense_init, embed_lookup,
                                       maybe_remat, mlp, per_layer, stacked)
from repro_torch.models.ssm import (MambaCache, init_mamba_params,
                                    mamba_block_decode, mamba_block_full,
                                    stack_mamba_caches, zero_mamba_cache)
from repro_torch.models.transformer import chunked_ce
from repro_torch.sharding.api import (Placed, attn_split, attn_weights,
                                      copy_to_model, gather_at_use,
                                      sum_over_model)


class HybridCaches(NamedTuple):
    mamba: MambaCache       # stacked (n_groups, group_size, ...)
    attn: L.KVCache         # stacked (n_sites, ...)
    length: torch.Tensor    # int32, 0-d


class HybridLM(TreeModel):
    _stacks = ("mamba_layers", "shared")

    def __init__(self, cfg: ModelConfig):
        if cfg.attn_every <= 0:
            raise ValueError("hybrid attn_every must be positive")
        if cfg.n_layers % cfg.attn_every != 0:
            raise ValueError(
                "hybrid n_layers must be a multiple of attn_every")
        super().__init__(cfg)
        self.n_groups = cfg.n_layers // cfg.attn_every

    # ------------------------------------------------------------------
    def _init_shared(self, gen: torch.Generator) -> dict:
        cfg = self.cfg
        d, pdt = cfg.d_model, cfg.pdtype
        return {
            "ln1": torch.zeros((d,), dtype=pdt, device=gen.device),
            "wq": dense_init(gen, (d, cfg.q_dim), pdt),
            "wk": dense_init(gen, (d, cfg.kv_dim), pdt),
            "wv": dense_init(gen, (d, cfg.kv_dim), pdt),
            "wo": dense_init(gen, (cfg.q_dim, d), pdt),
            "ln2": torch.zeros((d,), dtype=pdt, device=gen.device),
            "w1": dense_init(gen, (d, cfg.d_ff), pdt),
            "w3": dense_init(gen, (d, cfg.d_ff), pdt),
            "w2": dense_init(gen, (cfg.d_ff, d), pdt),
        }

    def _init_tree(self, gen: torch.Generator) -> dict:
        cfg = self.cfg
        G, ae = self.n_groups, cfg.attn_every
        return {
            "embed": dense_init(gen, (cfg.vocab, cfg.d_model), cfg.pdtype,
                                fan_in=cfg.d_model),
            "head": dense_init(gen, (cfg.d_model, cfg.vocab), cfg.pdtype),
            "final_ln": torch.zeros((cfg.d_model,), dtype=cfg.pdtype,
                                    device=gen.device),
            "mamba_layers": _tree.tree_map(
                lambda x: x.reshape(G, ae, *x.shape[1:]),
                stacked(lambda g: init_mamba_params(g, cfg), gen,
                        cfg.n_layers)),
            "shared": self._init_shared(gen),
        }

    # ------------------------------------------------------------------
    def _qkv(self, wq, wk, wv, h, positions):
        """q, k, v of ``h`` on the heads the weights' columns hold."""
        cfg = self.cfg
        B, S, _ = h.shape
        q = (h @ wq.to(h.dtype)).reshape(B, S, -1, cfg.head_dim)
        k = (h @ wk.to(h.dtype)).reshape(B, S, -1, cfg.head_dim)
        v = (h @ wv.to(h.dtype)).reshape(B, S, -1, cfg.head_dim)
        q = L.apply_rope(q, positions, cfg.rope_theta)
        k = L.apply_rope(k, positions, cfg.rope_theta)
        return q, k, v

    @staticmethod
    def _ffn(p, x):
        h2 = L.rms_norm(x, gather_at_use(p["ln2"]))
        return x + mlp(p, h2, "silu")

    def _shared_full(self, p, x, positions, chunk: int):
        """The shared block at one site, on this rank's heads and ``d_ff``
        columns where the spec splits them over ``model``
        (``sharding.api.attn_split``), its leaves gathered at the site."""
        cfg = self.cfg
        split, kv = attn_split(p, cfg.n_heads, cfg.n_kv_heads)
        h = copy_to_model(L.rms_norm(x, gather_at_use(p["ln1"])), split)
        B, S, _ = h.shape
        wq, wk, wv, wo = attn_weights(p, split, kv, cfg.head_dim)
        q, k, v = self._qkv(wq, wk, wv, h, positions)
        o = L.blockwise_attention(q, k, v, causal=True, chunk=chunk)
        x = x + sum_over_model(o.reshape(B, S, -1) @ wo.to(x.dtype), split)
        return self._ffn(p, x), (k, v)

    def _shared_decode(self, p, x, cache: L.KVCache, length, chunk: int):
        """The shared block's one token at a site; on the serving steps'
        ``Placed`` leaves on its heads and ``d_ff`` columns over the
        site's cache of this rank's KV heads, moving no weight
        (``models.common.attn_decode``)."""
        B = x.shape[0]
        pos = length.reshape(1, 1).expand(B, 1).to(torch.int32)
        if isinstance(p["wq"], Placed):
            cfg = self.cfg
            h = L.rms_norm(x, gather_at_use(p["ln1"]))
            kv_len = torch.clamp(length + 1, max=cache.k.shape[1])
            o, new_cache = attn_decode(
                p, h, cache, length, kv_len, cfg,
                lambda q, k: (L.apply_rope(q, pos, cfg.rope_theta),
                              L.apply_rope(k, pos, cfg.rope_theta)), chunk)
            return self._ffn(p, x + o), new_cache
        h = L.rms_norm(x, p["ln1"])
        q, k, v = self._qkv(p["wq"], p["wk"], p["wv"], h, pos)
        new_cache = L.cache_update_decode(cache._replace(length=length), k, v)
        kv_len = torch.clamp(length + 1, max=cache.k.shape[1])
        o = L.blockwise_attention(q, new_cache.k, new_cache.v, causal=False,
                                  kv_len=kv_len, chunk=chunk)
        x = x + o.reshape(B, 1, -1) @ p["wo"].to(x.dtype)
        return self._ffn(p, x), new_cache

    # ------------------------------------------------------------------
    def backbone(self, params, x, positions, *, remat: bool = False,
                 collect_cache: bool = False, chunk: int = 1024):
        """All groups; returns (x, (mamba caches stacked (G, ae, ...), [(k,
        v)] a site) or None)."""
        L.require_full_precision(x)
        cfg = self.cfg
        G, ae = self.n_groups, cfg.attn_every
        shared = params["shared"]
        block = maybe_remat(
            lambda p_l, xc: mamba_block_full(
                p_l, xc, cfg, collect_cache=collect_cache), remat)
        site = maybe_remat(lambda p, xc: self._shared_full(
            p, xc, positions, chunk), remat)
        layers = per_layer(params["mamba_layers"], lead=2)
        mcaches, kvs = [], []
        for g in range(G):
            for p_l in layers[g * ae:(g + 1) * ae]:
                x, cache = block(p_l, x)
                if collect_cache:
                    mcaches.append(cache)
            x, kv = site(shared, x)
            if collect_cache:
                kvs.append(cache_kv(shared, kv, cfg))
        if not collect_cache:
            return x, None
        return x, (stack_mamba_caches(mcaches, (G, ae)), kvs)

    def loss(self, params, batch, *, remat: bool = True, ce_chunk: int = 512,
             attn_chunk: int = 1024, **_):
        tokens, labels = batch["tokens"], batch["labels"]
        B, S = labels.shape
        positions = torch.arange(S, dtype=torch.int32,
                                 device=labels.device).expand(B, S)
        x = embed_lookup(params["embed"], tokens, self.cfg.cdtype)
        x, _ = self.backbone(params, x, positions, remat=remat,
                             chunk=attn_chunk)
        x = L.rms_norm(x, gather_at_use(params["final_ln"]))
        return chunked_ce(x, params["head"], labels, chunk=ce_chunk)

    # ------------------------------------------------------------------
    @torch.no_grad()
    def prefill(self, params, tokens=None, embeds=None,
                max_len: Optional[int] = None, attn_chunk: int = 1024, **_):
        """Full-sequence forward that also builds the decode caches;
        returns (last-position logits (B, vocab) f32, caches). Raises
        ``ValueError`` when ``max_len`` is under the prompt's length, as
        the reference does (its KV caches cannot pad by a negative
        amount)."""
        B, S = tokens.shape
        max_len = max_len or S
        if max_len < S:
            raise ValueError(f"max_len {max_len} is under the prompt's "
                             f"length {S}")
        dev = tokens.device
        positions = torch.arange(S, dtype=torch.int32, device=dev).expand(
            B, S)
        x = embed_lookup(params["embed"], tokens, self.cfg.cdtype)
        x, (mcaches, kvs) = self.backbone(params, x, positions,
                                          collect_cache=True,
                                          chunk=attn_chunk)
        pad = (0, 0, 0, 0, 0, max_len - S)
        attn = L.KVCache(
            torch.stack([F.pad(k, pad) for k, _ in kvs]),
            torch.stack([F.pad(v, pad) for _, v in kvs]),
            torch.full((self.n_groups,), S, dtype=torch.int32, device=dev))
        caches = HybridCaches(mamba=mcaches, attn=attn, length=torch.tensor(
            S, dtype=torch.int32, device=dev))
        return self.logits_last(params, x), caches

    def init_cache(self, B: int, max_len: int, device=None) -> HybridCaches:
        cfg = self.cfg
        dev = resolve_device(device)
        G = self.n_groups
        shape = (G, B, max_len, cfg.n_kv_heads, cfg.head_dim)
        zeros = torch.zeros(shape, dtype=cfg.cdtype, device=dev)
        kv = L.KVCache(zeros, zeros.clone(),
                       torch.zeros((G,), dtype=torch.int32, device=dev))
        return HybridCaches(
            mamba=zero_mamba_cache(cfg, B, (G, cfg.attn_every), dev),
            attn=kv, length=torch.zeros((), dtype=torch.int32, device=dev))

    @torch.no_grad()
    def decode_step(self, params, caches: HybridCaches, tokens, *,
                    attn_chunk: int = 4096, **_):
        """One token for every sequence. tokens: (B,) integers. Returns
        (logits (B, vocab) f32, new caches)."""
        cfg = self.cfg
        G, ae = self.n_groups, cfg.attn_every
        length = caches.length
        x = embed_lookup(params["embed"], tokens[:, None], cfg.cdtype)
        L.require_full_precision(x)
        layers = per_layer(params["mamba_layers"], lead=2)
        mc, ac = caches.mamba, caches.attn
        new_m, new_a = [], []
        for g in range(G):
            for i in range(ae):
                x, c = mamba_block_decode(
                    layers[g * ae + i], x,
                    MambaCache(mc.conv[g, i], mc.ssm[g, i]), cfg)
                new_m.append(c)
            x, c = self._shared_decode(
                params["shared"], x,
                L.KVCache(ac.k[g], ac.v[g], ac.length[g]), length,
                attn_chunk)
            new_a.append(c)
        attn = L.KVCache(*(torch.stack(t) for t in zip(*new_a)))
        return self.logits_last(params, x), HybridCaches(
            mamba=stack_mamba_caches(new_m, (G, ae)), attn=attn,
            length=length + 1)
