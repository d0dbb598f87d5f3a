"""Whisper-style encoder-decoder backbone (conv frontend stubbed).

The port of ``src/repro/models/encdec.py``. The audio frontend is a stub:
``data.input_specs()`` / ``make_batch`` provide precomputed frame
embeddings (B, n_frames, d). The encoder is bidirectional self-attention +
GELU (tanh) FFN with sinusoidal positions; the decoder is causal
self-attention + cross-attention + GELU FFN, with sinusoidal positions too
(the reference's divergence from Whisper's learned table).

The params tree is the reference's: ``enc_layers`` {``ln1``, ``attn``
{``wq``, ``wk``, ``wv``, ``wo``}, ``ln2``, ``w1``, ``w2``} and
``dec_layers`` {``ln1``, ``self`` {...}, ``lnx``, ``cross`` {...},
``ln2``, ``w1``, ``w2``}, leaves stacked along a leading layer dimension,
plus ``embed``, ``head``, ``enc_ln`` and ``final_ln``.

On the sharded train step's leaves (``sharding.api.Placed``) every
self- and cross-attention runs on this rank's heads and every MLP on its
``d_ff`` columns (``sharding.api.attn_split``, ``models.common.mlp``);
the encoder's output is copied to ``model`` at each cross-attention.
The serving steps run the same on the TP-only layout: the self- and
cross-attention caches hold this rank's KV heads, and decode moves no
weight (``models.common.attn_decode``).

Decode takes its position from the cache length on the device (no host
sync) and cross-attends the static cache of all ``n_frames`` frames.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.core.sparse import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.common import (TreeModel, attn_decode, cache_kv,
                                       dense_init, embed_lookup, maybe_remat,
                                       mlp, per_layer, stacked)
from repro_torch.models.transformer import chunked_ce
from repro_torch.sharding.api import (Placed, attn_split, attn_weights,
                                      copy_to_model, gather_at_use,
                                      sum_over_model)


class EncDecCaches(NamedTuple):
    self_kv: L.KVCache     # (L_dec, B, S_max, kv, hd)
    cross_kv: L.KVCache    # (L_dec, B, F, kv, hd) — static after prefill
    length: torch.Tensor   # int32, 0-d


def sinusoidal_positions(S: int, d: int, offset=0,
                         device=None) -> torch.Tensor:
    """(S, d) f32: sines then cosines of ``(offset + position) * 10000 **
    (-i / d)``, i = 0, 2, ...; ``offset`` an int or a 0-d tensor (decode's
    cache length, kept on its device)."""
    if isinstance(offset, torch.Tensor):
        device = offset.device
    pos = torch.arange(S, dtype=torch.float32, device=device) + offset
    inv = torch.exp(-torch.arange(0, d, 2, dtype=torch.float32,
                                  device=device) / d
                    * torch.tensor(math.log(10000.0), dtype=torch.float32,
                                   device=device))
    ang = pos[:, None] * inv[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


class EncDecLM(TreeModel):
    _TOP = ("embed", "enc_ln", "final_ln", "head")
    _stacks = ("enc_layers", "dec_layers")

    # ------------------------------------------------------------------
    def _init_attn(self, gen: torch.Generator) -> dict:
        cfg = self.cfg
        d, pdt = cfg.d_model, cfg.pdtype
        return {
            "wq": dense_init(gen, (d, cfg.q_dim), pdt),
            "wk": dense_init(gen, (d, cfg.kv_dim), pdt),
            "wv": dense_init(gen, (d, cfg.kv_dim), pdt),
            "wo": dense_init(gen, (cfg.q_dim, d), pdt),
        }

    def _zeros(self, gen):
        return torch.zeros((self.cfg.d_model,), dtype=self.cfg.pdtype,
                           device=gen.device)

    def _init_enc_layer(self, gen: torch.Generator) -> dict:
        cfg = self.cfg
        d, pdt = cfg.d_model, cfg.pdtype
        return {
            "ln1": self._zeros(gen),
            "attn": self._init_attn(gen),
            "ln2": self._zeros(gen),
            "w1": dense_init(gen, (d, cfg.d_ff), pdt),
            "w2": dense_init(gen, (cfg.d_ff, d), pdt),
        }

    def _init_dec_layer(self, gen: torch.Generator) -> dict:
        cfg = self.cfg
        d, pdt = cfg.d_model, cfg.pdtype
        return {
            "ln1": self._zeros(gen),
            "self": self._init_attn(gen),
            "lnx": self._zeros(gen),
            "cross": self._init_attn(gen),
            "ln2": self._zeros(gen),
            "w1": dense_init(gen, (d, cfg.d_ff), pdt),
            "w2": dense_init(gen, (cfg.d_ff, d), pdt),
        }

    def _init_tree(self, gen: torch.Generator) -> dict:
        cfg = self.cfg
        return {
            "embed": dense_init(gen, (cfg.vocab, cfg.d_model), cfg.pdtype,
                                fan_in=cfg.d_model),
            "head": dense_init(gen, (cfg.d_model, cfg.vocab), cfg.pdtype),
            "enc_layers": stacked(self._init_enc_layer, gen,
                                  cfg.n_enc_layers),
            "dec_layers": stacked(self._init_dec_layer, gen, cfg.n_layers),
            "enc_ln": self._zeros(gen),
            "final_ln": self._zeros(gen),
        }

    # ------------------------------------------------------------------
    def _heads(self, x, w):
        B, S, _ = x.shape
        return (x @ w.to(x.dtype)).reshape(B, S, -1, self.cfg.head_dim)

    def _mha(self, p, xq, xkv, *, causal: bool, chunk: int):
        """Attention of ``xq`` over ``xkv`` (self-attention when they are
        one tensor); returns (out, (k, v)). On this rank's heads where the
        spec splits them over ``model`` (``sharding.api.attn_split``):
        ``xq`` and a cross-attention's ``xkv`` (the encoder's output, the
        same on every ``model`` rank) are each copied to ``model``, so
        that their gradients hold every rank's heads."""
        cfg = self.cfg
        split, kv = attn_split(p, cfg.n_heads, cfg.n_kv_heads)
        self_attn = xkv is xq
        xq = copy_to_model(xq, split)
        xkv = xq if self_attn else copy_to_model(xkv, split)
        wq, wk, wv, wo = attn_weights(p, split, kv, cfg.head_dim)
        B, Sq, _ = xq.shape
        q = self._heads(xq, wq)
        k = self._heads(xkv, wk.to(xq.dtype))
        v = self._heads(xkv, wv.to(xq.dtype))
        o = L.blockwise_attention(q, k, v, causal=causal, chunk=chunk)
        return sum_over_model(o.reshape(B, Sq, -1) @ wo.to(xq.dtype),
                              split), (k, v)

    def _mlp(self, p_l, x):
        h = L.rms_norm(x, gather_at_use(p_l["ln2"]))
        return x + mlp(p_l, h, "gelu")

    def _enc_layer(self, p_l, x, chunk: int):
        h = L.rms_norm(x, gather_at_use(p_l["ln1"]))
        o, _ = self._mha(p_l["attn"], h, h, causal=False, chunk=chunk)
        return self._mlp(p_l, x + o)

    def encode(self, params, frames: torch.Tensor, *, remat: bool = False,
               chunk: int = 1024) -> torch.Tensor:
        """frames: (B, F, d) stubbed embeddings -> encoder states."""
        L.require_full_precision(frames)
        cfg = self.cfg
        B, Fr, d = frames.shape
        x = (frames.to(cfg.cdtype)
             + sinusoidal_positions(Fr, d, device=frames.device).to(
                 cfg.cdtype))
        layer = maybe_remat(
            lambda p_l, xc: self._enc_layer(p_l, xc, chunk), remat)
        for p_l in per_layer(params["enc_layers"]):
            x = layer(p_l, x)
        return L.rms_norm(x, gather_at_use(params["enc_ln"]))

    def _dec_layer_full(self, p_l, x, enc, chunk: int):
        h = L.rms_norm(x, gather_at_use(p_l["ln1"]))
        o, self_kv = self._mha(p_l["self"], h, h, causal=True, chunk=chunk)
        x = x + o
        h = L.rms_norm(x, gather_at_use(p_l["lnx"]))
        o, cross_kv = self._mha(p_l["cross"], h, enc, causal=False,
                                chunk=chunk)
        return self._mlp(p_l, x + o), self_kv, cross_kv

    def decode_full(self, params, tokens, enc, *, remat: bool = False,
                    chunk: int = 1024, collect_kv: bool = False):
        """The decoder over the whole sequence; returns (x, [((self k, v),
        (cross k, v))] a layer, or None)."""
        cfg = self.cfg
        B, S = tokens.shape
        x = embed_lookup(params["embed"], tokens, cfg.cdtype)
        x = x + sinusoidal_positions(S, cfg.d_model,
                                     device=x.device).to(x.dtype)
        layer = maybe_remat(
            lambda p_l, xc, e: self._dec_layer_full(p_l, xc, e, chunk),
            remat)
        kv = []
        for p_l in per_layer(params["dec_layers"]):
            x, self_kv, cross_kv = layer(p_l, x, enc)
            if collect_kv:
                kv.append((cache_kv(p_l["self"], self_kv, cfg),
                           cache_kv(p_l["cross"], cross_kv, cfg)))
        return x, (kv if collect_kv else None)

    def loss(self, params, batch, *, remat: bool = True, ce_chunk: int = 512,
             attn_chunk: int = 1024, **_):
        enc = self.encode(params, batch["embeds"], remat=remat,
                          chunk=attn_chunk)
        x, _ = self.decode_full(params, batch["tokens"], enc, remat=remat,
                                chunk=attn_chunk)
        x = L.rms_norm(x, gather_at_use(params["final_ln"]))
        return chunked_ce(x, params["head"], batch["labels"], chunk=ce_chunk)

    # ------------------------------------------------------------------
    @torch.no_grad()
    def prefill(self, params, tokens=None, embeds=None,
                max_len: Optional[int] = None, attn_chunk: int = 1024, **_):
        """Encode ``embeds`` (B, F, d), run the decoder over ``tokens``
        and build the caches; returns (last-position logits (B, vocab) f32,
        caches). Raises ``ValueError`` when ``max_len`` is under the
        prompt's length, as the reference does."""
        cfg = self.cfg
        B, S = tokens.shape
        max_len = max_len or S
        if max_len < S:
            raise ValueError(f"max_len {max_len} is under the prompt's "
                             f"length {S}")
        dev = tokens.device
        enc = self.encode(params, embeds, chunk=attn_chunk)
        x, kv = self.decode_full(params, tokens, enc, chunk=attn_chunk,
                                 collect_kv=True)
        pad = (0, 0, 0, 0, 0, max_len - S)
        Ld = cfg.n_layers

        def lens(n):
            return torch.full((Ld,), n, dtype=torch.int32, device=dev)

        caches = EncDecCaches(
            self_kv=L.KVCache(torch.stack([F.pad(s[0], pad) for s, _ in kv]),
                              torch.stack([F.pad(s[1], pad) for s, _ in kv]),
                              lens(S)),
            cross_kv=L.KVCache(torch.stack([c[0] for _, c in kv]),
                               torch.stack([c[1] for _, c in kv]),
                               lens(enc.shape[1])),
            length=torch.tensor(S, dtype=torch.int32, device=dev))
        return self.logits_last(params, x), caches

    def _dec_layer_decode_placed(self, p_l, x, self_cache: L.KVCache,
                                 cross_cache: L.KVCache, length, kv_len, Fr,
                                 chunk: int):
        """A decoder layer's one token on the serving steps' ``Placed``
        leaves: the self-attention over its cache and the
        cross-attention over the static cache, each on the caches'
        ``model`` layout (``models.common.attn_decode``), then the MLP on
        its ``d_ff`` columns; no weight moves. Returns (x, the new self
        cache)."""
        cfg = self.cfg
        h = L.rms_norm(x, gather_at_use(p_l["ln1"]))
        o, new_s = attn_decode(p_l["self"], h, self_cache, length, kv_len,
                               cfg, None, chunk)
        x = x + o
        h = L.rms_norm(x, gather_at_use(p_l["lnx"]))
        o, _ = attn_decode(p_l["cross"], h, cross_cache, None, Fr, cfg, None,
                           chunk, write=False)
        return self._mlp(p_l, x + o), new_s

    def init_cache(self, B: int, max_len: int, device=None) -> EncDecCaches:
        cfg = self.cfg
        dev = resolve_device(device)
        Ld = cfg.n_layers

        def kv(s):
            zeros = torch.zeros((Ld, B, s, cfg.n_kv_heads, cfg.head_dim),
                                dtype=cfg.cdtype, device=dev)
            return L.KVCache(zeros, zeros.clone(), torch.zeros(
                (Ld,), dtype=torch.int32, device=dev))

        return EncDecCaches(self_kv=kv(max_len), cross_kv=kv(cfg.n_frames),
                            length=torch.zeros((), dtype=torch.int32,
                                               device=dev))

    @torch.no_grad()
    def decode_step(self, params, caches: EncDecCaches, tokens, *,
                    attn_chunk: int = 4096, **_):
        """One token for every sequence. tokens: (B,) integers. Returns
        (logits (B, vocab) f32, new caches)."""
        cfg = self.cfg
        B = tokens.shape[0]
        length = caches.length
        x = embed_lookup(params["embed"], tokens[:, None], cfg.cdtype)
        L.require_full_precision(x)
        x = x + sinusoidal_positions(1, cfg.d_model,
                                     offset=length).to(x.dtype)
        sc, xc_ = caches.self_kv, caches.cross_kv
        S_max, Fr = sc.k.shape[2], xc_.k.shape[2]
        kv_len = torch.clamp(length + 1, max=S_max)
        new = []
        for i, p_l in enumerate(per_layer(params["dec_layers"])):
            if isinstance(p_l["ln1"], Placed):
                x, new_s = self._dec_layer_decode_placed(
                    p_l, x, L.KVCache(sc.k[i], sc.v[i], length),
                    L.KVCache(xc_.k[i], xc_.v[i], xc_.length[i]), length,
                    kv_len, Fr, attn_chunk)
                new.append(new_s)
                continue
            h = L.rms_norm(x, p_l["ln1"])
            q = self._heads(h, p_l["self"]["wq"])
            k = self._heads(h, p_l["self"]["wk"])
            v = self._heads(h, p_l["self"]["wv"])
            new_s = L.cache_update_decode(
                L.KVCache(sc.k[i], sc.v[i], length), k, v)
            o = L.blockwise_attention(q, new_s.k, new_s.v, causal=False,
                                      kv_len=kv_len, chunk=attn_chunk)
            x = x + o.reshape(B, 1, -1) @ p_l["self"]["wo"].to(x.dtype)
            # cross-attention against the static cache
            h = L.rms_norm(x, p_l["lnx"])
            q = self._heads(h, p_l["cross"]["wq"])
            o = L.blockwise_attention(q, xc_.k[i], xc_.v[i], causal=False,
                                      kv_len=Fr, chunk=attn_chunk)
            x = x + o.reshape(B, 1, -1) @ p_l["cross"]["wo"].to(x.dtype)
            x = self._mlp(p_l, x)
            new.append(new_s)
        self_kv = L.KVCache(*(torch.stack(t) for t in zip(*new)))
        return self.logits_last(params, x), EncDecCaches(
            self_kv=self_kv, cross_kv=xc_, length=length + 1)
