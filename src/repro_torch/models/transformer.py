"""Decoder-only transformer LM: dense / MoE / gemma3-pattern / VLM backbone.

The port of ``src/repro/models/transformer.py``. One class covers four
families:

- dense GQA (SmolLM, InternLM2, StableLM);
- the MoE FFN (Moonshot 64 experts top-6, Llama4-Scout 16 experts top-1)
  through ``models/moe.py``, whose load-balance term enters the loss as
  ``0.01 * aux``;
- gemma3's 5:1 local:global pattern: groups of ``local_per_global`` local
  layers at ``sliding_window`` and one global layer, then any extra local
  layers; local layers keep ring KV caches of the window's size;
- the Qwen2-VL backbone: patch embeddings in (``embeds``), M-RoPE on the
  three position streams where ``mrope_positions`` is given, text decode
  out.

The parameters are the reference's tree, leaf for leaf: ``embed`` (vocab,
d), ``head`` (d, vocab), ``final_ln`` (d,), and either ``layers`` (leaves
stacked along a leading layer dimension: ``wq`` (L, d, q_dim), ``wk``,
``wv``, ``wo``, ``ln1``, ``ln2`` and ``w1``/``w3``/``w2`` or ``moe``
{``router``, ``we1``, ``we3``, ``we2``}) or, for the grouped pattern,
``groups`` {``local`` (G, lpg, ...), ``global`` (G, ...)} and
``extra_local`` (n_extra, ...). Each weight is applied as ``x @ W``. Every
method takes that tree explicitly, as the reference's do, so the
optimizer, the gradient allreduce, delta sync and checkpoints (all of
which work on trees) see the same leaves in both packages. The module can
also hold a tree as its own parameters (:meth:`TransformerLM.load_params`);
``forward`` is the loss on them.

Training runs the layers one after another, each recomputed in backward
when ``remat`` (``torch.utils.checkpoint``, the reference's
``jax.checkpoint`` of its scanned body); sorts a recomputation repeats are
not counted (``core.sparse.uncounted_sorts``). Cross-entropy is computed in
sequence chunks so the (B, S, V) logits tensor never materializes.

On the sharded train step's leaves (``sharding.api.Placed``) each layer
gathers its weights where it uses them, inside the body a checkpoint
recomputes, and the blocks split over the mesh's ``model`` dim as the
reference's specs and GSPMD hints split them: attention on this rank's
heads (``wq``/``wk``/``wv`` column-parallel, ``wo`` row-parallel, then a
sum over ``model``), the MLP column-parallel on ``w1``/``w3`` and
row-parallel on ``w2``, the embedding a masked lookup of this rank's
vocabulary rows and the loss on its ``head`` columns. Where the split
does not fall on a head boundary the attention runs on its weights
gathered over ``model`` too; where there are fewer KV heads than ranks
(``T % n_kv_heads == 0``) each rank takes KV head ``r // (T /
n_kv_heads)`` of ``wk``/``wv`` gathered whole (Megatron's rule;
``sharding.api.attn_split``, which the hybrid's shared block and the
encoder-decoder's attention take too). The MoE
layer takes its router gathered whole and its experts on their ``model``
shards, over this rank's block of the dispatch buffer's capacity
(``models/moe.py``).

The serving steps hand the same ``Placed`` leaves on the TP-only serving
layout: prefill runs as above and turns each layer's keys and values into
the reference's cache layout (``models.common.cache_kv``: this rank's KV
heads, or its slice of ``head_dim`` of every KV head where the KV heads do
not divide the ranks); decode moves no weight
(``models.common.attn_decode``), and the logits come from the head's
vocabulary shard, all-gathered.

Under ``cfg.use_sp`` (sequence parallelism, the reference's ``seq_sp``)
the train step and prefill run each layer on this rank's block of S /
model positions where the leaves' mesh has more than one ``model`` rank:
the embedding's partial lookups reduce-scattered along the sequence (or
the patch embeddings sliced), the attention's and MLP's weights gathered
whole, q on every head at the block's global positions against k and v
all-gathered along the sequence, the MoE on the whole sequence
all-gathered (each rank then takes its block of the output), and the
final norm's output all-gathered for the loss on the vocabulary's shards,
which every ``model`` rank computes alike. Decode keeps the step above:
one token's row does not split. ``cfg.use_sp`` alone also turns the
banded local path off, as the reference's does, on every path.
"""
from __future__ import annotations

import contextlib
from typing import NamedTuple, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import compat
from repro_torch.core.sparse import resolve_device, uncounted_sorts
from repro_torch.models import layers as L
from repro_torch.models.common import (ModelConfig, TreeModel, attn_decode,
                                       cache_kv, dense_init, embed_lookup,
                                       mlp, per_layer, stacked)
from repro_torch.models.moe import init_moe_params, moe_ffn
from repro_torch.sharding.api import (ModelSplit, Placed, attn_split,
                                      attn_weights, copy_to_model,
                                      gather_at_use, gather_seq,
                                      gather_seq_equal, max_over_model,
                                      model_split, seq_block, seq_split,
                                      slice_seq, sum_over_model)

#: Families this module builds; ``models.build_model`` sends the others
#: to their own classes.
FAMILIES = ("dense", "moe", "vlm")


class DecodeCaches(NamedTuple):
    """The KV caches of every layer, in the compute dtype. All-global
    models: ``layers`` one :class:`~repro_torch.models.layers.KVCache` of
    stacks ``k``/``v`` (L, B, S_max, Hkv, D), ``length`` (L,). The grouped
    pattern: ``layers`` = ``{"groups": (local, global), "extra": extra or
    None}``, the local rings (G, lpg, B, w, Hkv, D), the global caches (G,
    B, S_max, Hkv, D), the extra local rings (n_extra, B, w, Hkv, D), each
    ``length`` of the leading shape. ``length`` is the tokens already in
    cache (int32, 0-d)."""
    layers: object
    length: torch.Tensor


def check_family(cfg: ModelConfig) -> None:
    """Raise ``ValueError`` for a family this class does not build (the
    SSM, hybrid and encoder-decoder families have their own classes, which
    ``models.build_model`` picks)."""
    if cfg.family not in FAMILIES:
        raise ValueError(
            f"{cfg.arch_id}: TransformerLM builds the {', '.join(FAMILIES)} "
            f"families, not {cfg.family!r}; use models.build_model")


def _stack_cache(caches) -> L.KVCache:
    """Per-layer caches stacked along a new leading dim."""
    return L.KVCache(*(torch.stack(x) for x in zip(*caches)))


class TransformerLM(TreeModel):
    def __init__(self, cfg: ModelConfig):
        super().__init__(cfg)
        check_family(cfg)
        # gemma3-style grouping
        if cfg.local_per_global > 0:
            period = cfg.local_per_global + 1
            self.n_groups = cfg.n_layers // period
            self.n_extra_local = cfg.n_layers - self.n_groups * period
        else:
            self.n_groups = 0
            self.n_extra_local = 0

    @property
    def _stacks(self):
        """The top-level keys of the params tree that hold layers."""
        if self.n_groups == 0:
            return ("layers",)
        return ("groups",) + (("extra_local",) if self.n_extra_local
                              else ())

    # ------------------------------------------------------------------
    # params
    # ------------------------------------------------------------------
    def _init_layer(self, gen: torch.Generator) -> dict:
        cfg = self.cfg
        d, pdt = cfg.d_model, cfg.pdtype
        p = {
            "ln1": torch.zeros((d,), dtype=pdt, device=gen.device),
            "wq": dense_init(gen, (d, cfg.q_dim), pdt),
            "wk": dense_init(gen, (d, cfg.kv_dim), pdt),
            "wv": dense_init(gen, (d, cfg.kv_dim), pdt),
            "wo": dense_init(gen, (cfg.q_dim, d), pdt),
            "ln2": torch.zeros((d,), dtype=pdt, device=gen.device),
        }
        if cfg.family == "moe":
            p["moe"] = init_moe_params(gen, cfg)
            return p
        p["w1"] = dense_init(gen, (d, cfg.d_ff), pdt)
        if cfg.act == "silu":
            p["w3"] = dense_init(gen, (d, cfg.d_ff), pdt)
        p["w2"] = dense_init(gen, (cfg.d_ff, d), pdt)
        return p

    def _init_tree(self, gen: torch.Generator) -> dict:
        cfg = self.cfg
        params = {
            "embed": dense_init(gen, (cfg.vocab, cfg.d_model), cfg.pdtype,
                                fan_in=cfg.d_model),
            "head": dense_init(gen, (cfg.d_model, cfg.vocab), cfg.pdtype),
            "final_ln": torch.zeros((cfg.d_model,), dtype=cfg.pdtype,
                                    device=gen.device),
        }
        if self.n_groups > 0:
            lpg = cfg.local_per_global

            def init_group(g):
                return {"local": stacked(self._init_layer, g, lpg),
                        "global": self._init_layer(g)}

            params["groups"] = stacked(init_group, gen, self.n_groups)
            if self.n_extra_local:
                params["extra_local"] = stacked(self._init_layer, gen,
                                                self.n_extra_local)
        else:
            params["layers"] = stacked(self._init_layer, gen, cfg.n_layers)
        return params

    # ------------------------------------------------------------------
    # blocks
    # ------------------------------------------------------------------
    def _project_qkv(self, wq, wk, wv, h, positions, mrope_positions):
        """q, k, v of ``h`` on the heads the weights' columns hold."""
        cfg = self.cfg
        B, S, _ = h.shape
        q = (h @ wq.to(h.dtype)).reshape(B, S, -1, cfg.head_dim)
        k = (h @ wk.to(h.dtype)).reshape(B, S, -1, cfg.head_dim)
        v = (h @ wv.to(h.dtype)).reshape(B, S, -1, cfg.head_dim)
        if cfg.mrope_sections != (0, 0, 0) and mrope_positions is not None:
            q = L.apply_mrope(q, mrope_positions, cfg.mrope_sections,
                              cfg.rope_theta)
            k = L.apply_mrope(k, mrope_positions, cfg.mrope_sections,
                              cfg.rope_theta)
        else:
            q = L.apply_rope(q, positions, cfg.rope_theta)
            k = L.apply_rope(k, positions, cfg.rope_theta)
        return q, k, v

    def _attn_full(self, p, x, positions, window, mrope_positions, chunk,
                   sp: Optional[ModelSplit] = None):
        """Full-sequence attention (train / prefill); returns (x, (k, v)).
        With ``sp`` (sequence parallelism, the reference's ``seq_sp``)
        ``x`` is this rank's block of positions: ``ln1`` and the
        projections run on its rows with the weights gathered whole (each
        gradient the rank's part, summed over ``model``), q on every head
        at the block's global positions, k and v all-gathered along the
        sequence (their gradients summed back into each rank's block), the
        causal attention from the block's offset, and ``wo`` with nothing
        summed; the (k, v) returned are the whole sequence's. Under
        ``cfg.use_sp`` the banded local path is never taken (the
        reference's rule, on every path)."""
        cfg = self.cfg
        seq = sp is not None
        split, kv = ((None, None) if seq
                     else attn_split(p, cfg.n_heads, cfg.n_kv_heads))
        h = L.rms_norm(x, gather_at_use(p["ln1"], model_partial=seq))
        h = copy_to_model(h, split)
        wq, wk, wv, wo = attn_weights(p, split, kv, cfg.head_dim,
                                      model_partial=seq)
        q, k, v = self._project_qkv(wq, wk, wv, h, positions,
                                    mrope_positions)
        k, v = gather_seq(k, sp), gather_seq(v, sp)
        if (window > 0 and cfg.local_attn_fast_path and not cfg.use_sp
                and x.shape[1] > window):
            o = L.local_window_attention(q, k, v, window=window)
        else:
            o = L.blockwise_attention(
                q, k, v, causal=True, window=window,
                q_offset=sp.rank * x.shape[1] if seq else 0, chunk=chunk)
        o = o.reshape(*x.shape[:2], -1) @ wo.to(x.dtype)
        return x + sum_over_model(o, split), (k, v)

    def _attn_decode(self, p, x, cache: L.KVCache, length, mrope, chunk):
        """Single-token attention against a cache (a ring for a local
        layer: it holds exactly the window); returns (x, new_cache). On
        the serving steps' ``Placed`` leaves, on the cache's ``model``
        layout with no weight moved (``models.common.attn_decode``)."""
        if isinstance(p["wq"], Placed):
            return self._attn_decode_placed(p, x, cache, length, mrope,
                                            chunk)
        B = x.shape[0]
        pos = length.reshape(1, 1).expand(B, 1).to(torch.int32)
        mpos = None
        if mrope:
            mpos = length.reshape(1, 1, 1).expand(3, B, 1).to(torch.int32)
        h = L.rms_norm(x, p["ln1"])
        q, k, v = self._project_qkv(p["wq"], p["wk"], p["wv"], h, pos, mpos)
        new_cache = L.cache_update_decode(cache._replace(length=length), k, v)
        S_max = cache.k.shape[1]
        kv_len = torch.clamp(length + 1, max=S_max)
        o = L.blockwise_attention(q, new_cache.k, new_cache.v, causal=False,
                                  kv_len=kv_len, chunk=chunk)
        o = o.reshape(B, 1, -1) @ p["wo"].to(x.dtype)
        return x + o, new_cache

    def _attn_decode_placed(self, p, x, cache: L.KVCache, length, mrope,
                            chunk):
        cfg = self.cfg
        B = x.shape[0]
        pos = length.reshape(1, 1).expand(B, 1).to(torch.int32)

        def rope(q, k):
            if mrope:
                mpos = length.reshape(1, 1, 1).expand(3, B, 1).to(
                    torch.int32)
                return tuple(L.apply_mrope(t, mpos, cfg.mrope_sections,
                                           cfg.rope_theta) for t in (q, k))
            return tuple(L.apply_rope(t, pos, cfg.rope_theta)
                         for t in (q, k))

        h = L.rms_norm(x, gather_at_use(p["ln1"]))
        kv_len = torch.clamp(length + 1, max=cache.k.shape[1])
        o, new_cache = attn_decode(p, h, cache, length, kv_len, cfg, rope,
                                   chunk)
        return x + o, new_cache

    def _ffn(self, p, x, sp: Optional[ModelSplit] = None):
        """The FFN block; returns (x, aux), aux ``None`` without MoE. The
        MLP is column-parallel on ``w1``/``w3`` and row-parallel on ``w2``
        where the spec splits ``d_ff`` over ``model``; the MoE gathers its
        own leaves (its experts kept on their ``model`` shards). With
        ``sp`` (``x`` this rank's block of positions) the MLP runs on the
        rank's rows on its weights gathered whole, and the MoE on the
        whole sequence, all-gathered, every ``model`` rank then taking its
        block of the output: its output's gradient is all-gathered back,
        equal on every rank as the MoE's own backward assumes, and the
        rank keeps its block of the input's."""
        cfg = self.cfg
        h = L.rms_norm(x, gather_at_use(p["ln2"],
                                        model_partial=sp is not None))
        if cfg.family == "moe":
            y, aux = moe_ffn(p["moe"], gather_seq_equal(h, sp), cfg)
            return x + slice_seq(y, sp), aux
        return x + mlp(p, h, cfg.act, seq=sp), None

    def _layer_full(self, p, x, positions, window, mrope_positions, chunk,
                    sp=None):
        x, kv = self._attn_full(p, x, positions, window, mrope_positions,
                                chunk, sp)
        x, aux = self._ffn(p, x, sp)
        return x, aux, kv

    def _schedule(self, params):
        """``(layer params, window, kind)`` for every layer in order; kind
        is ``"layers"``, ``"local"``, ``"global"`` or ``"extra"``."""
        if self.n_groups == 0:
            return [(p, 0, "layers")
                    for p in per_layer(params["layers"])]
        w, lpg = self.cfg.sliding_window, self.cfg.local_per_global
        loc = per_layer(params["groups"]["local"], lead=2)
        glob = per_layer(params["groups"]["global"])
        out = []
        for g in range(self.n_groups):
            out += [(p, w, "local") for p in loc[g * lpg:(g + 1) * lpg]]
            out.append((glob[g], 0, "global"))
        if self.n_extra_local:
            out += [(p, w, "extra")
                    for p in per_layer(params["extra_local"])]
        return out

    # ------------------------------------------------------------------
    # full-sequence forward (train / prefill)
    # ------------------------------------------------------------------
    def _seq(self, params) -> Optional[ModelSplit]:
        """The ``model`` split of the positions under ``cfg.use_sp`` on
        the sharded or placed steps' leaves (``sharding.api.seq_split``);
        ``None``: the whole sequence on every rank."""
        return seq_split(params["final_ln"]) if self.cfg.use_sp else None

    def _rows(self, B: int, S: int, sp: Optional[ModelSplit], dev):
        """``(this rank's positions as a slice, their (B, n) int32
        positions)`` of a sequence of ``S``: all of it with no ``sp``;
        ``ValueError`` where ``sp``'s ranks do not divide ``S``."""
        pos = slice(0, S) if sp is None else seq_block(S, sp)
        return pos, torch.arange(pos.start, pos.stop, dtype=torch.int32,
                                 device=dev).expand(B, pos.stop - pos.start)

    def _embed(self, params, tokens=None, embeds=None, sp=None):
        """The input's rows (B, S, d), or with ``sp`` this rank's block of
        positions: patch embeddings sliced, tokens looked up whole and
        each rank's partial lookups reduce-scattered along the sequence
        (``models.common.embed_lookup``)."""
        if embeds is not None:
            if sp is not None:
                embeds = embeds[:, seq_block(embeds.shape[1], sp)]
            return embeds.to(self.cfg.cdtype)
        return embed_lookup(params["embed"], tokens, self.cfg.cdtype, seq=sp)

    def backbone(self, params, x, positions, mrope_positions=None, *,
                 remat: bool = False, collect_kv: bool = False,
                 chunk: int = 1024, sp: Optional[ModelSplit] = None):
        """Runs all layers; returns (x, aux_sum, kv or None): kv per layer
        kind (``"layers"``, ``"local"``, ``"global"``, ``"extra"``), a list
        of (k, v) in layer order. With ``sp`` ``x`` is this rank's block
        of positions (sequence parallelism) and each layer runs on it."""
        L.require_full_precision(x)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        kv = {}
        for p_l, window, kind in self._schedule(params):
            args = (p_l, x, positions, window, mrope_positions, chunk, sp)
            if remat and torch.is_grad_enabled():
                x, a, kv_l = checkpoint(
                    self._layer_full, *args, use_reentrant=False,
                    context_fn=lambda: (contextlib.nullcontext(),
                                        uncounted_sorts()))
            else:
                x, a, kv_l = self._layer_full(*args)
            if a is not None:
                aux = aux + a
            if collect_kv:
                kv.setdefault(kind, []).append(cache_kv(p_l, kv_l,
                                                        self.cfg, seq=sp))
        return x, aux, (kv if collect_kv else None)

    def loss(self, params, batch, *, remat: bool = True,
             ce_chunk: int = 512, attn_chunk: int = 1024):
        """Mean next-token CE plus ``0.01 * aux``. batch: tokens (B, S) +
        labels (B, S) [+ embeds (B, S, d) + mrope_positions (3, B, S) for
        the VLM's stub frontend].

        Under ``cfg.use_sp`` on the sharded step's leaves (a ``model`` dim
        of more than one rank) each rank computes the layers on its block
        of S / model positions, the reference's ``seq_sp`` layout; the
        final norm's output is all-gathered along the sequence for the
        loss on the vocabulary's shards (``chunked_ce``), so every
        ``model`` rank holds the same loss, the whole sequence's.
        ``ValueError`` where the ``model`` ranks do not divide S."""
        labels = batch["labels"]
        B, S = labels.shape
        sp = self._seq(params)
        pos, positions = self._rows(B, S, sp, labels.device)
        x = self._embed(params, batch.get("tokens"), batch.get("embeds"), sp)
        mrope = batch.get("mrope_positions")
        if mrope is not None and sp is not None:
            mrope = mrope[..., pos]
        x, aux, _ = self.backbone(params, x, positions, mrope, remat=remat,
                                  chunk=attn_chunk, sp=sp)
        x = L.rms_norm(x, gather_at_use(params["final_ln"],
                                        model_partial=sp is not None))
        ce = chunked_ce(x, params["head"], labels, chunk=ce_chunk, seq=sp)
        return ce + 0.01 * aux

    # ------------------------------------------------------------------
    # serving
    # ------------------------------------------------------------------
    def init_cache(self, B: int, max_len: int, device=None) -> DecodeCaches:
        cfg = self.cfg
        dev = resolve_device(device)

        def kv(lead, s):
            shape = lead + (B, s, cfg.n_kv_heads, cfg.head_dim)
            zeros = torch.zeros(shape, dtype=cfg.cdtype, device=dev)
            return L.KVCache(zeros, zeros.clone(), torch.zeros(
                lead, dtype=torch.int32, device=dev))

        if self.n_groups > 0:
            w = min(cfg.sliding_window, max_len)
            layers = {
                "groups": (kv((self.n_groups, cfg.local_per_global), w),
                           kv((self.n_groups,), max_len)),
                "extra": (kv((self.n_extra_local,), w)
                          if self.n_extra_local else None),
            }
        else:
            layers = kv((cfg.n_layers,), max_len)
        return DecodeCaches(layers=layers, length=torch.zeros(
            (), dtype=torch.int32, device=dev))

    @torch.no_grad()
    def prefill(self, params, tokens=None, embeds=None, mrope_positions=None,
                *, max_len: Optional[int] = None, attn_chunk: int = 1024):
        """Full-sequence forward that also builds decode caches; returns
        (last-position logits (B, vocab) f32, caches). Raises
        ``ValueError`` when ``max_len`` is under the prompt's length (the
        reference's global caches cannot pad by a negative amount). Under
        ``cfg.use_sp`` on the placed step's leaves the layers run on this
        rank's block of positions as in :meth:`loss`, the caches are built
        from the keys and values gathered along the sequence, and the
        logits from the last ``model`` rank's last row."""
        if tokens is not None:
            B, S = tokens.shape
            dev = tokens.device
        else:
            B, S = embeds.shape[:2]
            dev = embeds.device
        max_len = max_len or S
        if max_len < S:
            raise ValueError(f"max_len {max_len} is under the prompt's "
                             f"length {S}")
        sp = self._seq(params)
        pos, positions = self._rows(B, S, sp, dev)
        x = self._embed(params, tokens, embeds, sp)
        if mrope_positions is not None and sp is not None:
            mrope_positions = mrope_positions[..., pos]
        x, _, kv = self.backbone(params, x, positions, mrope_positions,
                                 remat=False, collect_kv=True,
                                 chunk=attn_chunk, sp=sp)
        caches = self._kv_to_caches(kv, S, max_len)
        return self.logits_last(params, x, sp), caches

    @staticmethod
    def _ring_from_tail(k, S: int, w: int):
        """A ring cache from the last ``w`` of a (B, S, kv, hd) array:
        position p in slot p mod w."""
        if S <= w:
            return torch.nn.functional.pad(k, (0, 0, 0, 0, 0, w - S))
        return torch.roll(k[:, S - w:], shifts=(S - w) % w, dims=1)

    def _kv_to_caches(self, kv, S: int, max_len: int) -> DecodeCaches:
        dev = next(iter(kv.values()))[0][0].device

        def lens(lead):
            return torch.full(lead, S, dtype=torch.int32, device=dev)

        def full_cache(pairs):
            pad = (0, 0, 0, 0, 0, max_len - S)
            return L.KVCache(
                torch.stack([torch.nn.functional.pad(k, pad)
                             for k, _ in pairs]),
                torch.stack([torch.nn.functional.pad(v, pad)
                             for _, v in pairs]), lens((len(pairs),)))

        def ring_cache(pairs, w, lead):
            return L.KVCache(
                torch.stack([self._ring_from_tail(k, S, w)
                             for k, _ in pairs]).reshape(
                    lead + (-1, w) + pairs[0][0].shape[2:]),
                torch.stack([self._ring_from_tail(v, S, w)
                             for _, v in pairs]).reshape(
                    lead + (-1, w) + pairs[0][1].shape[2:]), lens(lead))

        if self.n_groups > 0:
            w = min(self.cfg.sliding_window, max_len)
            G = self.n_groups
            layers = {
                "groups": (ring_cache(kv["local"], w,
                                      (G, self.cfg.local_per_global)),
                           full_cache(kv["global"])),
                "extra": (ring_cache(kv["extra"], w, (self.n_extra_local,))
                          if self.n_extra_local else None),
            }
        else:
            layers = full_cache(kv["layers"])
        return DecodeCaches(layers=layers, length=torch.tensor(
            S, dtype=torch.int32, device=dev))

    def _layer_caches(self, layers):
        """The caches of every layer in :meth:`_schedule`'s order."""
        if self.n_groups == 0:
            c = layers
            return [L.KVCache(c.k[i], c.v[i], c.length[i])
                    for i in range(c.k.shape[0])]
        loc, glob = layers["groups"]
        out = []
        for g in range(self.n_groups):
            out += [L.KVCache(loc.k[g, i], loc.v[g, i], loc.length[g, i])
                    for i in range(self.cfg.local_per_global)]
            out.append(L.KVCache(glob.k[g], glob.v[g], glob.length[g]))
        if self.n_extra_local:
            e = layers["extra"]
            out += [L.KVCache(e.k[i], e.v[i], e.length[i])
                    for i in range(self.n_extra_local)]
        return out

    def _restack(self, per_layer):
        """:meth:`_layer_caches` inverted: per-layer caches in schedule
        order back into the layout of :class:`DecodeCaches`."""
        if self.n_groups == 0:
            return _stack_cache(per_layer)
        G, lpg = self.n_groups, self.cfg.local_per_global
        loc = [c for g in range(G) for c in per_layer[g * (lpg + 1):
                                                      g * (lpg + 1) + lpg]]
        glob = [per_layer[g * (lpg + 1) + lpg] for g in range(G)]
        loc = _stack_cache(loc)
        loc = L.KVCache(*(x.reshape((G, lpg) + x.shape[1:]) for x in loc))
        extra = per_layer[G * (lpg + 1):]
        return {"groups": (loc, _stack_cache(glob)),
                "extra": _stack_cache(extra) if extra else None}

    @torch.no_grad()
    def decode_step(self, params, caches: DecodeCaches, tokens,
                    *, attn_chunk: int = 4096):
        """One token for every sequence. tokens: (B,) integers. Returns
        (logits (B, vocab) f32, new caches). M-RoPE models take the cache
        length on all three streams."""
        length = caches.length
        x = self._embed(params, tokens[:, None])
        L.require_full_precision(x)
        mrope = self.cfg.mrope_sections != (0, 0, 0)
        new = []
        for (p_l, _, _), cache in zip(self._schedule(params),
                                      self._layer_caches(caches.layers)):
            x, cache = self._attn_decode(p_l, x, cache, length, mrope,
                                         attn_chunk)
            x, _ = self._ffn(p_l, x)
            new.append(cache)
        logits = self.logits_last(params, x)
        return logits, DecodeCaches(layers=self._restack(new),
                                    length=length + 1)


def _check_labels(labels: torch.Tensor, vocab: int) -> None:
    """Refuse a label outside ``[0, vocab)`` (one host sync). The read
    runs beneath the dispatch modes, so the cost analysis counts the same
    step on real and on fake tensors; fake tensors (the dry-run) have no
    values to read and are let through."""
    if compat.is_fake(labels) or labels.device.type == "meta":
        return
    with compat.beneath_dispatch_modes():
        bad = (labels < 0) | (labels >= vocab)
        if bool(bad.any()):
            raise ValueError(f"a label lies outside [0, {vocab}): "
                             f"{int(labels[bad][0])}")


def chunked_ce(x: torch.Tensor, head: torch.Tensor, labels: torch.Tensor,
               chunk: int = 512, seq: Optional[ModelSplit] = None
               ) -> torch.Tensor:
    """Cross-entropy without materializing (B, S, V): a loop over S chunks,
    each recomputed in backward (a chunk's (B, c, V) logits are never kept
    for backward). A ``head`` leaf the spec splits over ``model`` (a
    ``sharding.api.Placed``) is vocabulary-parallel: each rank's logits
    are its columns', and the max, the sum of ``exp`` and the gold logit
    are combined over ``model`` in f32. A label outside ``[0, vocab)``
    raises ``ValueError`` on either path, before any chunk. Under
    sequence parallelism (``seq``) ``x`` is this rank's block of the
    positions of ``labels``: it is all-gathered along the sequence first,
    and its gradient, each rank's vocabulary columns' part, comes back
    summed over ``model`` into each rank's block (a reduce-scatter, where
    tensor parallelism all-reduces it)."""
    _check_labels(labels, head.shape[-1])
    split = model_split(head, -1)
    head = gather_at_use(head, keep_model=split is not None)
    if seq is not None:
        x = (gather_seq(x, seq) if split is not None
             else gather_seq_equal(x, seq))
    elif split is not None:
        x = copy_to_model(x, split)
    B, S, d = x.shape
    n = max(1, S // chunk)
    chunk = S // n
    if S % chunk != 0:
        raise ValueError("seq len must divide ce chunk count")

    if split is None:
        def step(xb, lb):
            logits = (xb @ head.to(xb.dtype)).to(torch.float32)
            lse = torch.logsumexp(logits, dim=-1)
            gold = torch.gather(logits, -1, lb[..., None].long())[..., 0]
            return (lse - gold).sum()
    else:
        cols = head.shape[-1]
        lo = split.rank * cols

        def step(xb, lb):
            logits = (xb @ head.to(xb.dtype)).to(torch.float32)
            m = max_over_model(logits.amax(dim=-1), split)
            se = torch.exp(logits - m[..., None]).sum(dim=-1)
            lse = m + torch.log(sum_over_model(se, split))
            i = lb.long() - lo
            inside = (i >= 0) & (i < cols)
            gold = torch.gather(logits, -1,
                                i.clamp(0, cols - 1)[..., None])[..., 0]
            gold = sum_over_model(torch.where(inside, gold, 0.0), split)
            return (lse - gold).sum()

    remat = torch.is_grad_enabled() and (x.requires_grad
                                         or head.requires_grad)
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(n):
        xb = x[:, i * chunk:(i + 1) * chunk]
        lb = labels[:, i * chunk:(i + 1) * chunk]
        part = (checkpoint(step, xb, lb, use_reentrant=False) if remat
                else step(xb, lb))
        tot = tot + part
    return tot / (B * S)
