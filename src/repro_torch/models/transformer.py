"""Decoder-only transformer LM: the dense GQA family.

The port of ``src/repro/models/transformer.py`` for ``family == "dense"``
with all-global attention (SmolLM, InternLM2, StableLM share this path).
The gemma3 local:global pattern, MoE and the VLM backbone are ROADMAP
slice 6b.

The parameters are the reference's tree, leaf for leaf: ``embed`` (vocab,
d), ``head`` (d, vocab), ``final_ln`` (d,) and ``layers``, whose leaves are
stacked along a leading layer dimension (``wq`` (L, d, q_dim), ``wk``,
``wv``, ``wo``, ``w1``, ``w3``, ``w2``, ``ln1``, ``ln2``), each weight
applied as ``x @ W``. Every method takes that tree explicitly, as the
reference's do, so the optimizer, the gradient allreduce, delta sync and
checkpoints (all of which work on trees) see the same leaves in both
packages. The module can also hold a tree as its own parameters
(:meth:`TransformerLM.load_params`); ``forward`` is the loss on them.

Training runs the layers one after another, each recomputed in backward
when ``remat`` (``torch.utils.checkpoint``, the reference's
``jax.checkpoint`` of its scanned body). Cross-entropy is computed in
sequence chunks so the (B, S, V) logits tensor never materializes.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch import tree as _tree
from repro_torch.core.sparse import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.common import ModelConfig, dense_init, stacked


class DecodeCaches(NamedTuple):
    """The KV caches of every layer, stacked: ``layers.k``/``layers.v``
    (L, B, S_max, Hkv, D) in the compute dtype, ``layers.length`` (L,);
    ``length`` the tokens already in cache (int32, 0-d)."""
    layers: L.KVCache
    length: torch.Tensor


def check_dense(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` unless ``cfg`` is a dense all-global
    decoder, the only family ported so far."""
    unported = []
    if cfg.family != "dense":
        unported.append(f"family {cfg.family!r}")
    if cfg.local_per_global > 0:
        unported.append("the local:global layer pattern")
    if cfg.mrope_sections != (0, 0, 0):
        unported.append("M-RoPE")
    if unported:
        raise NotImplementedError(
            f"{cfg.arch_id}: {', '.join(unported)} is not ported yet "
            f"(ROADMAP slice 6b); the port builds dense all-global decoders")


class TransformerLM(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        check_dense(cfg)
        self.cfg = cfg
        self.top = nn.ParameterDict()
        self.layers = nn.ParameterDict()

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
        p["w1"] = dense_init(gen, (d, cfg.d_ff), pdt)
        if cfg.act == "silu":
            p["w3"] = dense_init(gen, (d, cfg.d_ff), pdt)
        p["w2"] = dense_init(gen, (cfg.d_ff, d), pdt)
        return p

    def init(self, seed: int = 0, device=None) -> dict:
        """A fresh params tree on ``device`` (``None`` = the CUDA card),
        drawn from a CPU ``torch.Generator`` seeded with ``seed`` (the same
        values on any device)."""
        cfg = self.cfg
        dev = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        params = {
            "embed": dense_init(gen, (cfg.vocab, cfg.d_model), cfg.pdtype,
                                fan_in=cfg.d_model),
            "head": dense_init(gen, (cfg.d_model, cfg.vocab), cfg.pdtype),
            "final_ln": torch.zeros((cfg.d_model,), dtype=cfg.pdtype),
            "layers": stacked(self._init_layer, gen, cfg.n_layers),
        }
        return _tree.tree_map(lambda x: x.to(dev), params)

    def load_params(self, params: dict) -> None:
        """Hold ``params`` (the reference's tree) as this module's
        parameters, sharing their storage."""
        self.top = nn.ParameterDict({k: nn.Parameter(params[k])
                                     for k in ("embed", "final_ln", "head")})
        self.layers = nn.ParameterDict({k: nn.Parameter(v) for k, v in
                                        params["layers"].items()})

    def params_tree(self) -> dict:
        """The module's parameters as the reference's tree."""
        return {**dict(self.top), "layers": dict(self.layers)}

    def forward(self, batch: dict, **kw) -> torch.Tensor:
        """The loss on the module's own parameters."""
        return self.loss(self.params_tree(), batch, **kw)

    # ------------------------------------------------------------------
    # blocks
    # ------------------------------------------------------------------
    def _project_qkv(self, p, h, positions):
        cfg = self.cfg
        B, S, _ = h.shape
        q = (h @ p["wq"].to(h.dtype)).reshape(B, S, cfg.n_heads,
                                              cfg.head_dim)
        k = (h @ p["wk"].to(h.dtype)).reshape(B, S, cfg.n_kv_heads,
                                              cfg.head_dim)
        v = (h @ p["wv"].to(h.dtype)).reshape(B, S, cfg.n_kv_heads,
                                              cfg.head_dim)
        q = L.apply_rope(q, positions, cfg.rope_theta)
        k = L.apply_rope(k, positions, cfg.rope_theta)
        return q, k, v

    def _attn_full(self, p, x, positions, chunk):
        """Full-sequence attention (train / prefill); returns (x, (k, v))."""
        h = L.rms_norm(x, p["ln1"])
        q, k, v = self._project_qkv(p, h, positions)
        o = L.blockwise_attention(q, k, v, causal=True, chunk=chunk)
        o = o.reshape(*x.shape[:2], -1) @ p["wo"].to(x.dtype)
        return x + o, (k, v)

    def _attn_decode(self, p, x, cache: L.KVCache, length, chunk):
        """Single-token attention against a cache; returns (x, new_cache)."""
        B = x.shape[0]
        pos = length.reshape(1, 1).expand(B, 1).to(torch.int32)
        h = L.rms_norm(x, p["ln1"])
        q, k, v = self._project_qkv(p, h, pos)
        new_cache = L.cache_update_decode(cache._replace(length=length), k, v)
        S_max = cache.k.shape[1]
        kv_len = torch.clamp(length + 1, max=S_max)
        o = L.blockwise_attention(q, new_cache.k, new_cache.v, causal=False,
                                  kv_len=kv_len, chunk=chunk)
        o = o.reshape(B, 1, -1) @ p["wo"].to(x.dtype)
        return x + o, new_cache

    def _ffn(self, p, x):
        h = L.rms_norm(x, p["ln2"])
        if self.cfg.act == "silu":
            y = L.swiglu(h, p["w1"].to(x.dtype), p["w3"].to(x.dtype),
                         p["w2"].to(x.dtype))
        else:
            y = L.gelu_mlp(h, p["w1"].to(x.dtype), p["w2"].to(x.dtype))
        return x + y

    def _layer_full(self, p, x, positions, chunk):
        x, kv = self._attn_full(p, x, positions, chunk)
        return self._ffn(p, x), kv

    @staticmethod
    def _per_layer(stack: dict):
        """The stacked layer leaves as one dict per layer (views; one
        ``unbind`` a leaf, whose backward stacks the layers' gradients)."""
        keys = sorted(stack)
        return [dict(zip(keys, vals))
                for vals in zip(*(stack[k].unbind(0) for k in keys))]

    # ------------------------------------------------------------------
    # full-sequence forward (train / prefill)
    # ------------------------------------------------------------------
    def _embed(self, params, tokens):
        return params["embed"].to(self.cfg.cdtype)[tokens.long()]

    def backbone(self, params, x, positions, *, remat: bool = False,
                 collect_kv: bool = False, chunk: int = 1024):
        """Runs all layers; returns (x, aux_sum, (k, v) stacks or None)."""
        L.require_full_precision(x)
        ks, vs = [], []
        for p_l in self._per_layer(params["layers"]):
            if remat and torch.is_grad_enabled():
                x, (k, v) = checkpoint(self._layer_full, p_l, x, positions,
                                       chunk, use_reentrant=False)
            else:
                x, (k, v) = self._layer_full(p_l, x, positions, chunk)
            if collect_kv:
                ks.append(k)
                vs.append(v)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        kv = (torch.stack(ks), torch.stack(vs)) if collect_kv else None
        return x, aux, kv

    def logits_last(self, params, x):
        """Logits for the final position only (prefill output)."""
        h = L.rms_norm(x[:, -1:], params["final_ln"])
        return (h @ params["head"].to(h.dtype)).to(torch.float32)[:, 0]

    def loss(self, params, batch, *, remat: bool = True,
             ce_chunk: int = 512, attn_chunk: int = 1024):
        """Mean next-token CE. batch: tokens (B, S) + labels (B, S)."""
        tokens, labels = batch["tokens"], batch["labels"]
        B, S = labels.shape
        positions = torch.arange(S, dtype=torch.int32,
                                 device=labels.device).expand(B, S)
        x = self._embed(params, tokens)
        x, aux, _ = self.backbone(params, x, positions, remat=remat,
                                  chunk=attn_chunk)
        x = L.rms_norm(x, params["final_ln"])
        ce = chunked_ce(x, params["head"], labels, chunk=ce_chunk)
        return ce + 0.01 * aux

    # ------------------------------------------------------------------
    # serving
    # ------------------------------------------------------------------
    def init_cache(self, B: int, max_len: int, device=None) -> DecodeCaches:
        cfg = self.cfg
        dev = resolve_device(device)
        shape = (cfg.n_layers, B, max_len, cfg.n_kv_heads, cfg.head_dim)
        zeros = torch.zeros(shape, dtype=cfg.cdtype, device=dev)
        return DecodeCaches(
            layers=L.KVCache(zeros, zeros.clone(), torch.zeros(
                (cfg.n_layers,), dtype=torch.int32, device=dev)),
            length=torch.zeros((), dtype=torch.int32, device=dev))

    @torch.no_grad()
    def prefill(self, params, tokens, *, max_len: Optional[int] = None,
                attn_chunk: int = 1024):
        """Full-sequence forward that also builds decode caches; returns
        (last-position logits (B, vocab) f32, caches)."""
        B, S = tokens.shape
        max_len = max_len or S
        positions = torch.arange(S, dtype=torch.int32,
                                 device=tokens.device).expand(B, S)
        x = self._embed(params, tokens)
        x, _, kv = self.backbone(params, x, positions, remat=False,
                                 collect_kv=True, chunk=attn_chunk)
        caches = self._kv_to_caches(kv, S, max_len)
        return self.logits_last(params, x), caches

    def _kv_to_caches(self, kv, S: int, max_len: int) -> DecodeCaches:
        k, v = kv  # (L, B, S, kv, hd)
        pad = max_len - S
        kp = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        vp = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        lens = torch.full(k.shape[:1], S, dtype=torch.int32, device=k.device)
        return DecodeCaches(layers=L.KVCache(kp, vp, lens),
                            length=torch.tensor(S, dtype=torch.int32,
                                                device=k.device))

    @torch.no_grad()
    def decode_step(self, params, caches: DecodeCaches, tokens,
                    *, attn_chunk: int = 4096):
        """One token for every sequence. tokens: (B,) integers. Returns
        (logits (B, vocab) f32, new caches)."""
        length = caches.length
        x = self._embed(params, tokens[:, None])
        L.require_full_precision(x)
        c = caches.layers
        new_k, new_v, new_len = [], [], []
        for i, p_l in enumerate(self._per_layer(params["layers"])):
            x, cache = self._attn_decode(
                p_l, x, L.KVCache(c.k[i], c.v[i], c.length[i]), length,
                attn_chunk)
            x = self._ffn(p_l, x)
            new_k.append(cache.k)
            new_v.append(cache.v)
            new_len.append(cache.length)
        logits = self.logits_last(params, x)
        layers = L.KVCache(torch.stack(new_k), torch.stack(new_v),
                           torch.stack(new_len))
        return logits, DecodeCaches(layers=layers, length=length + 1)


def chunked_ce(x: torch.Tensor, head: torch.Tensor, labels: torch.Tensor,
               chunk: int = 512) -> torch.Tensor:
    """Cross-entropy without materializing (B, S, V): a loop over S chunks,
    each recomputed in backward (a chunk's (B, c, V) logits are never kept
    for backward)."""
    B, S, d = x.shape
    n = max(1, S // chunk)
    chunk = S // n
    if S % chunk != 0:
        raise ValueError("seq len must divide ce chunk count")

    def step(xb, lb):
        logits = (xb @ head.to(xb.dtype)).to(torch.float32)
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, lb[..., None].long())[..., 0]
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
