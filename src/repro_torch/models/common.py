"""Shared model-config dataclass and parameter-init helpers.

The port of ``src/repro/models/common.py``. One ModelConfig describes every
assigned architecture; family-specific fields are simply unused elsewhere.
Configs are frozen (hashable). ``cdtype`` and ``pdtype`` are torch dtypes.

Init draws from an explicit ``torch.Generator``: :func:`dense_init` takes
its normals from the generator in call order, and :func:`stacked` calls an
init ``n`` times in a row. The values need not match JAX's PRNG; a
reference params tree crosses into the port through
``repro_torch.interop.params_from_numpy``.

:class:`TreeModel` is what every model class shares: the seeded ``init``
(each class draws its own tree), the last position's logits, and the
params tree held as the module's own parameters (``load_params``,
``params_tree``, ``forward``); :func:`per_layer` gives a stacked leaf's
layers as views and :func:`maybe_remat` recomputes a layer in backward.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch import tree as _tree
from repro_torch.core.sparse import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.layers import gelu_mlp, rms_norm, swiglu
from repro_torch.sharding.api import (ModelSplit, copy_to_model,
                                      gather_at_use, gather_over_model,
                                      model_split, scatter_seq, seq_block,
                                      sum_over_model)

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


def torch_dtype(name: str) -> torch.dtype:
    """A config's dtype name (``"bfloat16"``, ``"float32"``, ...) as a
    torch dtype."""
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"unknown dtype {name!r}; known: "
                         f"{sorted(_DTYPES)}") from None


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    arch_id: str
    family: str                    # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: Optional[int] = None   # default d_model // n_heads
    act: str = "silu"              # silu (SwiGLU) | gelu (plain MLP)
    rope_theta: float = 10_000.0
    # --- MoE ---
    n_experts: int = 0
    moe_topk: int = 0
    capacity_factor: float = 1.25
    # --- gemma3 local:global ---
    sliding_window: int = 0        # 0 = all-global
    local_per_global: int = 0      # e.g. 5 -> pattern LLLLLG repeated
    # --- SSM (mamba2 / zamba2) ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    conv_width: int = 4
    # --- hybrid (zamba2): a shared attention block every N ssm layers ---
    attn_every: int = 0
    # --- encoder-decoder (whisper) ---
    n_enc_layers: int = 0
    n_frames: int = 1500           # stubbed audio frame embeddings
    # --- vlm ---
    mrope_sections: Tuple[int, int, int] = (0, 0, 0)  # (t, h, w) head_dim split
    # --- distribution ---
    use_sp: bool = False       # Megatron-style sequence sharding of the
                               # residual stream over the 'model' axis
    local_attn_fast_path: bool = True  # banded O(S·2w) sliding-window attn
    # --- numerics ---
    compute_dtype: str = "bfloat16"
    param_dtype: str = "float32"
    # --- notes for DESIGN/EXPERIMENTS ---
    source: str = ""

    @property
    def head_dim(self) -> int:
        if self.d_head:
            return self.d_head
        return self.d_model // self.n_heads if self.n_heads else 0

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def cdtype(self) -> torch.dtype:
        return torch_dtype(self.compute_dtype)

    @property
    def pdtype(self) -> torch.dtype:
        return torch_dtype(self.param_dtype)

    def param_count(self) -> int:
        """Analytic parameter count (embedding + layers), for MODEL_FLOPS."""
        d, v = self.d_model, self.vocab
        emb = v * d
        per_layer = 0
        if self.family in ("dense", "moe", "vlm"):
            attn = d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
            if self.family == "moe":
                ffn = self.n_experts * 3 * d * self.d_ff + d * self.n_experts
            else:
                mult = 3 if self.act == "silu" else 2
                ffn = mult * d * self.d_ff
            per_layer = attn + ffn + 2 * d
            total = emb + self.n_layers * per_layer + d + emb  # final norm + head
        elif self.family == "ssm":
            di, N, H = self.d_inner, self.ssm_state, self.n_ssm_heads
            in_proj = d * (2 * di + 2 * N + H)
            out_proj = di * d
            per_layer = in_proj + out_proj + di + 2 * H + d
            total = emb + self.n_layers * per_layer + d + emb
        elif self.family == "hybrid":
            di, N, H = self.d_inner, self.ssm_state, self.n_ssm_heads
            in_proj = d * (2 * di + 2 * N + H)
            mamba = in_proj + di * d + di + 2 * H + d
            attn = d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
            mult = 3 if self.act == "silu" else 2
            shared = attn + mult * d * self.d_ff + 2 * d
            total = emb + self.n_layers * mamba + shared + d + emb
        elif self.family == "encdec":
            attn = d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
            mult = 3 if self.act == "silu" else 2
            ffn = mult * d * self.d_ff
            enc = self.n_enc_layers * (attn + ffn + 2 * d)
            dec = self.n_layers * (2 * attn + ffn + 3 * d)
            total = emb + enc + dec + d + emb
        else:
            raise ValueError(self.family)
        return int(total)

    def active_param_count(self) -> int:
        """Active params per token (MoE: routed top-k + attention only)."""
        if self.family != "moe":
            return self.param_count()
        d = self.d_model
        attn = d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
        ffn_active = self.moe_topk * 3 * d * self.d_ff + d * self.n_experts
        per_layer = attn + ffn_active + 2 * d
        return int(self.vocab * d * 2 + self.n_layers * per_layer + d)


def tree_param_count(cfg: ModelConfig) -> int:
    """The parameters a model's params tree holds. The reference's
    ``ModelConfig.param_count`` (kept as it is) leaves some out: each
    Mamba2 layer's convolution ((W + 1) * (d_inner + 2 * ssm_state)) and
    ``dt_bias`` (H), and the encoder's final norm (d)."""
    if cfg.family in ("ssm", "hybrid"):
        conv = (cfg.conv_width + 1) * (cfg.d_inner + 2 * cfg.ssm_state)
        return cfg.param_count() + cfg.n_layers * (conv + cfg.n_ssm_heads)
    if cfg.family == "encdec":
        return cfg.param_count() + cfg.d_model
    return cfg.param_count()


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str          # train_4k | prefill_32k | decode_32k | long_500k
    kind: str          # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeConfig("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524_288, 1),
}


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------

def dense_init(gen: torch.Generator, shape, dtype: torch.dtype,
               fan_in: Optional[int] = None) -> torch.Tensor:
    """Normals of std ``1 / sqrt(fan_in)`` (``fan_in`` defaults to
    ``shape[0]``), drawn in f32 from ``gen`` on its device, cast to
    ``dtype``."""
    fan = fan_in if fan_in is not None else shape[0]
    std = 1.0 / math.sqrt(max(1, fan))
    x = torch.randn(tuple(shape), generator=gen, dtype=torch.float32,
                    device=gen.device)
    return (x * std).to(dtype)


def stacked(init_fn: Callable[[torch.Generator], object],
            gen: torch.Generator, n: int):
    """``n`` calls of ``init_fn(gen)`` in a row, each leaf stacked along a
    new leading layer dimension (the reference's ``vmap`` of an init)."""
    trees = [init_fn(gen) for _ in range(n)]
    treedef = _tree.flatten(trees[0])[1]
    columns = zip(*(_tree.leaves(t) for t in trees))
    return _tree.unflatten(treedef, [torch.stack(c) for c in columns])


# ---------------------------------------------------------------------------
# params trees as module parameters
# ---------------------------------------------------------------------------

def _as_module(tree: dict) -> nn.Module:
    """A nested dict of tensors as a module holding them as parameters
    (sharing their storage), one submodule a nested dict."""
    m = nn.Module()
    for k, v in tree.items():
        if isinstance(v, dict):
            m.add_module(k, _as_module(v))
        else:
            m.register_parameter(k, nn.Parameter(v))
    return m


def _as_tree(m: nn.Module) -> dict:
    out = dict(m.named_parameters(recurse=False))
    out.update({k: _as_tree(c) for k, c in m.named_children()})
    return out


def per_layer(stack: dict, lead: int = 1):
    """The stacked layer leaves as one tree per layer (views; one
    ``unbind`` a leaf of its first ``lead`` dims flattened, whose backward
    stacks the layers' gradients into the leaf's shape)."""
    leaves, treedef = _tree.flatten(stack)
    cols = [x.flatten(0, lead - 1).unbind(0) if lead > 1 else x.unbind(0)
            for x in leaves]
    return [_tree.unflatten(treedef, vals) for vals in zip(*cols)]


def embed_lookup(embed, tokens: torch.Tensor, dtype: torch.dtype,
                 seq: Optional[ModelSplit] = None) -> torch.Tensor:
    """``embed``'s rows at ``tokens`` in ``dtype``. An ``embed`` leaf the
    spec splits over ``model`` (a ``sharding.api.Placed``) is
    vocabulary-parallel: each rank looks up the tokens that fall in its
    rows, zeros elsewhere, and the sum over ``model`` (one nonzero term a
    token) gives every rank the whole lookup. Under sequence parallelism
    (``seq``, the ``model`` split of the positions) ``tokens`` is the whole
    sequence and each rank gets its block of positions: the partial
    lookups are reduce-scattered along the sequence, and a table gathered
    whole looks up the rank's block alone (its gradient the rank's part,
    summed over ``model``)."""
    split = model_split(embed, 0)
    table = gather_at_use(embed, keep_model=split is not None,
                          model_partial=seq is not None).to(dtype)
    if split is None:
        if seq is not None:
            tokens = tokens[:, seq_block(tokens.shape[1], seq)]
        return table[tokens.long()]
    rows = table.shape[0]
    i = tokens.long() - split.rank * rows
    inside = (i >= 0) & (i < rows)
    out = torch.where(inside[..., None], table[i.clamp(0, rows - 1)], 0.0)
    if seq is not None:
        return scatter_seq(out, seq, 1)
    return sum_over_model(out, split)


def mlp(p, h: torch.Tensor, act: str,
        seq: Optional[ModelSplit] = None) -> torch.Tensor:
    """The MLP of ``h``: SwiGLU on ``p``'s ``w1``/``w3``/``w2`` for
    ``act == "silu"``, else the tanh GELU on ``w1``/``w2``, in ``h``'s
    dtype. Where the spec splits ``d_ff`` over ``model`` (the sharded
    train step's ``sharding.api.Placed`` leaves), column-parallel on
    ``w1``/``w3`` and row-parallel on ``w2``, then summed over ``model``;
    on its weights gathered whole otherwise. Under sequence parallelism
    (``seq``: ``h`` is this rank's block of positions) on its weights
    gathered whole, each weight's gradient the rank's part summed over
    ``model``, and nothing summed in forward."""
    names = ("w1", "w3", "w2") if act == "silu" else ("w1", "w2")
    splits = [model_split(p[n], -2 if n == "w2" else -1) for n in names]
    split = splits[0] if all(splits) and seq is None else None
    h = copy_to_model(h, split)
    w = [gather_at_use(p[n], keep_model=split is not None,
                       model_partial=seq is not None).to(h.dtype)
         for n in names]
    y = swiglu(h, *w) if act == "silu" else gelu_mlp(h, *w)
    return sum_over_model(y, split)


def attn_decode(p, h: torch.Tensor, cache: L.KVCache, length, kv_len,
                cfg: ModelConfig, rope=None, chunk: int = 4096, *,
                write: bool = True):
    """One token's attention block on the serving steps' leaves
    (``sharding.api.Placed`` on the TP-only serving layout) over a KV
    cache on the reference's cache layout (``sharding.params.cache_spec``),
    moving no weight: ``(the block's output (B, 1, d), new cache)``. ``h``
    is the normed input, ``rope(q, k)`` rotates whole heads (``None``:
    no rotation), ``write`` appends the token's k and v to the cache at
    ``length`` (a cross-attention's static cache: ``False``, no k or v).

    The cache's local shape says its layout. On this rank's KV heads: q,
    k and v on the projections' column blocks (whole heads), the
    attention on this rank's heads, ``wo`` row-parallel, then summed over
    ``model``. Otherwise the token's q, k and v columns are all-gathered
    over ``model`` (their blocks are no blocks of heads) and rotated as
    whole heads; on a cache split along ``head_dim`` each rank takes its
    slice of every head and the scores are summed over ``model``
    (:func:`layers.head_dim_split_attention`), the output's slices
    all-gathered; ``wo`` row-parallel on this rank's rows of it. With no
    ``model`` split this is the plain block's arithmetic."""
    B = h.shape[0]
    hd = cfg.head_dim
    on_heads = cache.k.shape[-2] < cfg.n_kv_heads
    split = model_split(p["wq"], -1)

    def proj(name):
        y = h @ gather_at_use(p[name], keep_model=True).to(h.dtype)
        if not on_heads:
            y = gather_over_model(y, model_split(p[name], -1), -1)
        return y.reshape(B, 1, -1, hd)

    q = proj("wq")
    if write:
        k, v = proj("wk"), proj("wv")
        if rope is not None:
            q, k = rope(q, k)
    part = cache.k.shape[-1]
    if part < hd:
        own = slice(split.rank * part, (split.rank + 1) * part)
        q = q[..., own]
        if write:
            k, v = k[..., own], v[..., own]
    if write:
        cache = L.cache_update_decode(cache._replace(length=length), k, v)
    if part < hd:
        o = L.head_dim_split_attention(
            q, cache.k, cache.v, kv_len=kv_len, chunk=chunk, head_dim=hd,
            sum_scores=lambda s: sum_over_model(s, split))
        o = gather_over_model(o, split, -1)
    else:
        o = L.blockwise_attention(q, cache.k, cache.v, causal=False,
                                  kv_len=kv_len, chunk=chunk)
    o = o.reshape(B, 1, -1)
    rows = model_split(p["wo"], -2)
    if rows is not None and not on_heads:
        n = o.shape[-1] // rows.size
        o = o[..., rows.rank * n:(rows.rank + 1) * n]
    wo = gather_at_use(p["wo"], keep_model=True)
    return sum_over_model(o @ wo.to(o.dtype), rows), cache


def cache_kv(p, kv, cfg: ModelConfig, seq: Optional[ModelSplit] = None):
    """A prefill layer's ``(k, v)`` (B, S, heads, head_dim) as its cache
    holds them on the reference's layout (``sharding.params.cache_spec``:
    the KV heads split over ``model`` where its ranks divide them, else
    ``head_dim`` where they divide it, else neither): as they are with no
    ``model`` split of ``p``'s ``wq`` or on this rank's KV heads; else
    gathered whole where the attention ran on one KV head a rank (an
    all-gather over ``model`` of (B, S, 1, head_dim), one rank a head
    taken), then this rank's slice of ``head_dim`` where the cache is
    split along it. Under sequence parallelism (``seq``) ``kv`` holds
    every KV head, gathered along the sequence: this rank's block of heads
    or of ``head_dim`` is taken."""
    if seq is not None:
        T, r = seq.size, seq.rank
        if cfg.n_kv_heads % T == 0:
            n = cfg.n_kv_heads // T
            return tuple(t[:, :, r * n:(r + 1) * n].contiguous() for t in kv)
        if cfg.head_dim % T == 0:
            n = cfg.head_dim // T
            return tuple(t[..., r * n:(r + 1) * n].contiguous() for t in kv)
        return kv
    split = model_split(p["wq"], -1)
    if split is None or cfg.n_kv_heads % split.size == 0:
        return kv
    by_dim = cfg.head_dim % split.size == 0
    if not by_dim and kv[0].shape[2] == cfg.n_kv_heads:
        return kv
    out = []
    for t in kv:
        if t.shape[2] < cfg.n_kv_heads:
            t = gather_over_model(t, split, 2)[
                :, :, ::split.size // cfg.n_kv_heads]
        if by_dim:
            part = cfg.head_dim // split.size
            t = t[..., split.rank * part:(split.rank + 1) * part]
        out.append(t.contiguous())
    return tuple(out)


def maybe_remat(fn, remat: bool):
    """``fn`` recomputed in backward (``torch.utils.checkpoint``) when
    ``remat`` and grad is on, else ``fn`` itself."""
    if not (remat and torch.is_grad_enabled()):
        return fn
    return lambda *a: checkpoint(fn, *a, use_reentrant=False)


class TreeModel(nn.Module):
    """A model whose methods take the reference's params tree explicitly
    and that can also hold one as its own parameters: the top-level leaves
    ``_TOP`` in ``self.top``, each subtree of :attr:`_stacks` as a
    submodule of that name. A subclass draws its tree in
    ``_init_tree(gen)``."""
    _TOP = ("embed", "final_ln", "head")

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        self.top = nn.ParameterDict()

    def init(self, seed: int = 0, device=None, *,
             on_device: bool = False) -> dict:
        """A fresh params tree on ``device`` (``None`` = the CUDA card),
        drawn from a ``torch.Generator`` seeded with ``seed``: by default
        on the CPU (the same values on any device), with ``on_device`` on
        ``device`` itself (other values than the CPU's; a full-width tree
        of billions of parameters is drawn in under a second on a card,
        where the CPU takes minutes)."""
        dev = resolve_device(device)
        gen = torch.Generator(device=dev if on_device else "cpu")
        gen.manual_seed(seed)
        return _tree.tree_map(lambda x: x.to(dev), self._init_tree(gen))

    def _init_tree(self, gen: torch.Generator) -> dict:
        raise NotImplementedError

    def logits_last(self, params, x, seq: Optional[ModelSplit] = None):
        """Logits for the final position only (prefill and decode
        output), f32. A ``head`` the spec splits over ``model`` (a
        ``sharding.api.Placed``) gives this rank's vocabulary columns,
        all-gathered over ``model``. Under sequence parallelism (``seq``)
        ``x`` is this rank's block of positions: the last ``model`` rank's
        last row, the sequence's, is all-gathered over ``model`` first."""
        if seq is not None:
            x = gather_over_model(x[:, -1:], seq, 1)
        split = model_split(params["head"], -1)
        h = rms_norm(x[:, -1:], gather_at_use(params["final_ln"]))
        head = gather_at_use(params["head"], keep_model=True)
        logits = (h @ head.to(h.dtype)).to(torch.float32)[:, 0]
        return gather_over_model(logits, split, -1)

    @property
    def _stacks(self) -> tuple:
        """The top-level keys of the params tree that hold subtrees."""
        raise NotImplementedError

    def load_params(self, params: dict) -> None:
        """Hold ``params`` (the reference's tree) as this module's
        parameters, sharing their storage."""
        self.top = nn.ParameterDict({k: nn.Parameter(params[k])
                                     for k in self._TOP})
        for k in self._stacks:
            setattr(self, k, _as_module(params[k]))

    def params_tree(self) -> dict:
        """The module's parameters as the reference's tree."""
        return {**dict(self.top),
                **{k: _as_tree(getattr(self, k)) for k in self._stacks}}

    def forward(self, batch: dict, **kw) -> torch.Tensor:
        """The loss on the module's own parameters."""
        return self.loss(self.params_tree(), batch, **kw)
