"""Shared model-config dataclass and parameter-init helpers.

The port of ``src/repro/models/common.py``. One ModelConfig describes every
assigned architecture; family-specific fields are simply unused elsewhere.
Configs are frozen (hashable). ``cdtype`` and ``pdtype`` are torch dtypes.

Init draws from an explicit ``torch.Generator``: :func:`dense_init` takes
its normals from the generator in call order, and :func:`stacked` calls an
init ``n`` times in a row. The values need not match JAX's PRNG; a
reference params tree crosses into the port through
``repro_torch.interop.params_from_numpy``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Tuple

import torch

from repro_torch import tree as _tree

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
