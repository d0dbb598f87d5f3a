"""int8 KV-cache quantization.

The port of ``src/repro/serve/kv_quant.py``. Per-(position, head)
symmetric int8 quantization cuts the cache's footprint and read traffic:

    k_q = round(k / scale),  scale = max|k| / 127   (per position, per head)

computed in f32 (the scale a true division by 127, on the card as on the
CPU), rounded half to even (``torch.round``, as ``jnp.round``), clipped to
±127 and cast to int8. Dequantization happens at attention
time: the codes times their scales in f32, cast to the query's dtype, then
the port's ``layers.blockwise_attention``. A decode step writes its
position at ``length % S_max`` (a ring, as ``layers.cache_update_decode``).
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from repro_torch.models.layers import blockwise_attention


class QuantKVCache(NamedTuple):
    k_q: torch.Tensor       # int8  (B, S, H, D)
    v_q: torch.Tensor       # int8  (B, S, H, D)
    k_scale: torch.Tensor   # f32   (B, S, H)
    v_scale: torch.Tensor   # f32   (B, S, H)
    length: torch.Tensor    # int32, 0-d


def _quant(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (..., D) -> (int8 codes, per-row scale)."""
    x32 = x.to(torch.float32)
    # a true division on the card too: there a Python scalar divisor is a
    # multiplication by its reciprocal, another rounding
    scale = torch.amax(x32.abs(), dim=-1) / torch.full(
        (), 127.0, dtype=torch.float32, device=x.device)
    safe = torch.clamp(scale, min=1e-8)
    q = torch.clamp(torch.round(x32 / safe[..., None]), -127, 127).to(
        torch.int8)
    return q, scale


def quantize_kv(k: torch.Tensor, v: torch.Tensor,
                length=None) -> QuantKVCache:
    """Quantize full (B, S, H, D) K/V tensors (prefill output)."""
    k_q, k_s = _quant(k)
    v_q, v_s = _quant(v)
    if length is None:
        length = k.shape[1]
    return QuantKVCache(k_q, v_q, k_s, v_s, torch.as_tensor(
        length, dtype=torch.int32, device=k.device))


def dequantize_kv(cache: QuantKVCache, dtype=torch.bfloat16):
    k = cache.k_q.to(torch.float32) * cache.k_scale[..., None]
    v = cache.v_q.to(torch.float32) * cache.v_scale[..., None]
    return k.to(dtype), v.to(dtype)


def quant_cache_update_decode(cache: QuantKVCache, k_new: torch.Tensor,
                              v_new: torch.Tensor) -> QuantKVCache:
    """Append one decode step (Sq=1), quantizing in-line, in new
    tensors."""
    S_max = cache.k_q.shape[1]
    pos = (cache.length % S_max).reshape(1).long()
    kq, ks = _quant(k_new)
    vq, vs = _quant(v_new)
    return QuantKVCache(
        k_q=cache.k_q.index_copy(1, pos, kq),
        v_q=cache.v_q.index_copy(1, pos, vq),
        k_scale=cache.k_scale.index_copy(1, pos, ks),
        v_scale=cache.v_scale.index_copy(1, pos, vs),
        length=cache.length + 1)


def attention_with_quant_cache(q: torch.Tensor, cache: QuantKVCache, *,
                               chunk: int = 4096) -> torch.Tensor:
    """Single-token attention against an int8 cache (dequant-at-use)."""
    k, v = dequantize_kv(cache, dtype=q.dtype)
    kv_len = torch.clamp(cache.length, max=cache.k_q.shape[1])
    return blockwise_attention(q, k, v, causal=False, kv_len=kv_len,
                               chunk=chunk)
