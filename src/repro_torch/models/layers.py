"""Shared neural layers: RMSNorm, RoPE (+M-RoPE), GQA attention, MLPs.

The port of ``src/repro/models/layers.py``. Each function keeps the
reference's arithmetic order and types:

- ``rms_norm`` computes in f32 with ``(1 + scale)`` and casts back;
- ``apply_rope`` rotates the two split halves of each head (not
  interleaved pairs), in f32; ``apply_mrope`` does the same with each
  frequency bin's angle taken from the position stream that owns it (the
  reference's one-hot product over the three streams has exactly one
  nonzero term, so a selection by owner gives its bits);
- ``blockwise_attention`` is the flash-style online softmax over KV chunks
  of the reference, with its guards (``m_safe``, ``corr``) and the padded
  last chunk: scores in f32, and the PV product on ``p`` and ``v`` rounded
  to the compute dtype and multiplied in f32 (the reference's
  ``preferred_element_type=f32``; a product of two bf16 values is exact in
  f32). Under autograd each chunk's body is recomputed in backward
  (``torch.utils.checkpoint``), as the reference checkpoints its scan body.
- ``local_window_attention`` is the banded sliding-window form of gemma3's
  local layers: blocks of ``window`` queries, each against (previous, own)
  block, f32 einsums and a full softmax over the ``2 * window`` keys.
- ``gelu_mlp`` uses the tanh approximation, ``jax.nn.gelu``'s default.

Every f32 product here must be a full f32 product: on a CUDA card TF32 and
reduced-precision bf16 reductions must be off
(:func:`require_full_precision`), or the calls raise.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


def use_full_precision() -> None:
    """Turn TF32 and reduced-precision bf16 reductions off for this
    process's CUDA matrix products (what :func:`require_full_precision`
    asks for); the launchers call it before they build a model."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.set_float32_matmul_precision("highest")


def require_full_precision(x: torch.Tensor) -> None:
    """Raise unless matrix products on ``x``'s device are full precision:
    on a CUDA card TF32 must be off (``torch.backends.cuda.matmul.allow_tf32
    = False``, float32 matmul precision ``"highest"``) and bf16 products
    must not reduce in reduced precision
    (``allow_bf16_reduced_precision_reduction = False``)."""
    if x.device.type != "cuda":
        return
    m = torch.backends.cuda.matmul
    if m.allow_tf32 or torch.get_float32_matmul_precision() != "highest":
        raise RuntimeError("f32 products must not use TF32: set "
                           "torch.backends.cuda.matmul.allow_tf32 = False")
    if m.allow_bf16_reduced_precision_reduction:
        raise RuntimeError(
            "bf16 products must reduce in f32: set torch.backends.cuda."
            "matmul.allow_bf16_reduced_precision_reduction = False")


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x32 = x.to(torch.float32)
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return ((x32 * torch.rsqrt(var + eps))
            * (1.0 + scale.to(torch.float32))).to(dt)


# ---------------------------------------------------------------------------
# rotary embeddings
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / torch.pow(theta, exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (B, S, H, D); positions: (B, S) integers."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                 # (D/2,)
    ang = positions[..., None].to(torch.float32) * freqs   # (B, S, D/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_mrope(x: torch.Tensor, positions: torch.Tensor, sections,
                theta: float) -> torch.Tensor:
    """Qwen2-VL multimodal RoPE. x: (B, S, H, D); positions: (3, B, S) for
    the (t, h, w) streams; ``sections`` = per-stream frequency counts
    summing to D/2, bins owned in order (the first ``t`` bins by stream 0,
    the next ``h`` by stream 1, the last ``w`` by stream 2)."""
    d = x.shape[-1]
    t_n, h_n, w_n = sections
    if t_n + h_n + w_n != d // 2:
        raise ValueError("mrope sections must sum to head_dim/2")
    freqs = rope_freqs(d, theta, x.device)                      # (D/2,)
    ang_all = positions[..., None].to(torch.float32) * freqs    # (3, B, S, D/2)
    ang = torch.cat([ang_all[0, ..., :t_n], ang_all[1, ..., t_n:t_n + h_n],
                     ang_all[2, ..., t_n + h_n:]], dim=-1)      # (B, S, D/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# blockwise attention (flash-style online softmax over KV chunks)
# ---------------------------------------------------------------------------

def _chunk_scores_mask(q_pos, k_pos, kv_len, causal: bool, window: int):
    """(Sq, Ck) boolean mask of admissible attention pairs."""
    ok = k_pos[None, :] < kv_len
    if causal:
        ok = ok & (k_pos[None, :] <= q_pos[:, None])
    if window > 0:
        ok = ok & (k_pos[None, :] > q_pos[:, None] - window)
    return ok


def _as_int32(x, device):
    """An int32 tensor on ``device``, or a Python int as it is (no copy
    from the host, which would wait for the card)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.int32)
    return int(x)


def local_window_attention(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, *, window: int) -> torch.Tensor:
    """Sliding-window causal attention in O(S·2w) instead of O(S²).

    Tiles the sequence into blocks of w = window (the tail padded with
    zeros); each query block attends only (previous block, its own block),
    exactly the support of a causal w-window. Block 0 has no predecessor;
    the padded query rows are cut off at the end.
    """
    require_full_precision(q)
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    w = window
    nb = (S + w - 1) // w
    pad = nb * w - S
    if pad:
        q = F.pad(q, (0, 0, 0, 0, 0, pad))
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    qb = q.reshape(B, nb, w, Hkv, G, D).to(torch.float32) * (D ** -0.5)
    kb = k.reshape(B, nb, w, Hkv, D).to(torch.float32)
    vb = v.reshape(B, nb, w, Hkv, D).to(torch.float32)
    k_prev = torch.cat([torch.zeros_like(kb[:, :1]), kb[:, :-1]], dim=1)
    v_prev = torch.cat([torch.zeros_like(vb[:, :1]), vb[:, :-1]], dim=1)
    k2 = torch.cat([k_prev, kb], dim=2)             # (B, nb, 2w, Hkv, D)
    v2 = torch.cat([v_prev, vb], dim=2)
    s = torch.einsum("bnqhgd,bnchd->bnhgqc", qb, k2)  # (B, nb, Hkv, G, w, 2w)
    dev = q.device
    qpos = torch.arange(w, device=dev)[:, None] + w   # within the 2w axis
    kpos = torch.arange(2 * w, device=dev)[None, :]
    ok = (kpos <= qpos) & (kpos > qpos - w)
    first_block_ok = kpos >= w                      # block 0 has no predecessor
    blk = torch.arange(nb, device=dev)
    mask = torch.where(blk[:, None, None] == 0, (ok & first_block_ok)[None],
                       ok[None])                    # (nb, w, 2w)
    s = torch.where(mask[None, :, None, None, :, :], s, float("-inf"))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bnhgqc,bnchd->bnqhgd", p, v2)
    o = o.reshape(B, nb * w, Hq, D)[:, :S]
    return o.to(q.dtype)


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int = 0,
                        q_offset=0, kv_len=None,
                        chunk: int = 1024, scale=None,
                        scores=None) -> torch.Tensor:
    """q: (B, Sq, Hq, D); k/v: (B, Skv, Hkv, D) -> (B, Sq, Hq, D).

    GQA-aware (Hq = G·Hkv groups share a KV head without materializing the
    repeat), fp32 online-softmax accumulators, optional sliding window and a
    dynamic valid-KV length (padded caches). ``q_offset`` is the absolute
    position of q[0] (decode: the current cache length); ``q_offset`` and
    ``kv_len`` are ints or 0-d integer tensors. ``scale`` defaults to
    ``D ** -0.5``; ``scores``, if given, maps each chunk's f32 scores
    before the mask (:func:`head_dim_split_attention`).
    """
    require_full_precision(q)
    B, Sq, Hq, D = q.shape
    _, Skv, Hkv, _ = k.shape
    G = Hq // Hkv
    if scale is None:
        scale = D ** -0.5
    dev = q.device
    if kv_len is None:
        kv_len = Skv
    kv_len = _as_int32(kv_len, dev)
    q_pos = _as_int32(q_offset, dev) + torch.arange(Sq, dtype=torch.int32,
                                                    device=dev)

    qg = q.reshape(B, Sq, Hkv, G, D) * scale
    q32 = qg.to(torch.float32)
    n_chunks = max(1, (Skv + chunk - 1) // chunk)
    pad = n_chunks * chunk - Skv
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    # p in the model's compute dtype for the PV product (bf16 models round
    # it, f32 models stay exact); the l/acc accumulators are always f32
    pv_dt = torch.bfloat16 if q.dtype == torch.bfloat16 else torch.float32

    def step(m, l, acc, c_idx: int, k_blk, v_blk):
        k_pos = c_idx * chunk + torch.arange(chunk, dtype=torch.int32,
                                             device=dev)
        # scores: (B, Sq, Hkv, G, Ck)
        s = torch.einsum("bshgd,bchd->bshgc", q32, k_blk.to(torch.float32))
        if scores is not None:
            s = scores(s)
        mask = _chunk_scores_mask(q_pos, k_pos, kv_len, causal, window)
        mask = mask[None, :, None, None, :]
        s = torch.where(mask, s, float("-inf"))
        m_new = torch.maximum(m, s.amax(dim=-1))
        # guard -inf rows (no valid keys yet) against NaN in exp
        m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
        p = torch.exp(s - m_safe[..., None])
        p = torch.where(mask, p, 0.0)
        corr = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
        l_new = l * corr + p.sum(dim=-1)
        pv = torch.einsum("bshgc,bchd->bshgd",
                          p.to(pv_dt).to(torch.float32),
                          v_blk.to(pv_dt).to(torch.float32))
        acc_new = acc * corr[..., None] + pv
        return m_new, l_new, acc_new

    m = torch.full((B, Sq, Hkv, G), float("-inf"), dtype=torch.float32,
                   device=dev)
    l = torch.zeros((B, Sq, Hkv, G), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, Sq, Hkv, G, D), dtype=torch.float32, device=dev)
    # backward recomputes each chunk's (Sq, Ck) score block instead of
    # saving one per chunk (flash-attention-style remat)
    remat = n_chunks > 1 and torch.is_grad_enabled() and any(
        t.requires_grad for t in (q, k, v))
    for c in range(n_chunks):
        k_blk = k[:, c * chunk:(c + 1) * chunk]
        v_blk = v[:, c * chunk:(c + 1) * chunk]
        if remat:
            m, l, acc = checkpoint(step, m, l, acc, c, k_blk, v_blk,
                                   use_reentrant=False)
        else:
            m, l, acc = step(m, l, acc, c, k_blk, v_blk)
    out = acc / torch.clamp(l[..., None], min=1e-30)
    return out.reshape(B, Sq, Hq, D).to(q.dtype)


def head_dim_split_attention(q, k, v, *, kv_len, chunk: int,
                             head_dim: int, sum_scores) -> torch.Tensor:
    """One token's attention over a KV cache split along ``head_dim``:
    ``q`` (B, 1, Hq, D / T), this rank's slice of every head, against the
    cache's slices ``k``/``v`` (B, S, Hkv, D / T). Each chunk's partial
    scores are summed over the ``T`` ranks by ``sum_scores`` (an
    all-reduce, which hands every rank the same bits) before the max and
    the ``exp``, and scaled as whole heads of ``head_dim``; the output is
    this rank's slice of every head, (B, 1, Hq, D / T). The reference
    leaves this layout to XLA, which inserts the same score all-reduce."""
    return blockwise_attention(q, k, v, causal=False, kv_len=kv_len,
                               chunk=chunk, scale=head_dim ** -0.5,
                               scores=sum_scores)


def attention_ref(q, k, v, *, causal=True, window=0, q_offset=0,
                  kv_len=None):
    """Quadratic reference for tests."""
    require_full_precision(q)
    B, Sq, Hq, D = q.shape
    _, Skv, Hkv, _ = k.shape
    G = Hq // Hkv
    dev = q.device
    if kv_len is None:
        kv_len = Skv
    q_pos = _as_int32(q_offset, dev) + torch.arange(Sq, dtype=torch.int32,
                                                    device=dev)
    k_pos = torch.arange(Skv, dtype=torch.int32, device=dev)
    qg = q.reshape(B, Sq, Hkv, G, D).to(torch.float32) * (D ** -0.5)
    s = torch.einsum("bshgd,bchd->bshgc", qg, k.to(torch.float32))
    mask = _chunk_scores_mask(q_pos, k_pos, _as_int32(kv_len, dev), causal,
                              window)
    s = torch.where(mask[None, :, None, None, :], s, float("-inf"))
    p = torch.softmax(s, dim=-1)
    p = torch.where(torch.isnan(p), 0.0, p)
    out = torch.einsum("bshgc,bchd->bshgd", p, v.to(torch.float32))
    return out.reshape(B, Sq, Hq, D).to(q.dtype)


# ---------------------------------------------------------------------------
# KV cache
# ---------------------------------------------------------------------------

class KVCache(NamedTuple):
    k: torch.Tensor       # (B, S_max, Hkv, D)
    v: torch.Tensor
    length: torch.Tensor  # int32 scalar: valid prefix


def cache_update_decode(cache: KVCache, k_new: torch.Tensor,
                        v_new: torch.Tensor) -> KVCache:
    """Append one step (Sq=1), in new tensors. For sliding-window caches the
    write wraps (ring buffer) — positions are tracked by ``length``
    monotonically."""
    S_max = cache.k.shape[1]
    pos = (torch.as_tensor(cache.length, device=cache.k.device) % S_max
           ).reshape(1).long()
    k = cache.k.index_copy(1, pos, k_new.to(cache.k.dtype))
    v = cache.v.index_copy(1, pos, v_new.to(cache.v.dtype))
    return KVCache(k, v, cache.length + 1)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def swiglu(x, w1, w3, w2):
    h = F.silu(x @ w1) * (x @ w3)
    return h @ w2


def gelu_mlp(x, w1, w2):
    return F.gelu(x @ w1, approximate="tanh") @ w2
