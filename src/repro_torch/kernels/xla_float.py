"""XLA's float rules for the port's plain versions on any device.

The reference runs on XLA, whose CPU and TPU arithmetic treat a subnormal
f32 or bf16 input of an add or a float compare as a zero of the same sign
and flush a subnormal result to a zero of its sign. PyTorch keeps
subnormals, so the port flushes explicitly where the reference adds or
compares values, and its CUDA kernels that add are built with
``-ftz=true`` (``_build.NVCC_FTZ``), which does the same on the card.
Copies, gathers, ``where`` and the order of ``lax.top_k`` keep the bits,
so order-only operations stay unflushed.

XLA rounds an f32 result to bf16 to nearest even and turns a NaN into the
quiet NaN of its sign (``0x7fc0`` / ``0xffc0``); PyTorch's CPU rounding
turns every NaN into ``0x7fc0``. :func:`round_bf16` is XLA's rule.

Nothing here changes a process-wide mode (``torch.set_flush_denormal`` is
not used): every flush is an explicit ``where``.
"""
from __future__ import annotations

import numpy as np
import torch

#: The smallest normal f32 (and bf16) magnitude; below it a value is
#: subnormal.
F32_TINY = torch.finfo(torch.float32).tiny

#: Types whose subnormals XLA flushes (both share the f32 exponent range).
FLUSHED = (torch.float32, torch.bfloat16)


def flush(x: torch.Tensor) -> torch.Tensor:
    """``x`` with every subnormal replaced by a zero of its sign (f32 and
    bf16; other types unchanged). NaN and infinities keep their bits."""
    if x.dtype not in FLUSHED:
        return x
    return torch.where(x.abs() < F32_TINY, x * 0.0, x)


def add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a + b`` as XLA adds f32: subnormal inputs and result flushed."""
    return flush(flush(a) + flush(b))


def add_scalar(a: np.float32, b: np.float32) -> np.float32:
    """:func:`add` of two numpy f32 scalars, for the plain versions' loops
    over one element at a time (a tensor op per element is far slower)."""
    tiny = np.float32(F32_TINY)
    a = a * np.float32(0.0) if abs(a) < tiny else a
    b = b * np.float32(0.0) if abs(b) < tiny else b
    c = np.float32(a + b)
    return c * np.float32(0.0) if abs(c) < tiny else c


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    """f32 -> bf16 as XLA rounds: to nearest even, a NaN to the quiet NaN
    of its sign."""
    bits = x.float().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    rne = (bits + 0x7FFF + ((bits >> 16) & 1)) >> 16
    nan = ((bits >> 16) & 0x8000) | 0x7FC0
    out = torch.where(torch.isnan(x), nan, rne)
    return (out - ((out & 0x8000) << 1)).to(torch.int16).view(torch.bfloat16)


def add_as(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a + b`` in ``a``'s type as XLA adds: f32 through :func:`add`;
    bf16 in f32 (flushed) and then :func:`round_bf16`, so every add rounds
    once; other types as PyTorch adds them."""
    if a.dtype == torch.bfloat16:
        return round_bf16(add(a.float(), b.float()))
    if a.dtype == torch.float32:
        return add(a, b.to(torch.float32))
    return a + b.to(a.dtype)
