"""Plain reference of one SUMMA worker's block of C (2D sparse SUMMA, the
SpGEMM whose stage partials SpKAdd adds, arXiv:2112.10223), and its
control in TF32.

The worker multiplies its A stripe ``(m, K)`` by its B stripe ``(K, n)``
in ``stages`` stages, and the block of C is the sum of the stages' partial
products, none cut. The reference works each stage out in float64 and sums
in float64; the control computes each stage with its operands rounded to
TF32 and sums in float32.
"""
from __future__ import annotations

import torch


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` (f32) rounded to TF32's 10 mantissa bits, to nearest even."""
    bits = x.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    out = (bits + 0xFFF + lsb) & ~0x1FFF
    return out.view(torch.float32)


def worker_block(a: torch.Tensor, b: torch.Tensor, stages: int,
                 precision: str = "float64") -> tuple:
    """The dense ``(m, n)`` block of C and the largest partial's count of
    nonzeros. ``precision`` ``"float64"`` is the reference; ``"tf32"`` is
    the control (operands rounded to TF32, products and sum in float32)."""
    k_glob = a.shape[1]
    blk = k_glob // stages
    out, fill = None, 0
    for s in range(stages):
        a_s, b_s = a[:, s * blk:(s + 1) * blk], b[s * blk:(s + 1) * blk, :]
        if precision == "float64":
            p = a_s.double() @ b_s.double()
        elif precision == "tf32":
            p = _f32_matmul(tf32_round(a_s), tf32_round(b_s))
        else:
            raise ValueError(f"unknown precision {precision!r}")
        fill = max(fill, int((p != 0).sum()))
        out = p if out is None else out + p
    return out, fill


def _f32_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """An f32 product with TF32 off, whatever the process has set."""
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return a @ b
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


def relative_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest entry of ``|got - want|`` over the largest ``|want|``."""
    scale = float(want.abs().max())
    diff = float((got.double() - want.double()).abs().max())
    return diff / scale if scale > 0 else diff


def support_gap(got: torch.Tensor, want: torch.Tensor) -> int:
    """The positions that are nonzero on one side and zero on the other."""
    return int(((got != 0) != (want != 0)).sum())
