"""Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates, 700 W)
and the least time a piece of work can take on it."""
from __future__ import annotations

#: HBM3 bandwidth, bytes a second.
HBM_BYTES_PER_S = 3.35e12
#: Float32 rate outside the tensor cores, operations a second.
F32_FLOPS_PER_S = 67e12


def bound_s(nbytes: float = 0.0, flops: float = 0.0) -> float:
    """The larger of ``nbytes`` over the memory rate and ``flops`` (f32,
    outside the tensor cores) over the f32 rate, in seconds."""
    return max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S)


def share_pct(least_s: float, took_s: float):
    """``least_s`` as a percentage of ``took_s``; None where nothing was
    timed."""
    if not took_s or took_s <= 0:
        return None
    return 100.0 * least_s / took_s


def matmul_flops(m: int, k: int, n: int) -> int:
    """Operations of a dense ``(m, k) @ (k, n)`` product."""
    return 2 * m * k * n
