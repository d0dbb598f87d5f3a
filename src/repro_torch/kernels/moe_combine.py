"""The MoE combine: ``csrc/moe_combine.cu`` and its plain version.

The reference combines the K expert outputs of each token with XLA's
ordered scatter-add, ``y.at[tok].add(contrib)``, which folds a token's
contributions in operand order from ``+0.0`` (``src/repro/models/moe.py``).
On CUDA, ``index_add_`` and float atomics add in no fixed order. Every run
of the combine holds exactly K elements at a fixed stride, so the kernel
reads each contribution where it lies in ``(T, K, d)`` and folds it in
registers: no layout copy, no ids, no zero fill.

:func:`moe_combine_raw` takes the plain version for a tensor on the CPU and
the CUDA kernel for a tensor on the card, and has no other path.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, xla_float

_P = ctypes.c_void_p
_ARGTYPES = [_P, _P, ctypes.c_int64, ctypes.c_int, ctypes.c_int64,
             ctypes.c_int, ctypes.c_int, ctypes.c_int64, ctypes.c_int, _P]
#: Value types the kernel folds, by the code its C entry point takes.
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: The kernel's block (``csrc/moe_combine.cu`` ``MC_THREADS``).
THREADS = 256


def moe_combine_plain(contrib: torch.Tensor) -> torch.Tensor:
    """Plain version: K passes of XLA's add over the tokens
    (:func:`xla_float.add_as`), each adding every token's next
    contribution, from ``+0.0``."""
    T, K, d = contrib.shape
    y = torch.zeros((T, d), dtype=contrib.dtype, device=contrib.device)
    for r in range(K):
        y = xla_float.add_as(y, contrib[:, r])
    return y


def launch_geometry(T: int, K: int, d: int, dtype: torch.dtype,
                    aligned: bool) -> dict:
    """The launch :func:`moe_combine_raw` makes for ``contrib`` (T, K, d):
    whether it takes the 16-byte path, its items (one thread each), and
    its grid: a block row for each token, of ``row_blocks`` blocks."""
    per16 = 128 // torch.finfo(dtype).bits
    vectorized = aligned and d % per16 == 0
    row = d // per16 if vectorized else d
    row_blocks = -(-row // THREADS)
    return {"vectorized": vectorized, "items": T * row,
            "blocks": T * row_blocks, "row_blocks": row_blocks,
            "threads": THREADS}


def moe_combine_raw(contrib: torch.Tensor) -> torch.Tensor:
    """``y[t] = ((+0.0 + c[t, 0]) + c[t, 1]) + ... + c[t, K-1]`` of
    ``contrib`` (T, K, d), f32 or bf16, in its type, as XLA adds:
    subnormal inputs and results flushed to a zero of their sign, a bf16
    total rounded after every add (a NaN to the quiet NaN of its sign).
    The reference's ``y.at[tok].add(contrib)`` over a token-major stream,
    bitwise."""
    if contrib.dim() != 3:
        raise ValueError(f"moe_combine_raw: contrib must be (T, K, d), got "
                         f"shape {tuple(contrib.shape)}")
    if contrib.dtype not in _DTYPE_CODES:
        raise TypeError(f"moe_combine_raw takes f32 or bf16, got "
                        f"{contrib.dtype}")
    if contrib.device.type == "cpu":
        return moe_combine_plain(contrib)
    if contrib.device.type != "cuda":
        raise ValueError(f"moe_combine_raw: unsupported device "
                         f"{contrib.device}")
    T, K, d = contrib.shape
    c = contrib.contiguous()
    y = torch.empty((T, d), dtype=c.dtype, device=c.device)
    if y.numel() == 0:
        return y  # no launch
    dev, code = c.device.index or 0, _DTYPE_CODES[c.dtype]
    aligned = c.data_ptr() % 16 == 0 and y.data_ptr() % 16 == 0
    geo = launch_geometry(T, K, d, c.dtype, aligned)
    fn = _build.entry("moe_combine", "spk_moe_combine", _ARGTYPES)
    _build.check(fn(c.data_ptr(), y.data_ptr(), T, K, d, code,
                    int(geo["vectorized"]), geo["row_blocks"], dev,
                    _build.stream_ptr(c)), "moe_combine launch")
    moe_combine_raw.launches += 1
    return y


#: Launches of the CUDA kernel (the plain version does not count).
moe_combine_raw.launches = 0
