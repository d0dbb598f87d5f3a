"""Elementwise f32 add and subtract with XLA's subnormal rule:
``csrc/xla_add.cu`` and its plain version.

The delta publisher's three passes over every parameter (``cur - prev``,
``grad + residual``, ``corrected - densify(u)``) are adds that the
reference leaves to XLA, which flushes a subnormal input or result to a
zero of its sign. The plain version, :func:`xla_float.add` /
:func:`xla_float.sub`, flushes with a few more passes over each tensor; the
kernel, built with ``-ftz=true``, does the add and the flush in one pass.

:func:`xla_add_raw` takes the plain version for tensors on the CPU and the CUDA
kernel for f32 tensors on the card, and has no other path.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, xla_float

_P = ctypes.c_void_p
_ARGTYPES = [_P, _P, _P, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, _P]


def xla_add_plain(a: torch.Tensor, b: torch.Tensor, *,
                  subtract: bool = False) -> torch.Tensor:
    """Plain version: :func:`xla_float.sub_as` or :func:`xla_float.add_as`
    (f32 through :func:`xla_float.add` / :func:`xla_float.sub`)."""
    return xla_float.sub_as(a, b) if subtract else xla_float.add_as(a, b)


def xla_add_raw(a: torch.Tensor, b: torch.Tensor, *,
            subtract: bool = False) -> torch.Tensor:
    """``a - b`` if ``subtract`` else ``a + b``, as XLA computes it: a
    subnormal input or result is a zero of its sign. ``a`` and ``b`` have
    one shape; on the card both are f32."""
    if a.shape != b.shape:
        raise ValueError(f"xla_add_raw: shapes differ: {tuple(a.shape)} vs "
                         f"{tuple(b.shape)}")
    if a.device.type == "cpu" and b.device.type == "cpu":
        return xla_add_plain(a, b, subtract=subtract)
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError(f"xla_add_raw: unsupported devices {a.device} / "
                         f"{b.device}")
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        raise TypeError(f"xla_add kernel takes f32, got {a.dtype} / "
                        f"{b.dtype}")
    a, b = a.contiguous(), b.contiguous()
    out = torch.empty_like(a)
    if a.numel() == 0:
        return out  # no launch
    aligned = all(t.data_ptr() % 16 == 0 for t in (a, b, out))
    fn = _build.entry("xla_add", "spk_xla_add", _ARGTYPES)
    _build.check(fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), a.numel(),
                    int(subtract), int(aligned), a.device.index or 0,
                    _build.stream_ptr(a)), "xla_add launch")
    xla_add_raw.launches += 1
    return out


#: Launches of the CUDA kernel (the plain version does not count).
xla_add_raw.launches = 0
