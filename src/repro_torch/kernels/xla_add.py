"""Elementwise f32 add and subtract with XLA's subnormal rule:
``csrc/xla_add.cu`` and its plain version.

The delta publisher's three passes over every parameter (``cur - prev``,
``grad + residual``, ``corrected - densify(u)``) are adds that the
reference leaves to XLA, which flushes a subnormal input or result to a
zero of its sign. The plain version, :func:`xla_float.add` /
:func:`xla_float.sub`, flushes with a few more passes over each tensor; the
kernel, built with ``-ftz=true``, does the add and the flush in one pass.

:func:`xla_add_raw` takes the plain version for tensors on the CPU and the CUDA
kernel for f32 tensors on the card, and has no other path. Each launch
takes one of two routes, counted in ``xla_add_raw.routes``: ``vector``
(16-byte units) when ``a``, ``b`` and the output are all 16-byte aligned,
else ``scalar`` (one element a unit).
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import _build, xla_float

_P = ctypes.c_void_p
_ARGTYPES = [_P, _P, _P, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
             ctypes.c_int64, ctypes.c_int, _P]
#: The kernel's block (``csrc/xla_add.cu`` ``XA_THREADS``) and its largest
#: grid: 16 blocks an SM of the H100's 132, through which the loop strides.
THREADS = 256
MAX_BLOCKS = 132 * 16
#: f32 elements in a vector route's unit (one float4).
VECTOR = 4


def xla_add_plain(a: torch.Tensor, b: torch.Tensor, *,
                  subtract: bool = False) -> torch.Tensor:
    """Plain version: :func:`xla_float.sub_as` or :func:`xla_float.add_as`
    (f32 through :func:`xla_float.add` / :func:`xla_float.sub`)."""
    return xla_float.sub_as(a, b) if subtract else xla_float.add_as(a, b)


def launch_geometry(n: int, aligned: bool) -> dict:
    """The launch :func:`xla_add_raw` makes for ``n`` elements: its route
    (``vector`` when the three pointers are ``aligned`` to 16 bytes, else
    ``scalar``), its units (float4 groups or elements), the ``tail`` of
    elements past the last float4 (block 0's first threads take them), its
    blocks (none at ``n = 0``: no launch; one block of ``THREADS`` a
    ``THREADS`` units, at most ``MAX_BLOCKS``) and the most units a thread
    takes in its grid-stride loop (``items``)."""
    units = n // VECTOR if aligned else n
    blocks = 0 if n == 0 else min(max(1, -(-units // THREADS)), MAX_BLOCKS)
    return {"route": "vector" if aligned else "scalar", "units": units,
            "unit_elems": VECTOR if aligned else 1,
            "tail": n % VECTOR if aligned else 0, "blocks": blocks,
            "threads": THREADS,
            "items": -(-units // (blocks * THREADS)) if blocks else 0}


def index_spans(n: int, aligned: bool) -> np.ndarray:
    """The kernel's index map, as ``(start, stop)`` element spans, one for
    each (block, loop iteration) that owns units and one for the tail:
    thread ``t`` of block ``k`` owns units ``k * THREADS + t + i * blocks *
    THREADS`` below ``units`` (``i = 0, 1, ...``, its grid-stride loop),
    so at each ``i`` a block's threads cover up to ``THREADS`` consecutive
    units; thread ``t < tail`` of block 0 owns element ``units * 4 + t``."""
    geo = launch_geometry(n, aligned)
    stride = geo["blocks"] * THREADS
    k = np.arange(geo["blocks"], dtype=np.int64)[:, None]
    i = np.arange(geo["items"], dtype=np.int64)[None, :]
    lo = (k * THREADS + i * stride).reshape(-1)
    lo = lo[lo < geo["units"]]
    size = geo["unit_elems"]
    spans = np.stack([lo * size, np.minimum(lo + THREADS, geo["units"])
                      * size], axis=1)
    if geo["tail"]:
        start = geo["units"] * size
        spans = np.concatenate([spans, [[start, start + geo["tail"]]]])
    return spans.reshape(-1, 2)


def _launch(a: torch.Tensor, b: torch.Tensor, out: torch.Tensor, *,
            subtract: bool) -> None:
    """One launch of the kernel on contiguous ``a``, ``b`` and ``out``
    (none at 0 elements), counted with its route."""
    n = a.numel()
    aligned = all(t.data_ptr() % 16 == 0 for t in (a, b, out))
    geo = launch_geometry(n, aligned)
    if geo["blocks"] == 0:
        return  # no launch
    fn = _build.entry("xla_add", "spk_xla_add", _ARGTYPES)
    _build.check(fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), n,
                    int(subtract), int(aligned), geo["blocks"],
                    a.device.index or 0, _build.stream_ptr(a)),
                 "xla_add launch")
    xla_add_raw.launches += 1
    xla_add_raw.routes[geo["route"]] += 1


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
    _launch(a, b, out, subtract=subtract)
    return out


#: Launches of the CUDA kernel (the plain version does not count), and
#: how many took each route.
xla_add_raw.launches = 0
xla_add_raw.routes = {"vector": 0, "scalar": 0}
