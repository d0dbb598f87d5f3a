"""AdamW with decoupled weight decay, global-norm clipping, cosine schedule.

The port of ``src/repro/optim/adamw.py``: plain functions on parameter
trees (nested dicts, lists and tuples of tensors, walked in JAX's leaf
order by :mod:`repro_torch.tree`). Moments are fp32 on each leaf's device,
whatever the parameter's type.

The arithmetic is the reference's, expression for expression: the global
norm sums the leaves' squared sums in leaf order from 0, ``b1 ** step`` is
taken in f32, a leaf with ``ndim < 2`` gets no decay, and each new
parameter is cast back to its type (bf16 by XLA's rounding). Every float
operation flushes a subnormal input or result to a zero of its sign, as
XLA does (:func:`repro_torch.kernels.xla_float.flush`), and a division by
a constant is a product with its f32 reciprocal, as XLA compiles it. What
still differs from the reference is the order of each leaf's sum, the last
bit of ``pow``, ``cos`` and ``sqrt``, and the multiply-adds XLA fuses: the
port holds the reference to a stated tolerance, not bitwise.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch import tree as _tree
from repro_torch.kernels import xla_float


def _f(x):
    """XLA's flush of a subnormal f32 result (a Python number, which the
    reference also keeps in double until it meets an array, passes)."""
    return xla_float.flush(x) if isinstance(x, torch.Tensor) else x


class AdamWState(NamedTuple):
    step: torch.Tensor  # int32, 0-d
    mu: Any             # tree of fp32 first moments
    nu: Any             # tree of fp32 second moments


def adamw_init(params) -> AdamWState:
    """Zero moments, fp32, each on its leaf's device; ``step`` 0 (int32)
    on the first leaf's device."""
    leaves = _tree.leaves(params)
    dev = leaves[0].device if leaves else torch.device("cpu")

    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      mu=_tree.tree_map(zeros, params),
                      nu=_tree.tree_map(zeros, params))


def _div(num: float, den: torch.Tensor) -> torch.Tensor:
    """``num / den`` as one f32 division (``num / tensor`` in PyTorch is a
    reciprocal and a product, whose last bit can differ)."""
    return _f(torch.div(den.new_tensor(num), den))


def clip_by_global_norm(grads, max_norm: float):
    """(grads as fp32 scaled to a global norm of at most ``max_norm``, the
    global norm before scaling)."""
    total = 0
    for g in _tree.leaves(grads):
        g32 = _f(g.to(torch.float32))
        total = _f(total + _f(torch.sum(_f(g32 * g32))))
    gn = torch.sqrt(torch.as_tensor(total, dtype=torch.float32))
    scale = torch.clamp(_div(max_norm, torch.clamp(gn, min=1e-9)), max=1.0)
    return (_tree.tree_map(lambda g: _f(_f(g.to(torch.float32)) * scale),
                           grads), gn)


def cosine_schedule(step: torch.Tensor, *, peak_lr: float, warmup: int,
                    total: int, floor: float = 0.1) -> torch.Tensor:
    """Linear warmup to ``peak_lr``, then a cosine decay to
    ``floor * peak_lr`` at ``total``; ``step`` an integer tensor, the rate
    an f32 tensor on its device."""
    step = step.to(torch.float32)
    # XLA divides by a constant as a product with its f32 reciprocal, and
    # folds ``peak_lr`` into that constant
    warm = _f(step * float(np.float32(peak_lr)
                           * np.float32(xla_float.reciprocal(max(1, warmup)))))
    frac = torch.clamp(xla_float.div_const(_f(step - warmup),
                                           max(1, total - warmup)), 0.0, 1.0)
    cos = peak_lr * _f(floor + _f((1 - floor) * 0.5 * _f(
        1 + _f(torch.cos(_f(math.pi * frac))))))
    return torch.where(step < warmup, warm, _f(cos))


def adamw_update(params, grads, state: AdamWState, *, lr,
                 b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1, max_grad_norm: float = 1.0):
    """One AdamW step: ``(new params, new state, global grad norm)``.
    ``lr`` is a float or an f32 0-d tensor (:func:`cosine_schedule`)."""
    grads, gnorm = clip_by_global_norm(grads, max_grad_norm)
    step = state.step + 1
    bc1 = _f(1 - _f(b1 ** step.to(torch.float32)))
    bc2 = _f(1 - _f(b2 ** step.to(torch.float32)))

    def upd(p, g, m, v):
        m = _f(_f(b1 * m) + _f((1 - b1) * g))
        v = _f(_f(b2 * v) + _f((1 - b2) * _f(g * g)))
        mhat = _f(m / bc1)
        vhat = _f(v / bc2)
        delta = _f(mhat / _f(torch.sqrt(vhat) + eps))
        decay = weight_decay if p.dim() >= 2 else 0.0  # no decay on norms/bias
        new_p = _f(_f(_f(p.to(torch.float32)) * _f(1 - lr * decay))
                   - _f(lr * delta))
        if p.dtype == torch.bfloat16:
            return xla_float.round_bf16(new_p), m, v
        return new_p.to(p.dtype), m, v

    p_flat, treedef = _tree.flatten(params)
    g_flat = _tree.leaves(grads)
    m_flat = _tree.leaves(state.mu)
    v_flat = _tree.leaves(state.nu)
    out = [upd(p, g, m, v) for p, g, m, v in zip(p_flat, g_flat, m_flat,
                                                 v_flat)]
    new_params = _tree.unflatten(treedef, [o[0] for o in out])
    new_mu = _tree.unflatten(treedef, [o[1] for o in out])
    new_nu = _tree.unflatten(treedef, [o[2] for o in out])
    return new_params, AdamWState(step=step, mu=new_mu, nu=new_nu), gnorm
