"""Distributed SpGEMM (sparse SUMMA) with SpKAdd partial-product reduction.

The port of ``src/repro/core/spgemm.py``. Paper §IV-E / Fig. 5: C = A·B
on a p_r × p_c process grid. Each process gathers A's block-row stripe
along its grid row and B's block-column stripe along its grid column,
multiplies stage by stage, and — the step this paper is about — reduces
the ``num_stages`` sparse partial products with SpKAdd.

The grid is a 2-D ``DeviceMesh`` with dims ``("data", "model")`` (p_r ×
p_c): the two gathers are tiled all-gathers over the mesh's ``model``
group (A, axis 1) and ``data`` group (B, axis 0). Blocks are dense tiles
with sparse contents; partials become ``PaddedCOO`` (``from_dense``) and
are reduced by the engine (``spkadd_run``), whose kernels run on the card.
A stage's product is a plain ``torch.matmul`` in full f32, as the
reference leaves its ``a @ b`` to XLA: TF32 must be off on the card.
"""
from __future__ import annotations

from typing import List, Optional

import torch
import torch.distributed as dist

from repro_torch.core.allreduce import all_gather_flat
from repro_torch.core.engine import spkadd_run
from repro_torch.core.sparse import PaddedCOO, from_dense


def _full_f32_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if a.device.type == "cuda" and (
            torch.backends.cuda.matmul.allow_tf32
            or torch.get_float32_matmul_precision() != "highest"):
        raise RuntimeError("f32 products must not use TF32: set "
                           "torch.backends.cuda.matmul.allow_tf32 = False")
    return torch.matmul(a, b)


def local_summa_stage(a_blk: torch.Tensor, b_blk: torch.Tensor
                      ) -> torch.Tensor:
    """Local multiply of one SUMMA stage (dense tiles, sparse contents)."""
    return _full_f32_matmul(a_blk, b_blk)


def summa_partials(a_stripe: torch.Tensor, b_stripe: torch.Tensor,
                   stages: int, cap: int) -> List[PaddedCOO]:
    """The ``stages`` partial products of one worker: stage ``s``
    multiplies A's column block ``s`` of the ``(m_loc, K)`` stripe by B's
    row block ``s`` of the ``(K, n_loc)`` stripe, each kept as a PaddedCOO
    of capacity ``min(cap, m_loc·n_loc)`` (the heaviest entries if it
    overflows)."""
    m_loc, k_glob = a_stripe.shape
    n_loc = b_stripe.shape[1]
    blk = k_glob // stages
    cap = min(cap, m_loc * n_loc)
    return [from_dense(local_summa_stage(
        a_stripe[:, s * blk:(s + 1) * blk],
        b_stripe[s * blk:(s + 1) * blk, :]), cap=cap)
        for s in range(stages)]


def summa_block(a_stripe: torch.Tensor, b_stripe: torch.Tensor,
                stages: int, *, algorithm: str = "auto",
                partial_cap_per_stage: Optional[int] = None) -> torch.Tensor:
    """One worker's body after the gathers: the stage partials
    (:func:`summa_partials`, capacity ``partial_cap_per_stage`` or the
    whole tile), their SpKAdd reduction with ``algorithm``, and the dense
    ``(m_loc, n_loc)`` block of C."""
    cap = partial_cap_per_stage or a_stripe.shape[0] * b_stripe.shape[1]
    partials = summa_partials(a_stripe, b_stripe, stages, cap)
    return spkadd_run(partials, algorithm=algorithm).to_dense()


def gather_tiled(x: torch.Tensor, group, axis: int) -> torch.Tensor:
    """Every group rank's ``x`` concatenated along ``axis`` in rank order
    (the reference's ``all_gather(..., tiled=True)``)."""
    out = all_gather_flat(x, group).view(
        (dist.get_world_size(group),) + tuple(x.shape))
    return torch.cat(list(out.unbind(0)), dim=axis)


def spgemm_summa(a: torch.Tensor, b: torch.Tensor, mesh, *,
                 algorithm: str = "auto",
                 partial_cap_per_stage: Optional[int] = None) -> torch.Tensor:
    """This rank's block of C = A @ B on a p_r × p_c ``DeviceMesh`` with
    dims ``("data", "model")``: ``a`` and ``b`` are this rank's
    ``(data, model)`` blocks of A and B, and the result is its
    ``(data, model)`` block of C, dense. The partial products are reduced
    with the SpKAdd ``algorithm`` (``"auto"`` lets the engine's dispatch
    pick; explicit names select a family member for A/B comparisons).
    """
    p_c = mesh.size(mesh.mesh_dim_names.index("model"))
    a_stripe = gather_tiled(a, mesh.get_group("model"), axis=1)
    b_stripe = gather_tiled(b, mesh.get_group("data"), axis=0)
    # SUMMA with stationary C: stages = p_c (A's block-cols = B's block-rows)
    return summa_block(a_stripe, b_stripe, p_c, algorithm=algorithm,
                       partial_cap_per_stage=partial_cap_per_stage)


def spgemm_reference(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _full_f32_matmul(a, b)
