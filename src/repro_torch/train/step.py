"""Training-step state the port needs so far: the error-feedback residuals.

The port of ``init_ef_state`` and ``_shard_len`` from
``src/repro/train/step.py``; the publisher of parameter deltas
(``runtime/delta_sync.py``) keeps its residuals in this layout. The plain
and compressed train steps come with the port of the gradient allreduce.
"""
from __future__ import annotations

import torch

from repro_torch import tree as _tree


def _shard_len(size: int, model_shards: int) -> int:
    return -(-size // model_shards)


def init_ef_state(params, n_workers: int, model_shards: int = 1):
    """Error-feedback residuals, one flat fp32 residual per *shard* per leaf,
    each on its leaf's device.

    - ``model_shards == 1`` (DP-only): ``(P, size)`` — one full-length
      residual per data worker.
    - ``model_shards > 1`` (DP×TP): ``(D, T, ceil(size / T))`` — each model
      shard carries only the residual of the slice it owns.
    """
    def zeros(p: torch.Tensor) -> torch.Tensor:
        shape = ((n_workers, p.numel()) if model_shards <= 1 else
                 (n_workers, model_shards, _shard_len(p.numel(),
                                                      model_shards)))
        return torch.zeros(shape, dtype=torch.float32, device=p.device)

    return _tree.tree_map(zeros, params)
