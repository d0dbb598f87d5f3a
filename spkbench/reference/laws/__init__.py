"""Laws that place nonzeros, one a file: ``laws/<law>.py`` defines
``positions(gen, count, *, m, n, device, **params)``, which draws
``count`` positions of an ``m x n`` matrix and returns their ``(row,
col)`` as int64 tensors. A configuration or traffic file names a law and
its parameters as ``{"law": <law>, ...}``; a new law is a new file."""
from __future__ import annotations

import importlib

import torch


def positions(spec: dict, gen: torch.Generator, count: int, *, m: int,
              n: int, device) -> tuple:
    """``count`` positions of an ``m x n`` matrix drawn by the law
    ``spec["law"]`` with the rest of ``spec`` as its parameters."""
    params = {k: v for k, v in spec.items() if k != "law"}
    law = importlib.import_module(f"spkbench.reference.laws.{spec['law']}")
    return law.positions(gen, count, m=m, n=n, device=device, **params)
