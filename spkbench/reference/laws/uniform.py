"""Every position of the matrix equally likely (``launch/stream_serve.py``'s
``make_matrix``)."""
from __future__ import annotations

import torch


def positions(gen: torch.Generator, count: int, *, m: int, n: int,
              device) -> tuple:
    key = torch.randint(0, m * n, (count,), generator=gen, device=device)
    return key % m, key // m
