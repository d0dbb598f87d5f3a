"""Graph500's Kronecker (R-MAT) law, as the specification's reference
generator (``kronecker_generator.m``) draws it: at each level a position
takes its row bit with probability ``c + d`` and then its column bit with
``d / (c + d)`` or ``b / (a + b)``, and level ``l`` sets bit ``l``.
Graph500 sets ``initiator`` (a, b, c) to (0.57, 0.19, 0.19), d = 1 - a - b
- c. Both sides are powers of two; where one has more bits, its further
levels take the quadrants' marginal alone."""
from __future__ import annotations

from typing import Sequence

import torch

GRAPH500_INITIATOR = (0.57, 0.19, 0.19)


def positions(gen: torch.Generator, count: int, *, m: int, n: int, device,
              initiator: Sequence[float] = GRAPH500_INITIATOR) -> tuple:
    a, b, c = initiator
    ab = a + b
    c_norm, a_norm = c / (1.0 - ab), a / ab
    rbits, cbits = m.bit_length() - 1, n.bit_length() - 1
    if 1 << rbits != m or 1 << cbits != n:
        raise ValueError(f"the Kronecker law needs power-of-two sides, "
                         f"got {m} x {n}")
    row = torch.zeros(count, dtype=torch.int64, device=device)
    col = torch.zeros(count, dtype=torch.int64, device=device)
    for level in range(max(rbits, cbits)):
        if level < min(rbits, cbits):
            ii = torch.rand(count, generator=gen, device=device) > ab
            jj = (torch.rand(count, generator=gen, device=device)
                  > torch.where(ii, c_norm, a_norm))
            row += ii.long() << level
            col += jj.long() << level
        elif level < rbits:
            row += (torch.rand(count, generator=gen, device=device)
                    > ab).long() << level
        else:
            col += (torch.rand(count, generator=gen, device=device)
                    > a + c).long() << level
    return row, col
