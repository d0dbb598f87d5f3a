"""SPKJ204: static shared-memory budget of the partitioned launches.

The counterpart of ``src/repro/analysis/vmem.py``. The estimator re-uses
the runtime's own working-set formula
(:func:`repro_torch.kernels.ops.fold_working_set_bytes`) on the geometry
the runtime's own chooser would pick
(:func:`~repro_torch.kernels.ops.partitioned_launch_geometry` at the
budget ``engine`` passes it, ``ops.device_smem_budget``), then compares
against a per-backend hard cap — so the static proof and the runtime
budget cannot drift apart. The port runs one fold (the reference's
``_partition_fold`` choice is gone), so its working set is the ``sort``
fold's: the tile and two in-flight chunks.

The caps (:func:`backend_cap`):

- ``cuda``: one thread block's opt-in shared memory on the card
  (``torch.cuda.get_device_properties(...).shared_memory_per_block_optin``;
  232,448 B on NVIDIA H100 80GB HBM3), which also bounds the budget
  ``kernels/_build.max_dynamic_smem`` gives the chooser;
- ``cpu``: the reference's 16 MiB VMEM cap, which the port's CPU geometry
  mirrors (``ops.REFERENCE_VMEM_BUDGET``).
"""
from __future__ import annotations

from typing import Dict, List, Optional

from repro_torch.analysis.findings import Finding

CPU_CAP = 16 * 1024 * 1024

DEFAULT_BACKEND = "cpu"


def backend_cap(backend: str) -> int:
    """The hard per-block cap (bytes) of ``backend`` (``cpu`` or
    ``cuda``: the current card's)."""
    if backend == "cpu":
        return CPU_CAP
    if backend != "cuda":
        raise ValueError(f"no shared-memory cap for backend {backend!r}")
    import torch

    dev = torch.cuda.current_device()
    return int(torch.cuda.get_device_properties(dev)
               .shared_memory_per_block_optin)


def runtime_budget(backend: str) -> int:
    """The budget the engine sizes tiles to on ``backend``
    (``ops.device_smem_budget``)."""
    from repro_torch.kernels.ops import device_smem_budget

    return device_smem_budget(backend)


def working_set_bytes(*, part_elems: int, chunk: int) -> int:
    """Working set of one grid step at a given geometry — delegates to
    the runtime's single formula (the port's one fold)."""
    from repro_torch.kernels.ops import fold_working_set_bytes
    return fold_working_set_bytes("sort", tile_elems=part_elems, chunk=chunk)


def check_launch(*, cap: int, m: int, n: int,
                 smem_budget_bytes: Optional[int] = None,
                 part_elems: Optional[int] = None,
                 chunk: Optional[int] = None,
                 backend: str = DEFAULT_BACKEND,
                 label: str = "") -> List[Finding]:
    """Prove one launch geometry fits the backend cap.

    With no explicit ``part_elems``/``chunk`` this checks the geometry the
    engine would actually launch for a ``cap``-long stream on an (m, n)
    accumulator at ``smem_budget_bytes`` (default: the backend's runtime
    budget); explicit overrides let tests (and the CLI) probe deliberately
    overspilled geometries.
    """
    from repro_torch.kernels.ops import partitioned_launch_geometry

    budget = (runtime_budget(backend) if smem_budget_bytes is None
              else smem_budget_bytes)
    geom = partitioned_launch_geometry(
        cap, m=m, n=n, part_elems=part_elems, smem_budget_bytes=budget,
        chunk=chunk)
    ws = working_set_bytes(part_elems=geom.part_elems, chunk=geom.chunk)
    cap_bytes = backend_cap(backend)
    where = label or f"cap={cap},m={m},n={n},budget={budget}"
    if ws > cap_bytes:
        return [Finding(
            "SPKJ204", f"<smem:{where}>", 0,
            f"launch working set {ws} B (part_elems={geom.part_elems}, "
            f"chunk={geom.chunk}) exceeds the {backend} cap {cap_bytes} B",
            "shrink part_elems/chunk (or lower smem_budget_bytes so "
            "partitioned_launch_geometry re-tiles) until "
            "fold_working_set_bytes fits the cap")]
    return []


#: (cap, m, n, budget) sweep proved on every run: the engine's defaults
#: and a tight budget, each over both shapes. A budget is never taken
#: above the backend's runtime budget: the engine never passes more.
DEFAULT_MATRIX: List[Dict[str, int]] = [
    {"cap": 4096, "m": 64, "n": 8},
    {"cap": 4096, "m": 64, "n": 8, "smem_budget_bytes": 1 << 16},
    {"cap": 1 << 16, "m": 1024, "n": 512},
    {"cap": 1 << 16, "m": 1024, "n": 512, "smem_budget_bytes": 1 << 20},
]


def check_all(backend: str = DEFAULT_BACKEND) -> List[Finding]:
    findings: List[Finding] = []
    top = runtime_budget(backend)
    for spec in DEFAULT_MATRIX:
        spec = dict(spec)
        spec["smem_budget_bytes"] = min(spec.get("smem_budget_bytes", top),
                                        top)
        findings.extend(check_launch(backend=backend, **spec))
    return findings
