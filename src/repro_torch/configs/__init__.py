"""Assigned-architecture configs, the port's copies of ``src/repro/configs``.

``get_config(arch_id)`` returns the FULL config; ``get_smoke_config(arch_id)``
a reduced same-family config for CPU smoke tests. The ten config files are
data, field for field the reference's; ``repro_torch.models.build_model``
builds every one.
``long_500k`` applicability is recorded per arch (``SHAPE_SKIPS``).
"""
from __future__ import annotations

import importlib

ARCHS = [
    "moonshot_v1_16b_a3b",
    "llama4_scout_17b_a16e",
    "stablelm_3b",
    "internlm2_1_8b",
    "smollm_135m",
    "gemma3_27b",
    "whisper_medium",
    "zamba2_2_7b",
    "mamba2_370m",
    "qwen2_vl_72b",
]

_ALIASES = {a.replace("_", "-"): a for a in ARCHS}


def canonical(arch_id: str) -> str:
    key = arch_id.replace("-", "_").replace(".", "_")
    if key in ARCHS:
        return key
    if arch_id in _ALIASES:
        return _ALIASES[arch_id]
    raise KeyError(f"unknown arch {arch_id!r}; known: {ARCHS}")


def _module(arch_id: str):
    return importlib.import_module(f"repro_torch.configs.{canonical(arch_id)}")


def get_config(arch_id: str):
    return _module(arch_id).CONFIG


def get_smoke_config(arch_id: str):
    return _module(arch_id).SMOKE


def supports_shape(arch_id: str, shape_name: str) -> bool:
    """long_500k only for sub-quadratic archs; decode only for decoders."""
    mod = _module(arch_id)
    skips = getattr(mod, "SHAPE_SKIPS", ())
    return shape_name not in skips


def all_cells():
    """Every assigned (arch, shape) cell with its skip status."""
    from repro_torch.models.common import SHAPES
    cells = []
    for a in ARCHS:
        for s in SHAPES:
            cells.append((a, s, supports_shape(a, s)))
    return cells
