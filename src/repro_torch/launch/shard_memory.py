"""Reckon each rank's bytes of f32 parameters and AdamW moments under the
FSDP×TP specs, for every config at full depth on the production meshes.

    PYTHONPATH=src python -m repro_torch.launch.shard_memory

The trees are fake tensors (shapes and dtypes, nothing drawn), and the
specs come from :func:`repro_torch.sharding.params.param_spec` on the
meshes' names and sizes (``launch.mesh.production_mesh_shape``): a rank's
share of a leaf is its size over the product of the mesh axes its spec
names. This is arithmetic from the specs, not a measurement: activations,
gradients, the compute copy and allocator slack are not in it.
"""
from __future__ import annotations

import argparse
import math

from repro_torch import tree as _tree
from repro_torch.configs import ARCHS, get_config
from repro_torch.launch.mesh import production_mesh_shape
from repro_torch.sharding.api import mesh_axes
from repro_torch.sharding.params import param_spec

#: f32 parameters plus AdamW's two f32 moments, a parameter.
STATE_BYTES = 3 * 4


def per_rank_elements(params, mesh) -> int:
    """The parameters one rank holds under ``params_shardings`` (every
    spec divides evenly, so every rank holds as many)."""
    sizes = mesh_axes(mesh)
    total = 0
    leaves, names, _ = _tree.flatten_with_names(params)
    for name, leaf in zip(names, leaves):
        split = 1
        for entry in param_spec(name, leaf, mesh):
            axes = (() if entry is None else (entry,)
                    if isinstance(entry, str) else entry)
            split *= math.prod(sizes[a] for a in axes)
        total += leaf.numel() // split
    return total


def fake_params(arch: str):
    from repro_torch.compat import fake_tensor_mode
    from repro_torch.models import build_model

    model = build_model(get_config(arch))
    with fake_tensor_mode()():
        return model.init(0, device="cpu")


def main(argv=None) -> int:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args(
        argv)
    meshes = {"16x16": production_mesh_shape(),
              "2x16x16": production_mesh_shape(multi_pod=True)}
    print("| config | parameters | "
          + " | ".join(f"{m}: GB a rank (x an even split)" for m in meshes)
          + " |")
    print("|---|---|" + "---|" * len(meshes))
    for arch in ARCHS:
        params = fake_params(arch)
        n = sum(x.numel() for x in _tree.leaves(params))
        cells = []
        for mesh in meshes.values():
            local = per_rank_elements(params, mesh)
            ideal = n / math.prod(mesh_axes(mesh).values())
            cells.append(f"{local * STATE_BYTES / 1e9:.3f} "
                         f"({local / ideal:.2f}x)")
        print(f"| {arch} | {n:,} | " + " | ".join(cells) + " |")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
