"""The production meshes, and the data-parallel and DP x TP meshes.

The port of ``src/repro/launch/mesh.py``: ``DeviceMesh``es with named
dims over the ranks of the running ``torch.distributed`` world, built by
functions so that importing this module touches no process group. A
``DeviceMesh`` needs one rank a device, so the production meshes need
worlds of 256 or 512 ranks; :func:`production_mesh_shape` gives their
names and sizes alone, for spec work without ranks
(``repro_torch.sharding.params`` takes either).
"""
from __future__ import annotations

import math

import torch.distributed as dist

from repro_torch.sharding.api import MeshShape, mesh_axes


def production_mesh_shape(*, multi_pod: bool = False) -> MeshShape:
    """16×16 = 256 chips/pod; 2 pods = 512 chips multi-pod."""
    if multi_pod:
        return MeshShape(("pod", "data", "model"), (2, 16, 16))
    return MeshShape(("data", "model"), (16, 16))


def _device_mesh(device_type: str, shape: MeshShape):
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type, tuple(shape.shape),
                            mesh_dim_names=tuple(shape.axis_names))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """The production mesh over a world of 256 (or 512) ranks."""
    return _device_mesh(device_type,
                        production_mesh_shape(multi_pod=multi_pod))


def make_dp_mesh(n: int | None = None, device_type: str = "cuda"):
    """Pure data-parallel mesh (the sparse-allreduce setting); ``n=None``
    takes every rank of the world."""
    n = n or dist.get_world_size()
    return _device_mesh(device_type, MeshShape(("data",), (n,)))


def make_dp_tp_mesh(data: int | None = None, model: int = 1,
                    device_type: str = "cuda"):
    """('data', 'model') mesh for the sparse-DP × TP composition
    (DESIGN.md §8). ``data=None`` takes every rank of the world divided by
    ``model``; model-dim neighbours are consecutive ranks."""
    n = dist.get_world_size()
    if data is None:
        if n % model:
            raise ValueError(f"{n} ranks do not split into model={model}")
        data = n // model
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} does not match a world of "
                         f"{n}")
    return _device_mesh(device_type, MeshShape(("data", "model"),
                                               (data, model)))


def chips(mesh) -> int:
    return math.prod(mesh_axes(mesh).values())
