"""The one home of the private PyTorch APIs the port uses.

The counterpart of ``src/repro/compat.py``. The reference's file has two
roles. Its jax version shims do not carry over, and nothing takes their
place:

- ``shard_map`` and ``axis_size``: the port's collectives are
  ``torch.distributed`` calls on process groups and ``DeviceMesh`` dims,
  whose sizes ``dist.get_world_size(group)`` gives on every torch release.
- ``cost_analysis_dict``: torch compiles nothing to ask; the port counts
  what a step dispatches (``launch/hlo_analysis.py``).
- ``backend_initialized``: the dry-run's guard is that no default process
  group exists yet (``launch/dryrun.py``).

Its other role does carry over: private APIs move between releases, so
every module of the port that needs one imports it from here (spkaddlint's
SPK102 in ``repro_torch.analysis``), and a release that moves one is a
one-file problem. Each re-export raises an ``ImportError`` naming what
is missing when the torch at hand lacks it.
"""
from __future__ import annotations


def _missing(what: str, err: ImportError) -> ImportError:
    import torch

    return ImportError(f"{what} is not available in torch {torch.__version__} "
                       f"({err}); the port's fake-tensor dry-run and cost "
                       f"analysis need it")


def fake_tensor_mode():
    """``torch._subclasses.fake_tensor.FakeTensorMode``: tensors with a
    shape, a dtype and a device that allocate nothing."""
    try:
        from torch._subclasses.fake_tensor import FakeTensorMode
    except ImportError as e:
        raise _missing("FakeTensorMode", e) from None
    return FakeTensorMode


def fake_store():
    """``torch.testing._internal.distributed.fake_pg.FakeStore``: the store
    of a ``"fake"`` process group, whose collectives move nothing, so one
    process can stand for one rank of a world of any size."""
    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:
        raise _missing("the fake process group", e) from None
    return FakeStore


def torch_dispatch_mode():
    """``torch.utils._python_dispatch.TorchDispatchMode``: sees every ATen
    operation below autograd (forward, backward and collectives alike)."""
    try:
        from torch.utils._python_dispatch import TorchDispatchMode
    except ImportError as e:
        raise _missing("TorchDispatchMode", e) from None
    return TorchDispatchMode

