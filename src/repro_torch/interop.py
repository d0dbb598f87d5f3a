"""Interop: carry state between the reference and the port as numpy arrays.

The engine's state is ``PaddedCOO`` collections plus the cost-model table
(a JSON file both packages read the same way); the delta-sync and
checkpoint paths carry parameter trees. These helpers turn a PaddedCOO's
leaves, or a parameter tree's, as numpy arrays (or anything ``np.asarray``
takes — a reference PaddedCOO's leaves and a reference params tree
included), into the port's tensors and back, without importing the
reference. Trees keep their structure; leaves go in JAX's leaf order
(:mod:`repro_torch.tree`).
"""
from __future__ import annotations

from typing import Iterable, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch import tree as _tree
from repro_torch.core.sparse import PaddedCOO, resolve_device

#: ``(keys, vals, nnz, shape)`` as numpy arrays — the field order of both
#: packages' PaddedCOO.
NumpyCOO = Tuple[np.ndarray, np.ndarray, np.ndarray, Tuple[int, int]]


def array_to_tensor(a, device) -> torch.Tensor:
    """Anything ``np.asarray`` takes -> a tensor on ``device``, dtype kept.
    bf16 (``ml_dtypes.bfloat16``, which JAX's bf16 arrays give and
    ``torch.as_tensor`` refuses) goes through its uint16 bits, so every bit,
    NaN payloads included, is kept; ``ml_dtypes`` itself is not imported."""
    arr = np.array(a)
    if arr.dtype.name == "bfloat16" and arr.dtype.itemsize == 2:
        return torch.from_numpy(arr.view(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.as_tensor(arr, device=device)


def padded_coo_from_numpy(keys, vals, nnz, shape: Tuple[int, int],
                          device=None) -> PaddedCOO:
    """Leaves -> port PaddedCOO on ``device`` (``None`` = the CUDA card;
    raises without one unless ``device="cpu"``). Keys become int32, nnz an
    int32 tensor; values keep their dtype (bf16 included)."""
    dev = resolve_device(device)
    m, n = (int(s) for s in shape)
    return PaddedCOO(
        keys=torch.as_tensor(np.array(keys, dtype=np.int32), device=dev),
        vals=array_to_tensor(vals, dev),
        nnz=torch.as_tensor(np.array(nnz, dtype=np.int32), device=dev),
        shape=(m, n))


def padded_coo_to_numpy(a: PaddedCOO) -> NumpyCOO:
    """Port PaddedCOO -> ``(keys, vals, nnz, shape)`` numpy leaves."""
    return (a.keys.cpu().numpy(), a.vals.cpu().numpy(), a.nnz.cpu().numpy(),
            tuple(a.shape))


def collection_from_numpy(mats: Iterable[Sequence], device=None
                          ) -> List[PaddedCOO]:
    """A collection of ``(keys, vals, nnz, shape)`` leaf tuples (a list of
    reference PaddedCOOs is one) -> list of port PaddedCOOs."""
    return [padded_coo_from_numpy(*a, device=device) for a in mats]


def collection_to_numpy(mats: Iterable[PaddedCOO]) -> List[NumpyCOO]:
    return [padded_coo_to_numpy(a) for a in mats]


def params_from_numpy(tree, device=None):
    """A params tree (nested dicts, lists, tuples of arrays) -> the same
    tree of tensors on ``device`` (``None`` = the CUDA card; raises without
    one unless ``device="cpu"``), dtypes kept."""
    dev = resolve_device(device)
    return _tree.tree_map(lambda leaf: array_to_tensor(leaf, dev), tree)


def params_to_numpy(tree):
    """A params tree of tensors -> the same tree of numpy arrays."""
    return _tree.tree_map(lambda leaf: leaf.detach().cpu().numpy(), tree)
