"""Parameter trees: nested dicts, lists and tuples of tensors, in JAX's order.

The reference keeps parameters and state as JAX pytrees; the port keeps
them as plain nested ``dict``/``list``/``tuple`` containers of tensors.
Where the two packages meet — checkpoint leaves on disk, the leaf names in
delta-frame headers — the port must walk a tree exactly as
``jax.tree_util`` does:

- dict keys in sorted order (JAX sorts them), lists and tuples in order,
  ``None`` an empty node;
- each leaf named by ``jax.tree_util.keystr`` of its path: ``['layers']``
  for a dict key (its ``repr``), ``[0]`` for a position, concatenated.

A leaf is a tensor, a numpy array, a Python or numpy scalar, any other
object with ``__array__`` (a ``jax.Array`` of a reference params tree is
one; JAX is not imported), or an instance of a type given to
:func:`register_leaf_type`. Any other node type (a namedtuple, a set, an
object) raises ``TypeError``: the reference may flatten it in an order
this module cannot know.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple

import numpy as np
import torch

_LEAF_TYPES = (torch.Tensor, np.ndarray, np.generic, bool, int, float,
               complex)
#: Types registered as leaves (:func:`register_leaf_type`).
_EXTRA_LEAF_TYPES: List[type] = []

#: A tree's structure without its leaves: ``("leaf",)``, ``("none",)``,
#: ``("dict", keys, children)``, ``("list", children)`` or
#: ``("tuple", children)``, children being treedefs. Hashable; two trees
#: have equal treedefs exactly when JAX would give them equal ones.
TreeDef = tuple

_END = object()


def _walk(tree, path: str, leaves: List[Any], names: List[str]) -> TreeDef:
    if tree is None:
        return ("none",)
    kind = type(tree)
    if kind is dict:
        keys = tuple(sorted(tree))
        return ("dict", keys, tuple(_walk(tree[k], f"{path}[{k!r}]", leaves,
                                          names) for k in keys))
    if kind in (list, tuple):
        children = tuple(_walk(c, f"{path}[{i}]", leaves, names)
                         for i, c in enumerate(tree))
        return (kind.__name__, children)
    if (isinstance(tree, _LEAF_TYPES) or hasattr(tree, "__array__")
            or isinstance(tree, tuple(_EXTRA_LEAF_TYPES))):
        leaves.append(tree)
        names.append(path)
        return ("leaf",)
    raise TypeError(f"tree node {path or '<root>'} of type {kind.__name__} "
                    f"is not a dict, list, tuple, None or array leaf")


def register_leaf_type(cls: type) -> type:
    """Walk instances of ``cls`` as leaves (a class that holds a tensor
    with more than a tensor's data, such as a parameter's shard and its
    placement); returns ``cls``."""
    if cls not in _EXTRA_LEAF_TYPES:
        _EXTRA_LEAF_TYPES.append(cls)
    return cls


def flatten_with_names(tree) -> Tuple[List[Any], List[str], TreeDef]:
    """``(leaves, names, treedef)``: leaves in JAX's order, each with its
    ``keystr`` name."""
    leaves: List[Any] = []
    names: List[str] = []
    treedef = _walk(tree, "", leaves, names)
    return leaves, names, treedef


def flatten(tree) -> Tuple[List[Any], TreeDef]:
    """``(leaves, treedef)`` in JAX's leaf order."""
    leaves, _, treedef = flatten_with_names(tree)
    return leaves, treedef


def leaves(tree) -> List[Any]:
    return flatten(tree)[0]


def unflatten(treedef: TreeDef, leaves) -> Any:
    """The tree of ``treedef`` with ``leaves`` in JAX's order."""
    it = iter(leaves)

    def build(td):
        kind = td[0]
        if kind == "leaf":
            return next(it)
        if kind == "none":
            return None
        if kind == "dict":
            return {k: build(c) for k, c in zip(td[1], td[2])}
        children = [build(c) for c in td[1]]
        return children if kind == "list" else tuple(children)

    out = build(treedef)
    if next(it, _END) is not _END:
        raise ValueError("more leaves than the treedef has")
    return out


def flatten_up_to(treedef: TreeDef, tree) -> List[Any]:
    """The subtrees of ``tree`` at the leaf positions of ``treedef``, in
    JAX's order (``tree`` has ``treedef``'s structure down to those
    positions; what sits there is returned whole, ``None`` included)."""
    out: List[Any] = []

    def walk(td, node):
        kind = td[0]
        if kind == "leaf":
            out.append(node)
        elif kind == "dict":
            if type(node) is not dict or tuple(sorted(node)) != td[1]:
                raise ValueError(f"expected a dict with keys {td[1]}")
            for k, c in zip(td[1], td[2]):
                walk(c, node[k])
        elif kind in ("list", "tuple"):
            if (type(node) not in (list, tuple)
                    or len(node) != len(td[1])):
                raise ValueError(f"expected a {kind} of {len(td[1])}")
            for c, n in zip(td[1], node):
                walk(c, n)

    walk(treedef, tree)
    return out


def tree_map(fn: Callable[[Any], Any], tree) -> Any:
    leaves_, treedef = flatten(tree)
    return unflatten(treedef, [fn(x) for x in leaves_])


def describe(treedef: TreeDef) -> str:
    """A readable one-line form of a treedef, e.g.
    ``{'a': *, 'b': [*, *]}`` (``*`` a leaf)."""
    kind = treedef[0]
    if kind == "leaf":
        return "*"
    if kind == "none":
        return "None"
    if kind == "dict":
        return "{" + ", ".join(f"{k!r}: {describe(c)}"
                               for k, c in zip(treedef[1], treedef[2])) + "}"
    inner = ", ".join(describe(c) for c in treedef[1])
    return f"[{inner}]" if kind == "list" else f"({inner})"
