"""Nested-container helpers standing in for ``jax.tree``.

Parameter trees are dicts, tuples, lists and dataclass instances with
tensors at the leaves. Dict keys are visited in sorted order, as
``jax.tree_util`` does, so a tree's leaf order, and with it every flat
packing (core/flatspace.py), is the same in both packages. A dataclass is
visited field by field in declaration order, as a dataclass registered with
``jax.tree_util.register_dataclass`` is (``core/sync.py::BMUFState``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Tuple

Tree = Any


def _is_dataclass(x) -> bool:
    return dataclasses.is_dataclass(x) and not isinstance(x, type)


def leaves(tree: Tree) -> List[Any]:
    if _is_dataclass(tree):
        return [x for f in dataclasses.fields(tree) for x in leaves(getattr(tree, f.name))]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in leaves(t)]
    return [tree]


def leaves_with_path(tree: Tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """``(path, leaf)`` pairs in ``leaves`` order, each path written as
    ``jax.tree_util.tree_flatten_with_path``'s key entries print and the
    JAX package's checkpoint joins them: dict keys and sequence indices as
    themselves, dataclass fields as ``.field`` (a ``GetAttrKey``), joined
    by ``/``. ``None`` is an empty subtree there, so it yields no pair."""
    def join(key: str) -> str:
        return f"{prefix}/{key}" if prefix else key

    if tree is None:
        return []
    if _is_dataclass(tree):
        return [x for f in dataclasses.fields(tree)
                for x in leaves_with_path(getattr(tree, f.name), join("." + f.name))]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves_with_path(tree[k], join(str(k)))]
    if isinstance(tree, (tuple, list)):
        return [x for i, t in enumerate(tree) for x in leaves_with_path(t, join(str(i)))]
    return [(prefix, tree)]


def map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:  # noqa: A001 - jax.tree.map's name
    """Apply ``fn`` leafwise over trees of the same structure."""
    if _is_dataclass(tree):
        return type(tree)(**{f.name: map(fn, getattr(tree, f.name),
                                         *(getattr(r, f.name) for r in rest))
                             for f in dataclasses.fields(tree)})
    if isinstance(tree, dict):
        return {k: map(fn, tree[k], *(r[k] for r in rest)) for k in sorted(tree)}
    if isinstance(tree, (tuple, list)):
        return type(tree)(map(fn, *xs) for xs in zip(tree, *rest))
    return fn(tree, *rest)


def unflatten(template: Tree, flat: List[Any]) -> Tree:
    """Rebuild ``template``'s structure with ``flat`` as its leaves, in order."""
    it = iter(flat)
    out = map(lambda _: next(it), template)
    if next(it, None) is not None:
        raise ValueError("more leaves than the template holds")
    return out
