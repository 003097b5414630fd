"""Nested-container helpers standing in for ``jax.tree``.

Parameter trees are dicts, tuples and lists with tensors at the leaves. Dict
keys are visited in sorted order, as ``jax.tree_util`` does, so a tree's leaf
order, and with it every flat packing (core/flatspace.py), is the same in
both packages.
"""
from __future__ import annotations

from typing import Any, Callable, List

Tree = Any


def leaves(tree: Tree) -> List[Any]:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in leaves(t)]
    return [tree]


def map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:  # noqa: A001 - jax.tree.map's name
    """Apply ``fn`` leafwise over trees of the same structure."""
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
