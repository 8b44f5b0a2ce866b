"""Nested containers of tensors, flattened in the reference's leaf order.

The reference flattens its pytrees with ``jax.tree``: a dict by its sorted
keys, a list, tuple or NamedTuple by position, anything else is a leaf
(``None`` is an empty node).  The port keeps the same order, so that a
checkpoint's ``leaf_NNNNN.npy`` files and the optimizer's leaf walk line up
with the reference's.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def flatten(tree) -> Tuple[List[Any], Any]:
    """(leaves, structure); :func:`unflatten` inverts it."""
    leaves: List[Any] = []

    def walk(t):
        if t is None:
            return None
        if isinstance(t, dict):
            keys = sorted(t)
            return (dict, keys, [walk(t[k]) for k in keys])
        if isinstance(t, (list, tuple)):
            kind = type(t) if _is_namedtuple(t) else (list if isinstance(t, list) else tuple)
            return (kind, None, [walk(c) for c in t])
        leaves.append(t)
        return "*"

    return leaves, walk(tree)


def unflatten(structure, leaves) -> Any:
    it = iter(leaves)

    def build(s):
        if s is None:
            return None
        if s == "*":
            return next(it)
        kind, keys, children = s
        built = [build(c) for c in children]
        if kind is dict:
            return dict(zip(keys, built))
        if kind in (list, tuple):
            return kind(built)
        return kind(*built)

    out = build(structure)
    if next(it, None) is not None:
        raise ValueError("more leaves than the structure holds")
    return out


def leaves(tree) -> List[Any]:
    return flatten(tree)[0]


def tree_map(fn: Callable, tree, *rest) -> Any:
    """``fn`` applied leaf by leaf to ``tree`` and trees of its structure."""
    flat, structure = flatten(tree)
    others = [flatten(t)[0] for t in rest]
    if any(len(o) != len(flat) for o in others):
        raise ValueError("trees of different structure")
    return unflatten(structure, [fn(*xs) for xs in zip(flat, *others)])
