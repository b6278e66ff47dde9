"""Nested containers of tensors, walked as the reference's ``jax.tree``
walks them: dict keys in sorted order, namedtuple fields, list and tuple
items in order; anything else is a leaf.

The optimizers, the train step and the checkpoint manager all take their
leaves in this order, so a gradient norm sums its leaves in the reference's
order and a checkpoint written by either package lists its arrays in the
same order.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple

__all__ = ["flatten", "leaves", "tree_map", "unflatten", "unzip"]


def _children(tree) -> List[Any] | None:
    if isinstance(tree, dict):
        return [tree[k] for k in sorted(tree)]
    if isinstance(tree, (list, tuple)):
        return list(tree)
    return None


def _rebuild(tree, children: list):
    if isinstance(tree, dict):
        return dict(zip(sorted(tree), children))
    if hasattr(tree, "_fields"):            # namedtuple
        return type(tree)(*children)
    return type(tree)(children)


def tree_map(fn: Callable, tree, *rest):
    """``fn`` applied to each leaf of ``tree`` and the subtrees at the same
    path of ``rest`` (which may hold containers there: the reference's
    ``flatten_up_to``)."""
    kids = _children(tree)
    if kids is None:
        return fn(tree, *rest)
    if isinstance(tree, dict):
        keys = sorted(tree)
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in keys}
    return _rebuild(tree, [tree_map(fn, c, *(r[i] for r in rest))
                           for i, c in enumerate(kids)])


def flatten(tree) -> Tuple[list, Any]:
    """(leaves, skeleton): the skeleton is ``tree`` with each leaf replaced
    by its index in ``leaves`` (what ``jax.tree.unflatten(treedef,
    range(n))`` gives)."""
    out: list = []

    def index(leaf):
        out.append(leaf)
        return len(out) - 1
    skeleton = tree_map(index, tree)
    return out, skeleton


def leaves(tree) -> list:
    return flatten(tree)[0]


def unflatten(skeleton, values: list):
    """The inverse of :func:`flatten`."""
    return tree_map(lambda i: values[i], skeleton)


def unzip(tree, n: int) -> tuple:
    """A nested dict whose leaves are n-tuples -> n nested dicts of the
    same keys (what the reference gets with ``jax.tree.map(lambda o: o[i],
    out, is_leaf=lambda x: isinstance(x, tuple))``)."""
    if isinstance(tree, dict):
        parts = {k: unzip(v, n) for k, v in tree.items()}
        return tuple({k: v[i] for k, v in parts.items()} for i in range(n))
    return tuple(tree)
