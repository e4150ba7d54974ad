"""Parameter trees: nested dicts and lists of tensors, in the reference's leaf order.

``jax.tree`` flattens a dict by its sorted keys and a list in order; the
optimizer's state and the gradients follow the same order, so the port's
leaves line up with the reference's one for one.
"""

from __future__ import annotations

from typing import Any, Callable, List


def leaves(tree) -> List[Any]:
    """The leaves of ``tree`` in the reference's order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in leaves(t)]
    return [tree]


def unflatten(like, values) -> Any:
    """A tree shaped like ``like`` whose leaves are ``values``, in order."""
    it = iter(values)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            return type(node)(build(t) for t in node)
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("unflatten: more values than leaves")
    return out


def map_tree(fn: Callable, tree) -> Any:
    """``tree`` with ``fn`` applied to every leaf."""
    return unflatten(tree, [fn(x) for x in leaves(tree)])
