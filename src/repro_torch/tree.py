"""Parameter trees: nested dicts and lists with tensor (or array) leaves
— the port's counterpart of JAX pytrees, in the reference's layout.

Leaves are visited in a fixed order: dict keys sorted, lists in order
(``jax.tree_util`` order for the same tree).
"""
from __future__ import annotations

from typing import Any, Callable, List


def tree_leaves(tree) -> List[Any]:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in tree_leaves(t)]
    return [tree]


def tree_map(f: Callable, tree, *rest):
    """``f`` over corresponding leaves of trees with one structure, in
    :func:`tree_leaves` order."""
    if isinstance(tree, dict):
        return {k: tree_map(f, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(f, t, *(r[i] for r in rest))
                          for i, t in enumerate(tree))
    return f(tree, *rest)


def tree_unflatten(template, leaves: List[Any]):
    """Rebuild ``template``'s structure from ``leaves`` (as produced by
    :func:`tree_leaves` on a tree of that structure)."""
    it = iter(leaves)
    out = tree_map(lambda _: next(it), template)
    if next(it, None) is not None:
        raise ValueError("more leaves than the template holds")
    return out


def tree_add(acc, tree):
    """``tree`` added leaf by leaf onto ``acc``; ``acc=None`` starts the
    sum (gradients and metrics accumulated over chunks, in order)."""
    return tree if acc is None else tree_map(lambda a, b: a + b, acc, tree)


def stack_draws(draw: Callable[[], Any], n: int):
    """``tree_map(torch.stack, *[draw() for _ in range(n)])`` holding one
    draw at a time: every leaf is allocated once at ``(n, ...)`` and
    filled draw by draw (one draw is a view, not a copy; ``n = 0`` still
    draws once, for the shapes).  At full width a model's stacked heads
    would otherwise need twice their memory while they are stacked."""
    first = draw()
    if n == 1:
        return tree_map(lambda a: a[None], first)
    out = tree_map(lambda a: a.new_empty((n,) + tuple(a.shape)), first)
    for i in range(n):
        tree, first = (first if i == 0 else draw()), None
        for dst, src in zip(tree_leaves(out), tree_leaves(tree)):
            dst[i].copy_(src)
        del tree
    return out
