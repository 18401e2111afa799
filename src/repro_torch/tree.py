"""Nested dict/list parameter trees — the port's stand-in for JAX
pytrees. Leaves are tensors (or anything not a dict/list/tuple)."""
from __future__ import annotations


def tree_map(fn, tree, *rest):
    """Apply ``fn`` leaf-wise over ``tree`` and structurally equal
    ``rest`` trees, rebuilding the same nesting."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """Leaves in the order ``tree_map`` visits them."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_unflatten(template, leaves):
    """The leaves (in ``tree_leaves`` order) back in ``template``'s
    nesting."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), template)
