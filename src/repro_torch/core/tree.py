"""Nested dicts of tensors as the port's parameter trees.

The reference's parameters are JAX pytrees of dicts, which flatten in
sorted-key order; these helpers walk the port's nested dicts in the same
order, so leaf ``i`` here is leaf ``i`` there (per-leaf seeds and
per-leaf formats key on that index).  A leaf's path is the tuple of its
keys, e.g. ``("layers", "attn", "wq")``.
"""

from __future__ import annotations

from typing import Any, Callable, List, Mapping, Tuple


def leaves_with_path(tree, path: Tuple[str, ...] = ()) -> List[Tuple[Tuple[str, ...], Any]]:
    """``[(path, leaf), ...]`` in sorted-key depth-first order."""
    if isinstance(tree, Mapping):
        out = []
        for k in sorted(tree):
            out += leaves_with_path(tree[k], path + (k,))
        return out
    return [(path, tree)]


def leaves(tree) -> list:
    return [leaf for _, leaf in leaves_with_path(tree)]


def map_tree(fn: Callable, tree, *rest):
    """``fn`` applied leaf by leaf over trees of the same structure."""
    if isinstance(tree, Mapping):
        return {k: map_tree(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    return fn(tree, *rest)


def from_leaves(tree, new_leaves: list):
    """A tree shaped like ``tree`` holding ``new_leaves`` (in the order of
    :func:`leaves_with_path`)."""
    it = iter(new_leaves)

    def build(node):
        if isinstance(node, Mapping):
            return {k: build(node[k]) for k in sorted(node)}
        return next(it)

    out = build(tree)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree has")
    return out
