"""Nested dicts of tensors as the port's pytrees.

The reference flattens its state with ``jax.tree.flatten``, which visits
a dict's keys in sorted order; :func:`flatten` does the same, so leaf
lists line up with the reference's (the optimizer's global-norm sum, the
checkpoint's ``arr_%05d.npy`` files).  Anything that is not a dict is a
leaf.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple


def flatten(tree) -> Tuple[List[Any], Any]:
    """(leaves in sorted-key order, structure for :func:`unflatten`)."""
    leaves: List[Any] = []

    def visit(node):
        if isinstance(node, dict):
            return {k: visit(node[k]) for k in sorted(node)}
        leaves.append(node)
        return None

    return leaves, visit(tree)


def unflatten(structure, leaves) -> Any:
    """Rebuild a tree of :func:`flatten`'s ``structure`` from ``leaves``."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(v) for k, v in node.items()}
        return next(it)

    out = build(structure)
    if next(it, None) is not None:
        raise ValueError("more leaves than the structure holds")
    return out


def tree_map(fn: Callable, tree, *rest) -> Any:
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def copy_tree_(dst, src, what: str) -> None:
    """Copy ``src``'s tensors into ``dst``'s, in place, every leaf.
    Raises ``ValueError``, before anything is copied, where the trees'
    keys, or a leaf's shape or dtype, differ (nothing is cast); ``what``
    names the tree in the error."""
    pairs = []

    def visit(d, s, path):
        if isinstance(s, dict):
            if d.keys() != s.keys():
                raise ValueError(f"{what} {path or '/'}: keys {sorted(s)} "
                                 f"where the destination has {sorted(d)}")
            for k, v in s.items():
                visit(d[k], v, f"{path}/{k}")
        elif d.shape != s.shape or d.dtype != s.dtype:
            raise ValueError(
                f"{what} {path}: {tuple(s.shape)} {s.dtype} where the "
                f"destination has {tuple(d.shape)} {d.dtype}")
        else:
            pairs.append((d, s))

    visit(dst, src, "")
    for d, s in pairs:
        d.copy_(s)
