"""Nested dict/list parameter trees with JAX's flatten order.

Parameters keep the JAX package's layout: plain nested dicts and lists of
tensors.  ``leaves`` walks them in ``jax.tree_util`` order (dict keys
sorted, lists in order), so leaf ``i`` here is leaf ``i`` there and
interop is a plain copy.
"""
from __future__ import annotations

from typing import Any, Callable, List

import torch


def leaves(tree, is_leaf: Callable = None) -> List[Any]:
    """Leaves in JAX's order; ``is_leaf(node)`` stops the walk at a node
    (as ``jax.tree_util.tree_flatten``'s ``is_leaf``)."""
    if is_leaf is not None and is_leaf(tree):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k], is_leaf)]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in leaves(t, is_leaf)]
    return [tree]


def map(fn: Callable, tree, *rest):
    """``fn`` over matching leaves of trees with the same structure."""
    if isinstance(tree, dict):
        return {k: map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (list, tuple)):
        return _rebuild(tree, [map(fn, t, *(r[i] for r in rest))
                               for i, t in enumerate(tree)])
    return fn(tree, *rest)


def _rebuild(like, items):
    """A list or tuple of ``like``'s type holding ``items``; a NamedTuple
    (a round state) takes them as its fields."""
    if hasattr(like, "_fields"):
        return type(like)(*items)
    return type(like)(items)


def unflatten(like, flat_leaves):
    """Rebuild ``like``'s structure from leaves in ``leaves(like)`` order."""
    it = iter(flat_leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return _rebuild(t, [build(x) for x in t])
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def flatten_rows(tree, lead: int = 1) -> torch.Tensor:
    """(*lead, N) matrix of a tree of leaves with ``lead`` leading axes in
    common.  A one-leaf tree of a contiguous matrix comes back as a view
    (the round's update buffer); several leaves are concatenated."""
    ls = leaves(tree)
    shape = ls[0].shape[:lead]
    if len(ls) == 1:
        return ls[0].reshape(*shape, -1)
    return torch.cat([l.reshape(*shape, -1) for l in ls], dim=-1)


def row_views(flat: torch.Tensor, like):
    """Per-leaf views of the rows of ``flat`` (..., N), shaped like the
    leaves of ``like`` behind the leading axes: no copy."""
    lead = flat.shape[:-1]
    out, off = [], 0
    for l in leaves(like):
        n = l.numel()
        out.append(flat[..., off:off + n].view(*lead, *l.shape))
        off += n
    if off != flat.shape[-1]:
        raise ValueError(f"row width {flat.shape[-1]} != tree size {off}")
    return unflatten(like, out)
