"""Leaf-by-leaf operations over nested NamedTuples of tensors (the port's
carries and outputs; JAX's ``tree.map`` over pytrees)."""

from __future__ import annotations

import torch


def _rebuild(like: tuple, leaves):
    """A tuple of ``like``'s type (a NamedTuple or a plain tuple) from ``leaves``."""
    leaves = list(leaves)
    return type(like)(*leaves) if hasattr(like, "_fields") else type(like)(leaves)


def select(pred: torch.Tensor, old, new):
    """``old`` where ``pred`` else ``new``, leaf by leaf."""
    if isinstance(old, tuple):
        return _rebuild(old, (select(pred, o, n) for o, n in zip(old, new)))
    return torch.where(pred, old, new)


def unstack(tree, i: int):
    """Entry ``i`` of every leaf: the ``i``-th of a nested tuple of stacked
    tensors (the inverse of :func:`stack`)."""
    if isinstance(tree, tuple):
        return _rebuild(tree, (unstack(leaf, i) for leaf in tree))
    return tree[i]


def stack(outs: list):
    """Stack a list of equal nested tuples of tensors leaf by leaf."""
    first = outs[0]
    if isinstance(first, tuple):
        return _rebuild(first, (stack(list(leaves)) for leaves in zip(*outs)))
    return torch.stack(outs)
