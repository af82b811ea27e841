"""Leaf-by-leaf operations over nested NamedTuples of tensors (the port's
carries and outputs; JAX's ``tree.map`` over pytrees)."""

from __future__ import annotations

import torch


def select(pred: torch.Tensor, old, new):
    """``old`` where ``pred`` else ``new``, leaf by leaf."""
    if isinstance(old, tuple):
        return type(old)(*(select(pred, o, n) for o, n in zip(old, new)))
    return torch.where(pred, old, new)


def stack(outs: list):
    """Stack a list of equal nested NamedTuples leaf by leaf."""
    first = outs[0]
    if isinstance(first, tuple):
        return type(first)(*(stack(list(leaves)) for leaves in zip(*outs)))
    return torch.stack(outs)
