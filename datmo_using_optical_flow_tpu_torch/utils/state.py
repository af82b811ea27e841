"""Carry state across from the JAX package and back.

The pipelines have no weights: their state is the carry.  Pipeline A's is the
track table, the previous velocity grids, the previous frame's pyramid and the
validity flags; GMFA's (pipeline B) is the previous expanded cloud with its
Morton order, the track table, the static occupancy map and the previous
centroids.  :func:`carry_from_numpy` turns a JAX ``StreamCarry``/``StepCarry``/
``GmfaCarry`` that has been through ``jax.device_get`` (nested NamedTuples of
numpy arrays) into the port's carry on a chosen device;
:func:`carry_to_numpy` goes back.  Matching is by
NamedTuple class name and field order, which the two packages share.
"""

from __future__ import annotations

import numpy as np
import torch

from datmo_using_optical_flow_tpu_torch.models.gmfa import GmfaCarry, TrackTableB
from datmo_using_optical_flow_tpu_torch.models.optical_flow_datmo import StepCarry, StreamCarry
from datmo_using_optical_flow_tpu_torch.models.tracker_a import TrackTable

_CARRIES = {cls.__name__: cls
            for cls in (StreamCarry, StepCarry, TrackTable, GmfaCarry, TrackTableB)}


def carry_from_numpy(tree, device: str | torch.device):
    """Nested NamedTuples/tuples of numpy arrays -> the port's carry on ``device``."""
    if hasattr(tree, "_fields"):
        cls = _CARRIES[type(tree).__name__]
        if tuple(cls._fields) != tuple(tree._fields):
            raise ValueError(f"{cls.__name__}: fields {tree._fields} != {cls._fields}")
        return cls(*(carry_from_numpy(leaf, device) for leaf in tree))
    if isinstance(tree, (tuple, list)):
        return tuple(carry_from_numpy(leaf, device) for leaf in tree)
    return torch.as_tensor(np.array(tree), device=device)  # a writable copy


def carry_to_numpy(carry):
    """The port's carry -> the same nesting with numpy arrays as leaves."""
    if hasattr(carry, "_fields"):
        return type(carry)(*(carry_to_numpy(leaf) for leaf in carry))
    if isinstance(carry, (tuple, list)):
        return tuple(carry_to_numpy(leaf) for leaf in carry)
    return carry.detach().cpu().numpy()
