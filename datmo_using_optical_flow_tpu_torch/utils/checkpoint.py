"""Checkpoint and resume of a streaming carry, the counterpart of
``datmo_using_optical_flow_tpu.utils.checkpoint`` for ``.npz`` files.

One entry per leaf, keyed ``"leaf" + path`` as ``jax.tree_util.keystr``
writes it (``leaf.step.table.alive``, ``leaf.pyr[0]``), plus ``step`` and
``n``; so an archive written by the JAX package restores into the port's
carry and the other way round.  A leaf missing from the archive (a field
added after it was written) keeps the template's value; positional archives
(``leaf_<i>``) load where the shape matches.  The JAX package's orbax
directories are not read here.
"""

from __future__ import annotations

import numpy as np
import torch


def _leaves_with_paths(tree, path: str = "") -> list[tuple[str, torch.Tensor]]:
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [leaf for name, item in zip(tree._fields, tree)
                for leaf in _leaves_with_paths(item, f"{path}.{name}")]
    if isinstance(tree, (tuple, list)):
        return [leaf for i, item in enumerate(tree)
                for leaf in _leaves_with_paths(item, f"{path}[{i}]")]
    return [(path, tree)]


def _replace(tree, leaves):
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_replace(item, leaves) for item in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_replace(item, leaves) for item in tree)
    return next(leaves)


def _check_npz(path: str) -> None:
    if not path.endswith(".npz"):
        raise ValueError(f"checkpoint path must end in .npz, got {path!r}")


def save_checkpoint(path: str, carry, step: int = 0) -> None:
    """Snapshot a carry (nested NamedTuples of tensors) to the ``.npz`` ``path``."""
    _check_npz(path)
    leaves = _leaves_with_paths(carry)
    np.savez(path, step=step, n=len(leaves),
             **{"leaf" + p: x.detach().cpu().numpy() for p, x in leaves})


def load_checkpoint(path: str, like):
    """Restore a carry with the structure, dtypes and device of ``like``."""
    _check_npz(path)
    restored = []
    with np.load(path) as data:
        for i, (p, x) in enumerate(_leaves_with_paths(like)):
            key = "leaf" + p
            if key in data:
                val = torch.as_tensor(np.array(data[key]))
            elif f"leaf_{i}" in data and data[f"leaf_{i}"].shape == tuple(x.shape):
                val = torch.as_tensor(np.array(data[f"leaf_{i}"]))
            else:
                val = x
            restored.append(val.to(dtype=x.dtype, device=x.device))
    return _replace(like, iter(restored))
