"""Reductions and small products in one fixed order of float32 operations.

torch's reductions, matrix products and scatter-adds pick their order by
device (cuBLAS and atomics on the card, vectorised loops on the CPU), so the
same step rounds differently on the two.  Where a step feeds a threshold
(ICP's correspondence gate) or a chain of frames (the track table), these
helpers keep the card's run equal to the CPU's bit for bit: every value is
one elementwise operation at a time, in an order fixed by the shapes.
"""

from __future__ import annotations

import torch

# the once-rounded float32 operations (K7 on the card, float64 forms on the
# CPU; both give the same bits) are the kernels' module's, named here too,
# with the plain version of the sum of squares of a difference
from datmo_using_optical_flow_tpu_torch.ops.round_kernels import (  # noqa: F401
    fma32, norm_rn, sqrt_rn, sumsq_diff_reference, sumsq_fma)


def tree_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over dim 0 by a fixed pairwise tree (zero-padded to a power of two)."""
    n = x.shape[0]
    size = 1 << max(0, (n - 1).bit_length())
    if size != n:
        x = torch.cat([x, x.new_zeros((size - n,) + tuple(x.shape[1:]))])
    while x.shape[0] > 1:
        half = x.shape[0] // 2
        x = x[:half] + x[half:]
    return x[0]


def segment_sum(x: torch.Tensor, segments: torch.Tensor, k: int) -> torch.Tensor:
    """(k, ...) sums of the rows of ``x`` by segment id in [0, k); other ids
    are dropped.  A tree sum over a one-hot expansion: (N, k, ...) memory."""
    onehot = segments[:, None] == torch.arange(k, device=x.device)
    shape = (x.shape[0], k) + (1,) * (x.ndim - 1)
    return tree_sum(torch.where(onehot.reshape(shape), x[:, None], 0.0))


def matmul_terms(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` (batched by broadcasting) for small inner sizes, summed term
    by term left to right."""
    out = a[..., :, 0:1] * b[..., 0:1, :]
    for j in range(1, a.shape[-1]):
        out = out + a[..., :, j:j + 1] * b[..., j:j + 1, :]
    return out


def inv2(m: torch.Tensor) -> torch.Tensor:
    """Inverse of (..., 2, 2) matrices by the adjugate."""
    a, b, c, d = m[..., 0, 0], m[..., 0, 1], m[..., 1, 0], m[..., 1, 1]
    det = a * d - b * c
    adj = torch.stack([torch.stack([d, -b], -1), torch.stack([-c, a], -1)], -2)
    return adj / det[..., None, None]
