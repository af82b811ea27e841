"""RANSAC ground-plane segmentation, the counterpart of
``datmo_using_optical_flow_tpu.ops.ransac`` (Open3D's ``segment_plane`` with
``distance_threshold=0.5, ransac_n=5, num_iterations=5000`` in the reference,
``Optical_flow/main.py:73``).

All hypotheses are sampled and scored at once, with no early exit: each is the
least-squares plane (centroid and smallest covariance eigenvector) of
``ransac_n`` points drawn with :func:`utils.prng.uniform` from the same key as
the JAX package, so the sampled indices are the JAX package's; the plane with
the most inliers (the first, on ties) is refitted on its inlier set.

Where the JAX package calls ``jnp.linalg.eigh`` (LAPACK on the CPU), the
smallest eigenvector here comes from fixed cyclic Jacobi sweeps written in
elementwise float32 operations (+, *, /, the correctly rounded square root):
cuSOLVER on the card would round differently from the CPU and read its error
flag on the host.  Sums run in a fixed order and distances are
``|((x * a + y * b) + z * c) + d|`` elementwise (a matrix product's summation
order is the library's), so the card computes what the CPU computes, bit for
bit.  Against the JAX package the planes agree to float32 rounding, and an
inlier count can differ at points within rounding of the threshold.
"""

from __future__ import annotations

import torch

from datmo_using_optical_flow_tpu_torch.utils import prng
from datmo_using_optical_flow_tpu_torch.utils.ordered import matmul_terms, sqrt_rn, tree_sum

JACOBI_SWEEPS = 4
SCORE_CHUNK = 256  # planes per scoring pass: a (N, 256) slab
_PAIRS = ((0, 1), (0, 2), (1, 2))


def _rotation(c: torch.Tensor, s: torch.Tensor, p: int, q: int) -> torch.Tensor:
    """(..., 3, 3) Jacobi rotation J: identity but J[p,p] = J[q,q] = c,
    J[p,q] = s, J[q,p] = -s."""
    one, zero = torch.ones_like(c), torch.zeros_like(c)
    entries = [[one, zero, zero], [zero, one, zero], [zero, zero, one]]
    entries[p][p], entries[q][q], entries[p][q], entries[q][p] = c, c, s, -s
    return torch.stack([torch.stack(row, -1) for row in entries], -2)


def smallest_eigenvector(cov: torch.Tensor) -> torch.Tensor:
    """Unit eigenvector of the smallest eigenvalue of each symmetric (..., 3, 3)
    matrix, by ``JACOBI_SWEEPS`` cyclic Jacobi sweeps: each rotation J zeroes one
    off-diagonal entry, A <- J^T A J and V <- V J.  The products are
    ``matmul_terms`` (terms added left to right), so each entry is the
    two-term ``c * x - s * y`` or ``s * x + c * y`` of the textbook update
    (the other terms are exact zeros and ones)."""
    a = cov
    v = torch.eye(3, dtype=cov.dtype, device=cov.device).expand_as(cov)
    for _ in range(JACOBI_SWEEPS):
        for p, q in _PAIRS:
            apq = a[..., p, q]
            nonzero = apq != 0.0
            theta = (a[..., q, q] - a[..., p, p]) / torch.where(nonzero, apq * 2.0, 1.0)
            sign = torch.where(theta >= 0.0, 1.0, -1.0)
            t = sign / (torch.abs(theta) + sqrt_rn(theta * theta + 1.0))
            t = torch.where(nonzero, t, 0.0)
            c = 1.0 / sqrt_rn(t * t + 1.0)
            j = _rotation(c, t * c, p, q)
            a = matmul_terms(j.transpose(-1, -2), matmul_terms(a, j))
            v = matmul_terms(v, j)
    d0, d1, d2 = a[..., 0, 0], a[..., 1, 1], a[..., 2, 2]
    pick0 = (d0 <= d1) & (d0 <= d2)
    pick1 = ~pick0 & (d1 <= d2)
    return torch.where(pick0[..., None], v[..., :, 0],
                       torch.where(pick1[..., None], v[..., :, 1], v[..., :, 2]))


def _normalise(normal: torch.Tensor, centroid: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor]:
    nx, ny, nz = normal.unbind(-1)
    norm = torch.clamp(sqrt_rn((nx * nx + ny * ny) + nz * nz), min=1e-12)
    normal = normal / norm[..., None]
    cx, cy, cz = centroid.unbind(-1)
    nx, ny, nz = normal.unbind(-1)
    return normal, -((nx * cx + ny * cy) + nz * cz)


def _covariance(c: torch.Tensor, total) -> torch.Tensor:
    """(..., 3, 3) sum over the rows of centred points ``c`` (..., R, 3) of
    their outer products; ``total`` sums (..., R, 6) over its rows."""
    x, y, z = c[..., 0], c[..., 1], c[..., 2]
    xx, xy, xz, yy, yz, zz = total(torch.stack([x * x, x * y, x * z, y * y, y * z, z * z],
                                               -1)).unbind(-1)
    return torch.stack([torch.stack([xx, xy, xz], -1), torch.stack([xy, yy, yz], -1),
                        torch.stack([xz, yz, zz], -1)], -2)


def _sum_rows(x: torch.Tensor) -> torch.Tensor:
    """Sum over axis -2, top to bottom."""
    out = x[..., 0, :]
    for j in range(1, x.shape[-2]):
        out = out + x[..., j, :]
    return out


def _plane_from_samples(samples: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(K, n, 3) samples -> K least-squares planes (unit normal, d)."""
    centroid = _sum_rows(samples) / float(samples.shape[-2])
    centered = samples - centroid[..., None, :]
    cov = _covariance(centered, _sum_rows)
    return _normalise(smallest_eigenvector(cov), centroid)


def _plane_from_points(points: torch.Tensor, w: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Weighted least-squares plane of (N, 3) ``points`` with 0/1 weights
    ``w`` (float), sums by a fixed pairwise tree."""
    wsum = torch.clamp(tree_sum(w), min=1e-12)
    centroid = tree_sum(points * w[:, None]) / wsum
    centered = (points - centroid) * w[:, None]
    cov = _covariance(centered, tree_sum)
    return _normalise(smallest_eigenvector(cov), centroid)


def _distances(points: torch.Tensor, normals: torch.Tensor, ds: torch.Tensor) -> torch.Tensor:
    """|((x * a + y * b) + z * c) + d| of N points against K planes: (N, K)."""
    x, y, z = points[:, 0:1], points[:, 1:2], points[:, 2:3]
    return torch.abs(((x * normals[:, 0] + y * normals[:, 1]) + z * normals[:, 2]) + ds)


def _score_planes(points: torch.Tensor, mask: torch.Tensor, normals: torch.Tensor,
                  ds: torch.Tensor, threshold: float) -> torch.Tensor:
    """Inlier counts (int64) of K planes over N points, ``SCORE_CHUNK``
    planes at a time."""
    counts = []
    for s in range(0, normals.shape[0], SCORE_CHUNK):
        e = s + SCORE_CHUNK
        inside = _distances(points, normals[s:e], ds[s:e]) <= threshold
        counts.append(torch.sum(inside & mask[:, None], dim=0))
    return torch.cat(counts)


def sample_indices(key: torch.Tensor, mask: torch.Tensor, ransac_n: int,
                   num_iterations: int) -> torch.Tensor:
    """(num_iterations, ransac_n) row indices, uniform over the first
    ``num_valid`` rows: ``min(int(u * num_valid), num_valid - 1)``, with
    ``num_valid`` kept on the device."""
    num_valid = torch.clamp(torch.sum(mask.to(torch.int32)), min=1)
    u = prng.uniform(key, (num_iterations, ransac_n))
    idx = (u * num_valid.to(torch.float32)).to(torch.int32)
    return torch.minimum(idx, num_valid - 1)


def segment_plane(points: torch.Tensor, mask: torch.Tensor, key: torch.Tensor,
                  distance_threshold: float = 0.5, ransac_n: int = 5,
                  num_iterations: int = 5000) -> tuple[torch.Tensor, torch.Tensor]:
    """The dominant plane ``[a, b, c, d]`` (unit normal, oriented to +z),
    refitted on its inliers, and the refitted plane's inlier mask (valid
    points within ``distance_threshold``)."""
    mask = mask.to(torch.bool)
    idx = sample_indices(key, mask, ransac_n, num_iterations)
    normals, ds = _plane_from_samples(points[idx.long()])
    counts = _score_planes(points, mask, normals, ds, distance_threshold)
    best = torch.argmax(counts).reshape(1)  # index_select: a 0-d index would be read on the host
    normal, d = normals.index_select(0, best)[0], ds.index_select(0, best)[0]

    def inliers_of(normal, d):
        return (_distances(points, normal[None], d[None])[:, 0] <= distance_threshold) & mask

    normal, d = _plane_from_points(points, inliers_of(normal, d).to(points.dtype))
    inl = inliers_of(normal, d)
    sign = torch.where(normal[2] < 0, -1.0, 1.0).to(points.dtype)
    return torch.cat([normal * sign, (d * sign)[None]]), inl


def remove_ground(points: torch.Tensor, mask: torch.Tensor, key: torch.Tensor,
                  distance_threshold: float = 0.5, ransac_n: int = 5,
                  num_iterations: int = 5000) -> tuple[torch.Tensor, torch.Tensor]:
    """Ground removal: plane fit, then the valid points off it
    (``main.py:73-75``).  Returns ``(plane, non_ground_mask)``."""
    plane, inl = segment_plane(points, mask, key, distance_threshold, ransac_n,
                               num_iterations)
    return plane, mask & ~inl
