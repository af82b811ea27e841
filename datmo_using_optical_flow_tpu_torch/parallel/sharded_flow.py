"""Row-sharded Farnebäck flow over a process group, the counterpart of
``datmo_using_optical_flow_tpu.parallel.sharded_flow``.

The flow grid is sharded by rows over a :class:`~.mesh.RowGroup`: each
stencil reads its neighbours' rows through a halo
(:func:`~.halo.halo_exchange_rows`), and the flow-compensated warp reads the
target's coefficient planes through a halo of ``warp_halo`` rows, so
**vertical displacement is bounded by the halo depth** at the sharded level.
Horizontal displacement is not (rows are whole).  Within the bound the
sharded level computes what the unsharded one does; beyond it the warp clamps
to the halo's edge, as the JAX package's does (a documented deviation from the
unsharded flow).

The kernels run as in the unsharded flow, on blocks grown by their halos:
K1 (``flow_kernels.poly_exp``) expands each rank's halo-extended level-0
block and the replicated coarse levels; K2 (``flow_kernels.blur_solve``) sums
the window and solves on the halo-extended M of level 0 (its horizontal pass
is row-local, so its interior rows are :func:`~.halo.sharded_box_blur5` then
``solve_flow``) and on the small replicated levels; K3 runs the replicated
levels of at least 128x256.  The warp's M stays plain PyTorch
(:func:`sharded_update_matrices`), as in the JAX package, which computes it
outside any Pallas kernel.

Every function runs on every rank of the group at once, on blocks of shape
(5, H_local, W) or (H_local, W).
"""

from __future__ import annotations

import numpy as np
import torch

from datmo_using_optical_flow_tpu_torch.ops import farneback as fb
from datmo_using_optical_flow_tpu_torch.ops import flow_kernels, warp
from datmo_using_optical_flow_tpu_torch.oracle.np_farneback import gaussian_kernel, level_sizes
from datmo_using_optical_flow_tpu_torch.parallel.halo import halo_exchange_rows
from datmo_using_optical_flow_tpu_torch.parallel.mesh import RowGroup


def sharded_poly_exp(img_block: torch.Tensor, n: int, sigma: float,
                     group: RowGroup) -> torch.Tensor:
    """Row-sharded polynomial expansion -> (5, H_local, W) planes: K1 on the
    block grown by ``n`` rows of each neighbour.  K1 edge-pads again; the
    rows kept read true halo rows only."""
    hl = img_block.shape[0]
    ext = halo_exchange_rows(img_block, n, group).contiguous()
    return fb.poly_exp(ext, n, sigma)[:, n:n + hl, :]


def sharded_update_matrices(R0: torch.Tensor, R1ext: torch.Tensor, dx: torch.Tensor,
                            dy: torch.Tensor, group: RowGroup, warp_halo: int,
                            h_global: int) -> torch.Tensor:
    """Flow-compensated normal-equation planes M (5, H_local, W) of a
    row-sharded block (JAX ``sharded_flow.py:54-120``).

    ``R1ext``: the target's planes grown by ``warp_halo`` rows of each
    neighbour, (5, H_local + 2*warp_halo, W).  Equals
    ``ops.farneback.update_matrices`` of the whole grid on this rank's rows
    while |dy| stays within ``warp_halo`` rows; beyond, the sampled row
    clamps to the halo's edge."""
    _, hl, w = R0.shape
    start = group.rank * hl
    xs = torch.arange(w, dtype=dx.dtype, device=dx.device)[None, :]
    ys_local = torch.arange(hl, dtype=dx.dtype, device=dx.device)[:, None]
    ys_global = ys_local + start

    fx = xs + dx
    fy = ys_global + dy
    x1 = torch.floor(fx)
    y1 = torch.floor(fy)
    fx = fx - x1
    fy = fy - y1
    x1i = x1.to(torch.int64)
    y1i = y1.to(torch.int64)  # global row
    inside = (x1i >= 0) & (x1i < w - 1) & (y1i >= 0) & (y1i < h_global - 1)
    x1c = torch.clamp(x1i, 0, max(w - 2, 0))
    # the row in the extended block; the clamp bounds the vertical displacement
    y1l = torch.clamp(y1i - start + warp_halo, 0, hl + 2 * warp_halo - 2)

    flat = R1ext.reshape(5, -1)
    base = (y1l * w + x1c).reshape(-1)

    def take(offset):
        return flat[:, base + offset].reshape(5, hl, w)

    a00 = ((1 - fx) * (1 - fy))[None]
    a01 = (fx * (1 - fy))[None]
    a10 = ((1 - fx) * fy)[None]
    a11 = (fx * fy)[None]
    r = a00 * take(0) + a01 * take(1) + a10 * take(w) + a11 * take(w + 1)
    rows = torch.arange(start, start + hl, device=dx.device)  # attenuated as global rows
    scale = (fb.border_axis(rows, h_global)[:, None]
             * fb.border_axis(torch.arange(w, device=dx.device), w)[None, :])
    return fb.matrices_from_samples(R0, r, inside, dx, dy, scale)


def sharded_blur_solve(M: torch.Tensor, winsize: int, group: RowGroup
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Box window sum and 2x2 solve of row-sharded M (5, H_local, W): K2 on
    M grown by ``winsize // 2`` rows of each neighbour, its interior rows
    kept (``solve_flow(sharded_box_blur5(M))``)."""
    r = winsize // 2
    hl = M.shape[-2]
    dx, dy = flow_kernels.blur_solve(halo_exchange_rows(M, r, group).contiguous(), winsize)
    return dx[r:r + hl].contiguous(), dy[r:r + hl].contiguous()


def sharded_farneback_level(R0: torch.Tensor, R1: torch.Tensor, dx: torch.Tensor,
                            dy: torch.Tensor, winsize: int, iterations: int,
                            group: RowGroup, h_global: int, warp_halo: int = 16
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """One pyramid level on row-sharded blocks: ``iterations`` x (matrices ->
    window -> solve)."""
    R1ext = halo_exchange_rows(R1, warp_halo, group)
    M = sharded_update_matrices(R0, R1ext, dx, dy, group, warp_halo, h_global)
    for i in range(iterations):
        dx, dy = sharded_blur_solve(M, winsize, group)
        if i < iterations - 1:
            M = sharded_update_matrices(R0, R1ext, dx, dy, group, warp_halo, h_global)
    return dx, dy


def coarse_flow(im1_block: torch.Tensor, im2_block: torch.Tensor, group: RowGroup,
                pyr_scale: float = 0.3, levels: int = 5, winsize: int = 15,
                iterations: int = 5, poly_n: int = 5, poly_sigma: float = 5.0
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """This rank's rows of the flow that level 0 starts from: the levels
    below full size run replicated on every rank, on the gathered images
    (they cost ~``pyr_scale²`` of level 0), and their flow is upsampled to
    full size (JAX ``sharded_flow.py:156-193``).  Zeros when the pyramid has
    one level."""
    hl, w = im1_block.shape
    h_global = hl * group.world_size
    sizes = level_sizes(h_global, w, pyr_scale, levels)
    if len(sizes) == 1:
        zero = torch.zeros((hl, w), dtype=torch.float32, device=im1_block.device)
        return zero, zero.clone()
    full = [group.all_gather_rows(im).to(torch.float32) for im in (im1_block, im2_block)]
    dx = dy = None
    inv = float(np.float32(1.0 / pyr_scale))
    for _, scale, lh, lw in sizes[:-1]:
        if dx is None:
            dx = torch.zeros((lh, lw), dtype=torch.float32, device=im1_block.device)
            dy = torch.zeros_like(dx)
        else:
            dx = fb.resize_bilinear(dx, lh, lw) * inv
            dy = fb.resize_bilinear(dy, lh, lw) * inv
        R0, R1 = (fb.poly_exp(fb.level_image(im, scale, lh, lw), poly_n, poly_sigma)
                  for im in full)
        dx, dy = fb.farneback_level(R0, R1, dx, dy, winsize, iterations, fast_warp=False)
    rows = slice(group.rank * hl, (group.rank + 1) * hl)
    return ((fb.resize_bilinear(dx, h_global, w) * inv)[rows].contiguous(),
            (fb.resize_bilinear(dy, h_global, w) * inv)[rows].contiguous())


def level0_image(img_block: torch.Tensor, group: RowGroup) -> torch.Tensor:
    """Level 0's pre-blur of a row-sharded image: cv2's 3-tap Gaussian with
    BORDER_REFLECT_101 (``ops.farneback.level_image`` at scale 1), the
    vertical pass through a one-row halo.  Its taps (1/4, 1/2, 1/4) are
    powers of two, so every product is exact and these separately rounded
    sums give the same bits as the level image's contracted chain (K8)."""
    hl = img_block.shape[0]
    k3 = gaussian_kernel(3, 0.0).astype(np.float32)
    ext = halo_exchange_rows(img_block.to(torch.float32), 1, group, edge_mode="reflect101")
    return fb._corr_axis(fb._corr_axis(ext, k3, -2, "reflect")[1:1 + hl], k3, -1, "reflect")


def sharded_farneback_flow(img1_block: torch.Tensor, img2_block: torch.Tensor,
                           group: RowGroup, pyr_scale: float = 0.3, levels: int = 5,
                           winsize: int = 15, iterations: int = 5, poly_n: int = 5,
                           poly_sigma: float = 5.0, warp_halo: int = 16) -> torch.Tensor:
    """Pyramidal Farnebäck flow on row-sharded images -> this rank's
    (H_local, W, 2) [dx, dy] rows.

    The coarse levels run replicated (:func:`coarse_flow`); level 0, which
    dominates, runs row-sharded: the halo'd 3-tap pre-blur, K1 on the
    halo-extended blocks, the halo-bounded warp and K2 on the halo-extended
    M.  Every level warps exactly: equal to the unsharded ``ops.farneback``
    flow with ``fast_warp=False`` while level 0's vertical displacement stays
    within ``warp_halo`` rows.  ``img*_block``: this rank's (H_local, W) rows (``mesh.shard_rows``).
    """
    hl, _ = img1_block.shape
    dx, dy = coarse_flow(img1_block, img2_block, group, pyr_scale, levels, winsize,
                         iterations, poly_n, poly_sigma)
    R0, R1 = (sharded_poly_exp(level0_image(im, group), poly_n, poly_sigma, group)
              for im in (img1_block, img2_block))
    dx, dy = sharded_farneback_level(R0, R1, dx, dy, winsize, iterations, group,
                                     hl * group.world_size, warp_halo)
    return torch.stack([dx, dy], dim=-1)


def sharded_flow_launches(h: int, w: int, pyr_scale: float = 0.3, levels: int = 5,
                          iterations: int = 5) -> dict:
    """Kernel launches of one :func:`sharded_farneback_flow` call on each rank
    on the card, by the code above: two K1 per level (the replicated coarse
    levels and level 0's halo-extended blocks), ``iterations`` K3 on each
    coarse level of at least 128x256 (``warp.eligible``), ``iterations`` K2
    on each smaller one and on level 0; K8 twice per coarse level image (two
    images a level) and once per plane of each upsample (dx and dy: between
    the coarse levels and to full size).  Level 0's pre-blur runs
    :func:`level0_image`'s plain ops."""
    sizes = level_sizes(h, w, pyr_scale, levels)
    k3 = sum(warp.eligible(lh, lw) for _, _, lh, lw in sizes[:-1])
    coarse = len(sizes) - 1
    return {"poly_exp": 2 * len(sizes), "blur_solve": iterations * (len(sizes) - k3),
            "fused_iteration": iterations * k3,
            "level_image": 2 * 2 * coarse + 2 * coarse if coarse else 0}
