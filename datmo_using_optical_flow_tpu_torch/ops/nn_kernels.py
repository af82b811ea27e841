"""Exact 1-NN with spatial tile pruning (K5): the CUDA kernel, its plain
PyTorch version, the index helpers and the launch counter.

The counterpart of ``datmo_using_optical_flow_tpu.ops.nn_pallas``.  Sources
and targets are Morton-sorted into 256-point source blocks and 256-point
target tiles.  A per-(block, tile) lower bound, sorted ascending per block,
lets each block visit tiles nearest-first and stop at the first tile whose
bound exceeds ``bmax`` = min(the block's worst running best, ``cap2``).  Every
block recentres its rows and the visited tiles on its row 0, so the
expansion ``|t|^2 - 2 s.t`` (``|s|^2`` added back after the reductions) keeps
near-candidate error at ~ALPHA (d + r)^2.  Per row the sweep returns the
winner (lowest original index among equal distances), its distance, a sound
lower bound on the true minimum, a sound lower bound on the distance to any
other target, and the winner's coordinates.

:func:`nearest_neighbors` dispatches on its input's device alone: a CPU tensor
takes :func:`nearest_neighbors_reference`, a CUDA tensor launches the kernel
of ``csrc/nn_kernels.cu`` on the current stream, and any other device raises.
There is no fallback from the kernel to the plain version.  Both take the
same prepared inputs (:func:`prepare`) and do the same float32 operations in
the same order, so on one device they agree bit for bit.

The kernel spreads each block's walk over a thread-block cluster: its CTAs
scan the next few tiles at once and every CTA replays their results in tile
order.  A full query launches 4 CTAs per block, an active query (one with
per-block active counts: ICP's, whose few mixed blocks walk nearly every
tile) 16; the sizes were measured per GMFA step (``csrc/nn_kernels.cu``).
The plain version's ``chunk`` argument replays as the clusters do, so the
CPU tests hold that scheme to the serial definition (``chunk=1``).

Unlike the TPU kernel there is no dynamic grid: a block whose active count is
0 exits at once and writes the constant outputs, with the same values.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from datmo_using_optical_flow_tpu_torch.kernels import build
from datmo_using_optical_flow_tpu_torch.ops.flow_kernels import _on_cuda
from datmo_using_optical_flow_tpu_torch.utils.ordered import norm_rn

SRC_BLOCK = 256
TGT_TILE = 256
# targets above this many points go to the JAX package's scan fallback,
# which the port does not have (ops/nn.py raises)
MAX_TARGET = 1 << 18
# per-candidate relative error envelope of the recentred expansion
ALPHA = float(np.float32(1e-5))
_ONE_MINUS_ALPHA = float(np.float32(1.0) - np.float32(ALPHA))
# absolute slack (metres) subtracted from the geometric tile bound
_LB_PAD = float(np.float32(1e-3))
_BIG_I = 2 ** 30
_HUGE = 3e38  # finite-value test of the squared norms and distances

LAUNCHES = {"nearest_neighbors": 0}
_SWEEP = build.Entry("datmo_nn_sweep", "nn_sweep")
_SWEEP_ACTIVE = build.Entry("datmo_nn_sweep_active", "nn_sweep")
_SWEEP_SIZED = build.Entry("datmo_nn_sweep_sized", "nn_sweep")
CLUSTER_SIZES = (1, 2, 4, 8, 16)  # what datmo_nn_sweep_sized takes


def reset_launches() -> None:
    LAUNCHES["nearest_neighbors"] = 0


def eligible(m: int) -> bool:
    return m <= MAX_TARGET


class TargetIndex(NamedTuple):
    """Morton-sorted targets in 256-point tiles (built once, queried often)."""

    packed: torch.Tensor     # (m_tiles, 8, T) sorted coords on rows 0..2, zeros below
    tn: torch.Tensor         # (m_tiles, 1, T) |t|^2, +inf where invalid
    tidx: torch.Tensor       # (m_tiles, 1, T) int32 original indices
    tile_cent: torch.Tensor  # (m_tiles, 3) tile bounding-box centres
    tile_rad: torch.Tensor   # (m_tiles,) tile bounding radii (-inf if empty)
    tile_lo: torch.Tensor    # (m_tiles, 3) tile AABB minima (+inf if empty)
    tile_hi: torch.Tensor    # (m_tiles, 3) tile AABB maxima (-inf if empty)


def _norm3(v: torch.Tensor) -> torch.Tensor:
    """Euclidean norm over the last axis of length 3, as the JAX package's
    compiled ``jnp.linalg.norm`` rounds it in the index and the block table
    (JAX ``ops/nn_pallas.py:152-155, 373-374, 387``): ``sqrt_rn(fma(z, z,
    fma(y, y, x * x)))``, the correctly rounded root of the contracted sum."""
    return norm_rn(v)


def _morton_keys(p: torch.Tensor) -> torch.Tensor:
    """int32 Morton codes of (N, 3) points, 10 bits per axis over the data's
    bounding box with one shared (cubic) scale."""
    lo = torch.amin(p, dim=0)
    hi = torch.amax(p, dim=0)
    scale = 1023.0 / torch.clamp(torch.amax(hi - lo), min=1e-12)
    q = torch.clamp((p - lo) * scale, 0.0, 1023.0).to(torch.int32)
    key = torch.zeros(p.shape[:1], dtype=torch.int32, device=p.device)
    for bit in range(10):
        for d in range(3):
            key = key | (((q[:, d] >> bit) & 1) << (3 * bit + d))
    return key


def sort_order(pts: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """int32 Morton order of a masked cloud, invalid rows last (stable)."""
    ptsf = torch.where(mask[:, None], pts.to(torch.float32), 0.0)
    key = torch.where(mask, _morton_keys(ptsf), _BIG_I)
    return torch.argsort(key, stable=True).to(torch.int32)


def _pad_edge(x: torch.Tensor, n_out: int) -> torch.Tensor:
    """Pad rows to ``n_out`` by repeating the last row."""
    n = x.shape[0]
    if n_out == n:
        return x
    return torch.cat([x, x[-1:].expand(n_out - n, *x.shape[1:])], dim=0)


def build_target_index(tgt: torch.Tensor, tgt_mask: torch.Tensor,
                       order: torch.Tensor | None = None) -> TargetIndex:
    """Morton-sort targets (invalid rows last) into tiles with their bounds.
    ``order`` may be a precomputed permutation (:func:`sort_order`); the
    results do not depend on it, only pruning tightness does."""
    m = tgt.shape[0]
    mp = -(-m // TGT_TILE) * TGT_TILE
    tgtf = torch.where(tgt_mask[:, None], tgt.to(torch.float32), 0.0)
    if order is None:
        order = sort_order(tgtf, tgt_mask)
    order = order.long()
    tgt_s = tgtf[order]
    mask_s = tgt_mask[order]
    tidx = order.to(torch.int32)

    tgt_p = F.pad(tgt_s, (0, 5, 0, mp - m))
    mask_p = F.pad(mask_s, (0, mp - m))
    tidx_p = F.pad(tidx, (0, mp - m))
    # a validity flag only (the sweep recomputes the recentred norms)
    tn = (tgt_p[:, 0] * tgt_p[:, 0] + tgt_p[:, 1] * tgt_p[:, 1]) + tgt_p[:, 2] * tgt_p[:, 2]
    tn = torch.where(mask_p, tn, torch.inf)

    m_tiles = mp // TGT_TILE
    pts = tgt_p[:, :3].reshape(m_tiles, TGT_TILE, 3)
    mtile = mask_p.reshape(m_tiles, TGT_TILE)
    lo = torch.amin(torch.where(mtile[:, :, None], pts, torch.inf), dim=1)
    hi = torch.amax(torch.where(mtile[:, :, None], pts, -torch.inf), dim=1)
    has = torch.any(mtile, dim=1)
    cent = torch.where(has[:, None], (lo + hi) * 0.5, 0.0)
    rad = torch.where(
        has,
        torch.amax(_norm3(torch.where(mtile[:, :, None], pts - cent[:, None, :], 0.0)), dim=1),
        -torch.inf)  # empty tile: its bound is +inf, always skipped

    return TargetIndex(
        packed=tgt_p.reshape(m_tiles, TGT_TILE, 8).transpose(1, 2).contiguous(),
        tn=tn.reshape(m_tiles, 1, TGT_TILE).contiguous(),
        tidx=tidx_p.reshape(m_tiles, 1, TGT_TILE).contiguous(),
        tile_cent=cent, tile_rad=rad, tile_lo=lo, tile_hi=hi)


def block_first_fill(src: torch.Tensor, keep: torch.Tensor, n: int | None = None
                     ) -> torch.Tensor:
    """Rewrite rows where ``keep`` is False to their block's first kept row
    (blocks with no kept row keep row 0).  Returns the edge-padded (npad, 3)
    cloud: the sweep recentres on row 0, which must be a kept row."""
    n = src.shape[0] if n is None else n
    b = SRC_BLOCK
    npad = -(-n // b) * b
    srcp = _pad_edge(src.to(torch.float32)[:n], npad)
    keepp = F.pad(keep[:n], (0, npad - n))
    rows = srcp.reshape(-1, b, 3)
    first_active = torch.argmax(keepp.reshape(-1, b).to(torch.uint8), dim=1)  # 0 if none
    rep = torch.gather(rows, 1, first_active[:, None, None].expand(-1, 1, 3))
    rep = rep.expand(npad // b, b, 3).reshape(npad, 3)
    return torch.where(keepp[:, None], srcp, rep)


def build_block_table(src: torch.Tensor, index: TargetIndex, n: int | None = None
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-(source block, target tile) linear lower bounds (the larger of the
    bounding-ball and AABB-gap bounds, less ``_LB_PAD``), sorted ascending per
    block, and the matching tile visit order; padded to a multiple of 128
    columns with +inf / 0.  ``max(lb - drift, 0)`` stays sound for a cloud
    moved by at most ``drift``."""
    n = src.shape[0] if n is None else n
    np_ = -(-n // SRC_BLOCK) * SRC_BLOCK
    n_blocks = np_ // SRC_BLOCK
    blocks = _pad_edge(src.to(torch.float32)[:n], np_).reshape(n_blocks, SRC_BLOCK, 3)
    blo = torch.amin(blocks, dim=1)
    bhi = torch.amax(blocks, dim=1)
    bc = (blo + bhi) * 0.5
    br = torch.amax(_norm3(blocks - bc[:, None, :]), dim=1)
    d_ct = _norm3(bc[:, None, :] - index.tile_cent[None, :, :])
    ball = d_ct - br[:, None] - index.tile_rad[None, :]
    gap = torch.clamp(torch.maximum(index.tile_lo[None, :, :] - bhi[:, None, :],
                                    blo[:, None, :] - index.tile_hi[None, :, :]), min=0.0)
    aabb = _norm3(gap)
    lb = torch.clamp(torch.maximum(ball, aabb) - _LB_PAD, min=0.0)
    lb = torch.where(torch.isfinite(index.tile_rad)[None, :], lb, torch.inf)
    m_tiles = index.packed.shape[0]
    torder = torch.argsort(lb, dim=1, stable=True)
    lb = torch.gather(lb, 1, torder)
    mt_pad = (-m_tiles) % 128
    lb = F.pad(lb, (0, mt_pad), value=torch.inf)
    torder = F.pad(torder.to(torch.int32), (0, mt_pad))
    return lb, torder


class Prepared(NamedTuple):
    """The sweep's inputs, shared by the kernel and its plain version."""

    src: torch.Tensor           # (np_, 3) float32, edge-padded
    block_counts: torch.Tensor  # (n_blocks,) int32
    cap2: torch.Tensor          # (1,) float32
    lb2: torch.Tensor           # (n_blocks, mt_pad) float32 squared bounds, ascending
    torder: torch.Tensor        # (n_blocks, mt_pad) int32 tile visit order
    index: TargetIndex


def _scalar(x, dtype: torch.dtype, dev: torch.device) -> torch.Tensor:
    """A (1,) tensor on ``dev``; a Python number is filled in on the device
    (a copy from host memory would synchronise with the device)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=dev, dtype=dtype).reshape(1)
    return torch.full((1,), x, dtype=dtype, device=dev)


def prepare(src: torch.Tensor, index: TargetIndex, n_active=None, cap2=None,
            block_counts=None, block_table=None, drift=None) -> Prepared:
    """The sweep's inputs for :func:`nearest_neighbors`'s arguments."""
    n = src.shape[0]
    if src.ndim != 2 or src.shape[1] != 3 or n == 0:
        raise ValueError(f"src: expected (N, 3) with N > 0, got {tuple(src.shape)}")
    dev = src.device
    np_ = -(-n // SRC_BLOCK) * SRC_BLOCK
    n_blocks = np_ // SRC_BLOCK
    if block_counts is None:
        na = _scalar(n if n_active is None else n_active, torch.int32, dev)
        block_counts = torch.clamp(
            na - torch.arange(n_blocks, dtype=torch.int32, device=dev) * SRC_BLOCK,
            0, SRC_BLOCK)
    block_counts = block_counts.to(torch.int32).reshape(n_blocks).contiguous()
    cap2 = _scalar(torch.inf if cap2 is None else cap2, torch.float32, dev)
    srcf = _pad_edge(src.to(torch.float32), np_).contiguous()
    lb_lin, torder = build_block_table(src, index, n) if block_table is None else block_table
    if drift is not None:
        lb_lin = torch.clamp(lb_lin - _scalar(drift, torch.float32, dev), min=0.0)
    lb2 = torch.where(torch.isfinite(lb_lin), lb_lin * lb_lin, torch.inf)
    return Prepared(srcf, block_counts, cap2, lb2.contiguous(),
                    torder.to(torch.int32).contiguous(), index)


def _scan_tile(p: Prepared, j: int, cent, sx, sy, sz):
    """Every block's scan of its ``j``-th tile: the tile id and, per row, the
    minimum, the lowest original index among the minima, the two bound terms
    ``tl`` and ``t2l`` and the winner's coordinates."""
    idx_all = p.index
    jt = p.torder[:, j]
    jtl = jt.long()
    tile = idx_all.packed[jtl]                                 # (nb, 8, T)
    tn_raw = idx_all.tn[jtl, 0]                                # (nb, T)
    tidx = idx_all.tidx[jtl, 0]
    tpx = tile[:, 0] - cent[:, 0:1]
    tpy = tile[:, 1] - cent[:, 1:2]
    tpz = tile[:, 2] - cent[:, 2:3]
    tpn = (tpx * tpx + tpy * tpy) + tpz * tpz
    valid_t = tn_raw < _HUGE
    tn = torch.where(valid_t, tpn, torch.inf)
    cross = ((sx[:, :, None] * tpx[:, None, :] + sy[:, :, None] * tpy[:, None, :])
             + sz[:, :, None] * tpz[:, None, :])
    d2 = tn[:, None, :] - 2.0 * cross                          # (nb, B, T)
    td = torch.amin(d2, dim=2)
    eq = d2 == td[:, :, None]
    ti = torch.amin(torch.where(eq, tidx[:, None, :], _BIG_I), dim=2)
    maxtpn = torch.amax(torch.where(valid_t, tpn, 0.0), dim=1)[:, None]
    tl = td - ALPHA * maxtpn
    n_min = torch.sum(eq, dim=2)
    t2raw = torch.amin(torch.where(eq, torch.inf, d2), dim=2)
    t2 = torch.where(n_min > 1, td, t2raw)
    # the winner's position in the tile: unique (d2, original index) pair
    pos = torch.argmax((eq & (tidx[:, None, :] == ti[:, :, None])).to(torch.uint8), dim=2)
    sel = torch.gather(tile[:, :3, :], 2, pos[:, None, :].expand(-1, 3, -1)).transpose(1, 2)
    return jt, td, ti, tl, t2 - ALPHA * maxtpn, sel


def _take(td, ti, bd, bi):
    """Whether a tile's minimum replaces the running best (ties: lower index)."""
    return (td < bd) | ((td == bd) & (td < _HUGE) & (ti < bi))


def _sweep_reference(p: Prepared, chunk: int = 1):
    """Plain version of the sweep, vectorised over blocks: each block visits
    its tiles in order and stops for good at its first tile with
    ``lb2 > bmax``.  Returns the padded (np_,) / (np_, 3) outputs and, per
    block, the number of tiles it visited (0 for a block with no active row).

    ``chunk=1`` is the serial definition.  ``chunk=c`` replays as the
    kernel's clusters of ``c`` CTAs do: the next ``c`` tiles are scanned
    first; then each block's best after each of them, as if every one were
    taken, gives bmax before each, the block stops at the first tile whose
    bound exceeds it, and the tiles before the stop are applied in order.
    The results are the serial ones."""
    m_tiles = p.index.packed.shape[0]
    nb = p.block_counts.shape[0]
    dev = p.src.device
    blocks = p.src.reshape(nb, SRC_BLOCK, 3)
    cent = blocks[:, 0, :]
    sp = blocks - cent[:, None, :]
    sx, sy, sz = sp[..., 0], sp[..., 1], sp[..., 2]               # (nb, B)
    sn = (sx * sx + sy * sy) + sz * sz
    cap2 = p.cap2[0]
    inf = torch.full((nb, SRC_BLOCK), torch.inf, device=dev)
    bd, bl, s1, s2, sm2 = inf.clone(), inf.clone(), inf.clone(), inf.clone(), inf.clone()
    bi = torch.full((nb, SRC_BLOCK), _BIG_I, dtype=torch.int32, device=dev)
    s1t = torch.full((nb, SRC_BLOCK), -1, dtype=torch.int32, device=dev)
    bti = torch.full((nb, SRC_BLOCK), -2, dtype=torch.int32, device=dev)
    w = torch.zeros((nb, SRC_BLOCK, 3), device=dev)
    bmax = cap2.expand(nb).clone()
    running = p.block_counts > 0
    j_fin = torch.zeros(nb, dtype=torch.int64, device=dev)
    for j0 in range(0, m_tiles, chunk):
        cols = range(j0, min(j0 + chunk, m_tiles))
        scans = [_scan_tile(p, j, cent, sx, sy, sz) for j in cols[:-1]]
        # bmax before each tile of the chunk: the best after the tiles before
        # it, had each been taken (for a block still running, it was)
        bmax_before = [bmax]
        bd_t, bi_t = bd, bi
        for _, td, ti, _, _, _ in scans:
            take = _take(td, ti, bd_t, bi_t)
            bd_t, bi_t = torch.where(take, td, bd_t), torch.where(take, ti, bi_t)
            bmax_before.append(torch.minimum(torch.amax(bd_t + sn, dim=1), cap2))
        for k, j in enumerate(cols):
            go = running & (p.lb2[:, j] <= bmax_before[k])
            running = go
            if not bool(go.any()):
                break
            j_fin = torch.where(go, j + 1, j_fin)
            if k == len(scans):
                scans.append(_scan_tile(p, j, cent, sx, sy, sz))
            jt, td, ti, tl, t2l, sel = scans[k]
            g = go[:, None]
            take = g & _take(td, ti, bd, bi)
            sm2 = torch.where(g, torch.minimum(sm2, t2l), sm2)
            is_new_min = g & (tl < s1)
            s2 = torch.where(is_new_min, s1, torch.where(g, torch.minimum(s2, tl), s2))
            s1t = torch.where(is_new_min, jt[:, None], s1t)
            s1 = torch.where(is_new_min, tl, s1)
            bti = torch.where(take, jt[:, None], bti)
            bi = torch.where(take, ti, bi)
            bd = torch.where(take, td, bd)
            w = torch.where(take[:, :, None], sel, w)
            bl = torch.where(g, torch.minimum(bl, tl), bl)
            bmax = torch.where(go, torch.minimum(torch.amax(bd + sn, dim=1), cap2), bmax)
        else:  # every tile of the chunk had a running block
            continue
        break

    skipped = (p.block_counts <= 0)[:, None]
    idx = torch.where(bi == _BIG_I, 0, bi)
    d2o = torch.clamp(bd + sn, min=0.0)
    lo = torch.clamp(torch.minimum((bl + _ONE_MINUS_ALPHA * sn) - ALPHA, cap2), min=0.0)
    floor_abs = torch.where((j_fin < m_tiles)[:, None],
                            torch.gather(p.lb2, 1, torch.clamp(j_fin, max=m_tiles - 1)[:, None]),
                            torch.inf)
    other_min = torch.where(bti == s1t, s2, s1)
    second = torch.minimum(other_min, sm2)
    d2nd = torch.clamp(torch.minimum((second + _ONE_MINUS_ALPHA * sn) - ALPHA, floor_abs),
                       min=0.0)
    idx = torch.where(skipped, 0, idx)
    d2o, lo, d2nd = (torch.where(skipped, torch.inf, t) for t in (d2o, lo, d2nd))
    w = torch.where(skipped[:, :, None], 0.0, w)
    return (idx.reshape(-1), d2o.reshape(-1), lo.reshape(-1), d2nd.reshape(-1),
            w.reshape(-1, 3)), j_fin


def _check_index(index: TargetIndex) -> None:
    m_tiles = index.packed.shape[0]
    for t, name, shape, dtype in ((index.packed, "packed", (m_tiles, 8, TGT_TILE), torch.float32),
                                  (index.tn, "tn", (m_tiles, 1, TGT_TILE), torch.float32),
                                  (index.tidx, "tidx", (m_tiles, 1, TGT_TILE), torch.int32)):
        if t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"index.{name}: expected contiguous {dtype} {shape}, "
                             f"got {t.dtype} {tuple(t.shape)}")


def _sweep_kernel(p: Prepared, cluster: int | None = None, active: bool = False):
    """Launch K5 (``csrc/nn_kernels.cu``) on the current stream: with the
    source's cluster size for a full query, or for an ``active`` one (a
    query with per-block active counts, ICP's), or with ``cluster`` CTAs per
    block (one of ``CLUSTER_SIZES``, for measuring the size)."""
    _check_index(p.index)
    np_ = p.src.shape[0]
    nb = p.block_counts.shape[0]
    m_tiles = p.index.packed.shape[0]
    mt_pad = p.lb2.shape[1]
    if p.lb2.shape != (nb, mt_pad) or p.torder.shape != (nb, mt_pad) or mt_pad < m_tiles:
        raise ValueError(f"block table: expected ({nb}, >= {m_tiles}), got "
                         f"{tuple(p.lb2.shape)} / {tuple(p.torder.shape)}")
    dev = p.src.device
    idx = torch.empty(np_, dtype=torch.int32, device=dev)
    d2, lo, d2nd = (torch.empty(np_, dtype=torch.float32, device=dev) for _ in range(3))
    crd = torch.empty((np_, 3), dtype=torch.float32, device=dev)
    args = (idx.data_ptr(), d2.data_ptr(), lo.data_ptr(), d2nd.data_ptr(), crd.data_ptr(),
            p.src.data_ptr(), p.block_counts.data_ptr(), p.cap2.data_ptr(),
            p.lb2.data_ptr(), p.torder.data_ptr(), mt_pad,
            p.index.packed.data_ptr(), p.index.tn.data_ptr(), p.index.tidx.data_ptr(),
            nb, m_tiles, ALPHA, _ONE_MINUS_ALPHA)
    if cluster is None:
        (_SWEEP_ACTIVE if active else _SWEEP)(dev.index, *args)
    elif cluster in CLUSTER_SIZES:
        _SWEEP_SIZED(dev.index, *args, cluster)
    else:
        raise ValueError(f"cluster: expected one of {CLUSTER_SIZES}, got {cluster}")
    LAUNCHES["nearest_neighbors"] += 1
    return idx, d2, lo, d2nd, crd


def _outputs(res, n):
    idx, d2, lo, d2nd, crd = res
    return idx[:n], d2[:n], lo[:n], d2nd[:n], crd[:n]


def nearest_neighbors_reference(src: torch.Tensor, index: TargetIndex, n_active=None,
                                cap2=None, block_counts=None, block_table=None, drift=None):
    """Plain version of :func:`nearest_neighbors` (same arguments and outputs)."""
    return nearest_neighbors_reference_visits(src, index, n_active, cap2, block_counts,
                                              block_table, drift)[0]


def nearest_neighbors_reference_visits(src: torch.Tensor, index: TargetIndex, n_active=None,
                                       cap2=None, block_counts=None, block_table=None,
                                       drift=None):
    """:func:`nearest_neighbors_reference`'s outputs and the (n_blocks,) int64
    count of tiles each 256-row block visited before its stopping rule fired.
    The kernel applies the same rule to the same bounds and values, so these
    are its visits too."""
    p = prepare(src, index, n_active, cap2, block_counts, block_table, drift)
    res, visits = _sweep_reference(p)
    return _outputs(res, src.shape[0]), visits


def nearest_neighbors(src: torch.Tensor, index: TargetIndex, n_active=None, cap2=None,
                      block_counts=None, block_table=None, drift=None):
    """K5: 1-NN of each ``src`` row among the index's valid targets.

    Returns ``(idx, sqdist, sqdist_lower_bound, second_lower_bound, coords)``:
    idx in original target numbering with lowest-index tie-breaking (0 when no
    candidate, sqdist +inf); both bounds are sound (true value >= bound);
    coords are the winner's exact coordinates (zeros when no candidate).

    ``n_active`` (int or 0-d tensor): only the first ``n_active`` rows are
    owed results; whole blocks past it skip the sweep (idx 0, +inf, zeros).
    ``block_counts`` ((n_blocks,) int32) overrides it per block.  ``cap2``
    (squared search cap, default +inf): rows whose true NN d2 is below it get
    exactly the uncapped result; other rows return d2 >= cap2 or +inf, with
    lower bounds <= cap2.  ``block_table`` reuses :func:`build_block_table`'s
    output; ``drift`` is the most any row moved since that table was built.
    """
    p = prepare(src, index, n_active, cap2, block_counts, block_table, drift)
    if not _on_cuda(p.src, p.index.packed, p.lb2):
        return _outputs(_sweep_reference(p)[0], src.shape[0])
    active = n_active is not None or block_counts is not None
    return _outputs(_sweep_kernel(p, active=active), src.shape[0])
