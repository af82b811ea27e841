"""K1's tiny form: the polynomial expansion of an image of at most ``poly_n``
rows or columns, rounded as XLA's CPU code rounds the JAX package's
``ops.farneback.poly_exp`` there.

At such a shape some taps of a correlation read nothing but edge padding:
the tap's slice of the padded image is one edge row (or column) broadcast.
XLA folds those taps into broadcasts of a vector product, and what LLVM then
does with the broadcasts changes where products are rounded:

* rows (``h <= n < w``): the leading broadcast taps of a vertical sum form a
  sum of their own, onto which the other products are fused; the edge columns
  that pad a row plane for the horizontal pass are recomputed with their
  trailing broadcast products rounded separately (hoisted out of the row
  loop), as are the columns of a row plane past the last whole vector of 8
  (the scalar remainder, wide rows only); every ``g`` sum with a centre tap
  takes that tap from a vertical sum recomputed inside the planes' fusion;
* one row (``h == 1``) or one column (``w == 1``): all products of one input
  value with equal taps are one product, used by both taps of a symmetric
  pair, so each is rounded on its own;
* ``w == n < h``: the broadcast taps of a horizontal sum (its first and last)
  and its centre read vertical sums recomputed in the planes' fusion, whose
  products of tap ``n + 1`` (and of ``n - 1`` where two sums share them) are
  rounded on their own; the first product is rounded on its own, the last
  added on its own.

These rules were read off XLA's optimised HLO and LLVM IR of ``poly_exp``
jitted for an x86-64 CPU.  Other tiny shapes (``2 <= w < n``, or both axes
at most ``n`` but one row or column) keep the wide shapes' rounding, which
is not yet XLA's there.

A rounding *plan* describes one shape: a list of vertical-sum variants and
seven horizontal sums.  :func:`poly_exp_tiny_reference` evaluates it in
PyTorch; the CUDA kernel ``datmo_poly_exp_tiny`` runs the same plan as a
program (:func:`tiny_program`: each chain's operation per tap,
:func:`chain_ops`, and a block's tile, :func:`tiny_tiles`), so the two agree
bit for bit by construction.  :func:`plan_array` is the plan in the form
the first tiny kernel read, for timing a checkout that has it.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from datmo_using_optical_flow_tpu_torch.ops import farneback as fb
from datmo_using_optical_flow_tpu_torch.ops import round_kernels
from datmo_using_optical_flow_tpu_torch.oracle.np_farneback import prepare_gaussian

G, XG, XXG = 0, 1, 2          # which taps a sum takes
MAX_VARIANTS = 12
# the seven horizontal sums, in plan order, and the taps of each
SUM_KINDS = (G, XG, G, G, XXG, G, XG)   # p0, p1, p2 (b5, b1), p3 (b4, b1s), p4
PLAN_INTS = 1 + MAX_VARIANTS * 5 + 7 * 10
# The tiny kernel's program (csrc/flow_kernels.cu: TinyProgram): each chain's
# operation per tap (chain_ops), and the tile of a block (tiny_tiles)
SKIP, FIRST, FUSE0, FMA, ADD = range(5)
OPS = 16           # operations per chain: one per tap (2n + 1 <= 15), then skips
SUM_INTS = 1 + 2 * OPS + 4
PROGRAM_INTS = 3 + MAX_VARIANTS * (1 + OPS) + 7 * SUM_INTS
TILE = 32          # the most rows (columns) a block takes of a tall (wide) image
THREADS = 256      # a block's threads (kTinyThreads)
FILL = 2 * 132     # blocks at once: two per SM of the H100
SMEM_LIMIT = 48 * 1024  # the default shared memory of a block
STATIC_SMEM = 1024      # the kernel's own: the program and the taps, rounded up


class Variant(NamedTuple):
    """A vertical sum and how it rounds: ``sep`` taps' products are rounded on
    their own; ``swap``: the second product is the one fused into the first
    add; ``lead``: the leading broadcast taps form a sum of their own;
    ``trail``: the trailing broadcast taps are added rounded."""
    kind: int
    sep: int = 0
    swap: bool = False
    lead: bool = False
    trail: bool = False


class Sum(NamedTuple):
    """A horizontal sum: its taps, rounding flags as :class:`Variant`'s, and
    which vertical variant each tap reads: ``v_int`` inside the image,
    ``v_pad`` in the edge padding, ``v_rem`` at columns from ``rem_start``,
    ``v_centre`` at the centre tap and ``v_bcast`` at the broadcast taps
    (-1: no such rule)."""
    kind: int
    sep: int
    lead: bool
    trail: bool
    v_int: int
    v_pad: int
    v_rem: int
    rem_start: int
    v_centre: int = -1
    v_bcast: int = -1


class Plan(NamedTuple):
    variants: tuple[Variant, ...]
    sums: tuple[Sum, ...]


def is_tiny(h: int, w: int, n: int) -> bool:
    """Whether K1 takes its tiny form: at most ``n`` rows or columns."""
    return h <= n or w <= n


@functools.lru_cache(maxsize=64)
def _taps(n: int, sigma: float) -> tuple[np.ndarray, ...]:
    g, xg, xxg, invG = prepare_gaussian(n, sigma)
    igs = np.array([invG[1, 1], invG[0, 3], invG[3, 3], invG[5, 5]], np.float32)
    return tuple(np.asarray(k, np.float32) for k in (g, xg, xxg)) + (igs,)


def _sums(v_of, sep3: int, sep: dict | None = None, lead: bool = False, trail: bool = False,
          rem_start: int = 1 << 30) -> tuple[Sum, ...]:
    """The seven sums: ``v_of(slot, src)`` gives a sum's ``(v_int, v_pad,
    v_rem, v_centre, v_bcast)``, ``src`` being the vertical sum it reads; the
    x^2 plane's two sums round ``sep3`` on their own, the others ``sep``."""
    read = (XG, G, XXG, G, G, G, XG)
    return tuple(Sum(kind, sep3 if slot in (4, 5) else (sep or {}).get(slot, 0), lead, trail,
                     *v_of(slot, src)[:3], rem_start, *v_of(slot, src)[3:])
                 for slot, (kind, src) in enumerate(zip(SUM_KINDS, read)))


@functools.lru_cache(maxsize=256)
def tiny_plan(h: int, w: int, n: int, sigma: float) -> Plan:
    """The rounding plan of K1 at a tiny shape (:func:`is_tiny`)."""
    if not is_tiny(h, w, n):
        raise ValueError(f"{h}x{w} is not a tiny shape for poly_n {n}")
    g, xg, xxg, _ = _taps(n, float(sigma))
    full = (1 << (2 * n + 1)) - 1
    cen, ends = 1 << n, 1 | (1 << (2 * n))
    both = sum(1 << k for k in range(2 * n + 1) if g[k] == xxg[k] and g[k] != 0.0)
    narrow = w + n < 128
    if h == 1 and (w == 1 or w > n):
        # one row: every symmetric pair of products is one product
        variants = (Variant(G, full & ~cen), Variant(XG, full & ~cen & ~ends),
                    Variant(XXG, full & ~cen))
        pair = {s: (full & ~cen & ~ends) if k == XG else full & ~cen
                for s, k in enumerate(SUM_KINDS)} if w == 1 else {}
        return Plan(variants, _sums(lambda s, src: (src, src, src, -1, -1),
                                    both if w > 1 else pair[4], sep=pair))
    if w == 1 and h > n:
        variants = (Variant(G), Variant(XG), Variant(XXG), Variant(G, both), Variant(XXG, both))
        pair = {s: (full & ~cen & ~ends) if k == XG else full & ~cen
                for s, k in enumerate(SUM_KINDS)}

        def v_of(slot, src):
            v = {2: 4, 3: 3}.get(slot, src)   # the y^2 plane reads both-shared sums
            return v, v, v, -1, -1
        return Plan(variants, _sums(v_of, pair[4], sep=pair))
    if 2 <= h <= n < w:
        # rows: interior (I), edge (E) and recomputed (N, B) vertical sums
        variants = (Variant(G, lead=True), Variant(XG, lead=True), Variant(XXG, lead=True),
                    Variant(G, lead=True, trail=True), Variant(XG, lead=True, trail=True),
                    Variant(XXG, lead=True, trail=True), Variant(G), Variant(XG),
                    Variant(G, both), Variant(XXG, both))
        centre = {0: 7, 2: 9, 3: 8, 5: 6}

        def v_of(slot, src):
            return src, src + 3, src + 3, centre.get(slot, -1), -1
        rem = w if narrow else 8 * (w // 8)
        return Plan(variants, _sums(v_of, both, rem_start=rem))
    if w == n < h:
        up = 1 << (n + 1)
        variants = (Variant(G), Variant(XG), Variant(XXG), Variant(XG, up), Variant(G, up),
                    Variant(XXG, both), Variant(G, both, swap=True))
        rec = {0: 3, 1: 4, 2: 5, 3: 6, 4: 4, 5: 4, 6: 3}

        def v_of(slot, src):
            return src, src, src, rec[slot], rec[slot]
        return Plan(variants, _sums(v_of, both, lead=True, trail=True))
    # the wide shapes' rounding (narrow form): not yet XLA's at these shapes
    variants = (Variant(G), Variant(XG), Variant(XXG), Variant(G, both), Variant(XXG, both))
    centre = {2: 4, 3: 3} if narrow else {}
    return Plan(variants, _sums(lambda s, src: (src, src, src, centre.get(s, -1), -1), both))


def plan_array(plan: Plan) -> np.ndarray:
    """The plan as the int32 array ``datmo_poly_exp_tiny`` reads: the variant
    count, ``MAX_VARIANTS`` rows of (kind, sep, swap, lead, trail), then the
    seven sums' (kind, sep, lead, trail, v_int, v_pad, v_rem, rem_start,
    v_centre, v_bcast)."""
    out = np.zeros(PLAN_INTS, np.int32)
    out[0] = len(plan.variants)
    for i, v in enumerate(plan.variants):
        out[1 + 5 * i:6 + 5 * i] = [v.kind, v.sep, v.swap, v.lead, v.trail]
    base = 1 + 5 * MAX_VARIANTS
    for i, s in enumerate(plan.sums):
        out[base + 10 * i:base + 10 * (i + 1)] = [s.kind, s.sep, s.lead, s.trail, s.v_int,
                                                  s.v_pad, s.v_rem, min(s.rem_start, 1 << 30),
                                                  s.v_centre, s.v_bcast]
    return out


def chain_ops(ks: list[int], sep: int, swap: bool, lead: bool, trail: bool, bc) -> list[int]:
    """:func:`_chain`'s rounding of the terms of taps ``ks`` (ascending), as
    one operation per tap (:data:`OPS` of them, :data:`SKIP` where a tap is
    no term): :data:`FIRST` ``out = c * x`` (kept as the first product),
    :data:`FUSE0` ``out = fma(x0, c0, c * x)``, :data:`FMA` ``out = fma(x, c,
    out)``, :data:`ADD` ``out = out + c * x``.  ``bc(k)``: tap ``k`` is a
    broadcast tap."""
    t = len(ks)
    n_lead = 0
    while lead and n_lead < t and bc(ks[n_lead]):
        n_lead += 1
    end = t
    while trail and end > n_lead and bc(ks[end - 1]):
        end -= 1
    ops = [SKIP] * OPS
    ops[ks[0]] = FIRST
    q = 1
    if (n_lead or end) >= 2:
        s0, s1 = sep >> ks[0] & 1, sep >> ks[1] & 1
        ops[ks[1]] = FMA if (swap or s0) and not s1 else FUSE0 if not s0 else ADD
        q = 2
    for i in range(q, t):
        ops[ks[i]] = ADD if i >= end or sep >> ks[i] & 1 else FMA
    return ops


def tiny_tiles(h: int, w: int, n: int, nv: int) -> tuple[int, int]:
    """The output tile (rows, columns) of one block of the tiny kernel: all
    of a short axis (at most ``n``) by up to :data:`TILE` of the long one.
    A thread's chains run one after another, so the tile is the one whose
    grid takes the fewest rounds of them: the blocks' waves (:data:`FILL`
    at a time) times the chains per thread of stage 1 (``nv`` variants at
    the rows and staged columns) and of stage 2 (seven sums a pixel); the
    widest such tile.  A tall or a wide image spreads over many blocks."""
    def tile(t):
        return (h, min(w, t)) if h <= n else (min(h, t), w)

    def rounds(t):
        rows, cols = tile(t)
        blocks = -(-h // rows) * -(-w // cols)
        chains = (-(-nv * rows * min(w, cols + 2 * n) // THREADS)
                  + -(-7 * rows * cols // THREADS))
        return -(-blocks // FILL) * chains, -t

    return tile(min(range(1, TILE + 1), key=rounds))


def tiny_smem_bytes(w: int, n: int, nv: int, tile: tuple[int, int]) -> int:
    """Shared memory of one block: ``nv`` vertical-sum variants at the
    tile's rows and at its columns with their ``n``-column halo inside the
    image, the seven horizontal sums at each pixel of the tile, and
    :data:`STATIC_SMEM`."""
    rows, cols = tile
    return 4 * rows * (nv * min(w, cols + 2 * n) + 7 * cols) + STATIC_SMEM


@functools.lru_cache(maxsize=256)
def tiny_program(h: int, w: int, n: int, sigma: float) -> np.ndarray:
    """The int32 program ``datmo_poly_exp_tiny`` runs (its ``TinyProgram``):
    the variant count and the tile (:func:`tiny_tiles`); per variant of
    :func:`tiny_plan` (``MAX_VARIANTS`` rows) its taps' kind and
    :func:`chain_ops`; per horizontal sum its kind, ops, each tap's fixed
    variant (the centre's or a broadcast tap's, else -1), then ``v_int``,
    ``v_pad``, ``v_rem`` and ``rem_start``."""
    plan = tiny_plan(h, w, n, float(sigma))
    kerns = _taps(n, float(sigma))[:3]
    out = np.zeros(PROGRAM_INTS, np.int32)
    out[:3] = (len(plan.variants), *tiny_tiles(h, w, n, len(plan.variants)))
    at = 3
    for v in plan.variants:
        c = kerns[v.kind]
        ks = [k for k in range(2 * n + 1) if not (v.kind == XG and c[k] == 0.0)]
        out[at] = v.kind
        out[at + 1:at + 1 + OPS] = chain_ops(ks, v.sep, v.swap, v.lead, v.trail,
                                             lambda k: k <= n - h or k >= n + h)
        at += 1 + OPS
    at = 3 + MAX_VARIANTS * (1 + OPS)

    def hbc(k):
        return k <= n - w or k >= n + w

    for s in plan.sums:
        c = kerns[s.kind]
        ks = [k for k in range(2 * n + 1) if c[k] != 0.0]
        fix = [s.v_centre if k == n and s.v_centre >= 0 else
               s.v_bcast if hbc(k) and s.v_bcast >= 0 else -1 for k in range(OPS)]
        out[at] = s.kind
        out[at + 1:at + 1 + OPS] = chain_ops(ks, s.sep, False, s.lead, s.trail, hbc)
        out[at + 1 + OPS:at + 1 + 2 * OPS] = fix
        out[at + 1 + 2 * OPS:at + SUM_INTS] = (s.v_int, s.v_pad, s.v_rem,
                                                min(s.rem_start, 1 << 30))
        at += SUM_INTS
    return out


def _chain(terms: list, sep: int, swap: bool, lead: bool, trail: bool, bc) -> torch.Tensor:
    """``sum(c * x for k, c, x in terms)`` in tap order, rounded by the flags
    (see :class:`Variant`): the head sum takes a chain of once-rounded
    multiply-adds, its first product fused into the add of the second (the
    second into the first with ``swap`` or where the first is in ``sep``);
    ``sep`` products are added rounded."""
    fma = round_kernels.fma32_reference
    t = len(terms)
    n_lead = 0
    while lead and n_lead < t and bc(terms[n_lead][0]):
        n_lead += 1
    end = t
    while trail and end > n_lead and bc(terms[end - 1][0]):
        end -= 1
    head = terms[:n_lead or end]
    (k0, c0, x0) = head[0]
    if len(head) == 1:
        out = float(c0) * x0
    else:
        (k1, c1, x1) = head[1]
        s0, s1 = bool(sep >> k0 & 1), bool(sep >> k1 & 1)
        if (swap or s0) and not s1:
            out = fma(x1, c1, float(c0) * x0)
        elif not s0:
            out = fma(x0, c0, float(c1) * x1)
        else:
            out = float(c0) * x0 + float(c1) * x1
        for k, c, x in head[2:]:
            out = out + float(c) * x if sep >> k & 1 else fma(x, c, out)
    for k, c, x in terms[len(head):end]:
        out = out + float(c) * x if sep >> k & 1 else fma(x, c, out)
    for k, c, x in terms[end:]:
        out = out + float(c) * x
    return out


def poly_exp_tiny_reference(img: torch.Tensor, n: int, sigma: float) -> torch.Tensor:
    """Plain version of K1's tiny form: the (5, H, W) planes of a float32
    (H, W) image with ``h <= n or w <= n``, rounded by :func:`tiny_plan`."""
    h, w = img.shape
    plan = tiny_plan(h, w, n, float(sigma))
    g, xg, xxg, igs = _taps(n, float(sigma))
    kerns = (g, xg, xxg)
    pv = fb._pad_axis(img, n, -2, "edge")
    rows = [pv[k:k + h] for k in range(2 * n + 1)]

    def vbc(k):
        return k <= n - h or k >= n + h

    def hbc(k):
        return k <= n - w or k >= n + w

    planes = torch.stack([
        _chain([(k, kerns[v.kind][k], r) for k, r in enumerate(rows)
                if not (v.kind == XG and kerns[v.kind][k] == 0.0)],
               v.sep, v.swap, v.lead, v.trail, vbc)
        for v in plan.variants])                               # (nv, h, w)
    j = torch.arange(w, device=img.device)
    sums = []
    for s in plan.sums:
        terms = []
        for k, c in enumerate(kerns[s.kind]):
            if c == 0.0:
                continue
            col = j + (k - n)
            inside = (col >= 0) & (col < w)
            v = torch.where(inside, torch.where(col >= s.rem_start, s.v_rem, s.v_int), s.v_pad)
            col = col.clamp(0, w - 1)
            if hbc(k) and s.v_bcast >= 0:
                v = torch.full_like(v, s.v_bcast)
            if k == n and s.v_centre >= 0:
                v, col = torch.full_like(v, s.v_centre), j
            terms.append((k, c, planes[v, :, col].T))
        sums.append(_chain(terms, s.sep, False, s.lead, s.trail, hbc))
    ig11, ig03, ig33, ig55 = (float(x) for x in igs)
    fma = round_kernels.fma32_reference
    return torch.stack([sums[0] * ig11, sums[1] * ig11,
                        fma(sums[2], ig33, sums[3] * ig03), fma(sums[4], ig33, sums[5] * ig03),
                        sums[6] * ig55])
