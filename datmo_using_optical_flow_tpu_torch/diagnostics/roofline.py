"""The work of each kernel and the least time an H100 could take for it.

The bound of a call is the larger of two times: the bytes the function must
move (each input read once, each output written once) over the card's memory
rate, and its float32 operations over the card's float32 instruction rate
outside the tensor cores, which none of the port's kernels uses.  The memory
rate is the H100 SXM's published 3.35 TB/s (HBM3).  The operation rate is
33.5e12 separately rounded float32 instructions per second: 132 SMs x 128
float32 lanes x 1.98 GHz.  The published 67 TFLOP/s counts a fused
multiply-add as two operations; the kernels are built with ``-fmad=false``
(``kernels/build.py``), so none of their operations is fused, and each
counted operation below is one instruction.  Both rates hold at the card's
700 W limit.

Operations are counted from the kernels' code (``csrc/*.cu``): each add,
multiply, divide, compare or floor is one.  They
are counted per output pixel for the flow kernels, without the halo that the
windowed kernels recompute (the bound is for the work, not for one design of
it), and per (source row, target) pair in the visited tiles for the 1-NN
sweep, whose work depends on the data.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from datmo_using_optical_flow_tpu_torch.oracle.np_farneback import prepare_gaussian

HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 33.5e12  # separately rounded instructions (see above)
SMS = 132

# K3/K4's per-pixel warp and M assembly (csrc/flow_kernels.cu::warp_assemble),
# a once-rounded fma counted as two: positions, floors and fractions 6; the
# inside test 4; bilinear weights 6; five planes x (4 mul + 3 add) 35; r2..r6
# from R0 and the warp 10; the flow terms 8; the border attenuation and its
# square 7; the five M values 23.
WARP_M_OPS = 99
# K9's packed warp adds the five planes' scales (an fma each) and quantises
# its 20 corners (a multiply, a rounding and a clamp of two compares each;
# the test beside them and the rare division not counted).
WARP_PACKED_OPS = WARP_M_OPS + 10 + 20 * 4
# K2's per-pixel solve: five scales, the regularised determinant and its
# reciprocal (5), the numerators (3 each), dx and dy (1 each).
SOLVE_OPS = 18
# K5 per (source row, target) pair: the cross product 5, d2 = tn - 2 cross 2,
# and the running minimum, tie and second-minimum tests 3.
NN_PAIR_OPS = 10
NN_BLOCK = 256  # source rows per block == targets per tile (ops/nn_kernels.py)


class Work(NamedTuple):
    bytes: int
    ops: int

    def bound_us(self) -> float:
        return max(self.bytes / HBM_BYTES_PER_S, self.ops / FP32_OPS_PER_S) * 1e6

    def bound_by(self) -> str:
        return "bytes" if self.bytes / HBM_BYTES_PER_S >= self.ops / FP32_OPS_PER_S \
            else "operations"


def poly_exp(h: int, w: int, n: int = 5, sigma: float = 5.0) -> Work:
    """K1: the image in, five planes out.  Vertical correlations of g and xxg
    keep every tap, xg skips its zero ones; the seven horizontal correlations
    (the x^2 plane rounds a g sum of its own) skip taps that are zero in
    float32; then 9 for the inverse-Gram scaling.  An fma counts as two."""
    g, xg, xxg, _ = prepare_gaussian(n, sigma)
    taps = 2 * n + 1
    nz = [int(np.count_nonzero(np.asarray(k, np.float32))) for k in (g, xg, xxg)]
    vertical = (2 * taps - 1) + (2 * nz[1] - 1) + (2 * taps - 1)
    horizontal = 4 * (2 * nz[0] - 1) + 2 * (2 * nz[1] - 1) + (2 * nz[2] - 1)
    return Work(24 * h * w, (vertical + horizontal + 9) * h * w)


def blur_solve(h: int, w: int, winsize: int = 15, planes_out: int = 2) -> Work:
    """K2: five M planes in, the flow out; two window passes over five planes.
    Between iterations the flow out is three planes, the numerators and
    1 / det (``planes_out`` 3)."""
    return Work((20 + 4 * planes_out) * h * w, (10 * (2 * winsize - 1) + SOLVE_OPS) * h * w)


def fused_iteration(h: int, w: int, winsize: int = 15, planes_in: int = 2,
                    planes_out: int = 2) -> Work:
    """K3: R0 and R1 (ten planes) and the flow in, the new flow out; M stays
    on chip.  Between iterations the flow is three planes, the numerators
    and 1 / det (``planes_in``, ``planes_out`` 3)."""
    return Work((40 + 4 * (planes_in + planes_out)) * h * w,
                (WARP_M_OPS + 10 * (2 * winsize - 1) + SOLVE_OPS) * h * w)


def warp_matrices(h: int, w: int, planes_in: int = 2, halo_rows: int = 0) -> Work:
    """K4: R0, R1 and the flow in, five M planes out.  Between iterations the
    flow in is three planes, the numerators and 1 / det (``planes_in`` 3); a
    rank's block of the row-sharded flow also reads R1's ``halo_rows`` rows
    above and below it."""
    return Work((60 + 4 * planes_in) * h * w + 20 * 2 * halo_rows * w, WARP_M_OPS * h * w)


def warp_packed(h: int, w: int) -> Work:
    """K9, the packed ``update_matrices``: R0, R1 and the flow in, M out
    (the five scales' 20 bytes not counted); each corner quantised from R1
    (``WARP_PACKED_OPS``, every pixel's counted)."""
    return Work(68 * h * w, WARP_PACKED_OPS * h * w)


def corner_scale(h: int, w: int) -> Work:
    """K9's scale pass: R1's five planes in, five scales out; an absolute
    value and a maximum per value."""
    return Work(20 * h * w + 20, 10 * h * w)


def nearest_neighbors(n_src: int, n_tgt: int, tile_visits: int, live_blocks: int) -> Work:
    """K5 for this call's data: the sources, the index's coordinates, norms and
    ids, the pruning-table entries the live blocks read (each visited tile's
    and the one that stops the block) and 7 outputs per row; ``NN_PAIR_OPS``
    per (row, target) pair of the ``tile_visits`` visited (block, tile) pairs."""
    n_blocks = -(-n_src // NN_BLOCK)
    m_tiles = -(-n_tgt // NN_BLOCK)
    nbytes = (12 * n_src + 4 * n_blocks + 8 * (tile_visits + live_blocks)
              + 20 * m_tiles * NN_BLOCK + 28 * n_blocks * NN_BLOCK)
    return Work(nbytes, NN_PAIR_OPS * tile_visits * NN_BLOCK * NN_BLOCK)


def nearest_neighbors_serial_us(max_visits: int, cluster: int = 1) -> float:
    """K5's serial bound: the busiest block's ``max_visits`` tiles of
    ``NN_PAIR_OPS`` x 256 x 256 operations at one SM's share of the rate,
    split over the ``cluster`` SMs that share the block's walk.  When it
    exceeds the work bound, the longest walk, not the total work, sets the
    least time."""
    ops = NN_PAIR_OPS * max_visits * NN_BLOCK * NN_BLOCK
    return ops / (FP32_OPS_PER_S / SMS) / cluster * 1e6


def tiny(numel: int) -> Work:
    """K6: ``x + 1``, one float32 in and out per element."""
    return Work(8 * numel, numel)


def fma32(numel: int, tensor_inputs: int, root: bool) -> Work:
    """K7's fma: ``tensor_inputs`` distinct float32 arrays in (an operand given
    as a number is not read), one out; one fused multiply-add per element,
    and one more operation for the root."""
    return Work(4 * (tensor_inputs + 1) * numel, (1 + int(root)) * numel)


def transform_points(n: int) -> Work:
    """K7's ``transform_points``: n float32 points (3 values each) in, the
    12 values of [R | t] in once, n points out; per output value a multiply,
    two fused multiply-adds and an add."""
    return Work(4 * (3 * n + 12 + 3 * n), 4 * 3 * n)


def sumsq(rows: int, k: int, root: bool) -> Work:
    """K7's sum of squares: k float32 values in and one out per row; one
    multiply and k - 1 fused multiply-adds, and one more operation for the root."""
    return Work(4 * (k + 1) * rows, (k + int(root)) * rows)


def sumsq_diff(a_values: int, b_values: int, rows: int, k: int, root: bool) -> Work:
    """K7's sum of squares of a difference ``a - b``: the distinct float32
    values of ``a`` and of ``b`` in (an operand broadcast over rows is read
    once), one out per row; per row k subtractions, one multiply and k - 1
    fused multiply-adds, and one more operation for the root."""
    return Work(4 * (a_values + b_values + rows), (2 * k + int(root)) * rows)



def _read_positions(size: int, out: int) -> int:
    """The distinct source positions cv2's INTER_LINEAR resize of an axis of
    ``size`` to ``out`` reads (its i0 and i1, ``ops/farneback.resize_table``)."""
    f = (np.arange(out, dtype=np.float64) + 0.5) * (size / out) - 0.5
    i0 = np.clip(np.floor(f), 0, max(size - 2, 0)).astype(np.int64)
    return len(np.union1d(i0, np.minimum(i0 + 1, size - 1)))


def level_image(h: int, w: int, lh: int, lw: int, taps: int) -> Work:
    """K8's level image: the (h, w) image in, the (lh, lw) level out.  The
    blur is needed only where the resize reads it: the vertical chain (one
    multiply and ``taps`` - 1 fmas for the nonzero taps) at the distinct
    rows the resize reads, over every column; the horizontal chain at those
    rows and the distinct columns it reads; the rows' lerp (a multiply and an
    fma) there; the columns' lerp at every output.  Each fma is one
    instruction here (the rate counts instructions).  At ``(lh, lw) == (h,
    w)`` it is the blur alone: both chains at every pixel."""
    if (lh, lw) == (h, w):
        return Work(8 * h * w, 2 * taps * h * w)
    rows, cols = _read_positions(h, lh), _read_positions(w, lw)
    ops = taps * rows * w + taps * rows * cols + 2 * lh * cols + 2 * lh * lw
    return Work(4 * (h * w + lh * lw), ops)


def level_images(h: int, w: int, levels) -> Work:
    """K8's level images of one frame in one launch, ``levels`` a sequence of
    (lh, lw, taps): the image read once, every level written once, and the
    sum of the levels' operations (:func:`level_image`)."""
    ops = sum(level_image(h, w, lh, lw, taps).ops for lh, lw, taps in levels)
    return Work(4 * (h * w + sum(lh * lw for lh, lw, _ in levels)), ops)


def resize(planes: int, h: int, w: int, oh: int, ow: int, scaled: bool) -> Work:
    """K8's resize of ``planes`` (h, w) planes to (oh, ow): each plane in and
    out once; the rows' lerp at the distinct columns read, the columns' lerp
    at every output, and the multiply by the scale when there is one."""
    cols = _read_positions(w, ow)
    return Work(4 * planes * (h * w + oh * ow),
                planes * (2 * oh * cols + (2 + int(scaled)) * oh * ow))
