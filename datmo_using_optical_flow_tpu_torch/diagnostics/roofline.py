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

# K3/K4's per-pixel warp and M assembly (csrc/flow_kernels.cu::warp_assemble):
# positions, floors and fractions 6; the inside test 4; bilinear weights 6;
# five planes x (4 mul + 3 add) 35; r2..r6 from R0 and the warp 10; the flow
# terms 8; the border attenuation 6; the five M values 14.
WARP_M_OPS = 89
# K2's per-pixel solve: five scales, the regularised determinant and its
# reciprocal (5), dx and dy (4 each).
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


def blur_solve(h: int, w: int, winsize: int = 15) -> Work:
    """K2: five M planes in, the flow out; two window passes over five planes."""
    return Work(28 * h * w, (10 * (2 * winsize - 1) + SOLVE_OPS) * h * w)


def fused_iteration(h: int, w: int, winsize: int = 15) -> Work:
    """K3: R0 and R1 (ten planes) and the flow in, the new flow out; M stays
    on chip."""
    return Work(56 * h * w, (WARP_M_OPS + 10 * (2 * winsize - 1) + SOLVE_OPS) * h * w)


def warp_matrices(h: int, w: int) -> Work:
    """K4: R0, R1 and the flow in, five M planes out."""
    return Work(68 * h * w, WARP_M_OPS * h * w)


def update_matrices_packed(h: int, w: int) -> Work:
    """The packed-gather ``update_matrices``: R0, the 7-word corner table and
    the flow in, M out.  The unpacking's integer operations are not counted."""
    return Work(76 * h * w, WARP_M_OPS * h * w)


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


def sumsq(rows: int, k: int, root: bool) -> Work:
    """K7's sum of squares: k float32 values in and one out per row; one
    multiply and k - 1 fused multiply-adds, and one more operation for the root."""
    return Work(4 * (k + 1) * rows, (k + int(root)) * rows)



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


def resize(planes: int, h: int, w: int, oh: int, ow: int, scaled: bool) -> Work:
    """K8's resize of ``planes`` (h, w) planes to (oh, ow): each plane in and
    out once; the rows' lerp at the distinct columns read, the columns' lerp
    at every output, and the multiply by the scale when there is one."""
    cols = _read_positions(w, ow)
    return Work(4 * planes * (h * w + oh * ow),
                planes * (2 * oh * cols + (2 + int(scaled)) * oh * ow))
