"""Once-rounded float32 multiply-adds (K7): CUDA kernels, their plain
versions and their launch counters.

XLA's compiled code contracts ``a * b + c`` into one fused multiply-add and
``jnp.sum(v * v, axis=-1)`` over a short last axis into a chain of them, each
rounded once; the JAX package's results at those sites (NN distances, the flow
magnitude, ICP's transform and shells, tracker A's distances, GMFA's
residuals, the threefry draws' polynomials) depend on it.  PyTorch has no
fused multiply-add, so the plain versions here compute it in float64: the
product of two float32 values is exact there, and the float64 sum rounded to
odd rounds to the nearest float32 as the exact sum would.  That takes about a
dozen elementwise ops per fma, each a launch on the card; the kernels of
``csrc/round_kernels.cu`` do it in one (``__fmaf_rn``, ``__fsqrt_rn``).

Each wrapper dispatches on its inputs' device alone: CPU tensors take the
plain version, CUDA tensors launch the kernel on the current stream (and count
the launch), any other device raises.  Both give the same float32 bits.
Every kernel reads its tensor operands through their strides, so a broadcast
or a view is never copied, and each wrapper works out its launch arguments
once per shape and strides (``_fma32_args``, ``_sumsq_args``,
``_transform_args``).  The sum of squares takes the difference it squares
(``sumsq_fma(a, b)``, ``norm_rn(a, b)``), as XLA fuses ``a - b`` into the
sum; ICP's ``transform_points`` is one launch that reads the 4x4 transform
on the device (XLA's fused ``dot`` and add), where the port made four calls.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from datmo_using_optical_flow_tpu_torch.kernels import build
from datmo_using_optical_flow_tpu_torch.ops import flow_kernels

LAUNCHES = {"fma32": 0, "sumsq": 0, "transform_points": 0}
_FMA32 = build.Entry("datmo_fma32", "fma32")
_TRANSFORM = build.Entry("datmo_transform_points", "transform_points")
_SUMSQ = build.Entry("datmo_sumsq", "sumsq")


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _f32(x: torch.Tensor, what: str) -> torch.Tensor:
    if x.dtype != torch.float32:
        raise TypeError(f"{what}: expected float32, got {x.dtype}")
    return x


# ------------------------------------------------------------------ plain versions

def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """float32 square root rounded to nearest on both devices.  torch's CPU
    ``sqrt`` of float32 is off by an ulp for some inputs; the float64 root
    rounded to float32 is the correctly rounded float32 root (53 >= 2 * 24 + 2),
    as XLA's and the card's are."""
    return torch.sqrt(x.double()).float()


# CPU elements per pass of fma32_reference: its float64 temporaries then stay
# in cache (~2x faster on 1080p planes, one thread or eight)
_FMA_CHUNK = 1 << 17


def _fma_rounded(a: torch.Tensor, b, c) -> torch.Tensor:
    """``fma(a, b, c)`` rounded to float32, for float32 ``a`` and float64 or
    number ``b``, ``c`` that broadcast with it (:func:`fma32_reference`)."""
    p = a.double() * b
    s = p + c
    pv = s - c
    err = (c - (s - pv)).add_(p.sub_(pv))
    # ``err * inf`` is NaN only where ``err`` is 0, where it is not taken
    step = (err != 0) & ((s.view(torch.int64) & 1) == 0) & torch.isfinite(s)
    return torch.where(step, torch.nextafter(s, err.mul_(torch.inf)), s).float()


def fma32_reference(a: torch.Tensor, b, c, root: bool = False) -> torch.Tensor:
    """Plain version of :func:`fma32`.

    The float64 product is exact; the float64 sum is rounded to odd (when
    TwoSum's error is nonzero and the sum's last bit is even, it steps one
    ulp toward the error), and a sum rounded to odd with 53 bits rounds to
    the nearest float32 as the exact sum would.  Where the sum is infinite
    or NaN it is taken as it is, as IEEE's fma gives it.  Large CPU inputs
    go through in passes of ``_FMA_CHUNK`` elements."""
    b = b.double() if isinstance(b, torch.Tensor) else float(np.float32(b))
    c = c.double() if isinstance(c, torch.Tensor) else float(np.float32(c))
    shape = torch.broadcast_shapes(*(x.shape for x in (a, b, c) if isinstance(x, torch.Tensor)))
    n = shape.numel()
    if a.device.type != "cpu" or n <= _FMA_CHUNK:
        out = _fma_rounded(a, b, c)
    else:
        flat = [x.expand(shape).reshape(-1) if isinstance(x, torch.Tensor) else x
                for x in (a, b, c)]
        out = torch.empty(n, dtype=torch.float32)
        for i in range(0, n, _FMA_CHUNK):
            out[i:i + _FMA_CHUNK] = _fma_rounded(
                *(x[i:i + _FMA_CHUNK] if isinstance(x, torch.Tensor) else x for x in flat))
        out = out.reshape(shape)
    return sqrt_rn(out) if root else out


def fma_chain_reference(terms: list, shared: frozenset = frozenset()) -> torch.Tensor:
    """``sum(w * x for i, w, x in terms)`` in tap order, rounded as XLA's CPU
    code rounds such a chain: each product is contracted into the add that
    takes it (a once-rounded fma), the first product into the add of the
    second; a product that two sums of the same output share (taps in
    ``shared``) keeps its own rounding.  ``w`` is a float32 number or
    tensor, ``x`` a float32 tensor.  The correlations of K1's and K8's plain
    versions, the Gaussian window's and the warp's bilinear sums."""
    def prod(w, x):
        return w * x if isinstance(w, torch.Tensor) else float(w) * x

    if len(terms) == 1:
        return prod(terms[0][1], terms[0][2])
    (i0, w0, x0), (i1, w1, x1) = terms[0], terms[1]
    if i0 not in shared:
        out = fma32_reference(x0, w0, prod(w1, x1))
    elif i1 not in shared:
        out = fma32_reference(x1, w1, prod(w0, x0))
    else:
        out = prod(w0, x0) + prod(w1, x1)
    for i, w, x in terms[2:]:
        out = out + prod(w, x) if i in shared else fma32_reference(x, w, out)
    return out


def bits_equal(got: torch.Tensor, want: torch.Tensor) -> bool:
    """Equal float32 bits, NaN where NaN (a NaN's payload is not compared):
    how a kernel of this module is held to its plain version."""
    nan = torch.isnan(want)
    return torch.equal(torch.isnan(got), nan) and torch.equal(
        torch.where(nan, 0.0, got).view(torch.int32), torch.where(nan, 0.0, want).view(torch.int32))


def sumsq_reference(v: torch.Tensor, root: bool = False) -> torch.Tensor:
    """Plain version of :func:`sumsq_fma` (and, with ``root``, of :func:`norm_rn`)."""
    acc = v[..., 0] * v[..., 0]
    for i in range(1, v.shape[-1]):
        acc = fma32_reference(v[..., i], v[..., i], acc)
    return sqrt_rn(acc) if root else acc


def sumsq_diff_reference(a: torch.Tensor, b: torch.Tensor, root: bool = False) -> torch.Tensor:
    """Plain version of the difference form, :func:`sumsq_fma` (:func:`norm_rn`)
    of ``a`` and ``b``: the float32 difference, then :func:`sumsq_reference`."""
    return sumsq_reference(a - b, root)


def transform_points_reference(points: torch.Tensor, transformation: torch.Tensor
                               ) -> torch.Tensor:
    """Plain version of :func:`transform_points`: ``x * r0``, then
    ``fma(y, r1, .)`` and ``fma(z, r2, .)`` (:func:`fma32_reference`), then
    ``+ t``, over the (N, 1) coordinate columns and the rotation's (3,)
    columns."""
    r, t = transformation[:3, :3], transformation[:3, 3]
    x, y, z = (points[:, i:i + 1] for i in range(3))
    acc = x * r[:, 0]
    acc = fma32_reference(y, r[:, 1], acc)
    acc = fma32_reference(z, r[:, 2], acc)
    return acc + t


# ------------------------------------------------------------------ wrappers

def fma32(a: torch.Tensor, b, c, root: bool = False) -> torch.Tensor:
    """``fma(a, b, c)`` of float32 values, rounded once to float32, as XLA's
    compiled code contracts ``a * b + c`` (with ``root``, its correctly
    rounded square root).  ``b`` and ``c`` are float32 tensors that broadcast
    with ``a``, or Python numbers, taken as float32."""
    return _fma32(a, b, c, root)


def _fma32(a: torch.Tensor, b, c, root: bool) -> torch.Tensor:
    # the wrappers' one entry each (this, _sumsq and _transform_points), so
    # that a recorder patched over it sees every call, whichever name the
    # caller imported
    tb, tc = isinstance(b, torch.Tensor), isinstance(c, torch.Tensor)
    if not flow_kernels._on_cuda(a, *(x for x, t in ((b, tb), (c, tc)) if t)):
        return fma32_reference(a, b, c, root)
    _f32(a, "a")
    shape, args = _fma32_args(a.shape, a.stride(), _f32(b, "b").shape if tb else None,
                              b.stride() if tb else None, _f32(c, "c").shape if tc else None,
                              c.stride() if tc else None, root)
    if args is None:  # the kernel walks three axes: merge the others
        a, b, c = (x.expand(shape).reshape(-1, *shape[-2:]) if isinstance(x, torch.Tensor)
                   else x for x in (a, b, c))
        return _fma32(a, b, c, root).reshape(shape)
    out = torch.empty(shape, dtype=torch.float32, device=a.device)
    if out.numel() == 0:
        return out
    _FMA32(a.device.index, out.data_ptr(), a.data_ptr(), b.data_ptr() if tb else None,
           c.data_ptr() if tc else None, 0.0 if tb else float(np.float32(b)),
           0.0 if tc else float(np.float32(c)), *args)
    LAUNCHES["fma32"] += 1
    return out


def _row_strides(shape: tuple, stride: tuple, ndim: int = 3) -> list[int]:
    """An operand's element strides over a broadcast shape of ``ndim`` axes
    (for the sum of squares three: rows, rows, components), leading axes
    added: 0 along a broadcast axis."""
    return [0] * (ndim - len(shape)) + [st if size != 1 else 0 for st, size in zip(stride, shape)]


@functools.lru_cache(maxsize=256)
def _fma32_args(sa: torch.Size, ta: tuple, sb: torch.Size | None, tb: tuple | None,
                sc: torch.Size | None, tc: tuple | None, root: bool) -> tuple[tuple, tuple | None]:
    """For tensor operands of shapes ``sa``, ``sb``, ``sc`` and strides
    ``ta``, ``tb``, ``tc`` (None: a number): the output's shape and
    ``datmo_fma32``'s integer arguments (root, the axes (n0, n1, n2), a's,
    b's and c's element strides over them, flat), worked out once per
    signature.  The output's axes are coalesced first (size-1 axes dropped,
    an axis merged into the next where every operand steps across both
    alike); flat where one axis is left and every operand steps 1 along it.
    The arguments are None past three axes."""
    shape = tuple(sa)
    for s in (sb, sc):
        if s is not None:
            shape = _broadcast(shape, s)
    # a number is read at no address: stride 0, which never stops a merge
    ops = [[0] * len(shape) if s is None else _row_strides(s, t, len(shape))
           for s, t in ((sa, ta), (sb, tb), (sc, tc))]
    axes = []  # (size, [a's, b's, c's stride]), outermost first
    for k, n in enumerate(shape):
        if n == 1:
            continue
        st = [o[k] for o in ops]
        if axes and all(p == q * n for p, q in zip(axes[-1][1], st)):
            axes[-1] = (axes[-1][0] * n, st)
        else:
            axes.append((n, st))
    if len(axes) > 3:
        return shape, None
    flat = len(axes) == 0 or (len(axes) == 1 and
                              axes[0][1] == [int(s is not None) for s in (sa, sb, sc)])
    axes = [(1, [0, 0, 0])] * (3 - len(axes)) + axes
    return shape, (int(root), *(n for n, _ in axes), *(st[i] for i in range(3) for _, st in axes),
                   int(flat))


def _broadcast(sa: torch.Size, sb: torch.Size) -> tuple[int, ...]:
    """The broadcast of two shapes, plain tuple work on the host in place of
    ``torch.broadcast_shapes``, whose host time outweighs the kernel's."""
    if sa == sb:
        return tuple(sa)
    n = max(len(sa), len(sb))
    sa, sb = (1,) * (n - len(sa)) + tuple(sa), (1,) * (n - len(sb)) + tuple(sb)
    if any(x != y and 1 not in (x, y) for x, y in zip(sa, sb)):
        raise ValueError(f"shapes {sa} and {sb} do not broadcast")
    return tuple(y if x == 1 else x for x, y in zip(sa, sb))


@functools.lru_cache(maxsize=256)
def _sumsq_args(sa: torch.Size, ta: tuple, sb: torch.Size | None, tb: tuple | None,
                root: bool) -> tuple[tuple, tuple] | None:
    """For operands of shapes ``sa``, ``sb`` (None: no ``b``) and strides
    ``ta``, ``tb``: the output's shape and ``datmo_sumsq``'s integer
    arguments (k, root, the rows (n0, n1), a's and b's strides), worked out
    once per signature; None past two row axes."""
    shape = tuple(sa) if sb is None else _broadcast(sa, sb)
    if len(shape) > 3:
        return None
    rows = (1,) * (3 - len(shape)) + shape[:-1]
    return shape[:-1], (shape[-1], int(root), rows[-2], rows[-1], *_row_strides(sa, ta),
                        *([0, 0, 0] if sb is None else _row_strides(sb, tb)))


def _sumsq(a: torch.Tensor, b: torch.Tensor | None, root: bool) -> torch.Tensor:
    if not (flow_kernels._on_cuda(a) if b is None else flow_kernels._on_cuda(a, b)):
        return sumsq_reference(a, root) if b is None else sumsq_diff_reference(a, b, root)
    _f32(a, "a")
    plan = (_sumsq_args(a.shape, a.stride(), None, None, root) if b is None else
            _sumsq_args(a.shape, a.stride(), _f32(b, "b").shape, b.stride(), root))
    if plan is None:  # the kernel walks two row axes: merge the others
        shape = a.shape if b is None else _broadcast(a.shape, b.shape)
        a, b = (None if x is None else x.expand(shape).reshape(-1, *shape[-2:]) for x in (a, b))
        return _sumsq(a, b, root).reshape(shape[:-1])
    out = torch.empty(plan[0], dtype=torch.float32, device=a.device)
    if out.numel() == 0:
        return out
    _SUMSQ(a.device.index, out.data_ptr(), a.data_ptr(), None if b is None else b.data_ptr(),
           *plan[1])
    LAUNCHES["sumsq"] += 1
    return out


def sumsq_fma(a: torch.Tensor, b: torch.Tensor | None = None) -> torch.Tensor:
    """``jnp.sum(d * d, axis=-1)`` as XLA's compiled CPU code contracts it, for
    ``d = a - b`` (float32 tensors that broadcast; ``d = a`` without ``b``):
    ``fma(d[k-1], d[k-1], ... fma(d[1], d[1], d[0] * d[0]))``, each step
    rounded once, the difference rounded to float32 first.  On the card one
    launch reads ``a`` and ``b`` through their strides."""
    return _sumsq(a, b, False)


def norm_rn(a: torch.Tensor, b: torch.Tensor | None = None) -> torch.Tensor:
    """``sqrt_rn(sumsq_fma(a, b))``: the contracted sum's correctly rounded root."""
    return _sumsq(a, b, True)


# ------------------------------------------------------------------ ICP's transform

def transform_points(points: torch.Tensor, transformation: torch.Tensor) -> torch.Tensor:
    """``(R @ p) + t`` of each (N, 3) point by a 4x4 transform, rounded as
    XLA's fused ``dot`` and add: ``fma(z, r2, fma(y, r1, x * r0)) + t``, each
    step rounded once (:func:`transform_points_reference`).  On the card one
    launch reads the points through their strides and the transform where it
    lies, on the device."""
    return _transform_points(points, transformation)


def _transform_points(points: torch.Tensor, transformation: torch.Tensor) -> torch.Tensor:
    if not flow_kernels._on_cuda(points, transformation):
        return transform_points_reference(points, transformation)
    n, *args = _transform_args(_f32(points, "points").shape, points.stride(),
                               _f32(transformation, "transformation").shape,
                               transformation.stride())
    out = torch.empty((n, 3), dtype=torch.float32, device=points.device)
    if n == 0:
        return out
    _TRANSFORM(points.device.index, out.data_ptr(), points.data_ptr(),
               transformation.data_ptr(), n, *args)
    LAUNCHES["transform_points"] += 1
    return out


@functools.lru_cache(maxsize=64)
def _transform_args(sp: torch.Size, tp: tuple, sm: torch.Size, tm: tuple) -> tuple[int, ...]:
    """``datmo_transform_points``' integer arguments for points of shape
    ``sp`` and strides ``tp`` and a transform of shape ``sm`` and strides
    ``tm``: (N, the points' two strides, the transform's two), once per
    signature.  The points are (N, >= 3) (the first three columns are read),
    the transform at least 3x4 (``[:3, :3]`` and ``[:3, 3]``), as the plain
    version takes them."""
    if len(sp) != 2 or sp[1] < 3:
        raise ValueError(f"points: expected (N, 3), got {tuple(sp)}")
    if len(sm) != 2 or sm[0] < 3 or sm[1] < 4:
        raise ValueError(f"transformation: expected 4x4, got {tuple(sm)}")
    return (sp[0], *tp, *tm)
