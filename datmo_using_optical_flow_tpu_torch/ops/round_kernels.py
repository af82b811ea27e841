"""Once-rounded float32 multiply-adds (K7): CUDA kernels, their plain
versions and their launch counters.

XLA's compiled code contracts ``a * b + c`` into one fused multiply-add and
``jnp.sum(v * v, axis=-1)`` over a short last axis into a chain of them, each
rounded once; the JAX package's results at those sites (NN distances, the flow
magnitude, ICP's rotation and shells, tracker A's distances, GMFA's
residuals, the threefry draws' polynomials) depend on it.  PyTorch has no
fused multiply-add, so the plain versions here compute it in float64: the
product of two float32 values is exact there, and the float64 sum rounded to
odd rounds to the nearest float32 as the exact sum would.  That takes about a
dozen elementwise ops per fma, each a launch on the card; the kernels of
``csrc/round_kernels.cu`` do it in one (``__fmaf_rn``, ``__fsqrt_rn``).

Each wrapper dispatches on its inputs' device alone: CPU tensors take the
plain version, CUDA tensors launch the kernel on the current stream (and count
the launch), any other device raises.  Both give the same float32 bits.
"""

from __future__ import annotations

import numpy as np
import torch

from datmo_using_optical_flow_tpu_torch.kernels import build
from datmo_using_optical_flow_tpu_torch.ops import flow_kernels

LAUNCHES = {"fma32": 0, "sumsq": 0}
_FMA32 = build.Entry("datmo_fma32", "fma32")
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


def fma32_reference(a: torch.Tensor, b, c, root: bool = False) -> torch.Tensor:
    """Plain version of :func:`fma32`.

    The float64 product is exact; the float64 sum is rounded to odd (when
    TwoSum's error is nonzero and the sum's last bit is even, it steps one
    ulp toward the error), and a sum rounded to odd with 53 bits rounds to
    the nearest float32 as the exact sum would.  Where the sum is infinite
    or NaN it is taken as it is, as IEEE's fma gives it."""
    b = b.double() if isinstance(b, torch.Tensor) else float(np.float32(b))
    c = c.double() if isinstance(c, torch.Tensor) else float(np.float32(c))
    p = a.double() * b
    s = p + c
    pv = s - c
    err = (c - (s - pv)) + (p - pv)
    # ``err * inf`` is NaN only where ``err`` is 0, where it is not taken
    step = (err != 0) & ((s.view(torch.int64) & 1) == 0) & torch.isfinite(s)
    out = torch.where(step, torch.nextafter(s, err * torch.inf), s).float()
    return sqrt_rn(out) if root else out


def fma_chain_reference(terms: list, shared: frozenset = frozenset()) -> torch.Tensor:
    """``sum(w * x for i, w, x in terms)`` in tap order, rounded as XLA's CPU
    code rounds such a chain: each product is contracted into the add that
    takes it (a once-rounded fma), the first product into the add of the
    second; a product that two sums of the same output share (taps in
    ``shared``) keeps its own rounding.  ``w`` is a float32 number, ``x`` a
    float32 tensor.  The correlations of K1's and K8's plain versions."""
    def prod(w, x):
        return float(w) * x

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


# ------------------------------------------------------------------ wrappers

def fma32(a: torch.Tensor, b, c, root: bool = False) -> torch.Tensor:
    """``fma(a, b, c)`` of float32 values, rounded once to float32, as XLA's
    compiled code contracts ``a * b + c`` (with ``root``, its correctly
    rounded square root).  ``b`` and ``c`` are float32 tensors that broadcast
    with ``a``, or Python numbers, taken as float32."""
    return _fma32(a, b, c, root)


def _fma32(a: torch.Tensor, b, c, root: bool) -> torch.Tensor:
    # the wrappers' one entry each (this and _sumsq), so that a recorder
    # patched over it sees every call, whichever name the caller imported
    tensors = [x for x in (a, b, c) if isinstance(x, torch.Tensor)]
    if not flow_kernels._on_cuda(*tensors):
        return fma32_reference(a, b, c, root)
    for x, what in zip((a, b, c), "abc"):
        if isinstance(x, torch.Tensor):
            _f32(x, what)
    shape = torch.broadcast_shapes(*(x.shape for x in tensors))

    def full(x):  # (contiguous tensor, scalar), with the tensor None for a number
        if not isinstance(x, torch.Tensor):
            return None, float(np.float32(x))
        return x.expand(shape).contiguous(), 0.0

    (af, _), (bf, bs), (cf, cs) = full(a), full(b), full(c)
    out = torch.empty(shape, dtype=torch.float32, device=a.device)
    if out.numel() == 0:
        return out
    _FMA32(a.device.index, out.data_ptr(), af.data_ptr(),
           None if bf is None else bf.data_ptr(), None if cf is None else cf.data_ptr(),
           bs, cs, int(root), out.numel())
    LAUNCHES["fma32"] += 1
    return out


def _sumsq(v: torch.Tensor, root: bool) -> torch.Tensor:
    if not flow_kernels._on_cuda(v):
        return sumsq_reference(v, root)
    _f32(v, "v")
    k = v.shape[-1]
    rows = v.reshape(-1, k).contiguous()
    out = torch.empty(v.shape[:-1], dtype=torch.float32, device=v.device)
    if out.numel() == 0:
        return out
    _SUMSQ(v.device.index, out.data_ptr(), rows.data_ptr(), k, int(root), rows.shape[0])
    LAUNCHES["sumsq"] += 1
    return out


def sumsq_fma(v: torch.Tensor) -> torch.Tensor:
    """``jnp.sum(v * v, axis=-1)`` as XLA's compiled CPU code contracts it:
    ``fma(v[k-1], v[k-1], ... fma(v[1], v[1], v[0] * v[0]))``, each step
    rounded once, for a float32 ``v``."""
    return _sumsq(v, False)


def norm_rn(v: torch.Tensor) -> torch.Tensor:
    """``sqrt_rn(sumsq_fma(v))``: the contracted sum's correctly rounded root."""
    return _sumsq(v, True)
