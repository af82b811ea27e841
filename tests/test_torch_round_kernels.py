"""The port's once-rounded float32 operations (K7, ``ops/round_kernels``) on
the CPU, where each wrapper takes its plain version: ``fma32`` with IEEE's
infinities and NaNs, ``sumsq_fma`` and ``norm_rn`` against exact rational
arithmetic rounded once per step, the Python-number operands and
broadcasting that the callers use, and the dispatch (no launch counted on the
CPU, any other device refused).  Tolerance: none, bits equal.

The JAX side of these values is held by ``test_torch_nn_fma.py`` and
``test_torch_sqrt_sites.py`` (each site against its compiled JAX function),
the sum of squares of a difference here too (each site's JAX lines jitted
with their operands as the site makes them), and the kernels by
``chip_smoke.py`` (each equal to its plain version on the card).
"""

from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from datmo_using_optical_flow_tpu_torch.ops import icp as ticp
from datmo_using_optical_flow_tpu_torch.ops import round_kernels as rk
from datmo_using_optical_flow_tpu_torch.utils import ordered
from torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)

INF = float("inf")


def _bits(x: np.ndarray) -> np.ndarray:
    return np.asarray(x, np.float32).view(np.uint32)


def _round_exact(x: Fraction) -> np.float32:
    """The float32 nearest the rational ``x``, ties to even."""
    f = np.float32(float(x))
    cands = (np.nextafter(f, np.float32(-np.inf)), f, np.nextafter(f, np.float32(np.inf)))
    return min(cands, key=lambda c: (abs(Fraction(float(c)) - x),
                                     int(np.asarray(c).view(np.int32)) & 1))


def test_fma32_keeps_infinities_and_nans():
    """IEEE's fma: an infinite product or addend gives that infinity, inf - inf
    and inf * 0 give NaN, and a finite product past float32's range rounds to
    inf.  Before the plain version took an infinite sum as it is, TwoSum's
    error (inf - inf) was NaN and the rounding-to-odd step turned every
    infinity into NaN."""
    a = torch.tensor([INF, 2.0, -INF, 1.0, INF, 1e30, 3.0, float("nan")])
    b = torch.tensor([2.0, INF, 1.0, 1.0, 0.0, 1e30, 2.0, 1.0])
    c = torch.tensor([1.0, -5.0, INF, INF, 1.0, 0.0, -INF, 1.0])
    got = rk.fma32(a, b, c).numpy()
    want = np.float32([INF, INF, np.nan, INF, np.nan, INF, -INF, np.nan])
    np.testing.assert_array_equal(got, want)
    assert np.isnan(rk.fma32(a, b, c, root=True).numpy()[[2, 4, 6, 7]]).all()
    assert rk.fma32(torch.tensor([INF]), 1.0, 1.0).item() == INF


def test_fma32_broadcasts_and_takes_numbers():
    """The rotation's ``fma32(y, r[:, 1], acc)`` shapes and the draws' number
    operands give what the full-size tensors give."""
    rng = np.random.default_rng(3)
    y = torch.from_numpy(rng.standard_normal((50, 1)).astype(np.float32))
    r = torch.from_numpy(rng.standard_normal(3).astype(np.float32))
    acc = torch.from_numpy(rng.standard_normal((50, 3)).astype(np.float32))
    full = rk.fma32(y.expand(50, 3).contiguous(), r.expand(50, 3).contiguous(), acc)
    assert torch.equal(rk.fma32(y, r, acc), full)
    x = torch.from_numpy(rng.uniform(0, 1, 64).astype(np.float32))
    assert torch.equal(rk.fma32(x, 0.1, -2.5),
                       rk.fma32(x, torch.full_like(x, 0.1), torch.full_like(x, -2.5)))
    assert torch.equal(rk.fma32(x, x, 1.0, root=True), rk.sqrt_rn(rk.fma32(x, x, 1.0)))


@pytest.mark.parametrize("k", [1, 2, 3, 4])
def test_sumsq_and_norm_round_each_step_once(k):
    """``sumsq_fma`` is ``fma(v[k-1], v[k-1], ... v[0] * v[0])`` with each step
    rounded once from the exact value; ``norm_rn`` is its correctly rounded
    root.  Rows of mixed scale, so that later terms round into the sum."""
    rng = np.random.default_rng(10 + k)
    v = (rng.standard_normal((400, k)) * rng.choice([1e-3, 1.0, 30.0], (400, k))
         ).astype(np.float32)
    want = []
    for row in v:
        acc = np.float32(row[0] * row[0])
        for x in row[1:]:
            acc = _round_exact(Fraction(float(x)) ** 2 + Fraction(float(acc)))
        want.append(acc)
    want = np.float32(want)
    got = rk.sumsq_fma(torch.from_numpy(v)).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want))
    root = rk.norm_rn(torch.from_numpy(v)).numpy()
    np.testing.assert_array_equal(_bits(root), _bits(np.float32(np.sqrt(want.astype(np.float64)))))
    # leading axes kept
    assert torch.equal(rk.sumsq_fma(torch.from_numpy(v).reshape(20, 20, k)),
                       torch.from_numpy(got).reshape(20, 20))


def test_wrappers_take_the_plain_version_on_the_cpu_only():
    rk.reset_launches()
    v = torch.ones(8, 3)
    rk.fma32(v, v, v)
    rk.sumsq_fma(v)
    rk.norm_rn(v)
    assert torch.equal(rk.transform_points(v, torch.eye(4)), v)
    assert rk.LAUNCHES == {"fma32": 0, "sumsq": 0, "transform_points": 0}
    for fn, args in ((rk.fma32, (torch.ones(4, device="meta"), 1.0, 1.0)),
                     (rk.norm_rn, (torch.ones(4, 3, device="meta"),)),
                     (rk.transform_points, (torch.ones(4, 3, device="meta"),
                                            torch.eye(4, device="meta")))):
        with pytest.raises(ValueError, match="no kernel or plain version"):
            fn(*args)
    with pytest.raises(ValueError, match="several devices"):
        rk.transform_points(v, torch.eye(4, device="meta"))


def test_bits_equal_tells_signed_zeros_apart_and_takes_nan_as_nan():
    want = torch.tensor([0.0, float("nan"), 1.0, -float("inf")])
    assert rk.bits_equal(want.clone(), want)
    assert rk.bits_equal(torch.tensor([0.0, -float("nan"), 1.0, -float("inf")]), want)
    assert not rk.bits_equal(torch.tensor([-0.0, float("nan"), 1.0, -float("inf")]), want)
    assert not rk.bits_equal(torch.tensor([0.0, 0.0, 1.0, -float("inf")]), want)
    assert not rk.bits_equal(torch.tensor([0.0, float("nan"), float(np.nextafter(
        np.float32(1), np.float32(2))), -float("inf")]), want)


# ------------------------------------------------------------------ the difference form

_SPECIAL = np.float32([np.inf, -np.inf, np.nan, 0.0, -0.0, 1e-40, -3e-39, 3.4e38, -3.4e38, 1.0,
                       1e-20, 1e20, 2.5, -7.0])


def _operands(shape, seed, special):
    """Mixed-scale normals (later terms round into the sum); with
    ``special``, a third of the values from infinities, NaNs, signed zeros,
    subnormals and float32's extremes."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * rng.choice([1e-3, 1.0, 30.0], shape)).astype(np.float32)
    if special:
        pick = rng.random(shape) < 0.33
        x[pick] = rng.choice(_SPECIAL, int(pick.sum()))
    return x


def _assert_bits(got: torch.Tensor, want) -> None:
    assert rk.bits_equal(got, torch.from_numpy(np.array(want)))


def _tracker(k, special):
    """JAX ``models/tracker_a.py:169``: one cluster's features against the
    (64, k) track table, inside ``lax.scan`` as the tracker runs it."""
    feats, track = _operands((32, k), k, special), _operands((64, k), 10 + k, special)

    def dists(feats, track):
        return jax.lax.scan(lambda c, f: (c, jnp.linalg.norm(f[None, :] - track, axis=1)),
                            0, feats)[1]

    want = jax.jit(dists)(feats, track)
    tf, tt = torch.from_numpy(feats), torch.from_numpy(track)
    return ([torch.stack([f(tf[j], tt) for j in range(32)])
             for f in (rk.norm_rn, lambda a, b: rk.sumsq_diff_reference(a, b, True))], want)


def _gmfa_cost(k, special):
    """JAX ``models/gmfa.py:586-587``: the (64, 32) cost of tracks against
    clusters, (64, 1, k) - (1, 32, k)."""
    tf, fe = _operands((64, k), 20 + k, special), _operands((32, k), 30 + k, special)

    def cost(tf, fe):
        diff = tf[:, None, :] - fe[None, :, :]
        return jnp.sqrt(jnp.maximum(jnp.sum(diff * diff, axis=-1), 0.0))

    want = jax.jit(cost)(tf, fe)
    a, b = torch.from_numpy(tf)[:, None, :], torch.from_numpy(fe)[None, :, :]
    return [rk.norm_rn(a, b), rk.sumsq_diff_reference(a, b, True)], want


def _nn_exact_d2(k, special):
    """JAX ``ops/nn.py:78-84``: the exact d2 at the winner, ``src`` less the
    winner's coordinates sliced from the kernel's packed output, where the
    sweep's d2 is finite."""
    n = 2048
    src, packed = _operands((n, k), 40 + k, special), _operands((n, 2 + k), 50 + k, False)
    packed[np.random.default_rng(k).random(n) < 0.1, 0] = np.inf

    def tail(src, packed):
        d2, crd = packed[:, 0], packed[:, 2:2 + k]
        diff = src.astype(jnp.float32) - crd
        return jnp.where(jnp.isfinite(d2), jnp.sum(diff * diff, axis=1), d2)

    want = jax.jit(tail)(src, packed)
    s, p = torch.from_numpy(src), torch.from_numpy(packed)
    fin = torch.isfinite(p[:, 0])
    return [torch.where(fin, ordered.sumsq_fma(s, p[:, 2:2 + k]), p[:, 0]),
            torch.where(fin, ordered.sumsq_diff_reference(s, p[:, 2:2 + k]), p[:, 0])], want


def _icp_lines(k, special):
    """JAX ``ops/icp.py:109, 118-134, 144``: eval_full's d2, eval_cached's
    shell and certificate and the in-place sweep's drift, ``pts`` the moved
    cloud, against the lines jitted together (3-D points only)."""
    n = 20000
    srcf, qpos, qw = (_operands((n, 3), 60 + i, special) for i in range(3))
    tr = np.eye(4, dtype=np.float32)
    tr[:2, :2] = [[np.cos(0.01), -np.sin(0.01)], [np.sin(0.01), np.cos(0.01)]]
    tr[:3, 3] = [0.05, -0.02, 0.01]

    def lines(srcf, transform, qpos, qw):
        pts = srcf @ transform[:3, :3].T + transform[:3, 3]
        diff = pts - qw
        return jnp.stack([jnp.linalg.norm(pts - qpos, axis=1), jnp.sum((pts - qw) ** 2, axis=1),
                          jnp.sum(diff * diff, axis=1), jnp.linalg.norm(pts - srcf, axis=1)])

    want = jax.jit(lines)(srcf, tr, qpos, qw)
    s, q, w = (torch.from_numpy(x) for x in (srcf, qpos, qw))
    pts = ticp.transform_points(s, torch.from_numpy(tr))
    got = torch.stack([rk.norm_rn(pts, q), rk.sumsq_fma(pts, w), rk.sumsq_fma(pts, w),
                       rk.norm_rn(pts, s)])
    plain = torch.stack([rk.sumsq_diff_reference(pts, q, True), rk.sumsq_diff_reference(pts, w),
                         rk.sumsq_diff_reference(pts, w), rk.sumsq_diff_reference(pts, s, True)])
    return [got, plain], want


_SITES = {"tracker_a": _tracker, "gmfa_cost": _gmfa_cost, "nn_exact_d2": _nn_exact_d2,
          "icp": _icp_lines}
_SITE_CASES = [(site, k) for site in _SITES for k in ((3,) if site == "icp" else (2, 3, 4))]


@pytest.mark.parametrize("special", [False, True], ids=["normal", "special"])
@pytest.mark.parametrize("site,k", _SITE_CASES, ids=[f"{s}-k{k}" for s, k in _SITE_CASES])
def test_difference_form_bit_equal_to_jitted_jax(site, k, special):
    """The sum of squares of ``a - b`` (the wrapper on the CPU and its plain
    version, ``sumsq_diff_reference``) equals each call site's JAX lines
    jitted with their operands as the site makes them, bit for bit (a NaN's
    payload aside), broadcast (tracker A's features against its table,
    GMFA's cost matrix) and row by row (the NN query's exact d2, ICP's
    shell, certificate, d2 and drift), at k = 2, 3, 4 where the site allows,
    and with infinities, NaNs, signed zeros and subnormals in the operands.
    (XLA rounds ``jnp.sum((a - b) * (a - b), -1)`` jitted alone over two
    plain (n, k) arrays otherwise: its vector loop does not contract.)"""
    got, want = _SITES[site](k, special)
    for g in got:
        _assert_bits(g, want)


@pytest.mark.parametrize("shapes", [((4,), (64, 4)), ((64, 4), (4,)), ((64, 1, 4), (1, 32, 4)),
                                    ((400, 1, 3), (1, 400, 3)), ((102, 3), (102, 3)), ((7, 3), None),
                                    ((5,), None), ((2, 3, 4, 3), (4, 3)), ((5, 1, 2), (5, 6, 1))],
                         ids=str)
def test_difference_form_reads_each_operand_through_its_strides(shapes):
    """What the kernel reads: each operand at the element strides the
    wrapper passes (``_sumsq_args``: 0 along a broadcast axis; more than two
    row axes merged first) over the rows (n0, n1) and the k components gives
    the plain version's answer, for broadcasts, views and one operand."""
    sa, sb = shapes
    g = torch.Generator().manual_seed(len(sa))
    a = torch.randn(sa, generator=g)
    b = None if sb is None else torch.randn(sb, generator=g)

    def read(a, b):
        plan = rk._sumsq_args(a.shape, a.stride(), None if b is None else b.shape,
                              None if b is None else b.stride(), True)
        if plan is None:
            shape = torch.broadcast_shapes(a.shape, b.shape)
            a, b = (None if x is None else x.expand(shape).reshape(-1, *shape[-2:])
                    for x in (a, b))
            return read(a, b).reshape(shape[:-1])
        out_shape, (k, root, n0, n1, *strides) = plan
        assert root == 1
        d = torch.as_strided(a, (n0, n1, k), strides[:3])
        if b is not None:
            d = d - torch.as_strided(b, (n0, n1, k), strides[3:])
        return rk.sumsq_reference(d, True).reshape(out_shape)

    want = rk.norm_rn(a, b)
    assert torch.equal(read(a, b), want)
    assert torch.equal(want, rk.sumsq_reference(a if b is None else a - b, True))
    view = torch.randn(10, 6, generator=g)[:, ::2]
    other = torch.randn(3, 10, generator=g).T
    assert torch.equal(read(view, other), rk.sumsq_diff_reference(view, other, True))


def test_difference_form_takes_the_plain_version_on_the_cpu_only():
    """The CPU wrapper never reaches the kernel (no launch counted) and gives
    ``sumsq_reference(a - b)``; operands on two devices, or on a device with
    neither kernel nor plain version, raise."""
    rk.reset_launches()
    a, b = torch.randn(50, 3), torch.randn(3)
    assert torch.equal(rk.sumsq_fma(a, b), rk.sumsq_reference(a - b))
    assert torch.equal(rk.norm_rn(a, b), rk.sumsq_diff_reference(a, b, True))
    assert torch.equal(ordered.sumsq_diff_reference(a, b), rk.sumsq_reference(a - b))
    assert rk.LAUNCHES == {"fma32": 0, "sumsq": 0, "transform_points": 0}
    with pytest.raises(ValueError, match="several devices"):
        rk.norm_rn(a, torch.ones(3, device="meta"))
    with pytest.raises(ValueError, match="no kernel or plain version"):
        rk.sumsq_fma(torch.ones(4, 3, device="meta"), torch.ones(3, device="meta"))


def _c_params(entry: str) -> int:
    from datmo_using_optical_flow_tpu_torch.kernels import build

    text = (build.CSRC_DIR / "round_kernels.cu").read_text()
    head = text[text.index(f"int {entry}("):]
    return len(head[:head.index(")")].split(","))


def test_sumsq_signature_matches_the_source():
    """``kernels/build`` binds ``datmo_sumsq`` with as many arguments as
    ``csrc/round_kernels.cu`` declares."""
    from datmo_using_optical_flow_tpu_torch.kernels import build

    assert len(build._SIGNATURES["datmo_sumsq"][0]) == _c_params("datmo_sumsq")


@pytest.mark.parametrize("entry,args", [("datmo_fma32", 14), ("datmo_transform_points", 5)])
def test_fma32_and_transform_signatures_match_the_source(entry, args):
    """``kernels/build`` binds ``datmo_fma32`` and ``datmo_transform_points``
    with as many arguments as ``csrc/round_kernels.cu`` declares, and the
    wrappers' cached plans give as many integers as the entries take after
    their pointers and scalars (the device and the stream come last)."""
    from datmo_using_optical_flow_tpu_torch.kernels import build

    assert len(build._SIGNATURES[entry][0]) == _c_params(entry)
    a = torch.ones(6, 3)
    plan = (rk._fma32_args(a.shape, a.stride(), a.shape, a.stride(), None, None, False)[1]
            if entry == "datmo_fma32" else
            rk._transform_args(a.shape, a.stride(), (4, 4), (4, 1)))
    assert len(plan) == args
    pointers = 6 if entry == "datmo_fma32" else 3  # out, a, b, c, bs, cs / out, points, transform
    assert pointers + args + 2 == _c_params(entry)


# ------------------------------------------------------------------ the strided fma

def _fma_as_read(a, b, c, root=False):
    """What ``fma32_kernel`` reads for the arguments ``_fma32_args`` gives:
    each tensor operand at its element strides over the axes (n0, n1, n2),
    or at the output's own index on the flat path; past three axes the
    operands merged first, as the wrapper merges them."""
    sig = [(x.shape, x.stride()) if isinstance(x, torch.Tensor) else (None, None)
           for x in (a, b, c)]
    shape, args = rk._fma32_args(*(v for pair in sig for v in pair), root)
    if args is None:
        merged = (x.expand(shape).reshape(-1, *shape[-2:]) if isinstance(x, torch.Tensor) else x
                  for x in (a, b, c))
        return _fma_as_read(*merged, root).reshape(shape)
    r, n0, n1, n2, *strides, flat = args
    assert r == int(root)
    n = n0 * n1 * n2

    def view(x, st):
        if not isinstance(x, torch.Tensor):
            return x
        if flat:
            assert x.is_contiguous() and x.numel() == n
            return torch.as_strided(x, (n,), (1,))
        return torch.as_strided(x, (n0, n1, n2), st)

    ops = [view(x, strides[3 * i:3 * i + 3]) for i, x in enumerate((a, b, c))]
    return rk.fma32_reference(*ops, root).reshape(shape)


_FMA_CASES = {
    "icp (N,1)x(3,)+(N,3)": lambda g: (torch.randn(500, 3, generator=g)[:, 1:2],
                                       torch.randn(4, 4, generator=g)[:3, 1],
                                       torch.randn(500, 3, generator=g)),
    "full contiguous, flat": lambda g: (torch.randn(40, 50, generator=g),
                                        torch.randn(40, 50, generator=g),
                                        torch.randn(40, 50, generator=g)),
    "numbers": lambda g: (torch.randn(64, 3, generator=g), 0.1, -2.5),
    "number b, broadcast c": lambda g: (torch.randn(64, 3, generator=g), 0.3,
                                        torch.randn(3, generator=g)),
    "transposed a, sliced b": lambda g: (torch.randn(7, 30, generator=g).T,
                                         torch.randn(30, 14, generator=g)[:, ::2], 1.5),
    "scalar tensor c": lambda g: (torch.randn(5, 4, generator=g), torch.randn(4, generator=g),
                                  torch.tensor(0.25)),
    "four axes, broadcast (4, 3)": lambda g: (torch.randn(2, 3, 4, 3, generator=g),
                                               torch.randn(4, 3, generator=g),
                                               torch.randn(2, 3, 1, 1, generator=g)),
    "five axes, none merge": lambda g: (torch.randn(2, 1, 3, 1, 5, generator=g),
                                         torch.randn(1, 4, 1, 6, 1, generator=g),
                                         torch.randn(5, 6, 3, 4, 2, generator=g).permute(
                                             4, 3, 2, 1, 0)),
    "one element": lambda g: (torch.randn(1, 1, generator=g), torch.randn(1, generator=g), 2.0),
}


@pytest.mark.parametrize("root", [False, True], ids=["fma", "root"])
@pytest.mark.parametrize("case", list(_FMA_CASES))
def test_fma32_reads_each_operand_through_its_strides(case, root):
    """What the kernel reads: each operand at the element strides the wrapper
    passes (``_fma32_args``: the output's axes coalesced, 0 along a broadcast
    axis, more than three axes merged first) gives the plain version's
    answer, for ICP's broadcast signature, number operands, transposed and
    sliced views and shapes of four and five axes; the flat path only where
    every operand is contiguous with the output's shape."""
    g = torch.Generator().manual_seed(sorted(_FMA_CASES).index(case))
    a, b, c = _FMA_CASES[case](g)
    if root:
        a = a.abs()
        b = b.abs() if isinstance(b, torch.Tensor) else abs(b)
        c = c.abs() if isinstance(c, torch.Tensor) else abs(c)
    want = rk.fma32(a, b, c, root)
    assert torch.equal(want, rk.fma32_reference(a, b, c, root))
    assert rk.bits_equal(_fma_as_read(a, b, c, root), want)


def test_fma32_plan_takes_the_flat_path_only_for_whole_contiguous_operands():
    """The plan's last argument: the 1080x1920 magnitude and the draws'
    contiguous chains are flat; a broadcast or a view is not, and ICP's
    former signature walks two axes (no copy)."""
    def plan(*xs):
        return rk._fma32_args(*(v for x in xs for v in (
            (x.shape, x.stride()) if isinstance(x, torch.Tensor) else (None, None))), False)[1]

    img = torch.ones(1080, 1920)
    pts = torch.ones(102400, 3)
    assert plan(img, img, img)[-1] == 1
    assert plan(pts, 0.5, -1.0)[-1] == 1
    assert plan(pts, pts, 2.0)[-1] == 1
    icp = plan(pts[:, 1:2], torch.eye(4)[:3, 1], pts)
    assert icp == (0, 1, 102400, 3, 0, 3, 0, 0, 0, 4, 0, 3, 1, 0)
    assert plan(img.T, img.T, img.T)[-1] == 0
    assert plan(pts, torch.ones(3), pts)[-1] == 0


# ------------------------------------------------------------------ ICP's transform

def _transform_as_read(points, transformation):
    """What ``transform_points_kernel`` reads for ``_transform_args``: the
    points' three columns and the transform's [R | t] at their strides."""
    n, sp0, sp1, sm0, sm1 = rk._transform_args(points.shape, points.stride(),
                                               transformation.shape, transformation.stride())
    p = torch.as_strided(points, (n, 3), (sp0, sp1))
    m = torch.as_strided(transformation, (3, 4), (sm0, sm1))
    return rk.transform_points_reference(p, m)


def _rigid_transform(g) -> torch.Tensor:
    t = torch.eye(4)
    q, _ = torch.linalg.qr(torch.randn(3, 3, generator=g, dtype=torch.float64))
    t[:3, :3] = q.float()
    t[:3, 3] = torch.randn(3, generator=g)
    return t


_TRANSFORM_CASES = {
    "contiguous": lambda g, t: (torch.randn(300, 3, generator=g) * 20, t),
    "transposed points": lambda g, t: (torch.randn(3, 300, generator=g).T * 20, t),
    "sliced points": lambda g, t: (torch.randn(600, 5, generator=g)[::2, 1:4] * 20, t),
    "points of 4 columns": lambda g, t: (torch.randn(300, 4, generator=g) * 20, t),
    "transposed transform": lambda g, t: (torch.randn(300, 3, generator=g),
                                          t.T.contiguous().T),
    "transform a view of 6x6": lambda g, t: (torch.randn(300, 3, generator=g),
                                             torch.nn.functional.pad(t, (1, 1, 2, 0))[2:, 1:5]),
    "one point": lambda g, t: (torch.randn(1, 3, generator=g), t),
}


@pytest.mark.parametrize("case", list(_TRANSFORM_CASES))
def test_transform_points_reads_points_and_transform_through_their_strides(case):
    """What the kernel reads (``_transform_args`` through ``torch.as_strided``)
    gives the plain answer for transposed and sliced points and for a
    transform that is a view, and the wrapper on the CPU is its plain
    version."""
    g = torch.Generator().manual_seed(sorted(_TRANSFORM_CASES).index(case))
    points, t = _TRANSFORM_CASES[case](g, _rigid_transform(g))
    want = rk.transform_points_reference(points, t)
    assert want.shape == (points.shape[0], 3)
    assert torch.equal(rk.transform_points(points, t), want)
    assert torch.equal(ticp.transform_points(points, t), want)
    assert rk.bits_equal(_transform_as_read(points, t), want)


@pytest.mark.parametrize("shapes", [((300,), (4, 4)), ((300, 2), (4, 4)), ((300, 3), (3, 3)),
                                    ((300, 3), (4,)), ((2, 300, 3), (4, 4))], ids=str)
def test_transform_args_refuse_what_the_kernel_does_not_take(shapes):
    sp, sm = shapes
    p, m = torch.ones(sp), torch.ones(sm)
    with pytest.raises(ValueError):
        rk._transform_args(p.shape, p.stride(), m.shape, m.stride())
