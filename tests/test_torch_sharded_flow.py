"""The port's row-sharded flow (``parallel/{mesh,halo,sharded_flow}.py``) on a
4-rank gloo group of CPU processes, against the JAX package's ``shard_map``
functions on 4 devices of conftest's CPU mesh, on the same numpy inputs.

Halo rows, the sharded separable filter, box blur and polynomial expansion
are bit-equal to JAX's jitted ``shard_map`` functions.  The sharded level and
flow are bit-equal to JAX's jitted pieces (each iteration's jitted
``sharded_update_matrices`` and jitted window + solve; the coarse levels'
jitted refinement and upsample), and within 1e-4 px of JAX's whole jitted
level and flow, which part from those pieces: XLA fuses the solve into each
warp plane's fusion there and rounds by each fusion's operand order, in a way
that depends on the block's shape.  Against the port's unsharded level 1e-4
px, its unsharded flow EPE < 1e-3.  One level runs with vertical flow beyond
the warp halo, where the sharded warp clamps: it is held to JAX's sharded
result, not to the unsharded level.

Every port case runs in one spawn of the group (the module's fixture): each
rank takes its rows of every tensor input (``mesh.sharded_calls``).
"""

import os
import subprocess
import sys

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from datmo_using_optical_flow_tpu.ops import farneback as jfb
from datmo_using_optical_flow_tpu.parallel import halo as jhalo
from datmo_using_optical_flow_tpu.oracle.np_farneback import gaussian_kernel
from datmo_using_optical_flow_tpu.parallel import sharded_flow as jsf
from datmo_using_optical_flow_tpu_torch.ops import farneback as fb
from datmo_using_optical_flow_tpu_torch.parallel import halo, mesh
from datmo_using_optical_flow_tpu_torch.parallel import sharded_flow as sf
from torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)

pytestmark = pytest.mark.skipif(len(jax.devices()) < 4, reason="needs the CPU mesh")

N = 4
_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_K5 = np.array([0.1, 0.2, 0.4, 0.2, 0.1], np.float32)


def _pair(seed, shift):
    """tests/test_sharded_flow.py's frames: a blurred 64x80 noise image and
    its affine shift by ``shift`` = (dx, dy) px."""
    rng = np.random.default_rng(seed)
    img1 = cv2.GaussianBlur(rng.uniform(0, 255, (64, 80)).astype(np.float32), (0, 0), 3)
    img2 = cv2.warpAffine(img1, np.float32([[1, 0, shift[0]], [0, 1, shift[1]]]), (80, 64))
    return img1, img2


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    level1, level2 = _pair(0, (0.9, -1.2))
    flow1, flow2 = _pair(3, (1.1, -0.7))
    far1, far2 = _pair(5, (0.6, 11.0))  # vertical motion beyond a warp halo of 8
    R0, R1 = (np.array(jfb.poly_exp(jnp.asarray(x), 5, 5.0)) for x in (level1, level2))
    F0, F1 = (np.array(jfb.poly_exp(jnp.asarray(x), 5, 5.0)) for x in (far1, far2))
    return {
        "rows": np.arange(32 * 6, dtype=np.float32).reshape(32, 6),
        "noise": rng.normal(size=(32, 6)).astype(np.float32),
        "planes": rng.normal(size=(5, 32, 8)).astype(np.float32),
        "filter": rng.normal(size=(64, 40)).astype(np.float32),
        "blur": np.random.default_rng(1).normal(size=(5, 64, 40)).astype(np.float32),
        "level": (level1, R0, R1), "flow": (flow1, flow2), "far": (F0, F1),
        "zero": np.zeros((64, 80), np.float32),
        "far_dy": np.full((64, 80), -11.0, np.float32),
        # a smooth flow within the warp halo of 8 rows
        "flow_xy": tuple((a * np.sin(np.arange(64)[:, None] / b + np.arange(80) / c))
                         .astype(np.float32) for a, b, c in ((3.0, 7, 11), (-5.0, 5, 13))),
    }


def _extended_blocks(planes, radius):
    """Each rank's block of ``planes`` grown by ``radius`` rows of the
    edge-padded grid, the blocks stacked by rows (so that rank r's rows of
    the stack are its extended block)."""
    hl = planes.shape[-2] // N
    padded = np.pad(planes, ((0, 0), (radius, radius), (0, 0)), mode="edge")
    return np.concatenate([padded[:, r * hl:r * hl + hl + 2 * radius] for r in range(N)],
                          axis=-2)


@pytest.fixture(scope="module")
def port(inputs):
    """Every case's per-rank results from one spawn of 4 gloo ranks."""
    t = torch.from_numpy
    x = inputs
    level_args = dict(h_global=64, warp_halo=8)
    calls = {
        "halo_edge": (halo.halo_exchange_rows, (t(x["rows"]), 2), {}),
        "halo_reflect": (halo.halo_exchange_rows, (t(x["noise"]), 3),
                         {"edge_mode": "reflect101"}),
        "halo_planes": (halo.halo_exchange_rows, (t(x["planes"]), 4), {}),
        "sep_filter": (halo.sharded_sep_filter, (t(x["filter"]), _K5, _K5), {}),
        "box_blur": (halo.sharded_box_blur5, (t(x["blur"]), 7), {}),
        "poly_exp": (sf.sharded_poly_exp, (t(x["level"][0]), 5, 5.0), {}),
        **{f"level{it}": (sf.sharded_farneback_level,
                          (t(x["level"][1]), t(x["level"][2]), t(x["zero"]), t(x["zero"]), 15,
                           it), level_args) for it in (1, 2, 3)},
        "flow": (sf.sharded_farneback_flow, tuple(map(t, x["flow"])),
                 dict(pyr_scale=0.5, levels=2, iterations=3, warp_halo=8)),
        "update": (sf.sharded_update_matrices,
                   (t(x["level"][1]), t(_extended_blocks(x["level"][2], 8)),
                    *map(t, x["flow_xy"])), dict(warp_halo=8, h_global=64)),
        "far": (sf.sharded_farneback_level,
                (t(x["far"][0]), t(x["far"][1]), t(x["zero"]), t(x["far_dy"]), 15, 3),
                level_args),
    }
    results = mesh.spawn(mesh.sharded_calls, N, "gloo", ["cpu"] * N, list(calls.values()),
                         timeout=240)
    return {name: [r[i] for r in results] for i, name in enumerate(calls)}


def _jax_sharded(fn, in_specs, out_specs, *args):
    space = Mesh(np.asarray(jax.devices()[:N]), ("space",))
    run = shard_map(fn, mesh=space, in_specs=in_specs, out_specs=out_specs, check_vma=False)
    return jax.device_get(jax.jit(run)(*map(jnp.asarray, args)))


def _cat(blocks, dim=-2):
    return torch.cat(blocks, dim=dim).numpy()


@pytest.mark.parametrize("case,radius,mode", [("halo_edge", 2, "edge"),
                                              ("halo_reflect", 3, "reflect101")])
def test_halo_rows_bit_equal(inputs, port, case, radius, mode):
    x = inputs["rows" if case == "halo_edge" else "noise"]
    want = _jax_sharded(lambda b: jhalo.halo_exchange_rows(b, radius, "space", mode),
                        P("space"), P("space"), x)
    got = _cat(port[case])
    assert got.shape == (N * (32 // N + 2 * radius), 6)
    np.testing.assert_array_equal(got, want)


def test_halo_of_stacked_planes_is_each_planes_halo(inputs, port):
    """The port exchanges the five planes in one transfer; JAX
    (``sharded_flow._halo_stack``) plane by plane: the same rows."""
    want = _jax_sharded(lambda b: jsf._halo_stack(b, 4, "space"),
                        P(None, "space"), P(None, "space"), inputs["planes"])
    np.testing.assert_array_equal(_cat(port["halo_planes"]), want)


def test_sharded_sep_filter_matches_jax(inputs, port):
    want = _jax_sharded(lambda b: jhalo.sharded_sep_filter(b, _K5, _K5, "space"),
                        P("space"), P("space"), inputs["filter"])
    got = _cat(port["sep_filter"])
    np.testing.assert_array_equal(got, want)
    unsharded = fb.sep_filter(torch.from_numpy(inputs["filter"]), _K5, _K5, "edge").numpy()
    np.testing.assert_array_equal(got, unsharded)


def test_sharded_box_blur_matches_jax(inputs, port):
    want = _jax_sharded(lambda b: jhalo.sharded_box_blur5(b, 7, "space"),
                        P(None, "space"), P(None, "space"), inputs["blur"])
    np.testing.assert_array_equal(_cat(port["box_blur"]), want)


def test_sharded_poly_exp_matches_jax(inputs, port):
    img = inputs["level"][0]
    want = _jax_sharded(lambda b: jsf.sharded_poly_exp(b, 5, 5.0, "space"),
                        P("space"), P(None, "space"), img)
    got = _cat(port["poly_exp"])
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, fb.poly_exp(torch.from_numpy(img), 5, 5.0).numpy())


def _jax_level(R0, R1, dx, dy, iterations=3):
    """JAX's sharded level jitted whole, as one program."""
    return _jax_sharded(
        lambda r0, r1, a, b: jsf.sharded_farneback_level(r0, r1, a, b, 15, iterations, "space",
                                                         h_global=64, warp_halo=8),
        (P(None, "space"), P(None, "space"), P("space"), P("space")),
        (P("space"), P("space")), R0, R1, dx, dy)


def _jax_level_pieces(R0, R1, dx, dy, iterations=3):
    """JAX's sharded level as its jitted pieces: each iteration's jitted
    ``sharded_update_matrices``, then the jitted window and solve; the flow
    after each iteration."""
    out = []
    for _ in range(iterations):
        M = _jax_sharded(
            lambda r0, r1, a, b: jsf.sharded_update_matrices(
                r0, jsf._halo_stack(r1, 8, "space"), a, b, "space", 8, 64),
            (P(None, "space"), P(None, "space"), P("space"), P("space")), P(None, "space"),
            R0, R1, dx, dy)
        dx, dy = _jax_sharded(lambda m: jfb.solve_flow(jhalo.sharded_box_blur5(m, 15, "space")),
                              P(None, "space"), (P("space"), P("space")), M)
        out.append((dx, dy))
    return out


@pytest.fixture(scope="module")
def level_answers(inputs):
    """JAX's whole jitted level at 1, 2 and 3 iterations, and its pieces'
    flow after each iteration."""
    _, R0, R1 = inputs["level"]
    zero = inputs["zero"]
    return ([_jax_level(R0, R1, zero, zero, it) for it in (1, 2, 3)],
            _jax_level_pieces(R0, R1, zero, zero))


@pytest.mark.parametrize("iterations", [1, 2, 3])
def test_sharded_level_matches_jax(inputs, port, level_answers, iterations):
    """64x80 over 4 ranks: the port's sharded level after each iteration
    equals JAX's jitted pieces bit for bit, and is within 1e-4 px of JAX's
    whole jitted level and of the port's unsharded exact level."""
    _, R0, R1 = inputs["level"]
    zero = inputs["zero"]
    whole, pieces = level_answers
    got = [_cat([r[i] for r in port[f"level{iterations}"]]) for i in (0, 1)]
    for g, p, w in zip(got, pieces[iterations - 1], whole[iterations - 1]):
        np.testing.assert_array_equal(g, p)
        np.testing.assert_allclose(g, w, atol=1e-4)
    dx, dy = fb.farneback_level(*map(torch.from_numpy, (R0, R1, zero, zero)), 15, iterations,
                                fast_warp=False)
    np.testing.assert_allclose(got[0], dx.numpy(), atol=1e-4)
    np.testing.assert_allclose(got[1], dy.numpy(), atol=1e-4)


def test_jitted_sharded_level_moves_with_its_program(level_answers):
    """JAX's whole jitted level parts from its own jitted pieces once a
    solve's flow enters a warp (2 and 3 iterations; one iteration carries no
    flow and is equal): XLA recomputes the solve inside each M plane's fusion
    of the warp and contracts there by that fusion's operand order, which
    changes with the block's shape.  So the port follows the pieces, a target
    that does not move, and stays within 1e-4 px of the whole (the test
    above)."""
    whole, pieces = level_answers
    for it, (w, p) in enumerate(zip(whole, pieces), 1):
        moved = sum(int((a != b).sum()) for a, b in zip(w, p))
        assert (moved > 0) == (it > 1), (it, moved)
        assert max(np.abs(a - b).max() for a, b in zip(w, p)) < 1e-5


def test_sharded_update_matrices_matches_jitted_jax(inputs, port):
    """The warp and M of one sharded iteration (K4 with the rank's rows; its
    plain version here), bit-equal to JAX's jitted function: the bilinear
    sums and M's tail contracted as XLA's CPU code contracts them, the tail
    in its unfolded form (the attenuation depends on the rank, so XLA cannot
    fold it as in the unsharded warp); the port's sharded M equals its
    unsharded M on these rows within 1e-4 (the two tails round apart)."""
    _, R0, R1 = inputs["level"]
    want = _jax_sharded(
        lambda r0, r1, a, b: jsf.sharded_update_matrices(
            r0, jsf._halo_stack(r1, 8, "space"), a, b, "space", 8, 64),
        (P(None, "space"), P(None, "space"), P("space"), P("space")), P(None, "space"),
        R0, R1, *inputs["flow_xy"])
    got = _cat(port["update"])
    np.testing.assert_array_equal(got, want)
    unsharded = fb.update_matrices(*map(torch.from_numpy, (R0, R1, *inputs["flow_xy"])))
    np.testing.assert_allclose(got, unsharded.numpy(), atol=1e-4)


def test_flow_beyond_the_warp_halo_keeps_jax_clamp(inputs, port):
    """Vertical flow of ~11 px against a halo of 8 rows: the sampled rows
    clamp to the halo's edge, in JAX's sharded level as in the port's (bit
    for bit against its jitted pieces, within 1e-4 px of the whole)."""
    F0, F1 = inputs["far"]
    zero, dy0 = inputs["zero"], inputs["far_dy"]
    want = _jax_level(F0, F1, zero, dy0)
    pieces = _jax_level_pieces(F0, F1, zero, dy0)[-1]
    got = [_cat([r[i] for r in port["far"]]) for i in (0, 1)]
    for g, p, w in zip(got, pieces, want):
        np.testing.assert_array_equal(g, p)
        np.testing.assert_allclose(g, w, atol=1e-4)
    dx, dy = fb.farneback_level(*map(torch.from_numpy, (F0, F1, zero, dy0)), 15, 3,
                                fast_warp=False)
    assert np.abs(got[1] - dy.numpy()).max() > 0.1  # the clamp is in effect


def _jax_flow_pieces(img1, img2):
    """JAX's 2-level sharded flow as its jitted pieces: the coarse level's
    planes (jitted ``build_pyramid``), its jitted exact refinement and the
    jitted upsample times 1 / pyr_scale; level 0's jitted sharded pre-blur
    and ``sharded_poly_exp``; then the level's pieces (``_jax_level_pieces``)."""
    pyramid = jax.jit(lambda im: jfb.build_pyramid(im, 0.5, 2, 5, 5.0, use_pallas=False))
    A, B = (pyramid(jnp.asarray(im))[0] for im in (img1, img2))
    coarse = jax.jit(lambda a, b: jfb.flow_from_pyramids((a,), (b,), 0.5, 15, 3,
                                                         use_pallas=False, fast_warp=False))
    up = jax.jit(lambda f: [jfb.resize_bilinear(f[..., c], 64, 80) * np.float32(1 / 0.5)
                            for c in (0, 1)])(coarse(A, B))
    k3 = gaussian_kernel(3, 0.0).astype(np.float32)

    def planes(block):
        ext = jhalo.halo_exchange_rows(block, 1, "space", edge_mode="reflect101")
        f = jfb._corr_axis(jfb._corr_axis(ext, k3, -2, "reflect")[1:1 + block.shape[0]], k3,
                           -1, "reflect")
        return jsf.sharded_poly_exp(f, 5, 5.0, "space")
    R0, R1 = (_jax_sharded(planes, P("space"), P(None, "space"), im) for im in (img1, img2))
    dx, dy = _jax_level_pieces(R0, R1, *map(np.asarray, up))[-1]
    return np.stack([dx, dy], axis=-1)


def test_sharded_flow_matches_jax_and_unsharded(inputs, port):
    """The 2-level sharded flow bit-equal to JAX's jitted pieces, within
    1e-4 px of JAX's whole jitted sharded flow, which parts from those
    pieces (XLA's fusions of the whole program, as in the level), and within
    EPE 1e-3 of the port's unsharded exact flow."""
    img1, img2 = inputs["flow"]
    got = _cat(port["flow"], dim=0)
    want = _jax_sharded(
        lambda a, b: jsf.sharded_farneback_flow(a, b, "space", pyr_scale=0.5, levels=2,
                                                iterations=3, warp_halo=8),
        (P("space"), P("space")), P("space"), img1, img2)
    pieces = _jax_flow_pieces(img1, img2)
    assert got.shape == (64, 80, 2)
    np.testing.assert_array_equal(got, pieces)
    assert (want != pieces).any()  # the whole program moves
    np.testing.assert_allclose(got, want, atol=1e-4)
    unsharded = fb._farneback_impl(torch.from_numpy(img1), torch.from_numpy(img2), 0.5, 2,
                                   15, 3, 5, 5.0, fast_warp=False).numpy()
    assert np.linalg.norm(got - unsharded, axis=-1).max() < 1e-3
    assert np.abs(got).max() > 0.5  # the scene moves


def test_launch_count_follows_the_level_sizes():
    """One call's kernel launches per rank on the card, from the level sizes:
    at 1088x1920 the replicated 98x173 and 326x576 levels (K3: the exact
    warp fuses the small level too), then level 0 (K4 and K2: its M crosses
    ranks); K8 for the coarse levels' two images each (one launch an image)
    and the 2-plane upsamples (one launch each)."""
    assert sf.sharded_flow_launches(1088, 1920) == {"poly_exp": 6, "blur_solve": 5,
                                                    "warp_matrices": 5,
                                                    "fused_iteration": 10, "level_image": 6}
    assert sf.sharded_flow_launches(64, 80, 0.5, 2, 3) == {"poly_exp": 4, "blur_solve": 3,
                                                           "warp_matrices": 3,
                                                           "fused_iteration": 3,
                                                           "level_image": 3}


def test_shapes_that_cannot_be_sharded_raise():
    group = mesh.RowGroup(1, N, "gloo", torch.device("cpu"))
    with pytest.raises(ValueError, match="halo of 5 rows"):
        halo.halo_exchange_rows(torch.zeros(4, 3), 5, group)
    with pytest.raises(ValueError, match="reflect101"):
        halo.halo_exchange_rows(torch.zeros(4, 3), 4, group, edge_mode="reflect101")
    with pytest.raises(ValueError, match="do not divide"):
        mesh.shard_rows(torch.zeros(30, 3), group)
    with pytest.raises(ValueError, match="do not divide"):
        mesh.stream_mesh(group, 6)
    with pytest.raises(ValueError, match="nccl needs a CUDA device"):
        mesh.RowGroup(0, N, "nccl", torch.device("cpu"))
    with pytest.raises(ValueError, match="backend"):
        mesh.spawn(mesh.sharded_calls, 2, "mpi", ["cpu"] * 2, [])
    assert tuple(mesh.stream_mesh(group, 8)) == (2, 3)


def test_a_rank_failure_is_raised_in_the_caller():
    """Every rank's block has 2 rows; a halo of 5 raises on each rank, and
    the spawn raises it."""
    with pytest.raises(Exception, match="halo of 5 rows"):
        mesh.spawn(mesh.sharded_calls, 2, "gloo", ["cpu"] * 2,
                   [(halo.halo_exchange_rows, (torch.zeros(4, 3), 5), {})], timeout=120)


def test_parallel_imports_no_jax():
    code = ("import sys\n"
            "import datmo_using_optical_flow_tpu_torch.parallel.mesh, "
            "datmo_using_optical_flow_tpu_torch.parallel.halo, "
            "datmo_using_optical_flow_tpu_torch.parallel.sharded_flow, "
            "datmo_using_optical_flow_tpu_torch.dryrun\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'datmo_using_optical_flow_tpu')))")
    proc = subprocess.run([sys.executable, "-c", code], cwd=_REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"
