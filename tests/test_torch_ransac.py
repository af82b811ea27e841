"""The port's RANSAC ground removal against the JAX package's, on a small
synthetic frame (3,600 points in a 4,096-row buffer, 300 hypotheses).

The port samples the JAX package's indices (its uniform draws are bit-equal)
and solves each 3x3 covariance by Jacobi sweeps where JAX calls LAPACK's
``eigh``.  So each hypothesis' plane agrees with JAX's to 1e-5 wherever the
two smallest eigenvalues are apart (gap >= 2% of the largest); below that
LAPACK's float32 answer itself is off by up to ~3.5e-5, and the port's is
held to float64 ``eigh`` instead.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from datmo_using_optical_flow_tpu.ops import ransac as jr
from datmo_using_optical_flow_tpu_torch.ops import ransac as tr
from datmo_using_optical_flow_tpu_torch.sim.synthetic import SyntheticScene, synthetic_frame
from datmo_using_optical_flow_tpu_torch.utils import prng
from torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)

K = 300
THR = 0.5


@pytest.fixture(scope="module")
def frame():
    pts = synthetic_frame(SyntheticScene(ground_points=3000, seed=5), 0).astype(np.float32)
    cap = 4096
    P = np.full((cap, 3), 1e9, np.float32)
    P[:len(pts)] = pts
    P[:, 0] *= -1.0  # flipped, as preprocess hands it over
    M = np.zeros(cap, bool)
    M[:len(pts)] = True
    return P, M


def _planes(normals, ds):
    return np.concatenate([np.asarray(normals), np.asarray(ds)[:, None]], axis=1)


def _err_up_to_sign(a, b):
    return np.minimum(np.abs(a - b).max(axis=1), np.abs(a + b).max(axis=1))


@pytest.mark.parametrize("seed", range(4))
def test_hypotheses_match_jax(frame, seed):
    P, M = frame
    u = jax.random.uniform(jax.random.PRNGKey(seed), (K, 5))
    nv = int(M.sum())
    jidx = np.asarray(jnp.minimum((u * np.float32(nv)).astype(jnp.int32), nv - 1))
    tidx = tr.sample_indices(prng.PRNGKey(seed), torch.as_tensor(M), 5, K)
    np.testing.assert_array_equal(tidx.numpy(), jidx)

    jn, jd = jax.vmap(lambda p: jr._plane_from_points(p, jnp.ones(5)))(jnp.asarray(P)[jidx])
    tn, td = tr._plane_from_samples(torch.as_tensor(P)[tidx.long()])
    jpl, tpl = _planes(jn, jd), _planes(tn.numpy(), td.numpy())
    err = _err_up_to_sign(jpl, tpl)

    S = P[jidx].astype(np.float64)
    c = S.mean(axis=1)
    C = S - c[:, None]
    w, V = np.linalg.eigh(np.einsum("kri,krj->kij", C, C))
    truth = np.concatenate([V[:, :, 0], -(V[:, :, 0] * c).sum(axis=1)[:, None]], axis=1)
    apart = (w[:, 1] - w[:, 0]) / w[:, 2] >= 0.02
    print(f"seed {seed}: {apart.sum()} of {K} hypotheses apart; max error vs JAX there "
          f"{err[apart].max():.3e}; others vs float64: port "
          f"{_err_up_to_sign(tpl, truth)[~apart].max(initial=0):.3e}, JAX "
          f"{_err_up_to_sign(jpl, truth)[~apart].max(initial=0):.3e}")
    assert apart.sum() > 0.9 * K
    assert err[apart].max() <= 1e-5
    assert _err_up_to_sign(tpl, truth).max() <= 1e-5

    jc = np.asarray(jr._score_planes(jnp.asarray(P), jnp.asarray(M), jn, jd, THR))
    tc = tr._score_planes(torch.as_tensor(P), torch.as_tensor(M), tn, td, THR).numpy()
    assert np.abs(jc - tc).max() <= 3  # points within rounding of the threshold


@pytest.mark.parametrize("seed", range(4))
def test_segment_plane_and_remove_ground_match_jax(frame, seed):
    P, M = frame
    jplane, jinl = jr.segment_plane(jnp.asarray(P), jnp.asarray(M), jax.random.PRNGKey(seed),
                                    THR, 5, K)
    tplane, tinl = tr.segment_plane(torch.as_tensor(P), torch.as_tensor(M), prng.PRNGKey(seed),
                                    THR, 5, K)
    np.testing.assert_allclose(tplane.numpy(), np.asarray(jplane), atol=1e-5)
    assert tplane[2] > 0.99  # the ground plane z = 0, oriented up

    _, jng = jr.remove_ground(jnp.asarray(P), jnp.asarray(M), jax.random.PRNGKey(seed), THR, 5, K)
    _, tng = tr.remove_ground(torch.as_tensor(P), torch.as_tensor(M), prng.PRNGKey(seed), THR,
                              5, K)
    jng, tng = np.asarray(jng), tng.numpy()
    differ = jng != tng
    dist = np.abs(P.astype(np.float64) @ np.asarray(jplane, np.float64)[:3] + float(jplane[3]))
    print(f"seed {seed}: non-ground {int(jng.sum())} (JAX) / {int(tng.sum())} (port), "
          f"{int(differ.sum())} differ")
    assert np.all(np.abs(dist[differ] - THR) <= 1e-4)
    assert not (tng & ~M).any() and tng.sum() > 0


def test_port_result_is_reproducible(frame):
    P, M = (torch.as_tensor(a) for a in frame)
    a = tr.remove_ground(P, M, prng.PRNGKey(9), THR, 5, K)
    b = tr.remove_ground(P.clone(), M.clone(), prng.PRNGKey(9), THR, 5, K)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_smallest_eigenvector_matches_float64_eigh():
    rng = np.random.default_rng(0)
    S = rng.normal(size=(2000, 5, 3)).astype(np.float32)
    S[:, :, 2] *= 0.05
    C = S - S.mean(axis=1, keepdims=True)
    cov = np.einsum("kri,krj->kij", C, C).astype(np.float32)
    _, V = np.linalg.eigh(cov.astype(np.float64))
    got = tr.smallest_eigenvector(torch.as_tensor(cov)).numpy()
    assert _err_up_to_sign(got, V[:, :, 0]).max() <= 2e-6
    # a diagonal matrix needs no rotation: the sweeps leave it alone
    diag = torch.diag(torch.tensor([3.0, 1.0, 2.0]))
    np.testing.assert_array_equal(tr.smallest_eigenvector(diag).numpy(), [0.0, 1.0, 0.0])
