"""Where the JAX package's and the port's GMFA runs part, on the sequence of
``test_torch_gmfa_process_files`` (both runners keyed from ``PRNGKey(0)``):
ICP's float32 rounds on the bit-equal clouds of frame pairs 1 -> 2 and
3 -> 4.

ICP does not converge on these clouds (the scene has no static structure),
and each side's Kabsch solve rounds differently (JAX's ``svd`` and XLA's
sums against the port's fixed-tree sums and host ``svd``): the transforms
drift apart by 1e-6 to 3e-4 over rounds whose correspondence sets still
agree, until a correspondence near the 0.2 m gate falls on the other side
of it in one run.  From there the correspondence sets, the transforms, a
few classifications and so the clusters' centroids differ.

``test_first_parting_is_at_the_gate`` follows frame pair 1 -> 2 round by
round on both sides: until the correspondence sets part, the transforms
stay within ``DRIFT_BEFORE``; where they first part, at most
``PARTED_ROWS`` points differ, each within ``GATE_BAND`` of the gate on both
sides.  It prints those points' margins and what a float64 ICP with the
same rules counts there.  ``test_float64_icp_ends_next_to_the_port`` runs
that float64 ICP to its end on both frame pairs and holds the port's
transform within ``F64_LIMIT`` of it, printing how far JAX's ends.
``test_q16_runner_matches_jax`` holds the q16 file runner to JAX's with the
limits the partings set (the float32 runner:
``test_torch_gmfa_process_files``).
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

from datmo_using_optical_flow_tpu.ops import icp as jicp
from datmo_using_optical_flow_tpu_torch.io.frames import DiskFrameSource
from datmo_using_optical_flow_tpu_torch.ops import icp as ticp
from datmo_using_optical_flow_tpu_torch.ops.nn import nearest_neighbors
from datmo_using_optical_flow_tpu_torch.utils import prng
from test_torch_gmfa_process_files import (_CAPS, _assert_rows_match, _assert_som_match, _cfg,
                                           _jax_pipe, _port, seq)  # noqa: F401  (seq: fixture)
from torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)

DRIFT_BEFORE = 1e-3  # transform entries, while the correspondence sets agree
GATE_BAND = 1e-2     # relative to the gate's squared distance
PARTED_ROWS = 2
F64_LIMIT = 1e-3     # transform entries


def _clouds(paths, q16, first):
    """Frames ``first`` and ``first + 1``, expanded by the JAX package and by
    the port with the runners' keys; asserted bit-equal."""
    jpipe, tpipe = _jax_pipe(), _port()
    frames = list(DiskFrameSource(paths[:first + 2], capacity=_CAPS["max_raw_points"],
                                  quantize_q16=q16))
    out = []
    for i in (first, first + 1):
        pts, mask = frames[i]
        kp = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(0), i))[0]
        want = [np.array(a) for a in jpipe.preprocess(jnp.asarray(pts), jnp.asarray(mask), kp)]
        got = tpipe.preprocess(torch.from_numpy(pts), torch.from_numpy(mask),
                               prng.split(prng.fold_in(prng.PRNGKey(0), i))[0])
        assert all(torch.equal(g, torch.from_numpy(w)) for g, w in zip(got, want))
        out.append(want)
    return out


def _gate(src, smask, tgt, tmask, transform, thr2):
    """Each source row's squared distance to its nearest target after
    ``transform`` and whether it is a correspondence, as both sides gate."""
    pts = ticp.transform_points(torch.from_numpy(src), torch.from_numpy(transform))
    idx, _ = nearest_neighbors(pts, torch.from_numpy(tgt), torch.from_numpy(tmask))
    d = pts - torch.from_numpy(tgt)[idx.long()]
    d2 = ((d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]) + d[:, 2] * d[:, 2]).numpy()
    return d2, smask & (d2 <= thr2)


def _float64_icp(src, smask, tgt, tmask, thr, rounds):
    """The same ICP in float64 (Open3D's rules: NN gate, weighted Kabsch,
    stop when both relative changes fall below 1e-6): the transform and the
    correspondences after each round."""
    s, t = src[smask].astype(np.float64), tgt[tmask].astype(np.float64)
    tree, transform, counts = cKDTree(t), np.eye(4), []
    f0 = r0 = -1.0
    for k in range(rounds):
        p = s @ transform[:3, :3].T + transform[:3, 3]
        d, nn = tree.query(p)
        c = d * d <= thr * thr
        f1, r1 = c.sum() / len(s), np.sqrt((d[c] ** 2).sum() / max(c.sum(), 1))
        if k >= 2 and abs(f0 - f1) < 1e-6 and abs(r0 - r1) < 1e-6:
            break
        f0, r0 = f1, r1
        a, b = p[c], t[nn[c]]
        u, _, vt = np.linalg.svd((a - a.mean(0)).T @ (b - b.mean(0)))
        r = vt.T @ np.diag([1.0, 1.0, np.sign(np.linalg.det(vt.T @ u.T))]) @ u.T
        step = np.eye(4)
        step[:3, :3], step[:3, 3] = r, b.mean(0) - r @ a.mean(0)
        transform = step @ transform
        p = s @ transform[:3, :3].T + transform[:3, 3]
        counts.append(int((tree.query(p)[0] ** 2 <= thr * thr).sum()))
    return transform, counts


def _icp_pair(src, smask, tgt, tmask, rounds):
    """JAX's and the port's ICP transform and fitness after ``rounds``."""
    icp = _cfg().icp
    j = jax.jit(partial(jicp.registration_icp, threshold=icp.threshold, max_iterations=rounds,
                        relative_fitness=icp.relative_fitness,
                        relative_rmse=icp.relative_rmse))(
        *(jnp.asarray(a) for a in (src, smask, tgt, tmask)))
    t = ticp.registration_icp(*(torch.from_numpy(a) for a in (src, smask, tgt, tmask)),
                              icp.threshold, rounds, icp.relative_fitness, icp.relative_rmse)
    return (np.asarray(j.transformation), float(j.fitness)), \
        (t.transformation.numpy(), float(t.fitness))


@pytest.mark.parametrize("q16", [False, True], ids=["float32", "q16"])
def test_first_parting_is_at_the_gate(seq, q16):
    _, paths = seq
    (src, smask), (tgt, tmask) = _clouds(paths, q16, 1)
    thr = _cfg().icp.threshold
    thr2 = np.float32(thr * thr)
    for k in range(1, _cfg().icp.max_iterations + 1):
        (jt, jf), (tt, tf) = _icp_pair(src, smask, tgt, tmask, k)
        jd2, jc = _gate(src, smask, tgt, tmask, jt, thr2)
        td2, tc = _gate(src, smask, tgt, tmask, tt, thr2)
        assert jc.sum() == round(jf * smask.sum()) and tc.sum() == round(tf * smask.sum())
        if np.array_equal(jc, tc):
            assert np.abs(jt - tt).max() < DRIFT_BEFORE, (k, np.abs(jt - tt).max())
            continue
        rows = np.nonzero(jc != tc)[0]
        _, f64 = _float64_icp(src, smask, tgt, tmask, thr, k)
        print(f"{'q16' if q16 else 'float32'}: correspondences part after round {k}: "
              f"{int(jc.sum())} JAX, {int(tc.sum())} port, {f64[-1]} float64 ICP (float64 "
              f"per round {f64}); transforms {np.abs(jt - tt).max():.3e} apart")
        for row in rows:
            print(f"  source row {row}: d2 - gate = {jd2[row] - thr2:+.3e} (JAX), "
                  f"{td2[row] - thr2:+.3e} (port); gate {thr2:.9e}")
        assert len(rows) <= PARTED_ROWS
        assert np.all(np.abs(np.stack([jd2[rows], td2[rows]]) - thr2) < GATE_BAND * thr2)
        break


@pytest.mark.parametrize("q16", [False, True], ids=["float32", "q16"])
@pytest.mark.parametrize("first", [1, 3], ids=["frames1-2", "frames3-4"])
def test_float64_icp_ends_next_to_the_port(seq, q16, first):
    _, paths = seq
    (src, smask), (tgt, tmask) = _clouds(paths, q16, first)
    icp = _cfg().icp
    (jt, _), (tt, _) = _icp_pair(src, smask, tgt, tmask, icp.max_iterations)
    t64, _ = _float64_icp(src, smask, tgt, tmask, icp.threshold, icp.max_iterations)
    print(f"{'q16' if q16 else 'float32'} frames {first} -> {first + 1}: float64 ICP's "
          f"transform {np.abs(tt - t64).max():.3e} from the port's, "
          f"{np.abs(jt - t64).max():.3e} from JAX's")
    assert np.abs(tt - t64).max() < F64_LIMIT


@pytest.fixture(scope="module")
def q16_runs(seq):
    _, paths = seq
    return (_jax_pipe().process_files(paths, h2d_q16=True),
            _port().process_files(paths, h2d_q16=True))


def test_q16_runner_matches_jax(q16_runs):
    """``h2d_q16``: frames and ids exact; states within 1e-4 before the
    first parting and within the drift limits from it on; the SOM as the
    float32 run's is held (``test_torch_gmfa_process_files``)."""
    want, got = q16_runs
    _assert_rows_match(got["rows"], want["rows"])
    _assert_som_match(got["som"], want["som"])
