"""The port's GMFA ``preprocess`` against the JAX package's on the same padded
points and keys: flip x, RANSAC ground removal, ROI, compaction to
``max_roi_points`` and densification x10 with the jitter drawn from the
frame's key.  Held bit for bit (``torch.equal``) on 5 synthetic frames, with
float32 points and with int16 q16 points.

The jitter is where exactness took care: inside the jitted preprocess XLA
folds ``sqrt(2) * noise_std`` into one float32 constant and adds the product
to the replicated point in one rounding, so ``rep + normal(key) * std``
computed op by op differs from JAX's in ~1 of 1,000 coordinates (by one
rounding).  The port computes the compiled form (``prng.normal_fma``).  That
form is XLA's code generation for this fusion, not a rule: a bare jitted
``r + jax.random.normal(k, r.shape) * std`` on an (N, 3) array leaves its
third column uncontracted.  So the jitter is held to the JAX package's jitted
``densify`` itself, which is what its ``preprocess`` compiles.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from datmo_using_optical_flow_tpu.config import CapacityConfig as JCapacity
from datmo_using_optical_flow_tpu.config import GMFAConfig as JConfig
from datmo_using_optical_flow_tpu.io.frames import pad_points, pad_points_q16
from datmo_using_optical_flow_tpu.models import gmfa as jgmfa
from datmo_using_optical_flow_tpu.ops import points as jpts
from datmo_using_optical_flow_tpu.sim.synthetic import BoxTarget, SyntheticScene, synthetic_frame
from datmo_using_optical_flow_tpu_torch.config import CapacityConfig, GMFAConfig
from datmo_using_optical_flow_tpu_torch.models import gmfa as tgmfa
from datmo_using_optical_flow_tpu_torch.ops import points as tpts
from datmo_using_optical_flow_tpu_torch.utils import prng
from torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)

_CAPS = dict(max_raw_points=8192, max_roi_points=512, max_cells=1024, max_clusters=8,
             max_tracks=16)
N_FRAMES = 5
SCENE = SyntheticScene(seed=33, targets=(
    BoxTarget(center0=(5.0, -4.0, 0.75), velocity=(1.5, 0.8), points_per_frame=300),
    BoxTarget(center0=(-6.0, 5.0, 0.75), velocity=(-1.0, -1.2), size=(3.0, 1.6, 1.4),
              points_per_frame=250)))


def _frames(q16: bool):
    pad = pad_points_q16 if q16 else pad_points
    return [pad(synthetic_frame(SCENE, i).astype(np.float32), _CAPS["max_raw_points"])
            for i in range(N_FRAMES)]


@pytest.fixture(scope="module")
def jax_clouds():
    """The JAX package's expanded clouds, frame i with ``fold_in(PRNGKey(0),
    i)`` as its runner keys them; float32 and q16."""
    pipe = jgmfa.GMFAPipeline(JConfig(capacities=JCapacity(**_CAPS)), max_moving_points=2048)
    out = {}
    for q16 in (False, True):
        out[q16] = []
        for i, (pts, mask) in enumerate(_frames(q16)):
            ex, exmask = pipe.preprocess(jnp.asarray(pts), jnp.asarray(mask),
                                         jax.random.fold_in(jax.random.PRNGKey(0), i))
            out[q16].append((np.asarray(ex), np.asarray(exmask)))
    return out


@pytest.mark.parametrize("q16", [False, True], ids=["float32", "q16"])
def test_preprocess_matches_jax(jax_clouds, q16):
    pipe = tgmfa.GMFAPipeline(GMFAConfig(capacities=CapacityConfig(**_CAPS)),
                              max_moving_points=2048, device="cpu")
    for i, (pts, mask) in enumerate(_frames(q16)):
        ex, exmask = pipe.preprocess(torch.as_tensor(pts), torch.as_tensor(mask),
                                     prng.fold_in(prng.PRNGKey(0), i))
        want, want_mask = (torch.from_numpy(np.array(a)) for a in jax_clouds[q16][i])
        rows = int((ex != want).any(dim=1).sum())
        print(f"frame {i} ({'q16' if q16 else 'float32'}): {rows} of {int(want_mask.sum())} "
              f"expanded rows differ")
        assert ex.dtype == torch.float32 and ex.shape == (5120, 3)
        assert torch.equal(exmask, want_mask) and int(want_mask.sum()) > 1000
        assert torch.equal(ex, want), f"frame {i}: {rows} rows differ"


@pytest.mark.parametrize("std", [0.01, 0.05, 0.3])
def test_densify_jitter_is_jax_jitted_densify(std):
    rng = np.random.default_rng(3)
    pts = rng.uniform(-20, 20, size=(1024, 3)).astype(np.float32)
    mask = np.arange(1024) < 900
    jitted = jax.jit(partial(jpts.densify, expansion_factor=10, noise_std=std))
    for seed in (0, 1, 42):
        want, want_mask = jitted(jnp.asarray(pts), jnp.asarray(mask), jax.random.PRNGKey(seed))
        got, got_mask = tpts.densify(torch.as_tensor(pts), torch.as_tensor(mask),
                                     prng.PRNGKey(seed), 10, noise_std=std)
        assert torch.equal(got, torch.from_numpy(np.array(want)))
        assert torch.equal(got_mask, torch.from_numpy(np.array(want_mask)))
