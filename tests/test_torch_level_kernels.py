"""K8's wrapper and plain versions on the CPU (``ops/level_kernels.py``,
``ops/farneback.py``): the dispatch, the level image's restricted evaluation,
the tables and taps the CUDA kernel reads, its C signatures, and the level
image against the JAX package's jitted blur and resize."""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from datmo_using_optical_flow_tpu.ops import farneback as jfb
from datmo_using_optical_flow_tpu_torch.diagnostics import roofline
from datmo_using_optical_flow_tpu_torch.kernels import build
from datmo_using_optical_flow_tpu_torch.ops import farneback as fb
from datmo_using_optical_flow_tpu_torch.ops import level_kernels as lk
from torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)

SOURCE = Path(lk.__file__).resolve().parents[1] / "csrc" / "level_kernels.cu"


def _image(h, w, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).uniform(0, 255, (h, w))
                            .astype(np.float32))


def test_cpu_tensors_take_the_plain_versions():
    img = _image(40, 60)
    flow = torch.randn(2, 12, 18, generator=torch.Generator().manual_seed(1))
    lk.reset_launches()
    cases = [(lk.level_image(img, 0.3, 12, 18), fb.level_image_reference(img, 0.3, 12, 18)),
             (lk.blur(img, 7, 1.1), fb.gaussian_blur_reference(img, 7, 1.1)),
             (lk.resize(flow, 40, 60, 3.3), fb.resize_bilinear_reference(flow, 40, 60, 3.3)),
             (fb.level_image(img, 0.3, 12, 18), fb.level_image_reference(img, 0.3, 12, 18))]
    for got, want in cases:
        assert torch.equal(got, want)
    assert lk.LAUNCHES == {"level_image": 0}


@pytest.mark.parametrize("call", [lambda t: lk.level_image(t, 0.3, 3, 4),
                                  lambda t: lk.blur(t, 7, 1.1),
                                  lambda t: lk.resize(t, 3, 4)])
def test_other_devices_raise(call):
    with pytest.raises(ValueError, match="no kernel or plain version"):
        call(torch.empty((10, 12), device="meta"))


@pytest.mark.parametrize("h,w,scale", [(200, 200, 0.3), (256, 320, 0.09), (256, 320, 0.027),
                                       (120, 100, 0.3), (7, 150, 0.3), (150, 7, 0.09),
                                       (1, 64, 0.3), (64, 1, 0.3), (33, 40, 0.5)])
def test_level_image_evaluates_the_blur_where_the_resize_reads_it(h, w, scale):
    """The restricted evaluation gives the bits of the full blur, then the
    resize; and both equal the JAX package's jitted blur and resize."""
    ksize, sigma = fb.level_blur(scale)
    lh, lw = max(1, round(h * scale)), max(1, round(w * scale))
    img = _image(h, w, seed=h + w)
    got = fb.level_image(img, scale, lh, lw)
    full = fb.resize_bilinear_reference(fb.gaussian_blur_reference(img, ksize, sigma), lh, lw)
    assert torch.equal(got, full)
    want = jax.jit(lambda a: jfb.resize_bilinear(jfb.gaussian_blur(a, ksize, sigma), lh, lw))(
        jnp.asarray(img.numpy()))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_reflect101_is_numpy_reflect():
    for size in range(1, 12):
        for n in (0, 1, 3, size, 2 * size + 1, 45):
            want = np.pad(np.arange(size), n, mode="reflect")
            got = fb.reflect101(torch.arange(-n, size + n), size).numpy()
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("size,out", [(200, 60), (97, 324), (1, 19), (7, 2), (5, 5)])
def test_resize_table_is_the_jax_numpy_table_and_cached(size, out):
    i0, i1, wgt, rest = fb.resize_table(size, out, torch.device("cpu"))
    f = (np.arange(out) + 0.5) * (size / out) - 0.5
    j0 = np.clip(np.floor(f).astype(np.int32), 0, max(size - 2, 0))
    jw = (np.clip(f - j0, 0.0, 1.0).astype(np.float32) if size > 1
          else np.zeros(out, np.float32))
    np.testing.assert_array_equal(i0.numpy(), j0)
    np.testing.assert_array_equal(i1.numpy(), np.minimum(j0 + 1, size - 1))
    np.testing.assert_array_equal(wgt.numpy(), jw)
    np.testing.assert_array_equal(rest.numpy(), np.float32(1) - jw)
    assert fb.resize_table(size, out, torch.device("cpu"))[0] is i0  # built once


def test_taps_are_the_kernels_layout():
    for ksize, sigma in ((3, 0.0), (7, 1.1667), (25, 5.0556), (91, 18.019)):
        off, ws = lk._taps(ksize, sigma)
        taps = fb.blur_taps(ksize, sigma)
        assert off.dtype == np.int32 and ws.dtype == np.float32
        assert (np.diff(off) > 0).all() and (ws != 0).all()
        np.testing.assert_array_equal(ws, taps[off + ksize // 2])
    with pytest.raises(ValueError, match="taps"):
        lk._taps(lk.MAX_TAPS + 2, 40.0)
    assert int(re.search(r"kMaxTaps = (\d+);", SOURCE.read_text()).group(1)) == lk.MAX_TAPS


def _c_params(name: str) -> int:
    text = SOURCE.read_text()
    m = re.search(rf"int {name}\(([^)]*)\)", text)
    return len(m.group(1).split(","))


@pytest.mark.parametrize("name", ["datmo_level_image", "datmo_blur", "datmo_resize"])
def test_c_signatures_match_the_source(name):
    """``kernels/build`` binds each K8 entry point with as many arguments as
    the C source declares."""
    argtypes, _ = build._SIGNATURES[name]
    assert len(argtypes) == _c_params(name)


def test_roofline_counts_the_level_image_and_the_resize():
    blur = roofline.level_image(1080, 1920, 1080, 1920, 3)
    assert blur.bytes == 8 * 1080 * 1920 and blur.bound_by() == "bytes"
    level = roofline.level_image(1080, 1920, 324, 576, 7)
    assert level.bytes == 4 * (1080 * 1920 + 324 * 576)
    assert roofline._read_positions(1080, 324) == 648  # two rows per output, none shared
    up = roofline.resize(2, 324, 576, 1080, 1920, True)
    assert up.bytes == 8 * (324 * 576 + 1080 * 1920) and up.bound_by() == "bytes"
    assert roofline.level_image(2176, 3840, 59, 104, 91).bound_by() == "bytes"
