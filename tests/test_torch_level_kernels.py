"""K8's wrapper and plain versions on the CPU (``ops/level_kernels.py``,
``ops/farneback.py``): the dispatch, the level image's restricted evaluation,
the level images' tile plan (coverage, staged ranges, shared memory), the
tables and taps the CUDA kernels read, their C signatures, and the level
images against the JAX package's jitted blur and resize."""

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
from datmo_using_optical_flow_tpu_torch.oracle.np_farneback import level_sizes
from torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)

SOURCE = Path(lk.__file__).resolve().parents[1] / "csrc" / "level_kernels.cu"


def _image(h, w, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).uniform(0, 255, (h, w))
                            .astype(np.float32))


def test_cpu_tensors_take_the_plain_versions():
    img = _image(40, 60)
    flow = torch.randn(2, 12, 18, generator=torch.Generator().manual_seed(1))
    lk.reset_launches()
    levels = ((0.09, 4, 5), (0.3, 12, 18), (1.0, 40, 60))
    cases = [(lk.level_image(img, 0.3, 12, 18), fb.level_image_reference(img, 0.3, 12, 18)),
             (lk.blur(img, 7, 1.1), fb.gaussian_blur_reference(img, 7, 1.1)),
             (lk.resize(flow, 40, 60, 3.3), fb.resize_bilinear_reference(flow, 40, 60, 3.3)),
             (fb.level_image(img, 0.3, 12, 18), fb.level_image_reference(img, 0.3, 12, 18)),
             (lk.level_images(img, levels), fb.level_images_reference(img, levels)),
             (lk.upsample(flow[0], flow[1], 40, 60, 3.3),
              tuple(fb.resize_bilinear_reference(flow, 40, 60, 3.3))),
             (fb.upsample(flow[0], flow[1], 40, 60), tuple(fb.resize_bilinear(flow, 40, 60)))]
    for got, want in cases:
        if isinstance(got, tuple):
            assert len(got) == len(want) and all(map(torch.equal, got, want))
        else:
            assert torch.equal(got, want)
    assert lk.LAUNCHES == {"level_image": 0}


@pytest.mark.parametrize("call", [lambda t: lk.level_image(t, 0.3, 3, 4),
                                  lambda t: lk.blur(t, 7, 1.1),
                                  lambda t: lk.resize(t, 3, 4),
                                  lambda t: lk.level_images(t, ((0.3, 3, 4), (1.0, 10, 12))),
                                  lambda t: lk.upsample(t, t, 3, 4)])
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


@pytest.mark.parametrize("name", ["datmo_level_images", "datmo_resize"])
def test_c_signatures_match_the_source(name):
    """``kernels/build`` binds each K8 entry point with as many arguments as
    the C source declares."""
    argtypes, _ = build._SIGNATURES[name]
    assert len(argtypes) == _c_params(name)


@pytest.mark.parametrize("name", ["datmo_level_image", "datmo_blur"])
def test_the_two_pass_entries_are_gone(name):
    """The one-level callers take ``datmo_level_images``: the two-pass entry
    points and their kernels are neither in the source nor bound."""
    text = SOURCE.read_text()
    assert f"int {name}(" not in text and name not in build._SIGNATURES
    assert "blur_rows_kernel" not in text and "level_cols_kernel" not in text


def test_roofline_counts_the_level_image_and_the_resize():
    blur = roofline.level_image(1080, 1920, 1080, 1920, 3)
    assert blur.bytes == 8 * 1080 * 1920 and blur.bound_by() == "bytes"
    level = roofline.level_image(1080, 1920, 324, 576, 7)
    assert level.bytes == 4 * (1080 * 1920 + 324 * 576)
    assert roofline._read_positions(1080, 324) == 648  # two rows per output, none shared
    up = roofline.resize(2, 324, 576, 1080, 1920, True)
    assert up.bytes == 8 * (324 * 576 + 1080 * 1920) and up.bound_by() == "bytes"
    assert roofline.level_image(2176, 3840, 59, 104, 91).bound_by() == "bytes"


def test_roofline_counts_the_level_images_in_one_launch():
    """The one-launch bound: the source read once, every level written
    once, the levels' operations summed."""
    levels = ((97, 173, 25), (324, 576, 7), (1080, 1920, 3))
    work = roofline.level_images(1080, 1920, levels)
    assert work.bytes == 4 * (1080 * 1920 + 97 * 173 + 324 * 576 + 1080 * 1920)
    assert work.ops == sum(roofline.level_image(1080, 1920, *lv).ops for lv in levels)
    assert work.bound_by() == "bytes"
    one = roofline.level_images(1080, 1920, ((324, 576, 7),))
    assert one == roofline.level_image(1080, 1920, 324, 576, 7)


# the pyramids of the four flows (1080p, from points, 4K, 720p) and item 10's
# edge shapes (one row, one column, 1x1, a radius past the axis)
PYRAMIDS = [(1080, 1920), (200, 200), (2176, 3840), (720, 1280), (256, 320)]
EDGES = [(1, 64, 3, 0.0), (64, 1, 3, 0.0), (1, 1, 3, 0.0), (3, 200, 25, 5.0556),
         (64, 1, 7, 1.1667), (1, 64, 7, 1.1667), (1, 300, 91, 18.019), (300, 1, 25, 5.0556)]


def _pyramid_specs(h, w):
    sizes = tuple((s, lh, lw) for _, s, lh, lw in level_sizes(h, w, 0.3, 5))
    return lk._level_specs(sizes)


def _edge_specs(h, w, ksize, sigma):
    """The blur alone and the levels at 0.3 and 0.09 of an edge shape."""
    return ((ksize, sigma, h, w), (*fb.level_blur(0.3), max(1, round(h * 0.3)),
                                   max(1, round(w * 0.3))),
            (*fb.level_blur(0.09), max(1, round(h * 0.09)), max(1, round(w * 0.09))))


PLANS = ([pytest.param(h, w, _pyramid_specs(h, w), id=f"pyramid-{h}x{w}")
          for h, w in PYRAMIDS]
         + [pytest.param(h, w, _edge_specs(h, w, k, s), id=f"edge-{h}x{w}-{k}taps")
            for h, w, k, s in EDGES])


@pytest.mark.parametrize("h,w,specs", PLANS)
def test_level_plan_tiles_cover_every_output_and_stage_what_they_read(h, w, specs):
    """Every output of every level lies in exactly one tile; every source row
    a tile's vertical chains read (reflect-101 positions, before reflection)
    lies in its staged window, and every column its horizontal chains read
    in its range of vertical chains; each tile's shared memory fits the
    H100's 232,448 bytes a block."""
    plan = lk.level_plan(h, w, specs)
    tiles = plan.words[:plan.ntiles * lk.TILE_INTS].reshape(-1, lk.TILE_INTS)
    assert plan.smem + lk.STATIC_SMEM <= lk.SMEM_BYTES == 232448
    for li, (ksize, sigma, lh, lw) in enumerate(specs):
        off, _ = lk._taps(ksize, sigma)
        resize = (lh, lw) != (h, w)
        if resize:
            y0, y1, _, _ = (t.numpy() for t in fb.resize_table(h, lh, torch.device("cpu")))
            x0, x1, _, _ = (t.numpy() for t in fb.resize_table(w, lw, torch.device("cpu")))
        else:
            y0 = y1 = np.arange(lh)
            x0 = x1 = np.arange(lw)
        seen = np.zeros((lh, lw), np.int64)
        for _, r0, nr, q0, nq, pc0, npc, ps0, nps, _ in tiles[tiles[:, 0] == li]:
            seen[r0:r0 + nr, q0:q0 + nq] += 1
            rows = np.concatenate([y0[r0:r0 + nr], y1[r0:r0 + nr]])
            cols = np.concatenate([x0[q0:q0 + nq], x1[q0:q0 + nq]])
            read_rows = (rows[:, None] + off[None, :]).ravel() if h > 1 else rows
            read_cols = (cols[:, None] + off[None, :]).ravel() if w > 1 else cols
            assert pc0 <= read_cols.min() and read_cols.max() < pc0 + npc
            if nps:
                assert ps0 <= read_rows.min() and read_rows.max() < ps0 + nps
            floats = (2 * nr if resize else nr) * npc + nps * npc
            assert 4 * floats <= plan.smem
            assert 4 * floats + lk.STATIC_SMEM <= lk.SMEM_BYTES
        assert (seen == 1).all()
        assert plan.offsets[li] % lk.ALIGN == 0 and plan.offsets[li] + lh * lw <= plan.size


@pytest.mark.parametrize("h,w,specs", PLANS)
def test_level_plan_tables_and_taps_are_the_plain_versions(h, w, specs):
    """The plan's int32 tables and taps, as the kernel reads them, equal
    ``fb.resize_table`` and ``_taps`` at every level; so does the resize
    kernel's table."""
    plan = lk.level_plan(h, w, specs)
    words = plan.words
    head = plan.ntiles * lk.TILE_INTS
    for li, (ksize, sigma, lh, lw) in enumerate(specs):
        row = words[head + li * lk.LEVEL_INTS:head + (li + 1) * lk.LEVEL_INTS]
        lh_, lw_, out, taps, count, rows, cols, wy, wx, flags = (int(x) for x in row)
        assert (lh_, lw_, out) == (lh, lw, plan.offsets[li])
        off, ws = lk._taps(ksize, sigma)
        assert count == len(ws)
        np.testing.assert_array_equal(words[taps:taps + count], off)
        np.testing.assert_array_equal(words[taps + count:taps + 2 * count].view(np.float32), ws)
        np.testing.assert_array_equal(words[taps + 2 * count:taps + 3 * count],
                                      [int((ws == x).sum() > 1) for x in ws])
        assert flags == (lk.RESIZE * ((lh, lw) != (h, w)) | lk.ONE_ROW * (h == 1)
                         | lk.ONE_COL * (w == 1))
        if flags & lk.RESIZE:
            ry = fb.resize_table(h, lh, torch.device("cpu"))
            rx = fb.resize_table(w, lw, torch.device("cpu"))
            np.testing.assert_array_equal(words[rows:rows + 2 * lh],
                                          np.concatenate([ry[0].numpy(), ry[1].numpy()]))
            np.testing.assert_array_equal(words[cols:cols + 2 * lw],
                                          np.concatenate([rx[0].numpy(), rx[1].numpy()]))
            np.testing.assert_array_equal(words[wy:wy + lh].view(np.float32), ry[2].numpy())
            np.testing.assert_array_equal(words[wx:wx + lw].view(np.float32), rx[2].numpy())
            table = lk.resize_plan(lh, lw, h, w)  # the upsample back to the image's size
            ty = fb.resize_table(lh, h, torch.device("cpu"))
            tx = fb.resize_table(lw, w, torch.device("cpu"))
            np.testing.assert_array_equal(table.view(np.float32)[2 * h + 2 * w:],
                                          np.concatenate([ty[2].numpy(), tx[2].numpy()]))
            np.testing.assert_array_equal(table[:2 * h + 2 * w], np.concatenate(
                [ty[0].numpy(), ty[1].numpy(), tx[0].numpy(), tx[1].numpy()]))


@pytest.mark.parametrize("h,w", [(200, 200), (256, 320)])
def test_level_images_reference_is_each_level_and_jitted_jax(h, w):
    """``level_images_reference`` is ``level_image_reference`` at each level
    of the pyramid, and equals the level images of the jitted JAX
    ``build_pyramid`` (its blur and resize, jitted as one program)."""
    img = _image(h, w, seed=7)
    sizes = [(s, lh, lw) for _, s, lh, lw in level_sizes(h, w, 0.3, 5)]
    got = fb.level_images_reference(img, sizes)
    assert len(got) == len(sizes)
    for g, (s, lh, lw) in zip(got, sizes):
        assert torch.equal(g, fb.level_image_reference(img, s, lh, lw))
    assert all(map(torch.equal, fb.level_images(img, sizes), got))

    def levels(a):
        return tuple(jfb.resize_bilinear(jfb.gaussian_blur(a, *fb.level_blur(s)), lh, lw)
                     for s, lh, lw in sizes)

    for g, want in zip(got, jax.jit(levels)(jnp.asarray(img.numpy()))):
        np.testing.assert_array_equal(g.numpy(), np.asarray(want))


@pytest.mark.parametrize("shape,out,scale", [((97, 173), (324, 576), 1.0),
                                             ((60, 60), (200, 200), 1.0),
                                             ((18, 31), (60, 104), float(np.float32(1 / 0.3))),
                                             ((5, 5), (5, 5), 1.0), ((5, 5), (5, 5), 2.5),
                                             ((1, 64), (3, 19), 1.0)])
def test_upsample_is_the_resize_of_the_stack(shape, out, scale):
    """``upsample(dx, dy, ...)`` on CPU tensors equals the plain resize of
    ``torch.stack([dx, dy])``, with no launch counted."""
    gen = torch.Generator().manual_seed(3)
    dx, dy = (torch.randn(shape, generator=gen) * 3 for _ in range(2))
    lk.reset_launches()
    got = lk.upsample(dx, dy, *out, scale)
    want = fb.resize_bilinear_reference(torch.stack([dx, dy]), *out, scale)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert lk.LAUNCHES == {"level_image": 0}
