"""The route of the small exact-warp levels through K3 (``ops/warp.exact_fused``).

On the card, a level of the exact warp (``fast_warp=False``) runs each
iteration as K3, the fused iteration, wherever K3 rounds as K4 then K2 do;
elsewhere (a line, a level of at most 4x4, a Gaussian window with an axis
within its reach) it keeps K4 then K2, and ``datmo_fused_iteration`` refuses
the level.  Here the predicate is held to the C rules it mirrors, case by
case, and ``farneback_level`` to the route it picks.  K3's plain version is
K4's then K2's, so the route's bits on the CPU are those of
``tests/test_torch_farneback.py::test_refinement_bit_equal_to_jitted_jax``'s
level cases; on the card chip_smoke's phase 4c holds them.
"""

import re

import numpy as np
import pytest
import torch

from datmo_using_optical_flow_tpu_torch.kernels import build
from datmo_using_optical_flow_tpu_torch.ops import farneback as fb
from datmo_using_optical_flow_tpu_torch.ops import flow_kernels as fk
from datmo_using_optical_flow_tpu_torch.ops import warp
from torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)

# (h, w, the box window admitted, the Gaussian one admitted) at winsize 15:
# lines; K4's one-valued attenuation (both axes at most 4); the Gaussian
# window's broadcast taps (an axis of 2 to 7 rows, or 3 to 7 columns); just
# past each; the routed levels
_EDGES = [(1, 64, False, False), (64, 1, False, False), (1, 1, False, False),
          (2, 2, False, False), (4, 4, False, False), (2, 4, False, False), (4, 2, False, False),
          (4, 5, True, False), (5, 4, True, False), (2, 64, True, False), (64, 2, True, True),
          (3, 40, True, False), (40, 3, True, False), (7, 7, True, False), (8, 8, True, True),
          (7, 60, True, False), (60, 7, True, False), (60, 60, True, True),
          (97, 173, True, True), (98, 173, True, True), (200, 200, True, True)]


@pytest.mark.parametrize("gaussian", [False, True], ids=["box", "gauss"])
@pytest.mark.parametrize("h,w,box,gauss", _EDGES, ids=[f"{h}x{w}" for h, w, _, _ in _EDGES])
def test_exact_fused_at_its_edges(h, w, box, gauss, gaussian):
    assert warp.exact_fused(h, w, 15, gaussian) == (gauss if gaussian else box)


def _c_window_broadcast(taps: np.ndarray, h: int, w: int) -> bool:
    """``csrc/flow_kernels.cu::window_broadcast``, line by line: whether it
    sets any of the masks v_int, v_pad, h_bcast."""
    winsize = len(taps)
    if all(t == 1.0 for t in taps) or h < 2 or w < 3:
        return False
    r = winsize // 2

    def mask(size, trail):
        out, lead, first = 0, 0, -1
        for k in range(winsize):
            if taps[k] == 0.0:
                continue
            if k <= r - size:
                lead += 1
                if first < 0:
                    first = k
            if trail and k >= r + size:
                out |= 1 << k
        return out | (1 << first) if lead == 1 else out

    return bool(mask(h, False) | mask(h, True) | mask(w, True))


@pytest.mark.parametrize("winsize", [5, 7, 15, 31])
def test_exact_fused_mirrors_the_c_rules(winsize):
    """``warp.UNIFORM_MAX`` is the source's ``kUniformMax`` and
    ``warp.eligible``'s thresholds its ``kFusedMinH`` x ``kFusedMinW``; the
    predicate's window rule is ``window_broadcast``'s (ported line by line
    above) at every shape up to 40x40 and both windows; ``datmo_fused_iteration``
    refuses the levels under 2x2, of at most ``kUniformMax`` rows and
    columns and those ``window_broadcast`` gives a mask."""
    text = (build.CSRC_DIR / "flow_kernels.cu").read_text()
    assert int(re.search(r"constexpr int kUniformMax = (\d+);", text).group(1)) == \
        warp.UNIFORM_MAX
    # K3's small-level instance starts where warp.eligible stops
    fmin_h, fmin_w = (int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))
                      for name in ("kFusedMinH", "kFusedMinW"))
    assert warp.eligible(fmin_h, fmin_w)
    assert not warp.eligible(fmin_h - 1, 10**4) and not warp.eligible(10**4, fmin_w - 1)
    entry = text[text.index("int datmo_fused_iteration("):]
    entry = entry[:entry.index("return with_window_instance")]
    for rule in ("h < 2 || w < 2 || (h <= kUniformMax && w <= kUniformMax)",
                 "window_broadcast(&win, winsize, h, w);",
                 "if (win.v_int | win.v_pad | win.h_bcast) return cudaErrorInvalidValue;"):
        assert rule in entry
    for gaussian in (False, True):
        taps, _ = fk._window(winsize, gaussian)
        for h in range(1, 41):
            for w in range(1, 41):
                bcast = _c_window_broadcast(taps, h, w)
                assert warp.window_broadcasts(h, w, winsize, gaussian) == bcast, (h, w)
                line_or_uniform = h < 2 or w < 2 or (h <= warp.UNIFORM_MAX
                                                     and w <= warp.UNIFORM_MAX)
                assert warp.exact_fused(h, w, winsize, gaussian) == \
                    (not line_or_uniform and not bcast), (h, w)


_LEVELS = [(60, 60), (97, 173), (98, 173), (200, 200), (130, 300), (4, 4), (2, 64), (1, 64),
           (7, 60)]


@pytest.mark.parametrize("fast_warp", [False, True], ids=["exact", "packed"])
@pytest.mark.parametrize("gaussian", [False, True], ids=["box", "gauss"])
@pytest.mark.parametrize("h,w", _LEVELS, ids=[f"{h}x{w}" for h, w in _LEVELS])
def test_farneback_level_takes_the_route(monkeypatch, h, w, gaussian, fast_warp):
    """``farneback_level`` calls K3 each iteration on the levels of at least
    128x256 and, with the exact warp, on the smaller levels ``exact_fused``
    admits; K4 then K2 on the other exact levels; the packed warp's K9 (after
    one scale pass) then K2 on every small packed level, as before the
    route.  The wrappers are stubbed: this holds the routing, the bits are
    held elsewhere."""
    calls = {k: 0 for k in ("fused_iteration", "warp_matrices", "blur_solve",
                            "warp_matrices_packed", "corner_scale")}

    def flow(terms):
        return tuple(torch.zeros(h, w) for _ in range(3 if terms else 2))

    def stub(name, result):
        def call(*args, **kwargs):
            calls[name] += 1
            return result(*args, **kwargs)
        monkeypatch.setattr(fk, name, call)

    stub("fused_iteration", lambda *a: flow(a[7]))
    stub("warp_matrices", lambda *a: torch.zeros(5, h, w))
    stub("warp_matrices_packed", lambda *a: torch.zeros(5, h, w))
    stub("blur_solve", lambda M, win, g, terms: flow(terms))
    stub("corner_scale", lambda R1: torch.ones(5))
    zero = torch.zeros(h, w)
    out = fb.farneback_level(torch.zeros(5, h, w), torch.zeros(5, h, w), zero, zero, 15, 3,
                             fast_warp, gaussian, float(np.float32(1 / 0.3)))
    assert len(out) == 2
    if warp.fused(h, w, 15, gaussian, fast_warp):
        want = {"fused_iteration": 3}
    elif fast_warp:
        want = {"corner_scale": 1, "warp_matrices_packed": 3, "blur_solve": 3}
    else:
        want = {"warp_matrices": 3, "blur_solve": 3}
    assert calls == {k: want.get(k, 0) for k in calls}
    # every small level of the exact warp that a pipeline builds is routed
    if (h, w) in ((60, 60), (97, 173), (98, 173), (200, 200)) and not fast_warp:
        assert want == {"fused_iteration": 3}
