"""Soundness probe of K5's bounds as ICP uses them, at GMFA's reference load:
the counterpart of the JAX package's ``benchmarks/diag_icp_sound.py``.

Against an exact reference, a float64 tiled scan (the float32 scan of
:func:`ops.nn.nearest_neighbors_scan` is not one here: on GMFA's densified
clouds, whose copies of a point lie closer together than its error envelope
of ~2e-6 (|s|^2 + max |t|^2), its winner is often not the nearest; the
report counts those rows as ``scan32_winner_farther``), it counts three
kinds of violation, each of which would let ICP's exclusion shell drop a
true correspondence:

* ``*_lo_violations``: a valid row whose sound lower bound ``lo`` (from
  :func:`ops.nn.nearest_neighbors_with_bound`, capped at 5x the gate and
  uncapped) exceeds its true d2 (tolerance 1e-6 + 1e-5 sqrt(d2), the JAX
  probe's);
* ``*_subcap_mismatch``: a row whose true d2 is under the cap but whose
  returned winner lies farther than the truth (both d2 in float64) by more
  than K5's error envelope on the two candidates (``nn_kernels.ALPHA`` of
  their squared norms about the block's recentring row: within it the sweep
  cannot tell them apart).  Beside it, not a violation by itself:
  ``*_subcap_over_1e-6``, the rows farther than the JAX probe's tolerance
  of 1e-6 (:func:`strict_violations`; the first 16 under ``*_rows``; where
  a block spans metres, K5's envelope exceeds it), ``*_subcap_other_winner``,
  the rows whose winner is another point, and ``*_subcap_max_excess`` with
  the envelope of its row;
* ``exclusion_violations``: after one rigid step of ~2 mm (a 1e-4 rad yaw and
  (2, -1, 0.5) mm), a row that the reverse-triangle decay of the capped
  bound excludes although its true d2 at the new position is inside the gate.

    python -m datmo_using_optical_flow_tpu_torch.diagnostics.icp_sound

prints one JSON line (``"metric": "diag_icp_sound"``, the exclusion
violations as its value, every count under ``detail``) after building
frames 0 and 1 of ``benchmarks/gmfa_reference_load``'s scene with the
port's preprocessing (102,400 expanded points per cloud).
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch

from datmo_using_optical_flow_tpu_torch.diagnostics.measure import card_label
from datmo_using_optical_flow_tpu_torch.ops import nn_kernels
from datmo_using_optical_flow_tpu_torch.ops.icp import _DELTA_PAD, transform_points
from datmo_using_optical_flow_tpu_torch.ops.nn import (nearest_neighbors_scan,
                                                       nearest_neighbors_with_bound)
from datmo_using_optical_flow_tpu_torch.utils.device import resolve_device
from datmo_using_optical_flow_tpu_torch.utils.ordered import norm_rn, sqrt_rn

_TILE = 2048  # targets per tile of the float64 reference scan
# the one rigid step of the exclusion probe (JAX diag_icp_sound.py:140-143)
_YAW = 1e-4
_SHIFT = (0.002, -0.001, 0.0005)


def _truth(pts: torch.Tensor, tgt: torch.Tensor, tgt_mask: torch.Tensor
           ) -> tuple[np.ndarray, np.ndarray]:
    """Each row's nearest valid target and the float64 d2 to it (+inf where
    there is none), by a float64 tiled scan: the expansion's error there is
    ~1e-13 at ROI scale, far under the 1e-6 the counts allow; the winner's
    d2 is then taken by direct subtraction."""
    p64, t64 = pts.double(), tgt.double()
    sn = (p64 * p64).sum(dim=1)
    best_d = torch.full((pts.shape[0],), torch.inf, dtype=torch.float64, device=pts.device)
    best_i = torch.zeros(pts.shape[0], dtype=torch.int64, device=pts.device)
    for j in range(0, tgt.shape[0], _TILE):
        t, tm = t64[j:j + _TILE], tgt_mask[j:j + _TILE]
        d2 = (sn[:, None] + (t * t).sum(dim=1)[None, :]) - 2.0 * (p64 @ t.T)
        d2 = torch.where(tm[None, :], d2, torch.inf)
        td, ti = torch.min(d2, dim=1)
        take = td < best_d
        best_d = torch.where(take, td, best_d)
        best_i = torch.where(take, ti + j, best_i)
    diff = p64 - t64[best_i]
    exact = torch.where(torch.isfinite(best_d), (diff * diff).sum(dim=1), torch.inf)
    return best_i.cpu().numpy(), exact.cpu().numpy()


def _scan_winner_d2(pts: torch.Tensor, tgt: torch.Tensor, tgt_mask: torch.Tensor
                    ) -> np.ndarray:
    """float64 d2 at the float32 scan's winner (:func:`ops.nn.nearest_neighbors_scan`)."""
    idx, d2 = nearest_neighbors_scan(pts, tgt, tgt_mask)
    diff = pts.double() - tgt.double()[idx.long()]
    return torch.where(torch.isfinite(d2), (diff * diff).sum(dim=1), torch.inf).cpu().numpy()


def _recentring_rows(src: torch.Tensor) -> torch.Tensor:
    """The row each source row's K5 block recentres on in
    :func:`ops.nn.nearest_neighbors_with_bound` (its Morton order, 256-row
    blocks, the block's first row)."""
    n = src.shape[0]
    order = torch.argsort(nn_kernels._morton_keys(src.to(torch.float32)), stable=True)
    first = order[(torch.arange(n, device=src.device) // nn_kernels.SRC_BLOCK)
                  * nn_kernels.SRC_BLOCK]
    cent = torch.empty_like(src, dtype=torch.float64)
    cent[order] = src.double()[first]
    return cent


def _envelope(src: torch.Tensor, winner: torch.Tensor, cent: torch.Tensor) -> np.ndarray:
    """K5's error envelope on a candidate's d2, ALPHA (|s - c|^2 + |w - c|^2)
    with c the row's recentring row: two winners whose true distances lie
    within both envelopes are a tie to the sweep."""
    s, w = src.double() - cent, winner.double() - cent
    return (nn_kernels.ALPHA * ((s * s).sum(dim=1) + (w * w).sum(dim=1))).cpu().numpy()


def probe(src: torch.Tensor, src_mask: torch.Tensor, tgt: torch.Tensor,
          tgt_mask: torch.Tensor, threshold: float = 0.02) -> dict:
    """The violation counts (and the rows excluded) for ICP's first query
    of ``src`` against ``tgt``, on their device."""
    thr = np.float32(threshold)
    thr2 = float(thr * thr)
    cap2 = float(np.float32(5.0) * thr * (np.float32(5.0) * thr))
    sm = src_mask.cpu().numpy()
    idx_t, d2_t = _truth(src, tgt, tgt_mask)
    # the float32 scan as a reference: its winner may be farther than the
    # truth wherever targets lie closer together than its envelope
    report = {"rows": int(sm.sum()), "scan32_winner_farther": int(
        (sm & (_scan_winner_d2(src, tgt, tgt_mask) - d2_t > 1e-6)).sum())}
    lo_capped = None
    cent = _recentring_rows(src)
    env_t = _envelope(src, tgt[torch.from_numpy(idx_t).to(src.device)], cent)
    for name, cap in (("capped", cap2), ("uncapped", None)):
        idx, d2, lo = nearest_neighbors_with_bound(src, tgt, tgt_mask, cap2=cap)
        if cap is not None:
            lo_capped = lo
        winner = tgt[idx.long()]
        env = env_t + _envelope(src, winner, cent)
        diff = src.double() - winner.double()
        d2_w = torch.where(torch.isfinite(d2), (diff * diff).sum(dim=1), torch.inf).cpu().numpy()
        idx, lo = idx.cpu().numpy(), lo.cpu().numpy()
        viol = sm & (lo > d2_t + 1e-6 + 1e-5 * np.sqrt(d2_t))
        sub = sm & (d2_t < (np.inf if cap is None else cap - 1e-9))
        excess = np.where(sub, d2_w - d2_t, 0.0)
        report[f"{name}_lo_violations"] = int(viol.sum())
        report[f"{name}_subcap_mismatch"] = int((excess > env + 1e-9).sum())
        report[f"{name}_subcap_over_1e-6"] = int((excess > 1e-6).sum())
        report[f"{name}_subcap_over_1e-6_rows"] = np.flatnonzero(excess > 1e-6)[:16].tolist()
        report[f"{name}_subcap_other_winner"] = int((sub & (idx != idx_t)).sum())
        report[f"{name}_subcap_max_excess"] = float(excess.max(initial=0.0))
        report[f"{name}_subcap_envelope_at_max"] = float(env[np.argmax(excess)])
    c, s = np.cos(_YAW), np.sin(_YAW)
    step = np.eye(4, dtype=np.float32)
    step[:2, :2] = [[c, -s], [s, c]]
    step[:3, 3] = _SHIFT
    pts1 = transform_points(src, torch.from_numpy(step).to(src.device))
    delta = norm_rn(pts1, src) + _DELTA_PAD
    lo_new = sqrt_rn(lo_capped) - delta
    excluded = ((lo_new > 0.0) & (lo_new * lo_new > thr2)).cpu().numpy() & sm
    _, d2_t1 = _truth(pts1, tgt, tgt_mask)
    report["exclusion_violations"] = int((excluded & (d2_t1 <= thr2)).sum())
    report["excluded_total"] = int(excluded.sum())
    return report


def violations(report: dict) -> int:
    """The sum of the counts that must be 0."""
    return sum(v for k, v in report.items()
               if k.endswith(("_lo_violations", "_subcap_mismatch", "exclusion_violations")))


def strict_violations(report: dict) -> int:
    """The rows whose winner is farther than the truth by more than 1e-6,
    capped and uncapped: none where every block is compact enough for K5's
    envelope to stay under the JAX probe's tolerance."""
    return sum(v for k, v in report.items() if k.endswith("_subcap_over_1e-6"))


def reference_clouds(device: str | torch.device = "cuda"):
    """Frames 0 and 1 of ``gmfa_reference_load``'s scene, preprocessed by the
    port on ``device`` with that benchmark's keys: ``(pipe, [(points, mask)] * 2)``."""
    from datmo_using_optical_flow_tpu_torch.benchmarks import gmfa_reference_load as ref
    from datmo_using_optical_flow_tpu_torch.models.gmfa import GMFAPipeline

    cfg = ref.config()
    pipe = GMFAPipeline(cfg, ref.MAX_MOVING, device=device)
    return pipe, ref.clouds(pipe, ref.raw_frames(cfg, ref.scene(), 2))


def run(device: str | torch.device = "cuda") -> dict:
    dev = resolve_device(device)
    pipe, cl = reference_clouds(dev)
    report = probe(*cl[0], *cl[1], pipe.cfg.icp.threshold)
    card = card_label(dev)
    print(f"icp_sound: {report} [{card}]", file=sys.stderr)
    return {"metric": "diag_icp_sound", "value": report["exclusion_violations"],
            "unit": "violations", "detail": report, "card": card}


def main() -> int:
    out = run()
    print(json.dumps(out))
    return 0 if violations(out["detail"]) == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
