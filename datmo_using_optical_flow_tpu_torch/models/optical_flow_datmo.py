"""Pipeline A's per-frame step in PyTorch: BEV frames -> Farnebäck flow -> DATMO tail.

The counterpart of ``datmo_using_optical_flow_tpu.models.optical_flow_datmo``
for the step functions and the streaming runner's device calls (the JAX
package runs them with ``use_pallas=True``; here the flow's kernels are CUDA
for CUDA tensors and their plain versions for CPU tensors).  Same carries,
outputs and semantics:

* stream mode (:meth:`PipelineA.step_stream`) carries the previous frame's
  coefficient pyramid, so each frame's polynomial expansion runs once; the
  first frame primes it and reports ``skip``;
* an invalid pair (an all-zero BEV on either side) is a masked no-op that
  leaves the carried state untouched.

Preprocessing from point clouds and the file runner are not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from datmo_using_optical_flow_tpu_torch.config import PipelineAConfig
from datmo_using_optical_flow_tpu_torch.models import tracker_a
from datmo_using_optical_flow_tpu_torch.ops import masks as mask_ops
from datmo_using_optical_flow_tpu_torch.ops.dbscan import dbscan_velocity_grid
from datmo_using_optical_flow_tpu_torch.ops.farneback import (
    OPTFLOW_FARNEBACK_GAUSSIAN,
    _farneback_impl,
    build_pyramid,
    flow_from_pyramids,
)
from datmo_using_optical_flow_tpu_torch.oracle.np_farneback import level_sizes
from datmo_using_optical_flow_tpu_torch.utils.device import resolve_device
from datmo_using_optical_flow_tpu_torch.utils.tree import select, stack


class StepOutputs(NamedTuple):
    """Per-frame-pair observables."""

    skip: torch.Tensor            # bool: invalid BEV pair -> masked no-op
    velocity_x: torch.Tensor      # filtered vx grid
    velocity_y: torch.Tensor
    magnitude: torch.Tensor
    angular: torch.Tensor         # curl of the filtered grids
    raw_velocity_x: torch.Tensor  # pre-mask grids
    raw_velocity_y: torch.Tensor
    labels: torch.Tensor          # compacted DBSCAN labels
    rows: torch.Tensor
    cols: torch.Tensor
    cell_count: torch.Tensor
    cell_overflow: torch.Tensor   # bool: valid cells exceeded max_cells
    snapshot: tracker_a.TrackTable  # post-association table


class StepCarry(NamedTuple):
    prev_vx: torch.Tensor
    prev_vy: torch.Tensor
    has_prev: torch.Tensor  # bool scalar
    table: tracker_a.TrackTable


class StreamCarry(NamedTuple):
    """Stream-mode carry: pair state plus the previous frame's pyramid."""

    step: StepCarry
    pyr: tuple                  # per-level (5, lh, lw) planes of the previous frame
    frame_valid: torch.Tensor   # bool: previous frame had a nonzero BEV
    has_frame: torch.Tensor     # bool: any previous frame seen


def _gaussian(cfg: PipelineAConfig) -> bool:
    return bool(cfg.farneback.flags & OPTFLOW_FARNEBACK_GAUSSIAN)


def _step_impl(bev1: torch.Tensor, bev2: torch.Tensor, carry: StepCarry,
               cfg: PipelineAConfig, fast_warp: bool) -> tuple[StepCarry, StepOutputs]:
    """Pair-mode step: both frames' pyramids are built here."""
    fb = cfg.farneback
    flow = _farneback_impl(bev1.to(torch.float32), bev2.to(torch.float32), fb.pyr_scale,
                           fb.levels, fb.winsize, fb.iterations, fb.poly_n, fb.poly_sigma,
                           fast_warp, _gaussian(cfg))
    pair_valid = torch.any(bev1 > 0) & torch.any(bev2 > 0)
    return _datmo_tail(flow, pair_valid, carry, cfg)


def _stream_step_impl(bev: torch.Tensor, carry: StreamCarry, cfg: PipelineAConfig,
                      fast_warp: bool) -> tuple[StreamCarry, StepOutputs]:
    """Stream-mode step: one new frame; the previous frame's pyramid rides in
    the carry (a pure function of the BEV, so reusing it equals recomputing it)."""
    fb = cfg.farneback
    pyr2 = build_pyramid(bev.to(torch.float32), fb.pyr_scale, fb.levels, fb.poly_n,
                         fb.poly_sigma)
    flow = flow_from_pyramids(carry.pyr, pyr2, fb.pyr_scale, fb.winsize, fb.iterations,
                              fast_warp, _gaussian(cfg))
    cur_valid = torch.any(bev > 0)
    pair_valid = carry.has_frame & carry.frame_valid & cur_valid
    new_step, outputs = _datmo_tail(flow, pair_valid, carry.step, cfg)
    new_carry = StreamCarry(step=new_step, pyr=pyr2, frame_valid=cur_valid,
                            has_frame=torch.ones((), dtype=torch.bool, device=bev.device))
    return new_carry, outputs


def _datmo_tail(flow: torch.Tensor, pair_valid: torch.Tensor, carry: StepCarry,
                cfg: PipelineAConfig) -> tuple[StepCarry, StepOutputs]:
    """Velocity, continuity mask, DBSCAN over the moving cells, tracking."""
    c = cfg
    velocity_x, velocity_y, _ = mask_ops.velocity_from_flow(flow, c.x_range, c.y_range)

    cont = mask_ops.continuity_mask(velocity_x, velocity_y, c.masks.alpha_cont)
    combined = cont.to(velocity_x.dtype)
    vx_f = velocity_x * combined
    vy_f = velocity_y * combined
    magnitude = torch.sqrt(vx_f * vx_f + vy_f * vy_f)
    angular = mask_ops.gradient(vy_f, 1) - mask_ops.gradient(vx_f, 0)

    valid = magnitude > c.velocity_threshold
    labels, rows, cols, _, count = dbscan_velocity_grid(
        vx_f, vy_f, valid, c.dbscan.eps, c.dbscan.min_samples, c.grid_shape,
        c.capacities.max_cells)

    clusters = tracker_a.extract_clusters(labels, rows, cols, vx_f, vy_f,
                                          c.capacities.max_clusters)
    t = c.tracker
    snapshot = tracker_a.associate_and_update(carry.table, clusters, c.dt, t.process_noise,
                                              t.measurement_noise, t.gamma)
    table = tracker_a.lifecycle(snapshot, t.m1, t.n1, t.m2, t.n2)

    # an invalid pair leaves the carried state untouched
    skip = ~pair_valid
    advanced = StepCarry(prev_vx=velocity_x, prev_vy=velocity_y,
                         has_prev=torch.ones((), dtype=torch.bool, device=flow.device),
                         table=table)
    new_carry = select(skip, carry, advanced)
    total_valid = torch.sum(valid.to(torch.int32))
    outputs = StepOutputs(skip=skip, velocity_x=vx_f, velocity_y=vy_f,
                          magnitude=magnitude, angular=angular,
                          raw_velocity_x=velocity_x, raw_velocity_y=velocity_y,
                          labels=labels, rows=rows, cols=cols, cell_count=count,
                          cell_overflow=total_valid > c.capacities.max_cells,
                          snapshot=snapshot)
    return new_carry, outputs


class PipelineA:
    """Runner for the optical-flow DATMO step on one device (the card unless
    the caller passes ``device="cpu"``; without CUDA the default raises).

    ``fast_warp`` selects the packed int16/int8 warp for the pyramid levels
    below the fused kernel's size (the JAX kernel path always packs there);
    with it off those levels warp exactly.
    """

    def __init__(self, cfg: PipelineAConfig | None, device: str | torch.device = "cuda",
                 fast_warp: bool = True):
        self.cfg = (cfg or PipelineAConfig()).validate()
        self.device = resolve_device(device)
        self.fast_warp = fast_warp

    def init_carry(self) -> StepCarry:
        h, w = self.cfg.grid_shape
        dev = self.device
        return StepCarry(
            prev_vx=torch.zeros((h, w), dtype=torch.float32, device=dev),
            prev_vy=torch.zeros((h, w), dtype=torch.float32, device=dev),
            has_prev=torch.zeros((), dtype=torch.bool, device=dev),
            table=tracker_a.new_track_table(self.cfg.capacities.max_tracks, dev),
        )

    def init_stream_carry(self) -> StreamCarry:
        fb = self.cfg.farneback
        h, w = self.cfg.grid_shape
        pyr = tuple(torch.zeros((5, lh, lw), dtype=torch.float32, device=self.device)
                    for _, _, lh, lw in level_sizes(h, w, fb.pyr_scale, fb.levels))
        false = torch.zeros((), dtype=torch.bool, device=self.device)
        return StreamCarry(step=self.init_carry(), pyr=pyr, frame_valid=false,
                           has_frame=false)

    def step(self, bev1: torch.Tensor, bev2: torch.Tensor, carry: StepCarry
             ) -> tuple[StepCarry, StepOutputs]:
        """One frame-pair step."""
        return _step_impl(bev1, bev2, carry, self.cfg, self.fast_warp)

    def step_stream(self, bev: torch.Tensor, carry: StreamCarry
                    ) -> tuple[StreamCarry, StepOutputs]:
        """Stream-mode step: feed ONE new frame (uint8 BEV on this device)."""
        return _stream_step_impl(bev, carry, self.cfg, self.fast_warp)

    def scan_steps(self, bevs: torch.Tensor, carry: StepCarry
                   ) -> tuple[StepCarry, StepOutputs]:
        """Run a (T, H, W) clip in stream mode from ``carry``: returns the final
        carry and the T-1 pair outputs stacked."""
        sc = self.init_stream_carry()._replace(step=carry)
        sc, _ = self.step_stream(bevs[0], sc)  # prime the pyramid
        outs = []
        for i in range(1, bevs.shape[0]):
            sc, out = self.step_stream(bevs[i], sc)
            outs.append(out)
        return sc.step, stack(outs)
