"""Pipeline A in PyTorch: PCD points -> BEV -> Farnebäck flow -> DATMO tail -> tracks.

The counterpart of ``datmo_using_optical_flow_tpu.models.optical_flow_datmo``
(the JAX package runs it with ``use_pallas=True``; here the flow's kernels are
CUDA for CUDA tensors and their plain versions for CPU tensors).  Same
carries, outputs and semantics:

* :meth:`PipelineA.preprocess` turns one frame's padded points into the uint8
  BEV (flip x, RANSAC ground removal, ROI, compaction, densification x10,
  rasterisation), with no host synchronisation;
* stream mode (:meth:`PipelineA.step_stream`) carries the previous frame's
  coefficient pyramid, so each frame's polynomial expansion runs once; the
  first frame primes it and reports ``skip``;
* an invalid pair (an all-zero BEV on either side) is a masked no-op that
  leaves the carried state untouched;
* :meth:`PipelineA.process_files` runs a PCD sequence end to end (the
  reference's ``process_multiple_frames``, ``Optical_flow/main.py:541``),
  writing the reference's artifacts from two background threads, with
  checkpoint and resume.
"""

from __future__ import annotations

import time
from typing import NamedTuple, Sequence

import numpy as np
import torch

from datmo_using_optical_flow_tpu_torch.config import PipelineAConfig
from datmo_using_optical_flow_tpu_torch.io.artifacts import ArtifactSink
from datmo_using_optical_flow_tpu_torch.io.frames import DiskFrameSource, dequantize_points_q16
from datmo_using_optical_flow_tpu_torch.models import tracker_a
from datmo_using_optical_flow_tpu_torch.ops import bev as bev_ops
from datmo_using_optical_flow_tpu_torch.ops import masks as mask_ops
from datmo_using_optical_flow_tpu_torch.ops import points as point_ops
from datmo_using_optical_flow_tpu_torch.ops.dbscan import dbscan_velocity_grid
from datmo_using_optical_flow_tpu_torch.ops.farneback import (
    OPTFLOW_FARNEBACK_GAUSSIAN,
    _farneback_impl,
    build_pyramid,
    flow_from_pyramids,
)
from datmo_using_optical_flow_tpu_torch.ops.ransac import remove_ground
from datmo_using_optical_flow_tpu_torch.oracle.np_farneback import level_sizes
from datmo_using_optical_flow_tpu_torch.utils import prng
from datmo_using_optical_flow_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from datmo_using_optical_flow_tpu_torch.utils.device import resolve_device
from datmo_using_optical_flow_tpu_torch.utils.hostpack import HostMirror, HostPacker
from datmo_using_optical_flow_tpu_torch.utils.ordered import fma32
from datmo_using_optical_flow_tpu_torch.utils.padding import compact_masked
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


def _preprocess_impl(points: torch.Tensor, mask: torch.Tensor, key: torch.Tensor,
                     cfg: PipelineAConfig) -> torch.Tensor:
    """flip -> RANSAC ground removal -> ROI -> compact -> densify -> BEV (the
    reference's ``preprocess_pcd``, ``Optical_flow/main.py:59-95``).  int16
    points are q16 fixed point, dequantised here."""
    c = cfg
    if points.dtype == torch.int16:
        points = dequantize_points_q16(points)
    kr, kd = prng.split(key)
    p = point_ops.flip_x(points)
    _, non_ground = remove_ground(p, mask, kr, c.ransac.distance_threshold,
                                  c.ransac.ransac_n, c.ransac.num_iterations)
    roi = non_ground & point_ops.roi_mask(p, c.roi_bounds)
    cpts, cmask, _ = compact_masked(p, roi, c.capacities.max_roi_points)
    ex, exmask = point_ops.densify(cpts, cmask, kd, c.capacities.expansion_factor,
                                   noise_std=c.noise_std)
    return bev_ops.compute_bev_grid(ex, exmask, c.grid_shape, c.x_range, c.y_range,
                                    c.grid_resolution, c.bev_a, c.bev_b, c.z_max)


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


def velocity_magnitude(vx: torch.Tensor, vy: torch.Tensor) -> torch.Tensor:
    """``jnp.sqrt(vx * vx + vy * vy)`` as the JAX package's compiled step
    rounds it (JAX ``models/optical_flow_datmo.py:601``): the contracted
    ``fma(vx, vx, vy * vy)`` and a correctly rounded root."""
    return fma32(vx, vx, vy * vy, root=True)


def _datmo_tail(flow: torch.Tensor, pair_valid: torch.Tensor, carry: StepCarry,
                cfg: PipelineAConfig) -> tuple[StepCarry, StepOutputs]:
    """Velocity, continuity mask, DBSCAN over the moving cells, tracking."""
    c = cfg
    velocity_x, velocity_y, _ = mask_ops.velocity_from_flow(flow, c.x_range, c.y_range)

    cont = mask_ops.continuity_mask(velocity_x, velocity_y, c.masks.alpha_cont)
    combined = cont.to(velocity_x.dtype)
    vx_f = velocity_x * combined
    vy_f = velocity_y * combined
    magnitude = velocity_magnitude(vx_f, vy_f)
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

    def preprocess(self, points: torch.Tensor, mask: torch.Tensor, key: torch.Tensor
                   ) -> torch.Tensor:
        """Padded points (float32, or int16 q16) and their mask -> uint8 BEV
        (the reference's ``preprocess_pcd``), all on this pipeline's device."""
        return _preprocess_impl(points, mask, key, self.cfg)

    def process_files(self, pcd_files: Sequence[str], output_dir: str | None = None,
                      save_png: bool = False, seed: int = 0, progress: bool = False,
                      checkpoint_every: int = 0, checkpoint_path: str | None = None,
                      resume: bool = False, h2d_q16: bool = False) -> dict:
        """Run the pipeline over a PCD sequence and write the reference's
        artifacts (``process_multiple_frames``, ``Optical_flow/main.py:541``).

        Frame i's preprocessing key is ``fold_in(PRNGKey(seed), i)``, as the
        JAX package's is, so a run is reproducible and a resumed run
        continues it bit for bit.  With ``checkpoint_every=K`` the carry goes to
        ``checkpoint_path`` (.npz) every K frames, after the artifacts of
        every frame before it are written; ``resume=True`` restores it and
        continues from the frame it records.  ``h2d_q16`` ships the points
        to the device as int16 fixed point (half the bytes; +-0.5 mm of host
        rounding).

        Each frame's observables are packed on the device into one uint8
        buffer; a transfer thread copies a drained batch of buffers to the
        host at once and a writer thread unpacks them and writes the files,
        through bounded queues (a slow disk holds the loop back instead of
        piling up device buffers).  A thread's first error fails the run.
        Returns the final tracks, host-clock seconds per stage (the device
        stages' are launch times: the calls return before the card finishes)
        and the number of pairs written.
        """
        c = self.cfg
        dev = self.device
        sink = ArtifactSink(output_dir or c.output_folder, save_png=save_png)
        source = DiskFrameSource(pcd_files, capacity=c.capacities.max_raw_points,
                                 quantize_q16=h2d_q16)
        carry = self.init_stream_carry()
        key = prng.PRNGKey(seed)

        start_frame = 0
        if resume and checkpoint_path:
            with np.load(checkpoint_path) as data:
                start_frame = int(data["step"])
            carry = load_checkpoint(checkpoint_path, carry)
            if progress:
                print(f"resumed from {checkpoint_path} at frame {start_frame}")

        timings = {"preprocess": 0.0, "step": 0.0}
        state = {"pairs": 0}
        pack, packer = obs_packer(c)

        def write_artifacts(i: int, obs: dict) -> None:
            sink.save_bev(obs["bev"], i)
            if bool(obs["skip"]):
                return  # a skipped pair writes no pair artifacts (main.py:572-574)
            self.write_pair_artifacts(sink, obs, i - 1)
            state["pairs"] += 1
            if progress:
                print(f"pair {i - 1}: cells={int(obs['count'])} "
                      f"tracks={int(np.asarray(obs['snapshot'].alive).sum())}")
            if bool(obs["overflow"]):
                print(f"pair {i - 1}: WARNING valid cells exceed "
                      f"max_cells={c.capacities.max_cells}; clustering truncated")

        mirror = HostMirror(packer, write_artifacts)
        try:
            for i, (pts, mask) in enumerate(source):
                if i < start_frame:
                    continue
                k = prng.fold_in(key, i)
                try:
                    t0 = time.perf_counter()
                    bev = self.preprocess(torch.from_numpy(pts).to(dev),
                                          torch.from_numpy(mask).to(dev), k.to(dev))
                    timings["preprocess"] += time.perf_counter() - t0
                except RuntimeError:
                    # torch's CUDA errors and the kernels' build and launch
                    # failures are RuntimeErrors: the device's fault, not the frame's
                    raise
                except Exception as e:  # noqa: BLE001
                    # a bad frame must not kill the stream (main.py:635-637)
                    print(f"Error processing frame {i}: {e}")
                    continue

                t0 = time.perf_counter()
                carry, out = self.step_stream(bev, carry)
                timings["step"] += time.perf_counter() - t0

                mirror.put(i, pack(bev, out))
                if (i and checkpoint_every and checkpoint_path
                        and (i + 1) % checkpoint_every == 0):
                    mirror.flush()  # a snapshot never runs ahead of its frames' files
                    save_checkpoint(checkpoint_path, carry, step=i + 1)
        finally:
            mirror.close()
        mirror.check()
        timings.update(artifacts=mirror.seconds["mirror"],
                       artifacts_transfer=mirror.seconds["transfer"])

        tracks = self._tracks_dict(carry.step.table)
        sink.print_final_track_velocities(tracks)
        return {"tracks": tracks, "timings": timings, "pairs": state["pairs"]}

    @staticmethod
    def _tracks_dict(table: tracker_a.TrackTable) -> dict[int, np.ndarray]:
        alive, tid, st = (t.cpu().numpy() for t in (table.alive, table.tid, table.state))
        return {int(tid[i]): st[i] for i in np.nonzero(alive)[0]}

    @staticmethod
    def write_pair_artifacts(sink: ArtifactSink, obs: dict, pair_index: int) -> None:
        """A pair's files (velocity grids, filtered velocities, DBSCAN
        results, tracks) from the host observables ``obs`` of
        :func:`obs_packer`."""
        vx = np.asarray(obs["vx"], dtype=np.float32)
        vy = np.asarray(obs["vy"], dtype=np.float32)
        # magnitude and the curl from the transferred grids with the
        # reference's numpy arithmetic (main.py:600-606), the same float32
        # operations as the device's
        magnitude = np.sqrt(vx * vx + vy * vy)
        angular = _np_gradient(vy, 1) - _np_gradient(vx, 0)
        # the reference saves the raw grids (main.py:580) and then the
        # filtered ones under the same index (main.py:610): the filtered stay
        sink.save_velocity_grid(vx, vy, pair_index)
        sink.append_filtered_velocities(vx, vy, magnitude, angular, pair_index)
        n = int(obs["count"])
        labels = np.asarray(obs["labels"][:n], dtype=np.int32)
        idx = np.stack([obs["rows"][:n], obs["cols"][:n]], axis=1).astype(np.int32)
        sink.save_dbscan_results(labels, idx, pair_index)
        snap = obs["snapshot"]
        tracks = {int(snap.tid[i]): snap.state[i] for i in np.nonzero(snap.alive)[0]}
        sink.save_ekf_tracks(tracks, pair_index)
        sink.append_track_velocities(tracks, pair_index)


def _np_gradient(a: np.ndarray, axis: int) -> np.ndarray:
    """np.gradient along one axis, in the float32 arithmetic of
    :func:`ops.masks.gradient` (central differences, one-sided edges)."""
    a = np.moveaxis(a, axis, 0)
    out = np.concatenate([(a[1] - a[0])[None], (a[2:] - a[:-2]) * np.float32(0.5),
                          (a[-1] - a[-2])[None]], axis=0)
    return np.moveaxis(out, 0, axis)


def obs_packer(cfg: PipelineAConfig):
    """``(pack, packer)``: ``pack(bev, outputs)`` puts one frame's artifact
    observables into one uint8 buffer on the device, in the JAX package's
    layout; ``packer.unpack`` rebuilds them on the host.  Only what the files
    need crosses: the uint8 BEV, the filtered velocity grids, the cluster
    labels and indices (int16 where they fit), the counts and flags and the
    track snapshot; magnitude and curl are recomputed on the host."""
    h, w = cfg.grid_shape
    cap = cfg.capacities
    idx_t = torch.int16 if max(h, w, cap.max_cells) < 2 ** 15 else torch.int32

    def shrink(bev: torch.Tensor, out: StepOutputs) -> dict:
        return {"bev": bev, "skip": out.skip,
                "vx": out.velocity_x, "vy": out.velocity_y,
                "labels": out.labels.to(idx_t),
                "rows": out.rows.to(idx_t), "cols": out.cols.to(idx_t),
                "count": out.cell_count.to(torch.int32), "overflow": out.cell_overflow,
                "snapshot": out.snapshot}

    def meta(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    grid, cells = meta((h, w), torch.float32), meta((cap.max_cells,), torch.int32)
    example = StepOutputs(skip=meta((), torch.bool), velocity_x=grid, velocity_y=grid,
                          magnitude=grid, angular=grid, raw_velocity_x=grid,
                          raw_velocity_y=grid, labels=cells, rows=cells, cols=cells,
                          cell_count=meta((), torch.int32), cell_overflow=meta((), torch.bool),
                          snapshot=tracker_a.new_track_table(cap.max_tracks, "meta"))
    packer = HostPacker(shrink(meta((h, w), torch.uint8), example))
    return (lambda bev, out: packer.pack(shrink(bev, out))), packer
