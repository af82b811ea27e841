"""Stream-parallel DATMO: several feeds served by one card, the counterpart
of ``datmo_using_optical_flow_tpu.parallel.streams``.

The JAX package maps one feed per device of a ``'stream'`` mesh axis and
sums its monitoring metrics with ``psum``.  Here every carry and input has a
leading stream axis, as there, but the caller names a ``device`` and the
number of streams instead of a mesh: all streams run on that one device,
and the metrics are plain sums there (0-d tensors, no host read).

The streams advance one after another, each through the single-stream step
of its pipeline (``optical_flow_datmo._step_impl`` / ``_stream_step_impl``,
``gmfa.GMFAPipeline.step``), on the current CUDA stream.  Not one
``torch.cuda.Stream`` per feed: a step is bound by its host dispatch (pipeline
A's 1080p step keeps the card busy ~16 of ~70-90 ms, PERF.md), and one Python
thread issues every stream's launches either way, so side streams would add
``wait_stream`` / ``record_stream`` bookkeeping and no overlap where the time
goes.  A stream's outputs and carry are therefore those of the single-stream
step on its inputs, bit for bit, on the card as on the CPU.

Builders (each returns a function; the JAX names are kept):

* :func:`init_stream_carry` and :func:`make_multi_stream_step`: pipeline A's
  frame-pair step, ``(bev1, bev2, carry) -> (carry, outputs, metrics)``;
* :func:`init_stream_mode_carry` and :func:`make_stream_mode_step`: the
  stream-mode step the JAX package's ``benchmarks/bench_multistream.py``
  builds (one new frame per feed, each carrying its coefficient pyramid),
  ``(bevs, carry) -> (carry, outputs, total_cells)``;
* :func:`init_gmfa_stream_carry`, :func:`seed_gmfa_stream_carry` and
  :func:`make_multi_stream_gmfa_step`: GMFA's frame step,
  ``(points, mask, carry, keys) -> (carry, outputs, metrics)``.
"""

from __future__ import annotations

import torch

from datmo_using_optical_flow_tpu_torch.config import GMFAConfig, PipelineAConfig
from datmo_using_optical_flow_tpu_torch.models.gmfa import GMFAPipeline
from datmo_using_optical_flow_tpu_torch.models.optical_flow_datmo import (PipelineA,
                                                                          StepCarry,
                                                                          StreamCarry)
from datmo_using_optical_flow_tpu_torch.ops import nn_kernels
from datmo_using_optical_flow_tpu_torch.utils.tree import stack, unstack


def _repeat(tree, n: int):
    """``n`` copies of a carry stacked on a new leading axis."""
    return stack([tree] * n)


def _per_feed(step_fn, carry, *inputs):
    """``step_fn(*feed_inputs, feed_carry) -> (carry, outputs)`` on each feed in
    turn (each input and the carry indexed on their leading axis; a feed's
    carry is a view); the new carries and the outputs stacked again."""
    carries, outs = [], []
    for s in range(inputs[0].shape[0]):
        c, o = step_fn(*(x[s] for x in inputs), unstack(carry, s))
        carries.append(c)
        outs.append(o)
    return stack(carries), stack(outs)


def init_stream_carry(cfg: PipelineAConfig, n_streams: int,
                      device: str | torch.device = "cuda") -> StepCarry:
    """Pipeline A's frame-pair carry for ``n_streams`` feeds."""
    return _repeat(PipelineA(cfg, device).init_carry(), n_streams)


def make_multi_stream_step(cfg: PipelineAConfig, fast_warp: bool = True,
                           device: str | torch.device = "cuda"):
    """The frame-pair step over every feed: ``(bev1, bev2, carry) ->
    (carry, outputs, metrics)`` with (n_streams, H, W) uint8 BEVs on
    ``device`` and ``metrics = {"total_tracks", "total_cells"}``, the live
    tracks and clustered cells summed over the feeds."""
    pipe = PipelineA(cfg, device, fast_warp=fast_warp)

    def step(bev1: torch.Tensor, bev2: torch.Tensor, carry: StepCarry):
        new_carry, outputs = _per_feed(pipe.step, carry, bev1, bev2)
        metrics = {"total_tracks": torch.sum(new_carry.table.alive.to(torch.int32)),
                   "total_cells": torch.sum(outputs.cell_count)}
        return new_carry, outputs, metrics

    return step


def init_stream_mode_carry(cfg: PipelineAConfig, n_streams: int,
                           device: str | torch.device = "cuda") -> StreamCarry:
    """Pipeline A's stream-mode carry (pair state and pyramid) for
    ``n_streams`` feeds."""
    return _repeat(PipelineA(cfg, device).init_stream_carry(), n_streams)


def make_stream_mode_step(cfg: PipelineAConfig, fast_warp: bool = True,
                          device: str | torch.device = "cuda"):
    """One new frame for every feed: ``(bevs, carry) -> (carry, outputs,
    total_cells)`` with (n_streams, H, W) uint8 BEVs; each feed runs
    ``PipelineA.step_stream`` on its carried pyramid (the first call primes
    them and reports ``skip``)."""
    pipe = PipelineA(cfg, device, fast_warp=fast_warp)

    def step(bevs: torch.Tensor, carry: StreamCarry):
        new_carry, outputs = _per_feed(pipe.step_stream, carry, bevs)
        return new_carry, outputs, torch.sum(outputs.cell_count)

    return step


def init_gmfa_stream_carry(cfg: GMFAConfig, n_streams: int,
                           device: str | torch.device = "cuda"):
    """GMFA's carry for ``n_streams`` feeds."""
    return _repeat(GMFAPipeline(cfg, device=device).init_carry(), n_streams)


def seed_gmfa_stream_carry(carry, points: torch.Tensor, mask: torch.Tensor):
    """Seed each feed's previous cloud with its Morton order (the
    stream-axis ``GMFAPipeline.seed_carry``; JAX ``parallel/streams.py:94-104``).
    ``points``: (n_streams, P, 3), ``mask``: (n_streams, P)."""
    order = torch.stack([nn_kernels.sort_order(points[s], mask[s])
                         for s in range(points.shape[0])])
    return carry._replace(prev_points=points, prev_mask=mask, prev_order=order)


def make_multi_stream_gmfa_step(cfg: GMFAConfig, max_moving: int = 8192,
                                device: str | torch.device = "cuda"):
    """GMFA's frame step over every feed: ``(points, mask, carry, keys) ->
    (carry, outputs, metrics)`` with (n_streams, P, 3) expanded clouds and
    (n_streams, P) masks on ``device``, ``keys`` one threefry key per feed
    (``utils.prng``, on the host: (n_streams, 2)) and ``metrics =
    {"total_tracks", "total_moving"}`` summed over the feeds."""
    pipe = GMFAPipeline(cfg, max_moving, device)

    def step(points: torch.Tensor, mask: torch.Tensor, carry, keys: torch.Tensor):
        new_carry, outputs = _per_feed(
            lambda p, m, k, c: pipe.step(p, m, c, k), carry, points, mask, keys)
        metrics = {"total_tracks": torch.sum(new_carry.table.alive.to(torch.int32)),
                   "total_moving": torch.sum(outputs.moving_count)}
        return new_carry, outputs, metrics

    return step
