"""Timing and labelling shared by the diagnostics.

On the card a call's time is taken with CUDA events around it (median over
the repetitions, each ending in a synchronize), and its device time from a
``torch.profiler`` trace, summing only the events of ``DeviceType.CUDA`` (the
aten ops' own entries repeat their kernels' time).  Every result names the card
and its power limit as ``nvidia-smi`` prints them.  On the CPU, where the
tests run the diagnostics at tiny sizes, times come from the host clock and
there is no device time: it is ``None``, printed "not measured".
"""

from __future__ import annotations

import os
import statistics
import subprocess
import time
from typing import Callable

import torch

from datmo_using_optical_flow_tpu_torch.diagnostics.roofline import Work

_SENTINELS = 8  # kernels that close each trace (device_us_per_call)
_LEAD = 248  # further sentinels that open each trace, ahead of its _SENTINELS
_SENTINEL_NAME = "spin_kernel"
_ATTEMPTS = 10  # traces taken before LostTrace

# Kineto tears CUPTI down after each trace unless TEARDOWN_CUPTI is "0".  On
# the H100 that leaves traces empty, and every trace once another process has
# profiled the card (``diagnostics/profiler_traces.py``).  Kineto reads the
# variable when a trace ends, so setting it here, after torch is imported, holds.
os.environ.setdefault("TEARDOWN_CUPTI", "0")


def card_label(dev: torch.device) -> str:
    """``name, power.limit`` of the card from ``nvidia-smi``, or "cpu"."""
    if dev.type != "cuda":
        return "cpu"
    index = torch.cuda.current_device() if dev.index is None else dev.index
    out = subprocess.run(["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def ms_per_call(fn: Callable, dev: torch.device, reps: int = 10, warmup: int = 2) -> float:
    """Median ms of one call of ``fn`` (each call synchronized)."""
    for _ in range(warmup):
        fn()
    sync(dev)
    times = []
    for _ in range(reps):
        if dev.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


class LostTrace(RuntimeError):
    """``_ATTEMPTS`` profiler traces in a row lost kernel records."""


def traced_us(kernels: list[tuple[str, float]], reps: int, launches: int) -> float | None:
    """Device µs per call from one trace's kernel records ``(name, µs)`` in
    start order, or ``None`` when the trace lost records.

    The trace is ``_SENTINELS`` sentinels, the ``reps`` calls with one sentinel
    between each two, and ``_SENTINELS`` sentinels.  The opening sentinels may
    lose records (the card's traces lose their first ones), so it counts when
    its first and last records are sentinels, it holds at least
    ``_SENTINELS + reps`` of them (one opening, the separators, the closing
    ones), and each call left at least ``launches`` records of positive
    duration."""
    if not kernels or not all(_SENTINEL_NAME in name for name, _ in (kernels[0], kernels[-1])):
        return None
    calls, run = [], []
    for name, us in kernels:
        if _SENTINEL_NAME in name:
            if run:
                calls.append(run)
            run = []
        else:
            run.append(us)
    n_sentinels = sum(_SENTINEL_NAME in name for name, _ in kernels)
    if not _SENTINELS + reps <= n_sentinels <= 2 * _SENTINELS + reps - 1:
        return None
    if launches and (len(calls) != reps
                     or any(len(c) < launches or min(c) <= 0 for c in calls)):
        return None
    return sum(sum(c) for c in calls) / reps


def trace_layout(kernels: list[tuple[str, float]]) -> str:
    """A trace's records in start order, run-length coded: ``S`` sentinels,
    ``K`` other kernels, ``0`` kernels of no duration (``S8 K1 S1 K1 S8``)."""
    runs: list[list] = []
    for name, us in kernels:
        tag = "S" if _SENTINEL_NAME in name else ("K" if us > 0 else "0")
        if runs and runs[-1][0] == tag:
            runs[-1][1] += 1
        else:
            runs.append([tag, 1])
    text = " ".join(f"{tag}{n}" for tag, n in runs)
    return text if len(text) <= 160 else text[:157] + "..."


def _opening(kernels: list[tuple[str, float]]) -> int:
    """The number of sentinels that a trace's records start with."""
    return next((i for i, (name, _) in enumerate(kernels) if _SENTINEL_NAME not in name),
                len(kernels))


def trim_lead(kernels: list[tuple[str, float]]) -> list[tuple[str, float]]:
    """A trace's kernel records without the opening sentinels beyond the last
    ``_SENTINELS``: what :func:`traced_us` reads of a trace opened by
    ``_LEAD + _SENTINELS`` sentinels."""
    return kernels[max(0, _opening(kernels) - _SENTINELS):]


def head_lost(kernels: list[tuple[str, float]]) -> int:
    """How many of the ``_LEAD + _SENTINELS`` opening sentinels an untrimmed
    trace lost (all of them when its first record is not a sentinel; a
    separator that opens it reads as an opening sentinel)."""
    return _LEAD + _SENTINELS - min(_opening(kernels), _LEAD + _SENTINELS)


def trace_records(fn: Callable, dev: torch.device, reps: int,
                  trim: bool = True) -> list[tuple[str, float]]:
    """One profiler trace of ``reps`` calls of ``fn`` on the card, laid out
    for :func:`traced_us`: its kernel records ``(name, µs)`` in start order.

    The card's traces lose their first records: now and then a few traces in
    a row lose hundreds (``profiler_traces --head-loss`` counts them), and in
    a process that traces long stages every trace loses a few, more as the
    traces add up.  Late in chip_smoke that passed ``_SENTINELS``, in every
    retake of a stage.  So ``_LEAD`` sentinels open the trace ahead of the
    ``_SENTINELS`` that :func:`traced_us` reads, and :func:`trim_lead` drops
    those of them that survived (all of them kept with ``trim=False``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def sentinels(n):
        sync(dev)
        for _ in range(n):
            torch.cuda._sleep(1000)
        sync(dev)

    sync(dev)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        sentinels(_LEAD + _SENTINELS)
        for i in range(reps):
            if i:
                sentinels(1)
            fn()
        sentinels(_SENTINELS)
    kernels = sorted((ev for ev in prof.events() if ev.device_type == DeviceType.CUDA),
                     key=lambda ev: ev.time_range.start)
    records = [(ev.name, ev.device_time_total) for ev in kernels]
    return trim_lead(records) if trim else records


def device_us_per_call(fn: Callable, dev: torch.device, reps: int = 5,
                       launches: int = 1) -> float | None:
    """Mean device time (µs) of the work one call of ``fn`` puts on the card;
    ``None`` on the CPU.  ``launches`` is the least number of kernels one call
    launches (0 for a stage that may run on the host alone)."""
    if dev.type != "cuda":
        return None
    # Late in a long process the H100's traces lose their first kernel
    # records (unguarded, K3 read 4/5 of its time over 5 calls; guarded only
    # by sentinel ends, K2 once read 0 µs: the opening sentinels and all five
    # calls were lost).  So sentinel kernels (torch.cuda._sleep's
    # spin_kernel) open and close each trace and stand between the calls, the
    # opening ones ``_LEAD`` more than are read (:func:`trace_records`), and
    # :func:`traced_us` holds the trace to that layout.  It is taken again, up
    # to ``_ATTEMPTS`` times in all, and said, when it does not; then
    # :class:`LostTrace` is raised.
    for attempt in range(_ATTEMPTS):
        records = trace_records(fn, dev, reps)
        us = traced_us(records, reps, launches)
        if us is not None:
            return us
        print(f"profiler trace {attempt + 1} lost kernel records ({trace_layout(records)}); "
              f"profiling again", flush=True)
    raise LostTrace(f"the profiler lost kernel records in {_ATTEMPTS} traces on the card")


def named_us(kernels: list[tuple[str, float]], reps: int, launches: int,
             kernel: str) -> float | None:
    """Mean µs per call of the records whose name holds ``kernel`` in a
    trace laid out for :func:`traced_us` (``None`` where :func:`traced_us`
    rejects the trace, or the calls did not leave one such record each)."""
    if traced_us(kernels, reps, launches) is None:
        return None
    times = [us for name, us in kernels if kernel in name]
    return sum(times) / reps if len(times) == reps else None


def cold_kernel_us(fn: Callable, dev: torch.device, kernel: str, reps: int = 5
                   ) -> float | None:
    """Device µs of the kernel named ``kernel`` in one call of ``fn`` with
    the card's L2 cache cold: before each call a fill of four times the L2's
    size evicts what the call before left there, and the trace reads the
    kernel's records alone (:func:`named_us`).  The fill leaves L2 full of
    dirty lines, which the kernel's misses write back, so the reading errs
    slow.  ``None`` on the CPU."""
    if dev.type != "cuda":
        return None
    l2 = getattr(torch.cuda.get_device_properties(dev), "L2_cache_size", 0) or 50 * 2**20
    flush = torch.empty(l2, dtype=torch.float32, device=dev)  # 4 bytes an element

    def call():
        flush.fill_(0.0)
        fn()

    for attempt in range(_ATTEMPTS):
        records = trace_records(call, dev, reps)
        us = named_us(records, reps, 2, kernel)
        if us is not None:
            return us
        print(f"profiler trace {attempt + 1} lost kernel records ({trace_layout(records)}); "
              f"profiling again", flush=True)
    raise LostTrace(f"the profiler lost kernel records in {_ATTEMPTS} traces on the card")


def fmt(x: float | None, spec: str = ".3f") -> str:
    return "not measured" if x is None else format(x, spec)


def kernel_row(name: str, fn: Callable, work: Work, dev: torch.device, card: str,
               reps: int = 20) -> dict:
    """One call's ms, device µs, work, bound and share of the bound; printed."""
    ms = ms_per_call(fn, dev, reps)
    us = device_us_per_call(fn, dev)
    bound = work.bound_us()
    row = {"name": name, "ms": ms, "device_us": us, "bytes": work.bytes, "ops": work.ops,
           "bound_us": bound, "bound_by": work.bound_by(),
           "share_of_bound": None if us is None else bound / us}
    print(f"{name:44s} {ms:9.4f} ms/call, device {fmt(us, '.1f')} us, "
          f"{work.bytes / 1e6:.3f} MB, {work.ops / 1e6:.1f} Mop, bound {bound:.3f} us "
          f"({row['bound_by']}), share {fmt(row['share_of_bound'], '.3f')} [{card}]",
          flush=True)
    return row


def stage_row(name: str, fn: Callable, dev: torch.device, card: str, reps: int = 5,
              launches: int = 0) -> dict:
    """One synchronized stage: ms per call and the device ms it keeps busy
    (not measured, and said so, when the profiler loses its traces: a
    stage's row is a breakdown, not a check).  ``launches`` is the least
    number of kernels one call launches: a stage that runs on the card passes
    1, so that a trace which lost its calls' records is not read as 0 ms."""
    ms = ms_per_call(fn, dev, reps, warmup=1)
    try:
        us = device_us_per_call(fn, dev, reps=max(1, reps // 2), launches=launches)
    except LostTrace as e:
        print(f"{name}: device time not measured ({e})", flush=True)
        us = None
    dev_ms = None if us is None else us / 1e3
    row = {"name": name, "ms": ms, "device_ms": dev_ms,
           "busy_share": None if dev_ms is None else dev_ms / ms}
    print(f"{name:44s} {ms:9.3f} ms, device {fmt(dev_ms)} ms, busy share "
          f"{fmt(row['busy_share'])} [{card}]", flush=True)
    return row

