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

import statistics
import subprocess
import time
from typing import Callable

import torch

from datmo_using_optical_flow_tpu_torch.diagnostics.roofline import Work

_SENTINELS = 8  # kernels that close each trace (device_us_per_call)
_SENTINEL_NAME = "spin_kernel"


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


def device_us_per_call(fn: Callable, dev: torch.device, reps: int = 5) -> float | None:
    """Mean device time (µs) of the work one call of ``fn`` puts on the card;
    ``None`` on the CPU."""
    if dev.type != "cuda":
        return None
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    # Late in a long process the H100's traces lost their first kernel
    # records (unguarded, K3 read 4/5 of its time over 5 calls).  So sentinel
    # kernels (torch.cuda._sleep's spin_kernel) open and close each trace; it
    # counts only when its first and last records are sentinels, and they are
    # left out of the sum.  It is taken again, up to three times, and said,
    # when it does not.
    def sentinels():
        sync(dev)
        for _ in range(_SENTINELS):
            torch.cuda._sleep(1000)
        sync(dev)

    for attempt in range(3):
        sync(dev)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            sentinels()
            for _ in range(reps):
                fn()
            sentinels()
        kernels = sorted((ev for ev in prof.events() if ev.device_type == DeviceType.CUDA),
                         key=lambda ev: ev.time_range.start)
        if kernels and all(_SENTINEL_NAME in ev.name for ev in (kernels[0], kernels[-1])):
            return sum(ev.device_time_total for ev in kernels
                       if _SENTINEL_NAME not in ev.name) / reps
        print(f"profiler trace {attempt + 1} lost a sentinel end; profiling again", flush=True)
    raise RuntimeError("the profiler lost a sentinel end of 3 traces on the card")


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


def stage_row(name: str, fn: Callable, dev: torch.device, card: str, reps: int = 5) -> dict:
    """One synchronized stage: ms per call and the device ms it keeps busy."""
    ms = ms_per_call(fn, dev, reps, warmup=1)
    us = device_us_per_call(fn, dev, reps=max(1, reps // 2))
    dev_ms = None if us is None else us / 1e3
    row = {"name": name, "ms": ms, "device_ms": dev_ms,
           "busy_share": None if dev_ms is None else dev_ms / ms}
    print(f"{name:44s} {ms:9.3f} ms, device {fmt(dev_ms)} ms, busy share "
          f"{fmt(row['busy_share'])} [{card}]", flush=True)
    return row

