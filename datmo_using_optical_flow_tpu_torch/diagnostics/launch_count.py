"""Device records (kernels, copies, fills) per call of pipeline A's stream
step and of its ``build_pyramid``, for this checkout or another one.

    python datmo_using_optical_flow_tpu_torch/diagnostics/launch_count.py \
        [--root DIR] [--height H --width W] [--traces N] [--device cuda|cpu]

``--root`` names the checkout whose package is imported (another revision
unpacked with ``git archive <rev> | tar -x -C build/parent``, say, to count
it on the same card); it goes first on ``sys.path``, so run the script by its
path, not with ``-m``.  Only the package's long-standing API is used:
``benchmarks.stream_1080p.config``, ``models.optical_flow_datmo.PipelineA``,
``ops.farneback.build_pyramid`` and ``sim.frames.make_frames``.

After a warm-up call, each of ``--traces`` ``torch.profiler`` traces holds one
synchronised call, and its ``DeviceType.CUDA`` records are counted; the line
gives every trace's count (they agree unless the profiler lost records) and
the host ms per synchronised call.  On the CPU nothing runs on a device: the
counts are None, printed as "not measured".  Prints one JSON line with the
card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time


def _card(torch, dev) -> str:
    if dev.type != "cuda":
        return "cpu"
    out = subprocess.run(["nvidia-smi", f"--id={dev.index or 0}",
                          "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def count(fn, torch, dev, traces: int) -> dict:
    """``fn``'s host ms per synchronised call and its device records in each
    of ``traces`` one-call traces (None on the CPU)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    fn()
    sync()
    ms = []
    for _ in range(traces):
        t0 = time.perf_counter()
        fn()
        sync()
        ms.append((time.perf_counter() - t0) * 1e3)
    records = None
    if dev.type == "cuda":
        records = []
        for _ in range(traces):
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                fn()
                sync()
            records.append(sum(ev.device_type == DeviceType.CUDA for ev in prof.events()))
    return {"host_ms": sorted(ms)[len(ms) // 2], "device_records": records}


def run(h: int = 1080, w: int = 1920, device: str = "cuda", traces: int = 3) -> dict:
    """The counts for the package on ``sys.path``."""
    import numpy as np
    import torch

    from datmo_using_optical_flow_tpu_torch.benchmarks.stream_1080p import config
    from datmo_using_optical_flow_tpu_torch.models.optical_flow_datmo import PipelineA
    from datmo_using_optical_flow_tpu_torch.ops import farneback as fb
    from datmo_using_optical_flow_tpu_torch.sim.frames import make_frames

    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", 0)
    cfg = config(h, w)
    c = cfg.farneback
    pipe = PipelineA(cfg, dev, fast_warp=True)
    bev0, bev1 = (torch.as_tensor(np.asarray(f), device=dev) for f in make_frames(2, h, w))
    primed, _ = pipe.step_stream(bev0, pipe.init_stream_carry())
    rows = {
        "stream step": count(lambda: pipe.step_stream(bev1, primed), torch, dev, traces),
        "build_pyramid": count(lambda: fb.build_pyramid(
            bev1.to(torch.float32), c.pyr_scale, c.levels, c.poly_n, c.poly_sigma),
            torch, dev, traces)}
    return {"package": os.path.dirname(os.path.dirname(fb.__file__)), "card": _card(torch, dev),
            "shape": [h, w], "rows": rows}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=None, help="the checkout whose package is counted")
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--traces", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    root = os.path.abspath(args.root or os.path.join(os.path.dirname(__file__), "..", ".."))
    sys.path.insert(0, root)
    rec = run(args.height, args.width, args.device, args.traces)
    for name, row in rec["rows"].items():
        n = row["device_records"]
        print(f"{name}: {row['host_ms']:.3f} ms per call, device records per call "
              f"{'not measured' if n is None else n} [{rec['card']}]", file=sys.stderr)
    print(json.dumps(rec))


if __name__ == "__main__":
    main()
