"""Whole profiler traces on the card, before and after another process
profiles it.

Takes ``--traces`` traces of one small kernel, each laid out as
``measure.device_us_per_call`` lays them out, and counts those that
``measure.traced_us`` accepts.  Then it runs the 4-rank dry run
(``dryrun.py``, whose ranks profile the same card) in a subprocess and counts
again.  ``measure`` sets ``TEARDOWN_CUPTI=0`` when it is imported.  With
``--kineto-default`` the variable is unset before any trace, in this process
and in the dry run's, so kineto tears CUPTI down after each trace.

    python -m datmo_using_optical_flow_tpu_torch.diagnostics.profiler_traces \
        [--traces N] [--kineto-default]

Prints one JSON line with the counts and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch

from datmo_using_optical_flow_tpu_torch.diagnostics import measure


def whole_traces(dev: torch.device, traces: int) -> int:
    """How many of ``traces`` traces of five small kernels come back whole."""
    x = torch.randn(1 << 20, device=dev)
    whole = 0
    for _ in range(traces):
        for _ in range(20):  # work outside the trace, as between two measurements
            x.mul(2.0)
        measure.sync(dev)
        time.sleep(0.02)
        whole += measure.traced_us(measure.trace_records(lambda: x.mul(3.0), dev, 5), 5,
                                   1) is not None
    return whole


def run(traces: int = 30, kineto_default: bool = False) -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("profiler_traces counts traces of the card: no CUDA device here")
    if kineto_default:
        os.environ.pop("TEARDOWN_CUPTI", None)
    dev = torch.device("cuda")
    before = whole_traces(dev, traces)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "datmo_using_optical_flow_tpu_torch.dryrun",
                           "--ranks", "4", "--backend", "gloo", "--device", "cuda"],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"dryrun exited {proc.returncode}:\n{proc.stderr[-2000:]}")
    dry_s = time.perf_counter() - t0
    after = whole_traces(dev, traces)
    return {"traces": traces, "teardown_cupti": os.environ.get("TEARDOWN_CUPTI", "unset"),
            "whole_before": before, "whole_after_dryrun": after, "dryrun_s": dry_s,
            "card": measure.card_label(dev)}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--traces", type=int, default=30)
    ap.add_argument("--kineto-default", action="store_true",
                    help="unset TEARDOWN_CUPTI (kineto tears CUPTI down after each trace)")
    args = ap.parse_args()
    print(json.dumps(run(args.traces, args.kineto_default)), flush=True)


if __name__ == "__main__":
    main()
