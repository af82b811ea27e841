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

With ``--head-loss`` it takes ``--traces`` traces of the same kernel in
one process instead, untrimmed (``measure.trace_records(trim=False)``), and
gives how many opening sentinels each lost (``measure.head_lost``), how many
of them ``measure.traced_us`` accepts with the lead-in sentinels trimmed, and
how many it would accept had the same number of records been lost from a trace
opened by only ``measure._SENTINELS`` sentinels:

    python -m datmo_using_optical_flow_tpu_torch.diagnostics.profiler_traces \
        --head-loss [--traces N]

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


def head_losses(dev: torch.device, traces: int) -> dict:
    """Opening sentinels lost by each of ``traces`` traces of five small
    kernels, and the traces read with and without the lead-in sentinels."""
    x = torch.randn(1 << 20, device=dev)
    lost, read, read_unled = [], 0, 0
    for _ in range(traces):
        records = measure.trace_records(lambda: x.mul(3.0), dev, 5, trim=False)
        lost.append(measure.head_lost(records))
        read += measure.traced_us(measure.trim_lead(records), 5, 1) is not None
        # the same loss from a trace opened by _SENTINELS sentinels only
        read_unled += lost[-1] < measure._SENTINELS and measure.traced_us(
            records[measure._LEAD:], 5, 1) is not None
    return {"traces": traces, "head_lost": lost, "read": read,
            "read_without_lead": read_unled, "card": measure.card_label(dev)}


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
    ap.add_argument("--head-loss", action="store_true",
                    help="count the opening sentinels each trace loses, in one process")
    args = ap.parse_args()
    if args.head_loss:
        if not torch.cuda.is_available():
            raise RuntimeError("profiler_traces counts traces of the card: no CUDA device here")
        out = head_losses(torch.device("cuda"), args.traces)
    else:
        out = run(args.traces, args.kineto_default)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
