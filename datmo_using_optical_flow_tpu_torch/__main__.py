"""CLI: ``python -m datmo_using_optical_flow_tpu_torch <command>``.

Commands:
  run-a      optical-flow DATMO over PCDs (the reference's Optical_flow/main.py)
  run-b      GMFA over PCDs (the reference's GMFA/GMFA.py), writing the track log
  synth      write a deterministic synthetic PCD sequence
  simulate   CARLA capture harness (not ported yet)

``run-a`` and ``run-b`` run on the card unless ``--device cpu`` is given.
Their input is a folder of ``.pcd`` files or a YAML config (the reference's
schema; a YAML input needs pyyaml, a folder does not).  ``run-b`` writes the
track log as ``<output name>.csv`` (``-o track_data.xlsx`` gives
``track_data.csv``), as the JAX package does without openpyxl.
"""

from __future__ import annotations

import argparse
import os
import sys


def _resolve(inp: str, pipeline: str):
    """A PCD folder or a YAML config -> (config of ``pipeline``, PCD files):
    a folder's files in natural order; a config's list as the JAX package
    takes it (sorted for pipeline A, as given for GMFA)."""
    from datmo_using_optical_flow_tpu_torch.config import GMFAConfig, PipelineAConfig, load_config
    from datmo_using_optical_flow_tpu_torch.io.frames import pcd_files_in

    if inp.endswith((".yaml", ".yml")):
        cfg = load_config(inp, pipeline)
        files = list(cfg.pcd_files)
        if not files and cfg.input_folder:
            files = pcd_files_in(cfg.input_folder)
        return cfg, sorted(files) if pipeline == "a" else files
    if not os.path.isdir(inp):
        raise FileNotFoundError(f"no such folder or YAML config: {inp}")
    return (PipelineAConfig() if pipeline == "a" else GMFAConfig()), pcd_files_in(inp)


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="datmo_using_optical_flow_tpu_torch",
                                description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)

    pa = sub.add_parser("run-a", help="optical-flow DATMO pipeline")
    pa.add_argument("input", help="PCD folder or YAML config")
    pa.add_argument("-o", "--output", default=None)
    pa.add_argument("--png", action="store_true", help="also render PNG artifacts")
    pa.add_argument("--device", default="cuda", help="torch device (default: cuda)")

    pb = sub.add_parser("run-b", help="GMFA pipeline")
    pb.add_argument("input", help="PCD folder or YAML config")
    pb.add_argument("-o", "--output", default="track_data.xlsx",
                    help="track log; written as <name>.csv")
    pb.add_argument("--device", default="cuda", help="torch device (default: cuda)")

    ps = sub.add_parser("simulate", help="not ported yet")
    ps.add_argument("args", nargs=argparse.REMAINDER)

    pg = sub.add_parser("synth", help="write synthetic PCD frames")
    pg.add_argument("output_dir")
    pg.add_argument("-n", "--frames", type=int, default=5)
    pg.add_argument("--seed", type=int, default=0)

    args = p.parse_args(argv)
    if args.cmd == "run-a":
        from datmo_using_optical_flow_tpu_torch.models.optical_flow_datmo import PipelineA

        cfg, files = _resolve(args.input, "a")
        if len(files) < 2:
            print("need >= 2 PCD files")
            return 1
        summary = PipelineA(cfg, args.device).process_files(
            files, output_dir=args.output, save_png=args.png, progress=True)
        print(f"{summary['pairs']} pairs, {len(summary['tracks'])} live tracks")
        return 0
    if args.cmd == "run-b":
        from datmo_using_optical_flow_tpu_torch.models.gmfa import GMFAPipeline

        cfg, files = _resolve(args.input, "b")
        if not files:
            print("No PCD files found in the folder.")
            return 1
        summary = GMFAPipeline(cfg, device=args.device).process_files(
            files, output_xlsx=args.output, progress=True)
        print(f"{len(summary['rows'])} track-log rows")
        return 0
    if args.cmd == "synth":
        from datmo_using_optical_flow_tpu_torch.sim.synthetic import (SyntheticScene,
                                                                      write_synthetic_sequence)

        paths = write_synthetic_sequence(SyntheticScene(seed=args.seed), args.output_dir,
                                         args.frames)
        print("\n".join(paths))
        return 0
    print(f"{args.cmd}: not ported to the PyTorch package yet "
          f"(use python -m datmo_using_optical_flow_tpu {args.cmd})")
    return 2


if __name__ == "__main__":
    sys.exit(main())
