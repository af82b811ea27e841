"""CLI: ``python -m datmo_using_optical_flow_tpu_torch <command>``.

Commands:
  run-a      optical-flow DATMO over PCDs (the reference's Optical_flow/main.py)
  synth      write a deterministic synthetic PCD sequence
  run-b      GMFA over PCDs (not ported yet)
  simulate   CARLA capture harness (not ported yet)

``run-a`` runs on the card unless ``--device cpu`` is given.  Its input is a
folder of ``.pcd`` files or a YAML config (the reference's schema; a YAML
input needs pyyaml, a folder does not).
"""

from __future__ import annotations

import argparse
import os
import sys


def _resolve(inp: str):
    """A PCD folder or a YAML config -> (PipelineAConfig, sorted PCD files)."""
    from datmo_using_optical_flow_tpu_torch.config import PipelineAConfig, load_config
    from datmo_using_optical_flow_tpu_torch.io.frames import pcd_files_in

    if inp.endswith((".yaml", ".yml")):
        cfg = load_config(inp)
        files = list(cfg.pcd_files)
        if not files and cfg.input_folder:
            files = pcd_files_in(cfg.input_folder)
        return cfg, sorted(files)  # plain order, as the JAX package sorts a config's list
    if not os.path.isdir(inp):
        raise FileNotFoundError(f"no such folder or YAML config: {inp}")
    return PipelineAConfig(), pcd_files_in(inp)


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

    for name in ("run-b", "simulate"):
        ps = sub.add_parser(name, help="not ported yet")
        ps.add_argument("args", nargs=argparse.REMAINDER)

    pg = sub.add_parser("synth", help="write synthetic PCD frames")
    pg.add_argument("output_dir")
    pg.add_argument("-n", "--frames", type=int, default=5)
    pg.add_argument("--seed", type=int, default=0)

    args = p.parse_args(argv)
    if args.cmd == "run-a":
        from datmo_using_optical_flow_tpu_torch.models.optical_flow_datmo import PipelineA

        cfg, files = _resolve(args.input)
        if len(files) < 2:
            print("need >= 2 PCD files")
            return 1
        summary = PipelineA(cfg, args.device).process_files(
            files, output_dir=args.output, save_png=args.png, progress=True)
        print(f"{summary['pairs']} pairs, {len(summary['tracks'])} live tracks")
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
