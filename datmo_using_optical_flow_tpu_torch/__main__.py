"""CLI: ``python -m datmo_using_optical_flow_tpu_torch <command>``.

Commands:
  run-a      optical-flow DATMO over PCDs (the reference's Optical_flow/main.py)
  run-b      GMFA over PCDs (the reference's GMFA/GMFA.py), writing the track log
  simulate   CARLA capture harness (the reference's single_target_simultion.py)
  synth      write a deterministic synthetic PCD sequence

``run-a`` and ``run-b`` run on the card unless ``--device cpu`` is given.
Their input is a folder of ``.pcd`` files or a YAML config (the reference's
schema; a YAML input needs pyyaml, a folder does not).  ``run-b`` writes the
track log as ``<output name>.csv`` (``-o track_data.xlsx`` gives
``track_data.csv``), as the JAX package does without openpyxl, and with
``--plot-dir DIR`` the reference's per-frame plots as PNGs (needs
matplotlib).  ``simulate`` drives a CARLA server (``--host``, ``-p/--port``)
and needs the ``carla`` package, and ``cv2`` for the camera frames; without
``carla`` it raises ImportError.
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
    pb.add_argument("--plot-dir", default=None,
                    help="save the reference's per-frame plots here (GMFA.py:525-527; "
                         "non-blocking PNGs; needs matplotlib)")
    pb.add_argument("--device", default="cuda", help="torch device (default: cuda)")

    ps = sub.add_parser("simulate", help="CARLA capture harness")
    ps.add_argument("--host", default="127.0.0.1")
    ps.add_argument("-p", "--port", type=int, default=2000)
    ps.add_argument("--no-rendering", action="store_true")
    ps.add_argument("--filter", default="model3")
    ps.add_argument("--output", default="carla_capture")

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
            files, output_xlsx=args.output, plot_dir=args.plot_dir, progress=True)
        print(f"{len(summary['rows'])} track-log rows")
        return 0
    if args.cmd == "simulate":
        from datmo_using_optical_flow_tpu_torch.sim.carla_harness import run_simulation

        run_simulation(host=args.host, port=args.port, no_rendering=args.no_rendering,
                       vehicle_filter=args.filter, output_dir=args.output)
        return 0
    if args.cmd == "synth":
        from datmo_using_optical_flow_tpu_torch.sim.synthetic import (SyntheticScene,
                                                                      write_synthetic_sequence)

        paths = write_synthetic_sequence(SyntheticScene(seed=args.seed), args.output_dir,
                                         args.frames)
        print("\n".join(paths))
        return 0
    return 2


if __name__ == "__main__":
    sys.exit(main())
