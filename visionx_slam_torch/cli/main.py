"""CLI runner with the reference's flag surface.

Reproduces apps/main.cpp: the same 23 flag names (main.cpp:15-47) plus the
``--config`` key=value overlay where the command line wins
(main.cpp:61-103). Deviations per the north star: the process RUNS the
sequence, writes the TUM trajectory + metrics and EXITS (the reference
never terminates, main.cpp:162-169); the Pangolin viewer flags are
accepted but map to file sinks.

The port's runner has the JAX package's flags (generated from the same
``SystemConfig`` and ``TrackingOptions`` fields) plus ``--device`` (``cuda``
by default; ``cpu`` must be asked for).

Usage:
    python -m visionx_slam_torch.cli.main --dataset_dir D --sequence S \
        [--config default.cfg] [--output_dir out] [--max_frames N] \
        [--pipeline scan|offline|host] [--device cuda|cpu] ...
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

from ..utils.config import (
    SystemConfig,
    TrackingOptions,
    apply_config_if_default,
    parse_config_file,
)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("vxs-torch-run",
                                description="VisionX-SLAM runner (PyTorch port)")
    cfg = SystemConfig()

    def add(name, default, help_=""):
        t = type(default)
        if t is bool:
            p.add_argument(f"--{name}", type=_parse_bool, default=None, help=help_)
        else:
            p.add_argument(f"--{name}", type=t, default=None, help=help_)

    for f in dataclasses.fields(SystemConfig):
        if f.name == "tracking":
            continue
        add(f.name, getattr(cfg, f.name))
    for f in dataclasses.fields(TrackingOptions):
        add(f.name, getattr(cfg.tracking, f.name))
    return p


def _parse_bool(v: str) -> bool:
    return v.strip().lower() in ("true", "1", "yes", "on")


def parse_config(argv=None) -> SystemConfig:
    args = build_parser().parse_args(argv)
    cfg = SystemConfig()
    cli_set = set()
    for key, val in vars(args).items():
        if val is None:
            continue
        cli_set.add(key)
        if hasattr(cfg.tracking, key):
            setattr(cfg.tracking, key, val)
        else:
            setattr(cfg, key, val)
    if cfg.config:
        kv = parse_config_file(cfg.config)
        apply_config_if_default(cfg, kv, cli_set)
    return cfg


def entrypoint(argv=None) -> int:
    # glog-style stderr logging (reference InitLogger, logger.cpp:5-9)
    from ..utils.logging import init_logger

    init_logger()
    cfg = parse_config(argv)
    from ..system.system import System

    system = System(cfg)
    summary = system.run()
    print(
        f"tracked {summary['n_tracked']}/{summary['n_frames']} frames, "
        f"{summary['n_keyframes']} keyframes, {summary['n_landmarks']} landmarks, "
        f"{summary['fps']:.1f} fps"
        + (f", ATE RMSE {summary['ate_rmse']:.4f} m" if "ate_rmse" in summary else "")
    )
    return 0


if __name__ == "__main__":
    sys.exit(entrypoint())
