"""Real-data readiness harness (counterpart of ``tools/real_data_check.py``).

Two modes:

1. ``--dataset_dir D --sequence S``: ``System`` with the native loader on a
   TUM RGB-D directory (rgb.txt, depth.txt, groundtruth.txt and the
   freiburgN intrinsics, ``data/tum.py``); prints tracked frames, ATE,
   RPE, keyframes, landmarks and the loader that ran (the native one falls
   back to the Python loader, with a warning, where libpng is missing).
2. without ``--dataset_dir``: the sensor-degradation matrix. The online
   scan runs on the first ``--frames`` frames of the bench sequence clean,
   then degraded by each model of ``data/degrade.py::DEGRADATIONS`` (TUM
   depth quantization, blob depth holes, range noise, exposure jitter,
   motion blur), then by all of them combined, each row with the generator
   ``np.random.default_rng(7)``. Prints a markdown table, then one JSON
   line per run, and exits non-zero if a row leaves the band: tracked >=
   0.90 and ATE <= max(3 x clean, 20 mm), the clean row exempt from the
   ATE test.

Run from the repository root::

    python3 -m visionx_slam_torch.tools.real_data_check [--frames 120]
        [--device cuda|cpu]
    python3 -m visionx_slam_torch.tools.real_data_check --dataset_dir D
        --sequence S [--pipeline scan|offline|host] [--output_dir O]

Both modes raise where there is no card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import tempfile

import numpy as np

from ..bench import require_device, timed
from ..data import degrade, synthetic
from ..eval.trajectory import ate_of_run
from ..ops import detect
from ..ops.camera import make_camera
from ..system.system import System
from ..tracking.scan_pipeline import run_scan_pipeline
from ..utils.config import SystemConfig, TrackingOptions

MIN_TRACKED = 0.90       # the band's tracked share
ATE_FLOOR_M = 0.020      # the band's ATE: max(3 x clean, 20 mm)


def run_real(dataset_dir: str, sequence: str, output_dir: str,
             pipeline: str = "scan", frames: int = 120, device="cuda") -> dict:
    """``System(...).run()`` with the native loader over a TUM directory;
    the summary, with the loader that ran."""
    cfg = SystemConfig(dataset_dir=dataset_dir, sequence=sequence,
                       output_dir=output_dir, pipeline=pipeline,
                       max_frames=frames if frames > 0 else -1,
                       loader="native", device=str(require_device(device)))
    system = System(cfg)
    summary = system.run()
    summary["loader"] = system.loader_used
    return summary


def degraded_inputs(grays, depths):
    """(name, grays, depths) of the matrix's rows, in the JAX tool's order."""
    yield "clean", grays, depths
    for name, fn in degrade.DEGRADATIONS.items():
        yield (name, *fn(grays, depths, np.random.default_rng(7)))
    yield ("all_combined",
           *degrade.degrade_all(grays, depths, np.random.default_rng(7)))


def scan_row(cam, name: str, grays, depths, gt_t, opts, device) -> dict:
    """One row of the matrix: the scan over ``grays``/``depths``; its rigid
    ATE (NaN under 3 tracked frames), tracked count and share, fps, K1
    launches and device reads per frame."""
    dev = require_device(device)
    stats: dict = {}
    k0 = detect.launches
    wall, (_, out) = timed(lambda: run_scan_pipeline(
        cam, grays, depths, opts, device=dev, stats=stats), dev)
    tracked = out.tracked.cpu().numpy()
    ate, n = ate_of_run(out.pose.cpu().numpy(), tracked, gt_t)
    T = len(tracked)
    return {"name": name, "frames": T, "tracked": n, "tracked_share": n / T,
            "ate_m": math.nan if ate is None else ate,
            "seconds": wall, "fps": T / wall,
            "k1_launches": detect.launches - k0,
            "host_syncs_per_frame": stats["host_syncs"] / T}


def degradation_matrix(cam, grays, depths, gt_t, opts, device) -> list[dict]:
    """``scan_row`` of every row of ``degraded_inputs``, in its order."""
    return [scan_row(cam, name, g, d, gt_t, opts, device)
            for name, g, d in degraded_inputs(grays, depths)]


def _row_ok(row: dict, band: float) -> bool:
    return (row["tracked_share"] >= MIN_TRACKED
            and (row["ate_m"] <= band or row["name"] == "clean"))


def in_band(rows: list[dict]) -> tuple[bool, float]:
    """(every row in the band, the band's ATE bound): the JAX tool's rule,
    with ``rows[0]`` the clean row."""
    band = max(3.0 * rows[0]["ate_m"], ATE_FLOOR_M)
    return all(_row_ok(r, band) for r in rows), band


def table(rows: list[dict], band: float) -> str:
    """The JAX tool's markdown table and band line."""
    lines = ["| degradation | ATE (m) | tracked | in band |", "|---|---|---|---|"]
    lines += [f"| {r['name']} | {r['ate_m']:.4f} | {r['tracked_share']:.3f} | "
              f"{'yes' if _row_ok(r, band) else 'NO'} |" for r in rows]
    lines.append(f"\nband: tracked >= {MIN_TRACKED:.2f}, ATE <= {band:.4f} m "
                 f"(max(3x clean, {ATE_FLOOR_M * 1e3:.0f} mm))")
    return "\n".join(lines)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--dataset_dir", default="")
    p.add_argument("--sequence", default="rgbd_dataset_freiburg1_desk")
    p.add_argument("--output_dir",
                   default=os.path.join(tempfile.gettempdir(), "vxs_real_out"))
    p.add_argument("--pipeline", default="scan",
                   choices=["scan", "offline", "host"])
    p.add_argument("--frames", type=int, default=120)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    require_device(args.device)
    if args.dataset_dir:
        s = run_real(args.dataset_dir, args.sequence, args.output_dir,
                     args.pipeline, args.frames, args.device)
        print(f"REAL DATA: tracked {s['n_tracked']}/{s['n_frames']}, "
              f"ATE {s.get('ate_rmse', math.nan):.4f} m, "
              f"RPE {s.get('rpe_trans_rmse', math.nan):.4f} m, "
              f"{s['n_keyframes']} keyframes, {s['n_landmarks']} landmarks, "
              f"loader {s['loader']}", flush=True)
        return 0
    grays, depths, gt_t = synthetic.make_sequence(args.frames, seed=5)
    cam = make_camera(synthetic.FX, synthetic.FY, synthetic.CX, synthetic.CY)
    rows = degradation_matrix(cam, grays, depths, gt_t, TrackingOptions(),
                              args.device)
    ok, band = in_band(rows)
    print("\n" + table(rows, band), flush=True)
    for r in rows:
        print(json.dumps(r))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
