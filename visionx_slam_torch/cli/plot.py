"""Offline trajectory/map plotter — the optional viewer replacement
(SURVEY.md L8; supersedes the reference's Pangolin window,
core/viewer/viewer.cpp:146-235) operating purely on a run's file outputs.

Usage:
    python -m visionx_slam_torch.cli.plot --run_dir output \
        [--groundtruth path/to/groundtruth.txt] [--out traj.png]

Writes a PNG (top-down x/z + height profile, landmarks underlaid when a
map snapshot exists) and, if absent, the map.ply export.
"""

from __future__ import annotations

import argparse
import os
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser("vxs-torch-plot")
    p.add_argument("--run_dir", required=True,
                   help="a System output_dir (trajectory.txt, map_snapshot.npz)")
    p.add_argument("--groundtruth", default="",
                   help="optional TUM groundtruth.txt to overlay")
    p.add_argument("--out", default="", help="output PNG (default run_dir/trajectory.png)")
    args = p.parse_args(argv)

    from ..eval import export

    traj = os.path.join(args.run_dir, "trajectory.txt")
    if not os.path.isfile(traj):
        print(f"no trajectory.txt in {args.run_dir}", file=sys.stderr)
        return 1
    snap = os.path.join(args.run_dir, "map_snapshot.npz")
    snap = snap if os.path.isfile(snap) else None

    if snap and not os.path.isfile(os.path.join(args.run_dir, "map.ply")):
        n = export.export_snapshot_ply(snap, os.path.join(args.run_dir, "map.ply"))
        print(f"wrote map.ply ({n} points)")

    out = args.out or os.path.join(args.run_dir, "trajectory.png")
    try:
        export.plot_trajectory(traj, out, gt_path=args.groundtruth or None,
                               cloud_npz=snap)
        print(f"wrote {out}")
    except ImportError:
        print("matplotlib unavailable — PLY/trajectory files remain the sinks",
              file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
