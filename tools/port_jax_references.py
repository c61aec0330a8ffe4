"""The JAX package's accuracy at the bench shapes of BASELINE configs 5, 2b
and 2, run on the CPU: the references that ``chip_smoke.py`` holds the
PyTorch port's card runs to (its ``LANES_*_JAX``, ``MONO_OFF_*_JAX`` and
``MONO_SCAN_*_JAX`` constants).

- config 5: the 240-frame bench loop (scene seed 5) in 8 staggered
  windows of 120 frames (starts 30 k, wrapping), RGB-D, each window run as
  one lane (a folded lane equals a single run of its frames:
  tests/test_offline_pipeline.py::test_offline_batched_matches_single),
  ``kf_capacity = default_lane_kf_capacity(120)``; rigid ATE per lane;
- config 2b: the loop tiled 4 times at stride 4 (240 frames), zero depth,
  the monocular offline pipeline with bench.py's budget; scale-aligned ATE;
- config 2: 60 frames at stride 4, zero depth, the online scan with the
  monocular option set; scale-aligned ATE.

Run from the repository root:
``JAX_PLATFORMS=cpu python3 tools/port_jax_references.py [--configs 5 2b 2]``.
Prints one JSON line per config.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def _ate(pose, tracked, gt, with_scale):
    from visionx_slam_tpu.eval import trajectory as traj

    pose, tracked = np.asarray(pose), np.asarray(tracked, bool)
    if tracked.sum() < 3:
        return None
    est = np.asarray([traj.tcw_to_twc(pose[i])[:3, 3]
                      for i in np.flatnonzero(tracked)])
    return traj.ate_rmse(est, gt[tracked], with_scale=with_scale)


def config5(cam, opts, grays, depths, gts) -> dict:
    from visionx_slam_tpu.tracking.offline_pipeline import (
        default_lane_kf_capacity,
        run_offline_pipeline,
    )

    B, Tw = 8, 120
    T = len(grays)
    g2, d2, gt2 = (np.concatenate([x, x]) for x in (grays, depths, gts))
    lanes = []
    for b in range(B):
        s = (b * T) // B
        _, out = run_offline_pipeline(
            cam, g2[s:s + Tw], d2[s:s + Tw], opts,
            kf_capacity=default_lane_kf_capacity(Tw))
        tr = np.asarray(out.tracked)
        lanes.append({"start": s, "tracked": int(tr.sum()),
                      "ate_m": _ate(out.pose, tr, gt2[s:s + Tw], False),
                      "keyframes": int(out.n_keyframes),
                      "landmarks": int(out.n_landmarks)})
    return {"config": "5", "lanes": lanes}


def config2b(cam, opts, grays, gts) -> dict:
    from visionx_slam_tpu.tracking.offline_pipeline import (
        default_lane_kf_capacity,
        run_offline_pipeline,
    )

    g = np.tile(grays, (4, 1, 1))[::4]
    gt = np.tile(gts, (4, 1))[::4]
    _, out = run_offline_pipeline(
        cam, g, np.zeros(g.shape, np.float32), opts, monocular=True,
        kf_capacity=default_lane_kf_capacity(len(g)),
        mono_pair_hypotheses=64, mono_lo_starts=2, mono_sample_bias=64.0,
        mono_score_top_k=32)
    tr = np.asarray(out.tracked)
    return {"config": "2b", "frames": len(g), "tracked": int(tr.sum()),
            "ate_m_scale_aligned": _ate(out.pose, tr, gt, True),
            "keyframes": int(out.n_keyframes),
            "landmarks": int(out.n_landmarks)}


def config2(cam, opts, grays, gts) -> dict:
    from visionx_slam_tpu.tracking.scan_pipeline import run_scan_pipeline

    g = grays[::4]
    opts2 = dataclasses.replace(opts, link_tracked_landmarks=True,
                                min_init_landmarks=25)
    _, out = run_scan_pipeline(cam, g, np.zeros(g.shape, np.float32), opts2)
    tr = np.asarray(out.tracked)
    return {"config": "2", "frames": len(g), "tracked": int(tr.sum()),
            "ate_m_scale_aligned": _ate(out.pose, tr, gts[::4], True),
            "keyframe_events": int(np.asarray(out.is_keyframe).sum()),
            "landmarks": int(np.asarray(out.n_landmarks)[-1])}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--configs", nargs="+", default=["5", "2b", "2"])
    args = ap.parse_args()

    from visionx_slam_tpu.ops.camera import make_camera
    from visionx_slam_tpu.utils.config import TrackingOptions
    from visionx_slam_torch.data import synthetic

    # bit-equal to bench.py::_load_sequence(240, seed=5)
    grays, depths, gts = synthetic.make_sequence(240, seed=5)
    cam = make_camera(synthetic.FX, synthetic.FY, synthetic.CX, synthetic.CY)
    opts = TrackingOptions()
    runs = {"5": lambda: config5(cam, opts, grays, depths, gts),
            "2b": lambda: config2b(cam, opts, grays, gts),
            "2": lambda: config2(cam, opts, grays, gts)}
    for c in args.configs:
        t0 = time.perf_counter()
        res = runs[c]()
        res["cpu_seconds"] = time.perf_counter() - t0
        print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
