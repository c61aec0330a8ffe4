"""The monocular scan (BASELINE config 2's path) over several RANSAC draws,
in the JAX package or in the PyTorch port: the frames tracked and the
scale-aligned ATE of each draw, then their median and range. Draw k seeds
every frame's RANSAC from 17 + k in place of 17 (JAX: the per-frame keys
``fold_in(PRNGKey(17 + k), frame)``; the port: the per-frame generators of
``scan_pipeline.frame_generator``), so draw 0 is each package's own run.

Input: ``--source`` frames of the bench loop (scene seed 5) at stride 4, no
depth, ``TrackingOptions(link_tracked_landmarks=True, min_init_landmarks=25)``.
The bench shape of config 2 is ``--source 240`` (60 frames) with the default
capacities; tests/test_torch_mono.py's is ``--source 96 --kf-capacity 8
--lm-capacity 16384`` (24 frames).

Run from the repository root:
``JAX_PLATFORMS=cpu python3 tools/mono_scan_draws.py --package jax [--draws 8]``
or ``python3 tools/mono_scan_draws.py --package torch --device cuda``.
Prints one JSON line per draw and one summary line. The JAX package is
imported only for ``--package jax``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

OPTS = dict(link_tracked_landmarks=True, min_init_landmarks=25)


def _jax_runner(cap: dict):
    import dataclasses

    import jax

    from visionx_slam_tpu.ops.camera import make_camera
    from visionx_slam_tpu.tracking import scan_pipeline as sp
    from visionx_slam_tpu.utils.config import TrackingOptions
    from visionx_slam_torch.data import synthetic

    cam = make_camera(synthetic.FX, synthetic.FY, synthetic.CX, synthetic.CY)
    opts = dataclasses.replace(TrackingOptions(), **OPTS)

    def run(g, k):
        base = jax.random.PRNGKey(17 + k)
        sp.frame_keys = lambda fids: jax.vmap(
            lambda fid: jax.random.split(jax.random.fold_in(base, fid)))(fids)
        sp._compiled_scan.cache_clear()      # the keys are traced constants
        _, out = sp.run_scan_pipeline(cam, g, np.zeros(g.shape, np.float32),
                                      opts, **cap)
        return np.asarray(out.pose), np.asarray(out.tracked)

    return run


def _torch_runner(cap: dict, device: str):
    import torch

    from visionx_slam_torch.data import synthetic
    from visionx_slam_torch.ops.camera import make_camera
    from visionx_slam_torch.tracking import scan_pipeline as sp
    from visionx_slam_torch.utils.config import TrackingOptions

    cam = make_camera(synthetic.FX, synthetic.FY, synthetic.CX, synthetic.CY)
    opts = TrackingOptions(**OPTS)

    def run(g, k):
        def frame_generator(frame_id, stream, dev):
            return torch.Generator(device=dev).manual_seed(
                ((17 + k) << 40) + 2 * int(frame_id) + stream)

        sp.frame_generator = frame_generator
        _, out = sp.run_scan_pipeline(cam, g, np.zeros(g.shape, np.float32),
                                      opts, device=device, **cap)
        return out.pose.cpu().numpy(), out.tracked.cpu().numpy()

    return run


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--package", choices=["jax", "torch"], required=True)
    ap.add_argument("--device", default="cpu", help="the port's device")
    ap.add_argument("--source", type=int, default=240)
    ap.add_argument("--draws", type=int, default=8)
    ap.add_argument("--kf-capacity", type=int)
    ap.add_argument("--lm-capacity", type=int)
    args = ap.parse_args()

    from visionx_slam_torch.data import synthetic
    from visionx_slam_torch.eval.trajectory import ate_of_run

    grays, _, gt = synthetic.make_sequence(args.source, seed=5)
    g, gt = grays[::4].copy(), gt[::4]
    cap = {k: v for k, v in (("kf_capacity", args.kf_capacity),
                             ("lm_capacity", args.lm_capacity)) if v}
    run = (_jax_runner(cap) if args.package == "jax"
           else _torch_runner(cap, args.device))
    ates, tracked = [], []
    for k in range(args.draws):
        t0 = time.perf_counter()
        pose, tr = run(g, k)
        ate, _ = ate_of_run(pose, tr, gt, with_scale=True)
        ates.append(float(ate))
        tracked.append(int(tr.sum()))
        print(json.dumps({"draw": k, "tracked": tracked[-1], "ate_m": ates[-1],
                          "seconds": time.perf_counter() - t0}), flush=True)
    print(json.dumps({
        "package": args.package, "device": args.device, "frames": len(g),
        **cap, "draws": args.draws, "ate_m": ates, "tracked": tracked,
        "ate_median_m": float(np.median(ates)), "ate_max_m": max(ates),
        "ate_min_m": min(ates), "tracked_min": min(tracked),
        "tracked_median": float(np.median(tracked))}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
