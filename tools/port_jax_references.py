"""The JAX package's accuracy at the bench shapes of BASELINE configs 5, 2b
and 2 and of the scan with map culling on, run on the CPU: the references
that ``chip_smoke.py`` holds the PyTorch port's card runs to (its
``LANES_*_JAX``, ``MONO_OFF_*_JAX``, ``MONO_SCAN_*_JAX`` and ``CULL_*_JAX``
constants).

- config 5: the 240-frame bench loop (scene seed 5) in 8 staggered
  windows of 120 frames (starts 30 k, wrapping), RGB-D, each window run as
  one lane (a folded lane equals a single run of its frames:
  tests/test_offline_pipeline.py::test_offline_batched_matches_single),
  ``kf_capacity = default_lane_kf_capacity(120)``; rigid ATE per lane;
- config 2b: the loop tiled 4 times at stride 4 (240 frames), zero depth,
  the monocular offline pipeline with bench.py's budget; scale-aligned ATE;
- config 2b_loop, 2b_merge: config 2b's input and budget with the
  monocular loop closure on (``mono_loop_pairs=12``; ``2b_merge`` also
  ``mono_loop_merge=True``: the landmark merge and the two-phase refine);
  chip_smoke.py's ``MONO_LOOP_*_JAX`` and ``MONO_MERGE_*_JAX``;
- config 2: 60 frames at stride 4, zero depth, the online scan with the
  monocular option set; scale-aligned ATE;
- cull: the 240-frame RGB-D scan with ``enable_culling=True`` (64-slot
  ring, 1 << 17 landmarks); rigid ATE, keyframe events, the final map's
  keyframes and landmarks, and the keyframes culling removed among those
  the ring cannot have overwritten (``culled_keyframes``). With the default
  culling options the run collapses (every one-view depth landmark is
  culled at once);
- cull_keep: the same scan with the culling options under which it stays
  healthy and removes keyframes (``CULL_KEEP``: one observation keeps a
  landmark and makes it shared, at most 8 keyframes); chip_smoke.py's
  ``CULL_KEEP_*_JAX``;
- host: the bench sequence written to a temporary TUM-layout directory,
  then the JAX package's ``System`` with ``--pipeline host`` and
  ``extractor=jax`` over its first ``--host_frames`` frames (the normal
  entry point's default path); tracked, rigid ATE, keyframe flags, and
  the final map's keyframes and landmarks;
  chip_smoke.py's ``HOST_*_JAX``;
- fleet: the multi-device module. One fused ``slam_step`` over the rendered
  fleet of ``parallel.batch.make_rendered_fleet`` (D=8 lanes, N=1024, the
  first 9 frames of the bench sequence written to disk), vmapped on one
  device as ``tests/test_multichip.py`` runs it: fleet matches and inliers,
  per lane and in total, and each lane's pose error against its
  ground-truth motion; then the tiny dry run of ``__graft_entry__.py`` on a
  world of one (the correlated fleet's step totals, the sharded offline
  pipeline's tracked, keyframes, landmarks and ATE); chip_smoke.py's
  ``FLEET_*_JAX`` and ``DRYRUN_*_JAX``.

Run from the repository root:
``JAX_PLATFORMS=cpu python3 tools/port_jax_references.py [--configs 5 2b 2b_loop 2b_merge 2 cull cull_keep host fleet]``.
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


def config2b(cam, opts, grays, gts, name="2b", **loop_kw) -> dict:
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
        mono_score_top_k=32, **loop_kw)
    tr = np.asarray(out.tracked)
    return {"config": name, "frames": len(g), "tracked": int(tr.sum()),
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


CULL_KEEP = dict(min_landmark_observations=1, kf_min_shared_observations=1,
                 max_keyframes=8)


def culled_keyframes(is_keyframe, n_keyframes, init_frame_id, kf_id,
                     kf_capacity: int) -> int:
    """Keyframes that culling removed, read from a scan's outputs (the JAX
    scan keeps no counter): of the last ``kf_capacity`` keyframes inserted
    since the last initialization (the ring cannot have overwritten these),
    how many the final map no longer holds. 0 when the run ended on a
    cleared map (a tracking reset removes everything, culled or not)."""
    is_kf = np.asarray(is_keyframe, bool)
    n_kf = np.asarray(n_keyframes)
    inits = [i for i in np.flatnonzero(is_kf)
             if n_kf[i] == 2 and (i == 0 or n_kf[i - 1] == 0)]
    if not inits or n_kf[-1] == 0:
        return 0
    inserted = [int(init_frame_id)] + [int(i) for i in np.flatnonzero(is_kf)
                                       if i >= inits[-1]]
    alive = set(int(i) for i in np.asarray(kf_id) if i >= 0)
    return sum(1 for f in inserted[-kf_capacity:] if f not in alive)


def config_cull(cam, opts, grays, depths, gts, name="cull", **cull_opts) -> dict:
    from visionx_slam_tpu.tracking.scan_pipeline import run_scan_pipeline

    st, out = run_scan_pipeline(
        cam, grays, depths,
        dataclasses.replace(opts, enable_culling=True, **cull_opts))
    tr = np.asarray(out.tracked)
    return {"config": name, "frames": len(grays), "tracked": int(tr.sum()),
            "ate_m": _ate(out.pose, tr, gts, False),
            "keyframe_events": int(np.asarray(out.is_keyframe).sum()),
            "keyframes": int(np.asarray(out.n_keyframes)[-1]),
            "landmarks": int(np.asarray(out.n_landmarks)[-1]),
            "culled_keyframes": culled_keyframes(
                out.is_keyframe, out.n_keyframes, st.init_frame_id,
                st.ms.kf_id, st.ms.kf_capacity)}


def config_host(n_frames: int) -> dict:
    import tempfile

    from visionx_slam_tpu.system.system import System
    from visionx_slam_tpu.utils.config import SystemConfig
    from visionx_slam_torch.data import synthetic

    with tempfile.TemporaryDirectory() as tmp:
        # the port's writer leaves the pixels the JAX package's would
        # (tests/test_torch_data.py)
        synthetic.generate_sequence(tmp, n_frames=240, seed=5)
        system = System(SystemConfig(
            dataset_dir=tmp, sequence="rgbd_dataset_freiburg3_synthetic",
            output_dir=os.path.join(tmp, "out"), pipeline="host",
            extractor="jax", max_frames=n_frames))
        s = system.run()
    return {"config": "host", "frames": s["n_frames"], "tracked": s["n_tracked"],
            "ate_m": s.get("ate_rmse"),
            "keyframe_flags": sum(r.is_keyframe for r in system.results),
            "keyframes": s["n_keyframes"], "landmarks": s["n_landmarks"],
            "fps_cpu": s["fps"]}


def config_fleet() -> dict:
    import tempfile

    import jax

    from visionx_slam_tpu.data import tum
    from visionx_slam_tpu.models.local_ba import BAOptions
    from visionx_slam_tpu.ops.camera import make_camera
    from visionx_slam_tpu.parallel import batch as pb
    from visionx_slam_torch.data import synthetic

    D = 8
    cam = make_camera(synthetic.FX, synthetic.FY, synthetic.CX, synthetic.CY)
    with tempfile.TemporaryDirectory() as tmp:
        # the bench sequence's first D + 1 frames: the trajectory is a
        # function of the frame index alone
        synthetic.generate_sequence(tmp, n_frames=D + 1, seed=5)
        mss, obss, fids, keys, gt_rel = pb.make_rendered_fleet(cam, tmp, D)
    kw = dict(n_hypotheses=16, ba_opts=BAOptions(max_iterations=2))
    vstep = jax.jit(jax.vmap(
        lambda ms, obs, fid, key: pb.slam_step(ms, obs, fid, cam, key, **kw)))
    _, poses, stats = vstep(mss, obss, fids, keys)
    poses = np.asarray(poses)
    r_err = [float(np.abs(poses[b, :3, :3] - T[:3, :3]).max())
             for b, T in enumerate(gt_rel)]
    t_err = [float(np.abs(poses[b, :3, 3] - T[:3, 3]).max())
             for b, T in enumerate(gt_rel)]
    res = {"config": "fleet", "lanes": D,
           "matches": np.asarray(stats["matches"]).tolist(),
           "inliers": np.asarray(stats["inliers"]).tolist(),
           "total_matches": int(np.sum(stats["matches"])),
           "total_inliers": int(np.sum(stats["inliers"])),
           "rot_err_max": r_err, "t_err_m": t_err}

    # the dry run of __graft_entry__.dryrun_multichip on a world of one
    cam_s = make_camera(100.0, 100.0, 32.0, 24.0)
    mss, obss, fids, keys, _ = pb.make_correlated_fleet(cam_s, 1, 64, seed=0)
    step = pb.batched_slam_step(pb.make_mesh(1), cam_s, **kw)
    _, _, fleet = step(mss, obss, fids, keys)
    res["dryrun_inliers"] = int(fleet["total_inliers"])
    res["dryrun_matches"] = int(fleet["total_matches"])
    Tf = 8
    seq = "rgbd_dataset_freiburg3_synthetic"
    with tempfile.TemporaryDirectory() as tmp:
        synthetic.generate_sequence(tmp, sequence=seq, n_frames=Tf, seed=11,
                                    frames_per_loop=Tf)
        ds = tum.TumDataset(tmp, seq)
        ds.load()
        g = np.stack([tum.load_rgb_gray(e.rgb_path) for e in ds.entries])[None]
        d = np.stack([tum.load_depth_m(e.depth_path) for e in ds.entries])[None]
        gts = np.stack([e.gt_t for e in ds.entries])
    from visionx_slam_tpu.utils.config import TrackingOptions

    f = pb.sharded_offline_pipeline(
        pb.make_mesh(1), cam, TrackingOptions(), kf_capacity=4,
        extract_chunk=2, pair_chunk=4, refine_iterations=1)
    _, out, fleet_o = f(g, d)
    tr = np.asarray(out.tracked)[0]
    res.update(dryrun_tracked=int(fleet_o["total_tracked"]),
               dryrun_keyframes=int(fleet_o["total_keyframes"]),
               dryrun_landmarks=int(fleet_o["total_landmarks"]),
               dryrun_ate_m=_ate(np.asarray(out.pose)[0], tr, gts, False))
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--configs", nargs="+", default=["5", "2b", "2"])
    ap.add_argument("--host_frames", type=int, default=240,
                    help="frames of the host-path run (config host)")
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
            "2b_loop": lambda: config2b(cam, opts, grays, gts, "2b_loop",
                                        mono_loop_pairs=12),
            "2b_merge": lambda: config2b(cam, opts, grays, gts, "2b_merge",
                                         mono_loop_pairs=12,
                                         mono_loop_merge=True),
            "2": lambda: config2(cam, opts, grays, gts),
            "cull": lambda: config_cull(cam, opts, grays, depths, gts),
            "host": lambda: config_host(args.host_frames),
            "fleet": config_fleet,
            "cull_keep": lambda: config_cull(cam, opts, grays, depths, gts,
                                             "cull_keep", **CULL_KEEP)}
    for c in args.configs:
        t0 = time.perf_counter()
        res = runs[c]()
        res["cpu_seconds"] = time.perf_counter() - t0
        print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
