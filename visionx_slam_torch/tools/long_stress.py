"""Long-sequence stress of the online scan (counterpart of
``tools/long_stress.py``).

Tiles the 240-frame bench loop (it is exactly periodic, so the tiles are
one continuous motion) to ``--frames`` frames ON THE DEVICE, runs the scan
over all of them with ``TrackingOptions()`` (the keyframe ring evicts and
the landmark table compacts throughout; culling is off), and reports
tracking, ATE, the landmark allocator's state and fps. The gate: at least
99% of frames tracked and no landmark dropped for lack of capacity.

With ``--resume-split S`` the same frames run again as two calls: a fresh
run of ``[0, S)`` whose final ``ScanState`` is carried as ``st0`` (with
``frame0=S``) into a run of ``[S, T)``; the largest pose entry difference
from the single run must be under 1e-4. Keep S on a multiple of the
8-frame extraction chunk on the card, so both calls build the single run's
atlas batches.

Beyond the JAX tool's report: the device's peak memory, K1's launches and
the device reads per frame (the scan's ``stats=`` counters).

Run from the repository root::

    python3 -m visionx_slam_torch.tools.long_stress [--frames 2160]
        [--resume-split 1200] [--device cuda|cpu] [--json]

It exits 0 only if the gate passes and the split is within its bound. It
raises where there is no card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from ..bench import require_device, sync, timed
from ..data import synthetic
from ..eval.trajectory import ate_of_run
from ..ops import detect
from ..ops.camera import make_camera
from ..tracking import mapstate as msl
from ..tracking.scan_pipeline import run_scan_pipeline
from ..utils.config import TrackingOptions

LOOP_FRAMES = 240        # the bench loop
MIN_TRACKED_SHARE = 0.99
SPLIT_BOUND = 1e-4       # the JAX tool's bound on the split's pose difference


def _scan(cam, g, d, opts, dev, kw, **more):
    """(seconds, final state, outputs, stats, K1 launches) of one scan call."""
    stats: dict = {}
    k0 = detect.launches
    wall, (st, out) = timed(lambda: run_scan_pipeline(
        cam, g, d, opts, device=dev, stats=stats, **kw, **more), dev)
    return wall, st, out, stats, detect.launches - k0


def stress(cam, grays, depths, gt_t, reps: int, split: int, opts, device,
           kf_capacity: int = 64, lm_capacity: int = 1 << 17) -> dict:
    """The scan over ``grays``/``depths`` (numpy [T0,H,W]) tiled ``reps``
    times on the device, then (``split`` > 0) the same frames as two calls
    split at frame ``split``. Returns the report; ``ok`` is the gate (and the
    split's bound)."""
    dev = require_device(device)
    kw = dict(kf_capacity=kf_capacity, lm_capacity=lm_capacity)
    if dev.type == "cuda":
        sync(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    g = torch.as_tensor(grays).to(dev).repeat(reps, 1, 1)
    d = torch.as_tensor(depths).to(dev, torch.float32).repeat(reps, 1, 1)
    gt = np.tile(gt_t, (reps, 1))
    T = len(gt)
    wall, st, out, stats, k1 = _scan(cam, g, d, opts, dev, kw)
    tracked = out.tracked.cpu().numpy()
    poses = out.pose.cpu().numpy()
    nl = out.n_landmarks.cpu().numpy()
    ate, n_tracked = ate_of_run(poses, tracked, gt)
    ms = st.ms
    res = {
        "frames": T, "tracked": n_tracked, "tracked_share": n_tracked / T,
        "ate_m": ate, "seconds": wall, "fps": T / wall,
        "keyframe_events": int(out.is_keyframe.sum()),
        "keyframes_final": int(out.n_keyframes[-1]),
        "landmarks_final": int(nl[-1]), "landmarks_peak": int(nl.max()),
        "lm_capacity": lm_capacity,
        "map_keyframes": int(msl.n_keyframes(ms)),
        "map_landmarks": int(msl.n_landmarks(ms)),
        "lm_dropped": int(ms.lm_dropped),
        "compactions": stats["compactions"],
        "host_syncs_per_frame": stats["host_syncs"] / T,
        "k1_launches": k1,
    }
    res["ok"] = (n_tracked >= MIN_TRACKED_SHARE * T and res["lm_dropped"] == 0)
    del st, out, ms
    if split:
        # a fresh state: the scan updates st0's map in place
        w1, st1, o1, s1, k1a = _scan(cam, g[:split], d[:split], opts, dev, kw)
        p1 = o1.pose.cpu().numpy()
        del o1
        w2, st2, o2, s2, k1b = _scan(cam, g[split:], d[split:], opts, dev, kw,
                                     st0=st1, frame0=split)
        diff = np.abs(np.concatenate([p1, o2.pose.cpu().numpy()]) - poses)
        res["split"] = {
            "at": split, "max_pose_diff": float(diff.max()),
            "bit_equal": bool((diff == 0).all()), "bound": SPLIT_BOUND,
            "seconds": w1 + w2, "k1_launches": [k1a, k1b],
            "lm_dropped": int(st2.ms.lm_dropped),
            "compactions": s1["compactions"] + s2["compactions"]}
        res["ok"] = res["ok"] and res["split"]["max_pose_diff"] < SPLIT_BOUND
    if dev.type == "cuda":
        res["peak_memory_bytes"] = torch.cuda.max_memory_allocated(dev)
    return res


def summary(r: dict) -> str:
    """The JAX tool's report lines, with what the port adds."""
    ate = "n/a" if r["ate_m"] is None else f"{r['ate_m'] * 1e3:.1f}mm"
    lines = [
        f"frames={r['frames']} tracked={r['tracked']} ({r['tracked_share']:.1%}) "
        f"ate={ate} wall={r['seconds']:.1f}s ({r['fps']:.1f} fps)",
        f"keyframes(final)={r['keyframes_final']} keyframe events="
        f"{r['keyframe_events']} compactions={r['compactions']} landmarks: "
        f"final={r['landmarks_final']} peak={r['landmarks_peak']} "
        f"capacity={r['lm_capacity']}",
        f"map: n_kf={r['map_keyframes']} n_lm={r['map_landmarks']} "
        f"lm_dropped={r['lm_dropped']}",
        f"K1 launches={r['k1_launches']} device reads/frame="
        f"{r['host_syncs_per_frame']:.3f}"
        + (f" peak memory={r['peak_memory_bytes'] / 2**30:.2f} GiB"
           if "peak_memory_bytes" in r else ""),
    ]
    if "split" in r:
        s = r["split"]
        lines.append(
            f"resume split@{s['at']}: max pose delta {s['max_pose_diff']:.2e} "
            f"({'OK' if s['max_pose_diff'] < s['bound'] else 'MISMATCH'}"
            f"{', bit-equal' if s['bit_equal'] else ''}), K1 launches "
            f"{s['k1_launches'][0]} + {s['k1_launches'][1]}")
    lines.append("STRESS " + ("PASS" if r["ok"] else "FAIL"))
    return "\n".join(lines)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--frames", type=int, default=2160)
    p.add_argument("--resume-split", type=int, default=0)
    p.add_argument("--device", default="cuda")
    p.add_argument("--json", action="store_true",
                   help="also print the report as one JSON line")
    args = p.parse_args(argv)
    dev = require_device(args.device)
    grays, depths, gt_t = synthetic.make_sequence(LOOP_FRAMES, seed=5)
    cam = make_camera(synthetic.FX, synthetic.FY, synthetic.CX, synthetic.CY)
    reps = -(-args.frames // LOOP_FRAMES)
    r = stress(cam, grays, depths, gt_t, reps, args.resume_split,
               TrackingOptions(), dev)
    print(summary(r), flush=True)
    if args.json:
        print(json.dumps(r))
    return 0 if r["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
