"""Where the time goes in the global-BA solvers and the culling scan on one
CUDA device.

Run from the repository root on a machine with an NVIDIA GPU::

    python3 -m visionx_slam_torch.tools.profile_scan_gba [--what gba culling]
        [--frames N]

``gba``: the offline ``pre`` stage's K=128 map of the bench input (240
synthetic frames, scene seed 5), then one warm solve each of ``pair_ba`` and
``global_ba`` (2 GN iterations of 12 CG steps) under ``torch.profiler``:
kernel launches per solve, kernel time, the device's busy share, and the
unprofiled wall time per solve. ``culling``: the scan over the first
``--frames`` frames with and without ``enable_culling`` under the profiler:
kernel launches per frame and busy share. Prints one JSON line per item.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from .profile_offline import _union_us


def _profiled(fn) -> dict:
    """One call of ``fn`` (already warm) timed plain, then under the
    profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall_plain = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_us = _union_us((e.time_range.start, e.time_range.end) for e in kernels)
    return {"wall_ms": wall_plain * 1e3, "profiled_wall_ms": wall * 1e3,
            "kernel_launches": len(kernels),
            "kernel_ms": sum(e.time_range.elapsed_us() for e in kernels) / 1e3,
            "device_busy_share_of_wall": busy_us / 1e6 / wall_plain,
            "device_busy_share_of_profiled_wall": busy_us / 1e6 / wall}


def profile_gba(cam, grays, depths) -> None:
    from ..models.global_ba import GlobalBAOptions, global_ba
    from ..models.pair_ba import pair_ba
    from ..tracking.offline_pipeline import build_offline_pipeline
    from ..utils.config import TrackingOptions

    run = build_offline_pipeline(TrackingOptions())
    ms, links, _ = run.pre(cam, torch.as_tensor(grays).cuda(),
                           torch.as_tensor(depths).cuda())
    opts = GlobalBAOptions(max_iterations=2, cg_iterations=12)
    for name, fn in (("pair_ba", lambda: pair_ba(ms, cam, links, opts)),
                     ("global_ba", lambda: global_ba(ms, cam, opts))):
        fn()
        print(json.dumps({"what": "gba", "solver": name, **_profiled(fn)}), flush=True)


def profile_culling(cam, grays, depths) -> None:
    from ..tracking.scan_pipeline import run_scan_pipeline
    from ..utils.config import TrackingOptions

    g, d = torch.as_tensor(grays).cuda(), torch.as_tensor(depths).cuda()
    for culling in (False, True):
        stats: dict = {}
        fn = lambda: run_scan_pipeline(cam, g, d, TrackingOptions(enable_culling=culling),
                                       device="cuda", stats=stats)
        fn()
        res = _profiled(fn)
        T = len(grays)
        print(json.dumps({"what": "culling", "enable_culling": culling, "frames": T,
                          "kernel_launches_per_frame": res["kernel_launches"] / T,
                          "host_syncs_per_frame": stats["host_syncs"] / T,
                          "kf_events": stats["kf_events"], **res}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--what", nargs="+", default=["gba", "culling"],
                    choices=["gba", "culling"])
    ap.add_argument("--frames", type=int, default=48)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_scan_gba: no CUDA device")

    from ..data import synthetic
    from ..ops.camera import make_camera

    cam = make_camera(synthetic.FX, synthetic.FY, synthetic.CX, synthetic.CY)
    grays, depths, _ = synthetic.make_sequence(240, seed=5)
    print(json.dumps({"device": torch.cuda.get_device_name(0)}), flush=True)
    if "gba" in args.what:
        profile_gba(cam, grays, depths)
    if "culling" in args.what:
        profile_culling(cam, grays[:args.frames], depths[:args.frames])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
