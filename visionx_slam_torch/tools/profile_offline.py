"""Where the offline pipeline's time goes on one CUDA device: one warm run
of a bench configuration under ``torch.profiler``, then the ops with the
most host time, the kernels with the most device time, and the device's
busy share of the run's wall time (the union of the kernels' intervals
over the wall time).

Run from the repository root on a machine with an NVIDIA GPU::

    python3 -m visionx_slam_torch.tools.profile_offline [--config 2b|5|1]
        [--top N]

Configurations (bench input: 240 synthetic frames, scene seed 5): ``1``
the RGB-D offline pipeline over the 240 frames; ``5`` 8 folded lanes of
120 frames; ``2b`` the monocular pipeline over the loop tiled four times
at stride 4, with the bench's budget. Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch


def _inputs(config: str):
    from ..data import synthetic

    grays, depths, _ = synthetic.make_sequence(240, seed=5)
    if config == "1":
        return grays, depths, {}
    if config == "5":
        g2, d2 = np.concatenate([grays, grays]), np.concatenate([depths, depths])
        starts = [30 * k for k in range(8)]
        return (np.stack([g2[s:s + 120] for s in starts]),
                np.stack([d2[s:s + 120] for s in starts]), {})
    g = np.tile(grays, (4, 1, 1))[::4].copy()
    return g, np.zeros(g.shape, np.float32), dict(
        monocular=True, kf_capacity=88, mono_pair_hypotheses=64,
        mono_lo_starts=2, mono_sample_bias=64.0, mono_score_top_k=32)


def _union_us(spans) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(spans):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", choices=["1", "5", "2b"], default="2b")
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_offline: no CUDA device")

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from ..data import synthetic
    from ..ops.camera import make_camera
    from ..tracking.offline_pipeline import (
        run_offline_pipeline,
        run_offline_pipeline_batched,
    )
    from ..utils.config import TrackingOptions

    cam = make_camera(synthetic.FX, synthetic.FY, synthetic.CX, synthetic.CY)
    g, d, kw = _inputs(args.config)
    g, d = torch.as_tensor(g).cuda(), torch.as_tensor(d).cuda()
    run = run_offline_pipeline_batched if args.config == "5" else run_offline_pipeline

    def once(timings=None):
        run(cam, g, d, TrackingOptions(), device="cuda", timings=timings, **kw)
        torch.cuda.synchronize()

    once()
    stage_s: dict = {}
    t0 = time.perf_counter()
    once(stage_s)
    wall_plain = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        once()
        wall = time.perf_counter() - t0
    # device time: the kernel events alone (an op's self device time
    # repeats its kernels'), their intervals merged into busy time
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_us = _union_us((e.time_range.start, e.time_range.end) for e in kernels)
    rows = prof.key_averages()
    top = lambda dev, key: [
        {"op": e.key, "calls": e.count, "self_cpu_ms": e.self_cpu_time_total / 1e3,
         "self_device_ms": e.self_device_time_total / 1e3}
        for e in sorted((e for e in rows if e.device_type == dev), key=key,
                        reverse=True)[:args.top]]
    print(json.dumps({
        "config": args.config, "device": torch.cuda.get_device_name(0),
        "wall_s": wall_plain, "stage_seconds": stage_s,
        "profiled_wall_s": wall, "kernel_launches": len(kernels),
        "kernel_s": sum(e.time_range.elapsed_us() for e in kernels) / 1e6,
        "device_busy_s": busy_us / 1e6, "device_busy_share": busy_us / 1e6 / wall,
        "top_host": top(DeviceType.CPU, lambda e: e.self_cpu_time_total),
        "top_kernels": top(DeviceType.CUDA, lambda e: e.self_device_time_total)}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
