"""Smoke run of the PyTorch port on one NVIDIA GPU: builds kernel K1 from the
repo's sources, holds K1 and its score-only wrapper K1b against their plain
PyTorch versions and the pyramid atlas built on the card against the one
built on the CPU, then drives the port's two main paths over a 240-frame
640x480 synthetic sequence (bench input: scene seed 5) and checks their
accuracy: the RGB-D offline pipeline, and the online scan (per-frame
tracking, keyframes, local BA) as one run, streamed in 8-frame chunks, with
a depth hole (the left 200 columns: triangulated landmarks, so local BA
iterates), and over the sequence tiled five times (1200 frames: the keyframe
ring wraps and the landmark table is compacted at full capacity).

Run from the repository root: ``python3 chip_smoke.py [--frames N]``.
It exits non-zero (and prints no result) without a CUDA device or when any
phase fails. The last line of stdout is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``;
the line before it is the card's name and power limit, and before that a
JSON line of per-kernel results.
"""

from __future__ import annotations

import argparse
import collections
import json
import subprocess
import sys
import time


def _run(cmd: list[str]) -> str:
    try:
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"unavailable ({e})"
    return (res.stdout or res.stderr).strip()


def _card() -> str:
    return _run(["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"]).splitlines()[0]


def _require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def _time_ms(fn, reps: int = 20) -> float:
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def check_atlas(grays_u8) -> None:
    """The default (bf16) pyramid atlas built on the card equals the CPU
    build bit for bit (its float64 sums are exact in any order)."""
    import torch

    from visionx_slam_torch.models.orb_torch import build_atlas

    g = torch.as_tensor(grays_u8)
    a_cpu, m_cpu = build_atlas(g)
    a_gpu, m_gpu = build_atlas(g.cuda())
    a_gpu, m_gpu = a_gpu.cpu(), m_gpu.cpu()
    n_diff = int((a_gpu.view(torch.int16) != a_cpu.view(torch.int16)).sum())
    print(f"atlas {tuple(a_gpu.shape)} CUDA vs CPU: {n_diff} pixels differ",
          flush=True)
    _require(n_diff == 0 and torch.equal(m_gpu, m_cpu),
             "the CUDA atlas equals the CPU atlas bit for bit")


def check_k1(grays_u8) -> dict:
    """K1 against its plain version on rendered atlases and one ragged
    random shape; returns the kernel's result record."""
    import torch

    from visionx_slam_torch.models.orb_torch import build_atlas
    from visionx_slam_torch.ops import detect

    atlas, mask = build_atlas(torch.as_tensor(grays_u8).cuda())
    g = torch.Generator(device="cuda").manual_seed(0)
    ragged = (torch.rand((3, 77, 131), generator=g, device="cuda") * 255).to(
        torch.bfloat16)
    rmask = torch.zeros((77, 131), dtype=torch.int8, device="cuda")
    rmask[8:-8, 8:-8] = 1
    max_err = 0.0
    for img, m in [(atlas, mask), (ragged, rmask)]:
        s_k, b_k = detect.fast_harris_blur(img, m)
        s_p, b_p = detect.fast_harris_blur_reference(img, m)
        torch.cuda.synchronize()
        c_k, c_p = s_k > 0.5 * detect.NEG, s_p > 0.5 * detect.NEG
        inside = m.bool().expand_as(c_k)
        agree = (c_k == c_p)[inside].float().mean().item()
        _require(agree > 0.99, f"K1 corner-mask agreement {agree:.4f}")
        both = c_k & c_p
        torch.testing.assert_close(s_k[both], s_p[both], rtol=2e-2, atol=20.0)
        torch.testing.assert_close(b_k.float(), b_p.float(), rtol=2e-2, atol=2.0)
        max_err = max(max_err, (s_k[both] - s_p[both]).abs().max().item()
                      if both.any() else 0.0,
                      (b_k.float() - b_p.float()).abs().max().item())
        print(f"K1 vs plain {tuple(img.shape)}: corner agreement {agree:.6f}, "
              f"corners {int(c_k.sum())} vs {int(c_p.sum())}", flush=True)
    ms_k = _time_ms(lambda: detect.fast_harris_blur(atlas, mask))
    ms_p = _time_ms(lambda: detect.fast_harris_blur_reference(atlas, mask))
    print(f"K1 {tuple(atlas.shape)}: {ms_k:.4f} ms, plain {ms_p:.4f} ms "
          f"({_card()})", flush=True)
    return {"name": "fast_harris_blur", "route": "cuda",
            "source": "visionx_slam_torch/csrc/fast_harris_blur.cu",
            "replaces": "visionx_slam_tpu/ops/pallas_detect.py:167",
            "launches": 0, "max_abs_err": max_err, "ms": ms_k,
            "plain_ms": ms_p}


def check_k1b(grays_u8) -> dict:
    """K1b against its plain version on the float32 atlas of rendered frames
    and a ragged random batch, with K1's tolerances."""
    import torch

    from visionx_slam_torch.models.orb_torch import build_atlas
    from visionx_slam_torch.ops import detect

    atlas = build_atlas(torch.as_tensor(grays_u8).cuda())[0].float()
    g = torch.Generator(device="cuda").manual_seed(1)
    ragged = torch.rand((3, 77, 131), generator=g, device="cuda") * 255
    max_err = 0.0
    for img in (atlas, ragged, ragged[0]):
        s_k = detect.fast_harris_score(img)
        s_p = detect.fast_harris_score_reference(img)
        torch.cuda.synchronize()
        c_k, c_p = s_k > 0.5 * detect.NEG, s_p > 0.5 * detect.NEG
        agree = (c_k == c_p).float().mean().item()
        _require(agree > 0.99, f"K1b corner-mask agreement {agree:.4f}")
        both = c_k & c_p
        torch.testing.assert_close(s_k[both], s_p[both], rtol=2e-2, atol=20.0)
        if both.any():
            max_err = max(max_err, (s_k[both] - s_p[both]).abs().max().item())
        print(f"K1b vs plain {tuple(img.shape)}: corner agreement {agree:.6f}, "
              f"corners {int(c_k.sum())} vs {int(c_p.sum())}", flush=True)
    ms_k = _time_ms(lambda: detect.fast_harris_score(atlas))
    ms_p = _time_ms(lambda: detect.fast_harris_score_reference(atlas))
    print(f"K1b {tuple(atlas.shape)} f32: {ms_k:.4f} ms, plain {ms_p:.4f} ms "
          f"({_card()})", flush=True)
    return {"name": "fast_harris_score", "route": "cuda",
            "source": "visionx_slam_torch/csrc/fast_harris_blur.cu",
            "replaces": "visionx_slam_tpu/ops/pallas_detect.py:213",
            "launches": 0, "max_abs_err": max_err, "ms": ms_k,
            "plain_ms": ms_p}


def run_pipeline(grays, depths, gt_t) -> dict:
    """The port's main path, a warm-up run then a counted, timed run (with
    per-stage times: the stages synchronize at their ends); returns its
    metrics."""
    import numpy as np
    import torch

    from visionx_slam_torch.data import synthetic
    from visionx_slam_torch.eval.trajectory import ate_of_run
    from visionx_slam_torch.ops import detect
    from visionx_slam_torch.ops.camera import make_camera
    from visionx_slam_torch.tracking.offline_pipeline import run_offline_pipeline
    from visionx_slam_torch.utils.config import TrackingOptions

    cam = make_camera(synthetic.FX, synthetic.FY, synthetic.CX, synthetic.CY)
    opts = TrackingOptions()
    g = torch.as_tensor(grays).cuda()
    d = torch.as_tensor(depths).cuda()
    run_offline_pipeline(cam, g, d, opts, device="cuda")

    stage_s: dict = {}
    detect.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ms, out = run_offline_pipeline(cam, g, d, opts, device="cuda", timings=stage_s)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = detect.launches

    T = len(grays)
    pose = out.pose.cpu().numpy()
    tracked = out.tracked.cpu().numpy()
    _require(pose.shape == (T, 4, 4) and bool(np.isfinite(pose).all()),
             f"poses of shape {pose.shape}, all finite")
    ate, n_tracked = ate_of_run(pose, tracked, gt_t)
    return {"frames": T, "seconds": wall, "fps": T / wall, "ate_m": ate,
            "tracked": n_tracked, "keyframes": int(out.n_keyframes),
            "landmarks": int(out.n_landmarks), "k1_launches": launches,
            "stage_seconds": stage_s}


# The JAX package's scan on the same inputs, on the CPU (TrackingOptions(),
# 1024 slots, kf_capacity 64, lm_capacity 1 << 17; PERF.md): 240 frames
# tracked 240/240 at ATE 4.4578 mm with 77 keyframe events; the sequence
# tiled five times (1200 frames) tracked 1200/1200 at ATE 16.2077 mm.
SCAN_ATE_JAX = 0.004458
SCAN_KF_JAX = 77
LONG_ATE_JAX = 0.016208
LONG_REPS = 5   # tiles of the sequence in the long scan (BASELINE config 3)
# With no depth in the left 200 columns, the JAX scan on the CPU: 240/240
# tracked at ATE 10.8675 mm, 77 keyframe events, 57,999 landmarks.
HOLE_COLS = 200
HOLE_ATE_JAX = 0.010867
HOLE_KF_JAX = 77
HOLE_LM_JAX = 57999


def _scan(cam, g, d, stats=None, st0=None, frame0=0):
    from visionx_slam_torch.tracking.scan_pipeline import run_scan_pipeline
    from visionx_slam_torch.utils.config import TrackingOptions

    return run_scan_pipeline(cam, g, d, TrackingOptions(), st0=st0,
                             frame0=frame0, device="cuda", stats=stats)


def _scan_metrics(out, gt_t) -> dict:
    import numpy as np

    from visionx_slam_torch.eval.trajectory import ate_of_run

    pose = out.pose.cpu().numpy()
    tracked = out.tracked.cpu().numpy()
    _require(pose.shape == (len(gt_t), 4, 4) and bool(np.isfinite(pose).all()),
             f"scan poses of shape {pose.shape}, all finite")
    ate, n_tracked = ate_of_run(pose, tracked, gt_t)
    return {"ate_m": ate, "tracked": n_tracked,
            "keyframe_events": int(out.is_keyframe.sum()),
            "landmarks": int(out.n_landmarks[-1])}


def run_scan(grays, depths, gt_t) -> dict:
    """The online scan: a warm-up run, a counted and timed run, an 8-frame
    streamed run for per-frame latency, and a run with CUDA's sync debug
    mode on that counts every synchronizing call of the loop."""
    import warnings

    import numpy as np
    import torch

    from visionx_slam_torch.data import synthetic
    from visionx_slam_torch.ops import detect
    from visionx_slam_torch.ops.camera import make_camera

    cam = make_camera(synthetic.FX, synthetic.FY, synthetic.CX, synthetic.CY)
    g = torch.as_tensor(grays).cuda()
    d = torch.as_tensor(depths).cuda()
    T = len(grays)
    _scan(cam, g, d)

    stats: dict = {}
    detect.launches = 0
    detect.score_launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, out = _scan(cam, g, d, stats)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    res = {"frames": T, "seconds": wall, "fps": T / wall,
           "k1_launches": detect.launches, "k1b_launches": detect.score_launches,
           **_scan_metrics(out, gt_t), **stats}
    res["host_syncs_per_frame"] = stats["host_syncs"] / T
    res["ba_iterations_per_kf_event"] = (stats["ba_iterations"]
                                         / max(stats["kf_events"], 1))

    # streamed in 8-frame chunks, the state threaded through
    lat, st = [], None
    for s in range(0, T, 8):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        st, o = _scan(cam, g[s:s + 8], d[s:s + 8], st0=st, frame0=s)
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t1) / len(o.tracked) * 1e3)
    res["latency_ms_p50"] = float(np.percentile(lat, 50))
    res["latency_ms_p99"] = float(np.percentile(lat, 99))

    # every synchronizing CUDA call of one run, not only the step's reads
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            _scan(cam, g, d)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    res["cuda_syncs_per_frame"] = len(caught) / T
    sites = collections.Counter(f"{w.filename.split('visionx_slam_torch/')[-1]}:"
                                f"{w.lineno}" for w in caught)
    res["cuda_sync_sites"] = dict(sites.most_common(8))
    return res


def run_hole_scan(grays, depths, gt_t) -> dict:
    """The scan with no depth in the left ``HOLE_COLS`` columns: features
    there get landmarks only by triangulation between keyframes, observed
    twice, so local BA has work."""
    import torch

    from visionx_slam_torch.data import synthetic
    from visionx_slam_torch.ops import detect
    from visionx_slam_torch.ops.camera import make_camera

    cam = make_camera(synthetic.FX, synthetic.FY, synthetic.CX, synthetic.CY)
    d = torch.as_tensor(depths).cuda()
    d[:, :, :HOLE_COLS] = 0.0
    stats: dict = {}
    detect.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, out = _scan(cam, torch.as_tensor(grays).cuda(), d, stats)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    res = {"frames": len(grays), "seconds": wall, "fps": len(grays) / wall,
           "k1_launches": detect.launches, **_scan_metrics(out, gt_t), **stats}
    res["ba_iterations_per_kf_event"] = (stats["ba_iterations"]
                                         / max(stats["kf_events"], 1))
    return res


def run_long_scan(grays, depths, gt_t, reps: int) -> dict:
    """The scan over the sequence tiled ``reps`` times."""
    import numpy as np
    import torch

    from visionx_slam_torch.data import synthetic
    from visionx_slam_torch.ops.camera import make_camera

    cam = make_camera(synthetic.FX, synthetic.FY, synthetic.CX, synthetic.CY)
    g = torch.as_tensor(np.tile(grays, (reps, 1, 1))).cuda()
    d = torch.as_tensor(np.tile(depths, (reps, 1, 1))).cuda()
    gt = np.tile(gt_t, (reps, 1))
    stats: dict = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, out = _scan(cam, g, d, stats)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return {"frames": len(gt), "seconds": wall, "fps": len(gt) / wall,
            **_scan_metrics(out, gt), **stats}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=240)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2

    # ---- 1. environment ----
    card = _card()
    print(f"card: {card}", flush=True)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}", flush=True)
    print("nvcc: " + _run(["nvcc", "--version"]).splitlines()[-1], flush=True)

    from visionx_slam_torch.data import synthetic
    from visionx_slam_torch.ops import detect

    # ---- 2. build K1 from the checkout ----
    t0 = time.perf_counter()
    detect.build_kernel()
    print(f"K1 built in {time.perf_counter() - t0:.2f} s", flush=True)

    # ---- 3. K1 and K1b against their plain versions ----
    t0 = time.perf_counter()
    grays, depths, gt_t = synthetic.make_sequence(args.frames, seed=5)
    print(f"rendered {args.frames} frames in {time.perf_counter() - t0:.1f} s",
          flush=True)
    check_atlas(grays[:8])
    k1 = check_k1(grays[:8])
    k1b = check_k1b(grays[:8])

    # ---- 4. the offline pipeline ----
    res = run_pipeline(grays, depths, gt_t)
    print("pipeline " + json.dumps(res) + f" ({card})", flush=True)
    T = res["frames"]
    _require(res["k1_launches"] > 0, "the pipeline launched K1")
    _require(res["tracked"] >= int(0.95 * T), f"tracked {res['tracked']}/{T}")
    _require(res["ate_m"] is not None and res["ate_m"] <= 0.011,
             f"ATE {res['ate_m']} m <= 0.011 m")
    if T == 240:  # the JAX reference makes 80 keyframes on this input
        _require(68 <= res["keyframes"] <= 92, f"keyframes {res['keyframes']}")

    # ---- 5. the online scan (this slice's main path) ----
    scan = run_scan(grays, depths, gt_t)
    print("scan " + json.dumps(scan) + f" ({card})", flush=True)
    _require(scan["k1_launches"] > 0, "the scan launched K1")
    _require(scan["tracked"] >= int(0.95 * T), f"scan tracked {scan['tracked']}/{T}")
    if T == 240:
        _require(scan["ate_m"] is not None and scan["ate_m"] <= 2 * SCAN_ATE_JAX,
                 f"scan ATE {scan['ate_m']} m <= {2 * SCAN_ATE_JAX} m")
        lo, hi = 0.85 * SCAN_KF_JAX, 1.15 * SCAN_KF_JAX
        _require(lo <= scan["keyframe_events"] <= hi,
                 f"scan keyframe events {scan['keyframe_events']} in [{lo}, {hi}]")
    print(f"scan: {scan['fps']:.1f} fps, {scan['host_syncs_per_frame']:.3f} "
          f"host reads/frame ({scan['cuda_syncs_per_frame']:.3f} CUDA syncs/frame), "
          f"{scan['ba_iterations_per_kf_event']:.3f} local BA iterations per "
          f"keyframe event, 8-frame streaming latency p50 "
          f"{scan['latency_ms_p50']:.3f} ms p99 {scan['latency_ms_p99']:.3f} ms "
          f"per frame ({card})", flush=True)

    # ---- 6. the scan with a depth hole: triangulation and local BA ----
    hole = run_hole_scan(grays, depths, gt_t)
    print("hole scan " + json.dumps(hole) + f" ({card})", flush=True)
    _require(hole["k1_launches"] > 0, "the hole scan launched K1")
    _require(hole["tracked"] >= int(0.95 * T), f"hole tracked {hole['tracked']}/{T}")
    _require(hole["ba_iterations"] > 0, "local BA iterated")
    if T == 240:
        _require(hole["ate_m"] is not None and hole["ate_m"] <= 2 * HOLE_ATE_JAX,
                 f"hole ATE {hole['ate_m']} m <= {2 * HOLE_ATE_JAX} m")
        lo, hi = 0.85 * HOLE_KF_JAX, 1.15 * HOLE_KF_JAX
        _require(lo <= hole["keyframe_events"] <= hi,
                 f"hole keyframe events {hole['keyframe_events']} in [{lo}, {hi}]")
        lo, hi = 0.9 * HOLE_LM_JAX, 1.1 * HOLE_LM_JAX
        _require(lo <= hole["landmarks"] <= hi,
                 f"hole landmarks {hole['landmarks']} in [{lo}, {hi}]")

    # ---- 7. the long scan: ring wrap and compaction ----
    long = run_long_scan(grays, depths, gt_t, LONG_REPS)
    print("long scan " + json.dumps(long) + f" ({card})", flush=True)
    TL = long["frames"]
    _require(long["tracked"] >= int(0.95 * TL), f"long tracked {long['tracked']}/{TL}")
    _require(long["keyframe_events"] > 64, "the keyframe ring wrapped")
    _require(long["compactions"] >= 1, "landmark compaction ran")
    _require(long["ate_m"] is not None and long["ate_m"] <= 2 * LONG_ATE_JAX,
             f"long ATE {long['ate_m']} m <= {2 * LONG_ATE_JAX} m")
    k1["launches"] = scan["k1_launches"]
    k1b["launches"] = scan["k1b_launches"]

    # ---- 8. result ----
    print(json.dumps({"kernels": [k1, k1b]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
