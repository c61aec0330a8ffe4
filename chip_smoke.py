"""Smoke run of the PyTorch port on one NVIDIA GPU: builds kernels K1 and
K1b from the repo's source, holds them bit for bit against their plain
PyTorch versions (at the rendered 8-frame atlas and at edge shapes) and the
pyramid atlas built on the card against the one built on the CPU, then
drives the port's paths over a 240-frame 640x480 synthetic sequence (bench
input: scene seed 5) and checks their accuracy: the RGB-D offline
pipeline; the online scan (per-frame tracking, keyframes, local BA) as one
run, streamed in 8-frame chunks, with a depth hole (the left 200 columns:
triangulated landmarks, so local BA iterates), and over the sequence tiled
five times (1200 frames: the keyframe ring wraps and the landmark table is
compacted at full capacity); the offline pipeline over 8 folded lanes of
120 frames (BASELINE config 5); the monocular offline pipeline over the
sequence tiled four times at stride 4 (config 2b); and the monocular scan
over 60 frames at stride 4 (config 2).

Run from the repository root: ``python3 chip_smoke.py [--frames N]``.
It exits non-zero (and prints no result) without a CUDA device or when any
phase fails. The last line of stdout is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``;
the line before it is the card's name and power limit, and before that a
JSON line of per-kernel results (time, plain version's time, bytes, bound
and share of it, launches on the scan's main path).
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


def _kernel_record(name: str, replaces: str, n_bytes: int, n_ops: int,
                   max_err: float, ms: float, plain_ms: float) -> dict:
    """A kernel's entry of the result line. Its bound is the larger of the
    bytes it must move over the H100's 3.35 TB/s and its arithmetic over the
    67 TFLOP/s of float32 outside the tensor cores."""
    from visionx_slam_torch.tools import k1_bench

    bytes_ms = k1_bench.bound_ms(n_bytes)
    ops_ms = n_ops / k1_bench.F32_OPS_PER_S * 1e3
    bound = max(bytes_ms, ops_ms)
    return {"name": name, "route": "cuda",
            "source": "visionx_slam_torch/csrc/fast_harris_blur.cu",
            "replaces": replaces, "launches": 0, "max_abs_err": max_err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": None, "bytes": n_bytes, "bound_share": bound / ms}


def check_k1(grays_u8) -> dict:
    """K1 against its plain version, bit for bit and to the Pallas test's
    tolerances, on the rendered 8-frame atlas and the edge shapes; returns
    the kernel's result record."""
    import torch

    from visionx_slam_torch.models.orb_torch import build_atlas
    from visionx_slam_torch.ops import detect
    from visionx_slam_torch.tools import k1_bench

    atlas, mask = build_atlas(torch.as_tensor(grays_u8).cuda())
    max_err = k1_bench.check_k1(k1_bench.exact_cases(atlas, mask)[0])
    ms_k = _time_ms(lambda: detect.fast_harris_blur(atlas, mask))
    ms_p = _time_ms(lambda: detect.fast_harris_blur_reference(atlas, mask))
    print(f"K1 {tuple(atlas.shape)}: {ms_k:.4f} ms, plain {ms_p:.4f} ms "
          f"({_card()})", flush=True)
    return _kernel_record("fast_harris_blur",
                          "visionx_slam_tpu/ops/pallas_detect.py:167",
                          k1_bench.k1_bytes(atlas.shape),
                          k1_bench.k1_ops(atlas.shape), max_err, ms_k, ms_p)


def check_k1b(grays_u8) -> dict:
    """K1b against its plain version, bit for bit and to K1's tolerances,
    on the float32 atlas of rendered frames, the edge shapes and a 2-D
    image, one launch per call; returns the kernel's result record."""
    import torch

    from visionx_slam_torch.models.orb_torch import build_atlas
    from visionx_slam_torch.ops import detect
    from visionx_slam_torch.tools import k1_bench

    atlas, mask = build_atlas(torch.as_tensor(grays_u8).cuda())
    cases = k1_bench.exact_cases(atlas, mask)[1]
    max_err = k1_bench.check_k1b(cases)
    x = cases[0][1]
    ms_k = _time_ms(lambda: detect.fast_harris_score(x))
    ms_p = _time_ms(lambda: detect.fast_harris_score_reference(x))
    print(f"K1b {tuple(x.shape)} f32: {ms_k:.4f} ms, plain {ms_p:.4f} ms "
          f"({_card()})", flush=True)
    return _kernel_record("fast_harris_score",
                          "visionx_slam_tpu/ops/pallas_detect.py:213",
                          k1_bench.k1b_bytes(x.shape), k1_bench.k1b_ops(x.shape),
                          max_err, ms_k, ms_p)


def run_pipeline(grays, depths, gt_t) -> dict:
    """The port's main path, a warm-up run then a counted, timed run (with
    per-stage times: the stages synchronize at their ends); returns its
    metrics."""
    import numpy as np
    import torch

    from visionx_slam_torch.eval.trajectory import ate_of_run
    from visionx_slam_torch.ops import detect
    from visionx_slam_torch.tracking.offline_pipeline import run_offline_pipeline
    from visionx_slam_torch.utils.config import TrackingOptions

    cam = _camera()
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


# The JAX package on the CPU at the bench shapes of configs 5, 2b and 2
# (tools/port_jax_references.py): per lane of the 8 x 120-frame windows
# (starts 30 k), 120/120 tracked, 40 keyframes and 40,000 landmarks each, at
# these ATEs; mono offline 234/240 tracked at 0.35756 m scale-aligned with
# 76 keyframes and 4,657 landmarks. The mono scan over 8 draws of its
# per-frame keys (tools/mono_scan_draws.py): 55-60 tracked (median 59.5),
# scale-aligned ATE 18.2-239.5 mm (median 22.8 mm); the package's own draw
# reads 55/60 at 149.3 mm. The port's scan is held to the median draw.
LANES_B, LANES_T = 8, 120
LANES_ATE_JAX = (0.005571, 0.005413, 0.004859, 0.003390,
                 0.003650, 0.003943, 0.004718, 0.005709)
MONO_OFF_ATE_JAX = 0.357560
MONO_OFF_TRACKED_JAX = 234
MONO_SCAN_ATE_JAX = 0.022810       # median of the 8 draws
MONO_SCAN_TRACKED_JAX = 59.5
# the bench's mono offline budget (bench.py config 2b)
MONO_KW = dict(mono_pair_hypotheses=64, mono_lo_starts=2,
               mono_sample_bias=64.0, mono_score_top_k=32)


def _camera():
    from visionx_slam_torch.data import synthetic
    from visionx_slam_torch.ops.camera import make_camera

    return make_camera(synthetic.FX, synthetic.FY, synthetic.CX, synthetic.CY)


def run_lanes(grays, depths, gt_t) -> dict:
    """Config 5: 8 staggered 120-frame windows of the loop as folded lanes,
    a warm-up run then a counted, timed run; lane 0 also as a single run
    of its frames."""
    import numpy as np
    import torch

    from visionx_slam_torch.eval.trajectory import ate_of_run
    from visionx_slam_torch.ops import detect
    from visionx_slam_torch.tracking.offline_pipeline import (
        default_lane_kf_capacity,
        run_offline_pipeline,
        run_offline_pipeline_batched,
    )
    from visionx_slam_torch.utils.config import TrackingOptions

    cam, opts = _camera(), TrackingOptions()
    T = len(grays)
    starts = [(k * T) // LANES_B for k in range(LANES_B)]
    Tw = min(LANES_T, T)
    g2, d2, gt2 = (np.concatenate([x, x]) for x in (grays, depths, gt_t))
    g = torch.as_tensor(np.stack([g2[s:s + Tw] for s in starts])).cuda()
    d = torch.as_tensor(np.stack([d2[s:s + Tw] for s in starts])).cuda()
    K = default_lane_kf_capacity(Tw)
    run_offline_pipeline_batched(cam, g, d, opts, device="cuda")

    stage_s: dict = {}
    detect.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, out = run_offline_pipeline_batched(cam, g, d, opts, device="cuda",
                                          timings=stage_s)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = detect.launches
    pose, tracked = out.pose.cpu().numpy(), out.tracked.cpu().numpy()
    _require(pose.shape == (LANES_B, Tw, 4, 4) and bool(np.isfinite(pose).all()),
             f"lane poses of shape {pose.shape}, all finite")
    ates = [ate_of_run(pose[b], tracked[b], gt2[s:s + Tw])[0]
            for b, s in enumerate(starts)]
    _require(all(a is not None for a in ates), "every lane has an ATE")

    _, one = run_offline_pipeline(cam, g[0], d[0], opts, device="cuda",
                                  kf_capacity=K)
    one_ate, one_tracked = ate_of_run(one.pose.cpu().numpy(),
                                      one.tracked.cpu().numpy(), gt2[:Tw])
    return {"lanes": LANES_B, "frames_per_lane": Tw, "kf_capacity": K,
            "seconds": wall, "aggregate_fps": LANES_B * Tw / wall,
            "tracked_frac": float(tracked.mean()), "lane_ate_m": ates,
            "ate_m_mean": float(np.mean(ates)), "ate_m_max": float(np.max(ates)),
            "lane_tracked": tracked.sum(1).tolist(),
            "keyframes": out.n_keyframes.tolist(),
            "landmarks": out.n_landmarks.tolist(), "k1_launches": launches,
            "single_lane0_ate_m": one_ate, "single_lane0_tracked": one_tracked,
            "stage_seconds": stage_s}


def run_mono_offline(grays, gt_t) -> dict:
    """Config 2b: the loop tiled four times at stride 4 (240 frames), no
    depth, the monocular offline pipeline with the bench's budget; a
    warm-up run then a counted, timed run."""
    import numpy as np
    import torch

    from visionx_slam_torch.eval.trajectory import ate_of_run
    from visionx_slam_torch.ops import detect
    from visionx_slam_torch.tracking.offline_pipeline import (
        default_lane_kf_capacity,
        run_offline_pipeline,
    )
    from visionx_slam_torch.utils.config import TrackingOptions

    cam, opts = _camera(), TrackingOptions()
    g = torch.as_tensor(np.tile(grays, (4, 1, 1))[::4].copy()).cuda()
    gt = np.tile(gt_t, (4, 1))[::4]
    z = torch.zeros(g.shape, dtype=torch.float32, device="cuda")
    T = g.shape[0]
    kw = dict(monocular=True, kf_capacity=default_lane_kf_capacity(T), **MONO_KW)
    run_offline_pipeline(cam, g, z, opts, device="cuda", **kw)

    stage_s: dict = {}
    detect.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, out = run_offline_pipeline(cam, g, z, opts, device="cuda",
                                  timings=stage_s, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = detect.launches
    pose, tracked = out.pose.cpu().numpy(), out.tracked.cpu().numpy()
    _require(pose.shape == (T, 4, 4) and bool(np.isfinite(pose).all()),
             f"mono poses of shape {pose.shape}, all finite")
    ate, n_tracked = ate_of_run(pose, tracked, gt, with_scale=True)
    return {"frames": T, "seconds": wall, "fps": T / wall,
            "ate_m_scale_aligned": ate, "tracked": n_tracked,
            "keyframes": int(out.n_keyframes),
            "landmarks": int(out.n_landmarks), "k1_launches": launches,
            "stage_seconds": stage_s}


def run_mono_scan(grays, gt_t) -> dict:
    """Config 2: the scan over 60 frames at stride 4, no depth, with the
    monocular option set (keyframes inherit tracked landmarks, the init
    needs 25 triangulable points)."""
    import numpy as np
    import torch

    from visionx_slam_torch.eval.trajectory import ate_of_run
    from visionx_slam_torch.ops import detect
    from visionx_slam_torch.tracking.scan_pipeline import run_scan_pipeline
    from visionx_slam_torch.utils.config import TrackingOptions

    g = torch.as_tensor(grays[::4].copy()).cuda()
    gt = gt_t[::4]
    z = torch.zeros(g.shape, dtype=torch.float32, device="cuda")
    opts = TrackingOptions(link_tracked_landmarks=True, min_init_landmarks=25)
    stats: dict = {}
    detect.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, out = run_scan_pipeline(_camera(), g, z, opts, device="cuda", stats=stats)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    pose, tracked = out.pose.cpu().numpy(), out.tracked.cpu().numpy()
    _require(pose.shape == (len(gt), 4, 4) and bool(np.isfinite(pose).all()),
             f"mono scan poses of shape {pose.shape}, all finite")
    ate, n_tracked = ate_of_run(pose, tracked, gt, with_scale=True)
    return {"frames": len(gt), "seconds": wall, "fps": len(gt) / wall,
            "ate_m_scale_aligned": ate, "tracked": n_tracked,
            "first_tracked": int(np.flatnonzero(tracked)[0]) if tracked.any() else None,
            "keyframe_events": int(out.is_keyframe.sum()),
            "landmarks": int(out.n_landmarks[-1]), "k1_launches": detect.launches,
            **stats}


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

    from visionx_slam_torch.ops import detect

    cam = _camera()
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

    from visionx_slam_torch.ops import detect

    cam = _camera()
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


    cam = _camera()
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

    # ---- 8. folded lanes (BASELINE config 5) ----
    lanes = run_lanes(grays, depths, gt_t)
    print("lanes " + json.dumps(lanes) + f" ({card})", flush=True)
    n_frames = LANES_B * lanes["frames_per_lane"]
    _require(lanes["tracked_frac"] >= 0.95, f"lanes tracked {lanes['tracked_frac']}")
    if T == 240:
        _require(lanes["k1_launches"] == n_frames // 8,
                 f"K1 launches on the lanes {lanes['k1_launches']} == {n_frames // 8}")
        for b, (a, a_j) in enumerate(zip(lanes["lane_ate_m"], LANES_ATE_JAX)):
            _require(a <= 2 * a_j, f"lane {b} ATE {a} m <= 2 x JAX {a_j} m")
    _require(lanes["single_lane0_ate_m"] is not None
             and abs(lanes["lane_ate_m"][0] - lanes["single_lane0_ate_m"]) <= 5e-4,
             f"lane 0 ATE {lanes['lane_ate_m'][0]} within 0.5 mm of its single "
             f"run {lanes['single_lane0_ate_m']}")
    _require(abs(lanes["lane_tracked"][0] - lanes["single_lane0_tracked"]) <= 1,
             "lane 0 tracked within one frame of its single run")

    # ---- 9. monocular offline (config 2b) ----
    mono = run_mono_offline(grays, gt_t)
    print("mono offline " + json.dumps(mono) + f" ({card})", flush=True)
    _require(mono["landmarks"] > 0, "mono landmarks from triangulated depth")
    _require(mono["k1_launches"] == -(-mono["frames"] // 8),
             f"K1 launches on mono offline {mono['k1_launches']}")
    _require(mono["ate_m_scale_aligned"] is not None, "mono offline has an ATE")
    if T == 240:
        _require(mono["ate_m_scale_aligned"] <= 2 * MONO_OFF_ATE_JAX,
                 f"mono offline ATE {mono['ate_m_scale_aligned']} m <= 2 x JAX "
                 f"{MONO_OFF_ATE_JAX} m")
        _require(mono["tracked"] >= 0.9 * MONO_OFF_TRACKED_JAX,
                 f"mono offline tracked {mono['tracked']}")

    # ---- 10. monocular scan (config 2) ----
    mscan = run_mono_scan(grays, gt_t)
    print("mono scan " + json.dumps(mscan) + f" ({card})", flush=True)
    _require(mscan["k1_launches"] == -(-mscan["frames"] // 8),
             f"K1 launches on the mono scan {mscan['k1_launches']}")
    _require(mscan["ate_m_scale_aligned"] is not None, "mono scan has an ATE")
    if T == 240:
        _require(mscan["tracked"] >= MONO_SCAN_TRACKED_JAX - 4,
                 f"mono scan tracked {mscan['tracked']} >= JAX's median draw "
                 f"{MONO_SCAN_TRACKED_JAX} - 4")
        _require(mscan["ate_m_scale_aligned"] <= 2 * MONO_SCAN_ATE_JAX,
                 f"mono scan ATE {mscan['ate_m_scale_aligned']} m <= 2 x JAX's "
                 f"median draw {MONO_SCAN_ATE_JAX} m")

    k1["launches"] = scan["k1_launches"]
    k1b["launches"] = scan["k1b_launches"]
    k1["launches_by_path"] = {
        "offline": res["k1_launches"], "scan": scan["k1_launches"],
        "hole_scan": hole["k1_launches"], "lanes": lanes["k1_launches"],
        "mono_offline": mono["k1_launches"], "mono_scan": mscan["k1_launches"]}
    k1b["launches_by_path"] = {"scan": scan["k1b_launches"]}

    # ---- 11. result ----
    print(json.dumps({"kernels": [k1, k1b]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
