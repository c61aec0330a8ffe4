"""Smoke run of the PyTorch port on one NVIDIA GPU: builds kernel K1 from the
repo's sources, holds it against its plain PyTorch version, then drives the
RGB-D offline SLAM pipeline over a 240-frame 640x480 synthetic sequence
(bench input: scene seed 5) and checks its accuracy.

Run from the repository root: ``python3 chip_smoke.py [--frames N]``.
It exits non-zero (and prints no result) without a CUDA device or when any
phase fails. The last line of stdout is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``;
the line before it is the card's name and power limit, and before that a
JSON line of per-kernel results.
"""

from __future__ import annotations

import argparse
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

    # ---- 3. K1 against its plain version ----
    t0 = time.perf_counter()
    grays, depths, gt_t = synthetic.make_sequence(args.frames, seed=5)
    print(f"rendered {args.frames} frames in {time.perf_counter() - t0:.1f} s",
          flush=True)
    k1 = check_k1(grays[:8])

    # ---- 4. the main path ----
    res = run_pipeline(grays, depths, gt_t)
    print("pipeline " + json.dumps(res) + f" ({card})", flush=True)
    T = res["frames"]
    _require(res["k1_launches"] > 0, "the pipeline launched K1")
    _require(res["tracked"] >= int(0.95 * T), f"tracked {res['tracked']}/{T}")
    _require(res["ate_m"] is not None and res["ate_m"] <= 0.011,
             f"ATE {res['ate_m']} m <= 0.011 m")
    if T == 240:  # the JAX reference makes 80 keyframes on this input
        _require(68 <= res["keyframes"] <= 92, f"keyframes {res['keyframes']}")
    k1["launches"] = res["k1_launches"]

    # ---- 5. result ----
    print(json.dumps({"kernels": [k1]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
