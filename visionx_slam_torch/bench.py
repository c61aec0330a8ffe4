"""Benchmark of the port: frames/sec on one card over a synthetic
fr1_desk-class sequence (counterpart of the repository's ``bench.py``).

Renders the TUM-layout synthetic sequence at fr1 geometry (640x480 RGB-D,
scene seed 5; ``data.synthetic.make_sequence``, equal to the PNGs the
JAX bench loads) and runs the full SLAM pipeline on it: ORB on kernel K1,
Hamming matching, PnP RANSAC, keyframes and triangulation, BA, the
trajectory, with its ATE.

Measurement rules:

- the headline is the DEVICE loop: inputs staged on the card, the host
  clock read around ``torch.cuda.synchronize()``. The first run (which
  also uploads the frames and warms the card's libraries) is reported as
  ``e2e_fps_first_run``.
- the headline is the MEDIAN of N timed runs in this process; best and
  worst, their ratio and N are reported beside it.

Flags: --quick (a small CPU smoke run), --frames N, --runs N, --extractor
jax|opencv, --pipeline offline|scan|host, --batch B (B sequences as folded
lanes), --no-configs (the headline only), --device (default cuda), --budget_s
(seconds the config blocks may take before the rest are skipped), --json
PATH (the whole result, ``detail`` included).

The default invocation measures the offline headline and one block per
BASELINE.json evaluation config in ``detail.configs``:

1. stock online run   (the scan pipeline; with its streamed latency at
                       8-frame chunks and its MFU block)
2. monocular          (zero-depth scan over every 4th frame)
2b. monocular offline (the offline pipeline's essential + scale chain)
3. long sequence      (1200 frames through the scan)
4. full-map global BA (pair_ba and global_ba ms per solve on a K=128 map)
5. batched offline    (8 x 120-frame windows as folded lanes)

A config that fails raises and the process exits non-zero. The full result
is printed on one line; the LAST line is a compact summary of at most 500
characters (``metric``, ``value``, ``unit``, ``vs_baseline``, ...), which a
reader of the output's tail can always parse.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import sys
import tempfile
import time

import numpy as np
import torch

from .data import synthetic
from .eval.trajectory import ate_of_run
from .models.global_ba import GlobalBAOptions, global_ba
from .models.pair_ba import pair_ba
from .ops.camera import make_camera
from .system.system import System
from .tracking import mapstate as msl
from .tracking.offline_pipeline import (
    build_offline_pipeline,
    default_lane_kf_capacity,
    run_offline_pipeline,
    run_offline_pipeline_batched,
)
from .tracking.scan_pipeline import run_scan_pipeline, run_scan_pipeline_batched
from .utils import flops as fl
from .utils.config import SystemConfig, TrackingOptions

# the BASELINE.json north-star target: >= 500 frames/sec/chip on TUM fr1_desk
BASELINE_FPS = 500.0
# config 2b's consecutive-pair budget (the JAX bench's): 64 PROSAC-biased
# hypotheses, 2 LO starts, 32-wide tier-2 scoring
MONO_OFFLINE_KW = dict(mono_pair_hypotheses=64, mono_lo_starts=2,
                       mono_sample_bias=64.0, mono_score_top_k=32)
SUMMARY_MAX_CHARS = 500


def _median_stats(times, n_frames):
    fps = sorted(n_frames / t for t in times)
    return {
        "fps_median": round(statistics.median(fps), 2),
        "fps_best": round(fps[-1], 2),
        "fps_worst": round(fps[0], 2),
        "spread": round(fps[-1] / max(fps[0], 1e-9), 3),
        "n_runs": len(times),
    }


def require_device(name) -> torch.device:
    """``name`` as a device; raises for "cuda" where there is no card (a
    measurement does not fall back to the CPU)."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to run on the CPU")
    return dev


def sync(dev: torch.device) -> None:
    """Wait for ``dev``'s work (a no-op on the CPU)."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def timed(fn, dev):
    """(seconds, result) of one call by the host clock, the device's work
    before and inside it waited for."""
    sync(dev)
    t0 = time.perf_counter()
    out = fn()
    sync(dev)
    return time.perf_counter() - t0, out


def _time_device_loop(run_fn, n_frames, runs, dev, warm=True):
    """A warm-up call (``warm``), then the median statistics of ``runs``
    timed calls and the last call's result. A warm-up keeps the first
    call's costs (the card's libraries loading, the allocator growing) out
    of the times; the port compiles nothing per shape, so a path an earlier
    block of the same process warmed needs none."""
    if warm:
        run_fn()
    times, out = [], None
    for _ in range(runs):
        t, out = timed(run_fn, dev)
        times.append(t)
    return _median_stats(times, n_frames), out


def _camera():
    return make_camera(synthetic.FX, synthetic.FY, synthetic.CX, synthetic.CY)


def _ate(outs, gts, with_scale=False):
    """(ATE, tracked frames) of a run's outputs against ``gts``."""
    return ate_of_run(outs.pose.cpu().numpy(), outs.tracked.cpu().numpy(),
                      gts, with_scale)


def _lane_ates(outs, gts) -> list:
    """The ATEs of the lanes of [B,T,...] outputs (``gts``: one per lane),
    lanes with under 3 tracked frames left out."""
    pose, tracked = outs.pose.cpu().numpy(), outs.tracked.cpu().numpy()
    ates = [ate_of_run(pose[b], tracked[b], gt)[0] for b, gt in enumerate(gts)]
    return [a for a in ates if a is not None]


def _bench_configs(cam, opts, gd, dd, gts, runs, dev, budget_s):
    """The BASELINE.json evaluation configs on the staged 240-frame
    sequence (one exact trajectory loop, so tiling is continuous motion).

    ``budget_s``: once the configs have taken that long, the rest are
    recorded as ``{"skipped": ...}`` (the headline is already measured)."""
    t_start = time.perf_counter()
    T, H, W = gd.shape
    configs = {}

    def scan(g, d, o, **kw):
        return run_scan_pipeline(cam, g, d, o, device=dev, **kw)

    def over_budget(key) -> bool:
        spent = time.perf_counter() - t_start
        if spent <= budget_s:
            return False
        configs[key] = {"skipped": f"bench budget {budget_s:.0f}s exhausted "
                                   f"before this config ({spent:.0f}s spent)"}
        return True

    # ---- 1. stock online run: the reference's own loop shape ----
    if not over_budget("1_online_scan"):
        stats, outs = _time_device_loop(lambda: scan(gd, dd, opts)[1], T, runs, dev)
        ate, _ = _ate(outs, gts)
        c1 = configs["1_online_scan"] = {
            "fps": stats["fps_median"], "n_frames": T,
            "tracked_frac": float(outs.tracked.float().mean()),
            "ate_rmse_m": ate,
        }
        # per-frame latency of the streaming shape: the same scan in 8-frame
        # chunks with the state threaded through, per-chunk wall time over
        # the chunk size, p50/p99 over chunks (keyframe events are the tail)
        chunk = 8
        st, lat = None, []
        for s in range(0, T, chunk):
            t, (st, _) = timed(lambda: scan(gd[s:s + chunk], dd[s:s + chunk],
                                             opts, st0=st, frame0=s), dev)
            lat.append(t / min(chunk, T - s) * 1e3)
        c1.update(latency_ms_p50=round(float(np.percentile(lat, 50)), 3),
                  latency_ms_p99=round(float(np.percentile(lat, 99)), 3),
                  latency_chunk=chunk)
        # MFU / roofline: the per-stage counts (utils/flops.py) over the
        # measured frame time
        costs = fl.scan_stage_costs(
            cam, opts, (H, W), events_per_frame=float(outs.is_keyframe.float().mean()),
            ba_iters_avg=3.0, device=dev)
        mfu = fl.summarize(costs, 1.0 / stats["fps_median"], fl.device_peaks(dev))
        c1["mfu"] = mfu.get("mfu_vs_bf16_peak", 0.0)
        c1["roofline"] = mfu

    # ---- 2. monocular: zero depth, every 4th frame (fr1-speed steps starve
    # the parallax gate), with the mono option set: keyframes inherit
    # tracked landmarks, the init needs 25 triangulable points ----
    if not over_budget("2_monocular"):
        g2 = gd[::4].contiguous()
        z2 = torch.zeros(g2.shape, dtype=torch.float32, device=dev)
        opts2 = dataclasses.replace(opts, link_tracked_landmarks=True,
                                    min_init_landmarks=25)
        stats, outs = _time_device_loop(lambda: scan(g2, z2, opts2)[1],
                                        len(g2), runs, dev)
        configs["2_monocular"] = {
            "fps": stats["fps_median"], "n_frames": len(g2),
            "tracked_frac": float(outs.tracked.float().mean()),
            "ate_rmse_m_scale_aligned": _ate(outs, gts[::4], with_scale=True)[0],
            "note": "mono scale is unobservable: ATE after similarity "
                    "alignment (reference has no scale correction either)",
        }

    # ---- 2b. monocular on the offline pipeline (essential + scale chain)
    # over four trajectory loops at stride 4, 240 frames ----
    if not over_budget("2b_monocular_offline"):
        g2b = gd.repeat(4, 1, 1)[::4].contiguous()
        z2b = torch.zeros(g2b.shape, dtype=torch.float32, device=dev)
        T2 = len(g2b)
        kw = dict(monocular=True, kf_capacity=default_lane_kf_capacity(T2),
                  **MONO_OFFLINE_KW)
        stats, outs = _time_device_loop(
            lambda: run_offline_pipeline(cam, g2b, z2b, opts, device=dev, **kw)[1],
            T2, runs, dev)
        configs["2b_monocular_offline"] = {
            "fps": stats["fps_median"], "n_frames": T2,
            "tracked_frac": float(outs.tracked.float().mean()),
            "ate_rmse_m_scale_aligned": _ate(outs, np.tile(gts, (4, 1))[::4],
                                             with_scale=True)[0],
            "note": "fast-path mono (essential + scale chain), 4x-stride "
                    "over four trajectory loops",
        }

    # ---- 3. long sequence: 5 continuous loops = 1200 frames through the
    # scan (keyframe ring eviction and landmark compaction) ----
    if not over_budget("3_long_sequence"):
        reps = 5
        g3, d3 = gd.repeat(reps, 1, 1), dd.repeat(reps, 1, 1)
        # the scan was warmed by config 1
        stats, outs = _time_device_loop(lambda: scan(g3, d3, opts)[1],
                                        T * reps, max(2, runs - 1), dev, warm=False)
        configs["3_long_sequence"] = {
            "fps": stats["fps_median"], "n_frames": T * reps,
            "tracked_frac": float(outs.tracked.float().mean()),
            "ate_rmse_m": _ate(outs, np.tile(gts, (reps, 1)))[0],
            "n_keyframes": int(outs.n_keyframes[-1]),
            "n_landmarks": int(outs.n_landmarks[-1]),
        }

    # ---- 4. full-map global BA: ms per solve of both solvers on the
    # offline-built K=128 map ----
    if not over_budget("4_fullmap_gba"):
        ms, links, _ = build_offline_pipeline(opts).pre(cam, gd, dd)
        gba_opts = GlobalBAOptions(max_iterations=2, cg_iterations=12)
        entry = {}
        for name, fn in (("pair_ba", lambda: pair_ba(ms, cam, links, gba_opts)),
                         ("global_ba", lambda: global_ba(ms, cam, gba_opts))):
            fn()
            ts = [timed(fn, dev)[0] for _ in range(runs)]
            entry[name + "_ms_per_solve"] = round(statistics.median(ts) * 1e3, 2)
        entry.update(n_keyframes=int(msl.n_keyframes(ms)),
                     n_landmarks=int(msl.n_landmarks(ms)),
                     gn_iterations=2, cg_iterations=12)
        configs["4_fullmap_gba"] = entry

    # ---- 5. batched offline mapping: 8 staggered 120-frame windows of the
    # loop as folded lanes; aggregate fps is the metric ----
    if not over_budget("5_batched_offline"):
        B, Tw = 8, min(120, T)
        starts = [(k * T) // B for k in range(B)]
        g2x, d2x = gd.repeat(2, 1, 1), dd.repeat(2, 1, 1)   # windows may wrap
        g5 = torch.stack([g2x[s:s + Tw] for s in starts])
        d5 = torch.stack([d2x[s:s + Tw] for s in starts])
        stats, outs = _time_device_loop(
            lambda: run_offline_pipeline_batched(cam, g5, d5, opts, device=dev)[1],
            B * Tw, runs, dev)
        gt2 = np.tile(gts, (2, 1))
        ates = _lane_ates(outs, [gt2[s:s + Tw] for s in starts])
        configs["5_batched_offline"] = {
            "aggregate_fps": stats["fps_median"], "batch": B,
            "frames_per_seq": Tw,
            "per_stream_fps": round(stats["fps_median"] / B, 2),
            "tracked_frac": float(outs.tracked.float().mean()),
            "ate_rmse_m_mean": float(np.mean(ates)) if ates else None,
        }
    return configs


def _report(result: dict, summary_keys, json_path: str | None) -> None:
    """Print the whole result, then the compact summary as the last line;
    write the whole result to ``json_path`` if given."""
    if json_path:
        with open(json_path, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result), flush=True)
    d = result["detail"]
    summary = {k: result[k] for k in ("metric", "value", "unit", "vs_baseline")}
    summary.update({k: d[k] for k in summary_keys if k in d})
    line = json.dumps(summary)
    if len(line) > SUMMARY_MAX_CHARS:
        raise RuntimeError(f"summary line of {len(line)} characters")
    print(line, flush=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser("visionx_slam_torch.bench")
    p.add_argument("--quick", action="store_true", help="tiny CPU smoke run")
    p.add_argument("--frames", type=int, default=0)
    p.add_argument("--runs", type=int, default=5)
    p.add_argument("--extractor", default="jax", choices=["jax", "opencv"])
    p.add_argument("--pipeline", default="offline",
                   choices=["offline", "scan", "host"])
    p.add_argument("--batch", type=int, default=0,
                   help="batched throughput mode: B sequences as folded lanes")
    p.add_argument("--no-configs", action="store_true",
                   help="headline only; skip the per-BASELINE-config blocks")
    p.add_argument("--device", default="cuda")
    p.add_argument("--budget_s", type=float, default=900.0,
                   help="seconds the config blocks may take; later ones are "
                        "skipped")
    p.add_argument("--json", default="", help="write the whole result here")
    args = p.parse_args(argv)

    if args.batch:
        return bench_batched(args)
    if args.pipeline == "host" or args.extractor == "opencv":
        return bench_host(args)

    dev = require_device(args.device)
    n_frames = args.frames or (20 if args.quick else 240)
    runs = max(2, args.runs if not args.quick else 2)
    grays, depths, gts = synthetic.make_sequence(n_frames, seed=5)
    cam = _camera()
    opts = TrackingOptions()

    def run_fn(g, d):
        if args.pipeline == "offline":
            return run_offline_pipeline(cam, g, d, opts, device=dev)
        st, outs = run_scan_pipeline(cam, g, d, opts, device=dev)
        return st.ms, outs

    # end to end once (upload + the card's first calls), then the device
    # loop on staged inputs
    e2e_first, _ = timed(lambda: run_fn(grays, depths), dev)
    gd = torch.as_tensor(grays).to(dev)
    dd = torch.as_tensor(depths).to(dev)
    times = []
    for _ in range(runs):
        t, (ms, outs) = timed(lambda: run_fn(gd, dd), dev)
        times.append(t)
    stats = _median_stats(times, n_frames)
    ate, n_tracked = _ate(outs, gts)
    fps = stats["fps_median"]
    detail = {
        "n_frames": n_frames,
        "n_tracked": n_tracked,
        "n_keyframes": int(msl.n_keyframes(ms)),
        "n_landmarks": int(msl.n_landmarks(ms)),
        "ate_rmse_m": ate,
        "extractor": args.extractor,
        "pipeline": args.pipeline,
        "device": fl.device_peaks(dev)["device_kind"],
        **stats,
        "e2e_fps_first_run": round(n_frames / e2e_first, 2),
        "note": "device loop (inputs on the card, host clock around a "
                "synchronize); e2e includes the upload and the first calls",
    }
    if not args.quick:
        # headline MFU: the per-stage counts over the measured frame time; a
        # LOWER BOUND (utils/flops.py: the offline inventory leaves out the
        # map build and the global BA)
        H, W = grays.shape[1:]
        costs = (fl.offline_stage_costs(cam, opts, (H, W), device=dev)
                 if args.pipeline == "offline"
                 else fl.scan_stage_costs(cam, opts, (H, W), device=dev))
        mfu = fl.summarize(costs, 1.0 / fps, fl.device_peaks(dev))
        detail["mfu"] = mfu.get("mfu_vs_bf16_peak", 0.0)
        detail["roofline"] = mfu
    if not args.quick and not args.no_configs and args.pipeline == "offline":
        detail["configs"] = _bench_configs(cam, opts, gd, dd, gts,
                                           max(2, min(runs, 3)), dev, args.budget_s)
    result = {
        "metric": "frames/sec/chip, full SLAM device loop (640x480 RGB-D, "
                  "synthetic fr1-class)",
        "value": fps,
        "unit": "frames/sec",
        "vs_baseline": round(fps / BASELINE_FPS, 4),
        "detail": detail,
    }
    _report(result, ("n_frames", "n_tracked", "ate_rmse_m", "pipeline",
                     "device", "mfu"), args.json)
    return 0


def bench_host(args) -> int:
    """Host-pipeline / opencv-extractor variant through ``System``, on the
    sequence written as PNGs to a temporary directory."""
    dev = require_device(args.device)
    n_frames = args.frames or (20 if args.quick else 240)
    seq = "rgbd_dataset_freiburg3_synthetic"
    with tempfile.TemporaryDirectory(prefix="vxs_bench_") as root:
        synthetic.generate_sequence(root, sequence=seq, n_frames=n_frames,
                                    seed=5)
        cfg = SystemConfig(
            dataset_dir=root, sequence=seq,
            output_dir=os.path.join(root, "out"), extractor=args.extractor,
            pipeline=args.pipeline, metrics_jsonl=False, max_frames=n_frames,
            device=args.device,
        )
        System(cfg).run()  # warm-up
        wall, summary = timed(lambda: System(cfg).run(), dev)
    fps = summary.get("scan_fps", summary["n_frames"] / wall)
    _report({
        "metric": "frames/sec/chip end-to-end via System driver",
        "value": round(fps, 2),
        "unit": "frames/sec",
        "vs_baseline": round(fps / BASELINE_FPS, 4),
        "detail": {
            "n_frames": summary["n_frames"],
            "n_tracked": summary["n_tracked"],
            "ate_rmse_m": summary.get("ate_rmse"),
            "extractor": args.extractor, "pipeline": args.pipeline,
            "device": args.device,
        },
    }, ("n_frames", "n_tracked", "ate_rmse_m", "pipeline", "device"), args.json)
    return 0


def bench_batched(args) -> int:
    """Batched throughput mode (BASELINE config 5 on one card): B synthetic
    sequences (scene seeds 100, 101, ...) mapped together; the metric is
    aggregate frames/sec. The offline pipeline folds them into lanes;
    ``--pipeline scan`` measures the batched scan instead."""
    dev = require_device(args.device)
    B = args.batch
    T = args.frames or (20 if args.quick else 120)
    runs = max(2, args.runs if not args.quick else 2)
    seqs = [synthetic.make_sequence(T, seed=100 + b) for b in range(B)]
    gd = torch.as_tensor(np.stack([s[0] for s in seqs])).to(dev)
    dd = torch.as_tensor(np.stack([s[1] for s in seqs])).to(dev)
    gts = [s[2] for s in seqs]
    cam = _camera()
    opts = TrackingOptions()

    def run_fn():
        if args.pipeline == "scan":
            _, outs = run_scan_pipeline_batched(cam, gd, dd, opts, device=dev)
            # scan outputs are [T,B,...]; normalize to [B,T,...]
            return type(outs)(*(x.transpose(0, 1) for x in outs))
        return run_offline_pipeline_batched(cam, gd, dd, opts, device=dev)[1]

    stats, outs = _time_device_loop(run_fn, B * T, runs, dev)
    ates = _lane_ates(outs, gts)
    fps = stats["fps_median"]
    _report({
        "metric": "aggregate frames/sec/chip, batched multi-sequence SLAM "
                  "(640x480 RGB-D)",
        "value": fps,
        "unit": "frames/sec",
        "vs_baseline": round(fps / BASELINE_FPS, 4),
        "detail": {
            "batch": B, "frames_per_seq": T,
            "pipeline": args.pipeline,
            "per_stream_fps": round(fps / B, 2),
            "tracked_frac": float(outs.tracked.float().mean()),
            "ate_rmse_m_mean": float(np.mean(ates)) if ates else None,
            "device": fl.device_peaks(dev)["device_kind"],
            **stats,
        },
    }, ("batch", "frames_per_seq", "tracked_frac", "ate_rmse_m_mean",
        "pipeline", "device"), args.json)
    return 0


if __name__ == "__main__":
    sys.exit(main())
