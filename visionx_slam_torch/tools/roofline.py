"""Roofline / MFU report of the online scan (BASELINE config 1) on one card
(counterpart of ``tools/roofline.py``): the per-stage counts of
``utils/flops.py`` beside measured per-stage times.

Measured: the scan's seconds per frame at ``stage_limit`` 2 (the full
pipeline) and 0 (extraction only), median of N runs by the host clock
around a synchronize; local BA's iterations on the final window; and the
per-stage times on the real shapes of the final map (the keyframe ring's
descriptors, slot 0's landmark geometry), each call timed by CUDA events
and summed over repeated calls. The table separates the time attributed
to the stages from the residual, the serial glue of the scan step (the
state machine, branches, gathers, device reads) that no FLOP count
explains. Counting runs outside every timed window.

Run from the repository root on a machine with an NVIDIA GPU::

    python3 -m visionx_slam_torch.tools.roofline [--frames 240] [--runs 3]
        [--json out.json] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys

import torch

from ..bench import sync, timed
from ..data import synthetic
from ..models import matching
from ..models.estimation import pnp_prior
from ..models.local_ba import local_ba
from ..ops.camera import make_camera
from ..ops.se3 import identity_pose
from ..tracking import mapstate as msl
from ..tracking import scan_pipeline as sp
from ..tracking import stages
from ..tracking.mapstate import FREE
from ..utils import flops as fl
from ..utils.config import TrackingOptions


def _clone_map(ms):
    return type(ms)(*(x.clone() for x in ms))


def rep_time(fn, n_rep: int, dev, setup=None) -> float:
    """Mean seconds of one call ``fn(i, *setup(i))`` over ``n_rep`` calls,
    warm; ``setup`` runs outside the timed spans. On the card each call is
    timed by CUDA events around it, on the CPU by the host clock."""
    fn(0, *(setup(0) if setup else ()))
    total = 0.0
    spans = []
    for i in range(n_rep):
        args = setup(i) if setup else ()
        if dev.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn(i, *args)
            end.record()
            spans.append((start, end))
        else:
            total += timed(lambda: fn(i, *args), dev)[0]
    sync(dev)
    total += sum(s.elapsed_time(e) for s, e in spans) / 1e3
    return total / n_rep


def report(frames: int = 240, runs: int = 3, device="cuda") -> dict:
    """The roofline report of the scan over ``frames`` bench frames."""
    dev = torch.device(device)
    T = frames
    grays, depths, _ = synthetic.make_sequence(T, seed=5)
    cam = make_camera(synthetic.FX, synthetic.FY, synthetic.CX, synthetic.CY)
    gd = torch.as_tensor(grays).to(dev)
    dd = torch.as_tensor(depths).to(dev)
    opts = TrackingOptions()
    H, W = grays.shape[1:]
    N = 1024

    # ---- full run and extraction only (seconds per frame) ----
    def timed_scan(stage_limit):
        def go():
            return sp.run_scan_pipeline(cam, gd, dd, opts, stage_limit=stage_limit,
                                        device=dev)
        go()
        ts = [timed(go, dev) for _ in range(runs)]
        st, outs = ts[-1][1]
        return statistics.median(t for t, _ in ts) / T, st, outs

    t_full, st_final, outs = timed_scan(2)
    t_extract, _, _ = timed_scan(0)
    events_pf = float(outs.is_keyframe.float().mean())
    ms_final = st_final.ms

    # measured BA iterations on the final (realistic) window
    ba_opts = sp.tracking_ba_options(opts)
    _, ba_stats = local_ba(_clone_map(ms_final), cam, ba_opts)
    ba_iters = float(ba_stats.iterations)

    # ---- repeated stage calls on the final map's shapes ----
    descs, fvalid = ms_final.kf_desc, ms_final.kf_fvalid      # [K,N,32], [K,N]
    Kr = descs.shape[0]

    def match_fn(i):
        a, b = i % Kr, (i + 1) % Kr
        return matching.knn2_ratio_match(descs[a], fvalid[a], descs[b], fvalid[b])

    t_match = rep_time(match_fn, 32, dev)

    # PnP prior on real landmark geometry (slot 0's links)
    lm = ms_final.kf_feat_lm[0].clamp(0, ms_final.lm_physical - 1).long()
    pts3 = ms_final.lm_pos[:, lm].T.contiguous()
    pts2 = ms_final.kf_px[0].T.contiguous()
    pval = ms_final.kf_fvalid[0] & (ms_final.kf_feat_lm[0] >= 0)
    ident = identity_pose(device=dev)

    def pnp_fn(i):
        return pnp_prior(cam, pts3 + 1e-6 * i, pts2, pval, ident,
                         opts.max_reproj_error, refine_iters=2)

    t_pnp = rep_time(pnp_fn, 32, dev)

    # keyframe event (insert + depth landmarks + triangulation) on a copy
    # of the final map, which each call grows in place
    ms_ev = _clone_map(ms_final)
    cursor = int(ms_ev.next_kf)
    links = torch.full((N,), FREE, dtype=torch.int32, device=dev)

    def event_fn(i):
        m, slot = msl.insert_keyframe(
            ms_ev, 1000 + i, ident, pts2, descs[0], fvalid[0], links,
            ms_ev.kf_depth[0].clone(), fresh_links=True, slot=(cursor + i) % Kr)
        m = stages.depth_landmarks(m, cam, slot, ident)
        return stages.triangulate_pair(m, cam, 0, slot,
                                       opts.triangulation_min_angle_deg,
                                       opts.triangulation_max_reproj_error)

    t_event = rep_time(event_fn, 8, dev)

    # local BA per call, each on a fresh copy of the final map
    t_ba = rep_time(lambda i, m: local_ba(m, cam, ba_opts), 8, dev,
                    setup=lambda i: (_clone_map(ms_final),))

    # ---- FLOP/byte inventory (outside every timed window) ----
    costs = fl.scan_stage_costs(cam, opts, (H, W), n_features=N,
                                events_per_frame=events_pf, ba_iters_avg=ba_iters,
                                device=dev)
    peaks = fl.device_peaks(dev)
    summary = fl.summarize(costs, t_full, peaks)

    times_pf = {
        "extract": t_extract,
        "match": t_match,
        "pnp_prior": t_pnp,
        "kf_event(insert+depth_lm+tri)": t_event * events_pf,
        "local_ba(per GN iter)": t_ba * events_pf,   # t_ba is per call
    }
    attributed = sum(times_pf.values())
    rows = []
    for c in costs:
        tf = times_pf.get(c.name)
        gflops = c.flops_per_frame / tf / 1e9 if tf else None
        rows.append({
            "stage": c.name,
            "flops_per_frame": c.flops_per_frame,
            "bytes_per_frame": c.bytes_per_frame,
            "ms_per_frame": None if tf is None else tf * 1e3,
            "gflops": gflops,
            "pct_bf16_peak": (None if gflops is None or not peaks.get("flops_bf16")
                              else 100 * gflops * 1e9 / peaks["flops_bf16"]),
            "gbs": c.bytes_per_frame / tf / 1e9 if tf else None,
            "ai_flop_per_byte": c.flops_per_frame / max(c.bytes_per_frame, 1),
        })
    return {
        "config": "1_online_scan",
        "n_frames": T,
        "device": peaks["device_kind"],
        "t_full_ms_per_frame": t_full * 1e3,
        "fps": 1.0 / t_full,
        "t_extract_ms_per_frame": t_extract * 1e3,
        "events_per_frame": events_pf,
        "ba_iters_measured": ba_iters,
        "stages": rows,
        "attributed_ms_per_frame": attributed * 1e3,
        "residual_glue_ms_per_frame": (t_full - attributed) * 1e3,
        "summary": summary,
    }


def markdown(out: dict) -> str:
    """The report as a markdown table."""
    dash = "—"
    lines = ["| stage | ms/frame | GFLOP/frame | GFLOP/s | % bf16 peak | GB/s | AI (F/B) |",
             "|---|---|---|---|---|---|---|"]
    for r in out["stages"]:
        lines.append("| {} | {} | {:.3f} | {} | {} | {} | {:.1f} |".format(
            r["stage"],
            dash if r["ms_per_frame"] is None else f"{r['ms_per_frame']:.3f}",
            r["flops_per_frame"] / 1e9,
            dash if r["gflops"] is None else f"{r['gflops']:.0f}",
            dash if r["pct_bf16_peak"] is None else f"{r['pct_bf16_peak']:.2f}",
            dash if r["gbs"] is None else f"{r['gbs']:.0f}",
            r["ai_flop_per_byte"]))
    s = out["summary"]
    lines.append(f"| residual (serial glue) | {out['residual_glue_ms_per_frame']:.3f} "
                 f"| {dash} | {dash} | {dash} | {dash} | {dash} |")
    lines.append(f"| TOTAL | {out['t_full_ms_per_frame']:.3f} | "
                 f"{s['flops_per_frame'] / 1e9:.3f} | {s['achieved_gflops']:.0f} | "
                 f"{100 * s.get('mfu_vs_bf16_peak', 0):.2f} | "
                 f"{s['achieved_gbs']:.0f} | {s['arithmetic_intensity']:.1f} |")
    return "\n".join(lines)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--frames", type=int, default=240)
    p.add_argument("--runs", type=int, default=3)
    p.add_argument("--json", default="")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    out = report(args.frames, args.runs, args.device)
    print(json.dumps(out, indent=2))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=2)
    print("\n" + markdown(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
