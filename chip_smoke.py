"""Smoke run of the PyTorch port on one NVIDIA GPU: builds kernels K1 and
K1b from the repo's source, holds them bit for bit against their plain
PyTorch versions (at the rendered 8-frame atlas and at edge shapes) and the
pyramid atlas built on the card against the one built on the CPU, builds
kernel K2 (the pose Gauss-Newton) and holds it against its plain version
at the main path's three shapes, and kernels K3 (a whole local BA call)
and K4 (a whole two-view triangulation) against their plain versions on a
window and a keyframe pair of the scan, then
drives the port's paths over a 240-frame 640x480 synthetic sequence (bench
input: scene seed 5) and checks their accuracy: the RGB-D offline
pipeline (and ``match_frames_batched`` over 8 consecutive pairs of its
frames, bit for bit the per-pair loop); the online scan (per-frame
tracking, keyframes, local BA) as one run, streamed in 8-frame chunks,
and with a depth hole (the left 200
columns: triangulated landmarks, so local BA iterates); ``System`` over
240 frames of the benchmark cell ``rgbd.system_disk_holes`` (TUM files
with the hole model, tracking against the local map), judged by the cell's
reference and limits, and over 240 frames of ``rgbd.system_host_holes``
(the same files through ``System``'s default pipeline, the host
``Tracker`` with the local map, its ring harvested into the archive); the long-stress
tool (``tools/long_stress.py``): the sequence tiled on the card to 2160
frames (the keyframe ring wraps, the landmark table is compacted at full
capacity, no landmark may be dropped), then split at frame 1200 and
resumed from the carried scan state; the real-data tool's
sensor-degradation matrix (``tools/real_data_check.py``: the scan over 120
frames clean, under each of five sensor models and under all combined);
the offline pipeline over 8 folded lanes of
120 frames (BASELINE config 5); the monocular offline pipeline over the
sequence tiled four times at stride 4 (config 2b), and on that input with
the monocular loop closure (the scale re-anchoring at revisits; with the
landmark merge and the two-phase refine too, twice for equal bits; and that
as two folded lanes, the input and its reverse, lane 0 bit for bit the
single run); the monocular scan
over 60 frames at stride 4 (config 2); the two global-BA solvers
``pair_ba`` and ``global_ba`` on the offline K=128 map (config 4), timed;
the scan in 64-frame chunks with the keyframe archive and the full-map
global BA over every keyframe it made; the scan stopped at frame 120,
snapshotted to an npz, reloaded and resumed; the scan with map culling on,
with the default culling options (the map collapses, as the reference's
does) and with options under which it stays healthy and removes keyframes;
the batched scan over config 5's 8 windows, against 8 single runs; and the
normal entry point: the sequence written to a temporary TUM-layout
directory, decoded back (bit-equal to the rendered arrays) and mapped by
``visionx_slam_torch.cli.main.entrypoint`` through ``--pipeline scan``
(with the full-map global BA), ``offline`` (its ``System`` run bit for bit
the in-memory pipeline at the same 128 keyframe slots; the pipeline at 88
slots printed beside it) and ``host``, and stopped at a
snapshot and resumed, the output files read back, and the real-data
tool's ``--dataset_dir`` mode over that directory; and the multi-device
module in a world of one under ``nccl``: ``entry``'s forward, one fused
SLAM step over a fleet of 8 lanes built from the first 9 frames on disk,
the sharded offline pipeline over config 5's lanes (bit for bit the folded
lanes' result), and the dry run. The solvers' float sums add in a fixed
order, so ``global_ba``, local BA and the scan are checked to repeat bit
for bit. Then the measurement layer: the port's bench entry
(``python -m visionx_slam_torch.bench``, the headline and the six
BASELINE configs) in a process of its own, its last line parsed and every
config held to the limits of PERF.md Section 2.

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
import os
import subprocess
import sys
import tempfile
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


def _zero_k34() -> None:
    """Zeroes the launch counters of K3 (local BA) and K4 (triangulation),
    where a phase zeroes K1's."""
    from visionx_slam_torch.models import local_ba
    from visionx_slam_torch.tracking import stages

    local_ba.lba_launches = 0
    stages.tri_launches = 0


def _k34() -> dict:
    """K3's and K4's launches since the last ``_zero_k34``."""
    from visionx_slam_torch.models import local_ba
    from visionx_slam_torch.tracking import stages

    return {"lba_launches": local_ba.lba_launches,
            "tri_launches": stages.tri_launches}


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


def _device_ms(fn, reps: int = 5, lead_ms: float = 50.0) -> float:
    """Device time of one call of ``fn`` by CUDA events, a spin kernel
    keeping the card busy while the host launches the call, so that the
    events time the call's kernels and not the host's launches."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    total = 0.0
    for _ in range(reps):
        torch.cuda._sleep(int(lead_ms * 2e6))   # ~lead_ms at 2 GHz
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total / reps


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
                   max_err: float, ms: float, plain_ms: float,
                   source: str = "fast_harris_blur.cu") -> dict:
    """A kernel's entry of the result line. Its bound is the larger of the
    bytes it must move over the H100's 3.35 TB/s and its arithmetic over the
    67 TFLOP/s of float32 outside the tensor cores (``utils.flops``)."""
    from visionx_slam_torch.utils import flops

    bound = flops.bound_ms(n_bytes, n_ops)
    return {"name": name, "route": "cuda",
            "source": f"visionx_slam_torch/csrc/{source}",
            "replaces": replaces, "launches": 0, "max_abs_err": max_err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": ("bytes" if flops.bound_ms(n_bytes) >= flops.bound_ms(0, n_ops)
                         else "operations"),
            "library_ms": None, "bytes": n_bytes, "bound_share": bound / ms}


def check_k1(grays_u8) -> dict:
    """K1 against its plain version, bit for bit and to the Pallas test's
    tolerances, on the rendered 8-frame atlas and the edge shapes, and
    ``orb_extract`` of the 8 frames with ``use_kernel`` 0 and 1 equal to its
    default run; returns the kernel's result record."""
    import torch

    from visionx_slam_torch.models.orb_torch import build_atlas, orb_extract
    from visionx_slam_torch.ops import detect
    from visionx_slam_torch.tools import k1_bench
    from visionx_slam_torch.utils import flops

    g8 = torch.as_tensor(grays_u8).cuda()
    atlas, mask = build_atlas(g8)
    max_err = k1_bench.check_k1(k1_bench.exact_cases(atlas, mask)[0])
    full = orb_extract(g8)
    for use_kernel in (0, 1):
        _require(all(torch.equal(x, y) for x, y in zip(
            orb_extract(g8, use_kernel=use_kernel), full)),
            f"orb_extract(use_kernel={use_kernel}) equals its default run")
    ms_k = _time_ms(lambda: detect.fast_harris_blur(atlas, mask))
    ms_p = _time_ms(lambda: detect.fast_harris_blur_reference(atlas, mask))
    print(f"K1 {tuple(atlas.shape)}: {ms_k:.4f} ms, plain {ms_p:.4f} ms "
          f"({_card()})", flush=True)
    return _kernel_record("fast_harris_blur",
                          "visionx_slam_tpu/ops/pallas_detect.py:167",
                          flops.k1_bytes(atlas.shape),
                          flops.k1_ops(atlas.shape), max_err, ms_k, ms_p)


def time_k1_one_frame(gray_u8) -> dict:
    """K1 at the host path's shape, a one-frame atlas: its time and its
    plain version's by CUDA events, and its byte bound there."""
    import torch

    from visionx_slam_torch.models.orb_torch import build_atlas
    from visionx_slam_torch.ops import detect
    from visionx_slam_torch.tools import k1_bench
    from visionx_slam_torch.utils import flops

    atlas, mask = build_atlas(torch.as_tensor(gray_u8).cuda()[None])
    k1_bench.check_k1([("one-frame atlas", atlas, mask)])
    n_bytes = flops.k1_bytes(atlas.shape)
    out = {"shape": list(atlas.shape), "bytes": n_bytes,
           "ms": _time_ms(lambda: detect.fast_harris_blur(atlas, mask)),
           "plain_ms": _time_ms(lambda: detect.fast_harris_blur_reference(atlas, mask)),
           "bound_ms": flops.bound_ms(n_bytes, flops.k1_ops(atlas.shape))}
    print(f"K1 {tuple(atlas.shape)}: {out['ms']:.4f} ms, plain "
          f"{out['plain_ms']:.4f} ms, bound {out['bound_ms']:.5f} ms ({_card()})",
          flush=True)
    return out


def check_k1b(grays_u8) -> dict:
    """K1b against its plain version, bit for bit and to K1's tolerances,
    on the float32 atlas of rendered frames, the edge shapes and a 2-D
    image, one launch per call; returns the kernel's result record."""
    import torch

    from visionx_slam_torch.models.orb_torch import build_atlas
    from visionx_slam_torch.ops import detect
    from visionx_slam_torch.tools import k1_bench
    from visionx_slam_torch.utils import flops

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
                          flops.k1b_bytes(x.shape), flops.k1b_ops(x.shape),
                          max_err, ms_k, ms_p)


# K2 against its plain version (tests/test_torch_gn_kernel.py): the largest
# pose difference (unit quaternion, metres at 1-5 m depth) on problems where
# the plain version's float32 and float64 runs agree within GN_TOL, and the
# least share of such problems; the polish's 3-point systems amplify float32
# rounding by their condition, hence its own bound
GN_TOL = 1e-5
GN_TOL_POLISH = 1e-4
GN_STABLE_SHARE = 0.9


def _gn_inputs(P: int, H: int, N: int, seed: int) -> dict:
    """Pose Gauss-Newton problems on the card: N points a problem at 1-5 m
    depth, pixels of a true pose with 0.5 px noise, start poses near the
    truth; with ``H`` > 0, [P,1,N] points under [P,H] start poses each
    weighted on its own 3-point sample (the polish), else [P,N] with 0/1
    weights (95% on) and 10% of the pixels outliers."""
    import torch

    from visionx_slam_torch.ops.se3 import quat_conj, quat_mul, quat_rotate, so3_exp

    cam = _camera()
    g = torch.Generator().manual_seed(seed)
    u = lambda *s: torch.rand(*s, generator=g)
    n = lambda *s: torch.randn(*s, generator=g)
    pc = torch.stack([3 * u(P, N) - 1.5, 2 * u(P, N) - 1, 4 * u(P, N) + 1], -1)
    q, t = so3_exp(0.2 * n(P, 3)), 0.3 * n(P, 3)
    X = quat_rotate(quat_conj(q)[:, None], pc - t[:, None])
    px = torch.stack([cam.fx * pc[..., 0] / pc[..., 2] + cam.cx,
                      cam.fy * pc[..., 1] / pc[..., 2] + cam.cy], -1)
    px = px + 0.5 * n(P, N, 2)
    out = u(P, N) < (0.0 if H else 0.1)
    px = torch.where(out[..., None], u(P, N, 2) * torch.tensor([640.0, 480.0]), px)
    q0, t0 = quat_mul(so3_exp(0.005 * n(P, 3)), q), t + 0.01 * n(P, 3)
    if H:
        q0 = quat_mul(so3_exp(0.002 * n(P, H, 3)), q0[:, None])
        t0 = t0[:, None] + 0.005 * n(P, H, 3)
        w = torch.zeros(P, H, N).scatter_(-1, torch.argsort(u(P, H, N), -1)[..., :3], 1.0)
        X, px = X[:, None], px[:, None]
    else:
        w = (u(P, N) > 0.05).float()
    return {k: v.contiguous().cuda() for k, v in
            dict(q=q0, t=t0, X=X, px=px, w=w).items()}


def check_gn() -> dict:
    """K2 against its plain version at the main path's three shapes: the
    polish ([32,1,1024] points under [32,16] poses, 2 steps), the robust
    motion prior ([32] x 1024, 4 steps) and the final refine ([32] x 1024,
    2 and 4 steps). On each, poses within ``GN_TOL`` (the polish:
    ``GN_TOL_POLISH``) of the plain version's where float32 and float64
    plain runs agree within ``GN_TOL`` (at least ``GN_STABLE_SHARE`` of the
    problems), and bit for bit between two runs;
    device times of K2 and of the plain version by CUDA events, and the
    pace of back-to-back calls (``host_ms``: the host's launching of a call is
    longer than K2's device time). Returns K2's result
    record, timed at the polish, with every shape's numbers under
    ``shapes``."""
    import numpy as np
    import torch

    from visionx_slam_torch.models import estimation
    from visionx_slam_torch.ops.se3 import Pose
    from visionx_slam_torch.utils import flops

    cam = _camera()
    t0 = time.perf_counter()
    estimation.build_gn_kernel()
    build_s = time.perf_counter() - t0
    robust = dict(robust=True, huber_delta=4.0, gate_px=20.0)
    shapes = {"polish": (16, dict(iters=2)), "prior": (0, dict(iters=4, **robust)),
              "refine2": (0, dict(iters=2)), "refine4": (0, dict(iters=4))}
    rows = {}
    for k, (name, (H, kw)) in enumerate(shapes.items()):
        a = _gn_inputs(32, H, 1024, seed=100 + k)
        args = (Pose(a["q"], a["t"]), a["X"], a["px"], a["w"])
        k2 = lambda: estimation._pose_gn_refine(cam, *args, **kw)
        plain = lambda: estimation._pose_gn_refine_plain(cam, *args, **kw)
        r1, r2, p = k2(), k2(), plain()
        d = {k_: v.double() for k_, v in a.items()}
        p64 = estimation._pose_gn_refine_plain(
            cam, Pose(d["q"], d["t"]), d["X"], d["px"], d["w"], **kw)
        gap = lambda x, y: torch.maximum((x.q - y.q).abs().amax(-1),
                                         (x.t - y.t).abs().amax(-1))
        stable = gap(p, p64) <= GN_TOL
        err = float(gap(r1, p)[stable].max())
        bits = lambda x: torch.cat([x.q, x.t], -1).view(torch.int32)
        _require(torch.equal(bits(r1), bits(r2)), f"K2 repeats bit for bit ({name})")
        tol = GN_TOL_POLISH if H else GN_TOL
        _require(float(stable.float().mean()) >= GN_STABLE_SHARE and err <= tol,
                 f"K2 matches its plain version ({name}): {err} on "
                 f"{float(stable.float().mean())} of the problems")
        nb = int(np.prod(r1.t.shape[:-1]))
        n_in = sum(v.numel() for v in a.values())
        rows[name] = {"problems": nb, "points": 1024, **kw,
                      "max_abs_err": err,
                      "stable_share": float(stable.float().mean()),
                      "ms": _device_ms(k2), "plain_ms": _device_ms(plain),
                      "host_ms": _time_ms(k2), "plain_host_ms": _time_ms(plain),
                      "bytes": flops.k2_bytes(nb, n_in),
                      "ops": flops.k2_ops(nb, 1024, kw["iters"], kw.get("robust", False))}
        rows[name]["bound_ms"] = flops.bound_ms(rows[name]["bytes"], rows[name]["ops"])
        print(f"K2 {name} {json.dumps(rows[name])} ({_card()})", flush=True)
    pol = rows["polish"]
    rec = _kernel_record("pose_gn", "none: the JAX package leaves pose GN to XLA",
                         pol["bytes"], pol["ops"],
                         max(r["max_abs_err"] for r in rows.values()),
                         pol["ms"], pol["plain_ms"], source="pose_gn.cu")
    rec.update(build_s=build_s, shapes=rows)
    return rec


# K3 against its plain version on a full window of the hole scan: window
# poses within LBA_TOL_POSE, landmark positions within LBA_TOL_POS metres
# (tests/test_torch_lba_kernel.py gives the reasons), iterations and the
# observation count exactly
LBA_TOL_POSE = 1e-5
LBA_TOL_POS = 1e-4


def check_lba(grays, depths) -> dict:
    """K3 against its plain version on the last full window the scan hands
    to local BA over the first 48 frames with the depth hole (the scan's
    own options: early exit on): iterations and observations equal, poses
    and landmark positions within ``LBA_TOL_POSE`` and ``LBA_TOL_POS``,
    two K3 runs bit for bit; device times of K3 and of the plain version
    by CUDA events behind a spin kernel, with the copy that restores the
    window's tables before each call timed alone and taken off, and the
    pace of back-to-back calls (``host_ms``, the restore included: the
    plain version launches ~630 operations and reads the device once or
    twice a call). Returns K3's result record."""
    import torch

    from visionx_slam_torch.models import local_ba as lba
    from visionx_slam_torch.tracking import scan_pipeline as sp
    from visionx_slam_torch.tracking.mapstate import kf_alive
    from visionx_slam_torch.utils import flops
    from visionx_slam_torch.utils.config import TrackingOptions

    cam = _camera()
    t0 = time.perf_counter()
    lba.build_lba_kernel()
    build_s = time.perf_counter() - t0
    g = torch.as_tensor(grays[:48]).cuda()
    d = torch.as_tensor(depths[:48]).cuda()
    d[:, :, :HOLE_COLS] = 0.0
    seen, real = [], sp.local_ba

    def spy(ms, cam_, opts_):
        seen.append(type(ms)(*(x.clone() for x in ms)))
        return real(ms, cam_, opts_)

    sp.local_ba = spy
    try:
        sp.run_scan_pipeline(cam, g, d, TrackingOptions(), device="cuda")
    finally:
        sp.local_ba = real
    opts = sp.tracking_ba_options(TrackingOptions())
    src = [m for m in seen if int(kf_alive(m).sum()) >= opts.window_size][-1]
    ms = type(src)(*(x.clone() for x in src))

    def restore():
        for name in ("kf_q", "kf_t", "lm_pos"):
            getattr(ms, name).copy_(getattr(src, name))

    def k3():
        restore()
        return lba.local_ba(ms, cam, opts)

    def plain():
        restore()
        return lba._local_ba_plain(ms, cam, opts)

    def kept(res):   # the map is restored before the next call
        m, stats = res
        return type(m)(*(x.clone() for x in m)), stats

    (a, sa), (b, sb), (p, spl) = kept(k3()), kept(k3()), kept(plain())
    _require(all(torch.equal(x, y) for x, y in zip(a, b))
             and torch.equal(sa.final_cost, sb.final_cost),
             "K3 repeats bit for bit")
    pose_err = float(torch.maximum((a.kf_q - p.kf_q).abs().max(),
                                   (a.kf_t - p.kf_t).abs().max()))
    pos_err = float((a.lm_pos - p.lm_pos).abs().max())
    iters = (int(sa.iterations), int(spl.iterations))
    n_obs = (int(sa.total_obs), int(spl.total_obs))
    _require(iters[0] == iters[1] and n_obs[0] == n_obs[1]
             and pose_err <= LBA_TOL_POSE and pos_err <= LBA_TOL_POS,
             f"K3 matches its plain version: iterations {iters}, observations "
             f"{n_obs}, poses {pose_err}, positions {pos_err}")
    W, N = opts.window_size, ms.n_features
    restore_ms = _device_ms(restore)
    row = {"window": W, "features": N, "iterations": iters[0],
           "observations": n_obs[0], "max_pose_err": pose_err,
           "max_pos_err": pos_err, "restore_ms": restore_ms,
           "ms": _device_ms(k3) - restore_ms,
           "plain_ms": _device_ms(plain) - restore_ms,
           "host_ms": _time_ms(k3), "plain_host_ms": _time_ms(plain),
           "bytes": flops.k3_bytes(ms.kf_capacity, W, N),
           "ops": flops.k3_ops(W, N, iters[0])}
    print(f"K3 {json.dumps(row)} ({_card()})", flush=True)
    rec = _kernel_record("local_ba", "none: the JAX package leaves local BA to XLA",
                         row["bytes"], row["ops"], max(pose_err, pos_err),
                         row["ms"], row["plain_ms"], source="local_ba.cu")
    rec.update(build_s=build_s, window=row)
    return rec


# K4 against its plain version on the richest keyframe pair the hole scan
# triangulates: links, flags, counts and cursors exactly, new landmarks
# within TRI_TOL_POS of their distance from the first camera
# (tests/test_torch_tri_kernel.py gives the reasons)
TRI_TOL_POS = 1e-4


def check_tri(grays, depths) -> dict:
    """K4 against its plain version on the keyframe pair that makes the most
    landmarks of those the scan triangulates over the first 48 frames with
    the depth hole: every table
    but the positions equal, the new positions within ``TRI_TOL_POS``
    (relative), two K4 runs bit for bit; device times of K4 and of the plain
    version by CUDA events behind a spin kernel, the restore of the changed
    tables before each call timed alone and taken off, and the pace of
    back-to-back calls. Returns K4's result record."""
    import torch

    from visionx_slam_torch.tracking import scan_pipeline as sp
    from visionx_slam_torch.tracking import stages
    from visionx_slam_torch.utils import flops
    from visionx_slam_torch.utils.config import TrackingOptions

    cam = _camera()
    t0 = time.perf_counter()
    stages.build_tri_kernel()
    build_s = time.perf_counter() - t0
    g = torch.as_tensor(grays[:48]).cuda()
    d = torch.as_tensor(depths[:48]).cuda()
    d[:, :, :HOLE_COLS] = 0.0
    seen, real = [], stages.triangulate_pair

    def spy(ms, cam_, a, b, angle, gate, res=None):
        if res is not None:
            seen.append((type(ms)(*(x.clone() for x in ms)), a, b, res, angle, gate))
        return real(ms, cam_, a, b, angle, gate, res=res)

    stages.triangulate_pair = spy
    try:
        sp.run_scan_pipeline(cam, g, d, TrackingOptions(), device="cuda")
    finally:
        stages.triangulate_pair = real
    def made(pair) -> int:
        m, a_, b_, res_, angle_, gate_ = pair
        out = stages._triangulate_pair_plain(type(m)(*(x.clone() for x in m)),
                                             cam, a_, b_, angle_, gate_, res_)
        return int(out.next_lm) - int(m.next_lm)

    src, a, b, res, angle, gate = max(seen, key=made)
    ms = type(src)(*(x.clone() for x in src))
    changed = ("kf_feat_lm", "lm_pos", "lm_alive", "lm_obs", "next_lm", "lm_dropped")

    def restore():
        for name in changed:
            getattr(ms, name).copy_(getattr(src, name))

    def k4():
        restore()
        return stages.triangulate_pair(ms, cam, a, b, angle, gate, res=res)

    def plain():
        restore()
        return stages._triangulate_pair_plain(ms, cam, a, b, angle, gate, res)

    def kept(m):
        return type(m)(*(x.clone() for x in m))

    x, y, p = kept(k4()), kept(k4()), kept(plain())
    _require(all(torch.equal(u, v) for u, v in zip(x, y)), "K4 repeats bit for bit")
    same = all(torch.equal(getattr(x, f), getattr(p, f))
               for f in src._fields if f != "lm_pos")
    new = p.lm_alive & ~src.lm_alive
    centre = -stages.quat_rotate(torch.cat([src.kf_q[a, :1], -src.kf_q[a, 1:]]),
                                 src.kf_t[a])
    scale = torch.linalg.norm(p.lm_pos[:, new].T - centre, dim=-1).clamp(min=1.0)
    err = (x.lm_pos[:, new] - p.lm_pos[:, new]).abs().max(0).values / scale
    pos_err = float(err.max()) if err.numel() else 0.0
    made = int(p.next_lm) - int(src.next_lm)
    _require(same and pos_err <= TRI_TOL_POS and made > 0,
             f"K4 matches its plain version: tables {same}, positions {pos_err}, "
             f"{made} landmarks")
    N = ms.n_features
    restore_ms = _device_ms(restore)
    row = {"features": N, "created": made, "max_pos_err": pos_err,
           "restore_ms": restore_ms, "ms": _device_ms(k4) - restore_ms,
           "plain_ms": _device_ms(plain) - restore_ms,
           "host_ms": _time_ms(k4), "plain_host_ms": _time_ms(plain),
           "bytes": flops.k4_bytes(N), "ops": flops.k4_ops(N)}
    print(f"K4 {json.dumps(row)} ({_card()})", flush=True)
    rec = _kernel_record("triangulate", "none: the JAX package leaves triangulation to XLA",
                         row["bytes"], row["ops"], pos_err, row["ms"],
                         row["plain_ms"], source="triangulate.cu")
    rec.update(build_s=build_s, pair=row)
    return rec


def run_pipeline(grays, depths, gt_t) -> dict:
    """The port's main path, a warm-up run then a counted, timed run (with
    per-stage times: the stages synchronize at their ends); returns its
    metrics."""
    import numpy as np
    import torch

    from visionx_slam_torch.eval.trajectory import ate_of_run
    from visionx_slam_torch.models import estimation
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
    _zero_k34()
    estimation.gn_launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ms, out = run_offline_pipeline(cam, g, d, opts, device="cuda", timings=stage_s)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, k34 = detect.launches, _k34()

    T = len(grays)
    pose = out.pose.cpu().numpy()
    tracked = out.tracked.cpu().numpy()
    _require(pose.shape == (T, 4, 4) and bool(np.isfinite(pose).all()),
             f"poses of shape {pose.shape}, all finite")
    ate, n_tracked = ate_of_run(pose, tracked, gt_t)
    return {"frames": T, "seconds": wall, "fps": T / wall, "ate_m": ate,
            "tracked": n_tracked, "keyframes": int(out.n_keyframes),
            "landmarks": int(out.n_landmarks), "k1_launches": launches,
            "gn_launches": estimation.gn_launches, **k34,
            "stage_seconds": stage_s, "batched_matching": check_batched_matching(g),
            "_pose": pose, "_tracked": tracked}


def check_batched_matching(g) -> dict:
    """``match_frames_batched`` over 8 consecutive pairs of the frames'
    1024 ORB slots against the loop of single-pair ``match_frames``."""
    import torch

    from visionx_slam_torch.models import matching, orb_torch

    _, _, desc, fvalid = orb_torch.orb_extract(g[:9])
    batched = matching.match_frames_batched(desc[:8], fvalid[:8], desc[1:], fvalid[1:])
    loop = [matching.match_frames(desc[i], fvalid[i], desc[i + 1], fvalid[i + 1])
            for i in range(8)]
    equal = all(torch.equal(getattr(batched, f)[i], getattr(loop[i], f))
                for i in range(8) for f in batched._fields)
    return {"pairs": 8, "slots": int(desc.shape[1]),
            "matches": int(batched.valid.sum()), "equal_to_loop": equal}


# The JAX package's scan on the same inputs, on the CPU (TrackingOptions(),
# 1024 slots, kf_capacity 64, lm_capacity 1 << 17; PERF.md): 240 frames
# tracked 240/240 at ATE 4.4578 mm with 77 keyframe events; the sequence
# tiled five times (1200 frames, the bench's config 3) tracked 1200/1200 at
# ATE 16.2077 mm.
SCAN_ATE_JAX = 0.004458
SCAN_KF_JAX = 77
LONG_ATE_JAX = 0.016208
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
# The batched scan runs the first quarter of each window (half until PR 8):
# its checks compare the port with itself (lane against single run), and
# the 8 lanes plus the 8 single runs were the longest phase of the script
# before the bench phase came.
BSCAN_T = 30
LANES_ATE_JAX = (0.005571, 0.005413, 0.004859, 0.003390,
                 0.003650, 0.003943, 0.004718, 0.005709)
MONO_OFF_ATE_JAX = 0.357560
MONO_OFF_TRACKED_JAX = 234
MONO_SCAN_ATE_JAX = 0.022810       # median of the 8 draws
MONO_SCAN_TRACKED_JAX = 59.5
# The JAX package's config 2b with the loop closure on, on the CPU
# (tools/port_jax_references.py --configs 2b_loop 2b_merge): the scale
# re-anchoring alone, and with the landmark merge and the two-phase refine;
# tracked frames, ATE, the final map's keyframes and live landmarks. The
# merge kills 8.7% of the landmarks there (4909 -> 4482): the port's share
# is held within [1/2, 2] x that, which a run without the merge fails.
MONO_LOOP_PAIRS = 12
MONO_LOOP_ATE_JAX = 0.370938
MONO_LOOP_TRACKED_JAX = 235
MONO_LOOP_KEYFRAMES_JAX = 76
MONO_LOOP_LANDMARKS_JAX = 4909
MONO_MERGE_ATE_JAX = 0.371315
MONO_MERGE_TRACKED_JAX = 235
MONO_MERGE_KEYFRAMES_JAX = 76
MONO_MERGE_LANDMARKS_JAX = 4482
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
    from visionx_slam_torch.models import estimation
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
    _zero_k34()
    estimation.gn_launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ms_b, out = run_offline_pipeline_batched(cam, g, d, opts, device="cuda",
                                             timings=stage_s)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, k34 = detect.launches, _k34()
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
    return {"_inputs": (g, d), "_result": (ms_b, out),
            "lanes": LANES_B, "frames_per_lane": Tw, "kf_capacity": K,
            "seconds": wall, "aggregate_fps": LANES_B * Tw / wall,
            "tracked_frac": float(tracked.mean()), "lane_ate_m": ates,
            "ate_m_mean": float(np.mean(ates)), "ate_m_max": float(np.max(ates)),
            "lane_tracked": tracked.sum(1).tolist(),
            "keyframes": out.n_keyframes.tolist(),
            "landmarks": out.n_landmarks.tolist(), "k1_launches": launches,
            "gn_launches": estimation.gn_launches, **k34,
            "single_lane0_ate_m": one_ate, "single_lane0_tracked": one_tracked,
            "single_lane0_equal_bit_for_bit": bool(torch.equal(out.pose[0], one.pose)
                                                   and torch.equal(out.tracked[0], one.tracked)),
            "single_lane0_pose_gap": float((out.pose[0] - one.pose).abs().max()),
            "stage_seconds": stage_s}


def run_mono_offline(grays, gt_t) -> dict:
    """Config 2b: the loop tiled four times at stride 4 (240 frames), no
    depth, the monocular offline pipeline with the bench's budget; a
    warm-up run then a counted, timed run."""
    import numpy as np
    import torch

    from visionx_slam_torch.eval.trajectory import ate_of_run
    from visionx_slam_torch.models import estimation
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
    _zero_k34()
    estimation.gn_launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, out = run_offline_pipeline(cam, g, z, opts, device="cuda",
                                  timings=stage_s, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, k34 = detect.launches, _k34()
    pose, tracked = out.pose.cpu().numpy(), out.tracked.cpu().numpy()
    _require(pose.shape == (T, 4, 4) and bool(np.isfinite(pose).all()),
             f"mono poses of shape {pose.shape}, all finite")
    ate, n_tracked = ate_of_run(pose, tracked, gt, with_scale=True)
    return {"frames": T, "seconds": wall, "fps": T / wall,
            "ate_m_scale_aligned": ate, "tracked": n_tracked,
            "keyframes": int(out.n_keyframes),
            "landmarks": int(out.n_landmarks), "k1_launches": launches,
            "gn_launches": estimation.gn_launches, **k34,
            "stage_seconds": stage_s, "_pose": out.pose}


def _maps_equal(a, b) -> bool:
    import torch

    return all(torch.equal(getattr(a, f), getattr(b, f)) for f in a._fields)


def run_mono_loop(grays, gt_t, off_pose) -> dict:
    """Config 2b's input with the monocular loop closure: (i) the scale
    re-anchoring at revisits (``mono_loop_pairs=12``), (ii) also the
    landmark merge and the two-phase refine (``mono_loop_merge``), (iii)
    two folded lanes of (ii), the input and its reverse. Each a warm-up,
    then a counted, timed run; (ii) once more (equal bits) and once under
    CUDA's sync debug mode; the wide and the standard ``global_ba`` of
    (ii)'s refine timed by CUDA events on the map it refines; and the
    place descriptors of copied frames (the input repeats every 60 frames)
    checked to tie exactly."""
    import numpy as np
    import torch

    from visionx_slam_torch.eval.trajectory import ate_of_run
    from visionx_slam_torch.models.global_ba import global_ba
    from visionx_slam_torch.ops import detect
    from visionx_slam_torch.tracking import offline_pipeline as op
    from visionx_slam_torch.utils.config import TrackingOptions

    cam, opts = _camera(), TrackingOptions()
    g = torch.as_tensor(np.tile(grays, (4, 1, 1))[::4].copy()).cuda()
    gt = np.tile(gt_t, (4, 1))[::4]
    z = torch.zeros(g.shape, dtype=torch.float32, device="cuda")
    T = g.shape[0]
    K = op.default_lane_kf_capacity(T)
    kw = dict(monocular=True, kf_capacity=K, mono_loop_pairs=MONO_LOOP_PAIRS,
              **MONO_KW)
    merge = dict(kw, mono_loop_merge=True)
    g2 = torch.stack([g, g.flip(0)])
    z2 = torch.zeros(g2.shape, dtype=torch.float32, device="cuda")
    runs = {
        "scale": lambda **a: op.run_offline_pipeline(cam, g, z, opts, device="cuda",
                                                     **kw, **a),
        "merge": lambda **a: op.run_offline_pipeline(cam, g, z, opts, device="cuda",
                                                     **merge, **a),
        "folded": lambda **a: op.run_offline_pipeline_batched(
            cam, g2, z2, opts, device="cuda", **merge, **a)}
    res, results = {}, {}
    for name, fn in runs.items():
        fn()
        stage_s, stats = {}, {}
        detect.launches = 0
        _zero_k34()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ms, out = fn(timings=stage_s, stats=stats)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n = T * (2 if name == "folded" else 1)
        r = {"frames": n, "seconds": wall, "fps": n / wall,
             "k1_launches": detect.launches, **_k34(), "stage_seconds": stage_s,
             **stats,
             "keyframes": np.asarray(out.n_keyframes.cpu()).tolist(),
             "landmarks": np.asarray(out.n_landmarks.cpu()).tolist()}
        pose = out.pose.cpu().numpy()
        _require(bool(np.isfinite(pose).all()), f"mono loop {name}: finite poses")
        if name != "folded":
            r["ate_m_scale_aligned"], r["tracked"] = ate_of_run(
                pose, out.tracked.cpu().numpy(), gt, with_scale=True)
        results[name] = (ms, out)
        res[name] = r

    ms, out = results["scale"]
    res["scale"]["differs_from_plain_mono"] = not torch.equal(out.pose, off_pose)
    ms, out = results["merge"]
    ms2, out2 = runs["merge"]()
    res["merge"]["repeats_bit_for_bit"] = (torch.equal(out.pose, out2.pose)
                                           and torch.equal(out.tracked, out2.tracked)
                                           and _maps_equal(ms, ms2))
    flm, alive = ms.kf_feat_lm, ms.lm_alive
    live = flm[(flm >= 0) & ms.kf_fvalid & (ms.kf_id >= 0)[:, None]].long()
    res["merge"]["links_to_dead_landmarks"] = int((~alive[live]).sum())
    res["merge"]["lm_obs_is_link_count"] = bool(torch.equal(
        ms.lm_obs.long(), torch.bincount(live, minlength=ms.lm_obs.shape[0])))
    msb, outb = results["folded"]
    lane0 = op.MapState(*(x[0] for x in msb))
    res["folded"]["lane0_equals_merge_bit_for_bit"] = (
        torch.equal(outb.pose[0], out.pose) and torch.equal(outb.tracked[0], out.tracked)
        and all(torch.equal(getattr(lane0, f), getattr(ms, f))
                for f in ("kf_q", "kf_t", "kf_id", "kf_feat_lm", "lm_alive", "lm_obs"))
        # past the lane's landmarks its split table holds the next lane's
        and torch.equal(lane0.lm_pos[:, :int(ms.next_lm)], ms.lm_pos[:, :int(ms.next_lm)]))
    res["folded"]["lane0_pose_gap"] = float((outb.pose[0] - out.pose).abs().max())

    caught = _cuda_syncs(lambda: runs["merge"]())
    res["merge"]["cuda_syncs_per_run"] = len(caught)
    caught = _cuda_syncs(lambda: op.run_offline_pipeline(
        cam, g, z, opts, device="cuda", monocular=True, kf_capacity=K, **MONO_KW))
    res["merge"]["cuda_syncs_per_run_loop_off"] = len(caught)

    # the two refine phases of (ii) with the pipeline's own options, each
    # on the map it refines: the wide one on the merged map, the standard
    # one on the wide one's result
    run = op.build_offline_pipeline(opts, **merge)
    ms_pre, _, _ = run.pre(cam, g, z)
    ms_wide, _ = global_ba(ms_pre, cam, run.wide_gba_opts)
    res["merge"]["wide_gba_ms_per_solve"] = _median_ms(
        lambda: global_ba(ms_pre, cam, run.wide_gba_opts), reps=3)
    res["merge"]["gba_ms_per_solve"] = _median_ms(
        lambda: global_ba(ms_wide, cam, run.gba_opts), reps=3)

    # copies of a frame get equal place descriptors and equal similarities
    _, _, desc, valid = op.orb_extract(g[:120], n_slots=1024)
    H = op._place_descriptors(desc, valid)
    sim = op._block_similarity(H, 1)[0]
    res["copies_tie_exactly"] = bool(torch.equal(H[:60], H[60:])
                                     and torch.equal(sim[:, :60], sim[:, 60:]))
    return res


def run_mono_scan(grays, gt_t) -> dict:
    """Config 2: the scan over 60 frames at stride 4, no depth, with the
    monocular option set (keyframes inherit tracked landmarks, the init
    needs 25 triangulable points)."""
    import numpy as np
    import torch

    from visionx_slam_torch.eval.trajectory import ate_of_run
    from visionx_slam_torch.models import estimation
    from visionx_slam_torch.ops import detect
    from visionx_slam_torch.tracking.scan_pipeline import run_scan_pipeline
    from visionx_slam_torch.utils.config import TrackingOptions

    g = torch.as_tensor(grays[::4].copy()).cuda()
    gt = gt_t[::4]
    z = torch.zeros(g.shape, dtype=torch.float32, device="cuda")
    opts = TrackingOptions(link_tracked_landmarks=True, min_init_landmarks=25)
    stats: dict = {}
    detect.launches = 0
    _zero_k34()
    estimation.gn_launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, out = run_scan_pipeline(_camera(), g, z, opts, device="cuda", stats=stats)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k34 = _k34()
    pose, tracked = out.pose.cpu().numpy(), out.tracked.cpu().numpy()
    _require(pose.shape == (len(gt), 4, 4) and bool(np.isfinite(pose).all()),
             f"mono scan poses of shape {pose.shape}, all finite")
    ate, n_tracked = ate_of_run(pose, tracked, gt, with_scale=True)
    return {"frames": len(gt), "seconds": wall, "fps": len(gt) / wall,
            "ate_m_scale_aligned": ate, "tracked": n_tracked,
            "first_tracked": int(np.flatnonzero(tracked)[0]) if tracked.any() else None,
            "keyframe_events": int(out.is_keyframe.sum()),
            "landmarks": int(out.n_landmarks[-1]), "k1_launches": detect.launches,
            "gn_launches": estimation.gn_launches, **k34, **stats}


# The JAX package's scan with ``enable_culling=True`` on the 240 frames, on
# the CPU (tools/port_jax_references.py --configs cull): with the default
# options every depth landmark (one observation) is culled at the first
# keyframe event, tracking fails and the map is rebuilt from the identity,
# over and over: 174/240 tracked at ATE 0.38595 m, 67 keyframe flags, a
# final map of 2 keyframes and 2,000 landmarks, no keyframe removed by
# culling. The port is held to that behaviour class.
CULL_TRACKED_JAX = 174
CULL_ATE_JAX = 0.385955
CULL_KF_JAX = 67
CULL_FINAL_KF_JAX = 2
CULL_FINAL_LM_JAX = 2000
CULL_KF_REMOVED_JAX = 0
# The same with options that keep the map healthy (--configs cull_keep: one
# observation keeps a landmark and makes it shared, at most 8 keyframes):
# 240/240 tracked at ATE 4.4578 mm, 77 keyframe flags, a final map of 3
# keyframes and 3,000 landmarks, 61 of the last 64 inserted keyframes
# removed (one goes at nearly every keyframe event).
CULL_KEEP = dict(min_landmark_observations=1, kf_min_shared_observations=1,
                 max_keyframes=8)
CULL_KEEP_TRACKED_JAX = 240
CULL_KEEP_ATE_JAX = 0.004458
CULL_KEEP_KF_JAX = 77
CULL_KEEP_FINAL_KF_JAX = 3
CULL_KEEP_FINAL_LM_JAX = 3000
CULL_KEEP_KF_REMOVED_JAX = 61
GBA_ITERS, GBA_CG = 2, 12     # bench.py config 4

# The long-stress tool and the degradation matrix of the JAX package, on
# the CPU (``JAX_PLATFORMS=cpu python3 tools/port_jax_references.py
# --configs long_stress degrade``, PERF.md, PR 10). Stress: the 240-frame
# loop tiled 9 times, TrackingOptions(), 64 keyframe slots, 1 << 17
# landmarks: 2160/2160 tracked at ATE 28.7953 mm, 693 keyframe events,
# landmarks peak 129,000 and final 109,000, lm_dropped 0; split at frame
# 1200: the largest pose difference from the single run 0.0. The three
# sizes are the ones that tool fixes under the same names.
STRESS_FRAMES = 2160
STRESS_SPLIT = 1200
LONG_STRESS_ATE_JAX = 0.028795
# Degradation: the scan over the first 120 frames, each row (name, tracked
# share, rigid ATE in m) with np.random.default_rng(7).
DEGRADE_FRAMES = 120
DEGRADE_JAX = (
    ("clean", 1.0, 0.004449),
    ("depth_quantized", 1.0, 0.004449),
    ("depth_holes", 1.0, 0.005275),
    ("depth_noise", 1.0, 0.005151),
    ("exposure_jitter", 1.0, 0.005689),
    ("motion_blur", 1.0, 0.005419),
    ("all_combined", 1.0, 0.005840),
)


def _scan(cam, g, d, stats=None, st0=None, frame0=0, opts=None):
    from visionx_slam_torch.tracking.scan_pipeline import run_scan_pipeline
    from visionx_slam_torch.utils.config import TrackingOptions

    return run_scan_pipeline(cam, g, d, opts or TrackingOptions(), st0=st0,
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


def _cuda_syncs(fn) -> list:
    """The warnings of CUDA's sync debug mode over one call of ``fn``: one
    per synchronizing call."""
    import warnings

    import torch

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return caught


def run_scan(grays, depths, gt_t) -> dict:
    """The online scan: a warm-up run, a counted and timed run, an 8-frame
    streamed run for per-frame latency, and a run with CUDA's sync debug
    mode on that counts every synchronizing call of the loop."""
    import numpy as np
    import torch

    from visionx_slam_torch.models import estimation, local_ba
    from visionx_slam_torch.ops import detect
    from visionx_slam_torch.tracking import scan_pipeline as SP
    from visionx_slam_torch.tracking import stages

    cam = _camera()
    g = torch.as_tensor(grays).cuda()
    d = torch.as_tensor(depths).cuda()
    T = len(grays)
    _scan(cam, g, d)

    stats: dict = {}
    detect.launches = 0
    estimation.gn_launches = 0
    local_ba.lba_launches = 0
    stages.tri_launches = 0
    detect.score_launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, out = _scan(cam, g, d, stats)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    res = {"frames": T, "seconds": wall, "fps": T / wall,
           "k1_launches": detect.launches, "k1b_launches": detect.score_launches,
           "gn_launches": estimation.gn_launches,
           "lba_launches": local_ba.lba_launches,
           "tri_launches": stages.tri_launches,
           **_scan_metrics(out, gt_t), **stats}
    # kept for the resume phase's comparison; not printed
    res["_positions"] = out.pose[:, :3, 3].cpu().numpy()
    res["_tracked"] = out.tracked.cpu().numpy()
    res["host_syncs_per_frame"] = stats["host_syncs"] / T
    res["ba_iterations_per_kf_event"] = (stats["ba_iterations"]
                                         / max(stats["kf_events"], 1))
    # the steady tracked frame's graph: replayed in every frame that took
    # the GOOD branch, captured in the warm-up run
    res["good_branch_frames"] = int((out.state[:-1] == 1).sum())
    res["track_graph_pool_bytes"] = sum(
        g.pool_bytes for g in SP._TRACK_GRAPHS.values())

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
    caught = _cuda_syncs(lambda: _scan(cam, g, d))
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

    from visionx_slam_torch.models import local_ba as lba
    from visionx_slam_torch.models.local_ba import BAOptions, local_ba
    from visionx_slam_torch.ops import detect
    from visionx_slam_torch.tracking import stages

    cam = _camera()
    g = torch.as_tensor(grays).cuda()
    d = torch.as_tensor(depths).cuda()
    d[:, :, :HOLE_COLS] = 0.0
    stats: dict = {}
    detect.launches = 0
    lba.lba_launches = 0
    stages.tri_launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st, out = _scan(cam, g, d, stats)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    res = {"frames": len(grays), "seconds": wall, "fps": len(grays) / wall,
           "k1_launches": detect.launches, "lba_launches": lba.lba_launches,
           "tri_launches": stages.tri_launches,
           **_scan_metrics(out, gt_t), **stats}
    res["ba_iterations_per_kf_event"] = (stats["ba_iterations"]
                                         / max(stats["kf_events"], 1))
    # the solver sums add in a fixed order: local BA on the final map, and
    # the whole scan, repeat bit for bit
    ba = [local_ba(type(st.ms)(*(x.clone() for x in st.ms)), cam, BAOptions())
          for _ in range(2)]
    res["local_ba_repeats_bit_for_bit"] = (
        all(torch.equal(a, b) for a, b in zip(ba[0][0], ba[1][0]))
        and torch.equal(ba[0][1].final_cost, ba[1][1].final_cost))
    res["local_ba_iterations"] = int(ba[0][1].iterations)
    st2, out2 = _scan(cam, g, d)
    res["scan_repeats_bit_for_bit"] = (
        all(torch.equal(a, b) for a, b in zip(out, out2))
        and all(torch.equal(a, b) for a, b in zip(st.ms, st2.ms)))
    return res


# the hole cell's System pass: the benchmark's own feed at the cell's
# configuration (fr1/desk's camera and speeds, the hole model, tracking
# against the local map), its first HOLE_SYSTEM_FRAMES frames, one pass
HOLE_SYSTEM_CELL = "rgbd.system_disk_holes"
HOLE_SYSTEM_FRAMES = 240
HOLE_SYSTEM_SEED = 3200000105


def run_system_holes(device="cuda") -> dict:
    """``System --pipeline scan --run_global_ba`` over TUM files written
    with the hole model, through the benchmark cell's feed and judged by
    its reference: the keyframe events, ``System``'s counts of local BA
    iterations, triangulated landmarks and local-map matches, the steady
    tracked frames replayed as the scan's graph and the graphs captured, the
    share of events whose local BA iterated (one read a call, here only),
    K3's and K4's launches, and the reference's numbers against the cell's
    limits."""
    from slambench import feeds
    from slambench import run as harness
    from visionx_slam_torch.tracking import scan_pipeline as SP

    spec = harness.load_cell(HOLE_SYSTEM_CELL)
    traffic = dict(spec["traffic"], frames=HOLE_SYSTEM_FRAMES)
    feed = feeds.load(traffic["feed"])(spec["config"], traffic,
                                       HOLE_SYSTEM_SEED, device)
    feed.write()
    iterated = []
    real = SP.local_ba

    def spy(ms, cam, opts):
        out = real(ms, cam, opts)
        iterated.append(int(out[1].iterations) > 0)
        return out

    timings: dict = {}
    _zero_k34()
    SP.local_ba = spy
    try:
        t0 = time.perf_counter()
        summary, path = feed.one_pass(timings)
        wall = time.perf_counter() - t0
    finally:
        SP.local_ba = real
    res = {"frames": HOLE_SYSTEM_FRAMES, "seconds": wall,
           **{k: timings[k] for k in ("#kf_events", "#lba_iterations",
                                      "#tri_landmarks", "#localmap_matches",
                                      "#track_graph", "#track_graph_captures")},
           "events_iterated": sum(iterated), "tracked": summary["n_tracked"],
           "archived_keyframes": summary["global_ba"].get("archived_keyframes"),
           **_k34()}
    feed.outs = [(summary, path)]
    judged = feed.judge()
    res["checks"] = {k: [judged[k], lim["limit"]] for k, lim in spec["limits"].items()}
    return res


# the host cell's System pass: the same files and frames through System's
# default pipeline, the host Tracker with the local map
HOST_HOLE_CELL = "rgbd.system_host_holes"


def run_system_host_holes(device="cuda") -> dict:
    """``System --run_global_ba`` with its default pipeline, ``host``, over
    the host cell's feed at the hole phase's frames and seed: the keyframe
    events and the keyframes inserted, ``System``'s counts of local BA
    iterations, triangulated landmarks and local-map matches, the Tracker's
    reads a frame, the keyframes archived from its ring, the share of
    events whose local BA iterated (one read a call, here only), K3's and
    K4's launches, and the reference's numbers against the cell's
    limits."""
    from slambench import feeds
    from slambench import run as harness
    from visionx_slam_torch.tracking import frontend

    spec = harness.load_cell(HOST_HOLE_CELL)
    traffic = dict(spec["traffic"], frames=HOLE_SYSTEM_FRAMES)
    feed = feeds.load(traffic["feed"])(spec["config"], traffic,
                                       HOLE_SYSTEM_SEED, device)
    feed.write()
    timings: dict = {}
    systems, iterated = [], []
    real = frontend.local_ba

    def spy(ms, cam, opts):
        out = real(ms, cam, opts)
        iterated.append(int(out[1].iterations) > 0)
        return out

    _zero_k34()
    frontend.local_ba = spy
    try:
        t0 = time.perf_counter()
        summary, path = feed.one_pass(timings, before=systems.append)
        wall = time.perf_counter() - t0
    finally:
        frontend.local_ba = real
    res = {"frames": HOLE_SYSTEM_FRAMES, "seconds": wall,
           "events_iterated": sum(iterated),
           **{k: timings[k] for k in ("#kf_events", "#lba_iterations",
                                      "#tri_landmarks", "#localmap_matches")},
           "keyframes_inserted": systems[0].tracker.kf_inserted,
           "resets": systems[0].tracker.resets,
           "tracked": summary["n_tracked"],
           "archived_keyframes": summary["global_ba"].get("archived_keyframes"),
           "host_reads_per_frame": summary["host_reads_per_frame"],
           "host_syncs_per_frame": timings["#host_syncs"] / HOLE_SYSTEM_FRAMES,
           **_k34()}
    feed.outs = [(summary, path)]
    judged = feed.judge()
    res["checks"] = {k: [judged[k], lim["limit"]] for k, lim in spec["limits"].items()}
    return res


def run_stress(grays, depths, gt_t) -> dict:
    """The long-stress tool over the sequence tiled to ``STRESS_FRAMES``
    frames on the card, then split at ``STRESS_SPLIT`` (see the module
    docstring of ``visionx_slam_torch.tools.long_stress``)."""
    import torch

    from visionx_slam_torch.tools import long_stress
    from visionx_slam_torch.utils.config import TrackingOptions

    reps = -(-STRESS_FRAMES // len(grays))
    r = long_stress.stress(_camera(), grays, depths, gt_t, reps, STRESS_SPLIT,
                           TrackingOptions(), "cuda")
    # the 3.3 GB of tiled frames and the runs' outputs are gone with the
    # function's frame; hand their blocks back before the next phase
    torch.cuda.empty_cache()
    return r


def check_stress(r: dict, T0: int) -> None:
    """PERF.md Section 2's limits of the stress phase."""
    T, s = r["frames"], r["split"]
    _require(r["tracked"] >= 0.99 * T and r["lm_dropped"] == 0 and r["ok"],
             f"stress gate: tracked {r['tracked']}/{T}, lm_dropped {r['lm_dropped']}")
    _require(r["keyframe_events"] > 64, "the keyframe ring wrapped")
    _require(r["compactions"] >= 1, "landmark compaction ran")
    _require(s["max_pose_diff"] < s["bound"],
             f"the split at {s['at']} within {s['bound']} of the single run: "
             f"{s['max_pose_diff']}")
    _require(r["k1_launches"] == -(-T // 8)
             and s["k1_launches"] == [-(-s["at"] // 8), -(-(T - s["at"]) // 8)],
             f"K1 once per 8-frame chunk of each call: {r['k1_launches']}, "
             f"{s['k1_launches']}")
    if T0 == 240:
        _require(T == STRESS_FRAMES and r["ate_m"] is not None
                 and r["ate_m"] <= 2 * LONG_STRESS_ATE_JAX,
                 f"stress ATE {r['ate_m']} m <= 2 x {LONG_STRESS_ATE_JAX} m")


def run_degradation(grays, depths, gt_t) -> list:
    """The sensor-degradation matrix of the real-data tool over the first
    ``DEGRADE_FRAMES`` frames."""
    from visionx_slam_torch.tools import real_data_check
    from visionx_slam_torch.utils.config import TrackingOptions

    n = DEGRADE_FRAMES
    return real_data_check.degradation_matrix(
        _camera(), grays[:n], depths[:n], gt_t[:n], TrackingOptions(), "cuda")


def check_degradation(rows: list) -> float:
    """Every row in the JAX tool's band, K1 once per 8 frames; at the bench
    input, every row within 0.05 of the JAX row's tracked share and at most
    max(2 x its ATE, 20 mm). Returns the band's ATE bound."""
    from visionx_slam_torch.tools import real_data_check

    ok, band = real_data_check.in_band(rows)
    _require(ok, f"every degradation row in the band (ATE <= {band} m): {rows}")
    for r in rows:
        _require(r["k1_launches"] == -(-r["frames"] // 8),
                 f"{r['name']}: {r['k1_launches']} K1 launches")
    if rows[0]["frames"] == DEGRADE_FRAMES:     # the JAX rows' input
        _require([r["name"] for r in rows] == [n for n, _, _ in DEGRADE_JAX],
                 "the rows in the JAX tool's order")
        for r, (name, share, ate) in zip(rows, DEGRADE_JAX):
            _require(abs(r["tracked_share"] - share) <= 0.05
                     and r["ate_m"] <= max(2 * ate, 0.020),
                     f"{name}: tracked {r['tracked_share']} vs JAX {share}, ATE "
                     f"{r['ate_m']} m vs JAX {ate} m")
    return band


def run_real_data(root: str) -> dict:
    """The real-data tool's ``--dataset_dir`` mode over the TUM-layout
    directory the system phase wrote, through the scan, ``DEGRADE_FRAMES``
    frames."""
    from visionx_slam_torch.ops import detect
    from visionx_slam_torch.tools import real_data_check

    detect.launches = 0
    _zero_k34()
    t0 = time.perf_counter()
    s = real_data_check.run_real(root, SEQUENCE, os.path.join(root, "out_real"),
                                 "scan", DEGRADE_FRAMES, "cuda")
    return {"seconds": time.perf_counter() - t0, "k1_launches": detect.launches,
            **_k34(),
            **{k: s.get(k) for k in ("n_frames", "n_tracked", "ate_rmse",
                                     "rpe_trans_rmse", "n_keyframes", "n_landmarks",
                                     "loader", "device", "scan_fps")}}


def check_real_data(real: dict, clean: dict) -> None:
    """On the card, >= 95% tracked, ATE <= 2 x the in-memory scan's over the
    same frames (the degradation phase's clean row), the loader named, K1
    once per 8 frames."""
    _require(real["device"] == "cuda" and real["n_frames"] == DEGRADE_FRAMES
             and real["n_tracked"] >= 0.95 * DEGRADE_FRAMES,
             f"real data: tracked {real['n_tracked']}/{real['n_frames']} on the card")
    _require(real["ate_rmse"] <= 2 * clean["ate_m"],
             f"real data ATE {real['ate_rmse']} m <= 2 x the in-memory scan's "
             f"{clean['ate_m']} m over the same frames")
    _require(real["loader"] in ("native", "python")
             and real["k1_launches"] == -(-DEGRADE_FRAMES // 8),
             f"real data: loader {real['loader']}, {real['k1_launches']} K1 launches")


def _median_ms(fn, reps: int = 7) -> float:
    """Median over ``reps`` warm calls of ``fn``, each timed by CUDA events."""
    import statistics

    import torch

    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def time_segment_sum(ms) -> dict:
    """The cost of fixed-order sums: the map's K*N observations (each to its
    landmark, rows without one to the spare row) summed per landmark over
    12 float32 columns, global BA's Hll/bl table. Two bare ops timed by
    CUDA events in the same call: ``index_add_`` (atomics, what the solvers
    used before) and ``segment_sum`` over the segments sorted once (what
    they use now; ``segments`` itself runs once per solve). The segment sum
    is held to ``index_add_`` on the CPU bit for bit."""
    import torch

    from visionx_slam_torch.ops.index import segment_sum, segments

    L = ms.lm_physical
    has = (ms.kf_id >= 0)[:, None] & ms.kf_fvalid & (ms.kf_feat_lm >= 0)
    seg = torch.where(has, ms.kf_feat_lm.long(), L).reshape(-1)
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn((seg.numel(), 12), generator=gen, device="cuda")
    segs = segments(seg, L)
    atomic = lambda: torch.zeros((L + 1, 12), device="cuda").index_add_(0, seg, x)
    fixed = lambda: segment_sum(x, segs)
    out = fixed()
    first = atomic()
    return {
        "rows": seg.numel(), "segments": L,
        "segments_over_one_row": int((segs.lengths > 1).sum()),
        "equals_cpu_index_add_bit_for_bit": torch.equal(
            out.cpu(), torch.zeros((L + 1, 12)).index_add_(0, seg.cpu(), x.cpu())[:L]),
        "repeats_bit_for_bit": all(torch.equal(fixed(), out) for _ in range(4)),
        "index_add_runs_differing": sum(not torch.equal(atomic(), first)
                                        for _ in range(4)),
        "index_add_ms": _time_ms(atomic), "segment_sum_ms": _time_ms(fixed),
        "segments_ms": _time_ms(lambda: segments(seg, L))}


def run_gba(grays, depths) -> dict:
    """Config 4: the offline ``pre`` stage's K=128 map and its links, then
    ``pair_ba`` and ``global_ba`` (2 GN iterations of 12 CG steps), ms per
    solve. On the bench input every feature has depth and creates its own
    landmark, so no landmark has two views and the solves have nothing to
    move. The second map ("dropout") has thousands: the loop tiled four
    times at stride 4 (240 frames at four times the camera speed, config
    2b's frames, so that two-view landmarks have a baseline that
    conditions their depth) with 40% of the depth pixels dropped at
    random; there the solves must lower the reprojection error."""
    import numpy as np
    import torch

    from visionx_slam_torch.models.global_ba import (
        GlobalBAOptions,
        global_ba,
        map_reproj_error,
    )
    from visionx_slam_torch.models.pair_ba import pair_ba
    from visionx_slam_torch.ops import detect
    from visionx_slam_torch.tracking import mapstate as msl
    from visionx_slam_torch.tracking.offline_pipeline import build_offline_pipeline
    from visionx_slam_torch.utils.config import TrackingOptions

    cam = _camera()
    run = build_offline_pipeline(TrackingOptions())
    opts = GlobalBAOptions(max_iterations=GBA_ITERS, cg_iterations=GBA_CG)
    keep = np.random.default_rng(2).random(depths.shape) > 0.4
    fast = lambda x: np.tile(x, (4, 1, 1))[::4].copy()
    res = {"gn_iterations": GBA_ITERS, "cg_iterations": GBA_CG}
    detect.launches = 0
    _zero_k34()
    for name, g, d in (("bench", grays, depths),
                       ("dropout", fast(grays), fast(depths) * keep)):
        ms, links, _ = run.pre(cam, torch.as_tensor(g).cuda(),
                               torch.as_tensor(d).cuda())
        err0 = float(map_reproj_error(ms, cam)[0])
        ms_p, st_p = pair_ba(ms, cam, links, opts)
        ms_g, st_g = global_ba(ms, cam, opts)
        ms_p2, _ = pair_ba(ms, cam, links, opts)
        ms_g2, st_g2 = global_ba(ms, cam, opts)
        lm_gap = (ms_p.lm_pos - ms_g.lm_pos)[:, ms.lm_alive].abs().amax(0)
        res[name] = {
            "keyframes": int(msl.n_keyframes(ms)),
            "landmarks": int(msl.n_landmarks(ms)),
            "two_view_landmarks": int((links.adopter >= 0).sum()),
            "total_obs": int(st_p.total_obs),
            "total_obs_global": int(st_g.total_obs),
            "mean_reproj_before_px": err0,
            "mean_reproj_pair_px": float(map_reproj_error(ms_p, cam)[0]),
            "mean_reproj_global_px": float(map_reproj_error(ms_g, cam)[0]),
            "pose_gap_t": float((ms_p.kf_t - ms_g.kf_t).abs().max()),
            "pose_gap_q": float((ms_p.kf_q - ms_g.kf_q).abs().max()),
            "landmark_gap_p99": float(torch.quantile(lm_gap, 0.99)),
            "landmark_gap_max": float(lm_gap.max()),
            "landmarks_over_gap": int((lm_gap > 5e-3).sum()),
            "moved_t": float((ms_p.kf_t - ms.kf_t).abs().max()),
            "pair_ba_repeats_bit_for_bit": all(
                torch.equal(getattr(ms_p, f), getattr(ms_p2, f))
                for f in ("kf_q", "kf_t", "lm_pos")),
            "global_ba_repeats_bit_for_bit": all(
                torch.equal(getattr(ms_g, f), getattr(ms_g2, f))
                for f in ("kf_q", "kf_t", "lm_pos"))
            and torch.equal(st_g.final_cost, st_g2.final_cost),
            "segment_sum": time_segment_sum(ms),
            "pair_ba_ms_per_solve": _median_ms(lambda: pair_ba(ms, cam, links, opts)),
            "global_ba_ms_per_solve": _median_ms(lambda: global_ba(ms, cam, opts)),
        }
    res["k1_launches"] = detect.launches
    res.update(_k34())
    return res


def run_archive(grays, depths, gt_t) -> dict:
    """The scan in 64-frame chunks with the keyframe archive harvested at
    each boundary, then the full-map global BA over the union of every
    keyframe the scan made."""
    import torch

    from visionx_slam_torch.ops import detect
    from visionx_slam_torch.system.system import run_scan_archived
    from visionx_slam_torch.tracking import mapstate as msl
    from visionx_slam_torch.utils.config import TrackingOptions

    stats: dict = {}
    detect.launches = 0
    _zero_k34()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st, out, archive, gba = run_scan_archived(
        _camera(), grays, depths, TrackingOptions(), device="cuda", stats=stats)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    gba = {k: v for k, v in gba.items() if k not in ("keyframe_poses", "keyframe_ids")}
    return {"frames": len(grays), "seconds": wall, "fps": len(grays) / wall,
            "k1_launches": detect.launches, **_k34(), **_scan_metrics(out, gt_t),
            "archived": len(archive), "union_keyframes": int(msl.n_keyframes(st.ms)),
            "union_slots": st.ms.kf_capacity,
            "union_landmarks": int(msl.n_landmarks(st.ms)), "gba": gba, **stats}


def run_resume(grays, depths, gt_t, full_positions, full_tracked) -> dict:
    """Scan the first half, write a snapshot npz, load it, resume, scan the
    second half; against the uninterrupted scan's positions."""
    import os
    import tempfile

    import numpy as np
    import torch

    from visionx_slam_torch.ops import detect
    from visionx_slam_torch.system.system import load_snapshot_full, save_snapshot
    from visionx_slam_torch.tracking.scan_pipeline import resume_state

    cam = _camera()
    g = torch.as_tensor(grays).cuda()
    d = torch.as_tensor(depths).cuda()
    cut = len(grays) // 2
    detect.launches = 0
    st, _ = _scan(cam, g[:cut], d[:cut])
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "map_snapshot.npz")
        t0 = time.perf_counter()
        save_snapshot(path, st.ms, cut)
        save_s = time.perf_counter() - t0
        size = os.path.getsize(path)
        t0 = time.perf_counter()
        ms, meta = load_snapshot_full(path, device="cuda")
        load_s = time.perf_counter() - t0
    same = all(torch.equal(a, b) for a, b in zip(ms, st.ms))
    del st
    stats: dict = {}
    _zero_k34()   # K3 and K4 of the resumed half, which ``stats`` counts
    _, out = _scan(cam, g[cut:], d[cut:], stats, st0=resume_state(ms),
                   frame0=meta["next_frame_id"])
    tracked = out.tracked.cpu().numpy()
    both = tracked & full_tracked[cut:]
    gap = np.abs(out.pose[:, :3, 3].cpu().numpy() - full_positions[cut:])[both]
    return {"frames_resumed": len(tracked), "next_frame_id": meta["next_frame_id"],
            "snapshot_bytes": size, "save_seconds": save_s, "load_seconds": load_s,
            "snapshot_round_trip_equal": same, "tracked": int(tracked.sum()),
            "first_tracked": bool(tracked[0]),
            "max_position_gap_m": float(gap.max()) if gap.size else None,
            "k1_launches": detect.launches, **_k34(),
            **_scan_metrics(out, gt_t[cut:]), **stats}


def run_culling(grays, depths, gt_t, **cull_opts) -> dict:
    """The scan with ``enable_culling=True`` and the given culling options,
    then once more under CUDA's sync debug mode."""
    import torch

    from visionx_slam_torch.ops import detect
    from visionx_slam_torch.tracking import mapstate as msl
    from visionx_slam_torch.utils.config import TrackingOptions

    stats: dict = {}
    cam, opts = _camera(), TrackingOptions(enable_culling=True, **cull_opts)
    g = torch.as_tensor(grays).cuda()
    d = torch.as_tensor(depths).cuda()
    detect.launches = 0
    _zero_k34()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st, out = _scan(cam, g, d, stats, opts=opts)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, k34 = detect.launches, _k34()
    T = len(grays)
    n_syncs = len(_cuda_syncs(lambda: _scan(cam, g, d, opts=opts)))
    return {"frames": T, "seconds": wall, "fps": T / wall,
            "cuda_syncs_per_frame": n_syncs / T,
            "k1_launches": launches, **k34, **_scan_metrics(out, gt_t),
            "final_keyframes": int(msl.n_keyframes(st.ms)),
            "host_syncs_per_frame": stats["host_syncs"] / T, **stats}


def run_batched_scan(grays, depths, gt_t) -> dict:
    """The batched scan over the first ``BSCAN_T`` frames of config 5's 8
    staggered windows (a warm-up run, then a counted, timed run), and the 8
    windows as single runs one after the other in the same call."""
    import numpy as np
    import torch

    from visionx_slam_torch.eval.trajectory import ate_of_run
    from visionx_slam_torch.ops import detect
    from visionx_slam_torch.tracking.scan_pipeline import run_scan_pipeline_batched
    from visionx_slam_torch.utils.config import TrackingOptions

    cam, opts = _camera(), TrackingOptions()
    T = len(grays)
    starts = [(k * T) // LANES_B for k in range(LANES_B)]
    Tw = min(BSCAN_T, T)
    g2, d2, gt2 = (np.concatenate([x, x]) for x in (grays, depths, gt_t))
    g = torch.as_tensor(np.stack([g2[s:s + Tw] for s in starts])).cuda()
    d = torch.as_tensor(np.stack([d2[s:s + Tw] for s in starts])).cuda()
    run_scan_pipeline_batched(cam, g[:, :16], d[:, :16], opts, device="cuda")

    stats: dict = {}
    detect.launches = 0
    _zero_k34()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, out = run_scan_pipeline_batched(cam, g, d, opts, device="cuda", stats=stats)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, k34 = detect.launches, _k34()
    pose, tracked = out.pose.cpu().numpy(), out.tracked.cpu().numpy()
    _require(pose.shape == (Tw, LANES_B, 4, 4) and bool(np.isfinite(pose).all()),
             f"batched scan poses of shape {pose.shape}, all finite")
    ates = [ate_of_run(pose[:, b], tracked[:, b], gt2[s:s + Tw])[0]
            for b, s in enumerate(starts)]

    singles = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for b in range(LANES_B):
        singles.append(_scan(cam, g[b], d[b])[1])
    torch.cuda.synchronize()
    wall_single = time.perf_counter() - t0
    one_ate, one_tracked = ate_of_run(singles[0].pose.cpu().numpy(),
                                      singles[0].tracked.cpu().numpy(), gt2[:Tw])
    lanes_equal = [bool(torch.equal(out.pose[:, b], singles[b].pose))
                   for b in range(LANES_B)]
    return {"lanes": LANES_B, "frames_per_lane": Tw, "seconds": wall,
            "aggregate_fps": LANES_B * Tw / wall,
            "single_runs_seconds": wall_single,
            "single_runs_fps": LANES_B * Tw / wall_single,
            "extract_seconds": stats["extract_seconds"],
            "tracked_frac": float(tracked.mean()), "lane_ate_m": ates,
            "lane_tracked": tracked.sum(0).tolist(),
            "keyframe_events": out.is_keyframe.sum(0).tolist(),
            "k1_launches": launches, **k34, "single_lane0_ate_m": one_ate,
            "single_lane0_tracked": one_tracked,
            "lanes_equal_single_runs_bit_for_bit": lanes_equal,
            "host_syncs_per_frame": stats["host_syncs"] / (LANES_B * Tw)}


# The JAX package's ``System`` on ``--pipeline host`` with ``extractor=jax``
# over the same 240-frame sequence on disk, on the CPU
# (tools/port_jax_references.py --configs host): 240/240 tracked at ATE
# 4.4006 mm, 76 keyframe flags, a final map of 64 keyframes (the full ring)
# and 78,000 landmarks.
HOST_TRACKED_JAX = 240
HOST_ATE_JAX = 0.004401
HOST_KF_JAX = 76
HOST_FINAL_KF_JAX = 64
HOST_FINAL_LM_JAX = 78000
SEQUENCE = "rgbd_dataset_freiburg3_synthetic"


def host_environment() -> dict:
    """What the host around the card has for the loaders and the plotter,
    and whether the native decode library builds there."""
    import importlib.util
    import shutil

    from visionx_slam_torch.data import native_loader

    env = {tool: shutil.which(tool) is not None for tool in ("make", "g++")}
    env["png.h"] = any(os.path.isfile(os.path.join(d, "png.h")) for d in
                       ("/usr/include", "/usr/local/include",
                        "/usr/include/libpng16", "/usr/include/x86_64-linux-gnu"))
    for mod in ("scipy", "PIL", "matplotlib", "cv2", "jax"):
        env[mod] = importlib.util.find_spec(mod) is not None
    env["native_loader_built"] = native_loader.available()
    return env


def _cli(dataset_dir: str, out: str, *flags: str, keep_poses: bool = False) -> dict:
    """One call of the port's command line; returns metrics.json, with the
    K1 launches of the call and its wall seconds. ``keep_poses``: run the
    command line's ``System`` directly on its parsed flags and add its
    per-frame poses and tracked flags (``_pose``, ``_tracked``)."""
    import numpy as np
    import torch

    from visionx_slam_torch.cli.main import entrypoint, parse_config
    from visionx_slam_torch.ops import detect
    from visionx_slam_torch.system.system import System

    argv = ["--dataset_dir", dataset_dir, "--sequence", SEQUENCE,
            "--output_dir", out, *flags]
    detect.launches = 0
    _zero_k34()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if keep_poses:
        system = System(parse_config(argv))
        system.run()
    else:
        rc = entrypoint(argv)
        _require(rc == 0, f"the command line returned {rc}")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for name in ("trajectory.txt", "metrics.json", "map_snapshot.npz", "map.ply"):
        _require(os.path.isfile(os.path.join(out, name)), f"{out} holds {name}")
    with open(os.path.join(out, "metrics.json")) as f:
        metrics = json.load(f)
    if not os.path.isfile(os.path.join(out, "frames.jsonl")):
        # the offline pipeline writes none, in either package
        _require("offline" in flags, f"{out} holds frames.jsonl")
    else:
        with open(os.path.join(out, "frames.jsonl")) as f:
            recs = [json.loads(line) for line in f]
        _require(len(recs) == metrics["n_frames"],
                 "frames.jsonl has one record per frame")
        metrics["keyframe_flags"] = sum(r["is_keyframe"] for r in recs)
    metrics["k1_launches"] = detect.launches
    metrics.update(_k34())
    metrics["cli_seconds"] = wall
    if keep_poses:
        metrics["_tracked"] = np.array([r.pose_T_cw is not None for r in system.results])
        metrics["_pose"] = np.stack([np.eye(4, dtype=np.float32) if r.pose_T_cw is None
                                     else r.pose_T_cw for r in system.results])
    return metrics


def _brief(m: dict) -> dict:
    keep = ("_pose", "_tracked", "n_frames", "n_tracked", "n_keyframes",
            "n_landmarks", "ate_rmse", "rpe_trans_rmse", "rpe_rot_rmse", "fps",
            "scan_fps", "scan_time_s", "decode_time_s", "wall_time_s",
            "cli_seconds", "loader", "device", "k1_launches", "lba_launches",
            "tri_launches", "host_reads_per_frame", "global_ba", "scan_stats", "keyframe_flags")
    out = {k: m[k] for k in keep if k in m}
    out["stage_seconds"] = {k: v["total_s"] for k, v in m["stage_timings"].items()
                            if isinstance(v, dict)}
    return out


def offline_capacity_spread(grays, depths, gt_t, pose128, tracked128) -> dict:
    """The offline pipeline at 88 keyframe slots (what ``System`` used to
    size for 240 frames) against the in-memory run at the default 128: the
    padded capacity changes the order of the solvers' sums, so the map
    moves with it (in the JAX package too)."""
    import numpy as np

    from visionx_slam_torch.eval.trajectory import ate_of_run
    from visionx_slam_torch.tracking.offline_pipeline import run_offline_pipeline
    from visionx_slam_torch.utils.config import TrackingOptions

    _, out = run_offline_pipeline(_camera(), grays, depths, TrackingOptions(),
                                  device="cuda", kf_capacity=88)
    pose = out.pose.cpu().numpy()
    ate, n_tracked = ate_of_run(pose, out.tracked.cpu().numpy(), gt_t)
    ate128, n_tracked128 = ate_of_run(pose128, tracked128, gt_t)
    return {"ate_m_88": ate, "tracked_88": n_tracked,
            "keyframes_88": int(out.n_keyframes), "ate_m_128": ate128,
            "tracked_128": n_tracked128,
            "max_pose_gap": float(np.abs(pose - pose128).max())}


def run_system(root: str, grays, depths, gt_t, off_pose, off_tracked) -> dict:
    """The normal entry point over the sequence written to ``root`` (see
    the module docstring); returns one record per command-line run, the
    offline one with its poses."""
    import numpy as np

    from visionx_slam_torch.data import native_loader, synthetic, tum
    from visionx_slam_torch.eval import trajectory as traj
    from visionx_slam_torch.system.system import load_snapshot_full

    T = len(grays)
    res: dict = {}
    t0 = time.perf_counter()
    synthetic.generate_sequence(root, n_frames=T, seed=5)
    res["write_seconds"] = time.perf_counter() - t0
    ds = tum.TumDataset(root, SEQUENCE)
    _require(ds.load() and len(ds.entries) == T, f"the dataset associates {T} frames")
    t0 = time.perf_counter()
    for i, e in enumerate(ds.entries):
        _require(np.array_equal(tum.load_rgb_gray(e.rgb_path), grays[i])
                 and np.array_equal(tum.load_depth_m(e.depth_path), depths[i])
                 and np.array_equal(e.gt_t, gt_t[i]),
                 f"frame {i} decodes to the rendered arrays bit for bit")
    res["python_decode_seconds"] = time.perf_counter() - t0
    if native_loader.available():
        t0 = time.perf_counter()
        pf = native_loader.NativePrefetcher(
            [e.rgb_path for e in ds.entries], [e.depth_path for e in ds.entries],
            queue_depth=8, n_threads=2)
        gap = 0.0
        for i, (g, d) in enumerate(pf):
            _require(np.array_equal(g, grays[i]),
                     f"frame {i}: the native gray equals the rendered one")
            gap = max(gap, float(np.abs(d - depths[i]).max()))
        pf.close()
        res["native_decode_wall_seconds"] = time.perf_counter() - t0
        res["native_decode_thread_seconds"] = pf.decode_seconds()
        res["native_depth_max_gap_m"] = gap
        # the library multiplies by 1/5000 where the Python loader divides
        _require(gap <= 1e-6, f"native depth within 1e-6 m: {gap}")

    out = lambda name: os.path.join(root, "out_" + name)
    # 1. scan, streamed from disk, with the full-map global BA
    m = _cli(root, out("scan"), "--pipeline", "scan", "--run_global_ba", "true")
    ts, mats = traj.read_tum_trajectory(os.path.join(out("scan"), "trajectory.txt"))
    _require(len(ts) == m["n_tracked"], "trajectory.txt has one row per tracked frame")
    kts, _ = traj.read_tum_trajectory(
        os.path.join(out("scan"), "trajectory_keyframes_gba.txt"))
    # the union map's keyframes where the archive outgrew the ring
    n_refined = m["global_ba"].get("archived_keyframes", m["n_keyframes"])
    _require(len(kts) == n_refined,
             "trajectory_keyframes_gba.txt has one row per refined keyframe")
    ms, meta = load_snapshot_full(os.path.join(out("scan"), "map_snapshot.npz"))
    _require(meta == {"next_frame_id": T} and int((ms.kf_id >= 0).sum()) == len(kts),
             "the snapshot of the refined union map loads")
    res["scan"] = _brief(m)
    full_ts, full_xyz = ts, mats[:, :3, 3]

    # 2. offline, at the pipeline's 128 keyframe slots; the spread at 88
    # slots is printed first, once
    spread = offline_capacity_spread(grays, depths, gt_t, off_pose, off_tracked)
    res["offline_capacity"] = spread
    print(f"offline keyframe capacity: ATE {spread['ate_m_128']} m at 128 slots, "
          f"{spread['ate_m_88']} m at 88; poses differ by up to "
          f"{spread['max_pose_gap']} ({_card()})", flush=True)
    res["offline"] = _brief(_cli(root, out("offline"), "--pipeline", "offline",
                                 keep_poses=True))

    # 3. host (the default pipeline)
    res["host"] = _brief(_cli(root, out("host")))

    # 4. stop at a snapshot, resume on a directory holding the rest
    cut = T // 2
    _cli(root, out("first"), "--pipeline", "scan", "--max_frames", str(cut))
    rest = os.path.join(root, "rest")
    os.makedirs(os.path.join(rest, SEQUENCE))
    with open(os.path.join(root, "color_camera_freiburg3.txt")) as f:
        intr = f.read()
    with open(os.path.join(rest, "color_camera_freiburg3.txt"), "w") as f:
        f.write(intr)
    for sub in ("rgb", "depth"):
        os.symlink(os.path.join(root, SEQUENCE, sub),
                   os.path.join(rest, SEQUENCE, sub))
    for name in ("rgb.txt", "depth.txt", "groundtruth.txt"):
        with open(os.path.join(root, SEQUENCE, name)) as f:
            lines = f.read().splitlines()
        with open(os.path.join(rest, SEQUENCE, name), "w") as f:
            f.write("\n".join(lines[:2] + lines[2 + cut:]) + "\n")
    m = _cli(rest, out("second"), "--pipeline", "scan", "--resume_from",
             os.path.join(out("first"), "map_snapshot.npz"))
    rts, rmats = traj.read_tum_trajectory(
        os.path.join(out("second"), "trajectory.txt"))
    pairs = traj.associate_trajectories(rts, full_ts, max_diff=1e-4)
    gap = max(float(np.abs(rmats[i, :3, 3] - full_xyz[j]).max()) for i, j in pairs)
    _, meta = load_snapshot_full(os.path.join(out("second"), "map_snapshot.npz"))
    res["resume"] = dict(_brief(m), frames_compared=len(pairs),
                         max_position_gap_m=gap,
                         next_frame_id=meta["next_frame_id"])
    return res


# The JAX package on the CPU (tools/port_jax_references.py --configs fleet):
# one fused step over the rendered fleet (8 lanes, 1024 features, the first 9
# frames of the bench sequence, 16 hypotheses): 4,123 matches and 3,749
# inliers, each lane within 2.0e-3 (R) and 5.2e-3 m (t) of its motion; the
# tiny dry run on a world of one: 64 inliers of 64 matches, then 8/8
# tracked, 3 keyframes, 3,000 landmarks, ATE 27.6 mm.
FLEET_D = 8
FLEET_MATCHES_JAX = 4123
FLEET_INLIERS_JAX = 3749
DRYRUN_JAX = {"fleet_inliers": 64, "fleet_matches": 64, "fleet_tracked": 8,
              "fleet_keyframes": 3, "fleet_landmarks": 3000}


def _clone(nt):
    return type(nt)(*(x.clone() for x in nt))


def run_multi_device(seq_root: str, lanes: dict) -> dict:
    """The multi-device module in a world of one under ``nccl`` (a
    FileStore in a temporary directory): (a) ``entry``'s forward; (b) one
    ``batched_slam_step`` over the rendered fleet (the first 9 frames the
    system phase wrote to ``seq_root``) against the same lanes' unsharded
    loop; (c) ``sharded_offline_pipeline`` over config 5's lanes against the
    lanes phase's result; (e) the dry run."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from visionx_slam_torch import entry as ent
    from visionx_slam_torch.models.local_ba import BAOptions
    from visionx_slam_torch.ops import detect
    from visionx_slam_torch.parallel import batch as pb
    from visionx_slam_torch.tracking.offline_pipeline import OfflineOut
    from visionx_slam_torch.utils.config import TrackingOptions

    res: dict = {}
    t_phase = time.perf_counter()
    # (a) entry's forward: K1 once, at B=1
    fn, example = ent.entry("cuda")
    detect.launches = 0
    _zero_k34()
    pose, n_inl, n_valid = fn(*example)
    torch.cuda.synchronize()
    res["entry"] = {"k1_launches": detect.launches, **_k34(), "n_valid": int(n_valid),
                    "inliers": int(n_inl[0]),
                    "finite": bool(torch.isfinite(pose.q).all()
                                   and torch.isfinite(pose.t).all())}

    with tempfile.TemporaryDirectory() as tmp:
        pb.init_group(os.path.join(tmp, "store"), 0, 1, "cuda")
        try:
            mesh = pb.make_mesh(1)
            res["mesh"] = repr(mesh)
            _require(dist.get_backend() == "nccl" and mesh.device.type == "cuda",
                     f"the world of one runs nccl on the card: {mesh}")

            # (b) one fused step over the rendered fleet
            cam = _camera()
            kw = dict(n_hypotheses=16, ba_opts=BAOptions(max_iterations=2))
            detect.launches = 0
            mss, obss, fids, gens, gt_rel = pb.make_rendered_fleet(
                cam, seq_root, FLEET_D, device=mesh.device)
            launches = detect.launches
            ref_mss = _clone(mss)
            torch.cuda.synchronize()
            _zero_k34()
            t0 = time.perf_counter()
            mss2, poses, fleet = pb.batched_slam_step(mesh, cam, **kw)(
                mss, obss, fids, gens)
            torch.cuda.synchronize()
            step_s = time.perf_counter() - t0
            k34 = _k34()
            ref = [pb.slam_step(ms, obs, fids[b], cam, g, **kw) for b, (ms, obs, g)
                   in enumerate(zip(pb.unstack_states(ref_mss), pb.unstack_obs(obss),
                                    pb.lane_generators(7, range(FLEET_D), mesh.device)))]
            poses_np = poses.cpu().numpy()
            res["fleet"] = {
                "k1_launches": launches, **k34, "step_seconds": step_s,
                "total_matches": int(fleet["total_matches"]),
                "total_inliers": int(fleet["total_inliers"]),
                "lane_matches": [int(r[2]["matches"]) for r in ref],
                "lane_inliers": [int(r[2]["inliers"]) for r in ref],
                "rot_err_max": [float(np.abs(poses_np[b, :3, :3] - T[:3, :3]).max())
                                for b, T in enumerate(gt_rel)],
                "t_err_m": [float(np.abs(poses_np[b, :3, 3] - T[:3, 3]).max())
                            for b, T in enumerate(gt_rel)],
                "equals_unsharded_loop_bit_for_bit": (
                    torch.equal(poses, torch.stack([r[1] for r in ref]))
                    and all(torch.equal(a, b) for a, b in
                            zip(mss2, pb.stack_states([r[0] for r in ref]))))}

            # (c) the sharded offline pipeline over config 5's lanes
            g, d = lanes["_inputs"]
            ms_l, out_l = lanes["_result"]
            f = pb.sharded_offline_pipeline(mesh, cam, TrackingOptions())
            detect.launches = 0
            _zero_k34()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ms_s, out_s, fleet_o = f(g, d)
            torch.cuda.synchronize()
            res["offline"] = {
                "k1_launches": detect.launches, **_k34(),
                "seconds": time.perf_counter() - t0,
                "lane_offset": fleet_o["lane_offset"],
                "total_tracked": int(fleet_o["total_tracked"]),
                "total_keyframes": int(fleet_o["total_keyframes"]),
                "total_landmarks": int(fleet_o["total_landmarks"]),
                "host_sums": [int(out_s.tracked.sum()), int(out_s.n_keyframes.sum()),
                              int(out_s.n_landmarks.sum())],
                "out_differs": [f for f in OfflineOut._fields if not torch.equal(
                    getattr(out_s, f), getattr(out_l, f))],
                "map_differs": [f for f in ms_l._fields if not torch.equal(
                    getattr(ms_s, f), getattr(ms_l, f))]}

            # (e) the dry run
            detect.launches = 0
            _zero_k34()
            res["dryrun"] = ent.dryrun_multichip(1)
            res["dryrun"]["k1_launches"] = detect.launches
            res["dryrun"].update(_k34())
        finally:
            dist.destroy_process_group()
    res["seconds"] = time.perf_counter() - t_phase
    return res


def check_multi_device(md: dict, lanes: dict) -> None:
    e, fl, off, dr = md["entry"], md["fleet"], md["offline"], md["dryrun"]
    _require(e["k1_launches"] == 1 and e["finite"] and e["n_valid"] > 0,
             f"entry: one K1 launch, finite pose, valid features: {e}")
    D = FLEET_D
    _require(fl["k1_launches"] == -(-(D + 1) // 8), "the fleet's frames launched K1")
    _require(fl["total_matches"] == sum(fl["lane_matches"])
             and fl["total_inliers"] == sum(fl["lane_inliers"]),
             "the fleet totals equal the host sums of the lanes' stats")
    _require(fl["equals_unsharded_loop_bit_for_bit"],
             "the batched step equals the unsharded loop over the same lanes")
    _require(fl["total_matches"] >= 200 * D and fl["total_inliers"] >= 100 * D,
             f"fleet matches {fl['total_matches']} >= {200 * D}, inliers "
             f"{fl['total_inliers']} >= {100 * D}")
    _require(max(fl["rot_err_max"]) <= 5e-3 and max(fl["t_err_m"]) <= 8e-3,
             f"each lane's pose within 5e-3 (R) and 8e-3 m (t) of its motion: "
             f"{fl['rot_err_max']}, {fl['t_err_m']}")
    _require(not off["out_differs"] and not off["map_differs"],
             f"the sharded offline pipeline equals the folded lanes bit for bit: "
             f"outputs differ in {off['out_differs']}, maps in {off['map_differs']}")
    _require(off["lane_offset"] == 0 and [off["total_tracked"], off["total_keyframes"],
                                          off["total_landmarks"]] == off["host_sums"],
             "the sharded totals equal the host sums")
    _require(off["k1_launches"] == lanes["k1_launches"],
             f"K1 launches of the sharded offline pipeline {off['k1_launches']}")
    # the port's extraction on the card is JAX's to rounding ties, its
    # RANSAC draws are its own: matches within 5%, inliers within 10%
    _require(abs(fl["total_matches"] - FLEET_MATCHES_JAX) <= 0.05 * FLEET_MATCHES_JAX
             and abs(fl["total_inliers"] - FLEET_INLIERS_JAX) <= 0.1 * FLEET_INLIERS_JAX,
             f"fleet matches {fl['total_matches']} within 5% of JAX's "
             f"{FLEET_MATCHES_JAX}, inliers {fl['total_inliers']} within 10% of "
             f"{FLEET_INLIERS_JAX}")
    J = DRYRUN_JAX
    _require(dr["k1_launches"] > 0
             and all(dr[k] == J[k] for k in ("fleet_inliers", "fleet_matches",
                                             "fleet_tracked"))
             and abs(dr["fleet_keyframes"] - J["fleet_keyframes"]) <= 1
             and abs(dr["fleet_landmarks"] - J["fleet_landmarks"])
             <= 0.1 * J["fleet_landmarks"],
             f"the dry run's totals against JAX's {J} (keyframes within 1, "
             f"landmarks within 10%): {dr}")


# The port's bench entry run as ``python -m visionx_slam_torch.bench``
# does, in a process of its own, reporting K1's launches of the whole run
_BENCH_RUN = """
import runpy, sys
from visionx_slam_torch.models import local_ba
from visionx_slam_torch.ops import detect
from visionx_slam_torch.tracking import stages
sys.argv[0] = "visionx_slam_torch.bench"
try:
    runpy.run_module("visionx_slam_torch.bench", run_name="__main__")
finally:
    print(f"K1_LAUNCHES {detect.launches}", file=sys.stderr)
    print(f"K34_LAUNCHES {local_ba.lba_launches} {stages.tri_launches}",
          file=sys.stderr)
"""
BENCH_CONFIGS = ("1_online_scan", "2_monocular", "2b_monocular_offline",
                 "3_long_sequence", "4_fullmap_gba", "5_batched_offline")


def _finite_numbers(d: dict) -> bool:
    import math

    nums = [v for v in d.values() if isinstance(v, (int, float))
            and not isinstance(v, bool)]
    return bool(nums) and all(math.isfinite(v) for v in nums)


def run_bench(runs: int = 2) -> dict:
    """The port's bench at full width (240 frames, 640x480, 1024 slots, the
    six configs) in a process of its own: its last line, its whole result
    (the line before, and the ``--json`` file), K1's launches and its wall
    time."""
    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "bench.json")
        t0 = time.perf_counter()
        res = subprocess.run([sys.executable, "-c", _BENCH_RUN, "--runs", str(runs),
                              "--json", path], cwd=root, capture_output=True,
                             text=True, timeout=900)
        wall = time.perf_counter() - t0
        _require(res.returncode == 0,
                 f"the bench exited {res.returncode}: {res.stderr[-3000:]}")
        with open(path) as f:
            saved = json.load(f)
    lines = res.stdout.strip().splitlines()
    launches = [int(x.split()[1]) for x in res.stderr.splitlines()
                if x.startswith("K1_LAUNCHES")]
    k34 = [x.split()[1:] for x in res.stderr.splitlines()
           if x.startswith("K34_LAUNCHES")][-1]
    return {"last_line": lines[-1], "result": json.loads(lines[-2]),
            "saved": saved, "k1_launches": launches[-1],
            "lba_launches": int(k34[0]), "tri_launches": int(k34[1]),
            "seconds": wall}


def check_bench(b: dict) -> None:
    """The bench's last line parses and is short; no config errored or was
    skipped; every path's tracked frames and ATE within PERF.md Section 2's
    limits; the MFU and roofline blocks present and finite."""
    import numpy as np

    _require(len(b["last_line"]) <= 500, f"bench last line of {len(b['last_line'])} "
             "characters")
    summary = json.loads(b["last_line"])
    res = b["result"]
    _require(res == b["saved"], "the bench's --json file holds its printed result")
    _require(all(summary[k] == res[k] for k in ("metric", "value", "unit",
                                                 "vs_baseline")),
             "the last line summarises the whole result")
    d = res["detail"]
    T = d["n_frames"]
    _require(T == 240 and d["n_tracked"] >= 228 and d["ate_rmse_m"] <= 0.011,
             f"bench headline: tracked {d['n_tracked']}/{T}, ATE {d['ate_rmse_m']} m")
    _require(d["mfu"] > 0 and _finite_numbers(d["roofline"]),
             f"bench headline MFU {d.get('mfu')} and roofline {d.get('roofline')}")
    cfg = d["configs"]
    _require(tuple(cfg) == BENCH_CONFIGS, f"bench configs {list(cfg)}")
    for name, c in cfg.items():
        _require("error" not in c and "skipped" not in c, f"bench config {name}: {c}")
    c1, c2, c2b = cfg["1_online_scan"], cfg["2_monocular"], cfg["2b_monocular_offline"]
    c3, c4, c5 = cfg["3_long_sequence"], cfg["4_fullmap_gba"], cfg["5_batched_offline"]
    _require(c1["tracked_frac"] >= 0.95 and c1["ate_rmse_m"] <= 2 * SCAN_ATE_JAX,
             f"bench config 1: {c1['tracked_frac']}, {c1['ate_rmse_m']} m")
    _require(c1["mfu"] > 0 and _finite_numbers(c1["roofline"])
             and c1["latency_ms_p99"] >= c1["latency_ms_p50"] > 0,
             f"bench config 1's MFU, roofline and latency: {c1}")
    _require(c2["tracked_frac"] * c2["n_frames"] >= MONO_SCAN_TRACKED_JAX - 4
             and c2["ate_rmse_m_scale_aligned"] <= 2 * MONO_SCAN_ATE_JAX,
             f"bench config 2: {c2}")
    _require(c2b["tracked_frac"] * c2b["n_frames"] >= 0.9 * MONO_OFF_TRACKED_JAX
             and c2b["ate_rmse_m_scale_aligned"] <= 2 * MONO_OFF_ATE_JAX,
             f"bench config 2b: {c2b}")
    _require(c3["n_frames"] == 1200 and c3["tracked_frac"] >= 0.95
             and c3["ate_rmse_m"] <= 2 * LONG_ATE_JAX, f"bench config 3: {c3}")
    _require(c4["n_keyframes"] >= 68 and c4["pair_ba_ms_per_solve"] > 0
             and c4["global_ba_ms_per_solve"] > 0, f"bench config 4: {c4}")
    _require(c5["tracked_frac"] >= 0.95
             and c5["ate_rmse_m_mean"] <= 2 * float(np.mean(LANES_ATE_JAX)),
             f"bench config 5: {c5}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=240)
    args = ap.parse_args()
    t_start = time.perf_counter()

    import numpy as np
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

    print("host " + json.dumps(host_environment()), flush=True)

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
    k1["one_frame"] = time_k1_one_frame(grays[0])
    k1b = check_k1b(grays[:8])
    gn = check_gn()
    lba_rec = check_lba(grays, depths)
    tri_rec = check_tri(grays, depths)

    # ---- 4. the offline pipeline ----
    res = run_pipeline(grays, depths, gt_t)
    off_pose, off_tracked = res.pop("_pose"), res.pop("_tracked")
    print("pipeline " + json.dumps(res) + f" ({card})", flush=True)
    T = res["frames"]
    _require(res["k1_launches"] > 0, "the pipeline launched K1")
    _require(res["gn_launches"] > 0, "the pipeline launched K2")
    bm = res["batched_matching"]
    _require(bm["equal_to_loop"] and bm["slots"] == 1024 and bm["matches"] > 0,
             f"match_frames_batched equals the per-pair loop bit for bit: {bm}")
    _require(res["tracked"] >= int(0.95 * T), f"tracked {res['tracked']}/{T}")
    _require(res["ate_m"] is not None and res["ate_m"] <= 0.011,
             f"ATE {res['ate_m']} m <= 0.011 m")
    if T == 240:  # the JAX reference makes 80 keyframes on this input
        _require(68 <= res["keyframes"] <= 92, f"keyframes {res['keyframes']}")

    # ---- 5. the online scan ----
    scan = run_scan(grays, depths, gt_t)
    full_positions, full_tracked = scan.pop("_positions"), scan.pop("_tracked")
    print("scan " + json.dumps(scan) + f" ({card})", flush=True)
    _require(scan["k1_launches"] > 0, "the scan launched K1")
    _require(scan["gn_launches"] > 0, "the scan launched K2")
    _require(scan["tracked"] >= int(0.95 * T), f"scan tracked {scan['tracked']}/{T}")
    _require(scan["track_graph"] == scan["good_branch_frames"] > 0
             and scan["track_graph_captures"] == 0,
             f"the scan replayed its graph in every GOOD-branch frame "
             f"({scan['track_graph']} of {scan['good_branch_frames']}) and "
             f"captured it in the warm-up run")
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
    _require(hole["local_ba_repeats_bit_for_bit"] and hole["scan_repeats_bit_for_bit"],
             "local BA on the hole scan's map, and the hole scan, repeat bit for bit")
    if T == 240:
        _require(hole["ate_m"] is not None and hole["ate_m"] <= 2 * HOLE_ATE_JAX,
                 f"hole ATE {hole['ate_m']} m <= {2 * HOLE_ATE_JAX} m")
        lo, hi = 0.85 * HOLE_KF_JAX, 1.15 * HOLE_KF_JAX
        _require(lo <= hole["keyframe_events"] <= hi,
                 f"hole keyframe events {hole['keyframe_events']} in [{lo}, {hi}]")
        lo, hi = 0.9 * HOLE_LM_JAX, 1.1 * HOLE_LM_JAX
        _require(lo <= hole["landmarks"] <= hi,
                 f"hole landmarks {hole['landmarks']} in [{lo}, {hi}]")

    # ---- 6b. System over TUM files with the hole model (the cell
    # rgbd.system_disk_holes): triangulation, local BA, the local map ----
    s_holes = run_system_holes()
    print("system holes " + json.dumps(s_holes) + f" ({card})", flush=True)
    _require(s_holes["tracked"] == s_holes["frames"], "system holes tracked every frame")
    _require(s_holes["#lba_iterations"] > 0 and s_holes["#tri_landmarks"] > 0
             and s_holes["#localmap_matches"] > 0,
             "system holes: local BA iterated, triangulation and the local map worked")
    _require(s_holes["lba_launches"] == s_holes["#kf_events"] > 0,
             "system holes: one K3 launch a keyframe event")
    _require(s_holes["#track_graph"] >= s_holes["frames"] - 2,
             f"system holes: {s_holes['#track_graph']} steady frames replayed")
    _require(2 * s_holes["events_iterated"] >= s_holes["#kf_events"],
             "system holes: local BA iterated in at least half the events")
    _require(all(v <= lim for v, lim in s_holes["checks"].values()),
             f"system holes within the cell's limits: {s_holes['checks']}")

    # ---- 6c. the same files through System's default pipeline (the cell
    # rgbd.system_host_holes): the host Tracker with the local map ----
    s_host_holes = run_system_host_holes()
    print("system host holes " + json.dumps(s_host_holes) + f" ({card})", flush=True)
    h = s_host_holes
    _require(h["tracked"] == h["frames"] and h["resets"] == 0,
             "system host holes tracked every frame")
    _require(h["#lba_iterations"] > 0 and h["#tri_landmarks"] > 0
             and h["#localmap_matches"] > 0,
             "system host holes: local BA iterated, triangulation and the local "
             "map worked")
    _require(h["lba_launches"] == h["#kf_events"] > 0,
             "system host holes: one K3 launch a keyframe event")
    _require(2 * h["events_iterated"] >= h["#kf_events"],
             "system host holes: local BA iterated in at least half the events")
    _require(h["archived_keyframes"] == h["keyframes_inserted"] == h["#kf_events"] + 2,
             f"system host holes archived every keyframe made: "
             f"{h['archived_keyframes']} of {h['keyframes_inserted']}")
    _require(all(v <= lim for v, lim in h["checks"].values()),
             f"system host holes within the cell's limits: {h['checks']}")

    # ---- 7. the long-stress tool: 2160 frames, ring wrap, compaction,
    # no landmark dropped, split at 1200 ----
    _zero_k34()
    stress = run_stress(grays, depths, gt_t)
    stress.update(_k34())   # both of the tool's runs
    print("stress " + json.dumps(stress) + f" ({card})", flush=True)
    check_stress(stress, T)
    from visionx_slam_torch.tools import long_stress
    print(long_stress.summary(stress) + f" ({card})", flush=True)

    # ---- 7b. the sensor-degradation matrix (the real-data tool) ----
    _zero_k34()
    degr = run_degradation(grays, depths, gt_t)
    degr_k34 = _k34()   # every row
    band = check_degradation(degr)
    from visionx_slam_torch.tools import real_data_check
    print(real_data_check.table(degr, band), flush=True)
    for r in degr:
        print("degradation " + json.dumps(r) + f" ({card})", flush=True)

    # ---- 8. folded lanes (BASELINE config 5) ----
    lanes = run_lanes(grays, depths, gt_t)
    lanes_data = {k: lanes.pop(k) for k in ("_inputs", "_result")}
    print("lanes " + json.dumps(lanes) + f" ({card})", flush=True)
    n_frames = LANES_B * lanes["frames_per_lane"]
    _require(lanes["tracked_frac"] >= 0.95, f"lanes tracked {lanes['tracked_frac']}")
    if T == 240:
        _require(lanes["k1_launches"] == n_frames // 8,
                 f"K1 launches on the lanes {lanes['k1_launches']} == {n_frames // 8}")
        for b, (a, a_j) in enumerate(zip(lanes["lane_ate_m"], LANES_ATE_JAX)):
            _require(a <= 2 * a_j, f"lane {b} ATE {a} m <= 2 x JAX {a_j} m")
    # the solvers' sums add in a fixed order: a folded lane is its single
    # run, bit for bit, on the card as on the CPU
    _require(lanes["single_lane0_equal_bit_for_bit"],
             f"lane 0 equals its single run bit for bit (pose gap "
             f"{lanes['single_lane0_pose_gap']})")

    # ---- 9. monocular offline (config 2b) ----
    mono = run_mono_offline(grays, gt_t)
    mono_pose = mono.pop("_pose")
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

    # ---- 9b. monocular loop closure (config 2b's input) ----
    loop = run_mono_loop(grays, gt_t, mono_pose)
    del mono_pose
    print("mono loop " + json.dumps(loop) + f" ({card})", flush=True)
    ls, lm, lf = loop["scale"], loop["merge"], loop["folded"]
    Tm = ls["frames"]
    for name, r, n in (("scale", ls, Tm), ("merge", lm, Tm), ("folded", lf, 2 * Tm)):
        _require(r["k1_launches"] == -(-n // 8),
                 f"K1 launches on mono loop {name} {r['k1_launches']}")
        _require(r["loop_verified_frames"] > 0
                 and 0.25 <= r["loop_factor_min"] <= r["loop_factor_max"] <= 4.0,
                 f"mono loop {name}: {r['loop_verified_frames']} verified frames, "
                 f"factors in [{r['loop_factor_min']}, {r['loop_factor_max']}]")
    _require(ls["differs_from_plain_mono"], "the scale re-anchoring changed the poses")
    _require(lm["loop_pairs_verified"] > 0 and lm["loop_links_merged"] > 0,
             f"mono loop merge: {lm['loop_pairs_verified']} pairs verified, "
             f"{lm['loop_links_merged']} links merged")
    _require(lm["links_to_dead_landmarks"] == 0 and lm["lm_obs_is_link_count"],
             "after the merge every live link points at a live landmark and lm_obs "
             "counts the links")
    _require(lm["repeats_bit_for_bit"], "the merge run repeats bit for bit")
    _require(lf["lane0_equals_merge_bit_for_bit"],
             f"folded lane 0 equals the merge run bit for bit (pose gap "
             f"{lf['lane0_pose_gap']})")
    _require(loop["copies_tie_exactly"],
             "copied frames get equal place descriptors and similarities")
    for name, r in (("scale", ls), ("merge", lm)):
        _require(r["ate_m_scale_aligned"] is not None, f"mono loop {name} has an ATE")
    if T == 240:
        for name, r, ate_j, tr_j, kf_j, lm_j in (
                ("scale", ls, MONO_LOOP_ATE_JAX, MONO_LOOP_TRACKED_JAX,
                 MONO_LOOP_KEYFRAMES_JAX, MONO_LOOP_LANDMARKS_JAX),
                ("merge", lm, MONO_MERGE_ATE_JAX, MONO_MERGE_TRACKED_JAX,
                 MONO_MERGE_KEYFRAMES_JAX, MONO_MERGE_LANDMARKS_JAX)):
            _require(r["tracked"] >= 0.9 * tr_j and r["ate_m_scale_aligned"] <= 2 * ate_j,
                     f"mono loop {name}: tracked {r['tracked']} >= 0.9 x JAX {tr_j}, "
                     f"ATE {r['ate_m_scale_aligned']} m <= 2 x JAX {ate_j} m")
            print(f"mono loop {name}: {r['keyframes']} keyframes, {r['landmarks']} "
                  f"landmarks (JAX {kf_j}, {lm_j})", flush=True)
            _require(abs(r["keyframes"] - kf_j) <= 0.1 * kf_j
                     and abs(r["landmarks"] - lm_j) <= 0.25 * lm_j,
                     f"mono loop {name}: keyframes {r['keyframes']} within 10% of JAX "
                     f"{kf_j}, landmarks {r['landmarks']} within 25% of JAX {lm_j}")
        share_j = 1 - MONO_MERGE_LANDMARKS_JAX / MONO_LOOP_LANDMARKS_JAX
        share = 1 - lm["landmarks"] / ls["landmarks"]
        _require(0.5 * share_j <= share <= 2 * share_j,
                 f"the merge killed {share:.4f} of the landmarks, within [1/2, 2] x "
                 f"JAX's {share_j:.4f}")
    print(f"mono loop: scale {ls['fps']:.1f} fps, merge {lm['fps']:.1f} fps, folded "
          f"{lf['fps']:.1f} aggregate fps (plain mono {mono['fps']:.1f}); wide global_ba "
          f"{lm['wide_gba_ms_per_solve']:.2f} ms per solve, standard "
          f"{lm['gba_ms_per_solve']:.2f} ms; {lm['cuda_syncs_per_run']} CUDA syncs per "
          f"merge run ({lm['cuda_syncs_per_run_loop_off']} with the loop off) ({card})",
          flush=True)

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

    # ---- 11. the two global-BA solvers on the offline map (config 4) ----
    gba = run_gba(grays, depths)
    print("gba " + json.dumps(gba) + f" ({card})", flush=True)
    _require(gba["k1_launches"] == 2 * -(-T // 8), "the two map builds launched K1")
    for name in ("bench", "dropout"):
        m = gba[name]
        # gated at the start of the last iteration, on states that differ
        # in their last bits
        _require(m["total_obs"] > 0 and abs(m["total_obs"] - m["total_obs_global"])
                 <= 1e-3 * m["total_obs"],
                 f"gba {name}: both solvers see the same observations: "
                 f"{m['total_obs']}, {m['total_obs_global']}")
        for solver in ("pair", "global"):
            _require(m[f"mean_reproj_{solver}_px"]
                     <= m["mean_reproj_before_px"] + 1e-3,
                     f"gba {name}: {solver} does not raise the reprojection error")
        # landmarks by their 99th percentile, with the worst one bounded: a
        # few two-view landmarks with a weak depth direction amplify the
        # solvers' last bits to centimetres
        _require(m["pose_gap_t"] <= 2e-3 and m["pose_gap_q"] <= 2e-3
                 and m["landmark_gap_p99"] <= 5e-3 and m["landmark_gap_max"] <= 0.2,
                 f"gba {name}: pair_ba and global_ba agree (poses 2e-3, landmarks' "
                 f"99th percentile 5e-3, worst landmark 0.2 m): {m['pose_gap_t']}, "
                 f"{m['pose_gap_q']}, {m['landmark_gap_p99']}, {m['landmark_gap_max']}")
        _require(m["pair_ba_repeats_bit_for_bit"],
                 f"gba {name}: pair_ba gives equal bits twice")
        _require(m["global_ba_repeats_bit_for_bit"],
                 f"gba {name}: global_ba gives equal bits twice")
        ss = m["segment_sum"]
        _require(ss["equals_cpu_index_add_bit_for_bit"] and ss["repeats_bit_for_bit"],
                 f"gba {name}: the segment sum equals index_add_ on the CPU and "
                 f"repeats, bit for bit: {ss}")
        print(f"gba {name}: per-landmark sum of {ss['rows']} rows x 12: index_add_ "
              f"{ss['index_add_ms']:.4f} ms ({ss['index_add_runs_differing']}/4 "
              f"repeats differ), segment sum {ss['segment_sum_ms']:.4f} ms + "
              f"{ss['segments_ms']:.4f} ms to sort once per solve; global_ba "
              f"{m['global_ba_ms_per_solve']:.2f} ms per solve ({card})", flush=True)
    if T == 240:
        _require(gba["bench"]["keyframes"] >= 68, "the K=128 map's keyframes")
    d = gba["dropout"]
    _require(d["two_view_landmarks"] > 1000, "the dropout map has two-view landmarks")
    _require(d["mean_reproj_pair_px"] < d["mean_reproj_before_px"]
             and d["mean_reproj_global_px"] < d["mean_reproj_before_px"],
             "both solvers lower the dropout map's reprojection error")
    _require(abs(d["mean_reproj_pair_px"] - d["mean_reproj_global_px"])
             <= 0.03 * d["mean_reproj_global_px"],
             f"the dropout map's error after pair_ba {d['mean_reproj_pair_px']} px "
             f"within 3% of global_ba's {d['mean_reproj_global_px']} px")

    # ---- 12. the archived scan and the full-map global BA ----
    arch = run_archive(grays, depths, gt_t)
    print("archive " + json.dumps(arch) + f" ({card})", flush=True)
    _require(arch["k1_launches"] == sum(-(-min(64, T - s) // 8)
                                        for s in range(0, T, 64)),
             f"K1 launches of the archived scan {arch['k1_launches']}")
    # the init pair inserts two keyframes and flags one frame
    _require(arch["archived"] == arch["keyframe_events"] + 1,
             f"archived {arch['archived']} == keyframes made "
             f"{arch['keyframe_events'] + 1}")
    _require(arch["union_keyframes"] == arch["archived"],
             "the union map holds every archived keyframe")
    _require(arch["gba"]["mean_reproj_after_px"]
             <= arch["gba"]["mean_reproj_before_px"] + 1e-3,
             "the union solve does not raise the reprojection error")
    _require(arch["gba"]["total_obs"] > 0, "the union solve has observations")
    _require(abs(arch["ate_m"] - scan["ate_m"]) <= 5e-4
             and abs(arch["tracked"] - scan["tracked"]) <= 1,
             f"chunking at 64 leaves the scan as it was: ATE {arch['ate_m']} vs "
             f"{scan['ate_m']}, tracked {arch['tracked']} vs {scan['tracked']}")
    if T == 240:
        _require(arch["archived"] > 64 and arch["union_slots"] == 128,
                 f"the archive outgrew the ring: {arch['archived']} keyframes in "
                 f"{arch['union_slots']} slots")
        _require(arch["gba"].get("archived_keyframes") == arch["archived"],
                 "the solve covered the union map")

    # ---- 13. snapshot and resume ----
    resume = run_resume(grays, depths, gt_t, full_positions, full_tracked)
    print("resume " + json.dumps(resume) + f" ({card})", flush=True)
    n_res = resume["frames_resumed"]
    _require(resume["k1_launches"] > 0, "the resumed scan launched K1")
    _require(resume["snapshot_round_trip_equal"] and resume["next_frame_id"] == T // 2,
             "the snapshot loads as it was saved")
    _require(resume["first_tracked"], "the first resumed frame tracks")
    _require(resume["tracked"] >= n_res - 2, f"resumed tracked {resume['tracked']}/{n_res}")
    _require(resume["max_position_gap_m"] is not None
             and resume["max_position_gap_m"] <= 0.010,
             f"resumed positions within 10 mm of the uninterrupted scan: "
             f"{resume['max_position_gap_m']}")

    # ---- 14. the scan with map culling ----
    cull = run_culling(grays, depths, gt_t)
    print("culling " + json.dumps(cull) + f" ({card})", flush=True)
    _require(cull["k1_launches"] == -(-T // 8), "the culling scan launched K1")
    _require(cull["lm_culled"] > 0, "culling removed landmarks")
    if T == 240:   # JAX collapses at this shape: the behaviour class
        lo, hi = 0.85 * CULL_TRACKED_JAX, 1.15 * CULL_TRACKED_JAX
        _require(lo <= cull["tracked"] <= hi,
                 f"culling tracked {cull['tracked']} in [{lo}, {hi}]")
        _require(cull["ate_m"] is not None
                 and CULL_ATE_JAX / 3 <= cull["ate_m"] <= 3 * CULL_ATE_JAX,
                 f"culling ATE {cull['ate_m']} m of the order of JAX's {CULL_ATE_JAX} m")
        lo, hi = 0.85 * CULL_KF_JAX, 1.15 * CULL_KF_JAX
        _require(lo <= cull["keyframe_events"] <= hi,
                 f"culling keyframe flags {cull['keyframe_events']} in [{lo}, {hi}]")
    print(f"culling: {cull['fps']:.1f} fps, {cull['host_syncs_per_frame']:.3f} host "
          f"reads/frame (plain scan {scan['host_syncs_per_frame']:.3f}), "
          f"{cull['cuda_syncs_per_frame']:.3f} CUDA syncs/frame (plain scan "
          f"{scan['cuda_syncs_per_frame']:.3f}), "
          f"{cull['lm_culled']} landmarks and {cull['kf_culled']} keyframes culled, "
          f"final map {cull['final_keyframes']} keyframes / {cull['landmarks']} "
          f"landmarks (JAX {CULL_FINAL_KF_JAX} / {CULL_FINAL_LM_JAX}, "
          f"{CULL_KF_REMOVED_JAX} keyframes removed) ({card})", flush=True)

    # with options that keep the landmarks: a healthy run that removes keyframes
    keep = run_culling(grays, depths, gt_t, **CULL_KEEP)
    print("culling, landmarks kept " + json.dumps(keep) + f" ({card})", flush=True)
    _require(keep["k1_launches"] == -(-T // 8), "the second culling scan launched K1")
    _require(keep["kf_culled"] > 0 and keep["lm_culled"] > 0,
             f"culling removed keyframes ({keep['kf_culled']}) and landmarks "
             f"({keep['lm_culled']})")
    _require(keep["tracked"] >= int(0.95 * T), f"culling (kept) tracked {keep['tracked']}/{T}")
    _require(keep["final_keyframes"] <= CULL_KEEP["max_keyframes"],
             f"the culled map holds {keep['final_keyframes']} keyframes")
    if T == 240:
        _require(keep["tracked"] >= 0.95 * CULL_KEEP_TRACKED_JAX
                 and keep["ate_m"] is not None
                 and keep["ate_m"] <= 2 * CULL_KEEP_ATE_JAX,
                 f"culling (kept): tracked {keep['tracked']}, ATE {keep['ate_m']} m "
                 f"<= {2 * CULL_KEEP_ATE_JAX} m")
        lo, hi = 0.85 * CULL_KEEP_KF_JAX, 1.15 * CULL_KEEP_KF_JAX
        _require(lo <= keep["keyframe_events"] <= hi,
                 f"culling (kept) keyframe flags {keep['keyframe_events']} in [{lo}, {hi}]")
        _require(keep["kf_culled"] >= CULL_KEEP_KF_REMOVED_JAX,
                 f"culling (kept) removed {keep['kf_culled']} keyframes, JAX at least "
                 f"{CULL_KEEP_KF_REMOVED_JAX}")
    print(f"culling, landmarks kept: {keep['fps']:.1f} fps, "
          f"{keep['host_syncs_per_frame']:.3f} host reads/frame, "
          f"{keep['cuda_syncs_per_frame']:.3f} CUDA syncs/frame, "
          f"{keep['lm_culled']} landmarks and {keep['kf_culled']} keyframes culled, "
          f"final map {keep['final_keyframes']} keyframes / {keep['landmarks']} "
          f"landmarks (JAX {CULL_KEEP_FINAL_KF_JAX} / {CULL_KEEP_FINAL_LM_JAX}) "
          f"({card})", flush=True)

    # ---- 15. the batched scan (config 5's windows) ----
    bscan = run_batched_scan(grays, depths, gt_t)
    print("batched scan " + json.dumps(bscan) + f" ({card})", flush=True)
    n_frames = LANES_B * bscan["frames_per_lane"]
    _require(bscan["tracked_frac"] >= 0.95,
             f"batched scan tracked {bscan['tracked_frac']}")
    _require(bscan["k1_launches"] == -(-n_frames // 8),
             f"K1 launches of the batched scan {bscan['k1_launches']}")
    _require(all(bscan["lanes_equal_single_runs_bit_for_bit"]),
             f"every lane of the batched scan equals its single run bit for bit: "
             f"{bscan['lanes_equal_single_runs_bit_for_bit']}")
    print(f"batched scan: {bscan['aggregate_fps']:.1f} aggregate fps, the 8 single runs "
          f"{bscan['single_runs_fps']:.1f} fps"
          f", the offline folded lanes {lanes['aggregate_fps']:.1f} aggregate fps "
          f"({card})", flush=True)

    # ---- 16. the normal entry point, from files on disk ----
    seq_root = tempfile.TemporaryDirectory()
    sysr = run_system(seq_root.name, grays, depths, gt_t, off_pose, off_tracked)
    sys_pose, sys_tracked = sysr["offline"].pop("_pose"), sysr["offline"].pop("_tracked")
    print("system " + json.dumps(sysr) + f" ({card})", flush=True)
    s_scan, s_off, s_host, s_res = (sysr[k] for k in ("scan", "offline", "host", "resume"))
    _require(s_scan["scan_stats"]["track_graph"] > 0,
             f"system scan: {s_scan['scan_stats']['track_graph']} steady frames "
             f"replayed")
    for name, m in (("scan", s_scan), ("offline", s_off), ("host", s_host)):
        _require(m["n_frames"] == T and m["device"] == "cuda",
                 f"system {name} ran {T} frames on the card")
        _require(m["k1_launches"] > 0, f"system {name} launched K1")
    _require(abs(s_scan["n_tracked"] - scan["tracked"]) <= 1
             and abs(s_scan["ate_rmse"] - scan["ate_m"]) <= 5e-4,
             f"system scan within one frame and 0.5 mm of the in-memory scan: "
             f"{s_scan['n_tracked']} vs {scan['tracked']}, {s_scan['ate_rmse']} vs "
             f"{scan['ate_m']}")
    _require(s_scan["global_ba"].get("archived_keyframes") == arch["archived"],
             f"system scan archived {s_scan['global_ba'].get('archived_keyframes')} "
             f"keyframes, the archive phase {arch['archived']}")
    _require(s_scan["k1_launches"] == arch["k1_launches"],
             "system scan launches K1 once per 8 frames of each 64-frame chunk")
    # the same decoded frames, the same 128 keyframe slots and fixed-order
    # solver sums: the run from disk is the in-memory run
    print(f"system offline: ATE {s_off['ate_rmse']} m, tracked {s_off['n_tracked']}; "
          f"in-memory pipeline ATE {res['ate_m']} m, tracked {res['tracked']} ({card})",
          flush=True)
    pose_equal = (np.array_equal(sys_tracked, off_tracked)
                  and np.array_equal(sys_pose[sys_tracked], off_pose[off_tracked]))
    _require(s_off["n_tracked"] == res["tracked"] and pose_equal,
             f"system offline equals the in-memory pipeline bit for bit: tracked "
             f"{s_off['n_tracked']} vs {res['tracked']}, ATE {s_off['ate_rmse']} vs "
             f"{res['ate_m']}")
    _require(s_host["k1_launches"] == T, "the host path launches K1 once per frame")
    if T == 240:
        _require(s_host["n_tracked"] >= 0.95 * HOST_TRACKED_JAX
                 and s_host["ate_rmse"] <= 2 * HOST_ATE_JAX,
                 f"system host: tracked {s_host['n_tracked']} >= 95% of JAX's "
                 f"{HOST_TRACKED_JAX}, ATE {s_host['ate_rmse']} m <= 2 x {HOST_ATE_JAX} m")
        lo, hi = 0.85 * HOST_KF_JAX, 1.15 * HOST_KF_JAX
        _require(lo <= s_host["keyframe_flags"] <= hi,
                 f"system host keyframe flags {s_host['keyframe_flags']} in [{lo}, {hi}]")
        _require(s_host["n_keyframes"] == HOST_FINAL_KF_JAX
                 and abs(s_host["n_landmarks"] - HOST_FINAL_LM_JAX)
                 <= 0.1 * HOST_FINAL_LM_JAX,
                 f"system host ends on a full ring: {s_host['n_keyframes']} "
                 f"keyframes, {s_host['n_landmarks']} landmarks")
    _require(s_res["n_frames"] == T - T // 2 and s_res["next_frame_id"] == T
             and s_res["frames_compared"] >= s_res["n_frames"] - 2
             and s_res["max_position_gap_m"] <= 0.010,
             f"the resumed run's positions within 10 mm of the uninterrupted "
             f"run: {s_res['max_position_gap_m']} over {s_res['frames_compared']} frames")
    print(f"system: scan {s_scan['scan_fps']:.1f} fps from disk (in-memory scan "
          f"{scan['fps']:.1f}), loader {s_scan['loader']}, decode "
          f"{s_scan['decode_time_s']:.3f} s of threads' time, "
          f"{s_scan['stage_seconds'].get('decode_wait', 0.0):.3f} s waited for; offline "
          f"{s_off['scan_fps']:.1f} fps after {s_off['stage_seconds']['decode']:.3f} s "
          f"of decode (in-memory {res['fps']:.1f}); host {s_host['fps']:.1f} fps, "
          f"{s_host['host_reads_per_frame']:.2f} device reads per frame, "
          f"{s_host['k1_launches']} K1 launches ({card})", flush=True)

    # ---- 16b. the real-data tool on the directory above (synthetic) ----
    real = run_real_data(seq_root.name)
    print("real data " + json.dumps(real) + f" ({card})", flush=True)
    check_real_data(real, degr[0])
    print(f"REAL DATA: tracked {real['n_tracked']}/{real['n_frames']}, ATE "
          f"{real['ate_rmse']:.4f} m, RPE {real['rpe_trans_rmse']:.4f} m, "
          f"{real['n_keyframes']} keyframes, {real['n_landmarks']} landmarks, "
          f"loader {real['loader']} ({card})", flush=True)

    # ---- 17. the multi-device module, a world of one under nccl ----
    try:
        md = run_multi_device(seq_root.name, lanes_data)
    finally:
        seq_root.cleanup()
    del lanes_data
    print("multi-device " + json.dumps(md) + f" ({card})", flush=True)
    check_multi_device(md, lanes)
    fl, off = md["fleet"], md["offline"]
    print(f"multi-device: {md['seconds']:.1f} s; fleet step {fl['step_seconds']:.3f} s, "
          f"{fl['total_matches']} matches / {fl['total_inliers']} inliers over "
          f"{FLEET_D} lanes; sharded offline {off['seconds']:.2f} s, equal to the "
          f"folded lanes bit for bit; dry run {md['dryrun']['fleet_tracked']}/8 "
          f"tracked ({card})", flush=True)

    # ---- 18. the bench entry, in a process of its own ----
    bench = run_bench()
    print("bench " + bench["last_line"] + f" ({card})", flush=True)
    print("bench detail " + json.dumps(bench["result"]["detail"]) + f" ({card})",
          flush=True)
    check_bench(bench)
    cfg = bench["result"]["detail"]["configs"]
    print(f"bench: {bench['seconds']:.1f} s; headline {bench['result']['value']} fps; "
          f"configs 1 {cfg['1_online_scan']['fps']} fps (p50 "
          f"{cfg['1_online_scan']['latency_ms_p50']} ms), 2 {cfg['2_monocular']['fps']}, "
          f"2b {cfg['2b_monocular_offline']['fps']}, 3 {cfg['3_long_sequence']['fps']}, "
          f"4 pair_ba {cfg['4_fullmap_gba']['pair_ba_ms_per_solve']} ms / global_ba "
          f"{cfg['4_fullmap_gba']['global_ba_ms_per_solve']} ms, 5 "
          f"{cfg['5_batched_offline']['aggregate_fps']} aggregate fps; "
          f"{bench['k1_launches']} K1 launches ({card})", flush=True)

    k1["launches"] = scan["k1_launches"]
    k1b["launches"] = scan["k1b_launches"]
    k1["launches_by_path"] = {
        "offline": res["k1_launches"], "scan": scan["k1_launches"],
        "hole_scan": hole["k1_launches"],
        "stress": stress["k1_launches"],
        "stress_split": sum(stress["split"]["k1_launches"]),
        "degradation": sum(r["k1_launches"] for r in degr),
        "real_data": real["k1_launches"], "lanes": lanes["k1_launches"],
        "mono_offline": mono["k1_launches"], "mono_scan": mscan["k1_launches"],
        "mono_loop_scale": ls["k1_launches"], "mono_loop_merge": lm["k1_launches"],
        "mono_loop_folded": lf["k1_launches"],
        "gba": gba["k1_launches"], "archive": arch["k1_launches"],
        "resume": resume["k1_launches"], "culling": cull["k1_launches"],
        "culling_keep": keep["k1_launches"],
        "batched_scan": bscan["k1_launches"],
        "system_scan": s_scan["k1_launches"],
        "system_offline": s_off["k1_launches"],
        "system_host": s_host["k1_launches"],
        "multi_device_fleet": fl["k1_launches"],
        "multi_device_offline": off["k1_launches"],
        "multi_device_dryrun": md["dryrun"]["k1_launches"],
        "entry": md["entry"]["k1_launches"],
        "bench": bench["k1_launches"]}
    k1b["launches_by_path"] = {"scan": scan["k1b_launches"]}
    # K3 and K4 on every path that K1 runs on (stress: both of its runs;
    # degradation: every row; bench: its process, warm-ups included)
    k34_paths = {
        "offline": res, "scan": scan, "hole_scan": hole,
        "system_holes": s_holes, "stress": stress,
        "degradation": degr_k34, "real_data": real, "lanes": lanes,
        "mono_offline": mono, "mono_scan": mscan, "mono_loop_scale": ls,
        "mono_loop_merge": lm, "mono_loop_folded": lf, "gba": gba,
        "archive": arch, "resume": resume, "culling": cull,
        "culling_keep": keep, "batched_scan": bscan, "system_scan": s_scan,
        "system_offline": s_off, "system_host": s_host,
        "multi_device_fleet": fl, "multi_device_offline": off,
        "multi_device_dryrun": md["dryrun"], "entry": md["entry"],
        "bench": bench}
    lba_rec["launches"] = scan["lba_launches"]
    lba_rec["launches_by_path"] = {k: r["lba_launches"] for k, r in k34_paths.items()}
    tri_rec["launches"] = scan["tri_launches"]
    tri_rec["launches_by_path"] = {k: r["tri_launches"] for k, r in k34_paths.items()}
    # where a path reports the scan's counters, every local BA it made was
    # one K3 launch
    for name, r in k34_paths.items():
        c = r.get("scan_stats", r)
        if "lba_kernel" in c:
            _require(r["lba_launches"] == c["lba_kernel"] == c["kf_events"],
                     f"{name}: every local BA of the scan is one K3 launch: "
                     f"{r['lba_launches']} launches, lba_kernel {c['lba_kernel']}, "
                     f"{c['kf_events']} keyframe events")
    print("K3 launches by path " + json.dumps(lba_rec["launches_by_path"])
          + f"; K4 {json.dumps(tri_rec['launches_by_path'])} ({card})", flush=True)
    gn["launches"] = scan["gn_launches"]
    gn["launches_by_path"] = {
        "offline": res["gn_launches"], "scan": scan["gn_launches"],
        "lanes": lanes["gn_launches"], "mono_offline": mono["gn_launches"],
        "mono_scan": mscan["gn_launches"]}

    # ---- 19. result ----
    print(f"chip_smoke: every phase passed in {time.perf_counter() - t_start:.1f} s "
          f"({card})", flush=True)
    print(json.dumps({"kernels": [k1, k1b, gn, lba_rec, tri_rec]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
