"""Sliding-window local bundle adjustment as batched block Gauss-Newton
(counterpart of ``visionx_slam_tpu/models/local_ba.py``).

Alternating pose/point passes over the newest ``window_size`` keyframes
with Huber weights, the reprojection gate, 1e-6 Tikhonov damping, left
SE(3) retraction and a relative-cost convergence test; the JAX package's
sign fix of the reference's Gauss-Newton update is kept. The point pass
works on a compact bucket table of the window's landmarks: observations
sorted by landmark once, per-iteration segment sums of 3x3 / 3x1 blocks
(``ops.index.segment_sum``: a fixed order, so the same bits in every run on
CUDA too), closed-form 3x3 solves.

On CUDA tensors the whole call is one launch of kernel K3
(``csrc/local_ba.cu``): the window, the buckets, every iteration and the
convergence test run on the card, and the host reads nothing. On CPU
tensors the plain version (``_local_ba_plain``) runs; there is no fallback
between the two.

The plain version's iteration loop: with ``early_exit`` the host reads the
``done`` flag after every iteration and stops at convergence (one device
read per iteration; the JAX package's ``while_loop``); without it the loop
runs ``max_iterations`` masked iterations and reads nothing (its ``scan``).
Both give the same map, iterations, cost and observation count as the JAX
variant of the same name; ``BAStats.host_reads`` counts the reads. K3 runs
either variant on the card (it stops when ``done`` is set, or runs the
masked iterations) with no read.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import NamedTuple

import torch

from ..ops import cuda_build
from ..ops.camera import CameraParams
from ..ops.index import segment_sum, segments, stable_argsort
from ..ops.linalg import chol_solve6x6, solve3x3
from ..ops.se3 import Pose, quat_to_matrix, se3_compose, se3_exp
from ..tracking import mapstate as msl
from ..tracking.mapstate import MapState
from ..utils import flops

# kernel K3, a whole ``local_ba`` call on the card
_K3_SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "local_ba.cu"
# kf_q, kf_t, kf_id, kf_px, kf_fvalid, kf_feat_lm, lm_pos, lm_alive, lm_obs,
# stats, workspace, layout, params, stream (see the .cu file's foot)
_K3_ARGTYPES = (ctypes.c_void_p,) * 14
_K3_MAX_WINDOW = 1024     # window slots: their state in shared memory
_K3_MAX_ROWS = 1 << 28    # window x features: int indices of the workspace
lba_launches = 0          # K3 launches since import (or the last reset by a caller)


class BAOptions(NamedTuple):
    """Mirrors LocalBA::Options (see the JAX package for each field)."""

    window_size: int = 5
    max_iterations: int = 5
    min_pose_observations: int = 20
    min_point_observations: int = 2
    huber_delta: float = 5.0
    max_reproj_error: float = 5.0
    rel_tol: float = 1e-6
    early_exit: bool = False


class BAStats(NamedTuple):
    iterations: torch.Tensor  # [] int32, iterations actually applied
    final_cost: torch.Tensor  # [] f32, weighted squared-error cost
    total_obs: torch.Tensor   # [] int32, observations in the last pose pass
    host_reads: int = 0       # device-to-host reads made by the early exit


def _proj_jacobian(cam: CameraParams, pc: torch.Tensor) -> torch.Tensor:
    """d(pixel)/d(pc): [...,2,3] (reference ProjectionJacobian)."""
    inv_z = 1.0 / torch.clamp(pc[..., 2], min=1e-6)
    zeros = torch.zeros_like(inv_z)
    return torch.stack(
        [
            torch.stack([cam.fx * inv_z, zeros, -cam.fx * pc[..., 0] * inv_z**2], -1),
            torch.stack([zeros, cam.fy * inv_z, -cam.fy * pc[..., 1] * inv_z**2], -1),
        ],
        -2,
    )


def _huber_w(err_norm: torch.Tensor, delta: float) -> torch.Tensor:
    """Huber weight: 1 inside delta, delta/err outside."""
    return torch.where(err_norm <= delta, 1.0, delta / torch.clamp(err_norm, min=1e-12))


def local_ba(ms: MapState, cam: CameraParams,
             opts: BAOptions = BAOptions()) -> tuple[MapState, BAStats]:
    """Windowed alternating GN on the map; updates the window's keyframe
    poses and landmark positions in place and returns (state, stats). For
    CUDA tensors the whole call is one launch of kernel K3, for CPU tensors
    the plain version runs (module docstring). Either way it records K3's
    analytic work with ``utils.flops``."""
    dev = ms.kf_q.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    W = min(max(1, opts.window_size), ms.kf_capacity)
    with flops.unit("local_ba",
                    flops.k3_ops(W, ms.n_features, opts.max_iterations),
                    flops.k3_bytes(ms.kf_capacity, W, ms.n_features)):
        if dev.type == "cpu":
            return _local_ba_plain(ms, cam, opts)
        return _launch_k3(ms, cam, opts, W)


def _k3_layout(ms: MapState, opts: BAOptions, W: int) -> list:
    """K3's int64 layout for a window of ``W`` slots: [K, N, Lp, W,
    iterations, min_pose_observations, min_point_observations,
    early_exit]. Raises on what K3 does not take: a field of another dtype
    or shape than ``empty_map`` makes, one not contiguous (K3 writes the
    tables in place), more than ``_K3_MAX_WINDOW`` window slots or
    ``_K3_MAX_ROWS`` window features."""
    K, N, Lp = ms.kf_capacity, ms.kf_px.shape[-1], ms.lm_pos.shape[-1]
    want = {"kf_q": ((K, 4), torch.float32), "kf_t": ((K, 3), torch.float32),
            "kf_id": ((K,), torch.int32), "kf_px": ((K, 2, N), torch.float32),
            "kf_fvalid": ((K, N), torch.bool),
            "kf_feat_lm": ((K, N), torch.int32),
            "lm_pos": ((3, Lp), torch.float32), "lm_alive": ((Lp,), torch.bool),
            "lm_obs": ((Lp,), torch.int32)}
    for name, (shape, dtype) in want.items():
        x = getattr(ms, name)
        if tuple(x.shape) != shape or x.dtype != dtype:
            raise ValueError(f"K3 takes {name} {shape} {dtype}; got "
                             f"{tuple(x.shape)} {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"K3 takes contiguous tables; {name} is not")
    if not 1 <= W <= min(K, _K3_MAX_WINDOW):
        raise ValueError(f"K3 takes 1 to {_K3_MAX_WINDOW} window slots of at "
                         f"most K={K}; got {W}")
    if N < 1 or W * N > _K3_MAX_ROWS:
        raise ValueError(f"K3 takes at most {_K3_MAX_ROWS} window features; "
                         f"got {W} x {N}")
    if not 1 <= Lp < 2 ** 31 - 1:
        raise ValueError(f"K3 takes 1 to 2**31 - 2 landmark rows; got {Lp}")
    return [K, N, Lp, W, max(opts.max_iterations, 0),
            opts.min_pose_observations, opts.min_point_observations,
            int(opts.early_exit)]


def _launch_k3(ms: MapState, cam: CameraParams, opts: BAOptions,
               W: int) -> tuple[MapState, BAStats]:
    """One launch of K3 on the current stream (no host read)."""
    global lba_launches
    layout = _k3_layout(ms, opts, W)
    dev = ms.kf_q.device
    if any(x.device != dev for x in ms):
        raise ValueError("K3 takes a map on one device")
    stats = torch.empty(3, dtype=torch.int32, device=dev)
    S = W * ms.n_features
    # the buckets' heads, positions and flags (6 S), the sort keys' room
    # where they do not fit in shared memory (2 P, P the power of two >= S)
    P = 1 << (S - 1).bit_length()
    work = torch.empty(6 * S + 2 * P, dtype=torch.int32, device=dev)
    params = (ctypes.c_float * 7)(cam.fx, cam.fy, cam.cx, cam.cy,
                                  opts.huber_delta, opts.max_reproj_error,
                                  opts.rel_tol)
    k3 = cuda_build.entry(_K3_SOURCE, "vxs_local_ba", _K3_ARGTYPES)
    tables = (ms.kf_q, ms.kf_t, ms.kf_id, ms.kf_px, ms.kf_fvalid,
              ms.kf_feat_lm, ms.lm_pos, ms.lm_alive, ms.lm_obs, stats, work)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = k3(*(x.data_ptr() for x in tables),
                 (ctypes.c_longlong * 8)(*layout), params, stream)
    if err != 0:
        raise RuntimeError(f"K3 launch failed with CUDA error {err}")
    lba_launches += 1
    return ms, BAStats(iterations=stats[0],
                       final_cost=stats[1:2].view(torch.float32)[0],
                       total_obs=stats[2])


def build_lba_kernel() -> None:
    """Compile and load K3 now (otherwise at the first launch)."""
    cuda_build.entry(_K3_SOURCE, "vxs_local_ba", _K3_ARGTYPES)


def _local_ba_plain(ms: MapState, cam: CameraParams,
                    opts: BAOptions = BAOptions()) -> tuple[MapState, BAStats]:
    """The plain version of kernel K3: ``local_ba`` runs it for CPU
    tensors."""
    W = max(1, opts.window_size)
    slots, wvalid = msl.window_slots(ms, W)
    W = slots.shape[0]
    dev = ms.kf_q.device
    dt = ms.kf_q.dtype
    Lp = ms.lm_physical
    N = ms.n_features
    n_kf = wvalid.sum()

    f_px = ms.kf_px[slots].transpose(1, 2)                   # [W,N,2]
    f_lm = ms.kf_feat_lm[slots]
    has_lm = ms.kf_fvalid[slots] & wvalid[:, None] & (f_lm >= 0)

    # compact window-landmark buckets (links are fixed inside BA)
    S = W * N
    base_lm = torch.where(has_lm, f_lm.clamp(0, Lp - 1), Lp).reshape(-1).long()
    seg_order = stable_argsort(base_lm)
    seg_idx = base_lm[seg_order]
    is_new = torch.ones_like(seg_idx, dtype=torch.bool)
    is_new[1:] = seg_idx[1:] != seg_idx[:-1]
    loc_sorted = torch.cumsum(is_new.long(), 0) - 1          # bucket id
    uniq_lm = torch.full((S,), Lp, dtype=torch.long, device=dev)
    uniq_lm[loc_sorted] = seg_idx                           # equal values per bucket
    uniq_real = uniq_lm < Lp
    uniq_clip = uniq_lm.clamp(0, Lp - 1)
    loc_flat = torch.empty_like(loc_sorted)
    loc_flat[seg_order] = loc_sorted
    # the rows without a landmark (the last bucket) are summed by nobody
    buckets = segments(torch.where(base_lm < Lp, loc_flat, S), S, seg_order)
    loc_flat = loc_flat.reshape(W, N)

    alive_u = ms.lm_alive[uniq_clip] & uniq_real
    lm_eligible_u = alive_u & (ms.lm_obs[uniq_clip] >= opts.min_point_observations)
    enabled = (n_kf >= 2) & lm_eligible_u.any()
    alive_f = alive_u[loc_flat]
    eligible_f = lm_eligible_u[loc_flat]
    eye6 = 1e-6 * torch.eye(6, dtype=dt, device=dev)
    eye3 = 1e-6 * torch.eye(3, dtype=dt, device=dev)

    def residuals(q, t, pos_c):
        pw = pos_c[:, loc_flat].permute(1, 2, 0)              # [W,N,3]
        pc = pw @ quat_to_matrix(q).transpose(1, 2) + t[:, None, :]
        z_ok = pc[..., 2] > 1e-6
        zs = torch.clamp(pc[..., 2], min=1e-6)
        uv = torch.stack([cam.fx * pc[..., 0] / zs + cam.cx,
                          cam.fy * pc[..., 1] / zs + cam.cy], -1)
        err = f_px - uv                                       # measured - projected
        err_n = torch.linalg.norm(err, dim=-1)
        obs = has_lm & alive_f & z_ok & (err_n <= opts.max_reproj_error)
        return err, pc, obs, _huber_w(err_n, opts.huber_delta)

    def iteration(q, t, pos_c, last_cost, done, iters):
        # ---- pose pass (landmarks fixed) ----
        err, pc, obs, w = residuals(q, t, pos_c)
        ww = torch.where(obs, w, 0.0)
        cost = (ww * (err * err).sum(-1)).sum()
        total_obs = obs.sum().to(torch.int32)
        Jp = _proj_jacobian(cam, pc)                          # [W,N,2,3]
        J = torch.cat([Jp, torch.linalg.cross(pc[..., None, :].expand_as(Jp), Jp)], -1)
        Jf = J.reshape(W, 2 * N, 6)
        Jw = Jf * ww.repeat_interleave(2, dim=-1)[..., None]
        H = Jw.transpose(1, 2) @ Jf + eye6
        b = (Jw.transpose(1, 2) @ err.reshape(W, -1, 1))[..., 0]
        dx = chol_solve6x6(H, b)
        apply_pose = ((obs.sum(1) >= opts.min_pose_observations) & wvalid
                      & ~done & enabled & torch.isfinite(dx).all(-1))
        newp = se3_compose(se3_exp(torch.where(apply_pose[:, None], dx, 0.0)),
                           Pose(q, t))
        q2, t2 = newp.q, newp.t

        # ---- point pass (poses fixed) ----
        err2, pc2, obs2, w2 = residuals(q2, t2, pos_c)
        obs2 = obs2 & eligible_f
        ww2 = torch.where(obs2, w2, 0.0)
        Jpt = _proj_jacobian(cam, pc2) @ quat_to_matrix(q2)[:, None]   # [W,N,2,3]
        Hc = Jpt.transpose(-1, -2) @ (Jpt * ww2[..., None, None])       # [W,N,3,3]
        bc = (Jpt.transpose(-1, -2) @ (err2 * ww2[..., None])[..., None])[..., 0]
        table = segment_sum(torch.cat([Hc.reshape(-1, 9), bc.reshape(-1, 3),
                                       obs2.reshape(-1, 1).to(dt)], -1), buckets)
        dp = solve3x3(table[:, :9].reshape(S, 3, 3) + eye3, table[:, 9:12])
        apply_pt = ((table[:, 12] >= opts.min_point_observations) & lm_eligible_u
                    & ~done & enabled & torch.isfinite(dp).all(-1))
        pos_c2 = torch.where(apply_pt[None, :], pos_c + dp.T, pos_c)

        # ---- convergence ----
        converged = (total_obs == 0) | (
            (last_cost - cost).abs() < opts.rel_tol * last_cost)
        iters = iters + torch.where(done | ~enabled, 0, 1).to(torch.int32)
        return q2, t2, pos_c2, cost, done | converged, iters, total_obs

    q, t = ms.kf_q[slots], ms.kf_t[slots]
    pos_c = ms.lm_pos[:, uniq_clip]
    cost = torch.full((), torch.finfo(torch.float32).max, dtype=dt, device=dev)
    done = ~enabled
    iters = torch.zeros((), dtype=torch.int32, device=dev)
    total_obs = torch.zeros((), dtype=torch.int32, device=dev)
    reads = 0
    if opts.early_exit and opts.max_iterations > 0:
        # the while-loop variant, stopped on the host. The first iteration
        # runs before any read (a disabled window applies no update in it);
        # if the window was disabled, the loop ran no iteration at all.
        def read(*flags):
            nonlocal reads
            reads += 1
            return torch.stack(flags).tolist()

        out = iteration(q, t, pos_c, cost, done, iters)
        was_done, now_done = read(done, out[4])
        if not was_done:
            q, t, pos_c, cost, done, iters, total_obs = out
            for _ in range(opts.max_iterations - 1):
                if now_done:
                    break
                q, t, pos_c, cost, done, iters, total_obs = iteration(
                    q, t, pos_c, cost, done, iters)
                now_done = read(done)[0]
    else:
        for _ in range(opts.max_iterations):
            q, t, pos_c, cost, done, iters, total_obs = iteration(
                q, t, pos_c, cost, done, iters)

    ms.kf_q[slots] = torch.where(wvalid[:, None], q, ms.kf_q[slots])
    ms.kf_t[slots] = torch.where(wvalid[:, None], t, ms.kf_t[slots])
    # padding buckets point at the last physical row and write its own value
    ms.lm_pos[:, uniq_clip] = torch.where(uniq_real[None], pos_c,
                                          ms.lm_pos[:, uniq_clip])
    return ms, BAStats(iterations=iters, final_cost=cost, total_obs=total_obs,
                       host_reads=reads)
