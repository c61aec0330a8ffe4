"""Offline SLAM over a whole RGB-D sequence as batched stages (the RGB-D,
single-sequence path of ``visionx_slam_tpu/tracking/offline_pipeline.py``).

Stages, as in the JAX package:

1. ORB over all frames, in chunks of ``extract_chunk`` frames (K1 runs on
   the whole chunk's atlases at once);
2. consecutive-pair Hamming matching and 3. RGB-D PnP RANSAC, batched over
   chunks of ``pair_chunk`` pairs;
4. absolute poses by a log-step prefix composition over SE(3);
5. the keyframe policy (a scalar recurrence, run on the host);
6. the keyframe chain (direct keyframe-pair PnP), ``build_keyframe_map``
   and its observation links;
7. one Gauss-Newton pass of ``global_ba``;
8. a batched re-track of every frame against its keyframe's landmarks.

A failed pair freezes its relative pose at identity. Randomness comes from
``torch.Generator``s seeded per stage (29, 31, 37 — the JAX package's key
seeds); the bits differ from ``jax.random``'s, so results agree with the JAX
package statistically, not bit for bit.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..models import matching
from ..models.estimation import pnp_ransac
from ..models.global_ba import GlobalBAOptions, global_ba
from ..models.orb_torch import orb_extract
from ..ops.camera import CameraParams, backproject, project_pinhole
from ..ops.index import stable_argsort, take_rows
from ..ops.se3 import (
    Pose,
    identity_pose,
    se3_apply,
    se3_compose,
    se3_inverse,
    se3_matrix,
)
from ..utils.config import TrackingOptions
from . import mapstate as msl
from . import stages
from .mapstate import FREE, MapState, PairLinks


class OfflineOut(NamedTuple):
    pose: torch.Tensor         # [T,4,4] T_cw
    tracked: torch.Tensor      # [T] bool
    n_matches: torch.Tensor    # [T] int32 (vs previous frame; 0 for frame 0)
    n_inliers: torch.Tensor    # [T] int32
    parallax: torch.Tensor     # [T] float32 (vs previous frame)
    is_keyframe: torch.Tensor  # [T] bool
    n_keyframes: torch.Tensor  # [] int32
    n_landmarks: torch.Tensor  # [] int32


def _chunked(fn, chunk: int, *args):
    """``fn(*args)`` on batched tensors, in chunks of the leading axis
    (bounds the live [chunk, N, N] distance matrices); outputs are
    concatenated along the leading axis."""
    M = args[0].shape[0]
    if chunk <= 0 or M <= chunk:
        return fn(*args)
    outs = [fn(*(a[i:i + chunk] for a in args)) for i in range(0, M, chunk)]
    return tuple(torch.cat(parts) for parts in zip(*outs))


def _compose_scan(q: torch.Tensor, t: torch.Tensor) -> Pose:
    """Inclusive prefix composition prefix[i] = value[i] ∘ prefix[i-1] by
    log-step doubling (the combine of the JAX associative scan)."""
    n = q.shape[0]
    d = 1
    while d < n:
        c = se3_compose(Pose(q[d:], t[d:]), Pose(q[:-d], t[:-d]))
        q = torch.cat([q[:d], c.q])
        t = torch.cat([t[:d], c.t])
        d *= 2
    return Pose(q, t)


def _normalized(q: torch.Tensor) -> torch.Tensor:
    return q / torch.clamp(torch.linalg.norm(q, dim=-1, keepdim=True), min=1e-12)


def _keyframe_policy(opts: TrackingOptions, n_inl, parallax, ok) -> np.ndarray:
    """The reference keyframe policy (tracking.cpp:562-575) over per-pair
    stats, accumulating parallax since the last keyframe. A scalar
    recurrence of T-1 steps: it runs on the host, in float32 like the JAX
    scan. Returns is_kf [T] (frame 0 is a keyframe)."""
    n_inl = n_inl.cpu().numpy()
    parallax = parallax.cpu().numpy().astype(np.float32)
    ok = ok.cpu().numpy()
    acc = np.float32(0.0)
    last_kf = 0
    is_kf = np.zeros(len(n_inl) + 1, bool)
    is_kf[0] = True
    for j in range(len(n_inl)):
        i = j + 1
        acc = np.float32(acc + parallax[j])
        need = (bool(ok[j]) and n_inl[j] >= opts.min_keyframe_inliers
                and acc >= opts.min_parallax
                and (i - last_kf) >= opts.min_keyframe_gap)
        if need:
            acc = np.float32(0.0)
            last_kf = i
        is_kf[i] = need
    return is_kf


def build_keyframe_map(
    cam: CameraParams,
    opts: TrackingOptions,
    kf_q: torch.Tensor,        # [K,4]
    kf_t: torch.Tensor,        # [K,3]
    kf_id: torch.Tensor,       # [K] int32, -1 = dead slot
    kf_px: torch.Tensor,       # [K,N,2]
    kf_desc: torch.Tensor,     # [K,N,32] uint8
    kf_fvalid: torch.Tensor,   # [K,N]
    kf_depth: torch.Tensor,    # [K,N]
    lm_capacity: int,
    pair_chunk: int = 16,
):
    """A MapState from posed keyframe observations in one batch:
    depth-backprojected landmarks with contiguous allocation in
    (keyframe, feature) order, then observation links from consecutive
    keyframe matching. Returns (MapState, PairLinks)."""
    K, N = kf_fvalid.shape
    dev = kf_q.device
    kvalid = kf_id >= 0
    kf_fvalid = kf_fvalid & kvalid[:, None]
    want = kf_fvalid & (kf_depth >= stages.MIN_DEPTH) & (kf_depth <= stages.MAX_DEPTH)
    pc = backproject(cam, kf_px, kf_depth)
    inv = se3_inverse(Pose(kf_q, kf_t))
    pw = se3_apply(Pose(inv.q[:, None], inv.t[:, None]), pc)    # [K,N,3] world
    want_flat = want.reshape(-1)
    rank = torch.cumsum(want_flat.long(), 0) - 1
    L = lm_capacity
    ok_alloc = want_flat & (rank < L)
    slots_flat = torch.where(ok_alloc, rank, FREE)
    n_created = ok_alloc.sum()

    Lp = L + N
    scatter_idx = torch.where(ok_alloc, rank, Lp)
    order = stable_argsort(scatter_idx)
    sidx = scatter_idx[order]
    # allocation is contiguous: every created slot is written exactly once
    new = rank[ok_alloc]
    lm_pos = torch.zeros((3, Lp), dtype=torch.float32, device=dev)
    lm_pos[:, new] = pw.reshape(-1, 3)[ok_alloc].T
    lm_alive = torch.zeros((Lp,), dtype=torch.bool, device=dev)
    lm_alive[new] = True
    lm_obs = torch.zeros((Lp,), dtype=torch.int32, device=dev)
    lm_obs[new] = 1

    i32 = lambda v: torch.as_tensor(v, device=dev).to(torch.int32)
    ms = MapState(
        kf_q=kf_q, kf_t=kf_t, kf_id=kf_id.to(torch.int32),
        kf_px=kf_px.transpose(1, 2).contiguous(),
        kf_desc=kf_desc, kf_fvalid=kf_fvalid,
        kf_feat_lm=slots_flat.reshape(K, N).to(torch.int32),
        kf_depth=kf_depth,
        lm_pos=lm_pos, lm_alive=lm_alive, lm_obs=lm_obs,
        next_kf=i32(kvalid.sum()),
        next_lm=i32(torch.clamp(n_created, max=L)),
        lm_dropped=i32(want_flat.sum() - n_created),
    )
    ms, adopter, creator = _link_consecutive_keyframes(ms, cam, opts, pair_chunk)
    links = PairLinks(created=ok_alloc.reshape(K, N), adopter=adopter,
                      creator=creator, order=order, sidx=sidx)
    return ms, links


def _link_consecutive_keyframes(ms: MapState, cam: CameraParams,
                                opts: TrackingOptions, pair_chunk: int = 16):
    """Match each keyframe to the next and point the later keyframe's
    matched FREE features at the earlier one's landmarks, gated by
    reprojection into the later keyframe; one query per target feature
    (best distance, then lowest query index). ``lm_prev`` is read from the
    pre-adoption table, so adoption never chains within a pass. Returns
    (ms, adopter [K,N], creator [K,N])."""
    K = ms.kf_capacity
    N = ms.n_features
    L = ms.lm_physical
    dev = ms.kf_q.device
    res = matching.MatchResult(*_chunked(
        lambda *a: tuple(matching.match_frames(*a)), pair_chunk,
        ms.kf_desc[:-1], ms.kf_fvalid[:-1], ms.kf_desc[1:], ms.kf_fvalid[1:]))

    lm_prev = ms.kf_feat_lm[:-1].long()                      # [K-1,N]
    lm_next = ms.kf_feat_lm[1:].long()
    lmi = lm_prev.clamp(0, L - 1)
    pw = ms.lm_pos[:, lmi].permute(1, 2, 0)                  # [K-1,N,3]
    uv, ok_z, _ = project_pinhole(
        cam, Pose(ms.kf_q[1:, None], ms.kf_t[1:, None]), pw)
    px_at = take_rows(ms.kf_px[1:].transpose(1, 2), res.idx)
    err = torch.linalg.norm(uv - px_at, dim=-1)
    target_prev = torch.gather(lm_next, 1, res.idx)
    adopt = (res.valid & (lm_prev >= 0) & ok_z
             & (err <= opts.triangulation_max_reproj_error)
             & (target_prev < 0))

    # dedupe: one query per target feature (best distance first)
    combo = torch.where(adopt, res.idx.float() * 512.0
                        + torch.clamp(res.dist, max=511.0), torch.inf)
    order = stable_argsort(combo, dim=1)
    key_sorted = torch.gather(torch.where(adopt, res.idx, -1), 1, order)
    first = torch.cat([torch.ones_like(key_sorted[:, :1], dtype=torch.bool),
                       key_sorted[:, 1:] != key_sorted[:, :-1]], dim=1)
    winner = torch.zeros_like(adopt)
    winner.scatter_(1, order, first & (key_sorted >= 0))
    adopt = adopt & winner

    # scatter into a buffer with one spare column for the non-adopting rows
    rows = torch.where(adopt, res.idx, N)
    new_next = torch.cat([lm_next, lm_next.new_zeros(K - 1, 1)], 1)
    new_next.scatter_(1, rows, torch.where(adopt, lm_prev, 0))
    kf_feat_lm = torch.cat([ms.kf_feat_lm[:1], new_next[:, :N].to(torch.int32)])

    qidx = torch.arange(N, device=dev).expand(K - 1, N)
    creator_rows = torch.full((K - 1, N + 1), -1, dtype=torch.int32, device=dev)
    creator_rows.scatter_(1, rows, torch.where(adopt, qidx, -1).to(torch.int32))
    none = torch.full((1, N), -1, dtype=torch.int32, device=dev)
    creator = torch.cat([none, creator_rows[:, :N]])
    adopter = torch.cat([torch.where(adopt, res.idx, -1).to(torch.int32), none])

    # observation counts: +1 per adopted link
    obs = torch.cat([ms.lm_obs, ms.lm_obs.new_zeros(1)])
    obs.index_add_(0, torch.where(adopt, lmi, L).reshape(-1),
                   torch.ones(adopt.numel(), dtype=obs.dtype, device=dev))
    return (ms._replace(kf_feat_lm=kf_feat_lm, lm_obs=obs[:L]), adopter,
            creator)


def build_offline_pipeline(
    opts: TrackingOptions,
    *,
    n_features_cap: int = 1024,
    kf_capacity: int = 128,
    extract_chunk: int = 8,
    pair_chunk: int = 32,
    pnp_hypotheses: int = 16,
    # one GN pass of global BA: the re-track stage re-estimates every frame
    # against the refined landmarks and dominates the final ATE
    refine_iterations: int = 1,
    gba_cg_iterations: int = 8,
    retrack_refine_iters: int = 3,
    retrack_hypotheses: int = 8,
):
    """Returns run(cam, images [T,H,W] u8, depths [T,H,W] f32, timings=None)
    -> (MapState, OfflineOut), on the device of the inputs; its stages are
    also exposed as run.pre, run.refine and run.post. ``timings``: if a dict
    is given, it is filled with each stage's seconds (the stages then
    synchronize the device at their ends)."""
    N = n_features_cap
    K = kf_capacity
    L = K * N  # the allocator's worst case: no landmark is ever dropped

    def pair_pose(cam, gen, pts3d, pts2d, vv, dcur, refine):
        ident = identity_pose((len(vv),), device=vv.device)
        sol = pnp_ransac(cam, pts3d, pts2d, vv, gen, opts.max_reproj_error,
                         n_hypotheses=pnp_hypotheses, refine_iters=refine,
                         init_pose=ident, depth_curr=dcur)
        ok = (sol.ok & (sol.n_inliers >= opts.min_inliers)
              & torch.isfinite(sol.pose.q).all(-1)
              & torch.isfinite(sol.pose.t).all(-1))
        return sol.pose, sol.n_inliers, ok

    def run_pre(cam: CameraParams, images, depths, clock=None):
        clock = clock or _StageClock(None, images.device)
        dev = images.device
        T = images.shape[0]
        ident = identity_pose(device=dev)

        # ---- 1. extraction in chunks of frames ----
        feats = []
        for i in range(0, T, extract_chunk):
            px_c, _, desc_c, valid_c = orb_extract(
                images[i:i + extract_chunk], n_slots=N)
            dfeat_c = stages.sample_depth_image(depths[i:i + extract_chunk],
                                                px_c, valid_c)
            feats.append((px_c, desc_c, valid_c, dfeat_c))
        px, desc, valid, dfeat = (torch.cat(p) for p in zip(*feats))
        clock.lap("extract")

        # ---- 2+3. consecutive-pair matching + relative pose (light GN
        # polish: this pose only seeds the keyframe policy and the VO
        # chain; the re-track stage re-estimates every frame) ----
        gen = torch.Generator(device=dev).manual_seed(29)

        def pair_track(dq, vq, dt, vt, pxq, pxt, ddq, ddt):
            m = matching.match_frames(dq, vq, dt, vt)
            pc = backproject(cam, pxq, ddq)
            pvalid = (m.valid & (ddq >= stages.MIN_DEPTH)
                      & (ddq <= stages.MAX_DEPTH))
            pose, n_i, ok_i = pair_pose(cam, gen, pc, take_rows(pxt, m.idx),
                                        pvalid, torch.gather(ddt, 1, m.idx), 2)
            return (pose.q, pose.t, n_i, ok_i,
                    m.valid.sum(-1).to(torch.int32),
                    stages.parallax_px(pxq, pxt, m))

        rq, rt, n_inl, ok, n_matches, parallax = _chunked(
            pair_track, pair_chunk,
            desc[:-1], valid[:-1], desc[1:], valid[1:],
            px[:-1], px[1:], dfeat[:-1], dfeat[1:])
        clock.lap("pairs")

        # ---- 4. absolute poses: T_cw[i+1] = rel[i] ∘ ... ∘ rel[0] ----
        prefix = _compose_scan(torch.where(ok[:, None], rq, ident.q),
                               torch.where(ok[:, None], rt, ident.t))
        poses = Pose(torch.cat([ident.q[None], _normalized(prefix.q)]),
                     torch.cat([ident.t[None], prefix.t]))
        tracked = torch.cat([torch.ones(1, dtype=torch.bool, device=dev), ok])

        # ---- 5. keyframe policy (host) ----
        is_kf_np = _keyframe_policy(opts, n_inl, parallax, ok)

        # ---- 6. the last K keyframes, ascending, dead slots first ----
        kf_frames = np.flatnonzero(is_kf_np)[-K:]
        sel = torch.from_numpy(np.concatenate(
            [np.full(K - len(kf_frames), -1), kf_frames])).to(dev)
        kvalid = sel >= 0
        slot_frame = sel.clamp(min=0)
        kf_px = px[slot_frame]
        kf_desc = desc[slot_frame]
        kf_fvalid = valid[slot_frame] & kvalid[:, None]
        kf_depth = dfeat[slot_frame]

        # ---- 6b. keyframe chain: direct PnP between consecutive
        # keyframes, the VO relative pose where it fails ----
        gen_k = torch.Generator(device=dev).manual_seed(31)

        def kf_pair_track(dq, vq, dt, vt, pxq, pxt, ddq, ddt):
            m = matching.match_frames(dq, vq, dt, vt)
            pc = backproject(cam, pxq, ddq)
            pvalid = (m.valid & (ddq >= stages.MIN_DEPTH)
                      & (ddq <= stages.MAX_DEPTH))
            pose, _, ok_i = pair_pose(cam, gen_k, pc, take_rows(pxt, m.idx),
                                      pvalid, torch.gather(ddt, 1, m.idx), 4)
            return pose.q, pose.t, ok_i

        vo_q, vo_t = poses.q[slot_frame], poses.t[slot_frame]
        vo_rel = se3_compose(Pose(vo_q[1:], vo_t[1:]),
                             se3_inverse(Pose(vo_q[:-1], vo_t[:-1])))
        rk_q, rk_t, ok_k = _chunked(
            kf_pair_track, pair_chunk,
            kf_desc[:-1], kf_fvalid[:-1], kf_desc[1:], kf_fvalid[1:],
            kf_px[:-1], kf_px[1:], kf_depth[:-1], kf_depth[1:])
        use_k = (ok_k & kvalid[1:] & kvalid[:-1])[:, None]
        kf_abs = _compose_scan(
            torch.cat([vo_q[:1], torch.where(use_k, rk_q, vo_rel.q)]),
            torch.cat([vo_t[:1], torch.where(use_k, rk_t, vo_rel.t)]))
        ms, links = build_keyframe_map(
            cam, opts, _normalized(kf_abs.q), kf_abs.t, sel.to(torch.int32),
            kf_px, kf_desc, kf_fvalid, kf_depth, L, pair_chunk=pair_chunk)
        clock.lap("map")
        aux = dict(poses_q=poses.q, poses_t=poses.t, tracked=tracked,
                   n_inl=n_inl, n_matches=n_matches, parallax=parallax,
                   is_kf=torch.from_numpy(is_kf_np).to(dev), px=px, desc=desc,
                   valid=valid, dfeat=dfeat)
        return ms, links, aux

    def run_refine(cam: CameraParams, ms: MapState) -> MapState:
        ms, _ = global_ba(ms, cam, GlobalBAOptions(
            max_iterations=max(refine_iterations, 1),
            cg_iterations=gba_cg_iterations))
        return ms

    def run_post(cam: CameraParams, ms: MapState, aux: dict):
        poses = Pose(aux["poses_q"], aux["poses_t"])
        is_kf, px, desc = aux["is_kf"], aux["px"], aux["desc"]
        valid, dfeat = aux["valid"], aux["dfeat"]
        dev = is_kf.device
        T = is_kf.shape[0]
        kvalid = ms.kf_id >= 0
        slot_frame = ms.kf_id.long().clamp(min=0)

        # preceding keyframe of every frame, and its slot
        frame_ids = torch.arange(T, device=dev)
        prev_kf = torch.cummax(torch.where(is_kf, frame_ids, -1), 0).values
        prev_kf = prev_kf.clamp(min=0)
        slot_of_frame = torch.zeros(T + 1, dtype=torch.long, device=dev)
        slot_of_frame[torch.where(kvalid, slot_frame, T)] = torch.arange(
            K, device=dev)                               # row T: dead slots
        kf_slot = slot_of_frame[:T][prev_kf]

        # fallback pose: re-anchor the VO chain to the refined keyframe,
        # T_cw'(f) = T_cw_vo(f) ∘ T_cw_vo(kf)^-1 ∘ T_cw_ref(kf)
        vo_kf = Pose(poses.q[prev_kf], poses.t[prev_kf])
        ref_kf = Pose(ms.kf_q[kf_slot], ms.kf_t[kf_slot])
        poses = se3_compose(poses, se3_compose(se3_inverse(vo_kf), ref_kf))

        # ---- 8. re-track every frame against its preceding keyframe's
        # landmarks; the re-anchored pose competes as the motion prior ----
        Lp = ms.lm_physical
        gen_r = torch.Generator(device=dev).manual_seed(37)

        def frame_retrack(kd, kv, flm, di, vi, pxi, ddi, pq, pt):
            m = matching.match_frames(kd, kv, di, vi)
            lmf = flm.long().clamp(0, Lp - 1)
            p3 = ms.lm_pos[:, lmf].permute(1, 2, 0)      # [P,N,3] world
            pval = (m.valid & (flm >= 0) & ms.lm_alive[lmf]
                    & torch.isfinite(p3).all(-1))
            sol = pnp_ransac(
                cam, p3, take_rows(pxi, m.idx), pval, gen_r,
                opts.max_reproj_error, n_hypotheses=retrack_hypotheses,
                refine_iters=retrack_refine_iters, init_pose=Pose(pq, pt),
                depth_curr=torch.gather(ddi, 1, m.idx))
            ok_i = (sol.ok & (sol.n_inliers >= opts.min_inliers)
                    & torch.isfinite(sol.pose.q).all(-1)
                    & torch.isfinite(sol.pose.t).all(-1))
            return sol.pose.q, sol.pose.t, sol.n_inliers, ok_i

        rt_q, rt_t, rt_inl, rt_ok = _chunked(
            frame_retrack, pair_chunk,
            ms.kf_desc[kf_slot], ms.kf_fvalid[kf_slot], ms.kf_feat_lm[kf_slot],
            desc, valid, px, dfeat, poses.q, poses.t)
        poses = Pose(torch.where(rt_ok[:, None], rt_q, poses.q),
                     torch.where(rt_ok[:, None], rt_t, poses.t))
        zero_i = torch.zeros(1, dtype=torch.int32, device=dev)
        out = OfflineOut(
            pose=se3_matrix(poses),
            tracked=aux["tracked"] | rt_ok,
            n_matches=torch.cat([zero_i, aux["n_matches"]]),
            n_inliers=torch.where(rt_ok, rt_inl,
                                  torch.cat([zero_i, aux["n_inl"]])),
            parallax=torch.cat([aux["parallax"].new_zeros(1), aux["parallax"]]),
            is_keyframe=is_kf,
            n_keyframes=msl.n_keyframes(ms),
            n_landmarks=msl.n_landmarks(ms),
        )
        return ms, out

    def run(cam: CameraParams, images, depths, timings: dict | None = None):
        clock = _StageClock(timings, images.device)
        ms, _, aux = run_pre(cam, images, depths, clock)
        if refine_iterations > 0:
            ms = run_refine(cam, ms)
        clock.lap("refine")
        ms, out = run_post(cam, ms, aux)
        clock.lap("retrack")
        return ms, out

    run.pre, run.refine, run.post = run_pre, run_refine, run_post
    return run


def run_offline_pipeline(
    cam: CameraParams,
    images_u8,                # [T,H,W] uint8 (tensor or numpy)
    depths_m,                 # [T,H,W] float32
    opts: TrackingOptions,
    device="cuda",
    timings: dict | None = None,
    **kw,                     # build_offline_pipeline options
) -> tuple[MapState, OfflineOut]:
    """The RGB-D offline pipeline on ``device`` with the JAX package's
    defaults; returns (MapState, OfflineOut)."""
    dev = torch.device(device)
    images = torch.as_tensor(images_u8).to(dev)
    depths = torch.as_tensor(depths_m).to(dev, torch.float32)
    return build_offline_pipeline(opts, **kw)(cam, images, depths, timings)


class _StageClock:
    """Per-stage wall times; synchronizes the device at each lap, and only
    when a ``timings`` dict was given."""

    def __init__(self, timings: dict | None, device: torch.device):
        self.timings = timings
        self.device = device
        self.t0 = self._now() if timings is not None else 0.0

    def _now(self) -> float:
        import time

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter()

    def lap(self, name: str) -> None:
        if self.timings is None:
            return
        t = self._now()
        self.timings[name] = self.timings.get(name, 0.0) + (t - self.t0)
        self.t0 = t
