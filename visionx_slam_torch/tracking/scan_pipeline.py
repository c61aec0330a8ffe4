"""The online SLAM scan: the per-frame tracker with keyframe creation, map
growth and sliding-window local BA (counterpart of
``visionx_slam_tpu/tracking/scan_pipeline.py``, the non-vmapped scan with
the default stage set).

Extraction depends only on the images, so it runs first over all frames in
chunks (``extract_sequence``: K1 on every chunk's pyramid atlases). The
serial part is a Python loop over frames on the host. The JAX package's
``lax.switch``/``lax.cond`` dispatch (INIT / TRACKING_GOOD / BAD / LOST,
the PnP tiers, the essential fallback, the keyframe event, compaction)
becomes Python branches: a branch not taken costs nothing, as in the
non-vmapped scan. Each decision needs device values on the host; a step
gathers the flags it needs into as few reads as it can (one in a steady
tracked frame, see ``track_branch``), and ``run_scan_pipeline`` counts them.

Host values in ``ScanState``: the state-machine scalars (state code, slots,
frame ids, the last inlier count and parallax) are Python numbers, and
``kf_cursor`` is the host's copy of the map's ring cursor ``ms.next_kf``,
so every keyframe slot is known without a device read. The map tables and
everything per feature stay on the device, updated in place.

Randomness: every frame draws from its own ``torch.Generator`` seeded from
(17, frame id, stream): stream 0 for PnP RANSAC, 1 for essential RANSAC,
the JAX package's ``fold_in(PRNGKey(17), frame_id)`` split into (k1, k2).
A run streamed in chunks (``st0``/``frame0``) therefore draws the same
samples as one long run. The bits differ from ``jax.random``'s.
"""

from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np
import torch

from ..models import matching
from ..models.estimation import (
    essential_ransac,
    essential_scale_from_depth,
    pnp_prior,
    pnp_ransac,
)
from ..models.local_ba import BAOptions, local_ba
from ..models.orb_torch import orb_extract
from ..ops.camera import CameraParams, backproject, project_pinhole
from ..ops.se3 import Pose, identity_pose, matrix_to_quat, se3_compose, se3_matrix
from ..utils.config import TrackingOptions
from ..utils.logging import span
from . import mapstate as msl
from . import stages
from .mapstate import FREE, MapState
from .stages import FrameObs

# state machine codes (reference tracking.h:22)
INIT, GOOD, BAD, LOST = 0, 1, 2, 3

# the reference's 1-degree constant, compared against a float32 parallax
DEG1_RAD = float(np.float32(0.017453292519943295))


class ScanState(NamedTuple):
    ms: MapState
    tstate: int               # state code
    have_init: bool           # first init frame stored
    init_obs: FrameObs
    init_frame_id: int
    init_kf_slot: int
    last_obs: FrameObs
    last_pose: Pose
    cur_pose: Pose
    last_kf_slot: int         # -1 = none
    last_kf_id: int
    last_inliers: int
    last_parallax: float      # a float32 value
    # reference-keyframe caches, refreshed at every map mutation point
    kf_bits: torch.Tensor     # [N,256] bf16 descriptor bit planes
    kf_pop: torch.Tensor      # [N] f32 popcounts
    kf_fvalid: torch.Tensor   # [N] bool
    kf_lm_pts: torch.Tensor   # [N,3] f32 landmark position per feature
    kf_lm_valid: torch.Tensor  # [N] bool feature has a live, sane landmark
    kf_px2: torch.Tensor      # [N,2] f32 keyframe feature pixels
    kf_cursor: int = 0        # host copy of ms.next_kf


class FrameOut(NamedTuple):
    pose: torch.Tensor         # [T,4,4] T_cw (identity when untracked)
    tracked: torch.Tensor      # [T] bool, pose valid this frame
    state: torch.Tensor        # [T] int32 state AFTER the frame
    n_matches: torch.Tensor    # [T] int32
    n_inliers: torch.Tensor    # [T] int32
    parallax: torch.Tensor     # [T] f32
    is_keyframe: torch.Tensor  # [T] bool
    n_keyframes: torch.Tensor  # [T] int32
    n_landmarks: torch.Tensor  # [T] int32


class FrameRecord(NamedTuple):
    """One frame's outputs as the step returns them: pose on the device,
    the decisions as host values, map sizes as device scalars."""

    pose: Pose
    tracked: bool
    state: int
    n_matches: int
    n_inliers: int
    parallax: float
    is_keyframe: bool
    n_keyframes: torch.Tensor
    n_landmarks: torch.Tensor


class ScanCounters:
    """What a run did that the outputs do not show: device-to-host reads
    made by the step's decisions (local BA's convergence reads and the
    keyframe culling's included), landmark compactions, keyframe events,
    the keyframes culling removed, and the local BA iterations and culled
    landmarks (device scalars, read once)."""

    def __init__(self, device=None):
        self.host_syncs = 0
        self.compactions = 0
        self.kf_events = 0
        self.kf_culled = 0
        self.ba_iterations = torch.zeros((), dtype=torch.int64, device=device)
        self.lm_culled = torch.zeros((), dtype=torch.int64, device=device)

    def read(self, *vals: torch.Tensor) -> list:
        """Device values (scalars or vectors) -> one flat list of host
        numbers, in one transfer."""
        self.host_syncs += 1
        return torch.cat([v.reshape(-1).to(torch.float64) for v in vals]).tolist()


def _empty_obs(n: int, device) -> FrameObs:
    return FrameObs(
        px=torch.zeros((n, 2), device=device),
        response=torch.zeros((n,), device=device),
        desc=torch.zeros((n, 32), dtype=torch.uint8, device=device),
        valid=torch.zeros((n,), dtype=torch.bool, device=device),
        depth=torch.zeros((n,), device=device),
    )


def _clear_map(ms: MapState) -> MapState:
    """map_->removeAll() (map.cpp:40-47) as mask resets, in place."""
    ms.kf_id.fill_(-1)
    ms.kf_fvalid.zero_()
    ms.kf_feat_lm.fill_(FREE)
    ms.lm_alive.zero_()
    ms.lm_obs.zero_()
    ms.next_kf.zero_()
    ms.next_lm.zero_()
    ms.lm_dropped.zero_()
    return ms


def _kf_cache_fields(ms: MapState, slot: int) -> dict:
    """The reference-keyframe caches of keyframe ``slot`` (copies): bit
    planes and popcounts, the linked landmark points with the
    pnp_correspondences gates (has a landmark, alive, finite, |p| <= 1000),
    and the pixels."""
    bits, pop = matching.unpack_with_pop(ms.kf_desc[slot])
    feat_lm = ms.kf_feat_lm[slot]
    lmc = feat_lm.clamp(0, ms.lm_physical - 1).long()
    p = ms.lm_pos[:, lmc].T
    lm_valid = ((feat_lm >= 0) & ms.lm_alive[lmc] & torch.isfinite(p).all(-1)
                & (p.abs() <= 1000.0).all(-1))
    return dict(
        kf_bits=bits,
        kf_pop=pop,
        kf_fvalid=ms.kf_fvalid[slot].clone(),
        kf_lm_pts=torch.where(lm_valid[:, None], p, 0.0),
        kf_lm_valid=lm_valid,
        kf_px2=ms.kf_px[slot].T.clone(),
    )


def _empty_kf_cache(n: int, device) -> dict:
    return dict(
        kf_bits=torch.zeros((n, 256), dtype=torch.bfloat16, device=device),
        kf_pop=torch.zeros((n,), device=device),
        kf_fvalid=torch.zeros((n,), dtype=torch.bool, device=device),
        kf_lm_pts=torch.zeros((n, 3), device=device),
        kf_lm_valid=torch.zeros((n,), dtype=torch.bool, device=device),
        kf_px2=torch.zeros((n, 2), device=device),
    )


def frame_generator(frame_id: int, stream: int, device,
                    seed: int = 17) -> torch.Generator:
    """The generator of one frame's RANSAC stream (0: PnP, 1: essential)."""
    g = torch.Generator(device=device)
    g.manual_seed((seed << 40) + 2 * int(frame_id) + stream)
    return g


def tracking_ba_options(opts: TrackingOptions) -> BAOptions:
    """Local BA's options from the tracking options; the loop stops at
    convergence (a single stream pays one read per iteration for it)."""
    return BAOptions(
        window_size=opts.ba_window_size,
        max_iterations=opts.ba_iterations,
        min_pose_observations=opts.ba_min_pose_observations,
        min_point_observations=opts.ba_min_point_observations,
        huber_delta=opts.ba_huber_delta,
        max_reproj_error=opts.ba_max_reproj_error,
        rel_tol=opts.ba_rel_tol,
        early_exit=True,
    )


def insert_init_pair(ms: MapState, cam: CameraParams, opts: TrackingOptions,
                     obs1: FrameObs, frame_id1: int, obs2: FrameObs,
                     frame_id2: int, pose2: Pose, cursor: int,
                     res: matching.MatchResult | None = None):
    """The map of a finished two-frame initialization: both frames become
    keyframes (the first at the identity) in the ring slots after
    ``cursor``, their depth landmarks, then the triangulated ones (``res``:
    the raw knn2 match of the two frames, when the caller has it). Returns
    (map, slot1, slot2)."""
    dev = obs1.px.device
    K, N = ms.kf_capacity, ms.n_features
    free = torch.full((N,), FREE, dtype=torch.int32, device=dev)
    ident = identity_pose(device=dev)
    ms, slot1 = msl.insert_keyframe(
        ms, frame_id1, ident, obs1.px, obs1.desc, obs1.valid, free,
        obs1.depth, fresh_links=True, slot=cursor % K)
    ms, slot2 = msl.insert_keyframe(
        ms, frame_id2, pose2, obs2.px, obs2.desc, obs2.valid, free,
        obs2.depth, fresh_links=True, slot=(cursor + 1) % K)
    ms = stages.depth_landmarks(ms, cam, slot1, ident)
    ms = stages.depth_landmarks(ms, cam, slot2, pose2)
    ms = stages.triangulate_pair(
        ms, cam, slot1, slot2, opts.triangulation_min_angle_deg,
        opts.triangulation_max_reproj_error, res=res)
    return ms, slot1, slot2


def insert_tracked_keyframe(ms: MapState, cam: CameraParams,
                            opts: TrackingOptions, obs: FrameObs,
                            frame_id: int, pose: Pose, prev_slot: int,
                            slot: int, links: torch.Tensor | None = None,
                            res: matching.MatchResult | None = None):
    """A tracked frame becomes the keyframe of ring slot ``slot``: its
    features (``links``: the landmarks they inherit, none by default), its
    depth landmarks, and the landmarks triangulated against the previous
    keyframe ``prev_slot`` (``res``: their raw knn2 match, when the caller
    has it). Returns the map."""
    fresh = links is None
    if fresh:
        links = torch.full((ms.n_features,), FREE, dtype=torch.int32,
                           device=obs.px.device)
    ms, slot = msl.insert_keyframe(
        ms, frame_id, pose, obs.px, obs.desc, obs.valid, links, obs.depth,
        fresh_links=fresh, slot=slot)
    ms = stages.depth_landmarks(ms, cam, slot, pose)
    return stages.triangulate_pair(
        ms, cam, prev_slot, slot, opts.triangulation_min_angle_deg,
        opts.triangulation_max_reproj_error, res=res)


def _frame_obs(obs: FrameObs, i: int) -> FrameObs:
    return FrameObs(*(x[i] for x in obs))


def _select_pose(pose: Pose, i: int) -> Pose:
    return Pose(pose.q[i], pose.t[i])


def build_scan_step(
    cam: CameraParams,
    opts: TrackingOptions,
    img_wh: tuple[int, int],
    *,
    n_features_cap: int = 1024,
    kf_capacity: int = 64,
    lm_capacity: int = 1 << 17,
    stage_limit: int = 2,
    counters: ScanCounters | None = None,
):
    """The per-frame step ``step(st, inp) -> (st, FrameRecord)``, closed
    over static options; ``inp`` = (frame_id, obs, bits, pop, gray_mean,
    gray_std) of one frame, the last two host floats. The branches are
    exposed as ``step.init_first``, ``step.init_second``,
    ``step.track_branch`` and ``step.create_keyframe``.

    ``stage_limit`` is a profiling knob, as in the JAX package: 2 = the
    full pipeline; 0 = extraction only (the step records the frame from
    its observations); 1 = extraction + ``track_branch`` (only ``cur_pose``
    is kept: no init, no keyframe, no map growth); 3 = the matcher against
    the keyframe cache and the distance filter; 4 = 3 + the prior-tier PnP.
    3 and 4 run a fixed chain of ops with no branch (the map stays empty,
    so their values are meaningless, but every frame runs the ops of the
    steady-state chain). Stages 0, 3 and 4 read nothing from the device in
    the step."""
    if stage_limit not in (0, 1, 2, 3, 4):
        raise ValueError(f"stage_limit must be 0-4, got {stage_limit}")
    W_IMG, H_IMG = img_wh
    N = n_features_cap
    K = kf_capacity
    ctr = counters if counters is not None else ScanCounters()
    thr = opts.max_reproj_error
    ba_opts = tracking_ba_options(opts)

    def mat_pose(R, t):
        return Pose(matrix_to_quat(R), t)

    def ok_pose(sol) -> torch.Tensor:
        return (sol.ok & torch.isfinite(sol.pose.q).all(-1)
                & torch.isfinite(sol.pose.t).all(-1))

    # ------------------------------------------------------------------
    def track_branch(st: ScanState, obs: FrameObs, bits, pop, frame_id: int):
        """TRACKING_GOOD: motion-prior PnP against the last keyframe, the
        full PnP RANSAC when that consensus is weak, the essential-matrix
        fallback against the last frame when PnP fails. Returns (state,
        n_matches, inliers, parallax, ok, raw knn2 match, next_lm)."""
        dev = obs.px.device
        m_raw = matching.knn2_from_bits(st.kf_bits, st.kf_pop, st.kf_fvalid,
                                        bits, pop, obs.valid)
        m = matching.reference_distance_filter(m_raw)
        span("match")
        pts2d = obs.px[m.idx]
        pvalid = m.valid & st.kf_lm_valid
        sol = pnp_prior(cam, st.kf_lm_pts, pts2d, pvalid, st.cur_pose, thr,
                        refine_iters=min(2, opts.pnp_refine_iters))
        # the PnP branch's parallax depends only on the match, so it rides
        # the same read as the consensus; the map cursor rides along for
        # this frame's keyframe event
        n_matches, n_pairs, n_inl, sol_ok, parallax, next_lm = ctr.read(
            m.valid.sum(), pvalid.sum(), sol.n_inliers, ok_pose(sol),
            stages.parallax_px(st.kf_px2, obs.px, m), st.ms.next_lm)
        n_matches, n_pairs, n_inl = int(n_matches), int(n_pairs), int(n_inl)
        if n_inl < max(2 * opts.min_inliers, (3 * n_pairs) // 10):
            # weak prior-only consensus: escalate to the full hypothesis fan
            depth_curr = obs.depth[m.idx] if opts.pnp_use_depth else None
            sol = pnp_ransac(
                cam, st.kf_lm_pts[None], pts2d[None], pvalid[None],
                frame_generator(frame_id, 0, dev), thr,
                n_hypotheses=max(64, opts.pnp_hypotheses),
                refine_iters=max(6, opts.pnp_refine_iters),
                init_pose=Pose(st.cur_pose.q[None], st.cur_pose.t[None]),
                depth_curr=None if depth_curr is None else depth_curr[None])
            sol = type(sol)(_select_pose(sol.pose, 0), sol.inlier_mask[0],
                            sol.n_inliers[0], sol.ok[0])
            n_inl, sol_ok = ctr.read(sol.n_inliers, ok_pose(sol))
            n_inl = int(n_inl)
        pnp_ok = (n_matches >= opts.min_matches and n_pairs >= opts.min_inliers
                  and bool(sol_ok) and n_inl >= opts.min_inliers)
        if pnp_ok:
            pose, inliers, ok = sol.pose, n_inl, True
        else:
            mf = matching.match_frames(st.last_obs.desc, st.last_obs.valid,
                                       obs.desc, obs.valid)
            px_c = obs.px[mf.idx]
            ess = essential_ransac(cam, st.last_obs.px, px_c, mf.valid,
                                   frame_generator(frame_id, 1, dev))
            t_rel = ess.t
            if opts.fallback_scale_from_depth:
                t_rel = ess.t * essential_scale_from_depth(
                    cam, ess, st.last_obs.px, px_c, st.last_obs.depth)
            pose = se3_compose(mat_pose(ess.R, t_rel), st.last_pose)
            n_matches, ess_ok, inliers, parallax = ctr.read(
                mf.valid.sum(), ess.ok, ess.n_inliers,
                stages.parallax_px(st.last_obs.px, obs.px, mf))
            n_matches, inliers = int(n_matches), int(inliers)
            ok = (n_matches >= opts.min_matches and bool(ess_ok)
                  and inliers >= opts.min_inliers)
        if ok:
            st = st._replace(cur_pose=pose, last_inliers=inliers,
                             last_parallax=parallax)
        return st, n_matches, inliers, parallax, ok, m_raw, int(next_lm)

    # ------------------------------------------------------------------
    def init_first(st: ScanState, obs: FrameObs, frame_id: int,
                   gray_mean: float, gray_std: float):
        """InitWithFirstFrame (tracking.cpp:177-204)."""
        n, dist_ok = ctr.read(obs.valid.sum(), stages.feature_distribution_ok(
            obs.px, obs.valid, W_IMG, H_IMG))
        quality_ok = 30 <= gray_mean <= 225 and gray_std >= 20
        ok = n >= opts.min_matches and bool(dist_ok) and quality_ok
        if ok:
            st = st._replace(have_init=True, init_obs=obs, init_frame_id=frame_id,
                             cur_pose=identity_pose(device=obs.px.device))
        return st, 0, 0, 0.0, ok, None

    # ------------------------------------------------------------------
    def init_second(st: ScanState, obs: FrameObs, frame_id: int):
        """InitWithSecondFrame (tracking.cpp:206-263) with the RGB-D PnP
        init and the reference's pixel/radian parallax quirk."""
        dev = obs.px.device
        io = st.init_obs
        m_raw = matching.knn2_ratio_match(io.desc, io.valid, obs.desc, obs.valid)
        m = matching.reference_distance_filter(m_raw)
        span("match")
        px_m = obs.px[m.idx]
        flags = [m.valid.sum(), stages.parallax_px(io.px, obs.px, m)]
        if opts.rgbd_init:
            good_d = (io.depth >= stages.MIN_DEPTH) & (io.depth <= stages.MAX_DEPTH)
            pw = backproject(cam, io.px, io.depth)
            pvalid = m.valid & good_d
            depth_curr = obs.depth[m.idx] if opts.pnp_use_depth else None
            sol = pnp_ransac(
                cam, pw[None], px_m[None], pvalid[None],
                frame_generator(frame_id, 0, dev), thr,
                n_hypotheses=max(64, opts.pnp_hypotheses),
                refine_iters=max(6, opts.pnp_refine_iters),
                init_pose=identity_pose((1,), device=dev),
                depth_curr=None if depth_curr is None else depth_curr[None])
            sol_pose = _select_pose(sol.pose, 0)
            flags += [(pvalid.sum() >= opts.min_inliers) & sol.ok[0]
                      & (sol.n_inliers[0] >= opts.min_inliers), sol.n_inliers[0]]
        ess = essential_ransac(cam, io.px, px_m, m.valid,
                               frame_generator(frame_id, 1, dev))
        t_init = ess.t
        if opts.init_scale_from_depth:
            t_init = ess.t * essential_scale_from_depth(cam, ess, io.px, px_m, io.depth)
        pose_e = mat_pose(ess.R, t_init)
        ess_ok = ess.ok & (ess.n_inliers >= opts.min_inliers)
        if opts.min_init_landmarks > 0:
            n_tri = stages.triangulable_count(
                cam, io.px, obs.px[m_raw.idx], m_raw.valid, pose_e,
                opts.triangulation_min_angle_deg,
                opts.triangulation_max_reproj_error)
            ess_ok = ess_ok & (n_tri >= opts.min_init_landmarks)
        vals = ctr.read(*flags, ess_ok, ess.n_inliers)
        n_matches, parallax = int(vals[0]), vals[1]
        ess_ok, ess_n = bool(vals[-2]), int(vals[-1])
        pnp_ok = opts.rgbd_init and bool(vals[2])
        if pnp_ok:
            pose2, inliers = sol_pose, int(vals[3])
        else:
            pose2, inliers = pose_e, ess_n
        ok = (n_matches >= opts.min_matches and (pnp_ok or ess_ok)
              and parallax >= DEG1_RAD)
        if ok:
            cursor = st.kf_cursor
            ms, slot1, slot2 = insert_init_pair(
                st.ms, cam, opts, io, st.init_frame_id, obs, frame_id, pose2,
                cursor, m_raw)
            st = st._replace(
                ms=ms, init_kf_slot=slot1, last_kf_slot=slot2,
                last_kf_id=frame_id, cur_pose=pose2, last_obs=obs,
                last_pose=pose2, last_inliers=inliers, last_parallax=parallax,
                kf_cursor=cursor + 2, **_kf_cache_fields(ms, slot2))
        return st, n_matches, inliers, parallax, ok, m_raw

    # ------------------------------------------------------------------
    def create_keyframe(st: ScanState, obs: FrameObs, frame_id: int,
                        kf_match: matching.MatchResult,
                        next_lm: int | None = None) -> ScanState:
        """CreateKeyFrame + culling + local BA (tracking.cpp:76-85, 577-584).
        ``kf_match``: this frame's raw knn2 match against the previous
        keyframe (reused for triangulation); ``next_lm``: the host's copy of
        the allocation cursor (read from the map when not given)."""
        ms = st.ms
        dev = obs.px.device
        ctr.kf_events += 1
        if next_lm is None:
            next_lm = int(ctr.read(ms.next_lm)[0])
        # recycle dead landmark slots before the allocator runs dry
        if next_lm > lm_capacity - 3 * N:
            ms = msl.compact_landmarks(ms)
            ctr.compactions += 1
        prev_slot = max(st.last_kf_slot, 0)
        idx = kf_match.idx.long()
        if opts.link_tracked_landmarks:
            # the new keyframe's features inherit the landmarks of the
            # previous keyframe's features they matched (reprojection-gated)
            prev_lm = ms.kf_feat_lm[prev_slot]
            lmc = prev_lm.clamp(0, ms.lm_physical - 1).long()
            uv, okp, _ = project_pinhole(cam, st.cur_pose, ms.lm_pos[:, lmc].T)
            err = torch.linalg.norm(uv - obs.px[idx], dim=-1)
            good = (kf_match.valid & (prev_lm >= 0) & ms.lm_alive[lmc]
                    & obs.valid[idx] & okp & (err <= opts.max_reproj_error))
            links = torch.full((N,), FREE, dtype=torch.long, device=dev).scatter_reduce(
                0, idx, torch.where(good, lmc, FREE), "amax").to(torch.int32)
        else:
            links = None
        slot = st.kf_cursor % K
        ms = insert_tracked_keyframe(ms, cam, opts, obs, frame_id, st.cur_pose,
                                     prev_slot, slot, links, kf_match)
        if opts.enable_culling:
            ms, n_culled = stages.cull_landmarks(
                ms, cam, opts.landmark_max_reproj_error,
                opts.min_landmark_observations,
                gate=msl.n_landmarks(ms) >= opts.min_landmarks_for_culling)
            ms, removed, n_culled2 = stages.cull_keyframes_device(
                ms, cam, slot, st.init_kf_slot, frame_id,
                min_keyframes_for_culling=opts.min_keyframes_for_culling,
                max_keyframes=opts.max_keyframes,
                kf_min_shared_observations=opts.kf_min_shared_observations,
                kf_redundant_ratio=opts.kf_redundant_ratio,
                landmark_max_reproj_error=opts.landmark_max_reproj_error,
                min_landmark_observations=opts.min_landmark_observations)
            ctr.host_syncs += 1
            ctr.kf_culled += removed >= 0
            ctr.lm_culled += n_culled + n_culled2
        if opts.enable_local_ba:
            ms, ba = local_ba(ms, cam, ba_opts)
            ctr.ba_iterations += ba.iterations
            ctr.host_syncs += ba.host_reads
        return st._replace(
            ms=ms, last_kf_slot=slot, last_kf_id=frame_id,
            cur_pose=msl.map_pose(ms, slot), kf_cursor=st.kf_cursor + 1,
            # caches refreshed after culling and BA: the next frames PnP
            # against these
            **_kf_cache_fields(ms, slot))

    # ------------------------------------------------------------------
    def reset(st: ScanState) -> ScanState:
        """HandleTrackingBad/Lost (tracking.cpp:477-499)."""
        return st._replace(
            ms=_clear_map(st.ms), tstate=INIT, have_init=False,
            init_kf_slot=-1, last_kf_slot=-1, last_kf_id=-1, last_inliers=0,
            last_parallax=0.0, kf_cursor=0,
            **_empty_kf_cache(N, st.kf_bits.device))

    # ------------------------------------------------------------------
    def profile_step(st: ScanState, obs: FrameObs, bits, pop, frame_id: int):
        """The step at ``stage_limit`` 0, 1, 3 or 4."""
        zero = torch.zeros((), dtype=torch.int32, device=obs.px.device)
        tracked, n_matches = obs.valid.any(), obs.valid.sum().to(torch.int32)
        inliers, parallax, st2 = 0, 0.0, st
        if stage_limit == 1:
            st1, n_matches, inliers, parallax, tracked, _, _ = track_branch(
                st, obs, bits, pop, frame_id)
            st2 = st._replace(cur_pose=st1.cur_pose)
        elif stage_limit in (3, 4):
            m = matching.reference_distance_filter(matching.knn2_from_bits(
                st.kf_bits, st.kf_pop, st.kf_fvalid, bits, pop, obs.valid))
            n_matches = m.valid.sum().to(torch.int32)
            if stage_limit == 4:
                sol = pnp_prior(cam, st.kf_lm_pts, obs.px[m.idx],
                                m.valid & st.kf_lm_valid, st.cur_pose, thr,
                                refine_iters=min(2, opts.pnp_refine_iters))
                inliers = sol.n_inliers
                st2 = st._replace(cur_pose=Pose(
                    torch.where(sol.ok, sol.pose.q, st.cur_pose.q),
                    torch.where(sol.ok, sol.pose.t, st.cur_pose.t)))
        return st2, FrameRecord(
            pose=st2.cur_pose, tracked=tracked, state=st.tstate,
            n_matches=n_matches, n_inliers=inliers, parallax=parallax,
            is_keyframe=False, n_keyframes=zero, n_landmarks=zero)

    # ------------------------------------------------------------------
    def step(st: ScanState, inp):
        frame_id, obs, bits, pop, gray_mean, gray_std = inp
        if stage_limit != 2:
            return profile_step(st, obs, bits, pop, frame_id)
        was = st.tstate
        was_init_first = was == INIT and not st.have_init
        was_init_second = was == INIT and st.have_init
        next_lm = None
        if was_init_first:
            st2, n_matches, inliers, parallax, ok, kf_match = init_first(
                st, obs, frame_id, gray_mean, gray_std)
        elif was_init_second:
            st2, n_matches, inliers, parallax, ok, kf_match = init_second(
                st, obs, frame_id)
        elif was == GOOD:
            st2, n_matches, inliers, parallax, ok, kf_match, next_lm = (
                track_branch(st, obs, bits, pop, frame_id))
            if not ok:  # HandleTrackingFailure: GOOD -> BAD
                st2 = st2._replace(tstate=BAD)
        else:
            st2, n_matches, inliers, parallax, ok, kf_match = (
                reset(st), 0, 0, 0.0, False, None)

        just_initialized = was_init_second and ok
        tracked_now = (was == GOOD and ok) or just_initialized
        # keyframe policy (tracking.cpp:562-575)
        need_kf = (was == GOOD and ok and st2.last_kf_slot >= 0
                   and st2.last_inliers >= opts.min_keyframe_inliers
                   and st2.last_parallax >= opts.min_parallax
                   and frame_id - st2.last_kf_id >= opts.min_keyframe_gap)
        st3 = st2
        if need_kf:
            st3 = create_keyframe(st2, obs, frame_id, kf_match, next_lm)
        # post-frame state update (tracking.cpp:87-88)
        if tracked_now:
            st3 = st3._replace(
                tstate=GOOD if st3.last_inliers >= opts.min_inliers else BAD,
                last_obs=obs, last_pose=st3.cur_pose)
        rec = FrameRecord(
            pose=st3.cur_pose,
            tracked=tracked_now or (was_init_first and ok),
            state=st3.tstate, n_matches=n_matches, n_inliers=inliers,
            parallax=parallax, is_keyframe=need_kf or just_initialized,
            n_keyframes=msl.n_keyframes(st3.ms),
            n_landmarks=msl.n_landmarks(st3.ms))
        return st3, rec

    step.init_first = init_first
    step.init_second = init_second
    step.track_branch = track_branch
    step.create_keyframe = create_keyframe
    step.counters = ctr
    return step


def initial_state(n_features_cap: int = 1024, kf_capacity: int = 64,
                  lm_capacity: int = 1 << 17, device=None) -> ScanState:
    ident = identity_pose(device=device)
    return ScanState(
        ms=msl.empty_map(kf_capacity, lm_capacity, n_features_cap, device),
        tstate=INIT, have_init=False,
        init_obs=_empty_obs(n_features_cap, device), init_frame_id=-1,
        init_kf_slot=-1, last_obs=_empty_obs(n_features_cap, device),
        last_pose=ident, cur_pose=ident, last_kf_slot=-1, last_kf_id=-1,
        last_inliers=0, last_parallax=0.0,
        **_empty_kf_cache(n_features_cap, device), kf_cursor=0,
    )


def resume_state(ms: MapState) -> ScanState:
    """A ``ScanState`` from a restored ``MapState`` snapshot, so a run can
    continue a sequence: the newest alive keyframe becomes the reference
    keyframe and tracking resumes in TRACKING_GOOD by PnP against its
    landmarks; ``last_obs`` is rebuilt from the keyframe tables (responses
    are not stored; nothing reads them after extraction); the oldest alive
    keyframe stands in for the init keyframe. An empty snapshot resumes in
    INIT. The state holds ``ms`` itself (the scan updates it in place) and
    copies of everything it takes from the tables. One device read."""
    dev = ms.kf_q.device
    n = ms.n_features
    alive = msl.kf_alive(ms)
    ids = torch.where(alive, ms.kf_id, -1)
    ids_min = torch.where(alive, ms.kf_id, torch.iinfo(torch.int32).max)
    have, slot, init_slot, last_id, cursor = torch.stack([
        alive.any().long(), torch.argmax(ids), torch.argmin(ids_min),
        ids.max().long(), ms.next_kf.long()]).tolist()
    st = initial_state(n, ms.kf_capacity, ms.lm_capacity, dev)._replace(
        ms=ms, kf_cursor=cursor)
    if not have:
        return st
    obs = FrameObs(
        px=ms.kf_px[slot].T.clone(),
        response=torch.zeros((n,), device=dev),
        desc=ms.kf_desc[slot].clone(),
        valid=ms.kf_fvalid[slot].clone(),
        depth=ms.kf_depth[slot].clone(),
    )
    return st._replace(
        tstate=GOOD, last_obs=obs, last_pose=msl.map_pose(ms, slot),
        cur_pose=msl.map_pose(ms, slot), init_kf_slot=init_slot,
        last_kf_slot=slot, last_kf_id=last_id, **_kf_cache_fields(ms, slot))


def extract_sequence(images_u8: torch.Tensor, depths_m: torch.Tensor,
                     orb_kwargs: dict, chunk: int = 8):
    """ORB, feature depth, image statistics and descriptor bit planes of
    every frame, in chunks of ``chunk`` frames (K1 runs once per chunk);
    ends the stage clock's ``orb`` span. Returns (FrameObs [T,...], gray mean [T], gray std [T], bits
    [T,N,256] bf16, popcounts [T,N])."""
    parts = []
    for i in range(0, images_u8.shape[0], chunk):
        g = images_u8[i:i + chunk]
        px, resp, desc, valid = orb_extract(g, **orb_kwargs)
        dfeat = stages.sample_depth_image(depths_m[i:i + chunk], px, valid)
        gf = g.float()
        mean = gf.mean((1, 2))
        std = torch.sqrt(torch.clamp((gf * gf).mean((1, 2)) - mean * mean, min=0.0))
        bits, pop = matching.unpack_with_pop(desc)
        parts.append((px, resp, desc, valid, dfeat, mean, std, bits, pop))
    px, resp, desc, valid, dfeat, mean, std, bits, pop = (
        torch.cat(p) for p in zip(*parts))
    span("orb")
    return (FrameObs(px=px, response=resp, desc=desc, valid=valid, depth=dfeat),
            mean, std, bits, pop)


def _scan_frames(step, st: ScanState, frame0: int, obs: FrameObs, bits, pop,
                 mean: list, std: list):
    """The serial loop over pre-extracted frames: (final state, records).
    Each frame ends the stage clock's ``step`` span: what its step ran after
    its last ``match``, ``ransac`` or ``gn`` span (the keyframe decision and
    event, local BA, the record)."""
    recs = []
    for i in range(len(mean)):
        st, rec = step(st, (frame0 + i, _frame_obs(obs, i), bits[i], pop[i],
                            mean[i], std[i]))
        recs.append(rec)
        span("step")
    return st, recs


def _frame_out(recs: list, dev) -> FrameOut:
    def host(vals, dtype):
        # host values, or device scalars where the step read nothing
        if isinstance(vals[0], torch.Tensor):
            return torch.stack(vals).to(dtype)
        return torch.tensor(vals, dtype=dtype).to(dev)

    return FrameOut(
        pose=se3_matrix(Pose(torch.stack([r.pose.q for r in recs]),
                             torch.stack([r.pose.t for r in recs]))),
        tracked=host([r.tracked for r in recs], torch.bool),
        state=host([r.state for r in recs], torch.int32),
        n_matches=host([r.n_matches for r in recs], torch.int32),
        n_inliers=host([r.n_inliers for r in recs], torch.int32),
        parallax=host([r.parallax for r in recs], torch.float32),
        is_keyframe=host([r.is_keyframe for r in recs], torch.bool),
        n_keyframes=torch.stack([r.n_keyframes for r in recs]),
        n_landmarks=torch.stack([r.n_landmarks for r in recs]),
    )


def _counter_stats(ctr: ScanCounters, frames: int) -> dict:
    return dict(frames=frames, host_syncs=ctr.host_syncs,
                compactions=ctr.compactions, kf_events=ctr.kf_events,
                kf_culled=ctr.kf_culled,
                ba_iterations=int(ctr.ba_iterations),
                lm_culled=int(ctr.lm_culled))


def run_scan_pipeline(
    cam: CameraParams,
    images_u8,               # [T,H,W] uint8 (tensor or numpy)
    depths_m,                # [T,H,W] float32
    opts: TrackingOptions,
    n_features_cap: int = 1024,
    kf_capacity: int = 64,
    lm_capacity: int = 1 << 17,
    orb_kwargs: dict | None = None,
    stage_limit: int = 2,
    st0: ScanState | None = None,
    frame0: int = 0,
    device="cuda",
    stats: dict | None = None,
) -> tuple[ScanState, FrameOut]:
    """Run a (chunk of a) sequence; returns (final state, per-frame outputs
    stacked along T). Pass the previous chunk's final state as ``st0`` and
    its running ``frame0`` to stream a sequence chunk by chunk; ``st0``'s
    map is updated in place (the JAX package donates it). ``stats``: if a
    dict is given, it receives the run's ``ScanCounters`` values."""
    dev = torch.device(device)
    images = torch.as_tensor(images_u8).to(dev)
    depths = torch.as_tensor(depths_m).to(dev, torch.float32)
    T, H, W = images.shape
    orb_kw = dict(orb_kwargs or {})
    orb_kw.setdefault("n_slots", n_features_cap)
    ctr = ScanCounters(dev)
    step = build_scan_step(cam, opts, (W, H), n_features_cap=n_features_cap,
                           kf_capacity=kf_capacity, lm_capacity=lm_capacity,
                           stage_limit=stage_limit, counters=ctr)
    obs, mean, std, bits, pop = extract_sequence(images, depths, orb_kw)
    stats_host = ctr.read(mean, std) if T else []
    st = st0 if st0 is not None else initial_state(
        n_features_cap, kf_capacity, lm_capacity, dev)
    st, recs = _scan_frames(step, st, frame0, obs, bits, pop,
                            stats_host[:T], stats_host[T:])
    out = _frame_out(recs, dev)
    if stats is not None:
        stats.update(_counter_stats(ctr, T))
    return st, out


def _stack(vals: list):
    """Stack the lanes' values of one state field over a leading [B] axis:
    tensors are stacked, tuples of tensors (the map, observations, poses)
    field by field, host values become a tuple of B."""
    v0 = vals[0]
    if isinstance(v0, torch.Tensor):
        return torch.stack(vals)
    if isinstance(v0, tuple):
        return type(v0)(*(_stack(list(x)) for x in zip(*vals)))
    return tuple(vals)


def run_scan_pipeline_batched(
    cam: CameraParams,
    images_u8,               # [B,T,H,W] uint8 (tensor or numpy)
    depths_m,                # [B,T,H,W] float32
    opts: TrackingOptions,
    n_features_cap: int = 1024,
    kf_capacity: int = 64,
    lm_capacity: int = 1 << 17,
    orb_kwargs: dict | None = None,
    device="cuda",
    stats: dict | None = None,
) -> tuple[ScanState, FrameOut]:
    """The scan over B independent sequences of T frames; returns (final
    states stacked over B, per-frame outputs [T, B, ...]). In the stacked
    ``ScanState`` every tensor gains a leading [B] axis and every host
    value becomes a tuple of B.

    Every lane starts from ``initial_state`` at frame id 0 and draws the
    per-frame generators of a single run, so lane b equals
    ``run_scan_pipeline`` of sequence b. Extraction runs once over all B*T
    frames (K1 once per ``extract_sequence`` chunk). The serial part stays
    one host loop per lane, one lane after the other (the JAX package vmaps
    the step and pays every branch in every lane; here a branch not taken
    costs nothing, and nothing is shared between lanes either).

    ``stats``: if a dict is given, it receives the lanes' counters
    (``lanes``: a list of B) and their sums."""
    dev = torch.device(device)
    images = torch.as_tensor(images_u8).to(dev)
    depths = torch.as_tensor(depths_m).to(dev, torch.float32)
    B, T, H, W = images.shape
    orb_kw = dict(orb_kwargs or {})
    orb_kw.setdefault("n_slots", n_features_cap)
    t0 = time.perf_counter()
    obs, mean, std, bits, pop = extract_sequence(
        images.reshape(B * T, H, W), depths.reshape(B * T, H, W), orb_kw)
    stats_host = torch.cat([mean, std]).tolist() if B * T else []
    extract_s = time.perf_counter() - t0

    def lane(b: int):
        ctr = ScanCounters(dev)
        step = build_scan_step(cam, opts, (W, H), n_features_cap=n_features_cap,
                               kf_capacity=kf_capacity, lm_capacity=lm_capacity,
                               counters=ctr)
        lo, hi = b * T, (b + 1) * T
        st, recs = _scan_frames(
            step, initial_state(n_features_cap, kf_capacity, lm_capacity, dev),
            0, FrameObs(*(x[lo:hi] for x in obs)), bits[lo:hi], pop[lo:hi],
            stats_host[lo:hi], stats_host[B * T + lo:B * T + hi])
        return st, _frame_out(recs, dev), _counter_stats(ctr, T)

    sts, outs, lane_stats = zip(*(lane(b) for b in range(B)))
    out = FrameOut(*(torch.stack(x, dim=1) for x in zip(*outs)))
    if stats is not None:
        stats.update(
            lanes=list(lane_stats), frames=B * T, extract_seconds=extract_s,
            **{k: sum(s[k] for s in lane_stats)
               for k in ("host_syncs", "compactions", "kf_events", "kf_culled",
                         "ba_iterations", "lm_culled")})
    return _stack(list(sts)), out
