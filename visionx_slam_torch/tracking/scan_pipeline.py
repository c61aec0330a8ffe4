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
On the card a steady tracked frame's device work up to that read
(``track_segment``) is one CUDA graph, captured once a process and replayed
once a frame (``TrackGraph``); CPU tensors run the same function eagerly.

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

from ..models import estimation
from ..models import local_ba as lba
from ..models import matching
from ..models.estimation import (
    PnPResult,
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
from ..utils.logging import count_sync, span
from . import local_map
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


def _flat64(*vals: torch.Tensor) -> torch.Tensor:
    """Device values (scalars or vectors) -> one flat float64 vector."""
    return torch.cat([v.reshape(-1).to(torch.float64) for v in vals])


class ScanCounters:
    """What a run did that the outputs do not show: device-to-host reads
    made by the step's decisions (local BA's convergence reads and the
    keyframe culling's included), landmark compactions, keyframe events,
    the local BA calls that ran as one launch of kernel K3 (every one on
    the card, none on the CPU), the keyframes culling removed, the steady
    tracked frames whose device work ran as a replay of a ``TrackGraph``
    and the graphs this counter's steps captured (none on the CPU), and the
    local BA iterations, culled landmarks, the landmarks that two-view
    triangulation created and the local map's matches (device scalars, read
    once)."""

    def __init__(self, device=None):
        self.host_syncs = 0
        self.compactions = 0
        self.kf_events = 0
        self.lba_kernel = 0
        self.kf_culled = 0
        self.track_graph = 0
        self.track_graph_captures = 0
        self.ba_iterations = torch.zeros((), dtype=torch.int64, device=device)
        self.lm_culled = torch.zeros((), dtype=torch.int64, device=device)
        self.tri_landmarks = torch.zeros((), dtype=torch.int64, device=device)
        self.localmap_matches = torch.zeros((), dtype=torch.int64, device=device)

    def read(self, *vals: torch.Tensor) -> list:
        """Device values (scalars or vectors) -> one flat list of host
        numbers, in one transfer; a lone float64 vector is read as it is."""
        self.host_syncs += 1
        if len(vals) == 1 and vals[0].dtype == torch.float64 and vals[0].dim() == 1:
            return vals[0].tolist()
        return _flat64(*vals).tolist()

    def stats(self, frames: int) -> dict:
        """Every count, the device scalars read in one transfer, with the
        run's ``frames``."""
        ba_iterations, lm_culled, tri_landmarks, localmap_matches = torch.stack(
            [self.ba_iterations, self.lm_culled, self.tri_landmarks,
             self.localmap_matches]).tolist()
        return dict(frames=frames, host_syncs=self.host_syncs,
                    compactions=self.compactions, kf_events=self.kf_events,
                    lba_kernel=self.lba_kernel, kf_culled=self.kf_culled,
                    track_graph=self.track_graph,
                    track_graph_captures=self.track_graph_captures,
                    ba_iterations=ba_iterations, lm_culled=lm_culled,
                    tri_landmarks=tri_landmarks, localmap_matches=localmap_matches)


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


def _ok_pose(sol: PnPResult) -> torch.Tensor:
    return (sol.ok & torch.isfinite(sol.pose.q).all(-1)
            & torch.isfinite(sol.pose.t).all(-1))


class TrackSegment(NamedTuple):
    """A steady tracked frame's device work up to its read."""

    m_raw: matching.MatchResult  # knn2 match against the reference keyframe
    m: matching.MatchResult      # after the reference's distance filter
    pts2d: torch.Tensor          # [N,2] the frame's pixel of each match
    pvalid: torch.Tensor         # [N] bool matched, with a sane landmark
    sol: PnPResult               # the motion-prior PnP
    flags: torch.Tensor          # [6] f64 what the frame's read brings back


def track_segment(cam: CameraParams, thr: float, refine_iters: int,
                  kf_bits, kf_pop, kf_fvalid, kf_lm_pts, kf_lm_valid, kf_px2,
                  px, valid, bits, pop, pose_q, pose_t,
                  next_lm) -> TrackSegment:
    """TRACKING_GOOD up to its consensus read: the frame's knn2 match
    (``px``, ``valid``, bit planes ``bits`` and popcounts ``pop``) against
    the reference keyframe's caches (``kf_*``, ``ScanState``'s fields),
    ``pnp_prior`` from the pose (``pose_q``, ``pose_t``), and the flags
    the read brings back: matches, PnP pairs, inliers, the pose's
    soundness, the PnP branch's parallax (it depends only on the match) and
    the map's allocation cursor ``next_lm`` (for the frame's keyframe
    event). Tensors in and out, no host read and no randomness, so
    ``TrackGraph`` can capture it. Ends the ``match`` span; its two GN
    calls end ``gn``."""
    m_raw = matching.knn2_from_bits(kf_bits, kf_pop, kf_fvalid, bits, pop,
                                    valid)
    m = matching.reference_distance_filter(m_raw)
    span("match")
    pts2d = px[m.idx]
    pvalid = m.valid & kf_lm_valid
    sol = pnp_prior(cam, kf_lm_pts, pts2d, pvalid, Pose(pose_q, pose_t), thr,
                    refine_iters=refine_iters)
    flags = _flat64(m.valid.sum(), pvalid.sum(), sol.n_inliers, _ok_pose(sol),
                    stages.parallax_px(kf_px2, px, m), next_lm)
    return TrackSegment(m_raw, m, pts2d, pvalid, sol, flags)


class TrackGraph:
    """``track_segment`` captured once as a CUDA graph over static input
    buffers (``args``: its tensor arguments in order; the first six are
    the reference keyframe's caches), replayed once a steady tracked
    frame. ``run`` copies the frame's tensors, the pose and the map's
    cursor in every frame, and the caches only when it is given other
    cache tensors than it last copied: the scan replaces them (a keyframe
    event, an initialization, a reset, a resumed state, another lane's
    state), never changes them in place. The outputs are the graph's own
    buffers, which the next replay overwrites. ``k2_launches``: the K2
    launches a replay runs; ``pool_bytes``: the device memory the capture
    reserved for the graph's private pool."""

    def __init__(self, segment, args: tuple):
        self.args = tuple(a.clone() for a in args)
        self.cache = args[:6]
        launches = estimation.gn_launches
        with torch.cuda.device(args[0].device):
            # lazy set-up (cuBLAS's handle and workspace, K2's library)
            # outside the capture, on the side stream that captures: one
            # more stream, one more cuBLAS workspace
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                segment(*self.args)
            torch.cuda.synchronize()
            count_sync()
            torch.cuda.empty_cache()
            reserved = torch.cuda.memory_reserved()
            before = estimation.gn_launches
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph, stream=side):
                self.out = segment(*self.args)
            self.k2_launches = estimation.gn_launches - before
            self.pool_bytes = torch.cuda.memory_reserved() - reserved
        # the warm-up and the capture ran no frame's work
        estimation.gn_launches = launches

    def run(self, args: tuple) -> TrackSegment:
        """Copy ``args`` in, replay; ends the ``match`` span after the
        copies and ``gn`` after the replay."""
        if any(a is not b for a, b in zip(args[:6], self.cache)):
            for dst, src in zip(self.args[:6], args[:6]):
                dst.copy_(src)
            self.cache = args[:6]
        for dst, src in zip(self.args[6:], args[6:]):
            dst.copy_(src)
        span("match")
        self.graph.replay()
        estimation.gn_launches += self.k2_launches
        span("gn")
        return self.out


# the process's graphs of ``track_segment``, by what enters them: the
# device, the feature cap and the step's constants (so steps built for each
# chunk, frame or lane share one capture)
_TRACK_GRAPHS: dict = {}


def _track_graph(key: tuple, segment, args: tuple,
                 ctr: ScanCounters) -> TrackGraph | None:
    """The graph of ``key`` for CUDA tensors ``args``, captured now where
    the process has none (counted in ``ctr``); None for CPU tensors."""
    if args[0].device.type != "cuda":
        return None
    graph = _TRACK_GRAPHS.get(key)
    if graph is None:
        graph = _TRACK_GRAPHS[key] = TrackGraph(segment, args)
        ctr.track_graph_captures += 1
    return graph


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


def _triangulate(ms: MapState, cam: CameraParams, opts: TrackingOptions,
                 slot_a: int, slot_b: int, res, tally) -> MapState:
    """``stages.triangulate_pair`` under the tracking options; ``tally``
    (an int64 device scalar, or None) gains the landmarks it created: the
    allocation cursor's advance, with no host read."""
    if tally is not None:
        tally.sub_(ms.next_lm)
    ms = stages.triangulate_pair(
        ms, cam, slot_a, slot_b, opts.triangulation_min_angle_deg,
        opts.triangulation_max_reproj_error, res=res)
    if tally is not None:
        tally.add_(ms.next_lm)
    return ms


def insert_init_pair(ms: MapState, cam: CameraParams, opts: TrackingOptions,
                     obs1: FrameObs, frame_id1: int, obs2: FrameObs,
                     frame_id2: int, pose2: Pose, cursor: int,
                     res: matching.MatchResult | None = None,
                     tally: torch.Tensor | None = None):
    """The map of a finished two-frame initialization: both frames become
    keyframes (the first at the identity) in the ring slots after
    ``cursor``, their depth landmarks, then the triangulated ones (``res``:
    the raw knn2 match of the two frames, when the caller has it; ``tally``:
    a device counter of the landmarks triangulated). Returns (map, slot1,
    slot2)."""
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
    ms = _triangulate(ms, cam, opts, slot1, slot2, res, tally)
    return ms, slot1, slot2


def insert_tracked_keyframe(ms: MapState, cam: CameraParams,
                            opts: TrackingOptions, obs: FrameObs,
                            frame_id: int, pose: Pose, prev_slot: int,
                            slot: int, links: torch.Tensor | None = None,
                            res: matching.MatchResult | None = None,
                            tally: torch.Tensor | None = None):
    """A tracked frame becomes the keyframe of ring slot ``slot``: its
    features (``links``: the landmarks they inherit, none by default), its
    depth landmarks, and the landmarks triangulated against the previous
    keyframe ``prev_slot`` (``res``: their raw knn2 match, when the caller
    has it; ``tally``: a device counter of them). Returns the map."""
    fresh = links is None
    if fresh:
        links = torch.full((ms.n_features,), FREE, dtype=torch.int32,
                           device=obs.px.device)
    ms, slot = msl.insert_keyframe(
        ms, frame_id, pose, obs.px, obs.desc, obs.valid, links, obs.depth,
        fresh_links=fresh, slot=slot)
    ms = stages.depth_landmarks(ms, cam, slot, pose)
    return _triangulate(ms, cam, opts, prev_slot, slot, res, tally)


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
    counters: ScanCounters | None = None,
):
    """The per-frame step ``step(st, inp) -> (st, FrameRecord)``, closed
    over static options; ``inp`` = (frame_id, obs, bits, pop, gray_mean,
    gray_std) of one frame, the last two host floats. The branches are
    exposed as ``step.init_first``, ``step.init_second``,
    ``step.track_branch`` and ``step.create_keyframe``."""
    W_IMG, H_IMG = img_wh
    N = n_features_cap
    K = kf_capacity
    ctr = counters if counters is not None else ScanCounters()
    thr = opts.max_reproj_error
    ba_opts = tracking_ba_options(opts)
    # the local map: the last keyframe and the ring's slots before it, as
    # many as local BA's window
    W_LOCAL = min(max(1, opts.ba_window_size), K)

    def mat_pose(R, t):
        return Pose(matrix_to_quat(R), t)

    refine = min(2, opts.pnp_refine_iters)
    graph_key = (N, cam, thr, refine, matching.NN_RATIO)

    def segment(*args) -> TrackSegment:
        return track_segment(cam, thr, refine, *args)

    # ------------------------------------------------------------------
    def track_branch(st: ScanState, obs: FrameObs, bits, pop, frame_id: int):
        """TRACKING_GOOD: motion-prior PnP against the last keyframe
        (``track_segment``: eagerly for CPU tensors, a graph's replay for
        CUDA ones), the full PnP RANSAC when that consensus is weak, the
        essential-matrix fallback against the last frame when PnP fails.
        Returns (state, n_matches, inliers, parallax, ok, raw knn2 match,
        next_lm)."""
        dev = obs.px.device
        args = (st.kf_bits, st.kf_pop, st.kf_fvalid, st.kf_lm_pts,
                st.kf_lm_valid, st.kf_px2, obs.px, obs.valid, bits, pop,
                st.cur_pose.q, st.cur_pose.t, st.ms.next_lm)
        graph = _track_graph((dev, *graph_key), segment, args, ctr)
        if graph is None:
            seg = segment(*args)
        else:
            seg = graph.run(args)
            ctr.track_graph += 1
        m_raw, m, pts2d, pvalid, sol, _ = seg
        n_matches, n_pairs, n_inl, sol_ok, parallax, next_lm = ctr.read(
            seg.flags)
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
            n_inl, sol_ok = ctr.read(sol.n_inliers, _ok_pose(sol))
            n_inl = int(n_inl)
        pnp_ok = (n_matches >= opts.min_matches and n_pairs >= opts.min_inliers
                  and bool(sol_ok) and n_inl >= opts.min_inliers)
        if pnp_ok:
            pose, inliers, ok = sol.pose, n_inl, True
            if opts.track_local_map:
                span("step")    # the consensus read's wait stays in ``step``
                pose, n_local = local_map.track_local_map(
                    st.ms, cam, pose, obs.px, obs.valid, bits, pop,
                    st.kf_lm_pts, pts2d, sol.inlier_mask & pvalid, m.idx,
                    st.ms.kf_feat_lm[st.last_kf_slot],
                    st.kf_cursor - W_LOCAL, W_LOCAL - 1, (W_IMG, H_IMG), thr)
                ctr.localmap_matches += n_local
            elif graph is not None and sol is seg.sol:
                # the next replay overwrites the graph's buffers
                pose = Pose(pose.q.clone(), pose.t.clone())
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
                cursor, m_raw, tally=ctr.tri_landmarks)
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
                                     prev_slot, slot, links, kf_match,
                                     tally=ctr.tri_landmarks)
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
            span("kf")
            launches = lba.lba_launches
            ms, ba = local_ba(ms, cam, ba_opts)
            span("lba")
            ctr.lba_kernel += lba.lba_launches - launches
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
    def step(st: ScanState, inp):
        frame_id, obs, bits, pop, gray_mean, gray_std = inp
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
    A keyframe event ends the stage clock's ``kf`` span (the event up to
    local BA: the keyframe, its landmarks, culling) and ``lba`` (local BA);
    each frame ends ``step``: what its step ran after its last ``match``,
    ``ransac``, ``gn`` or ``lba`` span (the record, and on a frame without
    an event the keyframe decision)."""
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


def run_scan_pipeline(
    cam: CameraParams,
    images_u8,               # [T,H,W] uint8 (tensor or numpy)
    depths_m,                # [T,H,W] float32
    opts: TrackingOptions,
    n_features_cap: int = 1024,
    kf_capacity: int = 64,
    lm_capacity: int = 1 << 17,
    orb_kwargs: dict | None = None,
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
                           counters=ctr)
    obs, mean, std, bits, pop = extract_sequence(images, depths, orb_kw)
    stats_host = ctr.read(mean, std) if T else []
    st = st0 if st0 is not None else initial_state(
        n_features_cap, kf_capacity, lm_capacity, dev)
    st, recs = _scan_frames(step, st, frame0, obs, bits, pop,
                            stats_host[:T], stats_host[T:])
    out = _frame_out(recs, dev)
    if stats is not None:
        stats.update(ctr.stats(T))
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
        return st, _frame_out(recs, dev), ctr.stats(T)

    sts, outs, lane_stats = zip(*(lane(b) for b in range(B)))
    out = FrameOut(*(torch.stack(x, dim=1) for x in zip(*outs)))
    if stats is not None:
        stats.update(
            lanes=list(lane_stats), frames=B * T, extract_seconds=extract_s,
            **{k: sum(s[k] for s in lane_stats)
               for k in ("host_syncs", "compactions", "kf_events",
                         "lba_kernel", "kf_culled", "track_graph",
                         "track_graph_captures",
                         "ba_iterations", "lm_culled", "tri_landmarks",
                         "localmap_matches")})
    return _stack(list(sts)), out
