"""Host-side tracking state machine over the device stages (counterpart of
``visionx_slam_tpu/tracking/frontend.py``).

Reproduces the reference frontend (core/frontend/tracking.cpp): the
INIT / TRACKING_GOOD / TRACKING_BAD / LOST state machine with two-frame
initialization, PnP-first tracking with essential-matrix fallback,
keyframe policy, depth/triangulated landmark creation, culling and local
BA. Control flow lives on the host; every array computation is a stage from
``stages.py`` / ``models/`` on the tracker's device. This is the parity and
debug path (``--pipeline host``): it reads the device several times per
frame and counts those reads in ``Tracker.host_reads``. The online scan
(``scan_pipeline.py``) is the fast form of the same machine.

Reference quirks deliberately reproduced:
- the init parallax gate compares a PIXEL-mean parallax against a 1-degree
  RADIAN constant (tracking.cpp:240-245), effectively always passing;
- the essential fallback composes a UNIT-norm translation
  (tracking.cpp:539-541) unless ``fallback_scale_from_depth``;
- TRACKING_BAD/LOST wipe the whole map and re-initialize
  (tracking.cpp:477-499), no relocalization;
- a frame arriving in BAD/LOST state is consumed by the reset handler
  without being tracked (tracking.cpp:68-74).

Against the JAX package's ``Tracker``: the map is updated in place (a reset
builds a fresh one, and ``tracker.ms`` may be assigned); keyframe slots are
host integers; RANSAC draws come from one ``torch.Generator`` per frame and
call site (stream 0 PnP, 1 essential), seeded from (17 + seed, frame id,
stream) as the scan's are, where the JAX package splits one key.
"""

from __future__ import annotations

import enum
import logging
from dataclasses import dataclass, field

import numpy as np
import torch

from ..models import matching
from ..models.estimation import (
    essential_ransac,
    essential_scale_from_depth,
    pnp_ransac,
)
from ..models.local_ba import local_ba
from ..ops.camera import CameraParams, backproject
from ..ops.se3 import Pose, identity_pose, se3_compose, se3_from_Rt, se3_matrix
from ..utils.config import TrackingOptions
from . import mapstate as msl
from . import stages
from .mapstate import MapState
from .scan_pipeline import (
    DEG1_RAD,
    frame_generator,
    insert_init_pair,
    insert_tracked_keyframe,
    tracking_ba_options,
)
from .stages import FrameObs

log = logging.getLogger("vxs.tracking")


class State(enum.Enum):
    INIT = 0
    TRACKING_GOOD = 1
    TRACKING_BAD = 2
    LOST = 3


@dataclass
class FrameResult:
    frame_id: int
    timestamp: float
    state: str
    pose_T_cw: np.ndarray | None  # 4x4 or None when the frame has no pose
    n_features: int = 0
    n_matches: int = 0
    n_inliers: int = 0
    parallax: float = 0.0
    is_keyframe: bool = False
    n_keyframes: int = 0
    n_landmarks: int = 0
    ba_cost: float = float("nan")


@dataclass
class Tracker:
    cam: CameraParams
    options: TrackingOptions = field(default_factory=TrackingOptions)
    n_features: int = 1024
    kf_capacity: int = 64
    lm_capacity: int = 1 << 17
    seed: int = 0
    device: str = "cuda"

    def __post_init__(self):
        self.state = State.INIT
        self._dev = torch.device(self.device)
        self._ba_opts = tracking_ba_options(self.options)
        self.host_reads = 0       # device-to-host reads made so far
        self._reset_episode()

    # ------------------------------------------------------------------
    def _reset_episode(self):
        """Map wipe + re-init (HandleTrackingBad/Lost, tracking.cpp:477-499)."""
        self.ms: MapState = msl.empty_map(
            self.kf_capacity, self.lm_capacity, self.n_features, self._dev)
        self.init_obs: FrameObs | None = None
        self.init_frame_id: int | None = None
        self.init_kf_slot: int | None = None
        self.last_obs: FrameObs | None = None
        self.last_pose: Pose | None = None
        self.last_kf_slot: int | None = None
        self.last_kf_frame_id: int | None = None
        self.current_pose: Pose | None = None
        self.last_inliers = 0
        self.last_parallax = 0.0

    def _read(self, *vals: torch.Tensor) -> list:
        """Device scalars -> host numbers, in one transfer (counted)."""
        self.host_reads += 1
        return torch.stack([v.reshape(()).to(torch.float64) for v in vals]).tolist()

    def _gen(self, frame_id: int, stream: int) -> torch.Generator:
        return frame_generator(frame_id, stream, self._dev, seed=17 + self.seed)

    # ------------------------------------------------------------------
    def process(
        self, frame_id: int, timestamp: float, gray: np.ndarray, obs: FrameObs
    ) -> FrameResult:
        """Per-frame entry point (Tracking::ProcessFrame, tracking.cpp:39-89)."""
        res = FrameResult(
            frame_id=frame_id,
            timestamp=timestamp,
            state=self.state.name,
            pose_T_cw=None,
            n_features=int(self._read(obs.valid.sum())[0]),
        )
        just_initialized = False

        if self.state == State.INIT:
            if self.init_obs is None:
                if not self._init_first(frame_id, gray, obs, res):
                    log.info("[ProcessFrame] Waiting for a better initial frame...")
                return self._finish(res)
            if not self._init_second(frame_id, obs, res):
                log.info("[ProcessFrame] Waiting for a better second frame...")
                return self._finish(res)
            self._update_tracking_state()
            log.info("[Tracking] Initialization success.")
            self.last_obs = obs
            self.last_pose = self.current_pose
            just_initialized = True
        elif self.state == State.TRACKING_GOOD:
            if not self._track(frame_id, obs, res):
                self._handle_tracking_failure()
                res.state = self.state.name
                return self._finish(res)
        elif self.state in (State.TRACKING_BAD, State.LOST):
            # the reference consumes this frame in the reset handler
            self._reset_episode()
            self.state = State.INIT
            log.info("[ProcessFrame] Tracking %s. Trying to re-initialize...",
                     res.state.lower())
            return self._finish(res)

        if not just_initialized and self._need_new_keyframe(frame_id):
            self._create_keyframe(frame_id, obs, res)
            if self.options.enable_culling:
                self._cull_landmarks()
                self._cull_keyframes(frame_id)
            if self.options.enable_local_ba:
                self.ms, stats = local_ba(self.ms, self.cam, self._ba_opts)
                self.host_reads += stats.host_reads
                res.ba_cost = self._read(stats.final_cost)[0]
                # keep the tracker's notion of the current pose in sync
                self.current_pose = msl.map_pose(self.ms, self.last_kf_slot)

        self._update_tracking_state()
        self.last_obs = obs
        self.last_pose = self.current_pose
        res.state = self.state.name
        return self._finish(res)

    # ------------------------------------------------------------------
    def _finish(self, res: FrameResult) -> FrameResult:
        n_kf, n_lm = self._read(msl.n_keyframes(self.ms), msl.n_landmarks(self.ms))
        res.n_keyframes, res.n_landmarks = int(n_kf), int(n_lm)
        return res

    def _set_frame_pose(self, res: FrameResult, pose: Pose):
        self.current_pose = pose
        self.host_reads += 1
        res.pose_T_cw = se3_matrix(pose).cpu().numpy()

    # ------------------------------------------------------------------
    # initialization (tracking.cpp:177-263)
    # ------------------------------------------------------------------
    def _init_first(self, frame_id, gray, obs, res) -> bool:
        n = res.n_features
        if n < self.options.min_matches:
            log.warning("[InitWithFirstFrame] Not enough features: %d", n)
            return False
        h, w = gray.shape
        if not self._read(stages.feature_distribution_ok(obs.px, obs.valid, w, h))[0]:
            log.warning("[InitWithFirstFrame] Poor feature distribution.")
            return False
        mean, std = float(gray.mean()), float(gray.std())
        if mean < 30 or mean > 225 or std < 20:  # tracking.cpp:120-139
            log.warning("[InitWithFirstFrame] Poor image quality.")
            return False
        self.init_obs = obs
        self.init_frame_id = frame_id
        self._set_frame_pose(res, identity_pose(device=self._dev))
        log.info("[Tracking] InitWithFirstFrame. Features: %d", n)
        return True

    def _init_second(self, frame_id, obs, res) -> bool:
        io = self.init_obs
        m = matching.match_frames(io.desc, io.valid, obs.desc, obs.valid)
        n_matches, parallax = self._read(
            m.valid.sum(), stages.parallax_px(io.px, obs.px, m))
        n_matches = int(n_matches)
        res.n_matches = n_matches
        if n_matches < self.options.min_matches:
            log.warning("[InitWithSecondFrame] Not enough matches: %d", n_matches)
            return False

        pose2 = None
        inliers = 0
        if self.options.rgbd_init:
            pose2, inliers = self._init_pose_from_depth_pnp(frame_id, obs, m)
            if pose2 is not None:
                log.info("[InitWithSecondFrame] RGB-D PnP init, inliers: %d", inliers)

        if pose2 is None:
            px_m = obs.px[m.idx]
            ess = essential_ransac(self.cam, io.px, px_m, m.valid,
                                   self._gen(frame_id, 1))
            ok, inliers = self._read(ess.ok, ess.n_inliers)
            inliers = int(inliers)
            if not ok or inliers < self.options.min_inliers:
                log.warning("[EstimatePoseByEssential] Essential failed. inliers: %d",
                            inliers)
                return False
            t_init = ess.t
            if self.options.init_scale_from_depth:
                t_init = ess.t * essential_scale_from_depth(
                    self.cam, ess, io.px, px_m, io.depth)
            # pose of the second frame: T_cw = T_cl * T_lw, T_lw = identity
            pose2 = se3_from_Rt(ess.R, t_init)

        # reference quirk preserved: pixel parallax vs 1-degree-in-radians
        if parallax < DEG1_RAD:
            log.warning("[InitWithSecondFrame] Parallax too small: %f", parallax)
            return False

        # both keyframes, then depth landmarks x2, then triangulation
        cursor = int(self._read(self.ms.next_kf)[0])
        self.ms, slot1, slot2 = insert_init_pair(
            self.ms, self.cam, self.options, io, self.init_frame_id, obs,
            frame_id, pose2, cursor)
        self.init_kf_slot = slot1
        self.last_kf_slot = slot2
        self.last_kf_frame_id = frame_id
        self.last_parallax = parallax
        self.last_inliers = inliers
        res.n_inliers = inliers
        res.parallax = parallax
        self._set_frame_pose(res, pose2)
        log.info("[InitWithSecondFrame] Parallax: %f, inliers: %d", parallax, inliers)
        return True

    def _init_pose_from_depth_pnp(self, frame_id, obs, m):
        """RGB-D init: PnP of the second frame against the first frame's
        depth-backprojected points (extension, ``rgbd_init``). Returns
        (pose, inliers) or (None, 0) to fall back to the essential path."""
        d = self.init_obs.depth
        good_d = (d >= stages.MIN_DEPTH) & (d <= stages.MAX_DEPTH)
        pw = backproject(self.cam, self.init_obs.px, d)  # init pose = identity
        valid = m.valid & good_d
        sol = self._pnp(frame_id, pw, obs, m, valid,
                        identity_pose(device=self._dev), blind=True)
        n_valid, ok, inliers = self._read(valid.sum(), sol.ok, sol.n_inliers)
        inliers = int(inliers)
        if (n_valid < self.options.min_inliers or not ok
                or inliers < self.options.min_inliers):
            return None, 0
        return sol.pose, inliers

    def _pnp(self, frame_id, pts3d, obs, m, valid, init_pose: Pose, blind: bool):
        """One PnP RANSAC problem (the batched solver with P = 1). A blind
        init gets the full hypothesis budget (see the scan's init_second);
        steady tracking gets the configured one."""
        o = self.options
        depth_curr = obs.depth[m.idx] if o.pnp_use_depth else None
        sol = pnp_ransac(
            self.cam, pts3d[None], obs.px[m.idx][None], valid[None],
            self._gen(frame_id, 0), o.max_reproj_error,
            n_hypotheses=max(64, o.pnp_hypotheses) if blind else o.pnp_hypotheses,
            refine_iters=max(6, o.pnp_refine_iters) if blind else o.pnp_refine_iters,
            init_pose=Pose(init_pose.q[None], init_pose.t[None]),
            depth_curr=None if depth_curr is None else depth_curr[None])
        return type(sol)(Pose(sol.pose.q[0], sol.pose.t[0]), sol.inlier_mask[0],
                         sol.n_inliers[0], sol.ok[0])

    # ------------------------------------------------------------------
    # steady-state tracking (tracking.cpp:267-455)
    # ------------------------------------------------------------------
    def _track(self, frame_id, obs, res) -> bool:
        if self.last_kf_slot is not None:
            if self._track_pnp(frame_id, obs, res):
                return True
            log.info("[Track] PnP failed, falling back to TrackLastFrame.")
        return self._track_last_frame(frame_id, obs, res)

    def _track_pnp(self, frame_id, obs, res) -> bool:
        slot = self.last_kf_slot
        m = matching.match_frames(
            self.ms.kf_desc[slot], self.ms.kf_fvalid[slot], obs.desc, obs.valid)
        pts3d, _, valid = stages.pnp_correspondences(self.ms, slot, obs, m)
        n_matches, n_pairs = (int(v) for v in self._read(m.valid.sum(), valid.sum()))
        res.n_matches = n_matches
        if n_matches < self.options.min_matches:
            log.warning("[TrackWithPnP] Not enough matches: %d", n_matches)
            return False
        if n_pairs < self.options.min_inliers:
            log.warning("[TrackWithPnP] Not enough 3D-2D pairs: %d", n_pairs)
            return False

        # the previous pose competes as the motion-prior hypothesis
        sol = self._pnp(frame_id, pts3d, obs, m, valid, self.current_pose,
                        blind=False)
        finite = torch.isfinite(sol.pose.q).all() & torch.isfinite(sol.pose.t).all()
        ok, inliers, finite, parallax = self._read(
            sol.ok, sol.n_inliers, finite,
            stages.parallax_px(self.ms.kf_px[slot].T, obs.px, m))
        inliers = int(inliers)
        if not ok or inliers < self.options.min_inliers:
            log.warning("[PnP] solvePnPRansac failed. Inliers: %d", inliers)
            return False
        if not finite:
            log.warning("[TrackWithPnP] Invalid pose")
            return False

        self.last_parallax = parallax
        self.last_inliers = inliers
        res.n_inliers = inliers
        res.parallax = parallax
        self._set_frame_pose(res, sol.pose)
        return True

    def _track_last_frame(self, frame_id, obs, res) -> bool:
        lo = self.last_obs
        if lo is None:
            log.warning("[TrackLastFrame] last frame is null")
            return False
        m = matching.match_frames(lo.desc, lo.valid, obs.desc, obs.valid)
        px_m = obs.px[m.idx]
        ess = essential_ransac(self.cam, lo.px, px_m, m.valid,
                               self._gen(frame_id, 1))
        n_matches, ok, inliers, parallax = self._read(
            m.valid.sum(), ess.ok, ess.n_inliers,
            stages.parallax_px(lo.px, obs.px, m))
        n_matches, inliers = int(n_matches), int(inliers)
        res.n_matches = max(res.n_matches, n_matches)
        if n_matches < self.options.min_matches:
            log.warning("[TrackLastFrame] Not enough matches: %d", n_matches)
            return False
        if not ok or inliers < self.options.min_inliers:
            log.warning("[TrackLastFrame] Pose estimation failed. inliers: %d", inliers)
            return False

        # the reference composes recoverPose's unit-scale translation here
        # (scale-drift quirk, tracking.cpp:539-541); with depth available we
        # optionally recover the metric scale (documented deviation)
        t_rel = ess.t
        if self.options.fallback_scale_from_depth:
            t_rel = ess.t * essential_scale_from_depth(
                self.cam, ess, lo.px, px_m, lo.depth)
        pose = se3_compose(se3_from_Rt(ess.R, t_rel), self.last_pose)
        self.last_inliers = inliers
        self.last_parallax = parallax
        res.n_inliers = inliers
        res.parallax = parallax
        self._set_frame_pose(res, pose)
        return True

    # ------------------------------------------------------------------
    # state management (tracking.cpp:459-499)
    # ------------------------------------------------------------------
    def _update_tracking_state(self):
        if self.last_inliers >= self.options.min_inliers:
            self.state = State.TRACKING_GOOD
        else:
            self.state = State.TRACKING_BAD

    def _handle_tracking_failure(self):
        if self.state == State.TRACKING_GOOD:
            self.state = State.TRACKING_BAD
        else:
            self.state = State.LOST
        log.warning("[Tracking] Tracking failure, state = %s", self.state.name)

    # ------------------------------------------------------------------
    # keyframes (tracking.cpp:562-650, 856-929)
    # ------------------------------------------------------------------
    def _need_new_keyframe(self, frame_id) -> bool:
        if self.state != State.TRACKING_GOOD:
            return False
        if self.current_pose is None or self.last_kf_slot is None:
            return False
        if self.last_inliers < self.options.min_keyframe_inliers:
            return False
        if self.last_parallax < self.options.min_parallax:
            return False
        if frame_id - self.last_kf_frame_id < self.options.min_keyframe_gap:
            return False
        return True

    def _create_keyframe(self, frame_id, obs, res):
        next_lm, cursor = (int(v) for v in self._read(self.ms.next_lm,
                                                      self.ms.next_kf))
        # recycle dead landmark slots before the allocator runs dry
        if next_lm > self.lm_capacity - 3 * self.n_features:
            self.ms = msl.compact_landmarks(self.ms)
        slot = cursor % self.kf_capacity
        self.ms = insert_tracked_keyframe(
            self.ms, self.cam, self.options, obs, frame_id, self.current_pose,
            self.last_kf_slot, slot)
        self.last_kf_slot = slot
        self.last_kf_frame_id = frame_id
        res.is_keyframe = True
        log.info("[Tracking] New keyframe created.")

    # ------------------------------------------------------------------
    # culling (tracking.cpp:652-840)
    # ------------------------------------------------------------------
    def _cull_landmarks(self):
        o = self.options
        self.ms, n = stages.cull_landmarks(
            self.ms, self.cam, o.landmark_max_reproj_error,
            o.min_landmark_observations,
            gate=msl.n_landmarks(self.ms) >= o.min_landmarks_for_culling)
        n = int(self._read(n)[0])
        if n:
            log.info("[Tracking] Culled landmarks: %d", n)

    def _cull_keyframes(self, current_frame_id):
        o = self.options
        init_slot = -1 if self.init_kf_slot is None else self.init_kf_slot
        self.ms, removed, n = stages.cull_keyframes_device(
            self.ms, self.cam, self.last_kf_slot, init_slot, current_frame_id,
            min_keyframes_for_culling=o.min_keyframes_for_culling,
            max_keyframes=o.max_keyframes,
            kf_min_shared_observations=o.kf_min_shared_observations,
            kf_redundant_ratio=o.kf_redundant_ratio,
            landmark_max_reproj_error=o.landmark_max_reproj_error,
            min_landmark_observations=o.min_landmark_observations,
            min_landmarks_for_culling=o.min_landmarks_for_culling)
        self.host_reads += 1
        if removed >= 0:
            log.info("[Tracking] Culled keyframe in slot %d", removed)
