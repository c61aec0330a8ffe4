"""Tracking stages on the map state (counterpart of
``visionx_slam_tpu/tracking/stages.py``): per-frame observations, the init
feature-distribution gate, depth-backprojected and two-view triangulated
landmark creation, landmark and keyframe culling. The map is updated in
place (see ``mapstate``)."""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..models import matching
from ..models.estimation import projection_matrix, triangulate_dlt
from ..models.matching import MatchResult
from ..ops.camera import CameraParams, backproject, project_pinhole
from ..ops.index import segment_sum, segments
from ..ops.se3 import Pose, identity_pose, quat_rotate, se3_apply, se3_inverse
from . import mapstate as msl
from .mapstate import MapState

MIN_DEPTH = 0.1
MAX_DEPTH = 10.0


class FrameObs(NamedTuple):
    """Fixed-size per-frame observation set (extractor output + depth)."""

    px: torch.Tensor        # [..., N, 2] float32 keypoint pixels
    response: torch.Tensor  # [..., N] float32
    desc: torch.Tensor      # [..., N, 32] uint8
    valid: torch.Tensor     # [..., N] bool
    depth: torch.Tensor     # [..., N] float32 meters (0 = missing)


def sample_depth_image(depth_img: torch.Tensor, px: torch.Tensor,
                       valid: torch.Tensor) -> torch.Tensor:
    """Depth at the rounded keypoint pixel; 0 where out of bounds or
    invalid. depth_img [B,H,W], px [B,N,2], valid [B,N] -> [B,N]."""
    B, H, W = depth_img.shape
    u = torch.round(px[..., 0]).long()
    v = torch.round(px[..., 1]).long()
    ok = valid & (u >= 0) & (u < W) & (v >= 0) & (v < H)
    lin = v.clamp(0, H - 1) * W + u.clamp(0, W - 1)
    d = torch.gather(depth_img.reshape(B, H * W), 1, lin)
    return torch.where(ok, d, 0.0)


def feature_distribution_ok(px: torch.Tensor, valid: torch.Tensor,
                            width: int, height: int) -> torch.Tensor:
    """5x5 grid coverage >= 50% (13 of 25 cells): px [N,2] -> [] bool."""
    gc = torch.clamp((px[:, 0] / width * 5).to(torch.int32), 0, 4)
    gr = torch.clamp((px[:, 1] / height * 5).to(torch.int32), 0, 4)
    cell = torch.where(valid, gc * 5 + gr, 25).long()
    hit = torch.zeros(26, dtype=torch.bool, device=px.device)
    hit.index_fill_(0, cell, True)                     # row 25: invalid
    return hit[:25].sum() >= 13


def parallax_px(px_a: torch.Tensor, px_b: torch.Tensor,
                res: MatchResult) -> torch.Tensor:
    """Mean pixel displacement over matches, per pair: px [..., N, 2] -> [...]."""
    px_m = torch.gather(px_b, -2, res.idx[..., None].expand(*res.idx.shape, 2))
    d = torch.linalg.norm(px_a - px_m, dim=-1)
    cnt = res.valid.sum(-1)
    tot = torch.where(res.valid, d, 0.0).sum(-1)
    return torch.where(cnt > 0, tot / cnt.clamp(min=1), 0.0)


def pnp_correspondences(ms: MapState, kf_slot: int, obs: FrameObs,
                        res: MatchResult):
    """3D-2D pairs from the landmark-bearing features of keyframe
    ``kf_slot`` (tracking.cpp:364-407). Row i is keyframe feature i (the
    match query): (pts3d [N,3], pts2d [N,2] current-frame pixels, valid
    [N]: matched, has a live landmark, finite, |p| <= 1000)."""
    feat_lm = ms.kf_feat_lm[kf_slot]
    lm = feat_lm.clamp(0, ms.lm_physical - 1).long()
    p = ms.lm_pos[:, lm].T
    valid = (res.valid & (feat_lm >= 0) & ms.lm_alive[lm]
             & torch.isfinite(p).all(-1) & (p.abs() <= 1000.0).all(-1))
    return p, obs.px[res.idx], valid


def depth_landmarks(ms: MapState, cam: CameraParams, kf_slot: int,
                    pose: Pose) -> MapState:
    """Every valid feature of keyframe ``kf_slot`` without a landmark and
    with depth in [0.1, 10] m backprojects to a new world landmark (observed
    once); the slot's links are updated."""
    px = ms.kf_px[kf_slot].T
    feat_lm = ms.kf_feat_lm[kf_slot]
    d = ms.kf_depth[kf_slot]
    want = ms.kf_fvalid[kf_slot] & (feat_lm < 0) & (d >= MIN_DEPTH) & (d <= MAX_DEPTH)
    pw = se3_apply(se3_inverse(pose), backproject(cam, px, d))
    ms, slots = msl.allocate_landmarks(ms, want, pw, obs_init=1)
    ms.kf_feat_lm[kf_slot] = torch.where(slots >= 0, slots, feat_lm)
    return ms


def _ray_angle_ok(cam: CameraParams, px_a, px_b, pose_a: Pose, pose_b: Pose,
                  min_angle_deg: float) -> torch.Tensor:
    """World-frame angle between the two viewing rays >= min_angle_deg."""
    ones = torch.ones_like(px_a[:, 0])
    f_a = backproject(cam, px_a, ones)
    f_b = backproject(cam, px_b, ones)
    f_a = f_a / torch.clamp(torch.linalg.norm(f_a, dim=-1, keepdim=True), min=1e-12)
    f_b = f_b / torch.clamp(torch.linalg.norm(f_b, dim=-1, keepdim=True), min=1e-12)
    fw_a = quat_rotate(se3_inverse(pose_a).q, f_a)
    fw_b = quat_rotate(se3_inverse(pose_b).q, f_b)
    cos_ang = torch.clamp((fw_a * fw_b).sum(-1), -1.0, 1.0)
    return torch.arccos(cos_ang) >= math.radians(min_angle_deg)


def _triangulate_gated(cam, px_a, px_b, pose_a, pose_b, min_angle_deg,
                       max_reproj):
    """(world points, angle + finite + two-sided reprojection gate)."""
    angle_ok = _ray_angle_ok(cam, px_a, px_b, pose_a, pose_b, min_angle_deg)
    pw = triangulate_dlt(projection_matrix(cam, pose_a),
                         projection_matrix(cam, pose_b), px_a, px_b)
    finite = torch.isfinite(pw).all(-1)
    uv1, ok1, _ = project_pinhole(cam, pose_a, pw)
    uv2, ok2, _ = project_pinhole(cam, pose_b, pw)
    reproj_ok = (ok1 & ok2
                 & (torch.linalg.norm(uv1 - px_a, dim=-1) <= max_reproj)
                 & (torch.linalg.norm(uv2 - px_b, dim=-1) <= max_reproj))
    return pw, angle_ok & finite & reproj_ok


def triangulable_count(cam: CameraParams, px_a: torch.Tensor,
                       px_b: torch.Tensor, valid: torch.Tensor, pose_b: Pose,
                       min_angle_deg: float, max_reproj: float) -> torch.Tensor:
    """How many matches (first frame at identity) would triangulate under
    ``triangulate_pair``'s gates, without touching the map: [] int32."""
    pose_a = identity_pose(device=px_a.device)
    _, ok = _triangulate_gated(cam, px_a, px_b, pose_a, pose_b,
                               min_angle_deg, max_reproj)
    return (valid & ok).sum().to(torch.int32)


def triangulate_pair(ms: MapState, cam: CameraParams, slot_a: int, slot_b: int,
                     min_angle_deg: float, max_reproj: float,
                     res: MatchResult | None = None) -> MapState:
    """TriangulateWithLastKeyFrame between keyframe slots a (earlier, match
    query) and b: ratio-test matches whose features both lack a landmark,
    gated by ray angle and two-sided reprojection error, create landmarks
    (observed twice) linked from both keyframes. One query per train
    feature wins: the lowest distance, then the lowest query row. ``res``:
    the knn2 ratio match of the two slots, when the caller has it."""
    px_a, px_b = ms.kf_px[slot_a].T, ms.kf_px[slot_b].T
    if res is None:
        res = matching.knn2_ratio_match(
            ms.kf_desc[slot_a], ms.kf_fvalid[slot_a],
            ms.kf_desc[slot_b], ms.kf_fvalid[slot_b])
    N = ms.n_features
    dev = px_a.device
    idx = res.idx.long()
    lm_a = ms.kf_feat_lm[slot_a]
    lm_b = ms.kf_feat_lm[slot_b].clone()
    free = (lm_a < 0) & (lm_b[idx] < 0)
    pw, gate = _triangulate_gated(cam, px_a, px_b[idx], msl.map_pose(ms, slot_a),
                                  msl.map_pose(ms, slot_b), min_angle_deg,
                                  max_reproj)
    want = res.valid & free & gate

    # dedupe the train side: per train feature, the best (distance, row)
    dist_c = torch.clamp(res.dist, max=511.0)
    rows = torch.arange(N, device=dev)
    best_d = torch.full((N + 1,), torch.inf, device=dev).scatter_reduce(
        0, torch.where(want, idx, N), dist_c, "amin")
    tied = want & (dist_c == best_d[idx])
    best_q = torch.full((N + 1,), N, device=dev).scatter_reduce(
        0, torch.where(tied, idx, N), rows, "amin")
    want = tied & (rows == best_q[idx])

    ms, slots = msl.allocate_landmarks(ms, want, pw, obs_init=2)
    created = slots >= 0
    links_a = torch.where(created, slots, lm_a)
    links_b = torch.cat([lm_b, lm_b[:1]])              # row N takes the rest
    links_b.scatter_(0, torch.where(created, idx, N), torch.where(created, slots, 0))
    ms.kf_feat_lm[slot_a] = links_a
    ms.kf_feat_lm[slot_b] = links_b[:N]
    return ms


# ---------------------------------------------------------------------------
# culling
# ---------------------------------------------------------------------------

def cull_landmarks(ms: MapState, cam: CameraParams, max_reproj: float,
                   min_obs: int = 2, gate: torch.Tensor | None = None):
    """CullLandmarks (tracking.cpp:652-750): kill the landmarks with too few
    observations, no measurable reprojection, any error > 2 x
    ``max_reproj`` or a mean error > ``max_reproj``. ``gate``: an optional
    [] bool on the device; nothing is killed where it is False (the
    caller's ``min_landmarks_for_culling`` test, without a host read).
    Returns (state, n_culled [] int32).

    The per-landmark sums are segment sums in a fixed order (the
    unmeasurable observations belong to no landmark), so a landmark whose
    mean error sits within rounding of the threshold falls on the same side
    in every run."""
    L = ms.lm_physical
    dev = ms.kf_q.device
    has = msl.kf_alive(ms)[:, None] & ms.kf_fvalid & (ms.kf_feat_lm >= 0)
    lm = ms.kf_feat_lm.clamp(0, L - 1).long()
    pw = ms.lm_pos[:, lm].permute(1, 2, 0)                       # [K,N,3]
    uv, ok, _ = project_pinhole(cam, Pose(ms.kf_q[:, None], ms.kf_t[:, None]), pw)
    err = torch.linalg.norm(uv - ms.kf_px.transpose(1, 2), dim=-1)
    measurable = (has & ok).reshape(-1)       # a failed projection is skipped
    seg = torch.where(measurable, lm.reshape(-1), L)             # spare row L
    err_flat = torch.where(measurable, err.reshape(-1), 0.0)
    table = segment_sum(torch.stack([err_flat, measurable.to(err.dtype)], -1),
                        segments(seg, L))
    err_sum, cnt = table[:L, 0], table[:L, 1]
    err_max = torch.zeros(L + 1, dtype=err.dtype, device=dev).scatter_reduce_(
        0, seg, err_flat, "amax")[:L]
    mean_err = err_sum / torch.clamp(cnt, min=1)
    kill = ms.lm_alive & ((msl.landmark_observation_counts(ms) < min_obs)
                          | (cnt == 0) | (err_max > 2.0 * max_reproj)
                          | (mean_err > max_reproj))
    if gate is not None:
        kill = kill & gate
    return msl.remove_landmarks(ms, kill), kill.sum().to(torch.int32)


def keyframe_redundancy(ms: MapState, min_shared: int):
    """Per keyframe, the share of its landmark-bearing features whose
    landmark is alive and observed by >= ``min_shared`` keyframes
    (CullKeyFrames, tracking.cpp:775-832): (ratio [K] f32, total [K])."""
    has = msl.kf_alive(ms)[:, None] & ms.kf_fvalid & (ms.kf_feat_lm >= 0)
    lm = ms.kf_feat_lm.clamp(0, ms.lm_physical - 1).long()
    total = has.sum(1)
    redundant = (has & ms.lm_alive[lm]
                 & (msl.landmark_observation_counts(ms)[lm] >= min_shared)).sum(1)
    return redundant.float() / total.clamp(min=1).float(), total


def cull_keyframes_device(
    ms: MapState,
    cam: CameraParams,
    last_kf_slot: int,
    init_kf_slot: int,
    current_frame_id: int,
    *,
    min_keyframes_for_culling: int,
    max_keyframes: int,
    kf_min_shared_observations: int,
    kf_redundant_ratio: float,
    landmark_max_reproj_error: float,
    min_landmark_observations: int,
    min_landmarks_for_culling: int = 0,
):
    """CullKeyFrames (tracking.cpp:775-840): remove at most one redundant
    keyframe, the first in ascending frame id that is neither the last
    keyframe, the init keyframe nor the current frame, then cull landmarks
    again (only on a map of at least ``min_landmarks_for_culling``
    landmarks, where that is given: the host tracker's rule). The decision
    is a host branch: one device read of (do_cull, slot). Returns (state,
    removed slot or -1, landmarks culled [] int32)."""
    K = ms.kf_capacity
    dev = ms.kf_q.device
    n_kf = msl.n_keyframes(ms)
    ratio, total = keyframe_redundancy(ms, kf_min_shared_observations)
    exceeded = (n_kf > max_keyframes) if max_keyframes > 0 else False
    slots = torch.arange(K, device=dev)
    eligible = (msl.kf_alive(ms) & (total > 0) & (slots != last_kf_slot)
                & (slots != init_kf_slot) & (ms.kf_id != current_frame_id)
                & (ratio > kf_redundant_ratio) & (exceeded | (ratio > 0.95)))
    ids = torch.where(eligible, ms.kf_id, torch.iinfo(torch.int32).max)
    do_cull = (n_kf > min_keyframes_for_culling) & eligible.any()
    do_cull, slot = torch.stack([do_cull.long(), torch.argmin(ids)]).tolist()
    if not do_cull:
        return ms, -1, torch.zeros((), dtype=torch.int32, device=dev)
    ms = msl.remove_keyframe_slot(ms, slot)
    gate = (msl.n_landmarks(ms) >= min_landmarks_for_culling
            if min_landmarks_for_culling > 0 else None)
    ms, n_culled = cull_landmarks(ms, cam, landmark_max_reproj_error,
                                  min_landmark_observations, gate=gate)
    return ms, slot, n_culled
