"""Tracking stages on the map state (counterpart of
``visionx_slam_tpu/tracking/stages.py``): per-frame observations, the init
feature-distribution gate, depth-backprojected and two-view triangulated
landmark creation. The map is updated in place (see ``mapstate``)."""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..models import matching
from ..models.estimation import projection_matrix, triangulate_dlt
from ..models.matching import MatchResult
from ..ops.camera import CameraParams, backproject, project_pinhole
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
