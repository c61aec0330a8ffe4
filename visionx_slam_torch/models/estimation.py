"""Batched, fixed-shape RGB-D PnP RANSAC (the RGB-D subset of
``visionx_slam_tpu/models/estimation.py``).

Every function takes explicit leading batch dimensions (frame pairs, then
hypotheses) where the JAX package used ``vmap``. Random minimal sets come
from a ``torch.Generator`` by the same Gumbel-top-k construction; torch
cannot reproduce ``jax.random``'s bits, so ``sample_minimal_sets`` also
accepts injected indices (tests feed it the JAX package's samples).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.camera import CameraParams, backproject
from ..ops.index import stable_topk, take_rows
from ..ops.linalg import chol_solve6x6
from ..ops.se3 import (
    Pose,
    matrix_to_quat,
    quat_to_matrix,
    se3_apply,
    se3_compose,
    se3_exp,
)

BIG = 1e9


class PnPResult(NamedTuple):
    pose: Pose                # T_cw, batch [...]
    inlier_mask: torch.Tensor  # [..., N] bool
    n_inliers: torch.Tensor    # [...] int32
    ok: torch.Tensor           # [...] bool


def sample_minimal_sets(gen: torch.Generator | None, valid: torch.Tensor,
                        n_hypotheses: int, k: int,
                        idx: torch.Tensor | None = None) -> torch.Tensor:
    """[..., H, k] indices, distinct within a hypothesis, valid-only:
    Gumbel noise on log(valid), then the k largest (stable top-k). With
    fewer than k valid entries invalid indices leak in; such hypotheses
    lose the consensus vote. ``idx`` given: returned as is (int64)."""
    if idx is not None:
        return idx.long()
    n = valid.shape[-1]
    u = torch.rand((*valid.shape[:-1], n_hypotheses, n), generator=gen,
                   device=valid.device)
    u = u.clamp(min=torch.finfo(torch.float32).tiny)
    g = -torch.log(-torch.log(u))
    scores = g + torch.where(valid[..., None, :], 0.0, -torch.inf)
    return stable_topk(scores, k)[1]


def _kabsch3(P: torch.Tensor, Q: torch.Tensor):
    """Rigid transform from 3 exact 3D-3D correspondences (R P_i + t = Q_i)
    by the orthonormal-triad construction. P, Q: [..., 3, 3] (rows are
    points). Returns (R [..., 3, 3], t [..., 3])."""

    def triad(X):
        e1 = X[..., 1, :] - X[..., 0, :]
        e1 = e1 / torch.clamp(torch.linalg.norm(e1, dim=-1, keepdim=True), min=1e-12)
        n = torch.linalg.cross(e1, X[..., 2, :] - X[..., 0, :])
        e3 = n / torch.clamp(torch.linalg.norm(n, dim=-1, keepdim=True), min=1e-12)
        e2 = torch.linalg.cross(e3, e1)
        return torch.stack([e1, e2, e3], dim=-1)  # columns

    R = triad(Q) @ triad(P).transpose(-1, -2)
    t = Q.mean(dim=-2) - (R @ P.mean(dim=-2)[..., None])[..., 0]
    return R, t


def _reproj_err_px(cam: CameraParams, R, t, X, px):
    """Pixel reprojection error [..., N] of X [..., N, 3] under (R, t);
    BIG behind the camera."""
    pc = X @ R.transpose(-1, -2) + t[..., None, :]
    z = torch.clamp(pc[..., 2], min=1e-6)
    u = cam.fx * pc[..., 0] / z + cam.cx
    v = cam.fy * pc[..., 1] / z + cam.cy
    err = torch.stack([u, v], -1) - px
    return torch.where(pc[..., 2] <= 1e-6, BIG, torch.linalg.norm(err, dim=-1))


def _pose_gn_refine(cam: CameraParams, pose: Pose, X: torch.Tensor,
                    px: torch.Tensor, w: torch.Tensor, iters: int = 10,
                    robust: bool = False, huber_delta: float = 0.0,
                    gate_px: float = 0.0) -> Pose:
    """Pose-only Gauss-Newton on weighted reprojection, batched: pose
    [...], X [..., N, 3], px [..., N, 2], w [..., N]. J = J_proj(pc) @
    [I | -hat(pc)], left-multiplicative update; the 6x6 normal equations
    and rhs come from one augmented [7,2N]x[2N,7] product. ``robust``:
    Huber IRLS weights with a gate, per iteration."""
    fx, fy = cam.fx, cam.fy
    eye6 = 1e-6 * torch.eye(6, dtype=X.dtype, device=X.device)
    for _ in range(iters):
        pc = se3_apply(Pose(pose.q[..., None, :], pose.t[..., None, :]), X)
        x, y = pc[..., 0], pc[..., 1]
        z = torch.clamp(pc[..., 2], min=1e-6)
        iz = 1.0 / z
        xiz, yiz = x * iz, y * iz
        u_err = px[..., 0] - (fx * xiz + cam.cx)
        v_err = px[..., 1] - (fy * yiz + cam.cy)
        ww = w * (pc[..., 2] > 1e-6)
        if robust:
            en = torch.sqrt(u_err * u_err + v_err * v_err)
            ww = ww * torch.where(en <= huber_delta, 1.0,
                                  huber_delta / torch.clamp(en, min=1e-9))
            ww = ww * (en <= gate_px)
        xyiz2 = xiz * yiz
        zero = torch.zeros_like(iz)
        Gu = torch.stack([fx * iz, zero, -fx * xiz * iz, -fx * xyiz2,
                          fx * (1.0 + xiz * xiz), -fx * yiz, u_err], -1)
        Gv = torch.stack([zero, fy * iz, -fy * yiz * iz,
                          -fy * (1.0 + yiz * yiz), fy * xyiz2, fy * xiz,
                          v_err], -1)
        G = torch.cat([Gu, Gv], dim=-2)                        # [..., 2N, 7]
        wf = torch.cat([ww, ww], dim=-1)
        M = (G * wf[..., None]).transpose(-1, -2) @ G          # [..., 7, 7]
        H = M[..., :6, :6] + eye6
        dx = chol_solve6x6(H, M[..., :6, 6])
        dx = torch.where(torch.isfinite(dx).all(-1, keepdim=True), dx, 0.0)
        pose = se3_compose(se3_exp(dx), pose)
    return pose


def pnp_ransac(
    cam: CameraParams,
    pts3d: torch.Tensor,      # [P,N,3] world landmarks
    pts2d: torch.Tensor,      # [P,N,2] pixels in the current frame
    valid: torch.Tensor,      # [P,N] bool
    gen: torch.Generator | None,
    reproj_thresh: float = 2.0,
    n_hypotheses: int = 64,
    refine_iters: int = 6,
    init_pose: Pose | None = None,       # [P]
    depth_curr: torch.Tensor | None = None,  # [P,N] current-frame depth (m)
    sample_idx: torch.Tensor | None = None,  # [P,H,3] injected minimal sets
) -> PnPResult:
    """RGB-D PnP RANSAC batched over P problems: 3-point Procrustes
    hypotheses on depth-backprojected points, pre-scored; the best
    min(16, H) get a 2-step GN polish on their own sample; ``init_pose``
    adds a robust IRLS motion-prior hypothesis; the consensus winner is
    refined on its inliers (``refine_iters`` GN steps) and re-scored."""
    if depth_curr is None:
        raise NotImplementedError("the monocular (DLT) variant is not ported")
    P, N = valid.shape
    good_d = (depth_curr > 0.1) & (depth_curr < 10.0) & valid
    idx = sample_minimal_sets(gen, good_d, n_hypotheses, 3, sample_idx)
    q_cam = backproject(cam, pts2d, depth_curr)               # [P,N,3]
    Rs, ts = _kabsch3(take_rows(pts3d, idx), take_rows(q_cam, idx))  # [P,H,...]
    finite_h = torch.isfinite(Rs).all(-1).all(-1) & torch.isfinite(ts).all(-1)
    eye3 = torch.eye(3, dtype=Rs.dtype, device=Rs.device)
    Rs = torch.where(finite_h[..., None, None], Rs, eye3)
    ts = torch.where(finite_h[..., None], ts, 0.0)

    # pre-score the raw hypotheses; keep the best few for the GN polish
    n_polish = min(16, n_hypotheses)
    X1 = pts3d[:, None]
    x1 = pts2d[:, None]
    raw_errs = _reproj_err_px(cam, Rs, ts, X1, x1)          # [P,H,N]
    raw_counts = ((raw_errs < 4.0 * reproj_thresh) & valid[:, None]).sum(-1)
    keep = stable_topk(raw_counts, n_polish)[1]              # [P,n_polish]
    Rs = torch.gather(Rs, 1, keep[..., None, None].expand(-1, -1, 3, 3))
    ts = torch.gather(ts, 1, keep[..., None].expand(-1, -1, 3))
    idx = torch.gather(idx, 1, keep[..., None].expand(-1, -1, 3))

    sample_w = torch.zeros((P, n_polish, N), dtype=pts3d.dtype,
                           device=pts3d.device)
    sample_w.scatter_(-1, idx, 1.0)                          # one-hot of sample
    poses_h = _pose_gn_refine(cam, Pose(matrix_to_quat(Rs), ts), X1, x1,
                              sample_w, iters=2)
    if init_pose is not None:
        prior = _pose_gn_refine(cam, init_pose, pts3d, pts2d, valid.to(pts3d.dtype),
                                iters=4, robust=True,
                                huber_delta=2.0 * reproj_thresh,
                                gate_px=10.0 * reproj_thresh)
        poses_h = Pose(torch.cat([poses_h.q, prior.q[:, None]], 1),
                       torch.cat([poses_h.t, prior.t[:, None]], 1))

    errs = _reproj_err_px(cam, quat_to_matrix(poses_h.q), poses_h.t, X1, x1)
    inl = (errs < reproj_thresh) & valid[:, None]
    best = torch.argmax(inl.sum(-1), dim=1)                  # first max
    ar = torch.arange(P, device=valid.device)
    q, t = poses_h.q[ar, best], poses_h.t[ar, best]
    finite = torch.isfinite(q).all(-1) & torch.isfinite(t).all(-1)
    q = torch.where(finite[:, None], q, q.new_tensor([1.0, 0, 0, 0]))
    t = torch.where(finite[:, None], t, 0.0)
    mask0 = inl[ar, best]

    pose = _pose_gn_refine(cam, Pose(q, t), pts3d, pts2d, mask0.to(pts3d.dtype),
                           iters=refine_iters)
    err = _reproj_err_px(cam, quat_to_matrix(pose.q), pose.t, pts3d, pts2d)
    mask = (err < reproj_thresh) & valid
    n_inliers = mask.sum(-1).to(torch.int32)
    return PnPResult(pose, mask, n_inliers, finite & (n_inliers > 0))
