"""Batched, fixed-shape robust estimation (counterpart of
``visionx_slam_tpu/models/estimation.py``): RGB-D PnP RANSAC, the
motion-prior PnP tier, essential-matrix RANSAC with cheirality recovery,
and two-view DLT triangulation.

The PnP functions take explicit leading batch dimensions (frame pairs, then
hypotheses) where the JAX package used ``vmap``; ``essential_ransac`` solves
one problem, its hypotheses batched. Random minimal sets come from a
``torch.Generator`` by the same Gumbel-top-k construction; torch cannot
reproduce ``jax.random``'s bits, so the samplers also accept injected
indices (tests feed them the JAX package's samples).

Symmetric eigenvectors and 3x3 SVDs come from ``torch.linalg``: their
column signs differ from LAPACK's and JAX's. Essential-matrix candidates are
sign-normalized (``_decompose_uv``) and compared by count in the JAX
package's candidate order, so only exact ties can resolve differently.
``torch.linalg.eigh`` and ``svd`` check their status on the host, which
synchronizes a CUDA stream: they run only on the essential-matrix path
(initialization and the tracking fallback).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops.camera import CameraParams, backproject
from ..ops.index import stable_topk, take_rows
from ..ops.linalg import chol_solve4x4, chol_solve6x6, det3x3, solve3x3, solve6x6_spd
from ..ops.se3 import (
    Pose,
    identity_pose,
    matrix_to_quat,
    quat_to_matrix,
    se3_apply,
    se3_compose,
    se3_exp,
    so3_exp,
    so3_hat,
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


def _identity_where_not(ok: torch.Tensor, pose: Pose) -> Pose:
    """The pose where ``ok``, the identity elsewhere (made on the device:
    a host-built constant would be a synchronizing copy)."""
    ident = identity_pose(ok.shape, pose.q.dtype, pose.q.device)
    return Pose(torch.where(ok[..., None], pose.q, ident.q),
                torch.where(ok[..., None], pose.t, ident.t))


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
    q, t = _identity_where_not(finite, Pose(q, t))
    mask0 = inl[ar, best]

    pose = _pose_gn_refine(cam, Pose(q, t), pts3d, pts2d, mask0.to(pts3d.dtype),
                           iters=refine_iters)
    err = _reproj_err_px(cam, quat_to_matrix(pose.q), pose.t, pts3d, pts2d)
    mask = (err < reproj_thresh) & valid
    n_inliers = mask.sum(-1).to(torch.int32)
    return PnPResult(pose, mask, n_inliers, finite & (n_inliers > 0))


def pnp_prior(
    cam: CameraParams,
    pts3d: torch.Tensor,      # [..., N, 3] world landmarks
    pts2d: torch.Tensor,      # [..., N, 2] pixels in the current frame
    valid: torch.Tensor,      # [..., N] bool
    init_pose: Pose,          # [...]
    reproj_thresh: float = 2.0,
    prior_iters: int = 4,
    refine_iters: int = 2,
) -> PnPResult:
    """Motion-prior-only PnP, the steady-state tier of the scan's tracking:
    robust IRLS from the previous pose over all correspondences, then the
    inlier-set GN refinement and inlier re-count of ``pnp_ransac``. No
    sampling, so no randomness."""
    w = valid.to(pts3d.dtype)
    prior = _pose_gn_refine(cam, init_pose, pts3d, pts2d, w, iters=prior_iters,
                            robust=True, huber_delta=2.0 * reproj_thresh,
                            gate_px=10.0 * reproj_thresh)
    err = _reproj_err_px(cam, quat_to_matrix(prior.q), prior.t, pts3d, pts2d)
    mask0 = (err < reproj_thresh) & valid
    finite = torch.isfinite(prior.q).all(-1) & torch.isfinite(prior.t).all(-1)
    pose = _pose_gn_refine(cam, _identity_where_not(finite, prior), pts3d,
                           pts2d, mask0.to(pts3d.dtype), iters=refine_iters)
    err = _reproj_err_px(cam, quat_to_matrix(pose.q), pose.t, pts3d, pts2d)
    mask = (err < reproj_thresh) & valid
    n_inliers = mask.sum(-1).to(torch.int32)
    return PnPResult(pose, mask, n_inliers, finite & (n_inliers > 0))


# ---------------------------------------------------------------------------
# nullspaces and triangulation
# ---------------------------------------------------------------------------

def _normalize_px(cam: CameraParams, px: torch.Tensor) -> torch.Tensor:
    """Pixels -> normalized image coordinates (pinhole)."""
    return torch.stack([(px[..., 0] - cam.cx) / cam.fx,
                        (px[..., 1] - cam.cy) / cam.fy], dim=-1)


def _eye(d: int, like: torch.Tensor) -> torch.Tensor:
    return torch.eye(d, dtype=like.dtype, device=like.device)


def _unit(v: torch.Tensor, eps: float) -> torch.Tensor:
    return v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True), min=eps)


def _smallest_eigvec(M: torch.Tensor) -> torch.Tensor:
    """Eigenvector of the smallest eigenvalue of symmetric PSD M [..., d, d],
    sharpened by two shifted inverse-iteration steps. d = 4 starts from the
    inhomogeneous solution and solves by unrolled Cholesky (no eigh); other
    sizes start from ``torch.linalg.eigh``."""
    d = M.shape[-1]
    if d == 4:
        X0 = solve3x3(M[..., :3, :3], -M[..., :3, 3])
        X0 = torch.where(torch.isfinite(X0), X0, 0.0)
        v0 = _unit(torch.cat([X0, torch.ones_like(X0[..., :1])], -1), 1e-30)
        tr = M[..., 0, 0] + M[..., 1, 1] + M[..., 2, 2] + M[..., 3, 3]
        shift = 1e-7 * torch.clamp(tr, min=1e-20)
        Ms = M + shift[..., None, None] * _eye(4, M)
        for _ in range(2):
            v0 = _unit(chol_solve4x4(Ms, v0), 1e-30)
        return v0
    # the LAPACK/cuSOLVER routines refuse non-finite input, where JAX returns
    # NaN: solve a zero matrix there and hand back NaN
    bad = ~torch.isfinite(M).all(-1).all(-1)
    M = torch.where(bad[..., None, None], 0.0, M)
    w, v = torch.linalg.eigh(M)
    v0 = v[..., :, 0]
    shift = 1e-7 * torch.clamp(w[..., -1], min=1e-20)
    Ms = M + shift[..., None, None] * _eye(d, M)
    for _ in range(2):
        v0 = _unit(torch.linalg.solve_ex(Ms, v0[..., None])[0][..., 0], 1e-30)
    return torch.where(bad[..., None], torch.nan, v0)


def triangulate_dlt(P1: torch.Tensor, P2: torch.Tensor, uv1: torch.Tensor,
                    uv2: torch.Tensor) -> torch.Tensor:
    """Two-view DLT triangulation of correspondences uv1, uv2 [..., N, 2]
    under projection matrices P1, P2 [..., 3, 4] (pixel-scale K[R|t] or
    normalized [R|t]); row-normalized 4x4 systems, smallest eigenvector."""
    def rows(P, uv):
        P = P[..., None, :, :]
        return (uv[..., 0:1] * P[..., 2, :] - P[..., 0, :],
                uv[..., 1:2] * P[..., 2, :] - P[..., 1, :])

    A = torch.stack([*rows(P1, uv1), *rows(P2, uv2)], dim=-2)   # [..., N, 4, 4]
    A = _unit(A, 1e-12)
    X = _smallest_eigvec(A.transpose(-1, -2) @ A)
    w = X[..., 3]
    safe_w = torch.where(w.abs() < 1e-12, 1e-12, w)
    return X[..., :3] / safe_w[..., None]


def projection_matrix(cam: CameraParams, T_cw: Pose) -> torch.Tensor:
    """K [R|t] [..., 3, 4] (the reference's ProjectionMatrix), built row by
    row on the device."""
    Rt = torch.cat([quat_to_matrix(T_cw.q), T_cw.t[..., :, None]], dim=-1)
    return torch.stack([cam.fx * Rt[..., 0, :] + cam.cx * Rt[..., 2, :],
                        cam.fy * Rt[..., 1, :] + cam.cy * Rt[..., 2, :],
                        Rt[..., 2, :]], dim=-2)


# ---------------------------------------------------------------------------
# essential matrix: 8-point hypotheses, sign-gated consensus, LO, GN polish
# ---------------------------------------------------------------------------

class EssentialResult(NamedTuple):
    R: torch.Tensor            # [3,3] rotation of T_cl (last -> current)
    t: torch.Tensor            # [3] unit-norm translation
    E: torch.Tensor            # [3,3]
    inlier_mask: torch.Tensor  # [N] bool
    n_inliers: torch.Tensor    # [] int32
    ok: torch.Tensor           # [] bool


def _homog(x: torch.Tensor) -> torch.Tensor:
    return torch.cat([x, torch.ones_like(x[..., :1])], dim=-1)


def _kron_rows(h1: torch.Tensor, h2: torch.Tensor) -> torch.Tensor:
    """Constraint rows kron(x2, x1) [..., 9] of x2^T E x1 = 0 (E row-major)."""
    return (h2[..., :, None] * h1[..., None, :]).flatten(-2)


def _eight_point_raw(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """x1, x2 [..., 8, 2] normalized coords -> raw (unprojected) E [..., 3, 3]."""
    A = _kron_rows(_homog(x1), _homog(x2))
    return _smallest_eigvec(A.transpose(-1, -2) @ A).reshape(*A.shape[:-2], 3, 3)


def _project_essential(E: torch.Tensor):
    """E [..., 3, 3] -> (E on the essential manifold, U, Vt)."""
    bad = ~torch.isfinite(E).all(-1).all(-1)
    U, _, Vt = torch.linalg.svd(torch.where(bad[..., None, None], 0.0, E))
    U = torch.where(bad[..., None, None], torch.nan, U)
    Ep = U[..., :, :2] @ Vt[..., :2, :]          # U diag(1, 1, 0) Vt
    return Ep, U, Vt


def _sampson_sq(E: torch.Tensor, h1: torch.Tensor, h2: torch.Tensor) -> torch.Tensor:
    """Squared Sampson distance [..., N] of correspondences h1, h2 [N, 3]
    under E [..., 3, 3]."""
    Ex1 = h1 @ E.transpose(-1, -2)
    Etx2 = h2 @ E
    num = (h2 * Ex1).sum(-1) ** 2
    den = Ex1[..., 0] ** 2 + Ex1[..., 1] ** 2 + Etx2[..., 0] ** 2 + Etx2[..., 1] ** 2
    return num / torch.clamp(den, min=1e-12)


def _two_ray_depths(R: torch.Tensor, t: torch.Tensor, h1: torch.Tensor,
                    h2: torch.Tensor):
    """Least-squares depths (z1, z2) [..., N] of z1 R x1 + t = z2 x2."""
    a = h1 @ R.transpose(-1, -2)
    aa = (a * a).sum(-1)
    bb = (h2 * h2).sum(-1)
    ab = (a * h2).sum(-1)
    at = (a * t[..., None, :]).sum(-1)
    bt = (h2 * t[..., None, :]).sum(-1)
    det = aa * bb - ab * ab
    inv_det = torch.where(det.abs() > 1e-18, 1.0 / det, 0.0)
    return (-bb * at + ab * bt) * inv_det, (-ab * at + aa * bt) * inv_det


def _triangulate_norm(R: torch.Tensor, t: torch.Tensor, x1: torch.Tensor,
                      x2: torch.Tensor):
    """DLT in normalized coords with P1 = [I|0], P2 = [R|t]: (X, z1, z2)."""
    P1 = torch.cat([_eye(3, R), torch.zeros_like(R[:, :1])], dim=1)
    P2 = torch.cat([R, t[:, None]], dim=1)
    X = triangulate_dlt(P1, P2, x1, x2)
    return X, X[:, 2], X @ R[2] + t[2]


_W90 = ((0.0, -1.0, 0.0), (1.0, 0.0, 0.0), (0.0, 0.0, 1.0))


def _decompose_uv(U: torch.Tensor, Vt: torch.Tensor):
    """(Ra, Rb, t) candidates from SVD factors, determinants normalized to
    +1 (so column-sign conventions of the SVD routine cancel)."""
    U = U * torch.sign(det3x3(U))[..., None, None]
    Vt = Vt * torch.sign(det3x3(Vt))[..., None, None]
    # U W Vt and U W^T Vt with W the 90-degree rotation about z, written as
    # column operations on U (no host-built constant)
    u0, u1, u2 = U[..., :, 0], U[..., :, 1], U[..., :, 2]
    UW = torch.stack([u1, -u0, u2], dim=-1)
    UWt = torch.stack([-u1, u0, u2], dim=-1)
    return UW @ Vt, UWt @ Vt, _unit(u2, 1e-12)


def _score_candidates(Ra, Rb, tu, inl, h1, h2):
    """Per hypothesis, the best of (Ra, tu), (Ra, -tu), (Rb, tu), (Rb, -tu)
    by sign-gated consensus (both two-ray depths positive); the first wins
    ties. Returns (count, R, t, mask)."""
    Rs = torch.stack([Ra, Ra, Rb, Rb])                  # [4, ..., 3, 3]
    ts = torch.stack([tu, -tu, tu, -tu])
    z1, z2 = _two_ray_depths(Rs, ts, h1, h2)
    goods = inl & (z1 > 0) & (z2 > 0)                   # [4, ..., N]
    counts = goods.sum(-1)
    ci = torch.argmax(counts, dim=0)                    # first max, [H]
    ar = torch.arange(ci.shape[0], device=ci.device)
    return counts[ci, ar], Rs[ci, ar], ts[ci, ar], goods[ci, ar]


def _refine_essential_pose(R0: torch.Tensor, t0: torch.Tensor,
                           h1: torch.Tensor, h2: torch.Tensor,
                           w: torch.Tensor, iters: int = 10):
    """Gauss-Newton on the Sampson error over (rotation, t-direction): three
    rotation and two t-tangent parameters, E = [t]x R; the Jacobian of the
    5-parameter residual by forward-mode AD (``torch.func.jacfwd``, as the
    JAX package uses ``jax.jacfwd``). Returns (R, unit t)."""
    from torch.func import jacfwd

    def sampson(E):
        Ex1 = h1 @ E.T
        Etx2 = h2 @ E
        num = (h2 * Ex1).sum(-1)
        den = Ex1[:, 0] ** 2 + Ex1[:, 1] ** 2 + Etx2[:, 0] ** 2 + Etx2[:, 1] ** 2
        return num / torch.sqrt(torch.clamp(den, min=1e-18))

    R, t = R0, t0
    e_x = torch.zeros_like(t)
    e_x[0].fill_(1.0)
    e_y = e_x.roll(1)
    for _ in range(iters):
        a = torch.where(t[0].abs() < 0.9, e_x, e_y)
        b1 = _unit(torch.linalg.cross(t, a), 1e-12)
        b2 = torch.linalg.cross(t, b1)

        def res(p, R=R, t=t, b1=b1, b2=b2):
            Rp = quat_to_matrix(so3_exp(p[:3])) @ R
            tp = _unit(t + p[3] * b1 + p[4] * b2, 1e-12)
            return sampson(so3_hat(tp) @ Rp)

        p0 = torch.zeros(5, dtype=t.dtype, device=t.device)
        r = res(p0)
        J = jacfwd(res)(p0)                              # [N,5]
        Jw = J * w[:, None]
        H = J.T @ Jw + 1e-8 * _eye(5, J)
        g = Jw.T @ r
        H6 = torch.block_diag(H, torch.ones_like(H[:1, :1]))
        dp = -solve6x6_spd(H6, torch.cat([g, torch.zeros_like(g[:1])]))[:5]
        dp = torch.where(torch.isfinite(dp).all(), dp, 0.0)
        R = quat_to_matrix(so3_exp(dp[:3])) @ R
        t = _unit(t + dp[3] * b1 + dp[4] * b2, 1e-12)
    return R, t


def _f32(v) -> float:
    return float(np.float32(v))


def essential_ransac(
    cam: CameraParams,
    px_last: torch.Tensor,   # [N,2] pixels in the LAST frame
    px_curr: torch.Tensor,   # [N,2] pixels in the CURRENT frame
    valid: torch.Tensor,     # [N] bool correspondence mask
    gen: torch.Generator | None,
    thresh_px: float = 1.0,
    n_hypotheses: int = 256,
    lo_starts: int = 16,
    polish_iters: int = 10,
    sample_idx: torch.Tensor | None = None,  # [H,8] injected minimal sets
) -> EssentialResult:
    """Essential-matrix RANSAC + pose recovery (cv::findEssentialMat +
    cv::recoverPose semantics, the JAX package's one-tier program):
    8-point hypotheses, projection to the manifold, sign-gated consensus
    over the four decompositions at a loose 4x gate, LO-RANSAC annealed
    4x -> 1x from the top ``lo_starts``, a GN Sampson polish kept if the
    consensus holds, and the 50-unit distance gate on the winner."""
    x1 = _normalize_px(cam, px_last)
    x2 = _normalize_px(cam, px_curr)
    h1, h2 = _homog(x1), _homog(x2)

    idx = sample_minimal_sets(gen, valid, n_hypotheses, 8, sample_idx)   # [H,8]
    Es_raw = _eight_point_raw(x1[idx], x2[idx])

    # thresholds in float32 arithmetic, as the JAX package computes them
    f32 = np.float32
    thresh_norm = f32(thresh_px) / (f32(0.5) * (f32(cam.fx) + f32(cam.fy)))
    loose = f32(4.0) * thresh_norm
    Es, Us, Vts = _project_essential(Es_raw)
    inl = (_sampson_sq(Es, h1, h2) < _f32(loose * loose)) & valid
    Ras, Rbs, tus = _decompose_uv(Us, Vts)
    scores, Rcs, tcs, goods = _score_candidates(Ras, Rbs, tus, inl, h1, h2)

    rows = _kron_rows(h1, h2)                                            # [N,9]

    def gate_at(R_, t_, E_, thr2):
        z1, z2 = _two_ray_depths(R_, t_, h1, h2)
        m_ = (_sampson_sq(E_, h1, h2) < thr2) & valid & (z1 > 0) & (z2 > 0)
        return m_.sum(-1), m_

    # LO chains from the top starts, batched over starts
    n_starts = min(lo_starts, n_hypotheses)
    topi = stable_topk(scores, n_starts)[1]
    E_b, R_b, t_b, m_b = Es[topi], Rcs[topi], tcs[topi], goods[topi]
    for a in (2.0, 1.4, 1.0, 1.0):
        thr = f32(a) * thresh_norm
        thr2 = _f32(thr * thr)
        w_rows = torch.where(m_b[..., None], rows, 0.0)
        e_fit = _smallest_eigvec(w_rows.transpose(-1, -2) @ w_rows).reshape(-1, 3, 3)
        E_f, Uf, Vtf = _project_essential(e_fit)
        Ra_f, Rb_f, tu_f = _decompose_uv(Uf, Vtf)
        inl_f = (_sampson_sq(E_f, h1, h2) < thr2) & valid
        n_f, R_f, t_f, m_f = _score_candidates(Ra_f, Rb_f, tu_f, inl_f, h1, h2)
        n_b, m_b2 = gate_at(R_b, t_b, E_b, thr2)
        take = n_f >= n_b
        E_b = torch.where(take[:, None, None], E_f, E_b)
        R_b = torch.where(take[:, None, None], R_f, R_b)
        t_b = torch.where(take[:, None], t_f, t_b)
        m_b = torch.where(take[:, None], m_f, m_b2)
    tn2 = _f32(thresh_norm * thresh_norm)
    n_j, m_j = gate_at(R_b, t_b, E_b, tn2)
    j = torch.argmax(n_j)
    E, R, t, mask, n_best = E_b[j], R_b[j], t_b[j], m_j[j], n_j[j]

    # GN polish on the manifold, kept if the gated consensus holds
    Rr, tr = _refine_essential_pose(R, t, h1, h2, mask.to(h1.dtype), polish_iters)
    E_ref = so3_hat(tr) @ Rr
    z1r, z2r = _two_ray_depths(Rr, tr, h1, h2)
    n_ref = ((_sampson_sq(E_ref, h1, h2) < tn2) & valid
             & (z1r > 0) & (z2r > 0)).sum()
    better = n_ref >= n_best
    R = torch.where(better, Rr, R)
    t = torch.where(better, tr, t)
    E = torch.where(better, E_ref, E)
    # cv::recoverPose's 50-unit distance gate on the chosen model
    z1f, z2f = _two_ray_depths(R, t, h1, h2)
    dist_mask = ((_sampson_sq(E, h1, h2) < tn2) & valid & (z1f > 0) & (z2f > 0)
                 & (z1f < 50.0) & (z2f < 50.0))
    n_inliers = dist_mask.sum().to(torch.int32)
    ok = (n_inliers > 0) & torch.isfinite(R).all() & torch.isfinite(t).all()
    return EssentialResult(R, t, E, dist_mask, n_inliers, ok)


def nanmedian(x: torch.Tensor) -> torch.Tensor:
    """``jnp.nanmedian`` of a 1-D tensor: the mean of the two middle values
    for an even count (``torch.nanmedian`` returns the lower one); NaN when
    every entry is NaN."""
    a = torch.sort(x).values                         # NaN sorts last
    cnt = (~torch.isnan(a)).sum().to(x.dtype)
    q = 0.5 * (cnt - 1.0)
    low, high = torch.floor(q), torch.ceil(q)
    hw = q - low
    lw = 1.0 - hw
    lo_i = torch.clamp(torch.minimum(low, cnt - 1.0), min=0.0).long()
    hi_i = torch.clamp(torch.minimum(high, cnt - 1.0), min=0.0).long()
    return a.gather(0, lo_i[None])[0] * lw + a.gather(0, hi_i[None])[0] * hw


def essential_scale_from_depth(cam: CameraParams, res: EssentialResult,
                               px_last: torch.Tensor, px_curr: torch.Tensor,
                               depth_last: torch.Tensor) -> torch.Tensor:
    """Metric scale of the essential translation from RGB-D depth: the
    median ratio of measured to unit-scale triangulated depth over the
    essential inliers; 1.0 with fewer than 10 usable pairs."""
    x1 = _normalize_px(cam, px_last)
    x2 = _normalize_px(cam, px_curr)
    X, z1, z2 = _triangulate_norm(res.R, res.t, x1, x2)
    good = (res.inlier_mask & (z1 > 1e-3) & (z2 > 1e-3)
            & (depth_last > 0.1) & (depth_last < 10.0)
            & torch.isfinite(X).all(-1))
    ratio = torch.where(good, depth_last / torch.clamp(z1, min=1e-6), torch.nan)
    scale = nanmedian(ratio)
    ok = ((good.sum() >= 10) & torch.isfinite(scale) & (scale > 1e-3)
          & (scale < 1e3))
    return torch.where(ok, scale, 1.0)
