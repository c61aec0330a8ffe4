"""Batched, fixed-shape robust estimation (counterpart of
``visionx_slam_tpu/models/estimation.py``): PnP RANSAC (RGB-D Procrustes
and monocular 6-point DLT hypotheses), the motion-prior PnP tier,
essential-matrix RANSAC with cheirality recovery, and two-view DLT
triangulation.

The RANSAC functions take explicit leading batch dimensions (problems, then
hypotheses) where the JAX package used ``vmap``. Random minimal sets come
from a ``torch.Generator``, or from uniforms the caller drew (``noise``), by
the same Gumbel-top-k construction; torch cannot reproduce
``jax.random``'s bits, so the samplers also accept injected indices (tests
feed them the JAX package's samples).

Symmetric eigenvectors and 3x3 SVDs come from ``torch.linalg``: their
column signs differ from LAPACK's and JAX's. Essential-matrix candidates are
sign-normalized (``_decompose_uv``) and compared by count in the JAX
package's candidate order, so only exact ties can resolve differently.
``torch.linalg.eigh`` and ``svd`` check their status on the host, which
synchronizes a CUDA stream: they run only in the essential-matrix and DLT
PnP paths (the scan's initialization and fallback, and the monocular
offline pipeline, once per chunk of problems).
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
from ..utils.logging import count_sync, span

BIG = 1e9


class PnPResult(NamedTuple):
    pose: Pose                # T_cw, batch [...]
    inlier_mask: torch.Tensor  # [..., N] bool
    n_inliers: torch.Tensor    # [...] int32
    ok: torch.Tensor           # [...] bool


def sample_minimal_sets(gen: torch.Generator | None, valid: torch.Tensor,
                        n_hypotheses: int, k: int,
                        idx: torch.Tensor | None = None,
                        log_weights: torch.Tensor | None = None,
                        noise: torch.Tensor | None = None) -> torch.Tensor:
    """[..., H, k] indices, distinct within a hypothesis, valid-only:
    Gumbel noise on log(valid), then the k largest (stable top-k). With
    fewer than k valid entries invalid indices leak in; such hypotheses
    lose the consensus vote. ``idx`` given: returned as is (int64).
    ``log_weights`` [..., N]: PROSAC-style bias, sets drawn with
    probability proportional to exp(log_weights). ``noise`` [..., H, N]:
    the uniforms to use instead of drawing from ``gen``."""
    if idx is not None:
        return idx.long()
    n = valid.shape[-1]
    u = noise if noise is not None else torch.rand(
        (*valid.shape[:-1], n_hypotheses, n), generator=gen,
        device=valid.device)
    u = u.clamp(min=torch.finfo(torch.float32).tiny)
    g = -torch.log(-torch.log(u))
    scores = g + torch.where(valid[..., None, :], 0.0, -torch.inf)
    if log_weights is not None:
        scores = scores + log_weights[..., None, :]
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


def _dlt_pnp(X: torch.Tensor, x: torch.Tensor):
    """Minimal DLT pose from 6 points: X [..., 6, 3] world, x [..., 6, 2]
    normalized. The points are centred and scaled, the 12x12 normal
    matrix's smallest eigenvector gives the projective P, and +P and -P are
    each snapped to SE(3) by SVD (closest rotation, translation over the
    mean singular value); the sign that puts more of the sample in front
    wins (+P on ties). Returns (R [..., 3, 3], t [..., 3])."""
    c = X.mean(dim=-2, keepdim=True)
    s = torch.clamp(torch.linalg.norm(X - c, dim=-1).mean(-1), min=1e-9)
    Xn = (X - c) / s[..., None, None]
    Xh = _homog(Xn)                                            # [..., 6, 4]
    zeros = torch.zeros_like(Xh)
    rows_u = torch.cat([Xh, zeros, -x[..., 0:1] * Xh], dim=-1)  # [..., 6, 12]
    rows_v = torch.cat([zeros, Xh, -x[..., 1:2] * Xh], dim=-1)
    A = torch.cat([rows_u, rows_v], dim=-2)                    # [..., 12, 12]
    P = _smallest_eigvec(A.transpose(-1, -2) @ A).reshape(*A.shape[:-2], 3, 4)

    Ps = torch.stack([P, -P])                                  # [2, ..., 3, 4]
    M = Ps[..., :3]
    bad = ~torch.isfinite(M).all(-1).all(-1)
    Um, Sm, Vmt = torch.linalg.svd(torch.where(bad[..., None, None], 0.0, M))
    count_sync(2)           # a batched svd waits twice on the card
    Um = torch.where(bad[..., None, None], torch.nan, Um)
    d = det3x3(Um) * det3x3(Vmt)
    Um = torch.cat([Um[..., :2], Um[..., 2:] * d[..., None, None]], dim=-1)
    R = Um @ Vmt                                  # Um diag(1, 1, d) Vmt
    t = Ps[..., 3] / torch.clamp(Sm.mean(-1, keepdim=True), min=1e-12)
    z = (Xn @ R[..., 2, :, None])[..., 0] + t[..., 2:3]       # [2, ..., 6]
    pick_a = (z[0] > 0).sum(-1) >= (z[1] > 0).sum(-1)
    R = torch.where(pick_a[..., None, None], R[0], R[1])
    t = torch.where(pick_a[..., None], t[0], t[1])
    # undo the normalization: x ~ R (X - c) / s + t
    t_full = s[..., None] * t - (R @ c[..., 0, :, None])[..., 0]
    return R, t_full


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
    Huber IRLS weights with a gate, per iteration. Ends the stage clock's
    ``gn`` span."""
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
    span("gn")
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
    sample_idx: torch.Tensor | None = None,  # [P,H,k] injected minimal sets
    noise: torch.Tensor | None = None,       # [P,H,N] sampling uniforms
) -> PnPResult:
    """PnP RANSAC batched over P problems. Hypotheses: with ``depth_curr``
    (RGB-D), 3-point Procrustes on depth-backprojected points; without,
    6-point DLT (``_dlt_pnp``, monocular). They are pre-scored and the
    best min(16, H) get a 2-step GN polish on their own sample;
    ``init_pose`` adds a robust IRLS motion-prior hypothesis; the consensus
    winner is refined on its inliers (``refine_iters`` GN steps) and
    re-scored. On the stage clock everything but the GN steps is the
    ``ransac`` span."""
    P, N = valid.shape
    if depth_curr is not None:
        good_d = (depth_curr > 0.1) & (depth_curr < 10.0) & valid
        idx = sample_minimal_sets(gen, good_d, n_hypotheses, 3, sample_idx,
                                  noise=noise)
        q_cam = backproject(cam, pts2d, depth_curr)           # [P,N,3]
        Rs, ts = _kabsch3(take_rows(pts3d, idx), take_rows(q_cam, idx))
    else:
        idx = sample_minimal_sets(gen, valid, n_hypotheses, 6, sample_idx,
                                  noise=noise)
        Rs, ts = _dlt_pnp(take_rows(pts3d, idx),
                          take_rows(_normalize_px(cam, pts2d), idx))
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
    idx = torch.gather(idx, 1, keep[..., None].expand(-1, -1, idx.shape[-1]))

    sample_w = torch.zeros((P, n_polish, N), dtype=pts3d.dtype,
                           device=pts3d.device)
    sample_w.scatter_(-1, idx, 1.0)                          # one-hot of sample
    span("ransac")
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
    span("ransac")

    pose = _pose_gn_refine(cam, Pose(q, t), pts3d, pts2d, mask0.to(pts3d.dtype),
                           iters=refine_iters)
    err = _reproj_err_px(cam, quat_to_matrix(pose.q), pose.t, pts3d, pts2d)
    mask = (err < reproj_thresh) & valid
    n_inliers = mask.sum(-1).to(torch.int32)
    span("ransac")
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
    count_sync()            # eigh reads its status on the host
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
    count_sync(2)           # a batched svd waits twice on the card
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
    ci = torch.argmax(counts, dim=0, keepdim=True)      # first max
    pick = lambda x: torch.take_along_dim(
        x, ci.reshape(*ci.shape, *([1] * (x.dim() - ci.dim()))), dim=0)[0]
    return pick(counts), pick(Rs), pick(ts), pick(goods)


def _sampson_and_jacobian(R: torch.Tensor, t: torch.Tensor, b1: torch.Tensor,
                          b2: torch.Tensor, h1: torch.Tensor, h2: torch.Tensor):
    """The signed Sampson residual r [..., N] of E = [unit(t)]x R and its
    Jacobian [..., N, 5] at 0 in the parameters p of E(p) = [unit(t + p_3
    b1 + p_4 b2)]x exp(p_:3) R: the derivative the JAX package takes by
    ``jax.jacfwd``, in closed form (dE/dp_k = [u]x [e_k]x R for the
    rotation, [(b - u (u.b)) / |t|]x R for the tangents, u = unit(t))."""
    n = torch.clamp(torch.linalg.norm(t, dim=-1, keepdim=True), min=1e-12)
    u = t / n
    E = so3_hat(u) @ R
    eye3 = _eye(3, R)
    d_rot = so3_hat(u)[..., None, :, :] @ so3_hat(eye3) @ R[..., None, :, :]
    db = torch.stack([b1, b2], -2)                         # [..., 2, 3]
    du = (db - u[..., None, :] * (db * u[..., None, :]).sum(-1, keepdim=True)) / n[..., None]
    dE = torch.cat([d_rot, so3_hat(du) @ R[..., None, :, :]], -3)   # [..., 5, 3, 3]

    Ex1 = h1 @ E.transpose(-1, -2)                         # [..., N, 3]
    Etx2 = h2 @ E
    num = (h2 * Ex1).sum(-1)
    den = Ex1[..., 0] ** 2 + Ex1[..., 1] ** 2 + Etx2[..., 0] ** 2 + Etx2[..., 1] ** 2
    dcl = torch.clamp(den, min=1e-18)
    r = num / torch.sqrt(dcl)
    dEx1 = h1[..., None, :, :] @ dE.transpose(-1, -2)      # [..., 5, N, 3]
    dEtx2 = h2[..., None, :, :] @ dE
    dnum = (h2[..., None, :, :] * dEx1).sum(-1)            # [..., 5, N]
    dden = 2.0 * (Ex1[..., None, :, 0] * dEx1[..., 0] + Ex1[..., None, :, 1] * dEx1[..., 1]
                  + Etx2[..., None, :, 0] * dEtx2[..., 0]
                  + Etx2[..., None, :, 1] * dEtx2[..., 1])
    dden = torch.where((den > 1e-18)[..., None, :], dden, 0.0)
    dr = dnum / torch.sqrt(dcl)[..., None, :] - (num * 0.5 / (dcl * torch.sqrt(dcl)))[..., None, :] * dden
    return r, dr.transpose(-1, -2)


def _refine_essential_pose(R0: torch.Tensor, t0: torch.Tensor,
                           h1: torch.Tensor, h2: torch.Tensor,
                           w: torch.Tensor, iters: int = 10):
    """Gauss-Newton on the Sampson error over (rotation, t-direction),
    batched over leading dimensions: three rotation and two t-tangent
    parameters, E = [t]x R, the Jacobian in closed form
    (``_sampson_and_jacobian``). R0 [..., 3, 3], t0 [..., 3], h1, h2
    [..., N, 3], w [..., N]. Returns (R, unit t)."""
    R, t = R0, t0
    e_x = torch.zeros_like(t)
    e_x[..., 0].fill_(1.0)
    e_y = e_x.roll(1, -1)
    eye5 = _eye(5, t)
    for _ in range(iters):
        a = torch.where(t[..., :1].abs() < 0.9, e_x, e_y)
        b1 = _unit(torch.linalg.cross(t, a), 1e-12)
        b2 = torch.linalg.cross(t, b1)
        r, J = _sampson_and_jacobian(R, t, b1, b2, h1, h2)   # [..., N], [..., N, 5]
        Jw = J * w[..., None]
        H = J.transpose(-1, -2) @ Jw + 1e-8 * eye5
        g = (Jw.transpose(-1, -2) @ r[..., None])[..., 0]
        H6 = torch.cat([torch.cat([H, torch.zeros_like(H[..., :1])], -1),
                        torch.cat([torch.zeros_like(H[..., :1, :]),
                                   torch.ones_like(H[..., :1, :1])], -1)], -2)
        dp = -solve6x6_spd(H6, torch.cat([g, torch.zeros_like(g[..., :1])], -1))[..., :5]
        dp = torch.where(torch.isfinite(dp).all(-1, keepdim=True), dp, 0.0)
        R = quat_to_matrix(so3_exp(dp[..., :3])) @ R
        t = _unit(t + dp[..., 3:4] * b1 + dp[..., 4:5] * b2, 1e-12)
    return R, t


def _f32(v) -> float:
    return float(np.float32(v))


def _rows_at(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [P, M, ...] at idx [P, J] along dim 1 -> [P, J, ...]."""
    return torch.take_along_dim(
        x, idx.reshape(*idx.shape, *([1] * (x.dim() - 2))), dim=1)


def essential_ransac(
    cam: CameraParams,
    px_last: torch.Tensor,   # [P,N,2] (or [N,2]) pixels in the LAST frame
    px_curr: torch.Tensor,   # [P,N,2] pixels in the CURRENT frame
    valid: torch.Tensor,     # [P,N] bool correspondence mask
    gen: torch.Generator | None,
    thresh_px: float = 1.0,
    n_hypotheses: int = 256,
    lo_starts: int = 16,
    polish_iters: int = 10,
    sample_idx: torch.Tensor | None = None,  # [P,H,8] injected minimal sets
    sample_logw: torch.Tensor | None = None,  # [P,N] PROSAC sampling bias
    score_top_k: int | None = None,
    noise: torch.Tensor | None = None,        # [P,H,N] sampling uniforms
) -> EssentialResult:
    """Essential-matrix RANSAC + pose recovery (cv::findEssentialMat +
    cv::recoverPose semantics), batched over P problems; a problem without
    its leading dimension gives results without it. 8-point hypotheses;
    with ``score_top_k`` < H, only the top ``score_top_k`` by raw Sampson
    count go on (two-tier scoring); projection to the manifold, sign-gated
    consensus over the four decompositions at a loose 4x gate, LO-RANSAC
    annealed 4x -> 1x from the top ``lo_starts``, a GN Sampson polish kept
    if the consensus holds, and the 50-unit distance gate on the winner.
    Each batched ``eigh``/``svd`` synchronizes a CUDA stream once per call
    (F7), so callers batch many problems into one call. The whole call is
    the stage clock's ``ransac`` span."""
    single = valid.dim() == 1
    if single:
        px_last, px_curr, valid = px_last[None], px_curr[None], valid[None]
        sample_idx = None if sample_idx is None else sample_idx[None]
        sample_logw = None if sample_logw is None else sample_logw[None]
        noise = None if noise is None else noise[None]
    x1 = _normalize_px(cam, px_last)
    x2 = _normalize_px(cam, px_curr)
    h1, h2 = _homog(x1), _homog(x2)                      # [P,N,3]
    hb1, hb2, vb = h1[:, None], h2[:, None], valid[:, None]   # per hypothesis

    idx = sample_minimal_sets(gen, valid, n_hypotheses, 8, sample_idx,
                              log_weights=sample_logw, noise=noise)  # [P,H,8]
    Es_raw = _eight_point_raw(take_rows(x1, idx), take_rows(x2, idx))

    # thresholds in float32 arithmetic, as the JAX package computes them
    f32 = np.float32
    thresh_norm = f32(thresh_px) / (f32(0.5) * (f32(cam.fx) + f32(cam.fy)))
    loose = f32(4.0) * thresh_norm
    loose2 = _f32(loose * loose)
    score_k = n_hypotheses if score_top_k is None else min(n_hypotheses,
                                                           score_top_k)
    if score_k < n_hypotheses:
        # two-tier scoring: the raw Sampson count picks the hypotheses that
        # get the SVD and the cheirality vote
        n_sampson = ((_sampson_sq(Es_raw, hb1, hb2) < loose2) & vb).sum(-1)
        Es_raw = _rows_at(Es_raw, stable_topk(n_sampson, score_k)[1])
    Es, Us, Vts = _project_essential(Es_raw)             # [P,K,3,3]
    inl = (_sampson_sq(Es, hb1, hb2) < loose2) & vb
    Ras, Rbs, tus = _decompose_uv(Us, Vts)
    scores, Rcs, tcs, goods = _score_candidates(Ras, Rbs, tus, inl, hb1, hb2)

    rows = _kron_rows(h1, h2)[:, None]                   # [P,1,N,9]

    def gate_at(R_, t_, E_, thr2):
        z1, z2 = _two_ray_depths(R_, t_, hb1, hb2)
        m_ = (_sampson_sq(E_, hb1, hb2) < thr2) & vb & (z1 > 0) & (z2 > 0)
        return m_.sum(-1), m_

    # LO chains from the top starts, batched over problems and starts
    n_starts = min(lo_starts, n_hypotheses, scores.shape[-1])
    topi = stable_topk(scores, n_starts)[1]
    E_b, R_b, t_b, m_b = (_rows_at(x, topi) for x in (Es, Rcs, tcs, goods))
    for a in (2.0, 1.4, 1.0, 1.0):
        thr = f32(a) * thresh_norm
        thr2 = _f32(thr * thr)
        w_rows = torch.where(m_b[..., None], rows, 0.0)
        e_fit = _smallest_eigvec(w_rows.transpose(-1, -2) @ w_rows)
        E_f, Uf, Vtf = _project_essential(e_fit.reshape(*e_fit.shape[:-1], 3, 3))
        Ra_f, Rb_f, tu_f = _decompose_uv(Uf, Vtf)
        inl_f = (_sampson_sq(E_f, hb1, hb2) < thr2) & vb
        n_f, R_f, t_f, m_f = _score_candidates(Ra_f, Rb_f, tu_f, inl_f, hb1, hb2)
        n_b, m_b2 = gate_at(R_b, t_b, E_b, thr2)
        take = n_f >= n_b
        E_b = torch.where(take[..., None, None], E_f, E_b)
        R_b = torch.where(take[..., None, None], R_f, R_b)
        t_b = torch.where(take[..., None], t_f, t_b)
        m_b = torch.where(take[..., None], m_f, m_b2)
    tn2 = _f32(thresh_norm * thresh_norm)
    n_j, m_j = gate_at(R_b, t_b, E_b, tn2)
    j = torch.argmax(n_j, dim=1, keepdim=True)           # first max, [P,1]
    E, R, t, mask, n_best = (_rows_at(x, j)[:, 0]
                             for x in (E_b, R_b, t_b, m_j, n_j))

    # GN polish on the manifold, kept if the gated consensus holds
    Rr, tr = _refine_essential_pose(R, t, h1, h2, mask.to(h1.dtype), polish_iters)
    E_ref = so3_hat(tr) @ Rr
    z1r, z2r = _two_ray_depths(Rr, tr, h1, h2)
    n_ref = ((_sampson_sq(E_ref, h1, h2) < tn2) & valid
             & (z1r > 0) & (z2r > 0)).sum(-1)
    better = n_ref >= n_best
    R = torch.where(better[:, None, None], Rr, R)
    t = torch.where(better[:, None], tr, t)
    E = torch.where(better[:, None, None], E_ref, E)
    # cv::recoverPose's 50-unit distance gate on the chosen model
    z1f, z2f = _two_ray_depths(R, t, h1, h2)
    dist_mask = ((_sampson_sq(E, h1, h2) < tn2) & valid & (z1f > 0) & (z2f > 0)
                 & (z1f < 50.0) & (z2f < 50.0))
    n_inliers = dist_mask.sum(-1).to(torch.int32)
    ok = ((n_inliers > 0) & torch.isfinite(R).all(-1).all(-1)
          & torch.isfinite(t).all(-1))
    res = EssentialResult(R, t, E, dist_mask, n_inliers, ok)
    span("ransac")
    return EssentialResult(*(x[0] for x in res)) if single else res


def nanmedian(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """``jnp.nanmedian`` along ``dim``: the mean of the two middle values
    for an even count (``torch.nanmedian`` returns the lower one); NaN where
    every entry is NaN."""
    a = torch.sort(x, dim=dim).values                # NaN sorts last
    cnt = (~torch.isnan(a)).sum(dim, keepdim=True).to(x.dtype)
    q = 0.5 * (cnt - 1.0)
    low, high = torch.floor(q), torch.ceil(q)
    hw = q - low
    lw = 1.0 - hw
    lo_i = torch.clamp(torch.minimum(low, cnt - 1.0), min=0.0).long()
    hi_i = torch.clamp(torch.minimum(high, cnt - 1.0), min=0.0).long()
    return (a.gather(dim, lo_i) * lw + a.gather(dim, hi_i) * hw).squeeze(dim)


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
