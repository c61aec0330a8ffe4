"""Structured global BA for offline-built maps: the pairwise Schur solve
(counterpart of ``visionx_slam_tpu/models/pair_ba.py``).

``build_keyframe_map`` and its link pass give every landmark at most two
observations: the feature that created it (keyframe k, slot n) and at most
one adopting feature of keyframe k+1 (the link pass reads the pre-adoption
table, so adoption never chains). The observation graph is a partial
matching between consecutive keyframes, so every landmark-axis reduction of
the general solver (``global_ba``: an ``index_add_`` into the landmark
table per matvec) becomes ONE gather along the feature axis of the
neighbouring keyframe (``_push_to_creator`` / ``_pull_from_creator``): no
sort, no scatter, no atomics, and therefore the same bits in every run.

Same semantics as ``global_ba`` (residuals, Huber weights, reprojection
gate, Schur-complement Gauss-Newton with block-Jacobi PCG, the oldest
keyframe as the gauge, landmarks below two observations held constant but
still constraining poses). The JAX package unrolls the small tensor algebra
into component-major [K,N] tuples for its tiles; here the components are
stacked on leading axes ([3,K,N] points, [2,6,K,N] pose Jacobians, ...) and
the per-keyframe normal equations ``Hpp``, ``bp`` come from one batched
matmul over the feature axis. The two loops are fixed-length host loops
with masked updates: no host branch reads a device value.
"""

from __future__ import annotations

import torch

from ..ops.camera import CameraParams
from ..ops.se3 import Pose, quat_to_matrix, se3_compose, se3_exp
from ..tracking import mapstate as msl
from ..tracking.mapstate import MapState, PairLinks
from .global_ba import GlobalBAOptions, GlobalBAStats
from .local_ba import _huber_w

__all__ = ["PairLinks", "pair_ba"]

# upper-triangle components (a00,a01,a02,a11,a12,a22) of a symmetric 3x3
_SYM_I = (0, 0, 0, 1, 1, 2)
_SYM_J = (0, 1, 2, 1, 2, 2)
# component index of entry (i,j) of the full matrix
_SYM_FULL = ((0, 1, 2), (1, 3, 4), (2, 4, 5))


def _push_to_creator(x: torch.Tensor, adopter: torch.Tensor) -> torch.Tensor:
    """[...,K,N] observation values -> the adopter's contribution at each
    creation slot: out[..., k, n] = x[..., k+1, adopter[k,n]] (0 where no
    adopter; the last row is 0)."""
    has = adopter[:-1] >= 0
    nxt = x[..., 1:, :]
    g = torch.gather(nxt, -1, adopter[:-1].clamp(min=0).long().expand(nxt.shape))
    g = torch.where(has, g, 0.0)
    return torch.cat([g, torch.zeros_like(x[..., :1, :])], dim=-2)


def _pull_from_creator(u: torch.Tensor, creator: torch.Tensor) -> torch.Tensor:
    """[...,K,N] creation-slot values -> at the adopting observations:
    out[..., k, m] = u[..., k-1, creator[k,m]] (0 where not adopting; row 0
    is 0)."""
    has = creator[1:] >= 0
    prev = u[..., :-1, :]
    g = torch.gather(prev, -1, creator[1:].clamp(min=0).long().expand(prev.shape))
    g = torch.where(has, g, 0.0)
    return torch.cat([torch.zeros_like(u[..., :1, :]), g], dim=-2)


def _sym3_inv(m: torch.Tensor, damping: float) -> torch.Tensor:
    """Inverse of symmetric 3x3 matrices given by their components [6,...]
    (a00,a01,a02,a11,a12,a22), ``damping`` added to the diagonal: the
    adjugate over the determinant, 0 where the determinant vanishes.
    Returns the inverse's components [6,...]."""
    a00, a01, a02, a11, a12, a22 = m.unbind(0)
    a00 = a00 + damping
    a11 = a11 + damping
    a22 = a22 + damping
    c00 = a11 * a22 - a12 * a12
    c01 = a02 * a12 - a01 * a22
    c02 = a01 * a12 - a02 * a11
    c11 = a00 * a22 - a02 * a02
    c12 = a01 * a02 - a00 * a12
    c22 = a00 * a11 - a01 * a01
    det = a00 * c00 + a01 * c01 + a02 * c02
    inv_det = torch.where(det.abs() > 1e-30, 1.0 / det, 0.0)
    return torch.stack([c00, c01, c02, c11, c12, c22]) * inv_det


def _sym3_apply(mi: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Symmetric 3x3 matrices (components [6,...]) times vectors [3,...]."""
    full = mi[_SYM_FULL,]                                   # [3,3,...]
    return (full * v[None]).sum(1)


def pair_ba(ms: MapState, cam: CameraParams, links: PairLinks,
            opts: GlobalBAOptions = GlobalBAOptions()):
    """Schur-complement Gauss-Newton over an offline-built pairwise map;
    stands in for ``global_ba`` when ``links`` is at hand (same options and
    stats). Returns (MapState, GlobalBAStats); ``ms`` is not modified."""
    K = ms.kf_capacity
    N = ms.n_features
    Lp = ms.lm_physical
    dev = ms.kf_q.device
    dt = ms.kf_q.dtype

    created = links.created & ms.kf_fvalid
    # an adopter counts only when the adopting feature itself is valid
    nxt_valid = torch.cat([ms.kf_fvalid[1:], torch.zeros_like(ms.kf_fvalid[:1])])
    adopter_valid = (links.adopter >= 0) & torch.gather(
        nxt_valid, 1, links.adopter.clamp(min=0).long())
    is_adopt = (links.creator >= 0) & ms.kf_fvalid

    alive_kf = msl.kf_alive(ms)
    has_obs = (created | is_adopt) & alive_kf[:, None]
    # optimizable (>= 2 observations): a creation slot with an adopter, and
    # every adopting observation
    opt_created = created & adopter_valid
    opt_obs = (opt_created | is_adopt) & alive_kf[:, None]

    # gauge: the oldest alive keyframe stays fixed
    ids = torch.where(alive_kf, ms.kf_id, torch.iinfo(torch.int32).max)
    free_kf = alive_kf & (torch.arange(K, device=dev) != torch.argmin(ids))
    free6 = free_kf[:, None]
    enabled = (alive_kf.sum() >= 2) & created.any()

    # landmark positions at the creation slots [3,K,N] (world frame; the
    # other slots hold values that ``created`` masks)
    lm_slot = ms.kf_feat_lm.clamp(0, Lp - 1).long()
    pos = ms.lm_pos[:, lm_slot]
    obs_uv = ms.kf_px                                        # [K,2,N]
    lam = opts.damping
    eye6 = torch.eye(6, dtype=dt, device=dev)

    q, t = ms.kf_q, ms.kf_t
    last_cost = torch.full((), torch.finfo(torch.float32).max, dtype=dt, device=dev)
    done = ~enabled
    iters = torch.zeros((), dtype=torch.int32, device=dev)
    cost = last_cost
    total_obs = torch.zeros((), dtype=torch.int32, device=dev)
    for _ in range(opts.max_iterations):
        # world point of every observation: its own creation slot or its
        # creator's
        Xo = torch.where(created, pos, _pull_from_creator(pos, links.creator))
        Rt = quat_to_matrix(q).permute(1, 2, 0)[..., None]   # [3(i),3(j),K,1]
        pc = (Rt * Xo[None]).sum(1) + t.T[:, :, None]        # [3,K,N]
        z_ok = pc[2] > 1e-6
        iz = 1.0 / torch.clamp(pc[2], min=1e-6)
        e = obs_uv.transpose(0, 1) - torch.stack([
            cam.fx * pc[0] * iz + cam.cx, cam.fy * pc[1] * iz + cam.cy])  # [2,K,N]
        sq = (e * e).sum(0)
        en = torch.sqrt(sq)
        obs = has_obs & z_ok & (en <= opts.max_reproj_error)
        w = torch.where(obs, _huber_w(en, opts.huber_delta), 0.0)
        cost = torch.where(obs, w * sq, 0.0).sum()   # 0 x non-finite stays 0
        total_obs = obs.sum().to(torch.int32)

        # projection Jacobian rows (u, v) [2,3,K,N], the pose Jacobian
        # [2,6,K,N] (translation block, then pc x row) and the point
        # Jacobian J_proj R [2,3,K,N]
        fxiz, fyiz = cam.fx * iz, cam.fy * iz
        zero = torch.zeros_like(iz)
        Jp = torch.stack([torch.stack([fxiz, zero, -fxiz * pc[0] * iz]),
                          torch.stack([zero, fyiz, -fyiz * pc[1] * iz])])
        J6 = torch.cat([Jp, torch.linalg.cross(pc[None].expand_as(Jp), Jp, dim=1)], 1)
        P = (Jp[:, :, None] * Rt[None]).sum(1)               # [2,3(l),K,N]

        # pose normal equations: one batched Gram matrix over (row, feature)
        A = torch.cat([J6, e[:, None]], 1)                   # [2,7,K,N]
        M = A.permute(2, 0, 3, 1).reshape(K, 2 * N, 7)
        Mw = M * w[:, None, :, None].expand(K, 2, N, 1).reshape(K, 2 * N, 1)
        G = Mw.transpose(1, 2) @ M                           # [K,7,7]
        Hpp, bp = G[:, :6, :6], G[:, :6, 6]

        # landmark system at the creation slots (optimizable only)
        w_opt = torch.where(opt_obs, w, 0.0)
        C = w_opt * (P[:, _SYM_I,] * P[:, _SYM_J,]).sum(0)   # [6,K,N]
        Cb = w_opt * (P * e[:, None]).sum(0)                 # [3,K,N]
        packed = torch.cat([C, Cb])
        tot = (torch.where(opt_created, packed, 0.0)
               + _push_to_creator(packed, links.adopter))
        bl = tot[6:]
        Hinv = torch.where(opt_created, _sym3_inv(tot[:6], lam), 0.0)
        Hinv_full = Hinv[_SYM_FULL,]                         # [3,3,K,N]

        def hinv_apply(v3):
            return (Hinv_full * v3[None]).sum(1)

        Wb = w_opt * (J6[:, :, None] * P[:, None]).sum(0)    # [6,3,K,N]

        def WT_v(v6):   # [K,6] -> [3,K,N] at the creation slots
            tv = (Wb * v6.T[:, None, :, None]).sum(0)
            return (torch.where(opt_created, tv, 0.0)
                    + _push_to_creator(tv, links.adopter))

        def W_u(u3):    # [3,K,N] at the creation slots -> [K,6]
            at_obs = torch.where(created, u3, _pull_from_creator(u3, links.creator))
            return (Wb * at_obs[None]).sum((1, 3)).T

        def S_mv(v6):   # gauge rows pinned to identity
            v6 = torch.where(free6, v6, 0.0)
            hv = torch.einsum("kij,kj->ki", Hpp, v6) + lam * v6
            sv = hv - W_u(hinv_apply(WT_v(v6)))
            return torch.where(free6, sv, v6)

        rhs = torch.where(free6, bp - W_u(hinv_apply(bl)), 0.0)
        # block-Jacobi preconditioner; inv_ex does not read its status back
        Pinv = torch.linalg.inv_ex(
            torch.where(free_kf[:, None, None], Hpp + lam * eye6, eye6)).inverse

        def prec(r):
            return torch.where(free6, torch.einsum("kij,kj->ki", Pinv, r), 0.0)

        x = torch.zeros_like(rhs)
        r = rhs
        z = prec(r)
        p = z
        rz = (r * z).sum()
        for _ in range(opts.cg_iterations):
            Ap = S_mv(p)
            pAp = (p * Ap).sum()
            ok = (pAp > 1e-30) & (rz > 1e-30)
            alpha = torch.where(ok, rz / torch.clamp(pAp, min=1e-30), 0.0)
            x = x + alpha * p
            r = r - alpha * Ap
            z = prec(r)
            rz_new = (r * z).sum()
            beta = torch.where(ok, rz_new / torch.clamp(rz, min=1e-30), 0.0)
            p = z + beta * p
            rz = rz_new
        dxp = torch.where(torch.isfinite(x).all(), x, 0.0)

        # back-substitute the landmarks at their creation slots
        dxl = hinv_apply(bl - WT_v(dxp))
        dxl = torch.where(opt_created & torch.isfinite(dxl), dxl, 0.0)

        apply = ~done & enabled
        dxp = torch.where((free_kf & apply)[:, None], dxp, 0.0)
        newp = se3_compose(se3_exp(dxp), Pose(q, t))
        q, t = newp.q, newp.t
        pos = pos + torch.where(apply, 1.0, 0.0) * dxl

        converged = (total_obs == 0) | ((last_cost - cost).abs() < 1e-6 * last_cost)
        iters = iters + torch.where(done | ~enabled, 0, 1).to(torch.int32)
        done = done | converged
        last_cost = cost

    # positions back into the table through build_keyframe_map's sorted creation
    # index; the non-creating slots (sidx == Lp) land in a spare column
    lm_pos = torch.cat([ms.lm_pos, ms.lm_pos.new_zeros(3, 1)], 1)
    lm_pos[:, links.sidx.long()] = pos.reshape(3, K * N)[:, links.order.long()]
    out = ms._replace(kf_q=q, kf_t=t, lm_pos=lm_pos[:, :Lp].contiguous())
    return out, GlobalBAStats(iterations=iters, final_cost=cost,
                              total_obs=total_obs)
