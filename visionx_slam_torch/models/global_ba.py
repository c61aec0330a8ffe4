"""Global bundle adjustment: matrix-free Schur-complement Gauss-Newton with
fixed-count PCG (counterpart of ``visionx_slam_tpu/models/global_ba.py``).

- Hll is block-diagonal [L,3,3] and Hpp [K,6,6]; the landmark sums are
  segment sums over the observations sorted by landmark once per solve
  (``ops.index.segment_sum``, as the JAX package's sorted segment sums);
  the observations of non-optimized landmarks belong to no segment.
- S v = (Hpp + lambda) v - W Hll^-1 W^T v is applied as an operator inside
  PCG with a block-Jacobi (Hpp + lambda)^-1 preconditioner; the oldest
  alive keyframe is the gauge and stays fixed.
- ``gauge_group`` labels the keyframe slots of a map merged from several
  independent lane maps: each group freezes its own oldest keyframe, and
  every scalar of the solve (CG step sizes, the finite check, cost and
  convergence) is kept per group by a segment sum over the labels, so one
  merged solve equals the per-lane solves.

Every float sum adds in a fixed order, so a solve on CUDA gives the same
bits in every run.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.camera import CameraParams
from ..ops.index import segment_sum, segments
from ..ops.linalg import inv3x3
from ..ops.se3 import Pose, quat_to_matrix, se3_compose, se3_exp, so3_hat
from ..utils.logging import count_sync
from ..tracking import mapstate as msl
from ..tracking.mapstate import MapState
from .local_ba import _huber_w, _proj_jacobian


class GlobalBAOptions(NamedTuple):
    max_iterations: int = 10
    huber_delta: float = 5.0
    max_reproj_error: float = 5.0
    min_point_observations: int = 2
    damping: float = 1e-6
    cg_iterations: int = 25


class GlobalBAStats(NamedTuple):
    iterations: torch.Tensor
    final_cost: torch.Tensor
    total_obs: torch.Tensor


def map_reproj_error(ms: MapState, cam: CameraParams):
    """(mean reprojection error [px], n_observations) over every live
    keyframe-feature -> landmark link of the map."""
    L = ms.lm_physical
    has = msl.kf_alive(ms)[:, None] & ms.kf_fvalid & (ms.kf_feat_lm >= 0)
    lm_idx = ms.kf_feat_lm.clamp(0, L - 1).long()
    pw = ms.lm_pos[:, lm_idx].permute(1, 2, 0)                  # [K,N,3]
    R = quat_to_matrix(ms.kf_q)
    pc = torch.einsum("kij,knj->kni", R, pw) + ms.kf_t[:, None, :]
    z_ok = pc[..., 2] > 1e-6
    zs = torch.clamp(pc[..., 2], min=1e-6)
    u = cam.fx * pc[..., 0] / zs + cam.cx
    v = cam.fy * pc[..., 1] / zs + cam.cy
    err = torch.linalg.norm(ms.kf_px.transpose(1, 2) - torch.stack([u, v], -1), dim=-1)
    obs = has & ms.lm_alive[lm_idx] & z_ok
    n = obs.sum()
    mean = torch.where(obs, err, 0.0).sum() / torch.clamp(n, min=1)
    return mean, n.to(torch.int32)


def global_ba(ms: MapState, cam: CameraParams,
              opts: GlobalBAOptions = GlobalBAOptions(),
              gauge_group: torch.Tensor | None = None):
    """Refine keyframe poses and landmarks of ``ms``; returns
    (MapState, GlobalBAStats). ``final_cost`` is the cost at the start of
    the last GN iteration, as in the JAX package (summed over groups).
    ``gauge_group``: optional [K] int lane label per keyframe slot of a
    merged multi-lane map (module docstring); None is one group."""
    K = ms.kf_capacity
    L = ms.lm_physical
    N = ms.n_features
    O = K * N
    dev = ms.kf_q.device
    dt = ms.kf_q.dtype

    alive_kf = msl.kf_alive(ms)
    f_valid = ms.kf_fvalid & alive_kf[:, None]
    has_lm = f_valid & (ms.kf_feat_lm >= 0)
    lm_idx = ms.kf_feat_lm.clamp(0, L - 1).long()
    # landmarks below the observation threshold stay constant: their
    # residuals still constrain poses, but they leave the Schur reduction
    lm_opt = ms.lm_alive & (msl.landmark_observation_counts(ms)
                            >= opts.min_point_observations)

    # gauge: freeze the oldest alive keyframe (of each group; ties to the
    # lowest slot)
    big = torch.iinfo(torch.int32).max
    ids = torch.where(alive_kf, ms.kf_id, big)
    slots = torch.arange(K, device=dev)
    single = gauge_group is None
    if single:
        fixed_mask = slots == torch.argmin(ids)
    else:
        grp = gauge_group.to(device=dev, dtype=torch.long)
        group_min = torch.full((K,), big, dtype=ids.dtype, device=dev)
        group_min.scatter_reduce_(0, grp, ids, "amin")
        is_min = alive_kf & (ids == group_min[grp])
        first = torch.full((K,), K, dtype=torch.long, device=dev)
        first.scatter_reduce_(0, grp, torch.where(is_min, slots, K), "amin")
        fixed_mask = is_min & (slots == first[grp])
    free_kf = alive_kf & ~fixed_mask
    free6 = free_kf[:, None]

    if not single:
        groups = segments(grp, K)

    def seg_k(x_k):   # per-keyframe [K] -> per group (a scalar when single)
        if single:
            return x_k.sum()
        return segment_sum(x_k, groups)

    def to_k(v_g):    # per group -> per keyframe
        return v_g if single else v_g[grp]

    def seg_rows(x):  # [K, ...] summed per group
        return x.sum() if single else seg_k(x.reshape(K, -1).sum(1))

    def gdot(a, b):   # per-group dot product of [K,6] vectors, per keyframe
        return (a * b).sum() if single else to_k(seg_rows(a * b))[:, None]

    kk = torch.arange(K, device=dev)[:, None].expand(K, N).reshape(-1)
    opt_obs_mask = (has_lm & lm_opt[lm_idx]).reshape(-1)
    seg = torch.where(opt_obs_mask, lm_idx.reshape(-1), L)      # spare row L
    lm_segs = segments(seg, L)

    has_any_obs = seg_k((has_lm & ms.lm_alive[lm_idx]).sum(1)) > 0
    enabled = (seg_k(alive_kf.long()) >= 2) & has_any_obs
    if single:
        apply_lm = lambda a: a
    else:
        # a landmark's group: that of its (same-lane) observations
        lm_grp = torch.zeros(L + 1, dtype=torch.long, device=dev)
        lm_grp.scatter_reduce_(0, seg, grp[kk], "amax")
        apply_lm = lambda a: a[lm_grp[:L]][None, :]

    def seg_sum_lm(per_obs):  # [O,d] -> [L,d]
        return segment_sum(per_obs, lm_segs)

    px_obs = ms.kf_px.transpose(1, 2)                           # [K,N,2]

    def residuals(q, t, lm_pos):
        pw = lm_pos[:, lm_idx].permute(1, 2, 0)
        R = quat_to_matrix(q)
        pc = torch.einsum("kij,knj->kni", R, pw) + t[:, None, :]
        z_ok = pc[..., 2] > 1e-6
        zs = torch.clamp(pc[..., 2], min=1e-6)
        u = cam.fx * pc[..., 0] / zs + cam.cx
        v = cam.fy * pc[..., 1] / zs + cam.cy
        err = px_obs - torch.stack([u, v], -1)
        err_n = torch.linalg.norm(err, dim=-1)
        obs = (has_lm & ms.lm_alive[lm_idx] & z_ok
               & (err_n <= opts.max_reproj_error))
        w = torch.where(obs, _huber_w(err_n, opts.huber_delta), 0.0)
        return err, pc, obs, w

    lam = opts.damping
    eye3 = torch.eye(3, dtype=dt, device=dev)
    eye6 = torch.eye(6, dtype=dt, device=dev)
    q, t, lm_pos = ms.kf_q, ms.kf_t, ms.lm_pos
    last_cost = torch.full(enabled.shape, torch.finfo(torch.float32).max,
                           dtype=dt, device=dev)
    done = ~enabled
    iters = torch.zeros(enabled.shape, dtype=torch.int32, device=dev)
    cost = total_obs = None
    for _ in range(opts.max_iterations):
        err, pc, obs, w = residuals(q, t, lm_pos)
        # gated out: 0 x a non-finite error stays 0
        cost = seg_rows(torch.where(obs, w * (err * err).sum(-1), 0.0))
        total_obs = seg_rows(obs.to(torch.int32)).to(torch.int32)

        # per-observation Jacobians
        Jp_proj = _proj_jacobian(cam, pc)                        # [K,N,2,3]
        Jse = torch.cat([eye3.expand(K, N, 3, 3), -so3_hat(pc)], -1)
        Jpose = Jp_proj @ Jse                                    # [K,N,2,6]
        R = quat_to_matrix(q)
        Jpt = torch.einsum("knij,kjl->knil", Jp_proj, R)         # [K,N,2,3]

        # block-diagonal pose system (k-major reductions)
        Jw = Jpose * w[..., None, None]
        Hpp = torch.einsum("knij,knil->kjl", Jw, Jpose)          # [K,6,6]
        bp = torch.einsum("knij,kni->kj", Jw, err)               # [K,6]

        # landmark system + coupling (optimizable landmarks only)
        w_opt = torch.where(obs & lm_opt[lm_idx], w, 0.0)
        Jpt_w = Jpt * w_opt[..., None, None]
        Hll_c = torch.einsum("knij,knil->knjl", Jpt_w, Jpt)      # [K,N,3,3]
        bl_c = torch.einsum("knij,kni->knj", Jpt_w, err)         # [K,N,3]
        table = seg_sum_lm(torch.cat([Hll_c.reshape(O, 9),
                                      bl_c.reshape(O, 3)], -1))  # [L,12]
        Hll = table[:, :9].reshape(L, 3, 3) + lam * eye3
        bl = table[:, 9:]
        Hll_inv = inv3x3(Hll)
        Hll_inv_bl = (Hll_inv @ bl[..., None])[..., 0]
        Wobs = torch.einsum("knij,knil->knjl", Jpose * w_opt[..., None, None],
                            Jpt).reshape(O, 6, 3)

        def WT_v(v6):  # [K,6] -> [L,3]
            return seg_sum_lm(torch.einsum("oij,oi->oj", Wobs, v6[kk]))

        def W_u(u3):   # [L,3] -> [K,6]
            u_pad = torch.cat([u3, u3.new_zeros(1, 3)])
            per_obs = torch.einsum("oij,oj->oi", Wobs, u_pad[seg])
            return per_obs.reshape(K, N, 6).sum(1)

        def S_mv(v6):  # gauge rows pinned to identity
            v6 = torch.where(free6, v6, 0.0)
            hv = torch.einsum("kij,kj->ki", Hpp, v6) + lam * v6
            sv = hv - W_u((Hll_inv @ WT_v(v6)[..., None])[..., 0])
            return torch.where(free6, sv, v6)

        rhs = torch.where(free6, bp - W_u(Hll_inv_bl), 0.0)
        Hpp_safe = torch.where(free_kf[:, None, None], Hpp + lam * eye6, eye6)
        Pinv = torch.linalg.inv(Hpp_safe)
        count_sync()            # inv reads its status on the host

        def prec(r):
            return torch.where(free6, torch.einsum("kij,kj->ki", Pinv, r), 0.0)

        # fixed-iteration PCG; converged state freezes through the masks
        x = torch.zeros_like(rhs)
        r = rhs
        z = prec(r)
        p = z
        rz = gdot(r, z)
        for _ in range(opts.cg_iterations):
            Ap = S_mv(p)
            pAp = gdot(p, Ap)
            ok = (pAp > 1e-30) & (rz > 1e-30)
            alpha = torch.where(ok, rz / torch.clamp(pAp, min=1e-30), 0.0)
            x = x + alpha * p
            r = r - alpha * Ap
            z = prec(r)
            rz_new = gdot(r, z)
            beta = torch.where(ok, rz_new / torch.clamp(rz, min=1e-30), 0.0)
            p = z + beta * p
            rz = rz_new
        if single:
            dxp = torch.where(torch.isfinite(x).all(), x, 0.0)
        else:
            bad = seg_rows((~torch.isfinite(x)).to(torch.int32)) > 0
            dxp = torch.where(to_k(bad)[:, None], 0.0, x)

        # back-substitute landmarks: dxl = Hll^-1 (bl - W^T dxp)
        dxl = (Hll_inv @ (bl - WT_v(dxp))[..., None])[..., 0]
        dxl = torch.where(lm_opt[:, None] & torch.isfinite(dxl).all(-1, keepdim=True),
                          dxl, 0.0)

        apply = ~done & enabled
        dxp = torch.where((free_kf & to_k(apply))[:, None], dxp, 0.0)
        newp = se3_compose(se3_exp(dxp), Pose(q, t))
        lm_pos = torch.where(apply_lm(apply), lm_pos + dxl.T, lm_pos)
        q, t = newp.q, newp.t

        converged = (total_obs == 0) | ((last_cost - cost).abs() < 1e-6 * last_cost)
        iters = iters + torch.where(done | ~enabled, 0, 1).to(torch.int32)
        done = done | converged
        last_cost = cost

    out = ms._replace(kf_q=q, kf_t=t, lm_pos=lm_pos)
    return out, GlobalBAStats(iterations=iters.max(), final_cost=cost.sum(),
                              total_obs=total_obs.sum())
