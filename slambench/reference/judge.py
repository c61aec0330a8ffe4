"""The plain reference: the truths of the benchmark's synthetic scene,
worked out again in NumPy from the scene's description (its planes and the
camera's poses), and the numbers that compare a run's outputs with them.

It imports nothing of the program and takes nothing the program made but
the outputs it judges: the poses of every frame and the final map
(keyframe poses, feature pixels and depths, landmark positions and links).

- ``trajectory``: the camera positions of all frames against the ground
  truth after a rigid (RGB-D) or similarity (monocular) alignment.
- ``map_numbers``: each kept feature's stored depth against the true depth
  at its pixel (the ORB pixel and its depth association), and each
  observation of a live landmark against the true depth along its ray in
  the observing keyframe (the landmark's geometry after bundle
  adjustment).
"""

from __future__ import annotations

import numpy as np

from ..data.scene import NEAR
from ..yardstick import umeyama


def quat_to_R(q: np.ndarray) -> np.ndarray:
    """[...,4] unit quaternions (w, x, y, z) -> [...,3,3]."""
    q = q / np.linalg.norm(q, axis=-1, keepdims=True)
    w, x, y, z = np.moveaxis(q, -1, 0)
    return np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        np.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        np.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
    ], -2)


def true_depth(planes, cap, R_wc: np.ndarray, t_wc: np.ndarray,
               u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Depth (camera z, metres) of the scene along the ray through pixel
    (u, v) of the camera ``cap`` (a ``scene.Capture``) at (R_wc [n,3,3],
    t_wc [n,3]); NaN where no plane is hit. float64, one ray per row."""
    d_cam = np.stack([(u - cap.cx) / cap.fx, (v - cap.cy) / cap.fy,
                      np.ones_like(u, dtype=np.float64)], -1)
    d = np.einsum("nij,nj->ni", R_wc, d_cam)
    best = np.full(len(u), np.inf)
    for pl in planes:
        with np.errstate(divide="ignore", invalid="ignore"):
            th = ((pl.point - t_wc) @ pl.normal) / (d @ pl.normal)
        ok = np.isfinite(th) & (th > NEAR) & (th < best)
        best = np.where(ok, th, best)
    return np.where(np.isfinite(best), best, np.nan)


def trajectory(pose_cw: np.ndarray, gt_t: np.ndarray, mono: bool) -> dict:
    """Every frame's returned pose ([T,4,4] T_cw) against the true camera
    positions ``gt_t`` [T,3], a lost frame's pose included: the RMSE
    (``ate_mm``, TUM's absolute trajectory error) and the worst frame
    (``err_max_mm``) after one rigid (RGB-D) or similarity (mono) alignment
    of all frames. Returns the alignment (s, R, t) too."""
    R = pose_cw[:, :3, :3]
    pos = -np.einsum("nji,nj->ni", R, pose_cw[:, :3, 3])     # -R^T t
    Ra, ta, s = umeyama(pos, gt_t, with_scale=mono)
    err = np.linalg.norm((s * pos @ Ra.T + ta) - gt_t, axis=1)
    return dict(ate_mm=1e3 * float(np.sqrt((err**2).mean())),
                err_max_mm=1e3 * float(err.max()), align=(s, Ra, ta))


def _pct(x: np.ndarray, q: float) -> float:
    """The q-th percentile of the finite values; inf where there are none
    (an empty map fails every limit)."""
    x = x[np.isfinite(x)]
    return float(np.percentile(x, q)) if len(x) else float("inf")


def map_numbers(m: dict, planes, cap, frame_ids: np.ndarray, scale: float,
                with_depth: bool) -> dict:
    """The final map ``m`` (numpy arrays named as the program's map:
    kf_q [K,4] wxyz, kf_t, kf_id, kf_px [K,2,N], kf_fvalid, kf_feat_lm,
    kf_depth, lm_pos [3,L], lm_alive) against the scene: medians over
    every kept feature and every observation of a live landmark, in mm.
    ``cap``: the ``scene.Capture``; ``frame_ids``: the loop frame of each
    frame id; ``scale``: metres per map unit (1 with depth)."""
    used = m["kf_id"] >= 0
    kid = m["kf_id"][used].astype(np.int64)
    Rk = quat_to_R(m["kf_q"][used].astype(np.float64))
    tk = m["kf_t"][used].astype(np.float64)
    px = np.transpose(m["kf_px"][used], (0, 2, 1)).astype(np.float64)  # [K,N,2]
    fvalid = m["kf_fvalid"][used]
    K, N = fvalid.shape
    gR, gt = cap.trajectory(frame_ids[kid])
    u, v = np.round(px[..., 0]), np.round(px[..., 1])
    inside = (u >= 0) & (u < cap.width) & (v >= 0) & (v < cap.height)
    kk = np.broadcast_to(np.arange(K)[:, None], (K, N))

    def depth_at(sel):
        return true_depth(planes, cap, gR[kk[sel]], gt[kk[sel]], u[sel], v[sel])

    out = {}
    if with_depth:
        sel = fvalid & inside & (m["kf_depth"][used] > 0)
        err = np.abs(m["kf_depth"][used][sel] - depth_at(sel))
        out["feat_depth_mm"] = 1e3 * _pct(err, 50)
    lm = m["kf_feat_lm"][used].astype(np.int64)
    obs = fvalid & inside & (lm >= 0)
    obs[obs] = m["lm_alive"][lm[obs]]
    X = m["lm_pos"][:, lm[obs]].T.astype(np.float64)                # [M,3]
    z = (np.einsum("mij,mj->mi", Rk[kk[obs]], X) + tk[kk[obs]])[:, 2]
    out["obs_depth_mm"] = 1e3 * _pct(np.abs(scale * z - depth_at(obs)), 50)
    out["observations"] = int(obs.sum())
    return out
