"""Trajectory evaluation (numpy only): the ``tcw_to_twc`` and ``ate_rmse``
of ``visionx_slam_tpu/eval/trajectory.py``."""

from __future__ import annotations

import numpy as np


def tcw_to_twc(T_cw: np.ndarray) -> np.ndarray:
    R = T_cw[:3, :3]
    t = T_cw[:3, 3]
    out = np.eye(4)
    out[:3, :3] = R.T
    out[:3, 3] = -R.T @ t
    return out


def umeyama_alignment(src: np.ndarray, dst: np.ndarray):
    """Least-squares rigid alignment src -> dst: (R, t)."""
    mu_s = src.mean(axis=0)
    mu_d = dst.mean(axis=0)
    xs = src - mu_s
    xd = dst - mu_d
    cov = xd.T @ xs / len(src)
    U, _, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    return R, mu_d - R @ mu_s


def ate_rmse(est_t: np.ndarray, gt_t: np.ndarray) -> float:
    """Absolute trajectory error RMSE after rigid Horn alignment ([N,3]
    each)."""
    R, t = umeyama_alignment(est_t, gt_t)
    aligned = (R @ est_t.T).T + t
    err = aligned - gt_t
    return float(np.sqrt((err**2).sum(axis=-1).mean()))


def ate_of_run(pose_cw: np.ndarray, tracked: np.ndarray, gt_t: np.ndarray):
    """(ATE RMSE [m] over the tracked frames, n_tracked) of an offline run
    (``OfflineOut.pose`` [T,4,4] T_cw as numpy); ATE is None under 3
    tracked frames."""
    tracked = np.asarray(tracked, bool)
    if tracked.sum() < 3:
        return None, int(tracked.sum())
    est = np.asarray([tcw_to_twc(pose_cw[i])[:3, 3]
                      for i in np.flatnonzero(tracked)])
    return ate_rmse(est, gt_t[tracked]), int(tracked.sum())
