"""Trajectory evaluation (numpy only): the ``tcw_to_twc``,
``umeyama_alignment`` and ``ate_rmse`` of
``visionx_slam_tpu/eval/trajectory.py``."""

from __future__ import annotations

import numpy as np


def tcw_to_twc(T_cw: np.ndarray) -> np.ndarray:
    R = T_cw[:3, :3]
    t = T_cw[:3, 3]
    out = np.eye(4)
    out[:3, :3] = R.T
    out[:3, 3] = -R.T @ t
    return out


def umeyama_alignment(src: np.ndarray, dst: np.ndarray,
                      with_scale: bool = False):
    """Least-squares rigid (or, ``with_scale``, similarity) alignment
    src -> dst: (R, t, s)."""
    mu_s = src.mean(axis=0)
    mu_d = dst.mean(axis=0)
    xs = src - mu_s
    xd = dst - mu_d
    cov = xd.T @ xs / len(src)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    s = float(np.trace(np.diag(D) @ S) / ((xs**2).sum() / len(src))) \
        if with_scale else 1.0
    return R, mu_d - s * R @ mu_s, s


def ate_rmse(est_t: np.ndarray, gt_t: np.ndarray,
             with_scale: bool = False) -> float:
    """Absolute trajectory error RMSE after Horn alignment ([N,3] each);
    ``with_scale`` for monocular runs, whose scale is arbitrary."""
    R, t, s = umeyama_alignment(est_t, gt_t, with_scale)
    aligned = (s * (R @ est_t.T)).T + t
    err = aligned - gt_t
    return float(np.sqrt((err**2).sum(axis=-1).mean()))


def ate_of_run(pose_cw: np.ndarray, tracked: np.ndarray, gt_t: np.ndarray,
               with_scale: bool = False):
    """(ATE RMSE [m] over the tracked frames, n_tracked) of a run
    (``OfflineOut.pose`` [T,4,4] T_cw as numpy); ATE is None under 3
    tracked frames."""
    tracked = np.asarray(tracked, bool)
    if tracked.sum() < 3:
        return None, int(tracked.sum())
    est = np.asarray([tcw_to_twc(pose_cw[i])[:3, 3]
                      for i in np.flatnonzero(tracked)])
    return ate_rmse(est, gt_t[tracked], with_scale), int(tracked.sum())
