"""TUM-format trajectory files and ATE/RPE evaluation (numpy only; the
functions of ``visionx_slam_tpu/eval/trajectory.py``, with the port's own
quaternion conversion in place of scipy's).

Trajectory lines are ``timestamp tx ty tz qx qy qz qw``, camera-to-world.
ATE follows the TUM benchmark: associate by timestamp, align with a rigid
(or similarity) Horn/Umeyama transform, report the translational RMSE. RPE
is the relative pose drift over a fixed frame delta."""

from __future__ import annotations

import numpy as np

from ..utils.rotation import matrix_to_quat_xyzw, quat_xyzw_to_matrix


def write_tum_trajectory(path: str, timestamps, T_wc_list) -> None:
    """Write camera-to-world poses (4x4 matrices) as TUM lines. Poses kept
    as T_cw go through :func:`tcw_to_twc` first."""
    with open(path, "w") as f:
        f.write("# estimated trajectory\n# timestamp tx ty tz qx qy qz qw\n")
        for ts, T in zip(timestamps, T_wc_list):
            t = T[:3, 3]
            q = matrix_to_quat_xyzw(T[:3, :3])
            f.write(
                f"{ts:.6f} {t[0]:.6f} {t[1]:.6f} {t[2]:.6f} "
                f"{q[0]:.6f} {q[1]:.6f} {q[2]:.6f} {q[3]:.6f}\n"
            )


def tcw_to_twc(T_cw: np.ndarray) -> np.ndarray:
    R = T_cw[:3, :3]
    t = T_cw[:3, 3]
    out = np.eye(4)
    out[:3, :3] = R.T
    out[:3, 3] = -R.T @ t
    return out


def read_tum_trajectory(path: str) -> tuple[np.ndarray, np.ndarray]:
    """Returns (timestamps [N], T_wc [N,4,4])."""
    ts, mats = [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            v = [float(x) for x in line.split()[:8]]
            T = np.eye(4)
            T[:3, :3] = quat_xyzw_to_matrix(v[4:8])
            T[:3, 3] = v[1:4]
            ts.append(v[0])
            mats.append(T)
    return np.array(ts), np.array(mats)


def associate_trajectories(
    ts_a: np.ndarray, ts_b: np.ndarray, max_diff: float = 0.02
) -> list[tuple[int, int]]:
    """Nearest-timestamp pairing (same join rule as the dataset loader)."""
    pairs = []
    order = np.argsort(ts_b)
    ts_b_sorted = ts_b[order]
    for i, t in enumerate(ts_a):
        j = int(np.searchsorted(ts_b_sorted, t))
        cands = [k for k in (j - 1, j) if 0 <= k < len(ts_b_sorted)]
        if not cands:
            continue
        k = min(cands, key=lambda k: abs(ts_b_sorted[k] - t))
        if abs(ts_b_sorted[k] - t) <= max_diff:
            pairs.append((i, int(order[k])))
    return pairs


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


def rpe_rmse(T_est: np.ndarray, T_gt: np.ndarray, delta: int = 1) -> tuple[float, float]:
    """Relative pose error over frame delta: (trans RMSE [m], rot RMSE [rad])."""
    n = len(T_est) - delta
    if n <= 0:
        return 0.0, 0.0
    terrs, rerrs = [], []
    for i in range(n):
        d_est = np.linalg.inv(T_est[i]) @ T_est[i + delta]
        d_gt = np.linalg.inv(T_gt[i]) @ T_gt[i + delta]
        e = np.linalg.inv(d_gt) @ d_est
        terrs.append(np.linalg.norm(e[:3, 3]))
        rerrs.append(np.arccos(np.clip((np.trace(e[:3, :3]) - 1) / 2, -1, 1)))
    return float(np.sqrt(np.mean(np.square(terrs)))), float(
        np.sqrt(np.mean(np.square(rerrs)))
    )


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
