"""Point-cloud / trajectory export sinks — the file-based replacement for
the reference's Pangolin viewer (core/viewer/viewer.cpp:167-235: landmark
point cloud, keyframe trajectory polyline, camera frusta), per SURVEY.md
L8: "trajectory/point-cloud dumps + optional offline plotter".

- ``write_ply`` / ``export_map_ply``: the landmark cloud (and keyframe
  positions, colored) as an ASCII PLY any viewer opens (MeshLab, CloudCompare,
  Open3D) — the offline analog of viewer.cpp:167-206.
- ``plot_trajectory``: optional matplotlib top-down + 3D figure of the
  estimated trajectory vs ground truth (viewer.cpp:186-206's polyline).

No GL, no threads: everything renders from the run's file outputs
(trajectory.txt, map_snapshot.npz), so it also works post-hoc on archived
runs. A copy of ``visionx_slam_tpu/eval/export.py`` (numpy only).
"""

from __future__ import annotations

import numpy as np

from ..utils.rotation import quat_xyzw_to_matrix


def write_ply(path: str, points: np.ndarray, colors: np.ndarray | None = None):
    """ASCII PLY point cloud. ``points`` [N,3] float; ``colors`` [N,3] uint8."""
    points = np.asarray(points, np.float32).reshape(-1, 3)
    n = len(points)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {n}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if colors is not None:
            colors = np.asarray(colors, np.uint8).reshape(-1, 3)
            f.write("property uchar red\nproperty uchar green\n"
                    "property uchar blue\n")
        f.write("end_header\n")
        if colors is None:
            for p in points:
                f.write(f"{p[0]:.6f} {p[1]:.6f} {p[2]:.6f}\n")
        else:
            for p, c in zip(points, colors):
                f.write(f"{p[0]:.6f} {p[1]:.6f} {p[2]:.6f} "
                        f"{c[0]} {c[1]} {c[2]}\n")


def export_map_ply(path: str, lm_pos, lm_alive, kf_t_wc=None,
                   max_points: int = 200_000):
    """Write the alive-landmark cloud (white) + keyframe centers (red).

    ``lm_pos`` is the MapState's coordinate-major [3, Lp] table (or a
    snapshot's copy); ``kf_t_wc`` optional [K,3] camera centers in world
    frame. Downsamples uniformly above ``max_points`` (the reference
    viewer draws every 5th landmark, viewer.cpp:170).
    """
    lm_pos = np.asarray(lm_pos)
    alive = np.asarray(lm_alive).astype(bool)
    pts = lm_pos[:, alive].T if lm_pos.shape[0] == 3 else lm_pos[alive]
    pts = pts[np.all(np.isfinite(pts), axis=1)]
    if len(pts) > max_points:
        pts = pts[:: int(np.ceil(len(pts) / max_points))]
    cols = np.full((len(pts), 3), 200, np.uint8)
    if kf_t_wc is not None and len(kf_t_wc):
        kf = np.asarray(kf_t_wc, np.float32).reshape(-1, 3)
        pts = np.concatenate([pts, kf])
        cols = np.concatenate(
            [cols, np.tile(np.array([[255, 0, 0]], np.uint8), (len(kf), 1))]
        )
    write_ply(path, pts, cols)
    return len(pts)


def _quat_to_R(q: np.ndarray) -> np.ndarray:
    """[w,x,y,z] (any non-zero norm) -> rotation matrix (the snapshot's
    keyframe quaternions are wxyz)."""
    return quat_xyzw_to_matrix(np.roll(np.asarray(q, np.float64), -1))


def export_snapshot_ply(snapshot_npz: str, path: str):
    """PLY export straight from a ``map_snapshot.npz`` (post-hoc)."""
    z = np.load(snapshot_npz)
    kf_t_wc = None
    if "kf_q" in z and "kf_t" in z:
        alive_kf = z["kf_id"] >= 0 if "kf_id" in z else None
        qs, ts = z["kf_q"], z["kf_t"]
        centers = []
        for i in range(len(qs)):
            if alive_kf is not None and not alive_kf[i]:
                continue
            # camera center in world frame from T_cw: c = -R^T t
            centers.append(-_quat_to_R(qs[i]).T @ ts[i])
        kf_t_wc = np.asarray(centers) if centers else None
    return export_map_ply(path, z["lm_pos"], z["lm_alive"], kf_t_wc)


def read_tum_trajectory(path: str) -> tuple[np.ndarray, np.ndarray]:
    """Read a TUM-format trajectory file -> (timestamps [N], t_wc [N,3])."""
    ts, xyz = [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            v = line.split()
            ts.append(float(v[0]))
            xyz.append([float(v[1]), float(v[2]), float(v[3])])
    return np.asarray(ts), np.asarray(xyz)


def plot_trajectory(traj_path: str, out_png: str, gt_path: str | None = None,
                    cloud_npz: str | None = None):
    """Offline plotter: top-down (x,z) + height profile; overlays ground
    truth and the landmark cloud when given. Requires matplotlib; raises
    ImportError where unavailable (optional per SURVEY.md L8)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    _, est = read_tum_trajectory(traj_path)
    fig, axes = plt.subplots(1, 2, figsize=(11, 5))
    ax = axes[0]
    if cloud_npz:
        z = np.load(cloud_npz)
        lm = np.asarray(z["lm_pos"])
        alive = np.asarray(z["lm_alive"]).astype(bool)
        pts = lm[:, alive].T if lm.shape[0] == 3 else lm[alive]
        pts = pts[np.all(np.isfinite(pts), axis=1)][:50000]
        if len(pts):
            ax.scatter(pts[:, 0], pts[:, 2], s=0.2, c="0.8", label="landmarks")
    ax.plot(est[:, 0], est[:, 2], "b-", lw=1.2, label="estimate")
    if gt_path:
        _, gt = read_tum_trajectory(gt_path)
        ax.plot(gt[:, 0], gt[:, 2], "g--", lw=1.0, label="ground truth")
    ax.set_xlabel("x [m]"); ax.set_ylabel("z [m]")
    ax.set_aspect("equal", adjustable="datalim")
    ax.legend(loc="best", fontsize=8)
    ax.set_title("top-down")

    ax = axes[1]
    ax.plot(est[:, 1], "b-", lw=1.0, label="estimate y")
    if gt_path:
        ax.plot(gt[:, 1], "g--", lw=1.0, label="gt y")
    ax.set_xlabel("frame"); ax.set_ylabel("y [m]")
    ax.legend(loc="best", fontsize=8)
    ax.set_title("height profile")
    fig.tight_layout()
    fig.savefig(out_png, dpi=110)
    plt.close(fig)
    return out_png
