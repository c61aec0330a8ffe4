"""Synthetic RGB-D sequences, in memory and on disk (numpy only; no cv2).

The scene, trajectory, renderer and writer are copies of
``visionx_slam_tpu/data/synthetic.py`` (``make_scene``, ``trajectory_pose``,
``render_frame``, ``generate_sequence``). ``generate_sequence`` writes the
TUM RGB-D layout (rgb.txt/depth.txt/groundtruth.txt, PNGs through
``data/png.py``, depth scale 5000) that the dataset loader reads;
``make_sequence`` returns the arrays that a load of such a sequence gives
(``bench.py::_load_sequence``): 8-bit gray, depth quantized to the TUM
16-bit scale (1/5000 m), and ground-truth positions at the 6 decimals of
``groundtruth.txt``.
"""

from __future__ import annotations

import functools
import os
from dataclasses import dataclass

import numpy as np

from ..utils.rotation import matrix_to_quat_xyzw
from . import png

W, H = 640, 480
FX, FY, CX, CY = 525.0, 525.0, 319.5, 239.5  # fr3-style, zero distortion

# fr1-style optics: the real TUM freiburg1 ROS-default calibration (the
# values data/tum.py DEFAULT_INTRINSICS carries), including k3: without the
# positive r^6 term the fr1 polynomial is non-invertible near the image
# corners (k2 = -0.95 makes the radial factor non-monotonic). The tracker
# models no distortion, as the reference's frontend does not
# (projection.h:10), so a run on these frames measures that blindness.
FR1 = dict(fx=517.3, fy=516.5, cx=318.6, cy=255.3,
           k1=0.2624, k2=-0.9531, p1=-0.0054, p2=0.0026, k3=1.1633)


@functools.lru_cache(maxsize=4)
def _ray_grid(fx, fy, cx, cy, k1=0.0, k2=0.0, p1=0.0, p2=0.0, k3=0.0):
    """Per-pixel normalized ray (x, y) such that distorting (x, y) with
    the 5-coefficient radial-tangential model lands exactly on that pixel:
    the inverse of the physical image formation, so a world point rendered
    at pixel (u, v) re-projects to (u, v) under the full model. Fixed-point
    undistortion iteration (cv2.undistortPoints' algorithm; 20 steps,
    converges over the full image for the fr1 calibration)."""
    u, v = np.meshgrid(np.arange(W, dtype=np.float64),
                       np.arange(H, dtype=np.float64))
    xd = (u - cx) / fx
    yd = (v - cy) / fy
    x, y = xd.copy(), yd.copy()
    if k1 or k2 or p1 or p2 or k3:
        for _ in range(20):
            r2 = x * x + y * y
            radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
            dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
            dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
            x = (xd - dx) / radial
            y = (yd - dy) / radial
    return x, y


@dataclass
class Plane:
    point: np.ndarray    # [3] a point on the plane (world)
    normal: np.ndarray   # [3] unit normal (world)
    u_axis: np.ndarray   # [3] texture u direction (world, unit)
    v_axis: np.ndarray   # [3] texture v direction (world, unit)
    texture: np.ndarray  # [T,T] float in [0,1]
    tex_scale: float     # meters per texture period


def _random_texture(rng: np.random.Generator, cells: int = 96) -> np.ndarray:
    """Blocky random multi-scale texture: sharp corners at cell boundaries.

    Three block lattices at coprime-ish cell counts are superimposed so
    local appearance is unique across the image — a single-period lattice
    aliases catastrophically when camera motion per frame approaches one
    cell (coherently wrong matches then form a valid rigid consensus that
    can out-vote the true pose in RANSAC).
    """

    def layer(n, lo, hi):
        t = rng.uniform(lo, hi, size=(n, n))
        reps = int(np.ceil(cells / n))
        return np.kron(t, np.ones((reps, reps)))[:cells, :cells]

    tex = layer(cells, 0.1, 0.5)          # fine lattice
    tex = tex + layer(29, 0.0, 0.35)      # mid lattice (coprime with 96)
    tex = tex + layer(13, 0.0, 0.25)      # coarse lattice
    return np.clip(tex, 0.05, 1.0)


def make_scene(seed: int = 0) -> list[Plane]:
    rng = np.random.default_rng(seed)

    def unit(v):
        v = np.asarray(v, np.float64)
        return v / np.linalg.norm(v)

    planes = [
        # back wall, slightly tilted
        Plane(
            point=np.array([0.0, 0.0, 3.2]),
            normal=unit([0.15, -0.1, -1.0]),
            u_axis=unit([1.0, 0.0, 0.15]),
            v_axis=unit([0.0, 1.0, -0.1]),
            texture=_random_texture(rng),
            tex_scale=4.0,
        ),
        # floor
        Plane(
            point=np.array([0.0, 0.9, 2.0]),
            normal=unit([0.0, -1.0, 0.0]),
            u_axis=unit([1.0, 0.0, 0.0]),
            v_axis=unit([0.0, 0.0, 1.0]),
            texture=_random_texture(rng),
            tex_scale=3.0,
        ),
        # side slab closer to the camera
        Plane(
            point=np.array([-1.1, 0.0, 2.2]),
            normal=unit([1.0, 0.0, -0.35]),
            u_axis=unit([0.35, 0.0, 1.0]),
            v_axis=unit([0.0, 1.0, 0.0]),
            texture=_random_texture(rng),
            tex_scale=2.5,
        ),
    ]
    return planes


def trajectory_pose(i: int, n: int, frames_per_loop: int = 240) -> tuple[np.ndarray, np.ndarray]:
    """Camera-to-world pose (R_wc, t_wc) along a smooth exploratory path.

    The path is parameterized by FRAME INDEX at fixed speed (one full loop
    per ``frames_per_loop`` frames at 30 fps -> ~0.35 m/s peak, fr1-class
    motion) so short sequences do not become artificially fast.
    """
    s = i / frames_per_loop
    t = np.array(
        [
            0.45 * np.sin(2.0 * np.pi * s),
            0.18 * np.sin(4.0 * np.pi * s + 0.7),
            0.30 * np.sin(2.0 * np.pi * s + 1.3),
        ]
    )
    # small look-around rotation (yaw/pitch/roll)
    yaw = 0.10 * np.sin(2.0 * np.pi * s + 0.3)
    pitch = 0.06 * np.sin(4.0 * np.pi * s)
    roll = 0.03 * np.sin(2.0 * np.pi * s + 2.0)
    cy_, sy = np.cos(yaw), np.sin(yaw)
    cp, sp = np.cos(pitch), np.sin(pitch)
    cr, sr = np.cos(roll), np.sin(roll)
    Rz = np.array([[cr, -sr, 0], [sr, cr, 0], [0, 0, 1]])
    Ry = np.array([[cy_, 0, sy], [0, 1, 0], [-sy, 0, cy_]])
    Rx = np.array([[1, 0, 0], [0, cp, -sp], [0, sp, cp]])
    return Ry @ Rx @ Rz, t


def render_frame(
    planes: list[Plane], R_wc: np.ndarray, t_wc: np.ndarray,
    intr: dict | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Ray-cast the scene: returns (gray uint8 [H,W], depth_m float32 [H,W]).

    ``intr``: dict(fx, fy, cx, cy[, k1, k2, p1, p2, k3]); distorted optics
    render through the undistorted ray grid (see _ray_grid); default is
    the distortion-free fr3 model."""
    if intr is None:
        intr = dict(fx=FX, fy=FY, cx=CX, cy=CY)
    x, y = _ray_grid(intr["fx"], intr["fy"], intr["cx"], intr["cy"],
                     intr.get("k1", 0.0), intr.get("k2", 0.0),
                     intr.get("p1", 0.0), intr.get("p2", 0.0),
                     intr.get("k3", 0.0))
    dirs_cam = np.stack([x, y, np.ones_like(x)], axis=-1)
    dirs_world = dirs_cam @ R_wc.T  # [H,W,3]
    origin = t_wc

    best_z = np.full((H, W), np.inf)
    shade = np.zeros((H, W))

    for pl in planes:
        denom = dirs_world @ pl.normal
        num = (pl.point - origin) @ pl.normal
        with np.errstate(divide="ignore", invalid="ignore"):
            t_hit = num / denom
        hit_pts = origin + dirs_world * t_hit[..., None]
        z_cam = t_hit * dirs_cam[..., 2]  # depth along camera z
        valid = (t_hit > 0.05) & np.isfinite(t_hit) & (z_cam < best_z) & (z_cam > 0.05)

        rel = hit_pts - pl.point
        tu = (rel @ pl.u_axis) / pl.tex_scale % 1.0
        tv = (rel @ pl.v_axis) / pl.tex_scale % 1.0
        T = pl.texture.shape[0]
        ti = np.clip((tu * T).astype(np.int64), 0, T - 1)
        tj = np.clip((tv * T).astype(np.int64), 0, T - 1)
        val = pl.texture[tj, ti]

        shade = np.where(valid, val, shade)
        best_z = np.where(valid, z_cam, best_z)

    depth = np.where(np.isfinite(best_z), best_z, 0.0).astype(np.float32)
    gray = np.clip(40.0 + 190.0 * shade, 0, 255).astype(np.uint8)
    gray = np.where(depth > 0, gray, 15).astype(np.uint8)
    return gray, depth


DEPTH_SCALE = 5000.0  # TUM 16-bit depth units per meter


def make_sequence(n_frames: int, seed: int = 5, frames_per_loop: int = 240):
    """(grays u8 [T,H,W], depths f32 [T,H,W], gt_t f64 [T,3]) of a
    synthetic fr3-style sequence (distortion-free intrinsics FX, FY, CX,
    CY); gt_t is the camera position in the world frame."""
    planes = make_scene(seed)
    grays = np.empty((n_frames, H, W), np.uint8)
    depths = np.empty((n_frames, H, W), np.float32)
    gt_t = np.empty((n_frames, 3), np.float64)
    for i in range(n_frames):
        R_wc, t_wc = trajectory_pose(i, n_frames, frames_per_loop)
        gray, depth = render_frame(planes, R_wc, t_wc)
        grays[i] = gray
        d16 = np.clip(depth * DEPTH_SCALE, 0, 65535).astype(np.uint16)
        depths[i] = d16.astype(np.float32) / DEPTH_SCALE
        gt_t[i] = [float(f"{v:.6f}") for v in t_wc]
    return grays, depths, gt_t


def generate_sequence(
    out_root: str,
    sequence: str = "rgbd_dataset_freiburg3_synthetic",
    n_frames: int = 60,
    seed: int = 0,
    fps: float = 30.0,
    frames_per_loop: int = 240,
    camera: str = "fr3",
) -> str:
    """Write a synthetic sequence in TUM RGB-D layout; returns dataset root.

    ``camera``: "fr3" (distortion-free, the default) or "fr1" (freiburg1
    optics with the real TUM fr1 radial-tangential distortion; pair it
    with a sequence name containing "freiburg1" so the loader picks the
    matching intrinsics file, dataset_tum_rgbd.cpp:124-165 semantics)."""
    seq_dir = os.path.join(out_root, sequence)
    os.makedirs(os.path.join(seq_dir, "rgb"), exist_ok=True)
    os.makedirs(os.path.join(seq_dir, "depth"), exist_ok=True)

    intr = FR1 if camera == "fr1" else dict(fx=FX, fy=FY, cx=CX, cy=CY)
    planes = make_scene(seed)
    t0 = 1305031102.0  # arbitrary TUM-looking epoch
    rgb_lines, depth_lines, gt_lines = [], [], []

    for i in range(n_frames):
        ts = t0 + i / fps
        R_wc, t_wc = trajectory_pose(i, n_frames, frames_per_loop)
        gray, depth = render_frame(planes, R_wc, t_wc, intr=intr)

        rgb_rel = f"rgb/{ts:.6f}.png"
        depth_rel = f"depth/{ts:.6f}.png"
        png.write_png(os.path.join(seq_dir, rgb_rel),
                      np.repeat(gray[..., None], 3, axis=-1))
        d16 = np.clip(depth * DEPTH_SCALE, 0, 65535).astype(np.uint16)
        png.write_png(os.path.join(seq_dir, depth_rel), d16)

        rgb_lines.append(f"{ts:.6f} {rgb_rel}")
        # offset depth ts slightly to exercise nearest-neighbor association
        depth_lines.append(f"{ts + 0.004:.6f} {depth_rel}")

        q = matrix_to_quat_xyzw(R_wc)
        gt_lines.append(
            f"{ts + 0.002:.6f} {t_wc[0]:.6f} {t_wc[1]:.6f} {t_wc[2]:.6f} "
            f"{q[0]:.6f} {q[1]:.6f} {q[2]:.6f} {q[3]:.6f}"
        )

    _write(os.path.join(seq_dir, "rgb.txt"), "# color images\n# ts filename", rgb_lines)
    _write(os.path.join(seq_dir, "depth.txt"), "# depth images\n# ts filename", depth_lines)
    _write(
        os.path.join(seq_dir, "groundtruth.txt"),
        "# ground truth trajectory\n# ts tx ty tz qx qy qz qw",
        gt_lines,
    )
    version = "1" if camera == "fr1" else "3"
    with open(os.path.join(out_root, f"color_camera_freiburg{version}.txt"),
              "w") as f:
        f.write("# fx fy cx cy k1 k2 p1 p2 k3\n")
        f.write(
            f"{intr['fx']} {intr['fy']} {intr['cx']} {intr['cy']} "
            f"{intr.get('k1', 0.0)} {intr.get('k2', 0.0)} "
            f"{intr.get('p1', 0.0)} {intr.get('p2', 0.0)} "
            f"{intr.get('k3', 0.0)}\n"
        )
    return out_root


def _write(path: str, header: str, lines: list[str]) -> None:
    with open(path, "w") as f:
        f.write(header + "\n")
        f.write("\n".join(lines) + "\n")
