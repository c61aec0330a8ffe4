"""Synthetic RGB-D sequences in memory (numpy only; no cv2).

The scene, trajectory and renderer are copies of
``visionx_slam_tpu/data/synthetic.py`` (``make_scene``, ``trajectory_pose``,
``render_frame``); ``make_sequence`` returns the arrays that
``bench.py::_load_sequence`` gets after its PNG round trip: 8-bit gray,
depth quantized to the TUM 16-bit scale (1/5000 m), and ground-truth
positions at the 6 decimals of the ``groundtruth.txt`` it writes.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np

W, H = 640, 480
FX, FY, CX, CY = 525.0, 525.0, 319.5, 239.5  # fr3-style, zero distortion


@functools.lru_cache(maxsize=1)
def _ray_grid():
    """Per-pixel normalized ray (x, y) of the distortion-free camera."""
    u, v = np.meshgrid(np.arange(W, dtype=np.float64),
                       np.arange(H, dtype=np.float64))
    return (u - CX) / FX, (v - CY) / FY


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


def render_frame(planes: list[Plane], R_wc: np.ndarray,
                 t_wc: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Ray-cast the scene: returns (gray uint8 [H,W], depth_m float32 [H,W])
    for the distortion-free fr3-style camera (FX, FY, CX, CY)."""
    x, y = _ray_grid()
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
