"""The benchmark's synthetic TUM-class sequence, rendered on the device.

Three textured planes drawn from a seed (a copy of the port's
``data/synthetic.py::make_scene``, itself the JAX package's), seen by the
camera that a configuration states (``Capture.from_config``: size,
intrinsics, depth units, frame rate) along a periodic loop that moves at the
configuration's mean speeds, translational and angular, as TUM reports them
for the sequence the configuration names. The images are ray-cast on the
device in float64 as the port's ``render_frame`` casts them (a rectified
pinhole camera: no distortion), in chunks of frames, and quantized as a TUM
sequence stores them: 8-bit gray, depth in 16-bit units of
1/``depth_scale`` m.

Nothing here imports the program; the reference reads the same description
(planes, camera, poses) and works out its own truths from it.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

NEAR = 0.05                   # hits nearer than this are ignored (m)


@dataclass
class Plane:
    point: np.ndarray    # [3] a point on the plane (world)
    normal: np.ndarray   # [3] unit normal (world)
    u_axis: np.ndarray   # [3] texture u direction (world, unit)
    v_axis: np.ndarray   # [3] texture v direction (world, unit)
    texture: np.ndarray  # [T,T] float64 in [0,1]
    tex_scale: float     # metres per texture period


def _random_texture(rng: np.random.Generator, cells: int = 96) -> np.ndarray:
    """Three superimposed block lattices (96, 29 and 13 cells): local
    appearance is unique across the image, so no lattice aliases into a
    coherent false match."""

    def layer(n, lo, hi):
        t = rng.uniform(lo, hi, size=(n, n))
        reps = int(np.ceil(cells / n))
        return np.kron(t, np.ones((reps, reps)))[:cells, :cells]

    tex = layer(cells, 0.1, 0.5)
    tex = tex + layer(29, 0.0, 0.35)
    tex = tex + layer(13, 0.0, 0.25)
    return np.clip(tex, 0.05, 1.0)


def _unit(v) -> np.ndarray:
    v = np.asarray(v, np.float64)
    return v / np.linalg.norm(v)


def make_scene(seed: int) -> list[Plane]:
    """Back wall, floor and a side slab; only the textures depend on the
    seed, so every seed gives the same geometry, sizes and motion."""
    rng = np.random.default_rng(int(seed) % (1 << 64))
    return [
        Plane(np.array([0.0, 0.0, 3.2]), _unit([0.15, -0.1, -1.0]),
              _unit([1.0, 0.0, 0.15]), _unit([0.0, 1.0, -0.1]),
              _random_texture(rng), 4.0),
        Plane(np.array([0.0, 0.9, 2.0]), _unit([0.0, -1.0, 0.0]),
              _unit([1.0, 0.0, 0.0]), _unit([0.0, 0.0, 1.0]),
              _random_texture(rng), 3.0),
        Plane(np.array([-1.1, 0.0, 2.2]), _unit([1.0, 0.0, -0.35]),
              _unit([0.35, 0.0, 1.0]), _unit([0.0, 1.0, 0.0]),
              _random_texture(rng), 2.5),
    ]


def lane_seeds(seed: int, lanes: int) -> list[int]:
    """One scene seed per lane, drawn from the run's seed."""
    ss = np.random.SeedSequence(int(seed) % (1 << 64))
    return [int(s.generate_state(1, np.uint64)[0]) for s in ss.spawn(lanes)]


def _shape(s: np.ndarray):
    """The loop's shape at phases ``s`` (loops, float64): positions [n,3]
    (m) and yaw, pitch, roll [n] (rad) before scaling to the stated speeds.
    A sweep across the scene once a loop; the view turns three times a loop
    in yaw and four in pitch, as a hand-held camera looks around a desk."""
    pos = np.stack([0.45 * np.sin(2.0 * np.pi * s),
                    0.18 * np.sin(4.0 * np.pi * s + 0.7),
                    0.30 * np.sin(2.0 * np.pi * s + 1.3)], -1)
    return (pos, 0.10 * np.sin(6.0 * np.pi * s + 0.3),
            0.05 * np.sin(8.0 * np.pi * s), 0.03 * np.sin(2.0 * np.pi * s + 2.0))


def _rotations(yaw, pitch, roll) -> np.ndarray:
    """R_wc = R_y(yaw) R_x(pitch) R_z(roll), [n,3,3]."""
    c, s = np.cos, np.sin
    one, zero = np.ones_like(yaw), np.zeros_like(yaw)
    Rz = np.stack([np.stack([c(roll), -s(roll), zero], -1),
                   np.stack([s(roll), c(roll), zero], -1),
                   np.stack([zero, zero, one], -1)], -2)
    Ry = np.stack([np.stack([c(yaw), zero, s(yaw)], -1),
                   np.stack([zero, one, zero], -1),
                   np.stack([-s(yaw), zero, c(yaw)], -1)], -2)
    Rx = np.stack([np.stack([one, zero, zero], -1),
                   np.stack([zero, c(pitch), -s(pitch)], -1),
                   np.stack([zero, s(pitch), c(pitch)], -1)], -2)
    return Ry @ Rx @ Rz


def step_angles(R: np.ndarray) -> np.ndarray:
    """Rotation angle (rad) between consecutive rotations of [n,3,3]."""
    rel = np.einsum("nji,njk->nik", R[:-1], R[1:])
    cos = (np.trace(rel, axis1=1, axis2=2) - 1.0) / 2.0
    return np.arccos(np.clip(cos, -1.0, 1.0))


@dataclass(frozen=True)
class Capture:
    """The camera of a configuration and the loop it moves along."""

    width: int
    height: int
    fx: float
    fy: float
    cx: float
    cy: float
    depth_scale: float            # depth units per metre (TUM: 5000)
    rate_hz: float
    loop_frames: int
    mean_speed: float             # m/s over the loop
    mean_turn: float              # rad/s over the loop

    @classmethod
    def from_config(cls, cfg: dict) -> "Capture":
        c, m = cfg["camera"], cfg["motion"]
        return cls(int(c["width"]), int(c["height"]), float(c["fx"]),
                   float(c["fy"]), float(c["cx"]), float(c["cy"]),
                   float(c["depth_scale"]), float(c["rate_hz"]),
                   int(m["loop_frames"]), float(m["mean_speed_m_per_s"]),
                   np.deg2rad(float(m["mean_angular_speed_deg_per_s"])))

    def _gains(self) -> tuple[float, float]:
        """Factors on the shape's positions and angles that give the loop
        the stated mean speeds, measured frame to frame at the camera's
        rate over one loop (as TUM measures them on its ground truth)."""
        s = np.arange(self.loop_frames + 1) / self.loop_frames
        pos, yaw, pitch, roll = _shape(s)
        speed = np.linalg.norm(np.diff(pos, axis=0), axis=1).mean() * self.rate_hz
        g = 1.0
        for _ in range(100):
            turn = step_angles(_rotations(g * yaw, g * pitch, g * roll)).mean() \
                * self.rate_hz
            if abs(turn / self.mean_turn - 1.0) < 1e-13:
                break
            g *= self.mean_turn / turn
        return self.mean_speed / speed, g

    def trajectory(self, frame_ids) -> tuple[np.ndarray, np.ndarray]:
        """Camera-to-world poses (R_wc [T,3,3], t_wc [T,3], float64) at the
        given frame indices; the path is periodic with ``loop_frames``."""
        a, g = self._gains()
        s = (np.asarray(frame_ids, np.int64) % self.loop_frames) / self.loop_frames
        pos, yaw, pitch, roll = _shape(s)
        return _rotations(g * yaw, g * pitch, g * roll), a * pos

    def _cast(self, planes, R_wc, t_wc, device, margins: bool):
        """Ray-cast a chunk of frames in float64: (shade, depth z, margin)."""
        f64 = dict(dtype=torch.float64, device=device)
        v, u = torch.meshgrid(torch.arange(self.height, **f64),
                              torch.arange(self.width, **f64), indexing="ij")
        x, y = (u - self.cx) / self.fx, (v - self.cy) / self.fy   # [H,W]
        R = torch.as_tensor(R_wc, **f64)                           # [T,3,3]
        o = torch.as_tensor(t_wc, **f64)                           # [T,3]
        # world ray directions, d_j = sum_k dir_cam[k] R[j,k], dir_cam_z = 1
        d = (x[None, :, :, None] * R[:, None, None, :, 0]
             + y[None, :, :, None] * R[:, None, None, :, 1]
             + R[:, None, None, :, 2])                             # [T,H,W,3]
        shape = d.shape[:3]
        best = torch.full(shape, float("inf"), **f64)
        shade = torch.zeros(shape, **f64)
        margin = torch.full(shape, float("inf"), **f64)
        for pl in planes:
            n = torch.as_tensor(pl.normal, **f64)
            p = torch.as_tensor(pl.point, **f64)
            th = ((p[None] - o) @ n)[:, None, None] / (d @ n)      # [T,H,W]
            hit = o[:, None, None, :] + d * th[..., None]
            z = th                                                 # dir_cam_z = 1
            ok = (th > NEAR) & torch.isfinite(th) & (z < best) & (z > NEAR)
            rel = hit - p
            tex = torch.as_tensor(pl.texture, **f64)
            Tn = tex.shape[0]
            fu = ((rel @ torch.as_tensor(pl.u_axis, **f64)) / pl.tex_scale
                  % 1.0) * Tn
            fv = ((rel @ torch.as_tensor(pl.v_axis, **f64)) / pl.tex_scale
                  % 1.0) * Tn
            ti = fu.to(torch.int64).clamp(0, Tn - 1)
            tj = fv.to(torch.int64).clamp(0, Tn - 1)
            val = tex[tj, ti]
            if margins:   # distance of each decision to its boundary
                frac = lambda a: torch.minimum(a - a.floor(), a.floor() + 1 - a)
                m = torch.minimum(frac(fu), frac(fv))
                m = torch.where(torch.isfinite(best), torch.minimum(
                    m, (z - best).abs()), m)
                margin = torch.where(ok | (torch.isfinite(th) & (th > NEAR)),
                                     torch.minimum(margin, m), margin)
            shade = torch.where(ok, val, shade)
            best = torch.where(ok, z, best)
        return shade, best, margin

    def render(self, planes: list[Plane], R_wc: np.ndarray, t_wc: np.ndarray,
               device, chunk: int = 16, margins: bool = False):
        """(gray uint8 [T,H,W], depth float32 [T,H,W] in metres, quantized
        to 1/depth_scale m as a TUM PNG holds it) on ``device``; with
        ``margins`` also each pixel's float64 distance to its nearest
        rounding decision (a texture-cell edge, a depth step, or two planes
        at the same depth), for tests that compare renderers."""
        T, H, W = len(t_wc), self.height, self.width
        gray = torch.empty((T, H, W), dtype=torch.uint8, device=device)
        depth = torch.empty((T, H, W), dtype=torch.float32, device=device)
        marg = torch.empty((T, H, W), dtype=torch.float64, device=device) \
            if margins else None
        for a in range(0, T, chunk):
            shade, best, m = self._cast(planes, R_wc[a:a + chunk],
                                        t_wc[a:a + chunk], device, margins)
            z32 = torch.where(torch.isfinite(best), best, 0.0).to(torch.float32)
            d16 = (z32 * self.depth_scale).clamp(0, 65535).to(torch.int32)
            depth[a:a + chunk] = d16.to(torch.float32) / self.depth_scale
            g = (40.0 + 190.0 * shade).clamp(0, 255).to(torch.uint8)
            gray[a:a + chunk] = torch.where(z32 > 0, g, 15)
            if margins:
                q = z32.double() * self.depth_scale
                marg[a:a + chunk] = torch.minimum(
                    m, torch.minimum(q - q.floor(), q.floor() + 1 - q))
        return (gray, depth, marg) if margins else (gray, depth)
