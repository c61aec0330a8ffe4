"""Pinhole camera model (counterpart of ``visionx_slam_tpu/ops/camera.py``).

``CameraParams`` holds Python floats already rounded to float32, so the
camera costs no device transfer and every product with it is a float32
tensor op, as in the JAX package.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .se3 import Pose, se3_apply


class CameraParams(NamedTuple):
    fx: float
    fy: float
    cx: float
    cy: float
    k1: float
    k2: float
    p1: float
    p2: float


def make_camera(fx, fy, cx, cy, k1=0.0, k2=0.0, p1=0.0, p2=0.0) -> CameraParams:
    f32 = lambda v: float(np.float32(v))
    return CameraParams(f32(fx), f32(fy), f32(cx), f32(cy),
                        f32(k1), f32(k2), f32(p1), f32(p2))


def intrinsic_matrix(cam: CameraParams, dtype=torch.float32,
                     device=None) -> torch.Tensor:
    """3x3 K (no distortion), as built at reference tracking.cpp:850-853."""
    K = torch.zeros((3, 3), dtype=dtype, device=device)
    K[0, 0].fill_(cam.fx)
    K[0, 2].fill_(cam.cx)
    K[1, 1].fill_(cam.fy)
    K[1, 2].fill_(cam.cy)
    K[2, 2].fill_(1.0)
    return K


def project_distorted(cam: CameraParams, pc: torch.Tensor) -> torch.Tensor:
    """Camera-frame points [...,3] -> distorted pixels [...,2]
    (camera.cpp:17-28: k1, k2 radial and p1, p2 tangential terms)."""
    x = pc[..., 0] / pc[..., 2]
    y = pc[..., 1] / pc[..., 2]
    r2 = x * x + y * y
    radial = 1.0 + cam.k1 * r2 + cam.k2 * r2 * r2
    xd = x * radial + 2.0 * cam.p1 * x * y + cam.p2 * (r2 + 2.0 * x * x)
    yd = y * radial + cam.p1 * (r2 + 2.0 * y * y) + 2.0 * cam.p2 * x * y
    return torch.stack([cam.fx * xd + cam.cx, cam.fy * yd + cam.cy], dim=-1)


def backproject(cam: CameraParams, px: torch.Tensor, depth: torch.Tensor) -> torch.Tensor:
    """Pixels [...,2] + depth [...] -> camera-frame points [...,3] (no
    undistortion, as in the reference)."""
    x = (px[..., 0] - cam.cx) / cam.fx
    y = (px[..., 1] - cam.cy) / cam.fy
    return torch.stack([x * depth, y * depth, depth], dim=-1)


def project_pinhole(cam: CameraParams, T_cw: Pose, pw: torch.Tensor):
    """World points -> (uv [...,2], valid [...], pc [...,3]); distortion-free
    with the z > 1e-6 cheirality gate; invalid entries get uv = 0."""
    pc = se3_apply(T_cw, pw)
    z = pc[..., 2]
    valid = z > 1e-6
    safe_z = torch.where(valid, z, 1.0)
    u = cam.fx * pc[..., 0] / safe_z + cam.cx
    v = cam.fy * pc[..., 1] / safe_z + cam.cy
    uv = torch.where(valid[..., None], torch.stack([u, v], dim=-1), 0.0)
    return uv, valid, pc
