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
