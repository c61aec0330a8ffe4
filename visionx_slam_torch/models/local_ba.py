"""The two helpers of ``visionx_slam_tpu/models/local_ba.py`` that global BA
uses; the windowed local BA itself is not ported yet."""

from __future__ import annotations

import torch

from ..ops.camera import CameraParams


def _proj_jacobian(cam: CameraParams, pc: torch.Tensor) -> torch.Tensor:
    """d(pixel)/d(pc): [...,2,3] (reference ProjectionJacobian)."""
    inv_z = 1.0 / torch.clamp(pc[..., 2], min=1e-6)
    zeros = torch.zeros_like(inv_z)
    return torch.stack(
        [
            torch.stack([cam.fx * inv_z, zeros, -cam.fx * pc[..., 0] * inv_z**2], -1),
            torch.stack([zeros, cam.fy * inv_z, -cam.fy * pc[..., 1] * inv_z**2], -1),
        ],
        -2,
    )


def _huber_w(err_norm: torch.Tensor, delta: float) -> torch.Tensor:
    """Huber weight: 1 inside delta, delta/err outside."""
    return torch.where(err_norm <= delta, 1.0, delta / torch.clamp(err_norm, min=1e-12))
