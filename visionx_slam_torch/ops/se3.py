"""SO(3) / SE(3) ops on tensors (counterpart of ``visionx_slam_tpu/ops/se3.py``).

Same conventions as the JAX package (and Sophus):
- a pose is (q, t): unit quaternion q in wxyz order plus translation t;
  ``T * p = R(q) @ p + t``;
- the se(3) tangent is ``xi = [upsilon(3), omega(3)]``, translation first;
- ``se3_exp`` uses the left Jacobian V; the BA retraction is ``exp(dx) * T``.

Every function broadcasts over leading batch dimensions. Constants are made
on the device (``zeros`` and fills), never copied from the host: a host copy
synchronizes a CUDA stream, and these functions run in the scan's per-frame
loop.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

_EPS = 1e-8


class Pose(NamedTuple):
    """SE(3) element: unit quaternion (wxyz) + translation, batched."""

    q: torch.Tensor  # [..., 4] wxyz
    t: torch.Tensor  # [..., 3]


def identity_pose(batch_shape=(), dtype=torch.float32, device=None) -> Pose:
    q = torch.zeros((*batch_shape, 4), dtype=dtype, device=device)
    q[..., 0].fill_(1.0)
    return Pose(q, torch.zeros((*batch_shape, 3), dtype=dtype, device=device))


def quat_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        dim=-1,
    )


def quat_conj(q: torch.Tensor) -> torch.Tensor:
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def quat_normalize(q: torch.Tensor) -> torch.Tensor:
    n = torch.linalg.norm(q, dim=-1, keepdim=True)
    q = q / torch.clamp(n, min=_EPS)
    # canonical sign (w >= 0)
    return q * torch.where(q[..., :1] < 0, -1.0, 1.0)


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    qv, vb = torch.broadcast_tensors(q[..., 1:], v)
    uv = torch.linalg.cross(qv, vb)
    uuv = torch.linalg.cross(qv, uv)
    return v + 2.0 * (q[..., :1] * uv + uuv)


def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    w, x, y, z = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        dim=-1,
    )
    return m.reshape(*q.shape[:-1], 3, 3)


def matrix_to_quat(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> quaternion (wxyz); branch-free Shepperd variant."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    qw2 = 1.0 + m00 + m11 + m22
    qx2 = 1.0 + m00 - m11 - m22
    qy2 = 1.0 - m00 + m11 - m22
    qz2 = 1.0 - m00 - m11 + m22

    def safe_sqrt(v):
        return torch.sqrt(torch.clamp(v, min=0.0))

    w_w = safe_sqrt(qw2) / 2
    d_w = torch.clamp(4 * w_w, min=_EPS)
    cand_w = torch.stack([w_w, (m21 - m12) / d_w, (m02 - m20) / d_w, (m10 - m01) / d_w], -1)
    x_x = safe_sqrt(qx2) / 2
    d_x = torch.clamp(4 * x_x, min=_EPS)
    cand_x = torch.stack([(m21 - m12) / d_x, x_x, (m01 + m10) / d_x, (m02 + m20) / d_x], -1)
    y_y = safe_sqrt(qy2) / 2
    d_y = torch.clamp(4 * y_y, min=_EPS)
    cand_y = torch.stack([(m02 - m20) / d_y, (m01 + m10) / d_y, y_y, (m12 + m21) / d_y], -1)
    z_z = safe_sqrt(qz2) / 2
    d_z = torch.clamp(4 * z_z, min=_EPS)
    cand_z = torch.stack([(m10 - m01) / d_z, (m02 + m20) / d_z, (m12 + m21) / d_z, z_z], -1)

    best = torch.argmax(torch.stack([qw2, qx2, qy2, qz2], -1), dim=-1)
    cands = torch.stack([cand_w, cand_x, cand_y, cand_z], -2)  # [..., 4cand, 4]
    idx = best[..., None, None].expand(*best.shape, 1, 4)
    return quat_normalize(torch.gather(cands, -2, idx)[..., 0, :])


def so3_hat(omega: torch.Tensor) -> torch.Tensor:
    """omega [...,3] -> skew-symmetric [...,3,3]."""
    ox, oy, oz = omega.unbind(-1)
    zero = torch.zeros_like(ox)
    m = torch.stack([zero, -oz, oy, oz, zero, -ox, -oy, ox, zero], dim=-1)
    return m.reshape(*omega.shape[:-1], 3, 3)


def so3_exp(omega: torch.Tensor) -> torch.Tensor:
    """Axis-angle [...,3] -> quaternion (wxyz), Taylor-safe near zero."""
    theta_sq = torch.sum(omega * omega, dim=-1, keepdim=True)
    theta = torch.sqrt(torch.clamp(theta_sq, min=0.0))
    small = theta_sq < 1e-10
    k = torch.where(small, 0.5 - theta_sq / 48.0,
                    torch.sin(0.5 * theta) / torch.clamp(theta, min=_EPS))
    w = torch.where(small, 1.0 - theta_sq / 8.0, torch.cos(0.5 * theta))
    return torch.cat([w, k * omega], dim=-1)


def _so3_left_jacobian(omega: torch.Tensor) -> torch.Tensor:
    theta_sq = torch.sum(omega * omega, dim=-1)[..., None, None]
    theta = torch.sqrt(torch.clamp(theta_sq, min=0.0))
    O = so3_hat(omega)
    OO = O @ O
    small = theta_sq < 1e-10
    a = torch.where(small, 0.5 - theta_sq / 24.0,
                    (1.0 - torch.cos(theta)) / torch.clamp(theta_sq, min=_EPS))
    b = torch.where(small, 1.0 / 6.0 - theta_sq / 120.0,
                    (theta - torch.sin(theta))
                    / torch.clamp(theta_sq * theta, min=_EPS))
    eye = torch.eye(3, dtype=omega.dtype, device=omega.device).expand_as(O)
    return eye + a * O + b * OO


def se3_exp(xi: torch.Tensor) -> Pose:
    """se(3) tangent [...,6] = [upsilon, omega] -> Pose."""
    upsilon = xi[..., :3]
    omega = xi[..., 3:]
    V = _so3_left_jacobian(omega)
    return Pose(so3_exp(omega), (V @ upsilon[..., None])[..., 0])


def se3_compose(a: Pose, b: Pose) -> Pose:
    """a * b (first apply b, then a)."""
    return Pose(quat_normalize(quat_mul(a.q, b.q)), quat_rotate(a.q, b.t) + a.t)


def se3_inverse(T: Pose) -> Pose:
    qinv = quat_conj(T.q)
    return Pose(qinv, -quat_rotate(qinv, T.t))


def se3_apply(T: Pose, p: torch.Tensor) -> torch.Tensor:
    """T * p for points [...,3]; the pose broadcasts over point dims."""
    return quat_rotate(T.q, p) + T.t


def se3_matrix(T: Pose) -> torch.Tensor:
    """Pose -> homogeneous [...,4,4]."""
    R = quat_to_matrix(T.q)
    top = torch.cat([R, T.t[..., :, None]], dim=-1)
    bottom = torch.zeros_like(top[..., :1, :])
    bottom[..., 3].fill_(1.0)
    return torch.cat([top, bottom], dim=-2)
