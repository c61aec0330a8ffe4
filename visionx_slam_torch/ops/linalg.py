"""Closed-form small-matrix linear algebra (counterpart of
``visionx_slam_tpu/ops/linalg.py``): elementwise formulas over any batch."""

from __future__ import annotations

import torch


def det3x3(A: torch.Tensor) -> torch.Tensor:
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    return a * (e * i - f * h) - b * (d * i - f * g) + c * (d * h - e * g)


def inv3x3(A: torch.Tensor, eps: float = 1e-20) -> torch.Tensor:
    """Batched 3x3 inverse via the adjugate; |det| is clamped to eps with
    its sign kept, so singular inputs give large but finite values."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    A00 = e * i - f * h
    A01 = c * h - b * i
    A02 = b * f - c * e
    A10 = f * g - d * i
    A11 = a * i - c * g
    A12 = c * d - a * f
    A20 = d * h - e * g
    A21 = b * g - a * h
    A22 = a * e - b * d
    det = a * A00 + b * A10 + c * A20
    det_safe = torch.where(det.abs() < eps, torch.where(det < 0, -eps, eps), det)
    inv_det = 1.0 / det_safe
    adj = torch.stack(
        [
            torch.stack([A00, A01, A02], -1),
            torch.stack([A10, A11, A12], -1),
            torch.stack([A20, A21, A22], -1),
        ],
        -2,
    )
    return adj * inv_det[..., None, None]


def solve3x3(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched solve of A x = b for [..., 3, 3] x [..., 3]."""
    return (inv3x3(A) @ b[..., None])[..., 0]


def inv2x2(A: torch.Tensor, eps: float = 1e-30) -> torch.Tensor:
    """Batched 2x2 inverse; |det| is clamped to eps with its sign kept."""
    a, b = A[..., 0, 0], A[..., 0, 1]
    c, d = A[..., 1, 0], A[..., 1, 1]
    det = a * d - b * c
    det_safe = torch.where(det.abs() < eps, torch.where(det < 0, -eps, eps), det)
    m = torch.stack([torch.stack([d, -b], -1), torch.stack([-c, a], -1)], -2)
    return m * (1.0 / det_safe)[..., None, None]


def solve4x4(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched solve of SPD-ish [..., 4, 4] x [..., 4] by a 2x2-block Schur
    complement (pivot-free; the leading 2x2 block must be invertible)."""
    P = A[..., :2, :2]
    Q = A[..., :2, 2:]
    R = A[..., 2:, :2]
    S = A[..., 2:, 2:]
    b1 = b[..., :2, None]
    b2 = b[..., 2:, None]
    Pi = inv2x2(P)
    RPi = R @ Pi
    Mi = inv2x2(S - RPi @ Q)
    y2 = Mi @ (b2 - RPi @ b1)
    y1 = Pi @ (b1 - Q @ y2)
    return torch.cat([y1, y2], dim=-2)[..., 0]


def chol3x3(A: torch.Tensor, eps: float = 1e-20) -> torch.Tensor:
    """Batched lower Cholesky factor of SPD [..., 3, 3] in closed form."""
    a00 = torch.sqrt(torch.clamp(A[..., 0, 0], min=eps))
    l10 = A[..., 1, 0] / a00
    l20 = A[..., 2, 0] / a00
    l11 = torch.sqrt(torch.clamp(A[..., 1, 1] - l10 * l10, min=eps))
    l21 = (A[..., 2, 1] - l20 * l10) / l11
    l22 = torch.sqrt(torch.clamp(A[..., 2, 2] - l20 * l20 - l21 * l21, min=eps))
    zero = torch.zeros_like(a00)
    return torch.stack(
        [
            torch.stack([a00, zero, zero], -1),
            torch.stack([l10, l11, zero], -1),
            torch.stack([l20, l21, l22], -1),
        ],
        -2,
    )


def _chol_solve(A: torch.Tensor, b: torch.Tensor, n: int,
                eps: float) -> torch.Tensor:
    """Solve SPD [..., n, n] x [..., n] by a fully unrolled scalar Cholesky
    and two triangular substitutions (the JAX package's form)."""
    a = [[A[..., i, j] for j in range(n)] for i in range(n)]
    L = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(i + 1):
            s = a[i][j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            if i == j:
                L[i][j] = torch.sqrt(torch.clamp(s, min=eps))
            else:
                L[i][j] = s / L[j][j]
    y = [None] * n
    for i in range(n):
        s = b[..., i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return torch.stack(x, dim=-1)


def chol_solve4x4(A: torch.Tensor, b: torch.Tensor,
                  eps: float = 1e-30) -> torch.Tensor:
    """Solve SPD [..., 4, 4] x [..., 4] by an unrolled scalar Cholesky."""
    return _chol_solve(A, b, 4, eps)


def chol_solve6x6(A: torch.Tensor, b: torch.Tensor,
                  eps: float = 1e-12) -> torch.Tensor:
    """Solve SPD [..., 6, 6] x [..., 6] by an unrolled scalar Cholesky."""
    return _chol_solve(A, b, 6, eps)


def solve6x6_spd(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched solve of SPD [..., 6, 6] x [..., 6] by a 3x3-block Schur
    complement (pivot-free; for damped Gauss-Newton normal matrices)."""
    P = A[..., :3, :3]
    Q = A[..., :3, 3:]
    R = A[..., 3:, :3]
    S = A[..., 3:, 3:]
    b1 = b[..., :3, None]
    b2 = b[..., 3:, None]
    Pi = inv3x3(P)
    RPi = R @ Pi
    Mi = inv3x3(S - RPi @ Q)
    y2 = Mi @ (b2 - RPi @ b1)
    y1 = Pi @ (b1 - Q @ y2)
    return torch.cat([y1, y2], dim=-2)[..., 0]
