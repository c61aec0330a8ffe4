"""The benchmark's frozen arithmetic: kernel K1's least traffic and work,
its bound on one H100, the published peaks, the device's busy time from a
trace, and the TUM trajectory error.

Copies, so that a change to the program cannot move the yardstick:
``k1_bytes``, ``k1_ops`` and ``bound_ms`` of the port's ``utils/flops.py``
(K1 at an [8,1896,640] atlas chunk: 78,873,600 bytes; at B=1:
10,920,960), the atlas rows of ``models/orb_torch.py::_atlas_layout``, the
merged-interval busy time of ``tools/profile_offline.py`` and the Horn /
Umeyama alignment of ``eval/trajectory.py``.
"""

from __future__ import annotations

import numpy as np

# NVIDIA's H100 SXM5 data sheet, dense rates at the 700 W limit
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

# arithmetic and compares per output pixel of K1, halo not counted: FAST
# 34 (two thresholds, 32 compares), Sobel rows 4, gradients and products 9,
# the three 7x7 box sums 36, Harris 7, NMS 9 (8 max, 1 compare), blur 26
K1_OPS_PER_PIXEL = 34 + 4 + 9 + 36 + 7 + 9 + 26

# the name of K1's CUDA kernel (the score-only K1b is the <true> instance)
K1_KERNEL = "fast_harris_kernel<false>"


def atlas_rows(H: int = 480, W: int = 640, n_levels: int = 8,
               scale_factor: float = 1.2) -> int:
    """Rows of the ORB pyramid atlas K1 runs on: the levels packed on
    8-aligned shelves of width W (1896 at 640x480, 8 levels of 1.2)."""
    y = x = shelf_h = 0
    for lvl in range(n_levels):
        s = scale_factor**lvl
        h, w = int(round(H / s)), int(round(W / s))
        wa = -(-w // 8) * 8
        if x + wa > W:
            y += -(-shelf_h // 8) * 8
            x, shelf_h = 0, 0
        x += wa
        shelf_h = max(shelf_h, h)
    return y + -(-shelf_h // 8) * 8


def k1_bytes(shape) -> int:
    """Least traffic of K1 on a [B,H,W] atlas: bf16 image read, int8 mask
    (shared by the batch) read, f32 score and bf16 blur written."""
    B, H, W = shape
    return B * H * W * (2 + 4 + 2) + H * W


def k1_ops(shape) -> int:
    return int(np.prod(shape)) * K1_OPS_PER_PIXEL


def bound_ms(n_bytes: int, n_ops: int = 0) -> float:
    """The least time of a kernel on an H100: the larger of its bytes over
    the memory rate and its float32 operations over the float32 rate."""
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / F32_OPS_PER_S) * 1e3


def union_length(spans) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(spans):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def gaps(spans, lo: float, hi: float) -> list[tuple[float, float]]:
    """The intervals of [lo, hi] that no span covers."""
    out, at = [], lo
    for s, e in sorted(spans):
        if s > at:
            out.append((at, min(s, hi)))
        at = max(at, e)
        if at >= hi:
            break
    if at < hi:
        out.append((at, hi))
    return [(a, b) for a, b in out if b > a]


def umeyama(src: np.ndarray, dst: np.ndarray, with_scale: bool = False):
    """Least-squares rigid (or similarity) alignment src -> dst: (R, t, s)."""
    mu_s, mu_d = src.mean(0), dst.mean(0)
    xs, xd = src - mu_s, dst - mu_d
    U, D, Vt = np.linalg.svd(xd.T @ xs / len(src))
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    s = float(np.trace(np.diag(D) @ S) / ((xs**2).sum() / len(src))) \
        if with_scale else 1.0
    return R, mu_d - s * R @ mu_s, s
