"""Fused FAST-9 + Harris + NMS + border mask + blur: kernel K1, its
score-only form K1b, and their plain PyTorch versions.

Counterpart of ``visionx_slam_tpu/ops/pallas_detect.py``. The detection
stage of ORB is ~50 stencil passes over the pyramid atlas; kernel K1
(``csrc/fast_harris_blur.cu``) computes both outputs in one pass with every
intermediate kept in registers:

- ``score`` f32 [B,H,W]: Harris response where (FAST corner & 3x3 NMS winner
  & border mask), else ``NEG``;
- ``blur`` bf16 [B,H,W]: the 7-tap Gaussian blur the BRIEF patches sample.

``fast_harris_blur`` runs the plain version for a CPU tensor and launches K1
for a CUDA tensor; there is no fallback between the two. ``fast_harris_score``
(K1b, counterpart of ``pallas_detect.fast_harris_score``) is the
detection-only form: one launch of the same kernel compiled without the
mask and the blur, reading the float32 image and rounding it to bf16 as it
loads. Both are compiled with ``nvcc`` from the repo's source at first use
into ``build/`` and bound through a plain C interface with ``ctypes``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

NEG = -3.0e38  # stand-in for -inf that survives f32 arithmetic
HARRIS_K = 0.04
HARRIS_BLOCK = 7

# FAST circle taps (dy, dx), radius 3, clockwise from 12 o'clock
FAST_CIRCLE = np.array(
    [
        (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
        (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
    ],
    np.int32,
)

_PKG = Path(__file__).resolve().parents[1]
_SOURCE = _PKG / "csrc" / "fast_harris_blur.cu"
_BUILD_DIR = _PKG / "build"

launches = 0        # K1 launches since import (or the last reset by a caller)
score_launches = 0  # K1b (fast_harris_score) launches, likewise


def _gaussian_kernel1d(size: int = 7, sigma: float = 2.0) -> np.ndarray:
    x = np.arange(size) - size // 2
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _blur_taps_bf16() -> tuple[float, ...]:
    """Gaussian taps rounded to bf16, as the kernel multiplies by them."""
    k = torch.from_numpy(_gaussian_kernel1d()).to(torch.bfloat16)
    return tuple(float(v) for v in k.float())


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: K1 cannot be built")
    return path


@functools.lru_cache(maxsize=None)
def _build(source: Path) -> ctypes.CDLL:
    """Compile ``source`` (once per source version) into a shared library
    under ``build/`` and load it."""
    src = source.read_bytes()
    tag = hashlib.sha256(src).hexdigest()[:16]
    so = _BUILD_DIR / f"{source.stem}_{tag}.so"
    if not so.exists():
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
               "-std=c++17", "-O3", "-Xptxas", "-v", "-shared",
               "-Xcompiler", "-fPIC", "-o", str(tmp), str(source)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"K1 build failed:\n{res.stdout}{res.stderr}")
        os.replace(tmp, so)
        so.with_suffix(".ptxas.txt").write_text(res.stderr)
    return ctypes.CDLL(str(so))


# C signatures of the library's entry points (see the .cu file's foot)
_ARGTYPES = {
    "vxs_fast_harris_blur": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [
        ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p],
    "vxs_fast_harris_score": [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + [
        ctypes.c_float, ctypes.c_void_p],
}


@functools.lru_cache(maxsize=None)
def _entry(source: Path, name: str):
    """The entry point ``name`` of the library built from ``source``."""
    fn = getattr(_build(source), name)
    fn.argtypes = _ARGTYPES[name]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _blur_taps_c():
    return (ctypes.c_float * 7)(*_blur_taps_bf16())


def build_kernel() -> None:
    """Compile and load K1 and K1b now (otherwise at the first launch)."""
    _entry(_SOURCE, "vxs_fast_harris_blur")
    _entry(_SOURCE, "vxs_fast_harris_score")


def fast_harris_blur(img16: torch.Tensor, mask: torch.Tensor,
                     threshold: float = 20.0):
    """Fused detection + blur over a batch of atlases.

    img16: bf16 [B,H,W] contiguous; mask: int8 [H,W] border mask (1 =
    allowed), shared by the batch, on the same device. Returns
    (score f32 [B,H,W] — NEG where not a surviving masked corner,
    blur bf16 [B,H,W])."""
    if img16.dtype != torch.bfloat16 or img16.dim() != 3:
        raise ValueError(f"img16 must be bf16 [B,H,W], got {img16.dtype} "
                         f"{tuple(img16.shape)}")
    if mask.dtype != torch.int8 or tuple(mask.shape) != tuple(img16.shape[1:]):
        raise ValueError(f"mask must be int8 {tuple(img16.shape[1:])}, got "
                         f"{mask.dtype} {tuple(mask.shape)}")
    if mask.device != img16.device:
        raise ValueError("img16 and mask must be on the same device")
    if not (img16.is_contiguous() and mask.is_contiguous()):
        raise ValueError("img16 and mask must be contiguous")
    if img16.device.type == "cpu":
        return fast_harris_blur_reference(img16, mask, threshold)
    if img16.device.type != "cuda":
        raise ValueError(f"unsupported device {img16.device}")

    global launches
    B, H, W = img16.shape
    score = torch.empty((B, H, W), dtype=torch.float32, device=img16.device)
    blur = torch.empty_like(img16)
    if score.numel() == 0:
        return score, blur
    k1 = _entry(_SOURCE, "vxs_fast_harris_blur")
    with torch.cuda.device(img16.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = k1(img16.data_ptr(), mask.data_ptr(), score.data_ptr(),
                 blur.data_ptr(), B, H, W, float(threshold), _blur_taps_c(),
                 stream)
    if err != 0:
        raise RuntimeError(f"K1 launch failed with CUDA error {err}")
    launches += 1
    return score, blur


def fast_harris_blur_reference(img16: torch.Tensor, mask: torch.Tensor,
                               threshold: float = 20.0):
    """The plain PyTorch version of K1: the same function, the same edge
    padding (replicate) and the same rounding points (bf16 after every
    Sobel/box/blur multiply and add, f32 compares and det/trace)."""
    B, H, W = img16.shape
    P = 5  # halo: FAST radius 3 + NMS 1, or Sobel 1 + box 3 + NMS 1
    x = F.pad(img16.float()[:, None], (P, P, P, P), mode="replicate")[:, 0]
    x16 = x.to(torch.bfloat16)  # exact: the values came from bf16

    def win(a, oy, ox, h, w):  # rows [oy, oy+h), cols [ox, ox+w) of padded a
        return a[:, oy:oy + h, ox:ox + w]

    # ---- FAST-9/16 over the NMS region (virtual rows/cols [-1, H+1)) ----
    H2, W2 = H + 2, W + 2
    center = win(x, P - 1, P - 1, H2, W2)
    hi = center + threshold
    lo = center - threshold
    bright = torch.zeros_like(center, dtype=torch.int64)
    dark = torch.zeros_like(bright)
    for i, (dy, dx) in enumerate(FAST_CIRCLE):
        tap = win(x, P - 1 + int(dy), P - 1 + int(dx), H2, W2)
        bright |= (tap > hi).long() << i
        dark |= (tap < lo).long() << i

    def run9(m):
        r = m | (m << 16)
        y = r & (r >> 1)
        y = y & (y >> 2)
        y = y & (y >> 4)
        y = y & (r >> 8)
        return (y & 0xFFFF) != 0

    corner2 = run9(bright) | run9(dark)  # [B,H2,W2]

    # ---- Harris over the same region: Sobel over virtual [-4, H+4) ----
    HB, WB = H2 + 6, W2 + 6
    up = win(x16, 0, 0, HB, WB + 2)
    mid = win(x16, 1, 0, HB, WB + 2)
    dn = win(x16, 2, 0, HB, WB + 2)
    rows_s = mid * 2.0 + up + dn
    rows_d = dn - up
    dxi = (rows_s[:, :, 2:2 + WB] - rows_s[:, :, 0:WB]) * 0.25
    dyi = (rows_d[:, :, 0:WB] + 2.0 * rows_d[:, :, 1:1 + WB]
           + rows_d[:, :, 2:2 + WB]) * 0.25

    def box7(a):  # [B,HB,WB] bf16 -> [B,H2,W2], bf16 accumulation in order
        acc = a[:, 0:H2, :]
        for k in range(1, HARRIS_BLOCK):
            acc = acc + a[:, k:k + H2, :]
        out = acc[:, :, 0:W2]
        for k in range(1, HARRIS_BLOCK):
            out = out + acc[:, :, k:k + W2]
        return out.float()

    sxx = box7(dxi * dxi)
    syy = box7(dyi * dyi)
    sxy = box7(dxi * dyi)
    det = sxx * syy - sxy * sxy
    tr = sxx + syy
    harris2 = det - HARRIS_K * tr * tr

    # ---- masked 3x3 NMS + border mask ----
    masked2 = torch.where(corner2, harris2, torch.full_like(harris2, NEG))
    nmax = torch.full((B, H, W), NEG, dtype=torch.float32, device=x.device)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if (dy, dx) != (0, 0):
                nmax = torch.maximum(
                    nmax, masked2[:, 1 + dy:1 + dy + H, 1 + dx:1 + dx + W])
    center_m = masked2[:, 1:1 + H, 1:1 + W]
    keep = (center_m >= nmax) & (mask != 0)[None]
    score = torch.where(keep, center_m, torch.full_like(center_m, NEG))

    # ---- 7-tap Gaussian blur, vertical then horizontal, bf16 ----
    taps = _blur_taps_bf16()
    racc = None
    for k, w in enumerate(taps):
        term = w * win(x16, P - 3 + k, P - 3, H, W + 6)
        racc = term if racc is None else racc + term
    blur = None
    for k, w in enumerate(taps):
        term = w * racc[:, :, k:k + W]
        blur = term if blur is None else blur + term
    return score, blur


def _check_score_input(img: torch.Tensor) -> None:
    if img.dim() not in (2, 3) or not img.is_floating_point():
        raise ValueError(f"img must be a float [H,W] or [B,H,W] image, got "
                         f"{img.dtype} {tuple(img.shape)}")


def fast_harris_score(img: torch.Tensor, threshold: float = 20.0) -> torch.Tensor:
    """K1b: FAST + Harris + NMS score of a float image [H,W] or [B,H,W]
    (rounded to bf16), no border mask (callers mask downstream); f32 score
    of the input's shape, ``NEG`` off-corner. One kernel launch for a float32
    CUDA tensor (another float type is cast to float32 first); the plain
    version for a CPU tensor."""
    _check_score_input(img)
    if img.device.type == "cpu":
        return fast_harris_score_reference(img, threshold)
    if img.device.type != "cuda":
        raise ValueError(f"unsupported device {img.device}")

    global score_launches
    x = img.to(torch.float32).contiguous()
    B, H, W = (1, *x.shape) if x.dim() == 2 else x.shape
    score = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    if score.numel() == 0:
        return score
    k1b = _entry(_SOURCE, "vxs_fast_harris_score")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = k1b(x.data_ptr(), score.data_ptr(), B, H, W, float(threshold),
                  stream)
    if err != 0:
        raise RuntimeError(f"K1b launch failed with CUDA error {err}")
    score_launches += 1
    return score


def fast_harris_score_reference(img: torch.Tensor,
                                threshold: float = 20.0) -> torch.Tensor:
    """The plain PyTorch version of K1b: K1's plain version on the image
    cast to bf16, with an all-ones mask."""
    _check_score_input(img)
    x = (img[None] if img.dim() == 2 else img).to(torch.bfloat16).contiguous()
    mask = torch.ones(x.shape[1:], dtype=torch.int8, device=x.device)
    score, _ = fast_harris_blur_reference(x, mask, threshold)
    return score[0] if img.dim() == 2 else score
