"""ORB on tensors: pyramid atlas -> K1 (FAST-9 + Harris + NMS + blur) ->
per-level grid top-K -> orientation -> steered BRIEF-256.

Counterpart of ``visionx_slam_tpu/models/orb_jax.py::orb_extract`` with the
same defaults (1000 features, scale 1.2, 8 levels, 1024 slots, FAST
threshold 20, border 31) and the same numpy tables (copied here: the JAX
module imports jax). Batched over frames: ``gray_u8`` is [B,H,W].

The pyramid equals the JAX package's bit for bit. Each level is
``jax.image.resize(method="linear")`` on downscale, which is two dense
products with antialiased triangle-kernel weight matrices
(``resize_weights``, a numpy copy of JAX's construction). In the default
(``resize_f32=0``, the JAX default) the image is bf16 and so are the
weights: the height pass is rounded to bf16, then the width pass. Each
product of a bf16 weight with a bf16 value has at most 16 significant
bits, but a sum of them can span more than float32's 24 (a small tail
weight times a small value next to a large product), so a float32 sum
depends on its order. The default build therefore sums in float64, where
every such sum of this pyramid (under 52 bits from the largest product to
the smallest bit) is exact in any order, then rounds through float32 to
bf16: CPU and CUDA give the same bits. JAX's float32 sums equal the exact
sum after that rounding on the rendered test frames (tests/test_torch_orb.py).
``resize_f32=1`` (the JAX package's option of that name) keeps both passes
in float32 with float32 weights and rounds the level once.

Differences from the JAX path, none of which changes a value:
- detection runs K1 over the whole [B, atlas_rows, W] chunk at once;
- patches are gathered directly (the space-to-depth + one-hot einsums of
  the JAX path only served the TPU) and BRIEF gathers the rotated sample
  pairs instead of contracting the difference bank; both give the same
  integers.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ..ops import detect
from ..ops.detect import FAST_CIRCLE, NEG, _gaussian_kernel1d, fast_harris_blur
from ..ops.index import stable_argsort, stable_topk
from ..utils.logging import count_sync

__all__ = ["FAST_CIRCLE", "_gaussian_kernel1d", "brief_pattern", "build_atlas",
           "orb_extract", "resize_weights"]

HALF_PATCH = 15          # orientation disc radius
BRIEF_RADIUS = 13        # pattern points live in [-13, 13]
PATCH_R = 15
PATCH_S = 2 * PATCH_R + 1
BRIEF_BINS = 32
CELL = 8


def brief_pattern(seed: int = 12345, n_pairs: int = 256) -> np.ndarray:
    """Deterministic BRIEF pattern: [n_pairs, 2, 2] int offsets (y, x),
    Gaussian(0, (2*13/5)^2) pairs clipped to the radius-13 disc."""
    rng = np.random.RandomState(seed)
    sigma = 2.0 * BRIEF_RADIUS / 5.0
    pts = rng.normal(0.0, sigma, size=(n_pairs, 2, 2))
    r = np.linalg.norm(pts, axis=-1, keepdims=True)
    pts = np.where(r > BRIEF_RADIUS, pts * (BRIEF_RADIUS / np.maximum(r, 1e-9)), pts)
    pts = np.round(pts).astype(np.int32)
    same = np.all(pts[:, 0] == pts[:, 1], axis=-1)
    pts[same, 1, 0] += 1
    return pts


_PATTERN = brief_pattern()


def _level_quotas(n_features: int, n_levels: int, scale: float) -> list[int]:
    """Per-level feature budget, geometric in 1/scale (OpenCV ORB scheme)."""
    q = 1.0 / scale
    first = n_features * (1 - q) / (1 - q**n_levels)
    quotas = [int(round(first * q**i)) for i in range(n_levels - 1)]
    quotas.append(max(n_features - sum(quotas), 0))
    return quotas


@functools.lru_cache(maxsize=2)
def _brief_bank(A: int = BRIEF_BINS) -> np.ndarray:
    """Difference banks [PATCH_S^2, A*256]: +1 at the first rotated sample
    and -1 at the second, per orientation bin."""
    pat = _PATTERN.astype(np.float32)
    py, px = pat[:, :, 0], pat[:, :, 1]
    D = np.zeros((PATCH_S * PATCH_S, A * 256), np.float32)
    cols = np.arange(256)
    for a in range(A):
        th = 2.0 * np.pi * a / A
        ca, sa = np.cos(th), np.sin(th)
        ry = np.round(px * sa + py * ca).astype(np.int64)
        rx = np.round(px * ca - py * sa).astype(np.int64)
        lin = (ry + PATCH_R) * PATCH_S + (rx + PATCH_R)
        np.add.at(D, (lin[:, 0], a * 256 + cols), 1.0)
        np.add.at(D, (lin[:, 1], a * 256 + cols), -1.0)
    return D


@functools.lru_cache(maxsize=2)
def _brief_pairs(A: int = BRIEF_BINS) -> tuple[np.ndarray, np.ndarray]:
    """The bank as sample indices: (plus [A,256], minus [A,256]) flat patch
    positions. A column whose two samples coincide holds no +-1; both
    indices are then 0 and the difference is 0, as the bank gives."""
    D = _brief_bank(A)
    plus = np.argmax(D == 1.0, axis=0).reshape(A, 256)
    minus = np.argmax(D == -1.0, axis=0).reshape(A, 256)
    return plus, minus


@functools.lru_cache(maxsize=8)
def _atlas_layout(H: int, W: int, n_levels: int, scale_factor: float,
                  border: int):
    """Greedy shelf packing of the pyramid levels into one [total, W]
    atlas, every placement 8-aligned. Returns (placements (oy,ox,h,w) per
    level, total rows, border mask)."""
    dims = []
    for lvl in range(n_levels):
        s = scale_factor**lvl
        dims.append((int(round(H / s)), int(round(W / s))))
    place = []
    y = 0
    shelf_h = 0
    x = 0
    for (h, w) in dims:
        wa = -(-w // 8) * 8
        if x + wa > W:
            y += -(-shelf_h // 8) * 8
            x, shelf_h = 0, 0
        place.append((y, x, h, w))
        x += wa
        shelf_h = max(shelf_h, h)
    total = y + -(-shelf_h // 8) * 8
    mask = np.zeros((total, W), bool)
    for (oy, ox, h, w) in place:
        mask[oy + border : oy + h - border,
             ox + border : ox + w - border] = True
    return tuple(place), total, mask


@functools.lru_cache(maxsize=16)
def _device_tables(H, W, n_levels, scale_factor, border, device):
    """Per-device constants: border mask (int8), orientation weights,
    BRIEF sample indices."""
    _, _, mask = _atlas_layout(H, W, n_levels, scale_factor, border)
    ys, xs = np.mgrid[-PATCH_R : PATCH_R + 1, -PATCH_R : PATCH_R + 1]
    disc = (xs**2 + ys**2 <= HALF_PATCH**2).astype(np.float32)
    wxy = np.stack([(xs * disc).reshape(-1), (ys * disc).reshape(-1)], -1)
    plus, minus = _brief_pairs(BRIEF_BINS)
    dev = torch.device(device)
    return (torch.from_numpy(mask.astype(np.int8)).to(dev),
            torch.from_numpy(wxy.astype(np.float32)).to(dev),
            torch.from_numpy(plus).to(dev),
            torch.from_numpy(minus).to(dev))


@functools.lru_cache(maxsize=64)
def resize_weights(in_size: int, out_size: int) -> np.ndarray:
    """[out, in] float32 weights of ``jax.image.resize(method="linear")``
    along one axis on downscale: half-pixel centres, a triangle kernel
    widened by the scale (antialiasing), columns normalized to sum 1, zero
    where the sample falls outside the input
    (``jax/_src/image/scale.py::compute_weight_mat``).

    The float32 steps follow what XLA's CPU compiler makes of that code:
    the sample position as one fused multiply-add, the division by the
    kernel scale as a product with its reciprocal. A few weights still
    differ from JAX's in their last float32 bit (summation order); rounded
    to bf16, as the default pyramid uses them, every weight of every level
    of a 640x480 pyramid is equal (tests/test_torch_orb.py)."""
    f32 = np.float32
    inv_scale = 1.0 / (out_size / in_size)     # a Python float in JAX too
    kernel_scale = f32(max(inv_scale, 1.0))
    a = np.arange(out_size, dtype=np.float64) + 0.5
    sample_f = (a * np.float64(f32(inv_scale)) - 0.5).astype(f32)
    x = (np.abs(sample_f[None, :] - np.arange(in_size, dtype=f32)[:, None])
         * (f32(1.0) / kernel_scale))
    w = np.maximum(f32(0.0), f32(1.0) - x)
    total = w.sum(axis=0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > f32(1000.0 * np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return np.where(inside[None, :], w, f32(0.0)).T.astype(f32)


@functools.lru_cache(maxsize=16)
def _resize_mats(H, W, n_levels, scale_factor, border, resize_f32, device):
    """Per level > 0: (height weights [h,H], width weights transposed
    [W,w]) on the device, bf16-rounded unless ``resize_f32``."""
    place, _, _ = _atlas_layout(H, W, n_levels, scale_factor, border)
    dev = torch.device(device)
    out = []
    for (_, _, h, w) in place[1:]:
        mats = [torch.from_numpy(resize_weights(H, h)),
                torch.from_numpy(resize_weights(W, w)).T.contiguous()]
        if not resize_f32:
            mats = [m.to(torch.bfloat16).double() for m in mats]
        out.append(tuple(m.to(dev) for m in mats))
    return out


def build_atlas(gray_u8: torch.Tensor, scale_factor: float = 1.2,
                n_levels: int = 8, border: int = 31, resize_f32: int = 0):
    """The shelf-packed pyramid atlas of a batch of frames and its border
    mask: (atlas bf16 [B,rows,W], mask int8 [rows,W]) — K1's inputs."""
    B, H, W = gray_u8.shape
    dev = gray_u8.device
    place, total_rows, _ = _atlas_layout(H, W, n_levels, scale_factor, border)
    mask = _device_tables(H, W, n_levels, scale_factor, border, str(dev))[0]
    mats = _resize_mats(H, W, n_levels, scale_factor, border, bool(resize_f32),
                        str(dev))
    img0 = gray_u8.float() if resize_f32 else gray_u8.double()
    atlas = torch.zeros((B, total_rows, W), dtype=torch.bfloat16, device=dev)
    oy, ox, _, _ = place[0]
    atlas[:, oy:oy + H, ox:ox + W] = img0.to(torch.bfloat16)
    for (oy, ox, h, w), (Wh, WwT) in zip(place[1:], mats):
        rows = Wh @ img0                                   # [B,h,W]
        if not resize_f32:   # exact float64 sums, rounded as JAX rounds
            rows = rows.float().to(torch.bfloat16).double()
        atlas[:, oy:oy + h, ox:ox + w] = (rows @ WwT).float().to(torch.bfloat16)
    return atlas, mask


def orb_extract(
    gray_u8: torch.Tensor,  # [B,H,W] uint8
    n_features: int = 1000,
    scale_factor: float = 1.2,
    n_levels: int = 8,
    n_slots: int = 1024,
    fast_threshold: float = 20.0,
    border: int = 31,
    resize_f32: int = 0,
    use_kernel: int = -1,
):
    """Full ORB: returns (px [B,S,2] level-0 pixels (x, y), resp [B,S],
    desc [B,S,32] uint8, valid [B,S]) with S = n_slots.

    ``use_kernel`` (the JAX ``use_pallas``): -1 runs the dense passes as
    ``fast_harris_blur`` does (K1 on a CUDA tensor, its plain version on a
    CPU tensor), 0 the plain version on either device, 1 K1 (raises on the
    CPU)."""
    B, H, W = gray_u8.shape
    dev = gray_u8.device
    quotas = _level_quotas(n_features, n_levels, scale_factor)
    place, total_rows, _ = _atlas_layout(H, W, n_levels, scale_factor, border)
    _, wxy, brief_plus, brief_minus = _device_tables(
        H, W, n_levels, scale_factor, border, str(dev))
    atlas, mask = build_atlas(gray_u8, scale_factor, n_levels, border, resize_f32)

    # ---- dense passes: K1 on the whole chunk ----
    if use_kernel == 0:
        with detect.k1_unit(atlas.shape):
            raw, blurred = detect.fast_harris_blur_reference(atlas, mask,
                                                             fast_threshold)
    elif use_kernel == 1 and atlas.device.type != "cuda":
        raise ValueError(f"use_kernel=1 launches K1, which needs a CUDA tensor, "
                         f"not {atlas.device}")
    else:
        raw, blurred = fast_harris_blur(atlas, mask, fast_threshold)
    score = torch.where(raw > 0.5 * NEG, raw, -math.inf)

    # ---- per-level grid-bucketed top-K: cell argmax, stable top-k ----
    all_yy, all_xx, all_lxy, all_resp = [], [], [], []
    for lvl, (oy, ox, h, w) in enumerate(place):
        hp = -(-h // CELL) * CELL
        wa = -(-w // CELL) * CELL
        Hc, Wc = hp // CELL, wa // CELL
        cells = score[:, oy:oy + hp, ox:ox + wa].reshape(
            B, Hc, CELL, Wc, CELL).permute(0, 1, 3, 2, 4).reshape(
            B, Hc * Wc, CELL * CELL)
        cell_arg = torch.argmax(cells, dim=-1)           # first max
        cell_max = torch.gather(cells, -1, cell_arg[..., None])[..., 0]
        top, cidx = stable_topk(cell_max, quotas[lvl])
        off_in = torch.gather(cell_arg, 1, cidx)
        yy = (cidx // Wc) * CELL + off_in // CELL       # level-local
        xx = (cidx % Wc) * CELL + off_in % CELL
        all_yy.append(yy + oy)                           # atlas coords
        all_xx.append(xx + ox)
        all_lxy.append(torch.stack([xx.float(), yy.float()], -1)
                       * float(np.float32(scale_factor**lvl)))
        all_resp.append(top)
    yy = torch.cat(all_yy, 1)
    xx = torch.cat(all_xx, 1)
    top = torch.cat(all_resp, 1)
    valid = torch.isfinite(top)
    resp = torch.where(valid, top, 0.0)
    xy = torch.cat(all_lxy, 1)
    Q = yy.shape[1]

    # ---- 31x31 blurred patches by direct gather ----
    # valid keypoints sit >= border px inside their level, so their patches
    # never leave it; dead slots are clamped into the atlas (masked later)
    off = torch.arange(-PATCH_R, PATCH_R + 1, device=dev)
    rows = (yy[..., None] + off).clamp(0, total_rows - 1)   # [B,Q,31]
    cols = (xx[..., None] + off).clamp(0, W - 1)
    bidx = torch.arange(B, device=dev)[:, None, None, None]
    patches = blurred[bidx, rows[..., :, None], cols[..., None, :]]
    flat = patches.reshape(B, Q, PATCH_S * PATCH_S)

    # ---- intensity-centroid orientation (f32 accumulation) ----
    m = flat.float() @ wxy                                  # (m10, m01)
    angles = torch.atan2(m[..., 1], m[..., 0])

    # ---- steered BRIEF: exact integer differences of rounded samples ----
    A = BRIEF_BINS
    bins = torch.remainder(torch.round(angles / (2.0 * np.pi / A)).long(), A)
    flat_i = torch.clamp(torch.round(flat.float()), 0.0, 255.0).int() - 128
    va = torch.gather(flat_i, -1, brief_plus[bins])         # [B,Q,256]
    vb = torch.gather(flat_i, -1, brief_minus[bins])
    bits = (va - vb < 0).int().reshape(B, Q, 32, 8)
    weights = 2 ** torch.arange(8, device=dev, dtype=torch.int32)
    desc = (bits * weights).sum(-1).to(torch.uint8)         # LSB first
    return _compact(xy, resp, desc, valid, n_slots)


def _compact(xy, resp, desc, valid, S: int):
    """The keypoints of [B,Q] slots in ``S`` slots, valid first, ordered by
    level: (px, resp, desc, valid)."""
    B, Q = valid.shape
    if Q < S:
        pad = S - Q
        xy = torch.cat([xy, xy.new_zeros(B, pad, 2)], 1)
        resp = torch.cat([resp, resp.new_zeros(B, pad)], 1)
        desc = torch.cat([desc, desc.new_zeros(B, pad, 32)], 1)
        valid = torch.cat([valid, valid.new_zeros(B, pad)], 1)
    else:
        order = stable_argsort((~valid).int(), dim=1)[:, :S]
        xy = torch.gather(xy, 1, order[..., None].expand(-1, -1, 2))
        resp = torch.gather(resp, 1, order)
        desc = torch.gather(desc, 1, order[..., None].expand(-1, -1, 32))
        valid = torch.gather(valid, 1, order)
    return xy, resp, desc, valid


class TorchOrbExtractor:
    """The on-device ORB with the host extractor protocol (numpy image in,
    numpy ``(px, resp, desc, valid)`` out), the counterpart of the JAX
    package's ``JaxOrbExtractor``. One frame is a one-frame atlas: on a
    CUDA ``device`` every ``extract`` launches kernel K1 once."""

    def __init__(self, n_features: int = 1000, scale_factor: float = 1.2,
                 n_levels: int = 8, n_slots: int = 1024,
                 fast_threshold: float = 20.0, resize_f32: bool = False,
                 device="cuda"):
        self.kwargs = dict(
            n_features=n_features, scale_factor=scale_factor,
            n_levels=n_levels, n_slots=n_slots, fast_threshold=fast_threshold,
            resize_f32=int(resize_f32),
        )
        self.n_slots = n_slots
        self.device = torch.device(device)

    def extract(self, gray: np.ndarray):
        """gray uint8 [H,W] -> (px [S,2] f32, resp [S] f32, desc [S,32] u8,
        valid [S] bool), S = n_slots; counts its copies in and out on the
        stage clock."""
        g = torch.as_tensor(gray).to(self.device)
        count_sync(5)               # the image's copy in, the four out
        return tuple(x[0].cpu().numpy() for x in orb_extract(g[None], **self.kwargs))
