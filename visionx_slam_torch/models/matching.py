"""Brute-force 2-NN Hamming matching (counterpart of
``visionx_slam_tpu/models/matching.py``), batched over frame pairs.

hamming(a, b) = |a| + |b| - 2 <a, b> on {0,1}^256 bit planes: the inner
products are one float32 matmul (exact: every sum is an integer <= 256), so
every distance, index and decision is integer-exact against the JAX path.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils.logging import span

BIG = 1e9
NN_RATIO = 0.8          # reference orb_matcher.h:14
MIN_DIST_FLOOR = 30.0   # reference tracking.cpp:218 max(2*min_dist, 30)
MIN_DIST_INIT = 100.0   # reference tracking.cpp:212/294
# the mask value the JAX path writes into its bf16 distance matrix
_BIG_BF16 = float(torch.tensor(BIG).to(torch.bfloat16))


class MatchResult(NamedTuple):
    """Row i describes query descriptor i (leading dims are batch)."""

    idx: torch.Tensor    # [..., N] int64 best-match index into the train set
    dist: torch.Tensor   # [..., N] float32 Hamming distance of the best match
    valid: torch.Tensor  # [..., N] bool, a ratio-test match exists


def unpack_bits(desc_u8: torch.Tensor) -> torch.Tensor:
    """uint8 [..., 32] -> {0,1} float32 bit planes [..., 256], LSB first."""
    shifts = torch.arange(8, device=desc_u8.device, dtype=torch.uint8)
    bits = (desc_u8[..., :, None] >> shifts) & 1
    return bits.reshape(*desc_u8.shape[:-1], desc_u8.shape[-1] * 8).float()


def hamming_matrix(desc_a: torch.Tensor, desc_b: torch.Tensor) -> torch.Tensor:
    """Hamming distances [..., N, M] (float32, integer-valued) from uint8
    descriptors [..., N, 32] / [..., M, 32]."""
    a = unpack_bits(desc_a)
    b = unpack_bits(desc_b)
    dot = a @ b.transpose(-1, -2)
    return a.sum(-1)[..., :, None] + b.sum(-1)[..., None, :] - 2.0 * dot


def unpack_with_pop(desc_u8: torch.Tensor):
    """(bit planes bf16 [..., 256], popcounts f32 [...]) of descriptors. The
    scan computes these once per frame, ahead of its serial loop, and
    carries the reference keyframe's copy. bf16 holds 0/1 exactly, and every
    inner product of two planes is an integer <= 256, exact in bf16 too."""
    bits = unpack_bits(desc_u8)
    return bits.to(torch.bfloat16), bits.sum(-1)


def knn2_from_bits(bits_a: torch.Tensor, pop_a: torch.Tensor,
                   valid_a: torch.Tensor, bits_b: torch.Tensor,
                   pop_b: torch.Tensor, valid_b: torch.Tensor,
                   nn_ratio: float = NN_RATIO) -> MatchResult:
    """``knn2_ratio_match`` on pre-unpacked bit planes (bit-identical)."""
    dot = (bits_a @ bits_b.transpose(-1, -2)).float()
    D = pop_a[..., :, None] + pop_b[..., None, :] - 2.0 * dot
    return _knn2_select(D, valid_a, valid_b, nn_ratio)


def knn2_ratio_match(desc_a: torch.Tensor, valid_a: torch.Tensor,
                     desc_b: torch.Tensor, valid_b: torch.Tensor,
                     nn_ratio: float = NN_RATIO) -> MatchResult:
    """2-NN + Lowe ratio matching, without the distance filter."""
    return _knn2_select(hamming_matrix(desc_a, desc_b), valid_a, valid_b,
                        nn_ratio)


def _knn2_select(D: torch.Tensor, valid_a: torch.Tensor,
                 valid_b: torch.Tensor, nn_ratio: float) -> MatchResult:
    """Top-2 + ratio selection over a distance matrix [..., N, M]."""
    D = torch.where(valid_b[..., None, :], D, _BIG_BF16)
    idx1 = torch.argmin(D, dim=-1)                       # first min
    d1 = torch.gather(D, -1, idx1[..., None])[..., 0]
    D2 = D.scatter(-1, idx1[..., None], _BIG_BF16)
    d2 = D2.min(dim=-1).values
    ok = (d1 < nn_ratio * d2) & valid_a & (d1 <= 256.0)
    return MatchResult(idx1, d1, ok)


def reference_distance_filter(res: MatchResult) -> MatchResult:
    """Keep d <= max(2*min_dist, 30), min_dist initialized at 100
    (tracking.cpp:212-222); per batch row."""
    dmin = torch.where(res.valid, res.dist, MIN_DIST_INIT).min(dim=-1).values
    dmin = torch.clamp(dmin, max=MIN_DIST_INIT)
    thresh = torch.clamp(2.0 * dmin, min=MIN_DIST_FLOOR)
    return MatchResult(res.idx, res.dist, res.valid & (res.dist <= thresh[..., None]))


def match_frames(desc_a: torch.Tensor, valid_a: torch.Tensor,
                 desc_b: torch.Tensor, valid_b: torch.Tensor,
                 nn_ratio: float = NN_RATIO) -> MatchResult:
    """knn2 ratio match + the reference distance filter, batched over
    leading dims: desc [..., N, 32] uint8, valid [..., N] bool. Ends the
    stage clock's ``match`` span."""
    res = reference_distance_filter(
        knn2_ratio_match(desc_a, valid_a, desc_b, valid_b, nn_ratio))
    span("match")
    return res


def match_frames_batched(desc_a: torch.Tensor, valid_a: torch.Tensor,
                         desc_b: torch.Tensor, valid_b: torch.Tensor,
                         nn_ratio: float = NN_RATIO) -> MatchResult:
    """``match_frames`` over a leading batch of frame pairs (the JAX
    package's ``jax.vmap`` of it): desc [B, N, 32] uint8, valid [B, N] bool
    -> a ``MatchResult`` of [B, N]; each pair's distance filter sees only
    its own matches."""
    if desc_a.dim() != 3 or desc_b.dim() != 3:
        raise ValueError(f"descriptors [B, N, 32] expected, got "
                         f"{tuple(desc_a.shape)} and {tuple(desc_b.shape)}")
    if desc_a.shape[0] != desc_b.shape[0]:
        raise ValueError(f"{desc_a.shape[0]} query frames against "
                         f"{desc_b.shape[0]} train frames")
    return match_frames(desc_a, valid_a, desc_b, valid_b, nn_ratio)
