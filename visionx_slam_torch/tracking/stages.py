"""Per-frame helpers of the tracking stages (subset of
``visionx_slam_tpu/tracking/stages.py``), batched over frames."""

from __future__ import annotations

import torch

from ..models.matching import MatchResult

MIN_DEPTH = 0.1
MAX_DEPTH = 10.0


def sample_depth_image(depth_img: torch.Tensor, px: torch.Tensor,
                       valid: torch.Tensor) -> torch.Tensor:
    """Depth at the rounded keypoint pixel; 0 where out of bounds or
    invalid. depth_img [B,H,W], px [B,N,2], valid [B,N] -> [B,N]."""
    B, H, W = depth_img.shape
    u = torch.round(px[..., 0]).long()
    v = torch.round(px[..., 1]).long()
    ok = valid & (u >= 0) & (u < W) & (v >= 0) & (v < H)
    lin = v.clamp(0, H - 1) * W + u.clamp(0, W - 1)
    d = torch.gather(depth_img.reshape(B, H * W), 1, lin)
    return torch.where(ok, d, 0.0)


def parallax_px(px_a: torch.Tensor, px_b: torch.Tensor,
                res: MatchResult) -> torch.Tensor:
    """Mean pixel displacement over matches, per pair: px [P,N,2] -> [P]."""
    px_m = torch.gather(px_b, -2, res.idx[..., None].expand(*res.idx.shape, 2))
    d = torch.linalg.norm(px_a - px_m, dim=-1)
    cnt = res.valid.sum(-1)
    tot = torch.where(res.valid, d, 0.0).sum(-1)
    return torch.where(cnt > 0, tot / cnt.clamp(min=1), 0.0)
