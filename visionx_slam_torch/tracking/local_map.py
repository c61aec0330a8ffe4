"""Tracking against the local map, a widening of the port beyond the
reference (``TrackingOptions.track_local_map``, off by default).

The scan tracks a frame against its last keyframe's landmarks alone, so the
error of each keyframe's pose is carried into the next like odometry. With
this step, once the frame's PnP against its keyframe has succeeded, the
landmarks of the ring's keyframes before it (the local BA window's, newest
first) are projected with the frame's pose and matched to the frame's
features by Hamming distance inside a pixel radius; the pose is then refined
on the union of those matches and the keyframe PnP's inliers by one pose
Gauss-Newton call (kernel K2 on the card). Everything runs on the device,
with no host read: the slots come from the host's copy of the ring cursor,
the tables by slices.

``search`` is the projection and the match; ``track_local_map`` adds the
refinement. The stage clock's ``localmap`` span ends after the search, and
the refinement's GN call ends a ``gn`` span."""

from __future__ import annotations

import torch

from ..models import matching
from ..models.estimation import _pose_gn_refine
from ..ops.camera import CameraParams, project_pinhole
from ..ops.se3 import Pose
from ..utils.logging import span
from .mapstate import MapState

RADIUS_PX = 8.0       # a landmark's match lies this close to its projection
MAX_HAMMING = 50.0    # and is at most this far in descriptor space
GN_ITERS = 4          # robust GN steps of the refinement


def ring_rows(x: torch.Tensor, first: int, n: int) -> torch.Tensor:
    """Rows ``first``, ``first + 1``, ..., ``first + n - 1`` of the ring
    table ``x`` (modulo its length) by slices: no index tensor is made
    from host values."""
    K = x.shape[0]
    first %= K
    if first + n <= K:
        return x[first:first + n]
    return torch.cat([x[first:], x[:first + n - K]])


def search(ms: MapState, cam: CameraParams, pose: Pose, px: torch.Tensor,
           valid: torch.Tensor, bits: torch.Tensor, pop: torch.Tensor,
           first: int, n: int, used: torch.Tensor, taken: torch.Tensor,
           img_wh: tuple[int, int]):
    """Matches of the landmarks linked from ring slots ``first`` ..
    ``first + n - 1`` to the frame's features (``px`` [N,2], ``valid``
    [N], their bit planes ``bits`` [N,256] and popcounts ``pop`` [N]) at
    ``pose``: each landmark that projects inside the image is matched to the
    nearest valid feature in Hamming distance within ``RADIUS_PX`` pixels of
    its projection, kept at most ``MAX_HAMMING``; a landmark listed by two
    slots counts once (its first row), ``used`` [N] features (the keyframe
    PnP's) and ``taken`` [Lp] landmarks (the keyframe's) take none, and
    each feature keeps its nearest landmark (ties: the lowest row).
    Returns (landmark positions [M,3], matched pixels [M,2], accepted [M]
    bool) over the M = n x N rows."""
    dev = px.device
    Lp = ms.lm_physical
    lm = ring_rows(ms.kf_feat_lm, first, n).reshape(-1)
    alive = ring_rows(ms.kf_id, first, n) >= 0
    fvalid = (ring_rows(ms.kf_fvalid, first, n) & alive[:, None]).reshape(-1)
    lmc = lm.clamp(0, Lp - 1).long()
    X = ms.lm_pos[:, lmc].T
    M = lm.shape[0]
    rows = torch.arange(M, device=dev)
    ok = (fvalid & (lm >= 0) & ms.lm_alive[lmc] & torch.isfinite(X).all(-1)
          & ~taken[lmc])
    # a landmark linked from two slots: its first row only (row Lp: none)
    at = torch.where(ok, lmc, Lp)
    first_row = torch.full((Lp + 1,), M, device=dev).scatter_reduce(
        0, at, rows, "amin")
    ok = ok & (first_row[at] == rows)
    uv, front, _ = project_pinhole(cam, pose, X)
    W_IMG, H_IMG = img_wh
    ok = (ok & front & (uv[:, 0] >= 0) & (uv[:, 0] < W_IMG)
          & (uv[:, 1] >= 0) & (uv[:, 1] < H_IMG))
    # Hamming distances in the dense bit-plane form, gated by the radius
    wbits, wpop = matching.unpack_with_pop(
        ring_rows(ms.kf_desc, first, n).reshape(M, -1))
    D = wpop[:, None] + pop[None, :] - 2.0 * (wbits @ bits.T).float()
    near = ((uv[:, None, :] - px[None, :, :]) ** 2).sum(-1) <= RADIUS_PX ** 2
    D = torch.where(near & ok[:, None] & (valid & ~used)[None, :], D,
                    torch.inf)
    d1, j = D.min(dim=1)
    acc = d1 <= MAX_HAMMING
    # each feature keeps its nearest landmark, then the lowest row
    N = px.shape[0]
    at = torch.where(acc, j, N)
    best = torch.full((N + 1,), torch.inf, device=dev).scatter_reduce(
        0, at, d1, "amin")
    acc = acc & (d1 == best[at])
    at = torch.where(acc, j, N)
    low = torch.full((N + 1,), M, device=dev).scatter_reduce(0, at, rows, "amin")
    acc = acc & (low[at] == rows)
    return torch.where(acc[:, None], X, 0.0), px[j], acc


def track_local_map(ms: MapState, cam: CameraParams, pose: Pose,
                    px: torch.Tensor, valid: torch.Tensor, bits: torch.Tensor,
                    pop: torch.Tensor, kf_pts: torch.Tensor,
                    kf_px: torch.Tensor, kf_inliers: torch.Tensor,
                    kf_feature: torch.Tensor, kf_lm: torch.Tensor,
                    first: int, n: int, img_wh: tuple[int, int],
                    reproj_thresh: float):
    """The frame's pose refined on its keyframe PnP's inliers (landmarks
    ``kf_pts`` [N,3] seen at ``kf_px`` [N,2], ``kf_inliers`` [N] bool, at
    the frame's features ``kf_feature`` [N]; the keyframe's links
    ``kf_lm`` [N]) and the local map's matches from ring slots ``first``
    .. ``first + n - 1`` (``search``). Returns (pose, local-map matches []
    int64); the pose found where the refinement is not finite."""
    N, Lp, dev = px.shape[0], ms.lm_physical, px.device
    used = torch.zeros(N + 1, dtype=torch.bool, device=dev).index_fill_(
        0, torch.where(kf_inliers, kf_feature, N), True)
    taken = torch.zeros(Lp + 1, dtype=torch.bool, device=dev).index_fill_(
        0, torch.where(kf_lm >= 0, kf_lm.long(), Lp), True)
    X, uv, acc = search(ms, cam, pose, px, valid, bits, pop, first, n,
                        used[:-1], taken[:-1], img_wh)
    span("localmap")
    w = torch.cat([kf_inliers, acc]).to(X.dtype)
    ref = _pose_gn_refine(cam, pose, torch.cat([kf_pts, X]),
                          torch.cat([kf_px, uv]), w, iters=GN_ITERS,
                          robust=True, huber_delta=reproj_thresh,
                          gate_px=RADIUS_PX)
    finite = torch.isfinite(ref.q).all() & torch.isfinite(ref.t).all()
    pose = Pose(torch.where(finite, ref.q, pose.q),
                torch.where(finite, ref.t, pose.t))
    return pose, acc.sum()
