"""Fixed-capacity map state (subset of ``visionx_slam_tpu/tracking/mapstate.py``
that the RGB-D offline path uses): the same ``MapState`` fields, shapes and
layouts (``kf_px [K,2,N]``, ``lm_pos [3,Lp]``), with ``Lp = L + N`` physical
landmark rows (N padding rows that never become alive)."""

from __future__ import annotations

from typing import NamedTuple

import torch

FREE = -1      # feature has no landmark (-2 marks an outlier feature)


class MapState(NamedTuple):
    # --- keyframe slots [K, ...] ---
    kf_q: torch.Tensor        # [K,4] T_cw rotation (wxyz)
    kf_t: torch.Tensor        # [K,3] T_cw translation
    kf_id: torch.Tensor       # [K] int32 frame id, -1 = empty slot
    kf_px: torch.Tensor       # [K,2,N] feature pixels (coordinate-major)
    kf_desc: torch.Tensor     # [K,N,32] uint8 descriptors
    kf_fvalid: torch.Tensor   # [K,N] feature validity
    kf_feat_lm: torch.Tensor  # [K,N] int32 landmark slot / FREE / OUTLIER
    kf_depth: torch.Tensor    # [K,N] depth (m) at the feature, 0 = none
    # --- landmark table [Lp = L + N padding, ...] ---
    lm_pos: torch.Tensor      # [3,Lp] (coordinate-major)
    lm_alive: torch.Tensor    # [Lp] bool
    lm_obs: torch.Tensor      # [Lp] int32 observation counts
    # --- cursors ---
    next_kf: torch.Tensor     # [] int32
    next_lm: torch.Tensor     # [] int32
    lm_dropped: torch.Tensor  # [] int32 landmarks lost to capacity overflow

    @property
    def kf_capacity(self) -> int:
        return self.kf_id.shape[0]

    @property
    def n_features(self) -> int:
        return self.kf_px.shape[2]

    @property
    def lm_physical(self) -> int:
        """Physical table size (logical capacity + padding rows)."""
        return self.lm_pos.shape[1]


def kf_alive(ms: MapState) -> torch.Tensor:
    return ms.kf_id >= 0


def n_keyframes(ms: MapState) -> torch.Tensor:
    return kf_alive(ms).sum().to(torch.int32)


def n_landmarks(ms: MapState) -> torch.Tensor:
    return ms.lm_alive.sum().to(torch.int32)


def landmark_observation_counts(ms: MapState) -> torch.Tensor:
    """[Lp] int32 observation counts (maintained incrementally)."""
    return ms.lm_obs


class PairLinks(NamedTuple):
    """The offline map's observation structure, from build_keyframe_map
    (``visionx_slam_tpu/models/pair_ba.py::PairLinks``).

    created  [K,N] bool : feature (k,n) created its landmark
    adopter  [K,N] int32: feature of keyframe k+1 observing the landmark
                          created at (k,n), or -1
    creator  [K,N] int32: feature of keyframe k-1 whose landmark feature
                          (k,m) adopted, or -1
    order    [K*N] int64: stable argsort of the creation scatter index
    sidx     [K*N] int64: the sorted creation scatter index (rank, or Lp for
                          non-creating slots)
    """

    created: torch.Tensor
    adopter: torch.Tensor
    creator: torch.Tensor
    order: torch.Tensor
    sidx: torch.Tensor
