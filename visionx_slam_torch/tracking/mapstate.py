"""Fixed-capacity map state (counterpart of
``visionx_slam_tpu/tracking/mapstate.py``): the same ``MapState`` fields,
shapes and layouts (``kf_px [K,2,N]``, ``lm_pos [3,Lp]``), with
``Lp = L + N`` physical landmark rows (N padding rows that never become
alive): a keyframe ring, a landmark table with a monotone allocation cursor,
and per-feature landmark links.

The mutating functions update the tables IN PLACE and return the same state
(the JAX package returns new arrays; the port saves the copies). Keyframe
slots are host integers: the caller that knows the ring cursor passes the
slot, otherwise it is read from ``next_kf`` (one device read). Every other
index stays on the device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.index import stable_argsort
from ..ops.se3 import Pose

FREE = -1      # feature has no landmark
OUTLIER = -2   # feature detached from a culled landmark


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
    def lm_capacity(self) -> int:
        """Logical landmark capacity (allocation limit)."""
        return self.lm_pos.shape[1] - self.n_features

    @property
    def lm_physical(self) -> int:
        """Physical table size (logical capacity + padding rows)."""
        return self.lm_pos.shape[1]


def empty_map(kf_capacity: int = 64, lm_capacity: int = 1 << 17,
              n_features: int = 1024, device=None) -> MapState:
    K, N = kf_capacity, n_features
    Lp = lm_capacity + n_features
    z = lambda *shape, dt=torch.float32: torch.zeros(shape, dtype=dt, device=device)
    kf_q = z(K, 4)
    kf_q[:, 0].fill_(1.0)
    return MapState(
        kf_q=kf_q, kf_t=z(K, 3),
        kf_id=torch.full((K,), -1, dtype=torch.int32, device=device),
        kf_px=z(K, 2, N), kf_desc=z(K, N, 32, dt=torch.uint8),
        kf_fvalid=z(K, N, dt=torch.bool),
        kf_feat_lm=torch.full((K, N), FREE, dtype=torch.int32, device=device),
        kf_depth=z(K, N),
        lm_pos=z(3, Lp), lm_alive=z(Lp, dt=torch.bool),
        lm_obs=z(Lp, dt=torch.int32),
        next_kf=z(dt=torch.int32), next_lm=z(dt=torch.int32),
        lm_dropped=z(dt=torch.int32),
    )


def kf_alive(ms: MapState) -> torch.Tensor:
    return ms.kf_id >= 0


def n_keyframes(ms: MapState) -> torch.Tensor:
    return kf_alive(ms).sum().to(torch.int32)


def n_landmarks(ms: MapState) -> torch.Tensor:
    return ms.lm_alive.sum().to(torch.int32)


def landmark_observation_counts(ms: MapState) -> torch.Tensor:
    """[Lp] int32 observation counts (maintained incrementally)."""
    return ms.lm_obs


def _links_delta(ms: MapState, links: torch.Tensor, active: torch.Tensor,
                 delta: int) -> None:
    """lm_obs +/- 1 for every active link >= 0 (in place). Inactive entries
    add 0 at slot 0: integer adds, so the result does not depend on the
    order the device applies them in."""
    ok = active & (links >= 0)
    ms.lm_obs.index_add_(0, torch.where(ok, links, 0).long(),
                         ok.to(ms.lm_obs.dtype) * delta)


def insert_keyframe(
    ms: MapState,
    frame_id: int,
    pose: Pose,
    px: torch.Tensor,        # [N,2]
    desc: torch.Tensor,      # [N,32] uint8
    fvalid: torch.Tensor,    # [N] bool
    feat_lm: torch.Tensor,   # [N] int32
    depth: torch.Tensor,     # [N]
    *,
    fresh_links: bool = False,
    slot: int | None = None,
) -> tuple[MapState, int]:
    """Insert a keyframe into the ring slot ``next_kf % K``; returns (state,
    slot). Evicting an occupant decrements its landmarks' observation
    counts; ``fresh_links`` asserts ``feat_lm`` is all FREE and skips the
    increment. ``slot``: the caller's copy of ``next_kf % K``."""
    if slot is None:
        slot = int(ms.next_kf) % ms.kf_capacity
    old_links = ms.kf_feat_lm[slot]
    _links_delta(ms, old_links, (ms.kf_id[slot] >= 0).expand_as(old_links), -1)
    if not fresh_links:
        _links_delta(ms, feat_lm, torch.ones_like(fvalid), +1)
    ms.kf_q[slot] = pose.q
    ms.kf_t[slot] = pose.t
    ms.kf_id[slot].fill_(frame_id)   # a fill: a Python scalar assigned by
                                     # indexing is a synchronizing host copy
    ms.kf_px[slot] = px.T
    ms.kf_desc[slot] = desc
    ms.kf_fvalid[slot] = fvalid
    ms.kf_feat_lm[slot] = feat_lm
    ms.kf_depth[slot] = depth
    ms.next_kf.add_(1)
    return ms, slot


def allocate_landmarks(ms: MapState, want: torch.Tensor, pos: torch.Tensor,
                       obs_init: int = 1) -> tuple[MapState, torch.Tensor]:
    """Allocate landmark slots for candidates ``want`` [N] at world
    positions ``pos`` [N,3], contiguously from ``next_lm`` in candidate
    order; returns (state, slots [N] int32, FREE where not created or
    dropped at capacity). New landmarks start with ``obs_init``
    observations."""
    N = want.shape[0]
    L = ms.lm_capacity
    dev = want.device
    offs = torch.cumsum(want.long(), 0) - 1             # rank among wanted
    slots = ms.next_lm + offs
    ok = want & (slots < L)
    slots = torch.where(ok, slots, FREE)
    n_created = ok.sum()
    # created rows first, in candidate order (row N takes the rest)
    buf = torch.zeros((N + 1, 3), dtype=pos.dtype, device=dev)
    buf[torch.where(ok, offs, N)] = torch.where(ok[:, None], pos, 0.0)
    win = ms.next_lm + torch.arange(N, device=dev)      # < L + N = Lp
    created = torch.arange(N, device=dev) < n_created
    ms.lm_pos[:, win] = torch.where(created[None], buf[:N].T, ms.lm_pos[:, win])
    ms.lm_alive[win] = created | ms.lm_alive[win]
    ms.lm_obs[win] = torch.where(created, obs_init, ms.lm_obs[win])
    n_wanted = want.sum()
    ms.next_lm.copy_(torch.clamp(ms.next_lm + n_wanted, max=L))
    ms.lm_dropped.add_(n_wanted - n_created)
    return ms, slots.to(torch.int32)


def remove_landmarks(ms: MapState, kill: torch.Tensor) -> MapState:
    """Kill the landmarks of ``kill`` [Lp] bool (in place): their feature
    links become OUTLIER and their observation counts zero."""
    lm = ms.kf_feat_lm
    pointed = (lm >= 0) & kill[lm.clamp(0, ms.lm_physical - 1).long()]
    ms.kf_feat_lm.masked_fill_(pointed, OUTLIER)
    ms.lm_alive.logical_and_(~kill)
    ms.lm_obs.masked_fill_(kill, 0)
    return ms


def remove_keyframe_slot(ms: MapState, slot: int) -> MapState:
    """Remove the keyframe of ``slot`` (in place): its landmarks lose one
    observation each (when the slot was alive) and the slot is cleared."""
    links = ms.kf_feat_lm[slot]
    _links_delta(ms, links, (ms.kf_id[slot] >= 0).expand_as(links), -1)
    ms.kf_id[slot].fill_(-1)
    ms.kf_fvalid[slot].zero_()
    ms.kf_feat_lm[slot].fill_(FREE)
    return ms


def compact_landmarks(ms: MapState) -> MapState:
    """Move the alive landmarks that still have observations to the front
    of the table (order kept), reap the rest, and remap every link."""
    Lp = ms.lm_physical
    keep = ms.lm_alive & (ms.lm_obs > 0)
    order = stable_argsort(torch.where(keep, 0, 1))
    inv = torch.empty_like(order)
    inv[order] = torch.arange(Lp, device=order.device)  # old slot -> new
    links = ms.kf_feat_lm
    remapped = torch.where(links >= 0, inv[links.clamp(0, Lp - 1).long()]
                           .to(links.dtype), links)
    obs_o = ms.lm_obs[order]
    ms.lm_pos.copy_(ms.lm_pos[:, order])
    ms.lm_alive.copy_(ms.lm_alive[order] & (obs_o > 0))
    ms.lm_obs.copy_(torch.where(keep[order], obs_o, 0))
    ms.kf_feat_lm.copy_(remapped)
    ms.next_lm.copy_(keep.sum())
    return ms


def window_slots(ms: MapState, window_size: int):
    """Slots of the newest ``window_size`` alive keyframes, ascending by
    frame id: (slots [W] int64, valid [W] bool); invalid entries must be
    masked by callers."""
    ids = torch.where(kf_alive(ms), ms.kf_id, -1)
    top = stable_argsort(-ids)[:window_size].flip(0)
    return top, ids[top] >= 0


def map_pose(ms: MapState, slot: int) -> Pose:
    """The pose of keyframe ``slot`` (a copy: the tables change in place)."""
    return Pose(ms.kf_q[slot].clone(), ms.kf_t[slot].clone())


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
