"""Carry state between the JAX package and the port.

This system has no learned weights: its parameters are the camera, the
constant ORB tables (built by the same numpy code on both sides, see
``models/orb_torch.py``) and the ``MapState``. These functions take the JAX
package's state as numpy arrays (``np.asarray`` of each field) and return
the port's on a given device, and back. Field names, shapes and layouts are
the same on both sides; only integer index tables widen where torch indexes.
"""

from __future__ import annotations

import numpy as np
import torch

from .models.orb_torch import (
    FAST_CIRCLE,
    _atlas_layout,
    _brief_bank,
    _gaussian_kernel1d,
    _level_quotas,
    brief_pattern,
)
from .models.matching import MatchResult
from .ops.camera import CameraParams, make_camera
from .ops.se3 import Pose
from .tracking.mapstate import MapState, PairLinks
from .tracking.scan_pipeline import ScanState
from .tracking.stages import FrameObs

__all__ = [
    "FAST_CIRCLE", "_atlas_layout", "_brief_bank", "_gaussian_kernel1d",
    "_level_quotas", "brief_pattern", "camera_from_numpy",
    "frameobs_from_numpy", "mapstate_from_numpy", "mapstate_to_numpy",
    "match_from_numpy", "pairlinks_from_numpy", "pose_from_numpy",
    "scanstate_from_numpy",
]


def camera_from_numpy(cam) -> CameraParams:
    """A camera from any object with fx..p2 fields (e.g. the JAX
    package's ``CameraParams`` of 0-d arrays)."""
    return make_camera(*(float(np.asarray(getattr(cam, f)))
                         for f in CameraParams._fields))


def mapstate_from_numpy(ms, device="cpu") -> MapState:
    """A port ``MapState`` on ``device`` from the JAX package's (any object
    with the same field names holding array-likes, or a mapping of them as
    ``mapstate_to_numpy`` gives). Fields keep their shapes, so a
    lane-stacked state ([B, ...] per field) converts as well as a merged
    one."""
    dev = torch.device(device)
    get = ms.__getitem__ if isinstance(ms, dict) else ms.__getattribute__
    return MapState(*(torch.as_tensor(np.array(get(f))).to(dev)
                      for f in MapState._fields))


def _tensor(x, device, dtype=None) -> torch.Tensor:
    out = torch.as_tensor(np.array(x)).to(device)
    return out if dtype is None else out.to(dtype)


def pose_from_numpy(pose, device="cpu") -> Pose:
    return Pose(_tensor(pose.q, device), _tensor(pose.t, device))


def frameobs_from_numpy(obs, device="cpu") -> FrameObs:
    return FrameObs(*(_tensor(getattr(obs, f), device) for f in FrameObs._fields))


def match_from_numpy(res, device="cpu") -> MatchResult:
    """A match table; indices widen to int64."""
    return MatchResult(_tensor(res.idx, device, torch.long),
                       _tensor(res.dist, device), _tensor(res.valid, device))


def pairlinks_from_numpy(links, device="cpu") -> PairLinks:
    """The offline map's link tables; the sort tables widen to int64."""
    return PairLinks(created=_tensor(links.created, device),
                     adopter=_tensor(links.adopter, device),
                     creator=_tensor(links.creator, device),
                     order=_tensor(links.order, device, torch.long),
                     sidx=_tensor(links.sidx, device, torch.long))


def scanstate_from_numpy(st, device="cpu") -> ScanState:
    """A port ``ScanState`` from the JAX package's: the state-machine
    scalars become host numbers, ``kf_cursor`` is read from the map's
    ``next_kf``, and the int8 bit planes become bf16 (both hold 0/1)."""
    host = lambda x: np.asarray(x).item()
    return ScanState(
        ms=mapstate_from_numpy(st.ms, device),
        tstate=int(host(st.tstate)), have_init=bool(host(st.have_init)),
        init_obs=frameobs_from_numpy(st.init_obs, device),
        init_frame_id=int(host(st.init_frame_id)),
        init_kf_slot=int(host(st.init_kf_slot)),
        last_obs=frameobs_from_numpy(st.last_obs, device),
        last_pose=pose_from_numpy(st.last_pose, device),
        cur_pose=pose_from_numpy(st.cur_pose, device),
        last_kf_slot=int(host(st.last_kf_slot)),
        last_kf_id=int(host(st.last_kf_id)),
        last_inliers=int(host(st.last_inliers)),
        last_parallax=float(host(st.last_parallax)),
        kf_bits=_tensor(st.kf_bits, device, torch.bfloat16),
        kf_pop=_tensor(st.kf_pop, device),
        kf_fvalid=_tensor(st.kf_fvalid, device),
        kf_lm_pts=_tensor(st.kf_lm_pts, device),
        kf_lm_valid=_tensor(st.kf_lm_valid, device),
        kf_px2=_tensor(st.kf_px2, device),
        kf_cursor=int(host(st.ms.next_kf)),
    )


def mapstate_to_numpy(ms: MapState) -> dict:
    """Field name -> numpy array, in the JAX package's dtypes."""
    return {f: getattr(ms, f).detach().cpu().numpy() for f in MapState._fields}
