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
from .ops.camera import CameraParams, make_camera
from .tracking.mapstate import MapState

__all__ = [
    "FAST_CIRCLE", "_atlas_layout", "_brief_bank", "_gaussian_kernel1d",
    "_level_quotas", "brief_pattern", "camera_from_numpy",
    "mapstate_from_numpy", "mapstate_to_numpy",
]


def camera_from_numpy(cam) -> CameraParams:
    """A camera from any object with fx..p2 fields (e.g. the JAX
    package's ``CameraParams`` of 0-d arrays)."""
    return make_camera(*(float(np.asarray(getattr(cam, f)))
                         for f in CameraParams._fields))


def mapstate_from_numpy(ms, device="cpu") -> MapState:
    """A port ``MapState`` on ``device`` from the JAX package's (any object
    with the same field names holding array-likes)."""
    dev = torch.device(device)
    return MapState(*(torch.as_tensor(np.array(getattr(ms, f))).to(dev)
                      for f in MapState._fields))


def mapstate_to_numpy(ms: MapState) -> dict:
    """Field name -> numpy array, in the JAX package's dtypes."""
    return {f: getattr(ms, f).detach().cpu().numpy() for f in MapState._fields}
