"""The general traffic generator: a feed for each kind of entry point, found
by the ``feed`` name of a traffic file (``slambench/feeds/<feed>.py``, whose
``FEED`` is the class), reading its parameters from the traffic file and its
deployment from a configuration file.

A feed renders its inputs on the device in its constructor, warms up in
``warm`` with the cell's own shapes, measures in ``window`` and hands its
outputs to the reference in ``judge``. Every seed gives the same sizes,
frames and motion; the seed draws the scene's textures.
"""

from __future__ import annotations

import importlib
import re

import numpy as np
import torch

from ..data import scene
from ..reference import judge as ref

MAP_FIELDS = ("kf_q", "kf_t", "kf_id", "kf_px", "kf_fvalid", "kf_feat_lm",
              "kf_depth", "lm_pos", "lm_alive")


def load(kind: str):
    """The feed class of ``feeds/<kind>.py``."""
    if not re.fullmatch(r"[A-Za-z0-9_]+", kind):
        raise ValueError(f"not a feed name: {kind!r}")
    return importlib.import_module(f"{__name__}.{kind}").FEED


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def host_map(ms, lane=None) -> dict:
    pick = (lambda x: x) if lane is None else (lambda x: x[lane])
    return {f: pick(getattr(ms, f)).cpu().numpy() for f in MAP_FIELDS}


def judge_poses(cap, pose: torch.Tensor, ids: np.ndarray, mono: bool) -> dict:
    """The reference's trajectory numbers of [T,4,4] returned poses at loop
    frames ``ids``."""
    return ref.trajectory(pose.cpu().double().numpy(), cap.trajectory(ids)[1],
                          mono)


def judge_passes(cap, outs, ids, planes, host_map_of, mono: bool) -> dict:
    """The reference's numbers, each the worst over every pass and lane:
    ``outs`` [(pose [B,T,4,4], tracked [B,T])] a pass, lane b's loop
    frames ``ids[b]`` and scene ``planes[b]``, its final map
    ``host_map_of(b)``. Observations are summed."""
    worst: dict = {}

    def keep(d):
        for k, v in d.items():
            worst[k] = (worst.get(k, 0) + v if k == "observations"
                        else max(worst.get(k, v), v))

    for b, lane_ids in enumerate(ids):
        for pose, tracked in outs:
            tr = judge_poses(cap, pose[b], lane_ids, mono)
            scale = tr.pop("align")[0]
            keep(dict(tr, lost_frames=int((~tracked[b]).sum())))
        keep(ref.map_numbers(host_map_of(b), planes[b], cap, lane_ids, scale,
                             not mono))
    return worst


class Laps(dict):
    """A ``timings`` dict that also leaves a marker in the profiler's
    trace at each stage's end, so idle gaps can be named by stage."""

    def __setitem__(self, key, value):
        with torch.profiler.record_function(f"lap:{key}"):
            pass
        super().__setitem__(key, value)


class Feed:
    """What the harness needs of a feed; see the module docstring."""

    def __init__(self, cfg: dict, traffic: dict, device):
        from visionx_slam_torch.ops.camera import make_camera
        from visionx_slam_torch.utils.config import TrackingOptions

        self.cfg, self.traffic = cfg, traffic
        self.dev = torch.device(device)
        self.cap = scene.Capture.from_config(cfg)
        c = self.cap
        self.cam = make_camera(c.fx, c.fy, c.cx, c.cy)
        self.opts = TrackingOptions(**cfg.get("tracking_options", {}))
        self.orb = dict(cfg["orb"])
        self.mono = not cfg["depth"]
        self.timings = Laps()           # stage seconds of the untraced part
        self.trace = None               # set by the harness in a traced run

    def _render(self, seed: int, ids: np.ndarray):
        planes = scene.make_scene(seed)
        g, d = self.cap.render(planes, *self.cap.trajectory(ids), self.dev)
        return planes, g, (torch.zeros_like(d) if self.mono else d)
