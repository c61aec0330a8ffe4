"""``run_offline_pipeline_batched`` over ``lanes`` sequences from as many
scenes drawn from the seed, each ``frames`` frames long (the configuration's
``lane_frames`` unless the traffic file says otherwise), lane b from loop
frame ``b * lane_start_step`` at a step of ``frame_stride``, mapped as
folded lanes in one pass with the entry's own keyframe slots a lane; passes
back to back. The traced run profiles the window's first pass."""

from __future__ import annotations

import numpy as np
import torch

from . import Feed, host_map, judge_passes, sync
from .offline import Offline
from ..data import scene


class Lanes(Offline):
    def __init__(self, cfg, traffic, seed, device):
        Feed.__init__(self, cfg, traffic, device)
        t = traffic
        B, T = t["lanes"], t.get("frames", cfg["lane_frames"])
        self.ids = [(b * t["lane_start_step"] + t.get("frame_stride", 1)
                     * np.arange(T)) % self.cap.loop_frames for b in range(B)]
        self.planes, gs, ds = [], [], []
        for b, s in enumerate(scene.lane_seeds(seed, B)):
            p, g, d = self._render(s, self.ids[b])
            self.planes.append(p)
            gs.append(g)
            ds.append(d)
        self.g, self.d = torch.stack(gs), torch.stack(ds)
        del gs, ds
        self.kw = dict(orb_kwargs=self.orb, monocular=self.mono)
        self.frames_per_pass = B * T

    def one_pass(self, timings=None):
        from visionx_slam_torch.tracking.offline_pipeline import (
            run_offline_pipeline_batched)

        ms, out = run_offline_pipeline_batched(
            self.cam, self.g, self.d, self.opts, device=self.dev,
            timings=timings, **self.kw)
        sync(self.dev)
        return ms, out

    def judge(self) -> dict:
        return judge_passes(self.cap, self.outs, self.ids, self.planes,
                            lambda b: host_map(self.last_ms, b), self.mono)


FEED = Lanes
