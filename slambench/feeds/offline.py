"""``run_offline_pipeline`` over one pass of the sequence, passes back to
back. A pass maps ``frames`` frames (the configuration's ``pass_frames``
unless the traffic file says otherwise) from loop frame ``start`` at a step
of ``frame_stride``; with depth off it is a monocular pass. The traced run
profiles the window's first pass."""

from __future__ import annotations

import time

import numpy as np
import torch

from . import Feed, Laps, host_map, judge_passes, sync


class Offline(Feed):
    def __init__(self, cfg, traffic, seed, device):
        super().__init__(cfg, traffic, device)
        t = traffic
        n = t.get("frames", cfg["pass_frames"])
        self.ids = (t.get("start", 0) + t.get("frame_stride", 1)
                    * np.arange(n)) % self.cap.loop_frames
        self.planes, self.g, self.d = self._render(seed, self.ids)
        self.kw = dict(cfg["offline"], orb_kwargs=self.orb,
                       monocular=self.mono)
        self.frames_per_pass = len(self.ids)

    def one_pass(self, timings=None):
        from visionx_slam_torch.tracking.offline_pipeline import (
            run_offline_pipeline)

        ms, out = run_offline_pipeline(self.cam, self.g, self.d, self.opts,
                                       device=self.dev, timings=timings,
                                       **self.kw)
        sync(self.dev)
        return ms, out

    def warm(self):
        self.one_pass()

    def window(self, seconds: float) -> dict:
        """Passes back to back; the last one starts before ``seconds`` is
        out and is finished."""
        self.outs, traced = [], 0
        t0 = t = time.perf_counter()
        while t - t0 < seconds:
            if self.trace is not None and not self.trace.done:
                with self.trace:
                    with torch.profiler.record_function("pass"):
                        ms, out = self.one_pass(Laps())
                traced += 1
                t0 += self.trace.exit_s     # the window keeps its work
            else:
                ms, out = self.one_pass(self.timings if self.trace else None)
            self.outs.append((out.pose, out.tracked))
            self.last_ms = ms
            t = time.perf_counter()
        n = len(self.outs)
        return dict(wall_s=t - t0, frames=n * self.frames_per_pass,
                    timed_frames=(n - traced) * self.frames_per_pass,
                    traced_frames=traced * self.frames_per_pass,
                    lost=int(sum(int((~tr).sum()) for _, tr in self.outs)))

    def judge(self) -> dict:
        return judge_passes(self.cap, [(p[None], t[None]) for p, t in self.outs],
                            [self.ids], [self.planes],
                            lambda b: host_map(self.last_ms), self.mono)


FEED = Offline
