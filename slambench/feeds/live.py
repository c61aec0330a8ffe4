"""``ScanStream.feed`` one frame a call in a closed loop, each frame handed
over as host arrays, the way a camera hands them over: frame i of the
stream is loop frame ``i mod frames`` (one loop unless the traffic file
says otherwise: continuous motion). Set-up warms
a separate stream over ``warm_frames`` frames; the traced run profiles
frames ``trace_from`` to ``trace_from + trace_frames``."""

from __future__ import annotations

import time

import numpy as np
import torch

from . import Feed, host_map, judge_poses
from ..reference import judge as ref


class Live(Feed):
    def __init__(self, cfg, traffic, seed, device):
        super().__init__(cfg, traffic, device)
        self.ids = np.arange(traffic.get("frames", self.cap.loop_frames))
        self.planes, g, d = self._render(seed, self.ids)
        # the frames as a camera hands them over: host arrays
        self.g, self.d = g.cpu().numpy(), d.cpu().numpy()

    def _stream(self):
        from visionx_slam_torch.system.system import ScanStream

        s = self.cfg["scan"]
        return ScanStream(self.cam, self.opts, kf_capacity=s["kf_capacity"],
                          lm_capacity=s["lm_capacity"], orb_kwargs=self.orb,
                          harvest=False, device=self.dev)

    def _frame(self, stream, i: int):
        k = i % len(self.ids)
        out = stream.feed(self.g[k:k + 1], self.d[k:k + 1])
        return out.pose.cpu()

    def warm(self):
        stream = self._stream()
        for i in range(self.traffic["warm_frames"]):
            self._frame(stream, i)

    def window(self, seconds: float) -> dict:
        """One frame a call until ``seconds`` is out; a frame's latency
        runs from its hand-over to its pose on the host."""
        stream = self._stream()
        tr = self.traffic
        lo = tr.get("trace_from", 0)
        hi = lo + tr.get("trace_frames", 0) if self.trace is not None else lo
        self.poses, self.latency = [], []
        t0 = t = time.perf_counter()
        i = 0
        while t - t0 < seconds:
            if i == lo < hi:
                self.trace.__enter__()
            ts = time.perf_counter()
            with torch.profiler.record_function(f"frame:{i}"):
                self.poses.append(self._frame(stream, i))
            t = time.perf_counter()
            self.latency.append(t - ts)
            i += 1
            if i == hi > lo:
                self.trace.__exit__(None, None, None)
                t0 += self.trace.exit_s     # the window keeps its work
        if lo < i < hi:
            self.trace.__exit__(None, None, None)
        self.stream = stream
        outs = stream.outputs()
        self.is_kf = outs.is_keyframe.cpu().numpy()
        self.tracked = outs.tracked.cpu().numpy()
        self.traced = (lo, min(hi, i))
        return dict(wall_s=t - t0, frames=i, latency_s=self.latency,
                    traced_frames=min(hi, i) - lo if hi > lo else 0,
                    lost=int((~self.tracked).sum()))

    def judge(self) -> dict:
        ids = self.ids[np.arange(len(self.poses)) % len(self.ids)]
        tr = judge_poses(self.cap, torch.cat(self.poses), ids, self.mono)
        tr["lost_frames"] = int((~self.tracked).sum())
        s = tr.pop("align")[0]
        m = ref.map_numbers(host_map(self.stream.state.ms), self.planes,
                            self.cap, ids, s, not self.mono)
        return dict(tr, **m)


FEED = Live
