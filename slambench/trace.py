"""The traced part of a ``--trace 1`` run: ``torch.profiler`` over a
fixed amount of the window's work (one pass, or a range of frames), read
into the device's busy time, K1's time and launches, the device operations
with the most time, and the idle gaps named by the benchmark's own span
they fell in (an offline stage, from the markers ``feeds.Laps`` leaves,
or a live frame, plain or with a keyframe event)."""

from __future__ import annotations

import time
from collections import defaultdict

import torch

from . import yardstick
from .feeds import sync


class Trace:
    def __init__(self, device):
        self.device = device
        self.done = False
        self.prof = None
        self.wall_s = 0.0
        self.exit_s = 0.0     # the profiler's own stop and parse

    def _profile(self):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        return profile(activities=acts)

    def warm(self):
        """Start and stop the profiler once, so that its first start (CUPTI
        loads) falls into set-up and not into the traced work."""
        with self._profile():
            torch.zeros(1, device=self.device).add_(1)
            sync(self.device)

    def __enter__(self):
        sync(self.device)
        self.prof = self._profile()
        self.prof.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        sync(self.device)
        t = time.perf_counter()
        self.wall_s = t - self.t0
        self.prof.__exit__(*exc)
        self.exit_s = time.perf_counter() - t
        self.done = True
        return False

    def read(self, label_frame=None) -> dict:
        """Numbers of the traced part. ``label_frame(i)`` names the live
        frame i's span."""
        from torch.autograd import DeviceType

        dev, marks = [], []
        for e in self.prof.events():
            r = (e.time_range.start, e.time_range.end)
            if e.name == "pass" or e.name.startswith(("lap:", "frame:")):
                # the markers, also mirrored on the device's timeline
                if e.device_type == DeviceType.CPU:
                    marks.append((e.name, *r))
            elif e.device_type == DeviceType.CUDA:
                dev.append((e.name, *r))
        spans = _spans(marks, label_frame)
        intervals = [(s, e) for _, s, e in dev]
        busy_us = yardstick.union_length(intervals)
        k1 = [e - s for n, s, e in dev if yardstick.K1_KERNEL in n]
        by_op = defaultdict(float)
        for n, s, e in dev:
            by_op[n] += (e - s) / 1e6
        idle = defaultdict(float)
        if intervals:
            lo = min(s for s, _ in intervals)
            hi = max(e for _, e in intervals)
            lo = min([lo] + [s for _, s, _ in spans])
            hi = max([hi] + [e for _, _, e in spans])
            for a, b in yardstick.gaps(intervals, lo, hi):
                idle[_label(spans, (a + b) / 2)] += (b - a) / 1e6
        top = lambda d: [[k[:160], v] for k, v in sorted(
            d.items(), key=lambda kv: -kv[1])[:10]]
        return dict(busy_s=busy_us / 1e6, window_s=self.wall_s,
                    device_ops=len(dev), k1_launches=len(k1),
                    k1_s=sum(k1) / 1e6, breakdown=dict(
                        device_ops=top(by_op), idle_gaps=top(idle)))


def _spans(marks, label_frame):
    """(label, start, end) spans from the markers: a live frame's range,
    or an offline stage from the end of the previous lap (or the pass's
    start) to its own lap."""
    out = []
    starts = sorted(s for n, s, _ in marks if n == "pass")
    laps = sorted((s, n[4:]) for n, s, _ in marks if n.startswith("lap:"))
    for n, s, e in marks:
        if n.startswith("frame:"):
            i = int(n[6:])
            out.append((label_frame(i) if label_frame else "frame", s, e))
    prev = None
    for s, name in laps:
        begin = max([p for p in starts if p <= s] + ([prev] if prev is not None else []),
                    default=s)
        out.append((name, begin, s))
        prev = s
    return out


def _label(spans, t: float) -> str:
    for name, s, e in spans:
        if s <= t <= e:
            return name
    return "outside the spans"
