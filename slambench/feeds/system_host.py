"""``System --run_global_ba`` with ``SystemConfig``'s default pipeline,
``host``, over a TUM RGB-D directory on disk: the reference's
``Tracking::ProcessFrame`` state machine one frame at a time (ORB at B=1,
the host ``Tracker`` with its reads, keyframe events driven from the host),
the Tracker's ring harvested into the archive, the global BA over the
union map of every keyframe and the output files. The set-up, the passes,
the window and the judge are ``system_disk.SystemDisk``'s; this feed
changes only a pass's log line and the traced pass.

The traced run profiles the first pass of the window from the ``track``
lap that ends frame ``trace_from`` (the traffic's, counted from 1) to its
end: the last frames, the last harvest, the union map, ``pair_ba`` and the
outputs. That pass is left out of the window's time, as in the disk cells.
A program whose ``System`` takes no ``timings`` opens the profile as its
global BA starts (``SystemDisk._trace_gba``)."""

from __future__ import annotations

import os
import sys
import time

import torch

from . import Laps
from .system_disk import SystemDisk


class _TracedTrack(Laps):
    """The traced pass's stage clock: the profile opens at the ``track``
    lap that ends frame ``open_after`` (counted from 1)."""

    def __init__(self, trace, open_after: int):
        super().__init__()
        self.trace, self.left = trace, open_after

    def __setitem__(self, key, value):
        super().__setitem__(key, value)
        if key == "track":
            self.left -= 1
            if self.left == 0:
                self.trace.__enter__()
                with torch.profiler.record_function("pass"):
                    pass


class SystemHost(SystemDisk):
    def one_pass(self, timings=None, before=None) -> tuple[dict, str]:
        """One run of ``System`` over the directory: (its summary, its
        output directory). ``before(system)`` is called on the ``System``
        before it runs."""
        from visionx_slam_torch.system.system import System
        from visionx_slam_torch.utils.config import SystemConfig

        out = os.path.join(self.root, f"out{self.n_pass}")
        self.n_pass += 1
        cfg = SystemConfig(
            dataset_dir=self.root, sequence=self.cfg["sequence"]["name"],
            output_dir=out, tracking=self.opts,
            n_features=self.orb["n_features"],
            orb_resize_f32=bool(self.orb["resize_f32"]),
            device=str(self.dev), **self.system)
        kw = {"timings": timings} if timings is not None and self.clocked else {}
        t = time.perf_counter()
        system = System(cfg, **kw)
        if before is not None:
            before(system)
        s = system.run()
        st, g = s["stage_timings"], s["global_ba"]
        lap = lambda k: st.get(k, {}).get("total_s", 0.0)
        print(f"system_host: pass {self.n_pass} {time.perf_counter() - t:.3f} s, "
              f"loader {s['loader']}, {s['n_tracked']}/{s['n_frames']} tracked, "
              f"decode {lap('decode'):.3f} s, extract {lap('extract'):.3f}, "
              f"track {lap('track'):.3f}, harvest {lap('harvest'):.3f}, global BA "
              f"{lap('global_ba'):.3f}, outputs {lap('outputs'):.3f}; "
              f"{s.get('host_reads_per_frame', 0.0):.2f} reads a frame; keyframes "
              f"{g.get('archived_keyframes')}, GBA iterations {g['iterations']}, "
              f"reprojection {g['mean_reproj_before_px']:.4f} -> "
              f"{g['mean_reproj_after_px']:.4f} px", file=sys.stderr)
        return s, out

    def window(self, seconds: float) -> dict:
        """Passes back to back; the last one starts before ``seconds`` is
        out and is finished. In a traced run the traced pass comes first
        and is not counted in the window."""
        self.outs, traced, traced_frames = [], 0, 0
        least = self.traffic.get("min_passes", 2)
        t0 = t = time.perf_counter()
        while t - t0 < seconds or len(self.outs) - traced < least:
            if self.trace is not None and not self.trace.done:
                ts = time.perf_counter()
                start = min(self.traffic["trace_from"], self.frames_per_pass - 1)
                if self.clocked:
                    if start == 0:
                        self.trace.__enter__()
                    self.outs.append(self.one_pass(_TracedTrack(self.trace, start)))
                    traced_frames = self.frames_per_pass - start
                else:
                    self.outs.append(self.one_pass(before=self._trace_gba))
                if self.trace.prof is not None:
                    self.trace.__exit__(None, None, None)
                traced += 1
                t0 += time.perf_counter() - ts
            else:
                self.outs.append(self.one_pass(self.timings if self.trace else None))
            t = time.perf_counter()
        n = len(self.outs)
        return dict(wall_s=t - t0, frames=n * self.frames_per_pass,
                    timed_frames=(n - traced) * self.frames_per_pass,
                    traced_frames=traced_frames,
                    lost=sum(s["n_frames"] - s["n_tracked"] for s, _ in self.outs),
                    loader=self.outs[-1][0]["loader"] if n else None)


FEED = SystemHost
