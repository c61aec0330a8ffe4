"""``System --pipeline scan --run_global_ba`` over a TUM RGB-D directory on
disk, as a user maps a recorded sequence: a pass constructs ``System`` over
the directory with a fresh output directory and runs it, so the decode of
every file, the scan tracker with its keyframe ring evicting into the
archive, the global BA over the union map of every keyframe and the output
files are all inside it. Passes run back to back.

Set-up renders the pass's frames (the traffic's ``frames``, the
configuration's whole sequence by default, from loop frame ``start`` at a
step of ``frame_stride``) and writes them with the reference's own PNG
writer into a temporary TUM directory (``reference/files.py``), keeping
the frames on the host only, with the configuration's ``depth_holes``
zeroed in the depth files as a sensor leaves them; the warm-up is one
whole pass. The configuration's ``system`` options, updated by the
traffic's, are the ``SystemConfig``'s.

The window holds at least the traffic's ``min_passes`` whole passes (2 by
default), so that every host averages more than one.

The traced run profiles the first pass of the window from the ``scan`` lap
that ends its last chunk but one to its end (the last chunk, the harvest,
the union map, ``pair_ba`` and the outputs): a whole pass traced would not
end in time. That pass is left out of the window's time, so the untraced
passes, whose stage clock the stage metrics read, fill the window. From
the trace of a CUDA device the feed counts, into ``timings``, the device
operations of the last chunk (from the trace's start to the chunk's
``scan`` lap, both synchronized: ``"#chunk_launches"``) and the launches
the host made inside the ``gba/solve`` span (the CUDA runtime's kernel
launches, copies and fills called between its two markers, whatever the
device's lag: ``"#gba_launches"``). A program whose ``System`` takes no
``timings`` runs the same passes without a clock; its traced pass opens
the profile as ``System._run_global_ba`` starts (the global BA and the
outputs), or at the pass's start where ``System`` has no such method.

The judge reads the files ``System`` wrote: ``trajectory.txt`` and
``trajectory_keyframes_gba.txt`` of every pass, and the last pass's
``map_snapshot.npz``. The directory goes at the process's exit."""

from __future__ import annotations

import atexit
import inspect
import os
import shutil
import sys
import tempfile
import time

import numpy as np
import torch

from . import Feed, Laps
from ..reference import files
from ..reference import judge as ref

T0 = 1305031452.791720      # the first frame's timestamp (s), TUM's epoch


class _TracedLaps(Laps):
    """The traced pass's stage clock: the profile opens at the ``scan`` lap
    that ends chunk ``open_after`` (counted from 1)."""

    def __init__(self, trace, open_after: int):
        super().__init__()
        self.trace, self.left = trace, open_after

    def __setitem__(self, key, value):
        super().__setitem__(key, value)
        if key == "scan":
            self.left -= 1
            if self.left == 0:
                self.trace.__enter__()
                with torch.profiler.record_function("pass"):
                    pass


class SystemDisk(Feed):
    def __init__(self, cfg, traffic, seed, device):
        super().__init__(cfg, traffic, device)
        t = traffic
        n = t.get("frames", cfg["sequence"]["frames"])
        self.ids = (t.get("start", 0) + t.get("frame_stride", 1)
                    * np.arange(n)) % self.cap.loop_frames
        self.seed = seed
        self.planes, self.g, self.d = self._render(seed, self.ids)
        self.system = dict(cfg["system"], **t.get("system", {}))
        self.frames_per_pass = n
        self.stamps = np.array([float(f"{T0 + i / self.cap.rate_hz:.6f}")
                                for i in range(n)])
        self.root, self.n_pass = None, 0
        from visionx_slam_torch.system.system import System

        self.clocked = "timings" in inspect.signature(System).parameters

    def write(self):
        """The TUM directory of the frames as they are now (a control that
        changes them holds around the warm-up, where they are written)."""
        if self.root is not None:
            return
        self.root = tempfile.mkdtemp(prefix="slambench_disk_")
        atexit.register(shutil.rmtree, self.root, True)
        c = self.cfg["camera"]
        # the files hold the frames now: the device lets them go
        self.g, self.d = self.g.cpu().numpy(), self.d.cpu().numpy()
        units = np.round(self.d.astype(np.float64) * c["depth_scale"])
        units[self._holes(units.shape)] = 0
        files.write_sequence(
            self.root, self.cfg["sequence"]["name"], c, self.stamps, self.g,
            units.clip(0, 65535).astype(np.uint16), *self.cap.trajectory(self.ids))

    def _holes(self, shape) -> np.ndarray:
        """[T,H,W] True where the depth file holds no reading: the
        configuration's ``depth_holes``, squares of ``blob_px`` a side of
        which a ``share`` is empty, drawn anew each frame from the seed."""
        h, (T, H, W) = self.cfg["depth_holes"], shape
        b = h["blob_px"]
        rng = np.random.default_rng([self.seed, 1])
        cells = rng.random((T, -(-H // b), -(-W // b))) < h["share"]
        return np.repeat(np.repeat(cells, b, 1), b, 2)[:, :H, :W]

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
        print(f"system_disk: pass {self.n_pass} {time.perf_counter() - t:.3f} s, "
              f"loader {s['loader']}, decode {s['decode_time_s']:.3f} s, scan "
              f"{s['scan_time_s']:.3f}, global BA {st['global_ba']['total_s']:.3f}, "
              f"outputs {st['outputs']['total_s']:.3f}; keyframes "
              f"{g.get('archived_keyframes')}, GBA iterations {g['iterations']}, "
              f"reprojection {g['mean_reproj_before_px']:.4f} -> "
              f"{g['mean_reproj_after_px']:.4f} px", file=sys.stderr)
        return s, out

    def warm(self):
        self.write()
        self.one_pass()

    def window(self, seconds: float) -> dict:
        """Passes back to back; the last one starts before ``seconds`` is
        out and is finished. In a traced run the traced pass comes first
        and is not counted in the window."""
        self.outs, traced, traced_frames = [], 0, 0
        least = self.traffic.get("min_passes", 2)
        t0 = t = time.perf_counter()
        while t - t0 < seconds or len(self.outs) - traced < least:
            if self.trace is not None and not self.trace.done:
                chunk = min(64, self.system["kf_capacity"])
                chunks = -(-self.frames_per_pass // chunk)
                ts = time.perf_counter()
                if self.clocked:
                    if chunks == 1:
                        self.trace.__enter__()
                    self.outs.append(self.one_pass(
                        _TracedLaps(self.trace, chunks - 1)))
                    traced_frames = self.frames_per_pass - (chunks - 1) * chunk
                else:
                    self.outs.append(self.one_pass(before=self._trace_gba))
                if self.trace.prof is not None:
                    self.trace.__exit__(None, None, None)
                    if self.dev.type == "cuda":
                        self.timings.update(self._launches())
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

    def _trace_gba(self, system) -> None:
        """The traced pass of a ``System`` without a clock: the profile
        opens as its global BA starts, or now where it has none."""
        run = getattr(system, "_run_global_ba", None)
        if run is None:
            self.trace.__enter__()
            return

        def traced():
            self.trace.__enter__()
            return run()

        system._run_global_ba = traced

    def _launches(self) -> dict:
        """From the traced part: ``#chunk_launches``, the device
        operations that start before the first ``scan`` marker (the last
        chunk's), and ``#gba_launches``, the CUDA runtime calls that
        enqueue device work (``cudaLaunch*``, ``cuLaunch*``, ``cudaMemcpy*``,
        ``cudaMemset*``) the host made between the ``gba/union`` and
        ``gba/solve`` markers (a ``pair_ba`` solve with its reprojection
        errors and reads). A marker missing leaves its count out."""
        from torch.autograd import DeviceType

        marks, dev, calls = {}, [], []
        for e in self.trace.prof.events():
            start = e.time_range.start
            if e.name == "pass" or e.name.startswith("lap:"):
                if e.device_type == DeviceType.CPU:      # not the device's copy
                    marks.setdefault(e.name, start)
            elif e.device_type == DeviceType.CUDA:
                dev.append(start)
            elif e.name.startswith(("cudaLaunch", "cuLaunch", "cudaMemcpy",
                                    "cudaMemset")):
                calls.append(start)
        out = {}
        if "lap:scan" in marks:
            out["#chunk_launches"] = sum(s <= marks["lap:scan"] for s in dev)
        if "lap:gba/union" in marks and "lap:gba/solve" in marks:
            lo, hi = marks["lap:gba/union"], marks["lap:gba/solve"]
            out["#gba_launches"] = sum(lo <= s <= hi for s in calls)
        print(f"system_disk: traced part {len(dev)} device operations, "
              f"{len(calls)} runtime launch calls; {out}", file=sys.stderr)
        return out

    def judge(self) -> dict:
        """The reference's numbers, each the worst over every pass: the
        trajectory of every frame, the refined keyframes', and the last
        pass's refined map."""
        worst: dict = {}
        gR, gt = self.cap.trajectory(self.ids)
        for _, out in self.outs:
            for name, key in (("trajectory.txt", ""),
                              ("trajectory_keyframes_gba.txt", "gba_")):
                ts, pose = files.read_trajectory(os.path.join(out, name))
                at = files.frames_of(ts, self.stamps)
                nums = ref.trajectory(pose[at >= 0], gt[at[at >= 0]], False)
                nums.pop("align")
                if not key:
                    nums["lost_frames"] = self.frames_per_pass - len(
                        np.unique(at[at >= 0]))
                else:
                    nums = {"gba_ate_mm": nums["ate_mm"]}
                for k, v in nums.items():
                    worst[k] = max(worst.get(k, v), v)
        m = files.read_map(os.path.join(self.outs[-1][1], "map_snapshot.npz"))
        nums = ref.map_numbers(m, self.planes, self.cap, self.ids, 1.0, True)
        err = files.obs_depth_errors(
            m, (self.cap.width, self.cap.height),
            lambda f, u, v: ref.true_depth(self.planes, self.cap,
                                           *self.cap.trajectory(self.ids[f]), u, v))
        err = err[np.isfinite(err)]
        nums["gba_obs_depth_p99_mm"] = (1e3 * float(np.percentile(err, 99))
                                        if len(err) else float("inf"))
        return dict(worst, **nums)


FEED = SystemDisk
