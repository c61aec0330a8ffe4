"""System runner: dataset -> extractor -> tracker -> trajectory/metrics
(counterpart of ``visionx_slam_tpu/system/system.py``).

``System`` runs one sequence from a TUM-layout directory through one of the
three pipelines (``scan``, ``offline``, ``host``) and leaves the host-side
sinks that replace the reference's viewer: a TUM-format trajectory,
per-frame JSONL metrics, ``metrics.json``, a map snapshot for
checkpoint/resume and a PLY of the map. It is built over plain functions
that also stand alone: ``save_snapshot`` / ``load_snapshot_full``,
``harvest_keyframes``, ``archive_union_map``, ``run_global_ba``, the
chunk-fed scan ``ScanStream`` and ``run_scan_archived``, a loop over it.

A snapshot is a flat npz: one array per ``MapState`` field under the field's
name, with the JAX package's shapes and dtypes, plus ``_meta_*`` entries
(``_meta_next_frame_id``: the frame id a resumed run continues at). Either
package loads the other's file.

The archive is a host dict ``frame id -> keyframe observations`` (numpy):
the online scan keeps only the last ``kf_capacity`` keyframes in its ring,
so a run that wants a global BA over every keyframe it ever made harvests
the ring at chunk boundaries, with chunks no longer than the ring.
"""

from __future__ import annotations

import json
import logging
import os
import time
from dataclasses import asdict

import numpy as np
import torch

from ..convert import mapstate_from_numpy, mapstate_to_numpy
from ..data import tum
from ..data.prefetch import PythonPrefetcher
from ..eval import trajectory as traj
from ..models.global_ba import GlobalBAOptions, global_ba, map_reproj_error
from ..models.pair_ba import pair_ba
from ..models.orb import OpenCVExtractor, sample_depth_at
from ..ops.camera import CameraParams, make_camera
from ..ops.se3 import Pose, se3_matrix
from ..tracking import mapstate as msl
from ..tracking.frontend import FrameResult, Tracker
from ..tracking.mapstate import MapState, PairLinks
from ..tracking.offline_pipeline import build_keyframe_map, run_offline_pipeline
from ..tracking.scan_pipeline import (
    FrameOut,
    ScanState,
    resume_state,
    run_scan_pipeline,
)
from ..tracking.stages import FrameObs
from ..utils.config import SystemConfig, TrackingOptions
from ..utils.logging import JsonlWriter, StageClock, count_sync, span
from ..utils.rotation import quat_xyzw_to_matrix

log = logging.getLogger("vxs.system")

# ``System``'s union solve: ``pair_ba``'s disparity row (px m), one pixel a
# standard deviation of the Kinect's depth, 1.425e-3 z^2 m (Khoshelham and
# Elberink, Sensors 2012), as a keypoint's row is one a pixel
DISPARITY_BF = 1 / 1.425e-3

# the count of frames the Python loader's workers had decoded when the
# consumer asked for them, added to ``timings`` at the end of a run
DECODE_AHEAD = "#decode_ahead"

# ``summary["stage_timings"]``'s names of the stage clock's keys
_TIMING_NAMES = {"gba": "global_ba", "scan": "scan_dispatch",
                 "scan/upload": "upload"}


def save_snapshot(path: str, ms: MapState, next_frame_id: int) -> None:
    """Write the map checkpoint ``path`` (npz); ``next_frame_id``: the id
    of the first frame a resumed run will process."""
    count_sync(len(ms))     # one copy out a field
    np.savez_compressed(
        path, _meta_next_frame_id=np.asarray(next_frame_id, np.int64),
        **mapstate_to_numpy(ms))


def load_snapshot_full(path: str, device="cuda") -> tuple[MapState, dict]:
    """(MapState on ``device``, meta dict) from a snapshot npz."""
    z = np.load(path)
    meta = {k[len("_meta_"):]: z[k].item()
            for k in z.files if k.startswith("_meta_")}
    return mapstate_from_numpy({k: z[k] for k in MapState._fields}, device), meta


def load_snapshot(path: str, device="cuda") -> MapState:
    return load_snapshot_full(path, device)[0]


def harvest_keyframes(archive: dict, ms: MapState) -> dict:
    """Copy the alive keyframes of ``ms`` that ``archive`` does not hold yet
    to the host (one device-to-host copy of the keyframe tables, whatever
    the number of new keyframes); returns ``archive``."""
    kf = {f: getattr(ms, f).cpu().numpy() for f in
          ("kf_id", "kf_q", "kf_t", "kf_px", "kf_desc", "kf_fvalid", "kf_depth")}
    count_sync(len(kf))
    for slot in np.flatnonzero(kf["kf_id"] >= 0):
        fid = int(kf["kf_id"][slot])
        if fid in archive:
            continue
        archive[fid] = {
            "q": kf["kf_q"][slot].copy(), "t": kf["kf_t"][slot].copy(),
            "px": kf["kf_px"][slot].T.copy(),               # [N,2]
            "desc": kf["kf_desc"][slot].copy(),
            "fvalid": kf["kf_fvalid"][slot].copy(),
            "depth": kf["kf_depth"][slot].copy(),
        }
    return archive


def archive_union_map(archive: dict, cam: CameraParams, opts: TrackingOptions,
                      device="cuda") -> tuple[MapState, PairLinks]:
    """A (MapState, PairLinks) over every archived keyframe, ids ascending,
    by the offline pipeline's ``build_keyframe_map`` (depth landmarks and
    consecutive-pair observation links). The keyframe slots are padded to a
    power of two >= 8 and the landmark table holds at least 1 << 17 rows."""
    fids = sorted(archive)
    K = max(8, 1 << (len(fids) - 1).bit_length())
    N = archive[fids[0]]["px"].shape[0]

    def pad(key, fill=0.0, dtype=np.float32):
        arrs = [archive[f][key] for f in fids]
        out = np.full((K,) + arrs[0].shape, fill, dtype)
        out[:len(arrs)] = np.stack(arrs)
        return out

    kf_q = pad("q")
    kf_q[len(fids):, 0] = 1.0
    kf_id = np.full((K,), -1, np.int32)
    kf_id[:len(fids)] = fids
    dev = torch.device(device)
    on = lambda x: torch.from_numpy(x).to(dev)
    count_sync(8)           # the eight copies in
    return build_keyframe_map(
        cam, opts, on(kf_q), on(pad("t")), on(kf_id), on(pad("px")),
        on(pad("desc", 0, np.uint8)), on(pad("fvalid", False, bool)),
        on(pad("depth")), 1 << max(17, (K * N - 1).bit_length()))


def run_global_ba(ms: MapState, cam: CameraParams, opts: TrackingOptions,
                  archive: dict | None = None, iterations: int = 10,
                  device="cuda", disparity_bf: float = 0.0) -> tuple[MapState, dict]:
    """Full-map Schur-complement BA (BASELINE config 4). When ``archive``
    holds more keyframes than the ring of ``ms`` (it is first topped up from
    ``ms``), the solve covers the union map of every archived keyframe with
    ``pair_ba`` (that map has the pairwise link structure), with its
    ``disparity_bf`` row where that is above 0; otherwise it is
    ``global_ba`` on ``ms``, whose observation graph is general. On an
    active stage clock it ends the spans ``harvest`` and ``union`` (union
    solves only) and ``solve`` (both reprojection errors, the solve and the
    reads of its results) and counts its host reads. Returns
    (refined map, summary): iterations, final cost, observations, the mean
    reprojection error before and after, ``archived_keyframes`` (union
    solves only), and the refined keyframes in frame-id order as
    ``keyframe_ids`` and ``keyframe_poses`` [n,4,4] T_cw (numpy)."""
    extra = {}
    links = None
    count_sync()            # the ring's keyframe count
    if archive is not None and len(archive) > int(msl.n_keyframes(ms)):
        harvest_keyframes(archive, ms)             # the last chunk's keyframes
        span("harvest")
        ms, links = archive_union_map(archive, cam, opts, device)
        span("union")
        extra["archived_keyframes"] = len(archive)
    err0, _ = map_reproj_error(ms, cam)
    gba_opts = GlobalBAOptions(max_iterations=iterations)
    if links is not None:
        ms2, stats = pair_ba(ms, cam, links, gba_opts, disparity_bf)
    else:
        ms2, stats = global_ba(ms, cam, gba_opts)
    err1, _ = map_reproj_error(ms2, cam)
    kf_ids = ms2.kf_id.cpu().numpy()
    slots = np.flatnonzero(kf_ids >= 0)
    slots = slots[np.argsort(kf_ids[slots], kind="stable")]
    at = torch.from_numpy(slots).to(ms2.kf_q.device)
    poses = se3_matrix(Pose(ms2.kf_q[at], ms2.kf_t[at])).cpu().numpy()
    summary = {
        "iterations": int(stats.iterations),
        "final_cost": float(stats.final_cost),
        "total_obs": int(stats.total_obs),
        "mean_reproj_before_px": float(err0),
        "mean_reproj_after_px": float(err1),
        "keyframe_ids": kf_ids[slots].tolist(),
        "keyframe_poses": poses,
        **extra,
    }
    count_sync(8)           # the ids, the slots' copy in, the poses, five scalars
    span("solve")
    return ms2, summary


class ScanStream:
    """The online scan fed chunk by chunk as frames arrive: the state is
    streamed from ``feed`` to ``feed``, so the whole sequence never has to
    sit in memory. With ``harvest`` the keyframe archive is topped up after
    every chunk, and a chunk may then hold at most ``chunk = min(64,
    kf_capacity)`` frames: a chunk no longer than the ring cannot create and
    evict a keyframe between two harvests. ``resume_from``: a snapshot npz
    to continue from (frame ids go on at its ``next_frame_id``)."""

    def __init__(self, cam: CameraParams, opts: TrackingOptions,
                 kf_capacity: int = 64, n_features_cap: int = 1024,
                 lm_capacity: int = 1 << 17, orb_kwargs: dict | None = None,
                 resume_from: str | None = None, harvest: bool = True,
                 device="cuda"):
        self.device = torch.device(device)
        self.chunk = min(64, kf_capacity) if harvest else 64
        self._harvest = harvest
        self._cam, self._opts = cam, opts
        self._kw = dict(n_features_cap=n_features_cap, kf_capacity=kf_capacity,
                        lm_capacity=lm_capacity, orb_kwargs=orb_kwargs,
                        device=self.device)
        self.state: ScanState | None = None
        self.frame0 = 0               # id of the first frame fed
        if resume_from:
            ms0, meta = load_snapshot_full(resume_from, self.device)
            self.state = resume_state(ms0)
            self.frame0 = int(meta.get("next_frame_id", 0))
        self.next_frame = self.frame0
        self.archive: dict = {}
        self._outs: list[FrameOut] = []
        self._totals: dict = {}
        self._harvest_s = 0.0

    def feed(self, images_u8, depths_m) -> FrameOut:
        """Scan the next frames ([n,H,W] uint8 and float32, tensors or
        numpy); returns their outputs."""
        n = len(images_u8)
        if self._harvest and n > self.chunk:
            raise ValueError(f"a chunk of {n} frames could evict a keyframe "
                             f"before it is archived (at most {self.chunk})")
        cs: dict = {}
        self.state, out = run_scan_pipeline(
            self._cam, images_u8, depths_m, self._opts, st0=self.state,
            frame0=self.next_frame, stats=cs, **self._kw)
        self.next_frame += n
        self._outs.append(out)
        count_sync(cs["host_syncs"])    # the chunk's reads, as the scan counts them
        for k, v in cs.items():
            if isinstance(v, (int, float)):
                self._totals[k] = self._totals.get(k, 0) + v
        if self._harvest:
            t0 = time.perf_counter()
            harvest_keyframes(self.archive, self.state.ms)
            self._harvest_s += time.perf_counter() - t0
        return out

    def outputs(self) -> FrameOut:
        """The outputs of every frame fed so far, stacked along T."""
        return FrameOut(*(torch.cat(x) for x in zip(*self._outs)))

    def stats(self) -> dict:
        """The chunks' counters summed, and the harvests' host seconds."""
        return dict(self._totals, chunks=len(self._outs), chunk=self.chunk,
                    harvest_seconds=self._harvest_s)


def run_scan_archived(
    cam: CameraParams,
    images_u8,               # [T,H,W] uint8 (tensor or numpy)
    depths_m,                # [T,H,W] float32
    opts: TrackingOptions,
    kf_capacity: int = 64,
    n_features_cap: int = 1024,
    lm_capacity: int = 1 << 17,
    orb_kwargs: dict | None = None,
    run_gba: bool = True,
    gba_iterations: int = 10,
    resume_from: str | None = None,
    device="cuda",
    stats: dict | None = None,
) -> tuple[ScanState, FrameOut, dict, dict | None]:
    """The online scan over a whole sequence held in memory: a loop over
    ``ScanStream.feed`` in chunks of ``min(64, kf_capacity)`` frames, the
    keyframe archive harvested at every chunk boundary and, with
    ``run_gba``, the full-map global BA at the end.
    ``resume_from``: a snapshot npz to continue from (frame ids go on at its
    ``next_frame_id``). Returns (final state, FrameOut over all frames,
    archive, global-BA summary or None); with ``run_gba`` the final state's
    map is the refined one (the union map when the archive outgrew the
    ring). ``stats``: if a dict is given, it receives the chunks' counters
    summed and the harvests' host seconds."""
    images = torch.as_tensor(images_u8)
    depths = torch.as_tensor(depths_m)
    scan = ScanStream(cam, opts, kf_capacity, n_features_cap, lm_capacity,
                      orb_kwargs, resume_from, device=device)
    for s in range(0, images.shape[0], scan.chunk):
        scan.feed(images[s:s + scan.chunk], depths[s:s + scan.chunk])
    st = scan.state
    out = scan.outputs()
    gba = None
    if run_gba and st is not None:
        ms2, gba = run_global_ba(st.ms, cam, opts, scan.archive, gba_iterations,
                                 scan.device)
        st = st._replace(ms=ms2)
    if stats is not None:
        stats.update(scan.stats())
    return st, out, scan.archive, gba


_STATE_NAMES = {0: "INIT", 1: "TRACKING_GOOD", 2: "TRACKING_BAD", 3: "LOST"}


class System:
    """End-to-end runner for one sequence, on ``cfg.device``.

    ``run`` times its stages on a stage clock
    (``utils/logging.py::StageClock``), synchronized at each lap, and
    reports this run's laps as ``summary["stage_timings"]``. ``timings``:
    if a dict is given, the clock is kept in it, values accumulating over
    runs; without it the clock's dict is the run's own. The scan
    pipeline's keys: ``decode`` (the wait for a chunk's decoded files)
    and ``scan`` (its upload, the host span ``scan/upload``, and
    ``ScanStream.feed``), each lapped once a chunk; ``gba`` (the global BA,
    with the host spans ``gba/harvest``, ``gba/union`` and ``gba/solve``
    inside it); ``outputs`` (the frame results read back and every output
    file); ``#host_syncs``; and, with the Python loader, ``#decode_ahead``
    (the frames its workers had decoded when asked for). The stage keys
    tile the run. Spans that the scan's own functions end land there too: ``scan/orb`` (a chunk's ORB),
    then a frame's ``scan/match``, ``scan/ransac``, ``scan/gn`` and
    ``scan/step`` (the rest of its step). The offline pipeline laps ``decode`` and
    ``offline_pipeline``, the host path ``decode``, ``extract`` and
    ``track`` a frame."""

    def __init__(self, cfg: SystemConfig, timings: dict | None = None):
        self.cfg = cfg
        self.timings = timings
        self.device = torch.device(cfg.device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "device 'cuda' was asked for and no CUDA device is there "
                "(pass device='cpu' to run on the CPU)")
        if cfg.resume_from and cfg.pipeline != "scan":
            raise ValueError("--resume_from requires --pipeline scan")
        if cfg.extractor not in ("jax", "torch", "opencv"):
            raise ValueError(f"unknown extractor: {cfg.extractor!r}")
        self.dataset = tum.TumDataset(cfg.dataset_dir, cfg.sequence)
        if not self.dataset.load():
            raise RuntimeError(
                f"Failed to load dataset: {cfg.dataset_dir}/{cfg.sequence}"
            )
        intr = self.dataset.intrinsics
        self.cam = make_camera(
            intr.fx, intr.fy, intr.cx, intr.cy, intr.k1, intr.k2, intr.p1, intr.p2
        )
        if cfg.extractor == "opencv":
            self.extractor = OpenCVExtractor(n_features=cfg.n_features)
        else:
            from ..models.orb_torch import TorchOrbExtractor

            self.extractor = TorchOrbExtractor(
                n_features=cfg.n_features, resize_f32=cfg.orb_resize_f32,
                device=self.device)
        self.tracker = Tracker(self.cam, cfg.tracking, device=cfg.device)
        self.results: list[FrameResult] = []
        self.loader_used = ""    # "native" or "python", once frames were read
        self._decode_s = 0.0     # seconds spent decoding (the worker threads' sum)
        self._decode_ahead = None  # a run's frames found decoded (Python loader)
        self._frame0 = 0         # id offset when resuming from a snapshot
        # keyframes harvested at chunk boundaries of the scan path (the ring
        # evicts; the archive keeps every keyframe so --run_global_ba can
        # cover the full map, BASELINE config 4)
        self._archive: dict = {}

    @property
    def _orb_kwargs(self) -> dict:
        return {"n_features": self.cfg.n_features,
                "resize_f32": int(self.cfg.orb_resize_f32)}

    def _check_finite(self, poses: torch.Tensor, what: str) -> None:
        """``debug_nans``: raise at the first non-finite pose (one device
        read per call)."""
        if self.cfg.debug_nans and not bool(torch.isfinite(poses).all()):
            raise FloatingPointError(f"non-finite pose in {what}")

    def run(self) -> dict:
        cfg = self.cfg
        os.makedirs(cfg.output_dir, exist_ok=True)
        entries = self.dataset.entries
        if cfg.max_frames > 0:
            entries = entries[: cfg.max_frames]
        if not cfg.profile_dir:
            return self._dispatch(entries)
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        os.makedirs(cfg.profile_dir, exist_ok=True)
        with profile(activities=acts) as prof:
            summary = self._dispatch(entries)
        prof.export_chrome_trace(os.path.join(cfg.profile_dir, "trace.json"))
        return summary

    def _dispatch(self, entries) -> dict:
        """The pipeline's run on the stage clock."""
        pipeline = self.cfg.pipeline
        timings = self.timings if self.timings is not None else {}
        self._before = dict(timings)
        self._clock = StageClock(timings, self.device)
        self._decode_ahead = None
        with self._clock.active():
            if pipeline == "scan":
                summary = self._run_scan(entries)
            elif pipeline == "offline":
                summary = self._run_offline(entries)
            else:
                summary = self._run_host(entries)
            self._clock.lap("outputs")
        if self._decode_ahead is not None:
            timings[DECODE_AHEAD] = timings.get(DECODE_AHEAD, 0) + self._decode_ahead
        return summary

    def _stage_timings(self) -> dict:
        """This run's laps of the clock under ``_TIMING_NAMES`` (the scan's
        ``decode`` as ``decode_wait``), and the spans of the lapped stages:
        each with its seconds, its stage's laps and their mean (ms)."""
        clock = self._clock
        names = dict(_TIMING_NAMES, **({"decode": "decode_wait"}
                                       if self.cfg.pipeline == "scan" else {}))
        out = {}
        for key, v in clock.timings.items():
            n = clock.laps.get(key.split("/")[0], 0)
            if n:
                s = v - self._before.get(key, 0.0)
                out[names.get(key, key)] = {"total_s": s, "count": n,
                                            "mean_ms": 1e3 * s / n}
        return out

    def _finish(self, summary: dict) -> dict:
        self._clock.lap("outputs")
        summary["stage_timings"] = self._stage_timings()
        with open(os.path.join(self.cfg.output_dir, "metrics.json"), "w") as f:
            json.dump(summary, f, indent=2)
        return summary

    def _write_frames_jsonl(self) -> None:
        jsonl = JsonlWriter(os.path.join(self.cfg.output_dir, "frames.jsonl"))
        try:
            for r in self.results:
                jsonl.write(_frame_record(r))
        finally:
            jsonl.close()

    # ------------------------------------------------------------------
    def _run_offline(self, entries) -> dict:
        """Batched offline mapping (tracking/offline_pipeline.py): every
        stage runs as frame-parallel batches; highest throughput. RGB-D by
        default; ``cfg.monocular`` switches to the essential + scale-chain
        variant."""
        cfg = self.cfg
        clock = self._clock
        frames = list(self._frames(entries))
        grays = np.stack([g for g, _ in frames])
        depths = np.stack([d for _, d in frames])
        clock.lap("decode")

        t0 = time.perf_counter()
        clock.begin("offline_pipeline")
        # the pipeline's own capacities, as the JAX System runs it: the
        # padded keyframe capacity changes the order of the solvers' sums,
        # so another capacity would compute another map
        ms, outs = run_offline_pipeline(
            self.cam, grays, depths, cfg.tracking, device=self.device,
            orb_kwargs=self._orb_kwargs, monocular=cfg.monocular)
        clock.lap("offline_pipeline")
        clock.begin("outputs")
        t_scan = time.perf_counter() - t0
        self._check_finite(outs.pose, "the offline pipeline's output")
        self.tracker.ms = ms

        o = {f: getattr(outs, f).cpu().numpy() for f in outs._fields}
        self.results = [
            FrameResult(
                frame_id=i,
                timestamp=e.timestamp,
                state="TRACKING_GOOD" if o["tracked"][i] else "LOST",
                pose_T_cw=o["pose"][i] if o["tracked"][i] else None,
                n_matches=int(o["n_matches"][i]),
                n_inliers=int(o["n_inliers"][i]),
                parallax=float(o["parallax"][i]),
                is_keyframe=bool(o["is_keyframe"][i]),
                n_keyframes=int(o["n_keyframes"]),
                n_landmarks=int(o["n_landmarks"]),
            )
            for i, e in enumerate(entries)
        ]
        summary = self._write_outputs(entries, t_scan)
        summary["scan_time_s"] = t_scan
        summary["decode_time_s"] = self._decode_s
        summary["decode_ahead"] = self._decode_ahead
        summary["scan_fps"] = len(entries) / max(t_scan, 1e-9)
        return self._finish(summary)

    # ------------------------------------------------------------------
    def _run_host(self, entries) -> dict:
        """Per-frame host state machine (reference-parity path)."""
        cfg = self.cfg
        dev = self.device
        jsonl = (JsonlWriter(os.path.join(cfg.output_dir, "frames.jsonl"))
                 if cfg.metrics_jsonl else None)
        clock = self._clock
        clock.begin("track")
        t_start = time.perf_counter()
        frames = self._frames(entries)
        try:
            for fid, (e, (gray, depth)) in enumerate(zip(entries, frames)):
                clock.lap("decode")
                px, resp, desc, valid = self.extractor.extract(gray)
                clock.lap("extract")
                d = sample_depth_at(px, valid, depth)
                obs = FrameObs(*(torch.from_numpy(np.ascontiguousarray(x)).to(dev)
                                 for x in (px, resp, desc, valid, d)))
                res = self.tracker.process(fid, e.timestamp, gray, obs)
                clock.lap("track")
                if cfg.debug_nans and res.pose_T_cw is not None and not np.isfinite(
                        res.pose_T_cw).all():
                    raise FloatingPointError(f"non-finite pose in frame {fid}")
                self.results.append(res)
                if jsonl:
                    jsonl.write(_frame_record(res))
        finally:
            frames.close()
            if jsonl:
                jsonl.close()
        wall = time.perf_counter() - t_start
        clock.begin("outputs")

        summary = self._write_outputs(entries, wall)
        summary["decode_time_s"] = self._decode_s
        summary["decode_ahead"] = self._decode_ahead
        summary["host_reads_per_frame"] = (
            self.tracker.host_reads / max(len(self.results), 1))
        log.info("host path: %.2f device reads per frame",
                 summary["host_reads_per_frame"])
        return self._finish(summary)

    # ------------------------------------------------------------------
    def _run_scan(self, entries) -> dict:
        """The online scan, streamed: frames are decoded into chunks (by
        the loader's worker threads while the scan of the previous chunk
        runs) and each chunk is uploaded
        and scanned as it fills; the whole sequence is never held. Frame
        results are rebuilt from the stacked outputs, so the reporting is
        that of the host path."""
        cfg = self.cfg
        scan = ScanStream(
            self.cam, cfg.tracking, kf_capacity=cfg.kf_capacity,
            orb_kwargs=self._orb_kwargs, resume_from=cfg.resume_from or None,
            harvest=cfg.run_global_ba, device=self.device)
        self._frame0 = scan.frame0
        if cfg.resume_from:
            log.info("Resuming from %s at frame id %d", cfg.resume_from,
                     scan.frame0)
        buf_g, buf_d = [], []
        clock = self._clock
        clock.begin("scan")

        def flush():
            if not buf_g:
                return
            clock.lap("decode")
            g = torch.from_numpy(np.stack(buf_g)).to(self.device)
            d = torch.from_numpy(np.stack(buf_d)).to(self.device)
            count_sync(2)           # the copies in
            clock.span("upload")
            buf_g.clear()
            buf_d.clear()
            out = scan.feed(g, d)
            self._check_finite(out.pose, f"the chunk ending at frame "
                                         f"{scan.next_frame - 1}")
            clock.lap("scan")

        t0 = time.perf_counter()
        # the prefetcher runs a whole chunk ahead of the scan
        frames = self._frames(entries, queue_depth=scan.chunk)
        try:
            for gray, depth in frames:
                buf_g.append(gray)
                buf_d.append(depth)
                if len(buf_g) == scan.chunk:
                    flush()
        finally:
            frames.close()
        flush()
        if scan.state is None:
            raise RuntimeError("the sequence has no frames")
        clock.begin("outputs")
        outs = scan.outputs()
        o = {f: getattr(outs, f).cpu().numpy() for f in outs._fields}
        count_sync(len(o))
        t_scan = time.perf_counter() - t0   # decode is inside this
        self.tracker.ms = scan.state.ms     # the final map (global BA, snapshot)
        self._archive = scan.archive

        self.results = [
            FrameResult(
                frame_id=self._frame0 + i,
                timestamp=e.timestamp,
                state=_STATE_NAMES[int(o["state"][i])],
                pose_T_cw=o["pose"][i] if o["tracked"][i] else None,
                n_matches=int(o["n_matches"][i]),
                n_inliers=int(o["n_inliers"][i]),
                parallax=float(o["parallax"][i]),
                is_keyframe=bool(o["is_keyframe"][i]),
                n_keyframes=int(o["n_keyframes"][i]),
                n_landmarks=int(o["n_landmarks"][i]),
            )
            for i, e in enumerate(entries)
        ]
        if cfg.metrics_jsonl:
            self._write_frames_jsonl()

        summary = self._write_outputs(entries, t_scan)
        summary["scan_time_s"] = t_scan
        summary["decode_time_s"] = self._decode_s
        summary["decode_ahead"] = self._decode_ahead
        summary["scan_fps"] = len(entries) / max(t_scan, 1e-9)
        summary["scan_stats"] = scan.stats()
        return self._finish(summary)

    # ------------------------------------------------------------------
    def _frames(self, entries, queue_depth: int = 4):
        """Yield (gray, depth_m) per entry, decoded up to ``queue_depth``
        frames ahead of the consumer by two worker threads: those of the
        native C++ decode + prefetch pipeline where its library is there or
        can be built, else those of the Python loader's ``PythonPrefetcher``
        (with a warning), which count the frames found decoded in
        ``_decode_ahead``. Close the generator to stop the workers."""
        if self.cfg.loader == "native":
            from ..data import native_loader

            if native_loader.available():
                self.loader_used = "native"
                pf = native_loader.NativePrefetcher(
                    [e.rgb_path for e in entries],
                    [e.depth_path for e in entries],
                    queue_depth=queue_depth, n_threads=2,
                )
                try:
                    yield from pf
                finally:
                    pf.close()
                    self._decode_s += pf.decode_seconds()
                return
            log.warning("native loader unavailable; falling back to python")
        self.loader_used = "python"
        pf = PythonPrefetcher([e.rgb_path for e in entries],
                              [e.depth_path for e in entries],
                              queue_depth=queue_depth, n_threads=2)
        try:
            yield from pf
        finally:
            pf.close()
            self._decode_s += pf.decode_seconds()
            self._decode_ahead = (self._decode_ahead or 0) + pf.ready

    # ------------------------------------------------------------------
    def _write_outputs(self, entries, wall: float) -> dict:
        cfg = self.cfg
        ts, mats, gt_t, gt_T = [], [], [], []
        for e, r in zip(entries, self.results):
            if r.pose_T_cw is None:
                continue
            ts.append(r.timestamp)
            mats.append(traj.tcw_to_twc(r.pose_T_cw))
            gt_t.append(e.gt_t)
            gt_T.append(_gt_mat(e))
        traj_path = os.path.join(cfg.output_dir, "trajectory.txt")
        traj.write_tum_trajectory(traj_path, ts, mats)

        ms = self.tracker.ms
        count_sync(2)           # the two counts
        summary = {
            "sequence": cfg.sequence,
            "n_frames": len(self.results),
            "n_tracked": len(mats),
            "n_keyframes": int(msl.n_keyframes(ms)),
            "n_landmarks": int(msl.n_landmarks(ms)),
            "wall_time_s": wall,
            "fps": len(self.results) / max(wall, 1e-9),
            "trajectory": traj_path,
            "device": str(self.device),
            "loader": self.loader_used,
        }
        if len(mats) >= 3:
            est_t = np.asarray([m[:3, 3] for m in mats])
            summary["ate_rmse"] = traj.ate_rmse(est_t, np.asarray(gt_t))
            rpe_t, rpe_r = traj.rpe_rmse(np.asarray(mats), np.stack(gt_T))
            summary["rpe_trans_rmse"] = rpe_t
            summary["rpe_rot_rmse"] = rpe_r

        if cfg.run_global_ba:
            self._clock.lap("outputs")
            self._clock.begin("gba")
            summary["global_ba"] = self._run_global_ba()
            self._clock.lap("gba")
            self._clock.begin("outputs")

        if cfg.dump_overlays > 0:
            from ..eval.overlay import dump_run_overlays

            paths = dump_run_overlays(
                self, entries, cfg.dump_overlays,
                os.path.join(cfg.output_dir, "overlays"),
            )
            summary["overlays"] = len(paths)

        snap_path = os.path.join(cfg.output_dir, "map_snapshot.npz")
        self.save_snapshot(snap_path)
        if cfg.export_ply:
            from ..eval.export import export_snapshot_ply

            ply_path = os.path.join(cfg.output_dir, "map.ply")
            summary["map_ply_points"] = export_snapshot_ply(snap_path, ply_path)
            summary["map_ply"] = ply_path
        log.info("Summary: %s", summary)
        return summary

    # ------------------------------------------------------------------
    def _run_global_ba(self) -> dict:
        """Full-map Schur-complement BA (``run_global_ba``): refines the map
        in place of the tracker's and dumps the refined keyframe
        trajectory. Where the scan archived keyframes that the ring has
        evicted, the solve covers every keyframe ever made."""
        ms2, gba = run_global_ba(
            self.tracker.ms, self.cam, self.cfg.tracking, self._archive,
            self.cfg.global_ba_iterations, self.device, DISPARITY_BF)
        self.tracker.ms = ms2
        ts_by_id = {r.frame_id: r.timestamp for r in self.results}
        ids, poses = gba.pop("keyframe_ids"), gba.pop("keyframe_poses")
        path = os.path.join(self.cfg.output_dir, "trajectory_keyframes_gba.txt")
        traj.write_tum_trajectory(
            path, [ts_by_id.get(fid, float(fid)) for fid in ids],
            [traj.tcw_to_twc(T) for T in poses])
        return {"iterations": gba.pop("iterations"),
                "final_cost": gba.pop("final_cost"),
                "total_obs": gba.pop("total_obs"),
                "keyframe_trajectory": path, **gba}

    # ------------------------------------------------------------------
    def save_snapshot(self, path: str) -> None:
        """Map-state checkpoint of the run (see ``save_snapshot``)."""
        save_snapshot(path, self.tracker.ms, self._frame0 + len(self.results))

    @staticmethod
    def load_snapshot(path: str, device="cuda") -> MapState:
        return load_snapshot(path, device)

    @staticmethod
    def load_snapshot_full(path: str, device="cuda") -> tuple[MapState, dict]:
        """Returns (MapState on ``device``, meta dict) from a snapshot npz."""
        return load_snapshot_full(path, device)


def _frame_record(r: FrameResult) -> dict:
    rec = asdict(r)
    rec["pose_T_cw"] = (None if r.pose_T_cw is None
                        else np.asarray(r.pose_T_cw).tolist())
    return rec


def _gt_mat(e) -> np.ndarray:
    T = np.eye(4)
    T[:3, :3] = quat_xyzw_to_matrix(e.gt_q)
    T[:3, 3] = e.gt_t
    return T
