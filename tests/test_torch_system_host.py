"""The benchmark cell ``rgbd.system_host_holes`` at a size the CPU holds:
fr1/desk as the Kinect records it (the configuration's hole model in every
depth file) through ``System --run_global_ba`` with its default pipeline,
``host``: the host ``Tracker`` one frame at a time, with the port's
tracking against the local map (``TrackingOptions.track_local_map``), its
ring harvested into the keyframe archive, and ``pair_ba`` over the union
map, judged by the reference from the files ``System`` wrote against the
cell's own limits. 24 frames taken 8 apart with an 8-slot ring: the ring
evicts, keyframe events triangulate landmarks for the features in holes
and local BA iterates on them.

Also: the Tracker's counts and reads in ``System``'s clock; the cell's
readers; faults planted in the written files fail the judge; with the
option off (its default) the host path is the bare ``Tracker``'s bit for
bit and never runs the local map; the host Tracker against the scan on
the same files; a reset of the Tracker empties the archive; ``System``
gives the Tracker its ``kf_capacity``. ORB runs once a frame
(``torch_parity.OrbMemo``)."""

import json
import logging
import os

import numpy as np
import pytest
import torch

from torch_parity import OrbMemo
from slambench import feeds, run, small
from test_torch_system_holes import FAULTS, _judged
from visionx_slam_torch.data import tum
from visionx_slam_torch.eval.trajectory import read_tum_trajectory
from visionx_slam_torch.models import orb_torch
from visionx_slam_torch.models.orb import sample_depth_at
from visionx_slam_torch.models.orb_torch import TorchOrbExtractor
from visionx_slam_torch.system.system import KF_COUNTS, System
from visionx_slam_torch.tracking import local_map as LM
from visionx_slam_torch.tracking import scan_pipeline as SP
from visionx_slam_torch.tracking.frontend import State, Tracker
from visionx_slam_torch.tracking.stages import FrameObs
from visionx_slam_torch.utils.config import SystemConfig, TrackingOptions

CELL = "rgbd.system_host_holes"
SEED = 2**31 + 91
KF = 8
READERS = ("decode_ms.host", "extract_ms.host", "tracker_ms.host",
           "localmap_ms.host", "kf_ms.host", "lba_ms.host", "gba_ms.host",
           "lba_iters.host", "syncs_per_frame.host", "k1_roofline.host",
           "device_idle.host")


@pytest.fixture(scope="module", autouse=True)
def orb_once():
    """Each frame's ORB computed once in this module, by the host path's
    extractor and by the scan alike."""
    with OrbMemo(orb_torch), OrbMemo(SP):
        yield


def small_spec() -> dict:
    spec = run.load_cell(CELL)
    spec["traffic"] = dict(spec["traffic"], frames=24, frame_stride=8,
                           min_passes=1, system={"kf_capacity": KF})
    return spec


def _feed_class(made: list):
    """The cell's feed, keeping itself and every pass's summary and
    ``System``, with ``System``'s clock kept in the feed's ``timings`` on
    every pass."""
    base = feeds.load("system_host")

    class Kept(base):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.summaries, self.systems = [], []
            made.append(self)

        def one_pass(self, timings=None, before=None):
            def keep(system):
                self.systems.append(system)
                if before is not None:
                    before(system)

            s, out = super().one_pass(self.timings, keep)
            self.summaries.append(s)
            return s, out

    return Kept


@pytest.fixture(scope="module")
def cell():
    """(the harness's result, the feed it ran, the limits) of one small
    run on the CPU."""
    spec = small_spec()
    made = []
    load, kept = feeds.load, _feed_class(made)
    feeds.load = lambda kind: kept
    try:
        out = small.run(spec, SEED, 0.1)
    finally:
        feeds.load = load
    return out, made[0], spec["limits"]


def _config(feed, out, **kw) -> SystemConfig:
    """The cell's ``SystemConfig`` over the feed's directory."""
    args = dict(dataset_dir=feed.root, sequence=feed.cfg["sequence"]["name"],
                output_dir=str(out), tracking=feed.opts,
                n_features=feed.orb["n_features"],
                orb_resize_f32=bool(feed.orb["resize_f32"]), device="cpu",
                **feed.system)
    args.update(kw)
    return SystemConfig(**args)


def test_a_small_run_is_correct_and_every_stage_does_work(cell):
    out, feed, limits = cell
    assert out["correct"] is True, out["checks"]
    assert set(out["checks"]) == set(limits) and out["failed"] == 0
    assert out["checks"]["gba_obs_depth_p99_mm"]["value"] < 7.0
    summary, path = feed.outs[-1]
    stats, g = summary["tracker_stats"], summary["global_ba"]
    tracker = feed.systems[-1].tracker
    assert summary["n_tracked"] == 24 and tracker.resets == 0
    # local BA iterated, triangulation made landmarks, the local map matched
    assert stats["ba_iterations"] > 0 and stats["tri_landmarks"] > 0
    assert stats["localmap_matches"] > 0
    # every keyframe made is refined: the union map outgrew the ring
    made = tracker.kf_inserted
    assert made == stats["kf_events"] + 2 > KF
    assert g["archived_keyframes"] == made
    ts, _ = read_tum_trajectory(os.path.join(path, "trajectory_keyframes_gba.txt"))
    assert len(ts) == made


def test_the_counts_and_reads_are_the_trackers_own(cell):
    """``System`` adds the Tracker's counters into ``timings`` once a run
    and into the run's ``stage_timings``; a keyframe event is a frame
    flagged as a keyframe; ``#host_syncs`` holds the Tracker's reads."""
    _, feed, _ = cell
    assert len(feed.summaries) == len(feed.systems) == 2   # warm and window
    for key, name in KF_COUNTS.items():
        runs = [s["tracker_stats"][name] for s in feed.summaries]
        assert feed.timings[key] == sum(runs), key
        assert [s["stage_timings"][key] for s in feed.summaries] == runs, key
    for s, system in zip(feed.summaries, feed.systems):
        st = s["tracker_stats"]
        assert st["kf_events"] == sum(r.is_keyframe for r in system.results)
        assert st["kf_events"] == system.tracker.counters.kf_events
        assert st["host_syncs"] == system.tracker.host_reads
        assert s["host_reads_per_frame"] == st["host_syncs"] / 24
        assert st["lba_kernel"] == 0                      # no K3 on the CPU
    reads = sum(system.tracker.host_reads for system in feed.systems)
    # and ORB's copies, the features' copies in, harvests and outputs
    assert feed.timings["#host_syncs"] > reads + 2 * 24 * 10


def test_the_spans_tile_the_track_lap(cell):
    """The host path's spans split its ``track`` lap: the features' copies
    in, the Tracker's matching, RANSAC, Gauss-Newton, the local map's
    search, a keyframe event up to local BA, local BA, and the rest of the
    frame; its stage keys tile the run."""
    _, feed, _ = cell
    t = feed.timings
    keys = [f"track/{k}" for k in ("upload", "match", "ransac", "gn",
                                   "localmap", "kf", "lba", "step")]
    for k in keys:
        assert k in t and t[k] > 0, k
    assert sum(t[k] for k in keys) <= t["track"]
    stages = ("decode", "extract", "track", "harvest", "gba", "outputs")
    assert all(k in stages or "/" in k or k.startswith("#") for k in t)
    for s in feed.summaries:
        st = s["stage_timings"]
        assert st["track"]["count"] == st["extract"]["count"] == 24
        assert st["harvest"]["count"] >= 1


@pytest.mark.parametrize("metric", READERS)
def test_the_cells_readers(cell, metric):
    """Each reader reads its lap, span or counts from ``timings``; the
    device's shares give None where the run traced no device (here the
    CPU); every reader gives None without its keys."""
    _, feed, _ = cell
    frames = 24 * len(feed.summaries)
    ctx = dict(timings=dict(feed.timings), frames=frames, trace=None,
               traced_frames=0, atlas=(1896, 640), window_frames=frames)
    got = run.reader(metric)(ctx)
    t = feed.timings
    per_frame = {"decode_ms.host": "decode", "extract_ms.host": "extract",
                 "tracker_ms.host": "track", "localmap_ms.host": "track/localmap",
                 "kf_ms.host": "track/kf", "lba_ms.host": "track/lba",
                 "gba_ms.host": "gba"}
    want = {m: 1e3 * t[k] / frames for m, k in per_frame.items()}
    want["lba_iters.host"] = t["#lba_iterations"] / t["#kf_events"]
    want["syncs_per_frame.host"] = t["#host_syncs"] / frames
    if metric in want:
        assert got == pytest.approx(want[metric], rel=1e-12) and got > 0
    else:
        assert got is None
    empty = dict(ctx, timings={})
    assert run.reader(metric)(empty) is None


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_fault_in_the_files_fails_its_limit(cell, fault):
    _, feed, limits = cell
    plant, key = FAULTS[fault]
    assert feed.judge()[key] <= limits[key]["limit"]
    nums = _judged(feed, plant)
    assert nums[key] > limits[key]["limit"], (key, nums[key])


def test_the_configuration_is_the_hole_cells_on_the_host_pipeline():
    """The host cell's configuration is the scan hole cell's with
    ``System``'s default pipeline, and its limits are the same numbers
    (their readings are the host path's own)."""
    host, scan = (run.load_cell(c) for c in (CELL, "rgbd.system_disk_holes"))
    h, s = host["config"], scan["config"]
    assert h["system"] == dict(s["system"], pipeline="host")
    assert h["system"]["pipeline"] == SystemConfig().pipeline
    assert TrackingOptions(**h["tracking_options"]) == TrackingOptions(
        track_local_map=True)
    same = {"name", "source", "system", "assumed"}
    assert {k: v for k, v in h.items() if k not in same} == {
        k: v for k, v in s.items() if k not in same}
    assert set(h["assumed"]) == set(s["assumed"])
    assert {k: v["limit"] for k, v in host["limits"].items()} == {
        k: v["limit"] for k, v in scan["limits"].items()}
    assert host["traffic"]["feed"] == "system_host"


def test_the_host_path_without_the_local_map_is_the_bare_trackers(
        cell, tmp_path, monkeypatch):
    """With ``track_local_map`` off (the default) the path never calls the
    local map, and ``System``'s clock, counts and harvests leave its poses
    and map those of a bare ``Tracker`` fed the same frames, bit for bit."""
    _, feed, _ = cell
    calls = []
    monkeypatch.setattr(LM, "track_local_map",
                        lambda *a, **k: calls.append(1) or None)
    cfg = _config(feed, tmp_path, tracking=TrackingOptions(), max_frames=12,
                  kf_capacity=4, loader="python")     # the loop's decoder
    system = System(cfg, timings={})
    summary = system.run()
    assert calls == [] and summary["tracker_stats"]["localmap_matches"] == 0
    assert summary["global_ba"]["archived_keyframes"] > 4

    ds = tum.TumDataset(cfg.dataset_dir, cfg.sequence)
    assert ds.load()
    ext = TorchOrbExtractor(n_features=cfg.n_features,
                            resize_f32=cfg.orb_resize_f32, device="cpu")
    bare = Tracker(system.cam, TrackingOptions(), kf_capacity=4, device="cpu")
    for i, e in enumerate(ds.entries[:12]):
        gray, depth = tum.load_rgb_gray(e.rgb_path), tum.load_depth_m(e.depth_path)
        px, resp, desc, valid = ext.extract(gray)
        obs = FrameObs(*(torch.from_numpy(np.ascontiguousarray(x)) for x in (
            px, resp, desc, valid, sample_depth_at(px, valid, depth))))
        r = bare.process(i, e.timestamp, gray, obs)
        got = system.results[i]
        assert (r.state, r.is_keyframe, r.n_matches, r.n_inliers) == (
            got.state, got.is_keyframe, got.n_matches, got.n_inliers), i
        np.testing.assert_array_equal(r.ba_cost, got.ba_cost)
        np.testing.assert_array_equal(r.pose_T_cw, got.pose_T_cw)
    assert bare.host_reads == system.tracker.host_reads


def test_the_host_tracker_against_the_scan(cell, tmp_path):
    """Both track against the local map over the same files: equal tracked
    frames and keyframe flags (the scan also flags its initializing frame,
    the host path does not), positions within 1 cm. Their RANSAC streams
    are seeded alike (``frame_generator``), but the scan's steady frame
    runs ``pnp_prior`` first and the full RANSAC only on a weak consensus
    (the host always), and it reads its frames in chunks: the poses
    differ by the draws' spread, not by an offset."""
    _, feed, _ = cell
    host = feed.systems[-1]
    scan = System(_config(feed, tmp_path, pipeline="scan"))
    scan.run()
    h, s = host.results, scan.results
    assert [r.pose_T_cw is not None for r in h] == [
        r.pose_T_cw is not None for r in s]
    first = next(i for i, r in enumerate(s) if r.is_keyframe)
    assert [r.is_keyframe for r in h[first + 1:]] == [
        r.is_keyframe for r in s[first + 1:]]
    gap = max(float(np.abs(np.linalg.inv(a.pose_T_cw)[:3, 3]
                           - np.linalg.inv(b.pose_T_cw)[:3, 3]).max())
              for a, b in zip(h, s) if a.pose_T_cw is not None)
    assert gap < 0.01, gap


def test_a_reset_empties_the_archive(cell, tmp_path, monkeypatch, caplog):
    """A frame after a tracking failure is consumed by the Tracker's reset,
    which wipes its map (tracking.cpp:477-499): the archive goes with it,
    and the global BA refines the keyframes made after it."""
    _, feed, _ = cell
    cfg = _config(feed, tmp_path, max_frames=16, kf_capacity=4)
    system = System(cfg)
    real = system.tracker.process

    def process(fid, *a):
        res = real(fid, *a)
        if fid == 8:                       # tracking lost after frame 8
            system.tracker.state = State.LOST
        return res

    system.tracker.process = process
    with caplog.at_level(logging.WARNING, logger="vxs.system"):
        system.run()
    assert system.tracker.resets == 1
    assert any("tracker reset at frame 9" in r.message for r in caplog.records)
    # frame 9 went to the reset, frames 10 and 11 initialize the new map
    assert system.results[9].pose_T_cw is None
    assert system._archive and min(system._archive) == 10
    ts, _ = read_tum_trajectory(os.path.join(cfg.output_dir,
                                             "trajectory_keyframes_gba.txt"))
    stamps = [e.timestamp for e in system.dataset.entries]
    assert len(ts) and min(ts) == pytest.approx(stamps[10], abs=1e-6)


def test_system_gives_the_tracker_its_ring(cell, tmp_path):
    _, feed, _ = cell
    assert System(_config(feed, tmp_path)).tracker.kf_capacity == KF
    assert System(_config(feed, tmp_path, kf_capacity=64)).tracker.kf_capacity == 64
    assert SystemConfig().kf_capacity == Tracker.kf_capacity == 64


def test_the_traffic_traces_the_last_frames():
    t = json.loads(run.ROOT.joinpath("slambench/traffic/system_host.json")
                   .read_text())
    cfg = run.load_cell(CELL)["config"]
    assert cfg["sequence"]["frames"] - t["trace_from"] == 62
