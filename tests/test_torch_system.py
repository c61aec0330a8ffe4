"""The port's ``System`` on the CPU over one synthetic sequence written to
disk (once per file): ``--pipeline scan`` and ``offline`` equal the port's
own in-memory ``run_scan_pipeline`` (one call: streaming in chunks changes
nothing) and ``run_offline_pipeline`` on the decoded arrays bit for bit
(earlier test files hold those to the JAX package), a run stopped at a
snapshot and resumed on the remaining frames continues the uninterrupted
run, and the output files have the JAX package's names and formats."""

import json
import os
import shutil

import numpy as np
import pytest
import torch

from visionx_slam_torch.data import synthetic, tum
from visionx_slam_torch.eval import trajectory as traj
from visionx_slam_torch.ops.camera import make_camera
from visionx_slam_torch.system import system as tsystem
from visionx_slam_torch.system.system import System
from visionx_slam_torch.tracking.offline_pipeline import run_offline_pipeline
from visionx_slam_torch.tracking.scan_pipeline import run_scan_pipeline
from visionx_slam_torch.utils.config import SystemConfig, TrackingOptions

import torch_parity  # noqa: F401  (one torch thread per test process)

SEQ = "rgbd_dataset_freiburg3_synthetic"
T = 10
CUT = 5
KF = 5         # ring slots: the stream then runs in chunks of 5 frames
T_OFF = 6      # frames of the offline run
ORB = {"n_features": 1000, "resize_f32": 0}


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """(root, decoded grays, depths, entries) of one written sequence."""
    root = str(tmp_path_factory.mktemp("sys"))
    synthetic.generate_sequence(root, n_frames=T, seed=5)
    ds = tum.TumDataset(root, SEQ)
    assert ds.load() and len(ds.entries) == T
    grays = np.stack([tum.load_rgb_gray(e.rgb_path) for e in ds.entries])
    depths = np.stack([tum.load_depth_m(e.depth_path) for e in ds.entries])
    return root, grays, depths, ds.entries


def _cfg(root, out, **kw):
    return SystemConfig(dataset_dir=root, sequence=SEQ, output_dir=str(out),
                        device="cpu", loader="python", **kw)


def _poses(system):
    return np.stack([r.pose_T_cw for r in system.results])


@pytest.fixture(scope="module")
def scan_run(dataset, tmp_path_factory):
    """``--pipeline scan --run_global_ba true`` with a 5-slot ring: the
    stream runs in two chunks of 5 frames."""
    out = tmp_path_factory.mktemp("scan_out")
    system = System(_cfg(dataset[0], out, pipeline="scan", run_global_ba=True,
                         global_ba_iterations=2, kf_capacity=KF))
    return system, system.run(), out


def test_system_scan_equals_in_memory_run(dataset, scan_run):
    """The streamed run (two chunks, frames decoded from disk) equals ONE
    in-memory ``run_scan_pipeline`` call over the decoded arrays bit for
    bit, and its archive, solve and refined map equal what the plain
    functions give on that call's map."""
    _, grays, depths, entries = dataset
    system, summary, out = scan_run
    cam = make_camera(synthetic.FX, synthetic.FY, synthetic.CX, synthetic.CY)
    opts = TrackingOptions()
    st, o = run_scan_pipeline(cam, grays, depths, opts, kf_capacity=KF,
                              orb_kwargs=ORB, device="cpu")
    assert bool(o.tracked.all()) and summary["n_tracked"] == T
    np.testing.assert_array_equal(_poses(system), o.pose.numpy())
    assert [r.is_keyframe for r in system.results] == o.is_keyframe.tolist()
    assert [r.n_inliers for r in system.results] == o.n_inliers.tolist()
    assert [r.n_landmarks for r in system.results] == o.n_landmarks.tolist()
    assert [r.state for r in system.results][-1] == "TRACKING_GOOD"
    # no keyframe left the 5-slot ring in 10 frames: one harvest sees all
    archive = tsystem.harvest_keyframes({}, st.ms)
    ms2, gba = tsystem.run_global_ba(st.ms, cam, opts, archive, 2, "cpu")
    g = summary["global_ba"]
    assert sorted(system._archive) == sorted(archive) and len(archive) >= 3
    for k in ("iterations", "final_cost", "total_obs", "mean_reproj_before_px",
              "mean_reproj_after_px"):
        assert g[k] == gba[k], k
    for a, b in zip(system.tracker.ms, ms2):
        assert torch.equal(a, b)
    assert summary["scan_stats"]["chunks"] == 2 and summary["loader"] == "python"
    assert summary["decode_time_s"] > 0 and summary["scan_fps"] > 0


def test_system_scan_outputs(dataset, scan_run):
    """Names and formats of the output files, read back."""
    _, _, _, entries = dataset
    system, summary, out = scan_run
    with open(out / "metrics.json") as f:
        metrics = json.load(f)
    for key in ("n_frames", "n_tracked", "n_keyframes", "n_landmarks",
                "wall_time_s", "fps", "ate_rmse", "rpe_trans_rmse",
                "rpe_rot_rmse", "scan_time_s", "decode_time_s", "scan_fps",
                "stage_timings", "global_ba"):
        assert key in metrics, key
    assert metrics["ate_rmse"] == summary["ate_rmse"] < 0.02
    assert {"upload", "scan_dispatch", "decode_wait", "outputs"} <= set(
        metrics["stage_timings"])
    ts, mats = traj.read_tum_trajectory(str(out / "trajectory.txt"))
    assert len(ts) == metrics["n_tracked"] == T
    np.testing.assert_allclose(ts, [e.timestamp for e in entries], atol=1e-6)
    est = np.stack([traj.tcw_to_twc(r.pose_T_cw) for r in system.results])
    np.testing.assert_allclose(mats, est, atol=5e-6)        # 6 decimals
    with open(out / "frames.jsonl") as f:
        recs = [json.loads(line) for line in f]
    assert len(recs) == T and recs[3]["frame_id"] == 3
    assert set(recs[0]) == {"frame_id", "timestamp", "state", "pose_T_cw",
                            "n_features", "n_matches", "n_inliers", "parallax",
                            "is_keyframe", "n_keyframes", "n_landmarks", "ba_cost"}
    kts, kmats = traj.read_tum_trajectory(str(out / "trajectory_keyframes_gba.txt"))
    assert len(kts) == metrics["n_keyframes"] >= 3 and (np.diff(kts) > 0).all()
    assert set(np.round(kts, 4)) <= set(np.round(ts, 4))   # keyframes are frames
    ms, meta = System.load_snapshot_full(str(out / "map_snapshot.npz"), device="cpu")
    assert meta == {"next_frame_id": T}
    for a, b in zip(ms, system.tracker.ms):
        assert torch.equal(a, b)
    with open(out / "map.ply") as f:
        head = [next(f).strip() for _ in range(3)]
    assert head[2] == f"element vertex {metrics['map_ply_points']}"
    assert metrics["map_ply_points"] == metrics["n_landmarks"] + metrics["n_keyframes"]


def test_resume_continues_the_run(dataset, scan_run, tmp_path):
    root, _, _, entries = dataset
    chunked = _poses(scan_run[0])
    # stop after CUT frames (no global BA: one chunk), then resume on a
    # directory that holds the rest
    first = System(_cfg(root, tmp_path / "first", pipeline="scan", kf_capacity=KF,
                        max_frames=CUT, metrics_jsonl=False, export_ply=False))
    s1 = first.run()
    assert s1["scan_stats"]["chunks"] == 1
    np.testing.assert_array_equal(_poses(first), chunked[:CUT])
    assert not os.path.exists(tmp_path / "first" / "frames.jsonl")
    assert not os.path.exists(tmp_path / "first" / "map.ply")
    rest = tmp_path / "rest"
    (rest / SEQ).mkdir(parents=True)
    shutil.copy(os.path.join(root, "color_camera_freiburg3.txt"), rest)
    for sub in ("rgb", "depth"):
        os.symlink(os.path.join(root, SEQ, sub), rest / SEQ / sub)
    for name in ("rgb.txt", "depth.txt", "groundtruth.txt"):
        with open(os.path.join(root, SEQ, name)) as f:
            lines = f.read().splitlines()
        (rest / SEQ / name).write_text("\n".join(lines[:2] + lines[2 + CUT:]) + "\n")
    second = System(_cfg(str(rest), tmp_path / "second", pipeline="scan",
                         kf_capacity=KF,
                         resume_from=str(tmp_path / "first" / "map_snapshot.npz")))
    s2 = second.run()
    assert s2["n_frames"] == s2["n_tracked"] == T - CUT
    assert [r.frame_id for r in second.results] == list(range(CUT, T))
    assert second.results[0].state == "TRACKING_GOOD"
    # the resumed tracker rebuilds its last frame from the keyframe tables,
    # so the first frames may differ in their last bits: 1e-4 m (the JAX
    # package's resume test allows 10 mm)
    np.testing.assert_allclose(_poses(second)[:, :3, 3], chunked[CUT:, :3, 3],
                               atol=1e-4)
    _, meta = System.load_snapshot_full(
        str(tmp_path / "second" / "map_snapshot.npz"), device="cpu")
    assert meta == {"next_frame_id": T}


def test_system_offline_equals_in_memory_run(dataset, tmp_path):
    root, grays, depths, _ = dataset
    system = System(_cfg(root, tmp_path / "off", pipeline="offline",
                         max_frames=T_OFF, dump_overlays=3))
    summary = system.run()
    cam = make_camera(synthetic.FX, synthetic.FY, synthetic.CX, synthetic.CY)
    ms, o = run_offline_pipeline(cam, grays[:T_OFF], depths[:T_OFF], TrackingOptions(),
                                 device="cpu", orb_kwargs=ORB)
    assert bool(o.tracked.all())
    np.testing.assert_array_equal(_poses(system), o.pose.numpy())
    for a, b in zip(system.tracker.ms, ms):
        assert torch.equal(a, b)
    assert summary["n_keyframes"] == int(o.n_keyframes) >= 2
    assert summary["ate_rmse"] < 0.02 and summary["scan_fps"] > 0
    assert summary["overlays"] == 2
    names = sorted(os.listdir(tmp_path / "off" / "overlays"))
    assert names == ["frame_000000_TRACKING_GOOD.png", "frame_000003_TRACKING_GOOD.png"]
    from visionx_slam_torch.data import png

    img = png.read_png(str(tmp_path / "off" / "overlays" / names[0]))
    assert img.shape == (480, 640, 3)
    assert ((img[..., 1] == 255) & (img[..., 0] == 0) & (img[..., 2] == 0)).sum() > 50


def test_system_refuses_what_it_cannot_do(dataset, tmp_path):
    root = dataset[0]
    with pytest.raises(ValueError, match="resume_from"):
        System(_cfg(root, tmp_path, pipeline="host", resume_from="x.npz"))
    with pytest.raises(ValueError, match="extractor"):
        System(_cfg(root, tmp_path, extractor="sift"))
    with pytest.raises(RuntimeError, match="Failed to load dataset"):
        System(_cfg(str(tmp_path), tmp_path))
    if not torch.cuda.is_available():     # no card: the default device raises
        with pytest.raises(RuntimeError, match="no CUDA device"):
            System(SystemConfig(dataset_dir=root, sequence=SEQ,
                                output_dir=str(tmp_path)))


def test_debug_nans_raises_on_a_non_finite_pose(dataset, tmp_path, monkeypatch):
    """``debug_nans``: a chunk whose poses are not finite ends the run."""
    real = tsystem.ScanStream.feed

    def poisoned(self, g, d):
        out = real(self, g, d)
        out.pose[0, 0, 0] = float("nan")
        return out

    monkeypatch.setattr(tsystem.ScanStream, "feed", poisoned)
    cfg = _cfg(dataset[0], tmp_path, pipeline="scan", kf_capacity=KF, max_frames=2,
               debug_nans=True)
    with pytest.raises(FloatingPointError, match="non-finite pose"):
        System(cfg).run()


def test_profile_dir_receives_a_trace(dataset, tmp_path):
    """``profile_dir``: the run is wrapped in ``torch.profiler`` and its
    Chrome trace lands there."""
    cfg = _cfg(dataset[0], tmp_path / "out", pipeline="scan", kf_capacity=KF,
               max_frames=2, profile_dir=str(tmp_path / "prof"),
               export_ply=False, metrics_jsonl=False)
    assert System(cfg).run()["n_frames"] == 2
    with open(tmp_path / "prof" / "trace.json") as f:
        assert len(json.load(f)["traceEvents"]) > 100
