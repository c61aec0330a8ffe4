"""``System``'s stage clock and its Python loader over a TUM directory that
the benchmark's reference wrote (24 frames of the fr1/desk loop taken 8
apart, an 8-slot ring, so the global BA solves the archive's union map):
with ``timings`` a ``--pipeline scan --run_global_ba`` run writes the
stage keys, the spans of the scan and of the global BA and the host-sync
count, and its stage keys tile the run, and it counts the frames its loader's workers had
decoded when the scan asked for them; without ``timings`` it writes nothing
and returns what it returned before; the Python loader returns the written
arrays bit for bit."""

import json
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (one torch thread per test process)
from slambench import run
from slambench.data import scene
from slambench.reference import files
from visionx_slam_torch.data import tum
from visionx_slam_torch.system.system import SCAN_COUNTS, System
from visionx_slam_torch.utils.config import SystemConfig

ROOT = Path(__file__).resolve().parents[1]
SEQ = "rgbd_dataset_freiburg1_desk"
STAGES = ("decode", "scan", "gba", "outputs")


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    """(root, grays [T,H,W] u8, depths [T,H,W] f32 m) as the cell's feed
    renders and writes them."""
    cfg = json.loads((ROOT / "slambench/configs/tum_rgbd_fr1_desk_files.json")
                     .read_text())
    cap = scene.Capture.from_config(cfg)
    ids = (8 * np.arange(24)) % cap.loop_frames
    g, d = cap.render(scene.make_scene(2**31 + 5), *cap.trajectory(ids), "cpu")
    root = str(tmp_path_factory.mktemp("tum"))
    units = torch.round(d.double() * cap.depth_scale).numpy().astype(np.uint16)
    files.write_sequence(root, SEQ, cfg["camera"], 1.0 + np.arange(24) / 30,
                         g.numpy(), units, *cap.trajectory(ids))
    return root, g.numpy(), d.numpy()


def _run(root, out, timings=None):
    cfg = SystemConfig(dataset_dir=root, sequence=SEQ, output_dir=str(out),
                       pipeline="scan", run_global_ba=True, kf_capacity=8,
                       loader="python", device="cpu")
    system = System(cfg) if timings is None else System(cfg, timings=timings)
    t = time.perf_counter()
    summary = system.run()
    return system, summary, time.perf_counter() - t


@pytest.fixture(scope="module")
def runs(written, tmp_path_factory):
    timings = {}
    clocked = _run(written[0], tmp_path_factory.mktemp("a"), timings)
    plain = _run(written[0], tmp_path_factory.mktemp("b"))
    return clocked, plain, timings


def test_the_python_loader_returns_the_written_arrays(written):
    root, grays, depths = written
    system = System(SystemConfig(dataset_dir=root, sequence=SEQ, loader="python",
                                 device="cpu"))
    got = list(system._frames(system.dataset.entries))
    assert system.loader_used == "python" and len(got) == len(grays)
    np.testing.assert_array_equal(np.stack([g for g, _ in got]), grays)
    np.testing.assert_array_equal(np.stack([d for _, d in got]), depths)


def test_timings_hold_the_stage_clock_and_tile_the_run(runs):
    (system, summary, wall), _, timings = runs
    assert summary["global_ba"]["archived_keyframes"] > 8
    counts = ("#host_syncs", "#decode_ahead", *SCAN_COUNTS)
    for k in (*STAGES, "gba/harvest", "gba/union", "gba/solve", *counts):
        assert k in timings, k
    assert all(k in STAGES or "/" in k or k in counts for k in timings)
    total = sum(timings[k] for k in STAGES)
    assert abs(total - wall) <= 0.01 * wall, (total, wall)
    spans = sum(v for k, v in timings.items() if k.startswith("gba/"))
    assert spans <= timings["gba"]
    # the scan's reads (as ScanStream counts them) are among the syncs
    assert timings["#host_syncs"] > summary["scan_stats"]["host_syncs"] > 0


def test_the_scan_spans_tile_the_scan_lap(runs):
    """The scan's spans split its lap: the upload, a chunk's ORB, and a
    frame's matching, RANSAC, Gauss-Newton, a keyframe event up to local BA,
    local BA, and the rest of its step."""
    _, _, timings = runs
    keys = [f"scan/{k}" for k in ("upload", "orb", "match", "ransac", "gn",
                                  "kf", "lba", "step")]
    for k in keys:
        assert k in timings and timings[k] >= 0, k
    assert sum(timings[k] for k in keys) <= timings["scan"]


def test_on_the_cpu_no_local_ba_runs_on_k3(runs):
    """The scan counts its local BA calls that ran on kernel K3: none on
    the CPU, where every keyframe event runs the plain version."""
    (_, summary, _), (_, plain, _), _ = runs
    for s in (summary, plain):
        assert s["scan_stats"]["kf_events"] > 0
        assert s["scan_stats"]["lba_kernel"] == 0


def test_lba_ms_reads_the_lba_spans(runs):
    """``lba_ms.disk`` reads the ``scan/lba`` spans a frame, and nothing
    where the program has no such span (the parent of kernel K3)."""
    (_, summary, _), _, timings = runs
    read = run.reader("lba_ms.disk")
    n = summary["n_frames"]
    assert read({"timings": timings, "frames": n}) == 1e3 * timings["scan/lba"] / n
    without = {k: v for k, v in timings.items() if k != "scan/lba"}
    assert read({"timings": without, "frames": n}) is None
    assert read({"timings": timings, "frames": 0}) is None


def test_without_timings_nothing_is_kept_and_the_run_is_the_same(runs):
    (a, sa, _), (b, sb, _), _ = runs
    assert b.timings is None
    assert set(sa) == set(sb) and set(sa["stage_timings"]) == set(sb["stage_timings"])
    np.testing.assert_array_equal(np.stack([r.pose_T_cw for r in a.results]),
                                  np.stack([r.pose_T_cw for r in b.results]))
    for x, y in zip(a.tracker.ms, b.tracker.ms):
        assert torch.equal(x, y)
    for k in ("n_tracked", "n_keyframes", "n_landmarks", "ate_rmse"):
        assert sa[k] == sb[k], k
    assert sa["global_ba"]["final_cost"] == sb["global_ba"]["final_cost"]


def test_the_scan_counts_the_frames_its_loader_decoded_ahead(runs):
    (_, summary, wall), _, timings = runs
    n = summary["n_frames"]
    assert summary["loader"] == "python"
    assert timings["#decode_ahead"] == summary["decode_ahead"]
    assert 0 <= timings["#decode_ahead"] <= n == 24
    # the count is no stage: the stage keys alone tile the run
    assert abs(sum(timings[k] for k in STAGES) - wall) <= 0.01 * wall
