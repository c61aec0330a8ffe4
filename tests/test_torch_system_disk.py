"""The benchmark cell ``rgbd.system_disk`` at a size the CPU holds: its
feed writes a TUM directory with the reference's own PNG writer, runs
``System --pipeline scan --run_global_ba`` over it through the harness, and
the reference judges the files ``System`` wrote against the cell's own
limits. 24 frames taken 8 apart with an 8-slot ring and one pass a window:
the ring evicts, and the global BA is ``pair_ba`` over the union map of the
archive. The depth files get the configuration's hole model (15% of each
file, which the cell itself leaves out), so features in a hole adopt the
landmark of the keyframe before and the solve refines two-view landmarks
with the port's disparity row, within every limit. Faults
planted in the written files fail the judge; the reference's file module
loads nothing of the program, of torch or of JAX; the cell's per-layer
readers give None where a program leaves their keys out, and a traced
run of a program without the System clock still profiles its global BA."""

import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

import torch_parity  # noqa: F401  (one torch thread per test process)
from slambench import feeds, run, small
from slambench.reference import files

ROOT = Path(__file__).resolve().parents[1]
CELL = "rgbd.system_disk"
SEED = 2**31 + 77
NEW = ("decode_ms.disk", "scan_ms.disk", "gba_ms.disk",
       "syncs_per_frame.disk", "device_idle.disk", "gba_launches.disk",
       "gn_ms.disk", "match_ms.disk", "ransac_ms.disk", "k1_roofline.disk",
       "launches_per_frame.disk")


def small_spec() -> dict:
    spec = run.load_cell(CELL)
    spec["config"] = dict(spec["config"], depth_holes=dict(
        spec["config"]["depth_holes"], share=0.15))
    spec["traffic"] = dict(spec["traffic"], frames=24, frame_stride=8,
                           min_passes=1, system={"kf_capacity": 8})
    return spec


@pytest.fixture(scope="module")
def cell():
    """(the harness's result, the feed it ran) of one small run."""
    spec = small_spec()
    made = []
    base = feeds.load("system_disk")

    class Kept(base):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    load = feeds.load
    feeds.load = lambda kind: Kept
    try:
        out = small.run(spec, SEED, 0.1)
    finally:
        feeds.load = load
    return out, made[0], spec["limits"]


def test_a_small_run_is_correct_and_runs_pair_ba(cell):
    out, feed, limits = cell
    assert out["correct"] is True, out["checks"]
    assert set(out["checks"]) == set(limits) and out["failed"] == 0
    summary, path = feed.outs[-1]
    g = summary["global_ba"]
    # the ring evicted, so the solve covered the archive's union map
    assert g["archived_keyframes"] > 8
    assert g["iterations"] >= 1 and summary["n_tracked"] == 24
    kts, _ = files.read_trajectory(os.path.join(path, "trajectory_keyframes_gba.txt"))
    assert len(kts) == g["archived_keyframes"]
    # features in the depth holes adopted landmarks of the keyframe before:
    # the solve had two-view landmarks to move, and moved the map
    m = files.read_map(os.path.join(path, "map_snapshot.npz"))
    lm = m["kf_feat_lm"][(m["kf_id"] >= 0)[:, None] & m["kf_fvalid"]]
    assert (np.bincount(lm[lm >= 0]) == 2).sum() > 100
    assert g["mean_reproj_after_px"] != g["mean_reproj_before_px"]


def _judged(feed, plant) -> dict:
    """The reference's numbers with ``plant(dir)`` applied to a copy of the
    last pass's output directory."""
    summary, path = feed.outs[-1]
    broken = path + "_broken"
    shutil.rmtree(broken, ignore_errors=True)
    shutil.copytree(path, broken)
    plant(broken)
    outs = feed.outs
    feed.outs = [(summary, broken)]
    try:
        return feed.judge()
    finally:
        feed.outs = outs


def _move_landmarks(d):
    """2% of the live landmarks 1 m further along the ray from the first
    keyframe that observes each."""
    p = os.path.join(d, "map_snapshot.npz")
    with np.load(p) as z:
        arrs = {k: z[k] for k in z.files}
    m = {k: arrs[k] for k in files.MAP_FIELDS}
    used = m["kf_id"] >= 0
    lm = m["kf_feat_lm"][used]
    seen = np.unique(lm[(lm >= 0) & m["kf_fvalid"][used]])
    seen = seen[m["lm_alive"][seen]]
    pick = np.random.default_rng(0).choice(seen, max(1, len(seen) // 50),
                                           replace=False)
    R = files.quat_to_R(m["kf_q"][used].astype(np.float64))
    centre = -np.einsum("kji,kj->ki", R, m["kf_t"][used].astype(np.float64))
    pos = arrs["lm_pos"].astype(np.float64)
    for lid in pick:
        k = np.argwhere(lm == lid)[0, 0]
        ray = pos[:, lid] - centre[k]
        pos[:, lid] += ray / np.linalg.norm(ray)
    arrs["lm_pos"] = pos.astype(arrs["lm_pos"].dtype)
    np.savez_compressed(p, **arrs)


def _edit_rows(name, edit):
    def plant(d):
        p = os.path.join(d, name)
        lines = open(p).read().splitlines()
        rows = [i for i, line in enumerate(lines) if not line.startswith("#")]
        edit(lines, rows)
        with open(p, "w") as f:
            f.write("\n".join(lines) + "\n")
    return plant


def _shift(lines, rows):
    i = rows[len(rows) // 2]
    v = lines[i].split()
    v[1] = f"{float(v[1]) + 1.0:.6f}"
    lines[i] = " ".join(v)


FAULTS = {
    "landmarks_moved_1m": (_move_landmarks, "gba_obs_depth_p99_mm"),
    "keyframe_moved_1m": (_edit_rows("trajectory_keyframes_gba.txt", _shift),
                          "gba_ate_mm"),
    "row_dropped": (_edit_rows("trajectory.txt",
                               lambda lines, rows: lines.pop(rows[5])),
                    "lost_frames"),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_fault_in_the_files_fails_its_limit(cell, fault):
    _, feed, limits = cell
    plant, key = FAULTS[fault]
    sound = feed.judge()
    assert sound[key] <= limits[key]["limit"]
    nums = _judged(feed, plant)
    assert nums[key] > limits[key]["limit"], (key, nums[key])


@pytest.mark.parametrize("metric", NEW)
def test_the_readers_give_none_without_their_keys(metric):
    """What a program without the System clock gives, and a run whose
    trace saw no device."""
    ctx = dict(timings={}, frames=702, trace=None, traced_frames=0,
               atlas=(1896, 640), window_frames=702)
    assert run.reader(metric)(ctx) is None


def test_a_traced_run_of_a_system_without_the_clock_still_profiles():
    """A program whose ``System`` takes no ``timings`` gets its traced pass
    profiled from the start of its global BA: the result's device holds
    ``busy_s`` and ``window_s``, and the clock's markers are absent."""
    spec = run.load_cell(CELL)
    spec["traffic"] = dict(spec["traffic"], frames=4, frame_stride=48,
                           min_passes=1, system={"kf_capacity": 8,
                                                 "global_ba_iterations": 1})
    made = []
    base = feeds.load("system_disk")

    class Unclocked(base):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.clocked = False
            made.append(self)

    load = feeds.load
    feeds.load = lambda kind: Unclocked
    try:
        out, _ = run.run_cell(spec, SEED, 0.1, True, "cpu", time.time())
    finally:
        feeds.load = load
    feed = made[0]
    assert out["correct"] is True, out["checks"]
    assert feed.trace.done and out["device"]["window_s"] > 0
    assert "busy_s" in out["device"]
    names = {e.name for e in feed.trace.prof.events()}
    assert not any(n.startswith("lap:") for n in names)
    assert not feed.timings


def test_the_file_reference_loads_nothing_of_the_program_or_torch(tmp_path):
    code = f"""
import sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in {{"torch", "jax", "jaxlib", "visionx_slam_torch",
                                   "visionx_slam_tpu"}}:
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
import importlib.util, json
import numpy as np
spec = importlib.util.spec_from_file_location("files", "slambench/reference/files.py")
files = importlib.util.module_from_spec(spec)
spec.loader.exec_module(files)
R = np.tile(np.eye(3), (3, 1, 1))
files.write_sequence({str(tmp_path)!r}, "rgbd_dataset_freiburg1_desk",
    dict(fx=517.3, fy=516.5, cx=318.6, cy=255.3), [1.0, 1.1, 1.2],
    np.zeros((3, 4, 5), np.uint8), np.ones((3, 4, 5), np.uint16), R,
    np.zeros((3, 3)))
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-3000:]
    names = set(json.loads(res.stdout.strip().splitlines()[-1]))
    assert not names & {"torch", "jax", "jaxlib", "visionx_slam_torch",
                        "visionx_slam_tpu"}
    seq = tmp_path / "rgbd_dataset_freiburg1_desk"
    assert len(list((seq / "rgb").iterdir())) == 3
    assert (tmp_path / "color_camera_freiburg1.txt").read_text().splitlines()[1] \
        == "517.3 516.5 318.6 255.3 0 0 0 0 0"
