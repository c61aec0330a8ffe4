"""The port's normal entry point on the CPU, over one synthetic sequence
written to disk by the port: ``--pipeline host`` against the JAX package's
``System`` with the cv2 ORB oracle (as ``tests/test_pipeline.py`` runs it):
equal per-frame states and keyframe flags, ATE within 25% + 1 mm (the
RANSAC draws differ); either package's snapshot loads in the other; and
``python -m visionx_slam_torch.cli.main ... --device cpu --max_frames 20``
prints the summary line and leaves the output files."""

import dataclasses
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest

from visionx_slam_tpu.system.system import System as JSystem
from visionx_slam_tpu.utils import config as jconfig

from visionx_slam_torch import convert
from visionx_slam_torch.cli import main as tmain
from visionx_slam_torch.data import synthetic
from visionx_slam_torch.system.system import System

from torch_parity import SINGLE_THREAD_ENV

SEQ = "rgbd_dataset_freiburg3_synthetic"
T = 20
T_HOST = 10      # frames of the host-path comparison


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("cli"))
    synthetic.generate_sequence(path, n_frames=T, seed=5)
    return path


@pytest.fixture(scope="module")
def host_runs(root, tmp_path_factory):
    """Both packages' ``System`` on ``--pipeline host`` with the cv2
    extractor; the port's configuration is made from the JAX package's."""
    out = tmp_path_factory.mktemp("host")
    jcfg = jconfig.SystemConfig(
        dataset_dir=root, sequence=SEQ, output_dir=str(out / "jax"),
        extractor="opencv", max_frames=T_HOST)
    tcfg = convert.systemconfig_from_dict(jconfig.config_to_dict(jcfg), device="cpu")
    tcfg.output_dir = str(out / "torch")
    jsys, tsys = JSystem(jcfg), System(tcfg)
    return jsys, jsys.run(), tsys, tsys.run(), out


def test_host_pipeline_matches_the_jax_system(host_runs):
    jsys, js, tsys, ts, _ = host_runs
    opts = dataclasses.asdict(tsys.cfg.tracking)
    assert opts.pop("track_local_map") is False     # the port's own, off
    assert opts == dataclasses.asdict(jsys.cfg.tracking)
    assert [r.state for r in tsys.results] == [r.state for r in jsys.results]
    assert ([r.is_keyframe for r in tsys.results]
            == [r.is_keyframe for r in jsys.results])
    for key in ("n_frames", "n_tracked", "n_keyframes"):
        assert ts[key] == js[key], key
    assert ts["n_tracked"] >= T_HOST - 1 and ts["n_keyframes"] >= 3
    assert abs(ts["n_landmarks"] - js["n_landmarks"]) <= 0.02 * js["n_landmarks"]
    assert ts["ate_rmse"] <= 1.25 * js["ate_rmse"] + 1e-3 and ts["ate_rmse"] < 0.05
    assert abs(ts["rpe_trans_rmse"] - js["rpe_trans_rmse"]) <= 2e-3
    assert set(js) <= set(ts)                 # every key of the JAX summary
    assert ts["host_reads_per_frame"] > 0 and ts["loader"] in ("native", "python")
    assert {"extract", "track"} <= set(ts["stage_timings"])


def test_snapshots_load_in_either_package(host_runs):
    jsys, _, tsys, _, out = host_runs
    snap_t = str(out / "torch" / "map_snapshot.npz")
    snap_j = str(out / "jax" / "map_snapshot.npz")
    ms_j = JSystem.load_snapshot(snap_t)         # the port's, in the JAX package
    for f in ms_j._fields:
        a, b = np.asarray(getattr(ms_j, f)), getattr(tsys.tracker.ms, f).numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    ms_t, meta = System.load_snapshot_full(snap_j, device="cpu")   # and back
    assert meta == {"next_frame_id": T_HOST}
    for f in ms_t._fields:
        a, b = getattr(ms_t, f).numpy(), np.asarray(getattr(jsys.tracker.ms, f))
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert JSystem.load_snapshot_full(snap_t)[1] == {"next_frame_id": T_HOST}


def test_cli_runs_a_sequence_from_disk(root, tmp_path):
    """The verify recipe: the default pipeline (host) with the on-device
    ORB, on the CPU because it is asked for."""
    out = tmp_path / "out"
    res = subprocess.run(
        [sys.executable, "-m", "visionx_slam_torch.cli.main", "--dataset_dir", root,
         "--sequence", SEQ, "--output_dir", str(out), "--max_frames", "20",
         "--device", "cpu"],
        capture_output=True, text=True, timeout=600,
        cwd=os.path.join(os.path.dirname(__file__), ".."),
        env={**os.environ, **SINGLE_THREAD_ENV})
    assert res.returncode == 0, res.stderr[-3000:]
    line = res.stdout.strip().splitlines()[-1]
    m = re.fullmatch(r"tracked (\d+)/20 frames, (\d+) keyframes, (\d+) landmarks, "
                     r"[\d.]+ fps, ATE RMSE ([\d.]+) m", line)
    assert m, line
    assert int(m.group(1)) >= 19 and int(m.group(2)) >= 3
    for name in ("trajectory.txt", "frames.jsonl", "metrics.json",
                 "map_snapshot.npz", "map.ply"):
        assert (out / name).is_file(), name
    with open(out / "metrics.json") as f:
        metrics = json.load(f)
    assert metrics["ate_rmse"] < 0.05 and metrics["device"] == "cpu"
    assert float(m.group(4)) == pytest.approx(metrics["ate_rmse"], abs=1e-4)
    assert metrics["n_tracked"] == int(m.group(1))


def test_cli_raises_without_a_card_unless_the_cpu_is_asked_for(root, tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmain.entrypoint(["--dataset_dir", root, "--sequence", SEQ,
                          "--output_dir", str(tmp_path), "--max_frames", "2"])


def test_extract_cli_writes_keypoints_and_overlay(root, tmp_path):
    from visionx_slam_torch.cli import extract
    from visionx_slam_torch.data import png

    rgb_dir = os.path.join(root, SEQ, "rgb")
    image = os.path.join(rgb_dir, sorted(os.listdir(rgb_dir))[0])
    prefix = str(tmp_path / "f" / "features")
    assert extract.entrypoint(["--image", image, "--device", "cpu",
                               "--out_prefix", prefix]) == 0
    with open(prefix + ".txt") as f:
        rows = [line.split() for line in f if not line.startswith("#")]
    assert len(rows) > 500 and len(rows[0]) == 4 and len(rows[0][3]) == 64
    img = png.read_png(prefix + ".png")
    assert img.shape == (480, 640, 3)
    assert ((img[..., 1] == 255) & (img[..., 0] == 0) & (img[..., 2] == 0)).sum() > 500
    assert extract.entrypoint(["--image", str(tmp_path / "none.png"),
                               "--device", "cpu"]) == 1


def test_plot_cli(host_runs, root, tmp_path):
    from visionx_slam_torch.cli import plot

    run_dir = str(host_runs[4] / "torch")
    os.remove(os.path.join(run_dir, "map.ply"))
    rc = plot.main(["--run_dir", run_dir, "--groundtruth",
                    os.path.join(root, SEQ, "groundtruth.txt")])
    assert os.path.isfile(os.path.join(run_dir, "map.ply"))   # written again
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        assert rc == 2
    else:
        assert rc == 0 and os.path.isfile(os.path.join(run_dir, "trajectory.png"))
    assert plot.main(["--run_dir", str(tmp_path)]) == 1
