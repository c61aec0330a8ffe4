"""The port's bench entry, ``python -m visionx_slam_torch.bench``: its
statistics equal the repository bench's, and its quick CPU run in a
process of its own ends in one compact JSON line (at most 500 characters)
with 20/20 frames tracked at the ATE of the port's offline pipeline on the
same 20 frames, computed here while the bench runs."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from visionx_slam_torch import bench as TB
from visionx_slam_torch.data import synthetic
from visionx_slam_torch.eval.trajectory import ate_of_run
from visionx_slam_torch.ops.camera import make_camera
from visionx_slam_torch.tracking.offline_pipeline import run_offline_pipeline
from visionx_slam_torch.utils.config import TrackingOptions

from torch_parity import SINGLE_THREAD_ENV, sequence, to_np


@pytest.mark.parametrize("times, n", [([0.5, 0.25, 1.0], 240),
                                      ([2.0, 2.0], 20), ([0.1], 8)])
def test_median_stats_equal_the_repository_bench(times, n):
    import bench   # the repository's bench imports no JAX at import time

    assert TB._median_stats(times, n) == bench._median_stats(times, n)


def test_quick_bench_ends_in_a_compact_line():
    env = {**os.environ, **SINGLE_THREAD_ENV}
    proc = subprocess.Popen(
        [sys.executable, "-m", "visionx_slam_torch.bench", "--quick",
         "--device", "cpu"], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env=env)
    try:
        grays, depths, gt = sequence(20, 5)
        cam = make_camera(synthetic.FX, synthetic.FY, synthetic.CX, synthetic.CY)
        _, out = run_offline_pipeline(cam, grays, depths, TrackingOptions(),
                                      device="cpu")
        ate, n_tracked = ate_of_run(to_np(out.pose), to_np(out.tracked), gt)
        stdout, stderr = proc.communicate(timeout=600)
    finally:
        proc.kill()
    assert proc.returncode == 0, stderr[-3000:]
    lines = stdout.strip().splitlines()
    last = lines[-1]
    assert len(last) <= 500, last
    summary = json.loads(last)
    assert summary["unit"] == "frames/sec" and summary["value"] > 0
    assert summary["vs_baseline"] == round(summary["value"] / 500.0, 4)
    assert summary["n_frames"] == 20 and summary["n_tracked"] == 20 == n_tracked
    assert summary["ate_rmse_m"] == ate
    assert summary["device"] == "cpu"
    detail = json.loads(lines[-2])["detail"]
    assert detail["n_runs"] == 2 and detail["fps_median"] == summary["value"]
    assert "configs" not in detail and "mfu" not in detail
    assert np.isfinite(detail["e2e_fps_first_run"])
