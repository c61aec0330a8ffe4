"""The port stands alone: it imports neither jax, cv2 nor
``visionx_slam_tpu`` (the GPU host has no jax and no cv2) — every module,
and the offline pipeline (one lane, folded lanes, monocular) and the online
scan run end to end — and its
in-memory sequence is bit-for-bit the one the bench loads from PNGs."""

import subprocess
import sys

import numpy as np

from visionx_slam_torch.data import synthetic

_GUARD = r"""
import importlib, pkgutil, sys
import numpy as np
for name in ("jax", "jaxlib", "cv2", "visionx_slam_tpu"):
    sys.modules[name] = None          # any import of these now fails
import visionx_slam_torch
for m in pkgutil.walk_packages(visionx_slam_torch.__path__, "visionx_slam_torch."):
    importlib.import_module(m.name)
from visionx_slam_torch import convert
from visionx_slam_torch.data import synthetic
from visionx_slam_torch.eval.trajectory import ate_of_run
from visionx_slam_torch.models import estimation, local_ba, matching, orb_torch
from visionx_slam_torch.ops import detect, linalg
from visionx_slam_torch.ops.camera import make_camera
from visionx_slam_torch.tracking import mapstate, scan_pipeline, stages
from visionx_slam_torch.tracking.offline_pipeline import (
    run_offline_pipeline, run_offline_pipeline_batched)
from visionx_slam_torch.tracking.scan_pipeline import run_scan_pipeline
from visionx_slam_torch.utils.config import TrackingOptions
g, d, gt = synthetic.make_sequence(4)
cam = make_camera(synthetic.FX, synthetic.FY, synthetic.CX, synthetic.CY)
ms, out = run_offline_pipeline(cam, g, d, TrackingOptions(), device="cpu",
                               kf_capacity=4)
ate, n = ate_of_run(out.pose.numpy(), out.tracked.numpy(), gt)
assert n == 4 and ate < 0.02, (n, ate)
_, outb = run_offline_pipeline_batched(cam, np.stack([g, g[::-1]]),
                                      np.stack([d, d[::-1]]), TrackingOptions(),
                                      device="cpu", kf_capacity=4)
assert outb.pose.shape == (2, 4, 4, 4) and bool(outb.tracked.all())
ate, n = ate_of_run(outb.pose[0].numpy(), outb.tracked[0].numpy(), gt)
assert n == 4 and ate < 0.02, (n, ate)
_, outm = run_offline_pipeline(cam, g, np.zeros_like(d), TrackingOptions(),
                               device="cpu", monocular=True, kf_capacity=4)
assert outm.pose.shape == (4, 4, 4) and bool(np.isfinite(outm.pose.numpy()).all())
st, out = run_scan_pipeline(cam, g, d, TrackingOptions(), device="cpu",
                            kf_capacity=8, lm_capacity=8192)
ate, n = ate_of_run(out.pose.numpy(), out.tracked.numpy(), gt)
assert n == 4 and ate < 0.02, (n, ate)
loaded = [m for m in ("jax", "cv2", "visionx_slam_tpu") if sys.modules.get(m)]
assert not loaded, loaded
print("GUARD-OK")
"""


def test_port_imports_no_jax_cv2_or_reference():
    res = subprocess.run([sys.executable, "-c", _GUARD], capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0 and "GUARD-OK" in res.stdout, res.stderr[-3000:]


def test_make_sequence_equals_bench_loader():
    import bench

    n = 4
    _, _, _, grays, depths, gts = bench._load_sequence(n, seed=5)
    g, d, gt = synthetic.make_sequence(n, seed=5)
    assert g.dtype == grays.dtype and d.dtype == depths.dtype
    np.testing.assert_array_equal(g, grays)
    np.testing.assert_array_equal(d, depths)
    np.testing.assert_array_equal(gt, gts)
