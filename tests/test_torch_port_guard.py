"""The port stands alone: it imports neither jax, cv2 nor
``visionx_slam_tpu`` (the GPU host has no jax and no cv2) — every module,
and the offline pipeline (one lane, folded lanes, monocular, with the
monocular loop closure), the online
scan (plain, with culling, batched, archived with the full-map global BA,
resumed from a snapshot), ``pair_ba``, the ``System`` class on a
sequence it wrote to disk (``scan``, ``offline`` and ``host``), the
multi-device step on a world of one and ``entry``'s forward run end to
end — and its in-memory sequence is bit-for-bit the one the bench loads
from PNGs."""

import os
import subprocess
import sys

import numpy as np

from visionx_slam_torch.data import synthetic

from torch_parity import SINGLE_THREAD_ENV

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
_, outl = run_offline_pipeline(cam, g, np.zeros_like(d), TrackingOptions(),
                               device="cpu", monocular=True, kf_capacity=4,
                               mono_loop_pairs=2, mono_loop_merge=True,
                               mono_loop_min_gap=1)
assert bool(np.isfinite(outl.pose.numpy()).all())
st, out = run_scan_pipeline(cam, g, d, TrackingOptions(), device="cpu",
                            kf_capacity=8, lm_capacity=8192)
ate, n = ate_of_run(out.pose.numpy(), out.tracked.numpy(), gt)
assert n == 4 and ate < 0.02, (n, ate)
import dataclasses, os, tempfile
from visionx_slam_torch.models.pair_ba import pair_ba
from visionx_slam_torch.system import system
from visionx_slam_torch.tracking.scan_pipeline import (
    resume_state, run_scan_pipeline_batched)
kw = dict(kf_capacity=8, lm_capacity=8192)
cull = dataclasses.replace(TrackingOptions(), enable_culling=True)
_, outc = run_scan_pipeline(cam, g, d, cull, device="cpu", **kw)
assert outc.pose.shape == (4, 4, 4)
_, outb = run_scan_pipeline_batched(cam, np.stack([g, g[::-1]]),
                                    np.stack([d, d[::-1]]), TrackingOptions(),
                                    device="cpu", **kw)
assert outb.pose.shape == (4, 2, 4, 4) and bool(outb.tracked.all())
st, outa, archive, gba = system.run_scan_archived(
    cam, g, d, TrackingOptions(), gba_iterations=1, device="cpu", **kw)
assert len(archive) == 2 and gba["total_obs"] > 0
ums, links = system.archive_union_map(archive, cam, TrackingOptions(), device="cpu")
_, pstats = pair_ba(ums, cam, links)
assert int(pstats.total_obs) > 0
with tempfile.TemporaryDirectory() as tmp:
    snap = os.path.join(tmp, "map_snapshot.npz")
    system.save_snapshot(snap, st.ms, 4)
    ms2, meta = system.load_snapshot_full(snap, device="cpu")
    assert meta == {"next_frame_id": 4} and resume_state(ms2).tstate == scan_pipeline.GOOD
    _, outr, _, _ = system.run_scan_archived(cam, g[2:], d[2:], TrackingOptions(),
                                             run_gba=False, resume_from=snap,
                                             device="cpu", **kw)
    assert bool(outr.tracked.all())
    from visionx_slam_torch.cli.main import parse_config
    from visionx_slam_torch.data import tum
    synthetic.generate_sequence(tmp, n_frames=4, seed=5)
    seq = "rgbd_dataset_freiburg3_synthetic"
    ds = tum.TumDataset(tmp, seq)
    assert ds.load() and np.array_equal(tum.load_rgb_gray(ds.entries[3].rgb_path), g[3])
    for pipeline in ("scan", "offline", "host"):
        cfg = parse_config(["--dataset_dir", tmp, "--sequence", seq, "--device", "cpu",
                            "--output_dir", os.path.join(tmp, pipeline),
                            "--pipeline", pipeline, "--kf_capacity", "8"])
        summary = system.System(cfg).run()
        assert summary["n_tracked"] == 4 and summary["ate_rmse"] < 0.02, summary
        assert os.path.isfile(os.path.join(tmp, pipeline, "map.ply"))
from visionx_slam_torch import entry
from visionx_slam_torch.models.local_ba import BAOptions
from visionx_slam_torch.parallel import batch as pb
mesh = pb.make_mesh(device="cpu")
cam_s = make_camera(100.0, 100.0, 32.0, 24.0)
mss, obss, fids, gens, _ = pb.make_correlated_fleet(cam_s, 2, 64, device="cpu")
_, poses, fleet = pb.batched_slam_step(mesh, cam_s, n_hypotheses=16,
                                       ba_opts=BAOptions(max_iterations=2))(
    mss, obss, fids, gens)
assert poses.shape == (2, 4, 4) and int(fleet["total_inliers"]) >= 64, fleet
fn, ex = entry.entry("cpu")
assert int(fn(*ex)[2]) > 0
from visionx_slam_torch.models.orb import OpenCVExtractor
try:
    OpenCVExtractor()
    raise SystemExit("the cv2 extractor was built without cv2")
except ImportError as e:
    assert "cv2" in str(e), e
loaded = [m for m in ("jax", "cv2", "visionx_slam_tpu") if sys.modules.get(m)]
assert not loaded, loaded
print("GUARD-OK")
"""


def test_port_imports_no_jax_cv2_or_reference():
    res = subprocess.run([sys.executable, "-c", _GUARD], capture_output=True,
                         text=True, timeout=1200,
                         env={**os.environ, **SINGLE_THREAD_ENV})
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
