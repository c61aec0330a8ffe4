"""Monocular mode of the port against the JAX package (BASELINE configs 2b
and 2), no sensor depth.

Offline (config 2b's path) at the shape of tests/test_offline_mono.py: 40
frames of 640x480 (seed 11, 48 frames per trajectory loop), the default
mono budget. Essential RANSAC on 4-6 cm baselines is float32 noise in both
packages (tests/test_torch_essential.py), so each run is one draw of a
wide distribution. Measured on the CPU over the stage seeds offset by 0,
100, ..., 900 (port) and 11 JAX keys: scale-aligned ATE 0.170-0.266 m
(port) and 0.151-0.387 m (JAX); landmarks 2-1730, median 1206 (port), and
99-1951, median 1343 (JAX): one draw in ten collapses the scale gauge in
each. So the test holds this draw of each: both track >= 35 frames, both
ATEs under 0.25 m and within 0.1 m of each other, both maps hold more than
500 landmarks made from triangulated depth (the sensor depth is zero), and
the chain's per-step scale spread (90th / 10th percentile of estimated
over true step length) stays under 6 for both.

Scan (config 2's path) with the monocular option set on 24 frames of the
bench loop (scene seed 5) at stride 4, a ring of 8 keyframes. Over 8 draws
of its per-frame keys (tools/mono_scan_draws.py --source 96 --kf-capacity 8
--lm-capacity 16384) the JAX package tracks 19-24 frames (median 23.5) at
scale-aligned ATEs of 10.4-158.3 mm, median 15.5 mm: six draws read
10-21 mm, one 69 mm, and the package's own draw loses frames 15-20 and
reads 158 mm. The port's scan reads 23/24 at 16.5 mm whatever its seeds
(the init's essential RANSAC converges to one solution and no later frame
escalates to RANSAC). So the port is held to the spread of JAX's draws:
tracked at least JAX's median less 2, ATE at most 1.5x JAX's median; and
the JAX run here must be one of the measured draws' range, which keeps the
pinned spread true to the package."""

import dataclasses

import numpy as np
import pytest

import jax

from visionx_slam_tpu.tracking import mapstate as jmsl
from visionx_slam_tpu.tracking.offline_pipeline import (
    run_offline_pipeline as jax_offline,
)
from visionx_slam_tpu.tracking.scan_pipeline import run_scan_pipeline as jax_scan
from visionx_slam_tpu.utils.config import TrackingOptions as JOpts

from visionx_slam_torch.eval.trajectory import ate_of_run, tcw_to_twc
from visionx_slam_torch.ops import detect
from visionx_slam_torch.tracking import mapstate as msl
from visionx_slam_torch.tracking.offline_pipeline import run_offline_pipeline
from visionx_slam_torch.tracking.scan_pipeline import run_scan_pipeline
from visionx_slam_torch.utils.config import TrackingOptions

from torch_parity import cameras, sequence, to_np

# the JAX scan's 8 draws at the scan test's shape (module docstring)
SCAN_ATE_JAX_DRAWS = (0.158309, 0.010414, 0.069370, 0.014900,
                      0.012638, 0.015252, 0.015717, 0.020717)
SCAN_TRACKED_JAX_DRAWS = (19, 22, 24, 21, 23, 24, 24, 24)


@pytest.fixture(scope="module")
def offline():
    grays, depths, gt = sequence(40, 11, 48)
    zero = np.zeros(depths.shape, np.float32)
    jc, tc = cameras()
    ms_j, oj = jax_offline(jc, grays, zero, JOpts(), monocular=True)
    jax.block_until_ready(oj)
    before = detect.launches
    ms_t, ot = run_offline_pipeline(tc, grays, zero, TrackingOptions(),
                                    device="cpu", monocular=True)
    assert detect.launches == before     # CPU tensors take K1's plain version
    return ms_j, oj, ms_t, ot, gt


def _scale_spread(pose, tracked, gt):
    ratios = []
    for i in range(len(tracked) - 1):
        if tracked[i] and tracked[i + 1]:
            est = np.linalg.norm(tcw_to_twc(pose[i + 1])[:3, 3]
                                 - tcw_to_twc(pose[i])[:3, 3])
            true = np.linalg.norm(gt[i + 1] - gt[i])
            if true > 1e-6 and est > 1e-9:
                ratios.append(est / true)
    assert len(ratios) >= 20
    return np.percentile(ratios, 90) / np.percentile(ratios, 10)


def test_offline_mono_matches_jax_band(offline):
    ms_j, oj, ms_t, ot, gt = offline
    tr_j, tr_t = np.asarray(oj.tracked), to_np(ot.tracked)
    assert tr_j.sum() >= 35 and tr_t.sum() >= 35, (tr_j.sum(), tr_t.sum())
    ate_j, _ = ate_of_run(np.asarray(oj.pose), tr_j, gt, with_scale=True)
    ate_t, _ = ate_of_run(to_np(ot.pose), tr_t, gt, with_scale=True)
    assert ate_j < 0.25 and ate_t < 0.25, (ate_j, ate_t)
    assert abs(ate_j - ate_t) <= 0.1, (ate_j, ate_t)
    n_j, n_t = int(jmsl.n_landmarks(ms_j)), int(msl.n_landmarks(ms_t))
    assert n_j > 500 and n_t > 500, (n_j, n_t)
    assert _scale_spread(np.asarray(oj.pose), tr_j, gt) < 6.0
    assert _scale_spread(to_np(ot.pose), tr_t, gt) < 6.0


def test_offline_mono_map_is_triangulated(offline):
    _, _, ms, ot, _ = offline
    T = 40
    assert ot.pose.shape == (T, 4, 4) and np.isfinite(to_np(ot.pose)).all()
    # one landmark per live keyframe feature with a synthesized depth in
    # the map's depth gate
    dep = to_np(ms.kf_depth)
    want = to_np(ms.kf_fvalid) & (dep >= 0.1) & (dep <= 10.0)
    assert want.sum() == int(msl.n_landmarks(ms)) > 0
    # the stride-2 link pass gives landmarks a third view
    assert (to_np(ms.lm_obs) >= 3).sum() > 0
    feat_lm = to_np(ms.kf_feat_lm)
    linked = feat_lm[feat_lm >= 0]
    np.testing.assert_array_equal(
        to_np(ms.lm_obs), np.bincount(linked, minlength=ms.lm_obs.shape[0]))
    assert int(ot.n_keyframes) == int(to_np(ot.is_keyframe).sum())


def test_mono_loop_closure_runs():
    """The loop-closure options run (held to the JAX package by
    tests/test_torch_mono_loop*.py): 12 frames, revisit partners 4 frames
    back, the merge and the two-phase refine on."""
    grays, _, _ = sequence(40, 11, 48)
    g = grays[:12]
    _, tc = cameras()
    stats, timings = {}, {}
    ms, out = run_offline_pipeline(
        tc, g, np.zeros(g.shape, np.float32), TrackingOptions(), device="cpu",
        monocular=True, kf_capacity=8, mono_loop_pairs=4, mono_loop_merge=True,
        mono_loop_min_gap=4, stats=stats, timings=timings)
    assert np.isfinite(to_np(out.pose)).all() and to_np(out.tracked).sum() >= 10
    assert {"loop_scale", "loop_merge", "refine_wide"} <= set(timings)
    assert 0 < stats["loop_factor_min"] <= stats["loop_factor_max"]
    assert stats["loop_pairs_verified"] >= 0 and stats["loop_links_merged"] >= 0


def test_mono_scan_matches_jax_band():
    grays, _, gt = sequence(96, 5)
    g, gt = grays[::4], gt[::4]
    zero = np.zeros(g.shape, np.float32)
    jc, tc = cameras()
    opts = dict(link_tracked_landmarks=True, min_init_landmarks=25)
    kw = dict(kf_capacity=8, lm_capacity=16384)
    _, oj = jax_scan(jc, g, zero, dataclasses.replace(JOpts(), **opts), **kw)
    jax.block_until_ready(oj)
    stats = {}
    _, ot = run_scan_pipeline(tc, g, zero, TrackingOptions(**opts), device="cpu",
                              stats=stats, **kw)
    tr_j, tr_t = np.asarray(oj.tracked), to_np(ot.tracked)
    ate_j, _ = ate_of_run(np.asarray(oj.pose), tr_j, gt, with_scale=True)
    ate_t, _ = ate_of_run(to_np(ot.pose), tr_t, gt, with_scale=True)
    assert tr_j.sum() >= min(SCAN_TRACKED_JAX_DRAWS), tr_j
    assert min(SCAN_ATE_JAX_DRAWS) <= ate_j <= max(SCAN_ATE_JAX_DRAWS), ate_j
    assert tr_t.sum() >= np.median(SCAN_TRACKED_JAX_DRAWS) - 2, tr_t
    assert ate_t <= 1.5 * np.median(SCAN_ATE_JAX_DRAWS), (ate_t, SCAN_ATE_JAX_DRAWS)
    assert int(ot.n_landmarks[-1]) > 0 and stats["ba_iterations"] > 0, stats
