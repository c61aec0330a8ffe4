"""The port's RGB-D offline pipeline against the JAX package's on 16 frames
of 640x480 (seed 7, kf_capacity 16 — the shape of
tests/test_offline_pipeline.py). RANSAC randomness cannot be shared
(``jax.random`` vs ``torch.Generator``), so the parity is a band: both
track >= 15/16 frames, keyframe decisions agree on >= 0.9 of the frames,
both ATEs are under 2 cm and within 5 mm of each other, and the landmark
counts are within 10%."""

import numpy as np
import pytest

from visionx_slam_tpu.tracking.offline_pipeline import (
    run_offline_pipeline as jax_run,
)
from visionx_slam_tpu.utils.config import TrackingOptions as JOpts

from visionx_slam_torch.eval.trajectory import ate_of_run
from visionx_slam_torch.ops import detect
from visionx_slam_torch.tracking.offline_pipeline import (
    build_offline_pipeline,
    run_offline_pipeline,
)
from visionx_slam_torch.utils.config import TrackingOptions

from torch_parity import cameras, sequence, t, to_np


@pytest.fixture(scope="module")
def runs():
    grays, depths, gt = sequence(16, 7)
    jc, tc = cameras()
    _, oj = jax_run(jc, grays, depths, JOpts(), kf_capacity=16)
    timings = {}
    ms, ot = run_offline_pipeline(tc, grays, depths, TrackingOptions(),
                                  device="cpu", kf_capacity=16, timings=timings)
    return oj, ot, ms, gt, timings


def test_offline_matches_jax_band(runs):
    oj, ot, _, gt, _ = runs
    tr_j, tr_t = np.asarray(oj.tracked), to_np(ot.tracked)
    assert tr_j.sum() >= 15 and tr_t.sum() >= 15, (tr_j, tr_t)
    kf_j, kf_t = np.asarray(oj.is_keyframe), to_np(ot.is_keyframe)
    assert (kf_j == kf_t).mean() >= 0.9, (kf_j, kf_t)
    ate_j, _ = ate_of_run(np.asarray(oj.pose), tr_j, gt)
    ate_t, _ = ate_of_run(to_np(ot.pose), tr_t, gt)
    assert ate_j < 0.02 and ate_t < 0.02, (ate_j, ate_t)
    assert abs(ate_j - ate_t) <= 0.005, (ate_j, ate_t)
    n_j, n_t = int(oj.n_landmarks), int(ot.n_landmarks)
    assert abs(n_t - n_j) <= 0.1 * n_j, (n_j, n_t)
    assert int(ot.n_keyframes) == int(kf_t.sum())


def test_offline_outputs_are_consistent(runs):
    _, ot, ms, _, timings = runs
    T = 16
    assert ot.pose.shape == (T, 4, 4) and np.isfinite(to_np(ot.pose)).all()
    # the five stages, their sub-spans and the host-sync count
    stages = {"extract", "pairs", "map", "refine", "retrack"}
    assert {k for k in timings if "/" not in k} == stages | {"#host_syncs"}
    assert all(k.split("/")[0] in stages for k in timings if "/" in k)
    # every keyframe link points at an alive landmark; counts match links
    feat_lm = to_np(ms.kf_feat_lm)
    alive = to_np(ms.lm_alive)
    linked = feat_lm[feat_lm >= 0]
    assert alive[linked].all()
    counts = np.bincount(linked, minlength=alive.shape[0])
    np.testing.assert_array_equal(to_np(ms.lm_obs), counts)
    # keyframe slots hold the keyframes, ascending, dead slots first
    ids = to_np(ms.kf_id)
    live = ids[ids >= 0]
    np.testing.assert_array_equal(live, np.flatnonzero(to_np(ot.is_keyframe)))


def test_stages_compose_and_stay_off_the_kernel_on_cpu():
    grays, depths, _ = sequence(16, 7)
    _, tc = cameras()
    run = build_offline_pipeline(TrackingOptions(), kf_capacity=8,
                                 extract_chunk=3, pair_chunk=5)
    before = detect.launches
    ms, links, aux = run.pre(tc, t(grays[:6]), t(depths[:6]))
    ms, out = run.post(tc, run.refine(tc, ms), aux)
    assert detect.launches == before   # CPU tensors take the plain version
    assert out.tracked.shape == (6,) and bool(out.tracked.all())
    assert links.created.shape == (8, 1024)
