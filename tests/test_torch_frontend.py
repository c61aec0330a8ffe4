"""The port's host ``Tracker`` against the JAX package's: both are fed the
same numpy ``FrameObs`` (one run of the cv2 ORB oracle over a 16-frame
synthetic sequence) and must walk the same state machine: equal per-frame
states and keyframe flags, equal keyframe counts, inliers and matches
within a band (their RANSAC draws differ: torch cannot reproduce
``jax.random``), ATE within a band. One run with the defaults, one with
culling on and options that keep landmarks, so keyframes are removed."""

import dataclasses

import numpy as np
import pytest
import torch

from visionx_slam_tpu.models.orb import OpenCVExtractor, sample_depth_at
from visionx_slam_tpu.tracking import frontend as jfrontend
from visionx_slam_tpu.tracking.stages import FrameObs as JFrameObs
from visionx_slam_tpu.utils.config import TrackingOptions as JOptions

from visionx_slam_torch import convert
from visionx_slam_torch.eval.trajectory import ate_rmse, tcw_to_twc
from visionx_slam_torch.tracking import frontend as tfrontend
from visionx_slam_torch.utils.config import TrackingOptions

from torch_parity import cameras, sequence

T = 16
CAPS = dict(n_features=1024, kf_capacity=8, lm_capacity=16384)
# one observation keeps a landmark and makes it shared; a small map
CULL = dict(enable_culling=True, min_landmark_observations=1,
            kf_min_shared_observations=1, max_keyframes=4)


@pytest.fixture(scope="module")
def observations():
    """Per frame: (gray, FrameObs fields as numpy), and the ground truth."""
    grays, depths, gt_t = sequence(T, 11)
    ext = OpenCVExtractor(n_features=1000)
    obs = []
    for g, d in zip(grays, depths):
        px, resp, desc, valid = ext.extract(g)
        obs.append((g, JFrameObs(px, resp, desc, valid, sample_depth_at(px, valid, d))))
    return obs, gt_t


def _run(tracker, frames, to_obs):
    return [tracker.process(i, 100.0 + i / 30.0, g, to_obs(o))
            for i, (g, o) in enumerate(frames)]


def _ate(results, gt_t):
    got = [(tcw_to_twc(r.pose_T_cw)[:3, 3], gt_t[i])
           for i, r in enumerate(results) if r.pose_T_cw is not None]
    est, gt = (np.asarray(x) for x in zip(*got))
    return ate_rmse(est, gt), len(got)


@pytest.mark.parametrize("cull", [False, True], ids=["default", "culling"])
def test_tracker_walks_the_jax_trackers_states(observations, cull):
    import jax.numpy as jnp

    frames, gt_t = observations
    jc, tc = cameras()
    extra = CULL if cull else {}
    jt = jfrontend.Tracker(jc, JOptions(**extra), **CAPS)
    tt = tfrontend.Tracker(tc, TrackingOptions(**extra), device="cpu", **CAPS)
    res_j = _run(jt, frames, lambda o: JFrameObs(*(jnp.asarray(x) for x in o)))
    res_t = _run(tt, frames, convert.frameobs_from_numpy)

    assert [r.state for r in res_t] == [r.state for r in res_j]
    assert [r.is_keyframe for r in res_t] == [r.is_keyframe for r in res_j]
    assert [r.n_keyframes for r in res_t] == [r.n_keyframes for r in res_j]
    assert [r.n_features for r in res_t] == [r.n_features for r in res_j]
    assert [r.pose_T_cw is None for r in res_t] == [r.pose_T_cw is None for r in res_j]
    assert sum(r.is_keyframe for r in res_t) >= 3
    for a, b in zip(res_t, res_j):
        assert a.n_matches == b.n_matches, a.frame_id      # no randomness
        # the draws differ; the refined consensus is nearly the same set
        assert abs(a.n_inliers - b.n_inliers) <= max(8, 0.05 * b.n_inliers), a.frame_id
        assert abs(a.parallax - b.parallax) <= 1e-3, a.frame_id
        assert abs(a.n_landmarks - b.n_landmarks) <= 0.02 * max(b.n_landmarks, 1) + 4
        assert np.isnan(a.ba_cost) == np.isnan(b.ba_cost)
        if a.pose_T_cw is not None:
            np.testing.assert_allclose(a.pose_T_cw, b.pose_T_cw, atol=5e-3)
    ate_t, n_t = _ate(res_t, gt_t)
    ate_j, n_j = _ate(res_j, gt_t)
    assert n_t == n_j >= T - 1
    assert ate_t <= 1.25 * ate_j + 1e-3 and ate_t < 0.02, (ate_t, ate_j)
    if cull:      # keyframes were removed: fewer alive than were made
        made = 1 + sum(r.is_keyframe for r in res_t)
        assert res_t[-1].n_keyframes < made
        assert res_t[-1].n_keyframes <= CULL["max_keyframes"] + 1
    assert tt.host_reads / T < 12         # the debug path's reads per frame


def test_tracker_resets_after_a_blackout(observations):
    """A dark frame fails tracking (GOOD -> BAD), the next frame is
    consumed by the reset on a FRESH map, and the tracker initializes
    again; the map a caller assigns is the one it reports."""
    frames, _ = observations
    _, tc = cameras()
    tt = tfrontend.Tracker(tc, TrackingOptions(), device="cpu", **CAPS)
    black = (np.zeros_like(frames[0][0]),
             JFrameObs(*(np.zeros_like(x) for x in frames[0][1])))
    seq = frames[:4] + [black] + frames[5:9]
    res = _run(tt, seq, convert.frameobs_from_numpy)
    states = [r.state for r in res]
    assert states[:4] == ["INIT", "TRACKING_GOOD", "TRACKING_GOOD", "TRACKING_GOOD"]
    assert states[4] == "TRACKING_BAD" and res[4].pose_T_cw is None
    ms_before = tt.ms
    assert states[5] == "TRACKING_BAD" and res[5].n_keyframes == 0   # the reset frame
    assert states[6] == "INIT" and states[7] == states[8] == "TRACKING_GOOD"
    assert res[8].n_keyframes >= 2
    other = tfrontend.Tracker(tc, TrackingOptions(), device="cpu", **CAPS)
    other.ms = ms_before
    assert int(other.ms.next_kf) == int(ms_before.next_kf)
    assert dataclasses.is_dataclass(res[0]) and isinstance(tt.ms.kf_q, torch.Tensor)
