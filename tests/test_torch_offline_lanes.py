"""Folded multi-sequence lanes (BASELINE config 5) of the port's offline
pipeline, at the shape of tests/test_offline_pipeline.py's
``test_offline_batched_matches_single``: 16 frames of 640x480 (seed 7),
lanes = the sequence and its reverse, ``kf_capacity`` 16, two GBA passes.

- Lane isolation: the port's folded lane 0 (run through
  ``parallel.batch.sharded_offline_pipeline`` on a world of one) equals a
  single port run of the same frames (poses within 1e-5, tracked and keyframe count equal; on the
  CPU they are bit-equal), in RGB-D and in mono.
- Against the JAX package's folded run (its ``pre``/``refine``/``post``
  stages with ``lanes=2``), per lane, the band of tests/test_torch_offline.py:
  both track >= 15/16, keyframe decisions agree on >= 0.9 of the frames,
  ATEs under 2 cm and within 5 mm, landmark counts within 10%.
- Exact against the JAX functions: the lane-aware keyframe policy on the
  JAX run's own pair statistics, ``split_merged_lanes`` of the JAX-built
  merged map, ``default_lane_kf_capacity``; the segmented SE(3) prefix
  composition within 1e-5.
"""

import numpy as np
import pytest
import torch

import jax

from visionx_slam_tpu.ops import se3 as jse3
from visionx_slam_tpu.tracking import offline_pipeline as JOP
from visionx_slam_tpu.utils.config import TrackingOptions as JOpts

from visionx_slam_torch import convert
from visionx_slam_torch.eval.trajectory import ate_of_run
from visionx_slam_torch.ops import se3 as tse3
from visionx_slam_torch.parallel import batch as TB
from visionx_slam_torch.tracking import offline_pipeline as TOP
from visionx_slam_torch.utils.config import TrackingOptions

from torch_parity import cameras, sequence, t, to_np

KW = dict(kf_capacity=16, refine_iterations=2)


def _lanes(n=16, seed=7, loop=240):
    grays, depths, gt = sequence(n, seed, loop)
    g2 = np.stack([grays, grays[::-1].copy()])
    d2 = np.stack([depths, depths[::-1].copy()])
    return g2, d2, np.stack([gt, gt[::-1]])


@pytest.fixture(scope="module")
def jax_folded():
    """The JAX package's lanes=2 pipeline, stage by stage (the aux of its
    pre stage holds the pair statistics of the keyframe policy)."""
    g2, d2, _ = _lanes()
    jc, _ = cameras()
    run = JOP.build_offline_pipeline(None, JOpts(), lanes=2, **KW)
    flat = lambda x: x.reshape(-1, *x.shape[2:])
    ms, links, aux = jax.jit(lambda g, d: run.pre(jc, g, d))(flat(g2), flat(d2))
    ms_r = jax.jit(lambda m, lk: run.refine(jc, m, lk))(ms, links)
    _, out = jax.jit(lambda m, a: run.post(jc, m, a))(ms_r, aux)
    return ms, aux, out


@pytest.fixture(scope="module")
def port_runs():
    g2, d2, gt2 = _lanes()
    _, tc = cameras()
    opts = TrackingOptions()
    timings = {}
    # the folded lanes through the multi-device wrapper on a world of one:
    # run_offline_pipeline_batched on every lane, plus the fleet totals
    ms_b, ob, fleet = TB.sharded_offline_pipeline(
        TB.make_mesh(device="cpu"), tc, opts, timings=timings, **KW)(g2, d2)
    ms_1, o1 = TOP.run_offline_pipeline(tc, g2[0], d2[0], opts, device="cpu", **KW)
    return ms_b, ob, ms_1, o1, gt2, timings, fleet


def test_folded_lane_equals_single_run(port_runs):
    ms_b, ob, ms_1, o1, _, timings, _ = port_runs
    assert ob.pose.shape == (2, 16, 4, 4)
    np.testing.assert_allclose(to_np(ob.pose[0]), to_np(o1.pose), rtol=0, atol=1e-5)
    assert torch.equal(ob.tracked[0], o1.tracked)
    assert int(ob.n_keyframes[0]) == int(o1.n_keyframes)
    assert int(ob.n_landmarks[0]) == int(o1.n_landmarks)
    # the split lane map is the single run's map
    for f in ("kf_id", "kf_feat_lm", "lm_alive", "lm_obs", "next_kf", "next_lm"):
        assert torch.equal(getattr(ms_b, f)[0], getattr(ms_1, f)), f
    np.testing.assert_allclose(to_np(ms_b.kf_t[0]), to_np(ms_1.kf_t), atol=1e-5)
    # the five stages, their sub-spans and the host-sync count
    stages = {"extract", "pairs", "map", "refine", "retrack"}
    assert {k for k in timings if "/" not in k} == stages | {"#host_syncs"}
    assert all(k.split("/")[0] in stages for k in timings if "/" in k)


def test_folded_lanes_match_jax_band(jax_folded, port_runs):
    _, _, oj = jax_folded
    _, ob, _, _, gt2, _, _ = port_runs
    T = 16
    for b in range(2):
        sl = slice(b * T, (b + 1) * T)
        tr_j, tr_t = np.asarray(oj.tracked)[sl], to_np(ob.tracked[b])
        assert tr_j.sum() >= 15 and tr_t.sum() >= 15, (b, tr_j, tr_t)
        kf_j, kf_t = np.asarray(oj.is_keyframe)[sl], to_np(ob.is_keyframe[b])
        assert kf_t[0] and (kf_j == kf_t).mean() >= 0.9, (b, kf_j, kf_t)
        ate_j, _ = ate_of_run(np.asarray(oj.pose)[sl], tr_j, gt2[b])
        ate_t, _ = ate_of_run(to_np(ob.pose[b]), tr_t, gt2[b])
        assert ate_j < 0.02 and ate_t < 0.02, (b, ate_j, ate_t)
        assert abs(ate_j - ate_t) <= 0.005, (b, ate_j, ate_t)
        n_j, n_t = int(np.asarray(oj.n_landmarks)[b]), int(ob.n_landmarks[b])
        assert abs(n_t - n_j) <= 0.1 * n_j, (b, n_j, n_t)
        assert int(ob.n_keyframes[b]) == int(kf_t.sum())


def test_sharded_fleet_totals_match_jax(jax_folded, port_runs):
    """The fleet totals of ``parallel.batch.sharded_offline_pipeline`` on a
    world of one (the fixture's folded run) are the lanes' sums, and equal
    the JAX package's folded run (the body of its
    ``sharded_offline_pipeline`` on a mesh of one, ``run.batched_lanes``):
    tracked frames, keyframe flags, keyframes and landmarks; the poses lie
    in the band above."""
    _, ob, _, _, _, _, fleet = port_runs
    _, _, oj = jax_folded
    assert fleet["lane_offset"] == 0
    assert int(fleet["total_tracked"]) == int(ob.tracked.sum()) == int(
        np.asarray(oj.tracked).sum()) == 32
    np.testing.assert_array_equal(to_np(ob.is_keyframe).reshape(-1),
                                  np.asarray(oj.is_keyframe))
    assert int(fleet["total_keyframes"]) == int(ob.n_keyframes.sum()) == int(
        np.asarray(oj.n_keyframes).sum())
    assert int(fleet["total_landmarks"]) == int(ob.n_landmarks.sum()) == int(
        np.asarray(oj.n_landmarks).sum())


def test_keyframe_policy_with_lane_starts_matches_jax(jax_folded):
    _, aux, _ = jax_folded
    T, T_lane = 32, 16
    xlane = (np.arange(T - 1) % T_lane) == T_lane - 1
    # tracked[1:] is ok | lane start; the policy ignores ok at lane starts
    ok = np.asarray(aux["tracked"])[1:] & ~xlane
    is_kf = TOP._keyframe_policy(TrackingOptions(), t(np.asarray(aux["n_inl"])),
                                 t(np.asarray(aux["parallax"])), t(ok), xlane)
    np.testing.assert_array_equal(is_kf, np.asarray(aux["is_kf"]))
    assert is_kf[T_lane] and is_kf.sum() >= 6


def test_split_merged_lanes_matches_jax(jax_folded):
    ms, aux, _ = jax_folded
    N = ms.kf_desc.shape[1]
    lane_lm = np.asarray(aux["lane_lm"])
    sj = JOP.split_merged_lanes(ms, 2, 16, N, 16, lane_lm)
    st = TOP.split_merged_lanes(convert.mapstate_from_numpy(ms), 2, 16, N, 16,
                                t(lane_lm))
    stacked = convert.mapstate_from_numpy(sj)      # a lane-stacked JAX state
    for f in st._fields:
        np.testing.assert_array_equal(to_np(getattr(st, f)),
                                      np.asarray(getattr(sj, f)), err_msg=f)
        assert torch.equal(getattr(stacked, f), getattr(st, f)), f
    assert (lane_lm > 0).all()


def test_default_lane_kf_capacity_matches_jax():
    for T in [1, 16, 30, 45, 60, 120, 240, 359, 360, 361, 1000]:
        assert TOP.default_lane_kf_capacity(T) == JOP.default_lane_kf_capacity(T)
    assert TOP.default_lane_kf_capacity(120) == 48
    assert TOP.default_lane_kf_capacity(240) == 88


def test_segmented_compose_scan_matches_jax():
    rng = np.random.default_rng(2)
    n = 37
    q = np.asarray(jse3.so3_exp(rng.normal(0, 0.2, (n, 3)).astype(np.float32)))
    tr = rng.normal(0, 0.3, (n, 3)).astype(np.float32)
    flag = np.zeros(n, bool)
    flag[[0, 9, 10, 23]] = True
    pj = JOP._segmented_compose_scan(q, tr, flag)
    pt = TOP._segmented_compose_scan(t(q), t(tr), t(flag))
    np.testing.assert_allclose(to_np(pt.q), np.asarray(pj.q), atol=1e-5)
    np.testing.assert_allclose(to_np(pt.t), np.asarray(pj.t), atol=1e-5)
    # a segment start is its own anchor
    np.testing.assert_array_equal(to_np(pt.t)[[9, 10, 23]], tr[[9, 10, 23]])
    # no flag after element 0: the plain prefix composition
    plain = TOP._segmented_compose_scan(t(q), t(tr), t(flag & (np.arange(n) == 0)))
    ref = tse3.Pose(t(q[:1]), t(tr[:1]))
    for i in range(1, n):
        ref = tse3.Pose(*(torch.cat([a, b[None]]) for a, b in zip(
            ref, tse3.se3_compose(tse3.Pose(t(q[i]), t(tr[i])),
                                  tse3.Pose(ref.q[-1], ref.t[-1])))))
    np.testing.assert_allclose(to_np(plain.t), to_np(ref.t), atol=1e-5)


def test_mono_folded_lane_equals_single_run():
    """The monocular pipeline folded (the essential-RANSAC draws, the scale
    chain's per-lane reset, the two-keyframe re-track bounded by the
    lane): lane 0 equals a single mono run of its frames."""
    g2, _, _ = _lanes(16, 11, 48)
    z2 = np.zeros(g2.shape, np.float32)
    _, tc = cameras()
    kw = dict(kf_capacity=16, mono_pair_hypotheses=64, mono_lo_starts=2,
              mono_sample_bias=64.0, mono_score_top_k=32)
    _, ob = TOP.run_offline_pipeline_batched(tc, g2, z2, TrackingOptions(),
                                             device="cpu", monocular=True, **kw)
    _, o1 = TOP.run_offline_pipeline(tc, g2[0], z2[0], TrackingOptions(),
                                     device="cpu", monocular=True, **kw)
    np.testing.assert_allclose(to_np(ob.pose[0]), to_np(o1.pose), rtol=0, atol=1e-5)
    assert torch.equal(ob.tracked[0], o1.tracked)
    assert int(ob.n_keyframes[0]) == int(o1.n_keyframes)
    assert int(ob.n_landmarks[0]) == int(o1.n_landmarks) > 0
