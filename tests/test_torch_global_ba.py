"""The keyframe map and global BA of the port against the JAX package, on
keyframes of a 16-frame sequence (ORB from the JAX package, poses from the
ground truth plus noise, 40% of feature depths dropped so that
keyframes link landmarks). The map tables of ``build_keyframe_map`` and
``_link_consecutive_keyframes`` are integer-equal; one ``global_ba`` pass on
the JAX-built map, carried over with ``convert.py``, agrees in final cost
and map reprojection error within 1e-3 relative and in poses within 1e-4.

Gauge groups: two such lane maps (keyframes 0, 3, ..., 15 and 1, 4, ...,
13, other noise) merged into one map as the folded pipeline lays it out
(lane-major slots, links offset by the lane's table). The gauge-grouped
solve agrees with the JAX package's in keyframe positions within 1e-5 m
(and rotations 1e-5), and equals the port's per-lane solves within 1e-6 in
keyframe poses. Landmarks agree within 5e-5 m: the per-group sums add in
another order than the single-group ones, and the weak depth direction of
three-frame baselines (above) amplifies those float32 ulps (1.8e-5 m seen
after two passes). The refine stage of a ``lanes=2`` pipeline on the
merged map equals the one-lane refine stage of each lane alike.
"""

import numpy as np
import pytest

from visionx_slam_tpu.models import global_ba as JG
from visionx_slam_tpu.models import orb_jax as OJ
from visionx_slam_tpu.ops import se3 as jse3
from visionx_slam_tpu.tracking import offline_pipeline as JOP
from visionx_slam_tpu.tracking import stages as JS
from visionx_slam_tpu.tracking.mapstate import MapState as JMapState
from visionx_slam_tpu.utils.config import TrackingOptions as JOpts

from visionx_slam_torch import convert
from visionx_slam_torch.data import synthetic
from visionx_slam_torch.models import global_ba as TG
from visionx_slam_torch.tracking import offline_pipeline as TOP
from visionx_slam_torch.utils.config import TrackingOptions

from torch_parity import cameras, sequence, t, to_np

KF_FRAMES = [0, 3, 6, 9, 12, 15]
K = 8  # two dead slots first, as the pipeline lays out a short sequence
# 4x the bench's camera speed: wider keyframe baselines keep the two-view
# landmark depths well conditioned (at bench speed a 3-frame baseline leaves
# the depth direction of Hll so weak that one GN step moves such landmarks by
# metres, and float32 rounding order alone then changes them by millimetres)
LOOP = 60


def _kf_arrays(frames, seed):
    grays, depths, _ = sequence(16, 7, LOOP)
    rng = np.random.default_rng(seed)
    cols = {k: [] for k in ("q", "t", "px", "desc", "valid", "depth")}
    for f in frames:
        px, _, desc, valid = OJ.orb_extract(grays[f], use_pallas=0)
        R_wc, t_wc = synthetic.trajectory_pose(f, 16, LOOP)
        w = rng.normal(0, 2e-3, 3).astype(np.float32)      # pose noise
        q = jse3.quat_mul(jse3.so3_exp(w),
                          jse3.matrix_to_quat(np.asarray(R_wc.T, np.float32)))
        cols["q"].append(np.asarray(q))
        cols["t"].append((-R_wc.T @ t_wc + rng.normal(0, 5e-3, 3)).astype(np.float32))
        cols["px"].append(np.asarray(px))
        cols["desc"].append(np.asarray(desc))
        cols["valid"].append(np.asarray(valid))
        # features without depth create no landmark and can adopt one
        # from the previous keyframe: drop 40% of the depths
        dep = np.asarray(JS.sample_depth_image(depths[f], px, valid))
        cols["depth"].append(np.where(rng.random(dep.shape) < 0.4, 0.0, dep))
    pad = K - len(frames)
    arr = {k: np.stack([v[0]] * pad + v) for k, v in cols.items()}
    arr["id"] = np.array([-1] * pad + list(frames), np.int32)
    arr["valid"][:pad] = False
    return arr


@pytest.fixture(scope="module")
def kf_inputs():
    return _kf_arrays(KF_FRAMES, 0)


@pytest.fixture(scope="module")
def maps(kf_inputs):
    a = kf_inputs
    jc, tc = cameras()
    N = a["px"].shape[1]
    args = (a["q"], a["t"], a["id"], a["px"], a["desc"], a["valid"], a["depth"])
    ms_j, links_j = JOP.build_keyframe_map(jc, JOpts(), *args, K * N)
    ms_t, links_t = TOP.build_keyframe_map(tc, TrackingOptions(),
                                           *(t(x) for x in args), K * N)
    return ms_j, links_j, ms_t, links_t


def test_tracking_options_are_a_copy():
    """The JAX package's fields and defaults, and the port's own widening
    ``track_local_map``, off."""
    import dataclasses

    opts = dataclasses.asdict(TrackingOptions())
    assert opts.pop("track_local_map") is False
    assert opts == dataclasses.asdict(JOpts())


def test_build_keyframe_map_tables_equal(maps):
    ms_j, links_j, ms_t, links_t = maps
    for f in ("kf_id", "kf_fvalid", "kf_feat_lm", "lm_alive", "lm_obs",
              "next_kf", "next_lm", "lm_dropped", "kf_desc"):
        np.testing.assert_array_equal(to_np(getattr(ms_t, f)),
                                      np.asarray(getattr(ms_j, f)), err_msg=f)
    for f in ("created", "adopter", "creator", "order", "sidx"):
        np.testing.assert_array_equal(to_np(getattr(links_t, f)),
                                      np.asarray(getattr(links_j, f)), err_msg=f)
    np.testing.assert_allclose(to_np(ms_t.lm_pos), np.asarray(ms_j.lm_pos),
                               atol=1e-5)
    # the map really links keyframes
    assert (np.asarray(links_j.adopter) >= 0).sum() > 200


def test_link_pass_on_the_carried_map(maps):
    """One more link pass on the JAX-built map, on both sides."""
    ms_j = maps[0]
    jc, tc = cameras()
    ms_c = convert.mapstate_from_numpy(ms_j)
    out_t, ad_t, cr_t = TOP._link_consecutive_keyframes(ms_c, tc, TrackingOptions())
    out_j, ad_j, cr_j = JOP._link_consecutive_keyframes(ms_j, jc, JOpts())
    np.testing.assert_array_equal(to_np(ad_t), np.asarray(ad_j))
    np.testing.assert_array_equal(to_np(cr_t), np.asarray(cr_j))
    np.testing.assert_array_equal(to_np(out_t.kf_feat_lm), np.asarray(out_j.kf_feat_lm))
    np.testing.assert_array_equal(to_np(out_t.lm_obs), np.asarray(out_j.lm_obs))


@pytest.mark.parametrize("iters", [1, 2])
def test_global_ba_matches(maps, iters):
    ms_j = maps[0]
    jc, tc = cameras()
    ms_c = convert.mapstate_from_numpy(ms_j)
    back = convert.mapstate_to_numpy(ms_c)
    for f, v in back.items():
        np.testing.assert_array_equal(v, np.asarray(getattr(ms_j, f)), err_msg=f)
    err0 = float(JG.map_reproj_error(ms_j, jc)[0])
    np.testing.assert_allclose(float(TG.map_reproj_error(ms_c, tc)[0]), err0,
                               rtol=1e-5)
    gj, sj = JG.global_ba(ms_j, jc, JG.GlobalBAOptions(max_iterations=iters,
                                                       cg_iterations=8))
    gt, st = TG.global_ba(ms_c, tc, TG.GlobalBAOptions(max_iterations=iters,
                                                       cg_iterations=8))
    np.testing.assert_allclose(float(st.final_cost), float(sj.final_cost), rtol=1e-3)
    assert int(st.total_obs) == int(sj.total_obs)
    e_j = float(JG.map_reproj_error(gj, jc)[0])
    e_t = float(TG.map_reproj_error(gt, tc)[0])
    # the solve moved the poses (well beyond the tolerance below)
    assert np.abs(np.asarray(gj.kf_t) - np.asarray(ms_j.kf_t)).max() > 1e-3
    np.testing.assert_allclose(e_t, e_j, rtol=1e-3)
    np.testing.assert_allclose(to_np(gt.kf_q), np.asarray(gj.kf_q), atol=1e-4)
    np.testing.assert_allclose(to_np(gt.kf_t), np.asarray(gj.kf_t), atol=1e-4)
    np.testing.assert_allclose(to_np(gt.lm_pos), np.asarray(gj.lm_pos), atol=1e-3)


def test_camera_from_numpy():
    jc, tc = cameras()
    assert convert.camera_from_numpy(jc) == tc


def _merge_lanes(lanes: list[dict]) -> dict:
    """Lane maps (field -> numpy) merged as the folded pipeline lays them
    out: keyframe slots lane-major, landmark tables concatenated, links
    offset by the lane's table size."""
    Lp = lanes[0]["lm_pos"].shape[1]
    out = {}
    for f in lanes[0]:
        vals = [m[f] for m in lanes]
        if f == "kf_feat_lm":
            vals = [np.where(v >= 0, v + b * Lp, v) for b, v in enumerate(vals)]
        if f == "lm_pos":
            out[f] = np.concatenate(vals, axis=1)
        elif np.ndim(vals[0]) == 0:
            out[f] = np.asarray(sum(vals), vals[0].dtype)
        else:
            out[f] = np.concatenate(vals)
    return out


@pytest.fixture(scope="module")
def two_lanes(kf_inputs):
    jc, _ = cameras()
    lanes = []
    for a in (kf_inputs, _kf_arrays([1, 4, 7, 10, 13], 1)):
        N = a["px"].shape[1]
        ms, _ = JOP.build_keyframe_map(
            jc, JOpts(), a["q"], a["t"], a["id"], a["px"], a["desc"],
            a["valid"], a["depth"], K * N)
        lanes.append({f: np.asarray(getattr(ms, f)) for f in ms._fields})
    return lanes


@pytest.mark.parametrize("iters", [1, 2])
def test_gauge_grouped_global_ba_matches_jax_and_per_lane(two_lanes, iters):
    jc, tc = cameras()
    merged = _merge_lanes(two_lanes)
    gg = np.repeat(np.arange(2, dtype=np.int32), K)
    jopts = JG.GlobalBAOptions(max_iterations=iters, cg_iterations=8)
    topts = TG.GlobalBAOptions(max_iterations=iters, cg_iterations=8)
    gj, sj = JG.global_ba(JMapState(**merged), jc, jopts, gauge_group=gg)
    gt, st = TG.global_ba(convert.mapstate_from_numpy(merged), tc, topts,
                          gauge_group=t(gg))
    assert np.abs(np.asarray(gj.kf_t) - merged["kf_t"]).max() > 1e-3
    # each lane keeps its own gauge keyframe (its oldest) fixed
    for b, first in ((0, 2), (1, K + 3)):
        np.testing.assert_array_equal(to_np(gt.kf_t)[first], merged["kf_t"][first])
    np.testing.assert_allclose(to_np(gt.kf_t), np.asarray(gj.kf_t), atol=1e-5)
    np.testing.assert_allclose(to_np(gt.kf_q), np.asarray(gj.kf_q), atol=1e-5)
    np.testing.assert_allclose(float(st.final_cost), float(sj.final_cost), rtol=1e-3)
    assert int(st.total_obs) == int(sj.total_obs)
    assert int(st.iterations) == int(sj.iterations)

    # the merged solve is the per-lane solves
    Lp = two_lanes[0]["lm_pos"].shape[1]
    for b, lane in enumerate(two_lanes):
        gl, _ = TG.global_ba(convert.mapstate_from_numpy(lane), tc, topts)
        sl = slice(b * K, (b + 1) * K)
        np.testing.assert_allclose(to_np(gt.kf_t)[sl], to_np(gl.kf_t), atol=1e-6)
        np.testing.assert_allclose(to_np(gt.kf_q)[sl], to_np(gl.kf_q), atol=1e-6)
        np.testing.assert_allclose(to_np(gt.lm_pos)[:, b * Lp:(b + 1) * Lp],
                                   to_np(gl.lm_pos), atol=5e-5)


def test_refine_merged_matches_per_lane(two_lanes):
    """The refine stage of a ``lanes=2`` pipeline on the lane-merged map
    (one gauge-grouped solve, groups of ``kf_capacity`` slots) against the
    refine stage of a one-lane pipeline on each lane."""
    _, tc = cameras()
    merged = TOP.build_offline_pipeline(TrackingOptions(), kf_capacity=K,
                                        lanes=2).refine(
        tc, convert.mapstate_from_numpy(_merge_lanes(two_lanes)))
    single = TOP.build_offline_pipeline(TrackingOptions(), kf_capacity=K)
    Lp = two_lanes[0]["lm_pos"].shape[1]
    for b, lane in enumerate(two_lanes):
        ref = single.refine(tc, convert.mapstate_from_numpy(lane))
        sl = slice(b * K, (b + 1) * K)
        assert np.abs(to_np(ref.kf_t) - lane["kf_t"]).max() > 1e-3
        np.testing.assert_allclose(to_np(merged.kf_t)[sl], to_np(ref.kf_t), atol=1e-6)
        np.testing.assert_allclose(to_np(merged.kf_q)[sl], to_np(ref.kf_q), atol=1e-6)
        np.testing.assert_allclose(to_np(merged.lm_pos)[:, b * Lp:(b + 1) * Lp],
                                   to_np(ref.lm_pos), atol=5e-5)
