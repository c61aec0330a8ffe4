"""Map culling of the port against the JAX package.

A map of 8 keyframes x 64 features over a 40-point cloud (numpy, seed 3):
every keyframe sees the points it projects, with pixel noise of up to 9 px
on a third of the observations, a few landmarks observed once and one
keyframe slot dead. ``remove_landmarks``, ``remove_keyframe_slot`` and
``keyframe_redundancy`` give exactly the JAX package's tables (integers and
the float32 ratio); ``cull_landmarks`` gives the same kill mask and count
(the map's mean and maximum errors are checked to lie more than 1e-4 px
from the thresholds: the port's per-landmark sums add in another order than
JAX's sorted segment sums, so a landmark on a threshold could fall on
either side); ``cull_keyframes_device`` removes the same slot and leaves
the same tables.

The scan with ``enable_culling=True`` on 16 frames of 640x480 (seed 7, an
8-slot ring). With the default options every depth landmark (observed once)
is culled at the first keyframe event, tracking fails and the map is
rebuilt, in both packages: tracked frames within 2 of JAX's, the per-frame
keyframe and landmark counts equal on >= 0.8 of the frames. With options
that keep landmarks and make keyframes redundant (one observation is
enough, at most 4 keyframes), every frame tracks in both, keyframes are
removed, ATE within 1 mm of JAX's and the final map holds the same
keyframe ids.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from visionx_slam_tpu.ops import se3 as jse3
from visionx_slam_tpu.tracking import mapstate as JMS
from visionx_slam_tpu.tracking import stages as JS
from visionx_slam_tpu.tracking.scan_pipeline import run_scan_pipeline as jax_run
from visionx_slam_tpu.utils.config import TrackingOptions as JOpts

from visionx_slam_torch import convert
from visionx_slam_torch.eval.trajectory import ate_of_run
from visionx_slam_torch.tracking import mapstate as TMS
from visionx_slam_torch.tracking import scan_pipeline as TSP
from visionx_slam_torch.tracking import stages as TS
from visionx_slam_torch.utils.config import TrackingOptions

from torch_parity import cameras, sequence, t, to_np

K, L, N, P = 8, 256, 64, 40


def _same_tables(ms_t, ms_j):
    got = convert.mapstate_to_numpy(ms_t)
    for f in JMS.MapState._fields:
        np.testing.assert_array_equal(got[f], np.asarray(getattr(ms_j, f)), err_msg=f)


@pytest.fixture(scope="module")
def jax_map():
    """7 alive keyframes (slot 5 dead) observing 40 landmarks."""
    jc, _ = cameras()
    rng = np.random.default_rng(3)
    X = rng.uniform([-1.5, -1.0, 3.0], [1.5, 1.0, 6.0], (P, 3)).astype(np.float32)
    ms = JMS.empty_map(K, L, N)
    for k in range(K):
        q = np.asarray(jse3.so3_exp(np.array([0.0, 0.01 * k, 0.0], np.float32)))
        tt = np.array([-0.08 * k, 0.01 * k, 0.0], np.float32)
        pc = np.asarray(jse3.se3_apply(jse3.Pose(q, tt), jnp.asarray(X)))
        uv = np.stack([jc.fx * pc[:, 0] / pc[:, 2] + jc.cx,
                       jc.fy * pc[:, 1] / pc[:, 2] + jc.cy], -1)
        noisy = rng.random(P) < 0.33
        uv = uv + np.where(noisy[:, None], rng.uniform(-9, 9, (P, 2)),
                           rng.normal(0, 0.3, (P, 2)))
        px = rng.uniform(0, 640, (N, 2)).astype(np.float32)
        px[:P] = uv
        valid = rng.random(N) < 0.9
        links = np.full(N, JMS.FREE, np.int32)
        links[:P] = np.arange(P)
        links[:P][rng.random(P) < 0.25] = JMS.FREE     # not every keyframe sees all
        if k > 0:
            links[:4] = JMS.FREE                       # landmarks 0-3: one observation
        ms, _ = JMS.insert_keyframe(
            ms, jnp.asarray(3 * k), jse3.Pose(q, tt), px,
            rng.integers(0, 256, (N, 32)).astype(np.uint8), valid, links,
            np.zeros(N, np.float32))
    pos = np.zeros((ms.lm_physical, 3), np.float32)
    pos[:P] = X
    alive = np.zeros(ms.lm_physical, bool)
    alive[:P] = True
    alive[7] = False                                   # a dead landmark with links
    ms = ms._replace(lm_pos=jnp.asarray(pos.T), lm_alive=jnp.asarray(alive),
                     next_lm=jnp.asarray(P, jnp.int32))
    return JMS.remove_keyframe_slot(ms, jnp.asarray(5))


def test_remove_landmarks_exact(jax_map):
    kill = np.random.default_rng(1).random(jax_map.lm_physical) < 0.3
    ms_t = TMS.remove_landmarks(convert.mapstate_from_numpy(jax_map), t(kill))
    ms_j = JMS.remove_landmarks(jax_map, jnp.asarray(kill))
    _same_tables(ms_t, ms_j)
    assert (to_np(ms_t.kf_feat_lm) == TMS.OUTLIER).sum() > 20
    assert TMS.OUTLIER == JMS.OUTLIER


@pytest.mark.parametrize("slot", [2, 5])          # an alive slot, a dead one
def test_remove_keyframe_slot_exact(jax_map, slot):
    ms_t = TMS.remove_keyframe_slot(convert.mapstate_from_numpy(jax_map), slot)
    ms_j = JMS.remove_keyframe_slot(jax_map, jnp.asarray(slot))
    _same_tables(ms_t, ms_j)
    assert int(ms_t.kf_id[slot]) == -1 and int(TMS.n_keyframes(ms_t)) == (6 if slot == 2 else 7)


@pytest.mark.parametrize("min_shared", [2, 5, 7])
def test_keyframe_redundancy_exact(jax_map, min_shared):
    r_t, n_t = TS.keyframe_redundancy(convert.mapstate_from_numpy(jax_map), min_shared)
    r_j, n_j = JS.keyframe_redundancy(jax_map, jnp.asarray(min_shared))
    np.testing.assert_array_equal(to_np(n_t), np.asarray(n_j))
    np.testing.assert_array_equal(to_np(r_t), np.asarray(r_j))
    assert r_t.dtype == torch.float32 and 0.0 < float(r_t.max()) <= 1.0


def _error_margins(ms_t, cam, max_reproj):
    """Distance of every measured landmark's mean and maximum reprojection
    error from the culling thresholds, in float64."""
    from visionx_slam_torch.ops.camera import project_pinhole
    from visionx_slam_torch.ops.se3 import Pose

    lm = ms_t.kf_feat_lm.clamp(min=0).long()
    uv, ok, _ = project_pinhole(cam, Pose(ms_t.kf_q[:, None], ms_t.kf_t[:, None]),
                                ms_t.lm_pos[:, lm].permute(1, 2, 0))
    err = torch.linalg.norm(uv - ms_t.kf_px.transpose(1, 2), dim=-1).double()
    m = ((ms_t.kf_id >= 0)[:, None] & ms_t.kf_fvalid & (ms_t.kf_feat_lm >= 0) & ok)
    Lp = ms_t.lm_physical
    s = torch.zeros(Lp, dtype=torch.float64).index_add_(0, lm[m], err[m])
    c = torch.zeros(Lp, dtype=torch.float64).index_add_(0, lm[m], torch.ones_like(err[m]))
    mx = torch.zeros(Lp, dtype=torch.float64).scatter_reduce_(0, lm[m], err[m], "amax")
    seen = c > 0
    return ((s[seen] / c[seen] - max_reproj).abs().min(),
            (mx[seen] - 2 * max_reproj).abs().min())


@pytest.mark.parametrize("max_reproj,min_obs", [(5.0, 2), (3.0, 2), (5.0, 4)])
def test_cull_landmarks_same_kill_mask(jax_map, max_reproj, min_obs):
    jc, tc = cameras()
    ms_t = convert.mapstate_from_numpy(jax_map)
    d_mean, d_max = _error_margins(ms_t, tc, max_reproj)
    assert d_mean > 1e-4 and d_max > 1e-4, (d_mean, d_max)   # off the thresholds
    alive0 = to_np(ms_t.lm_alive).copy()
    ms_t, n_t = TS.cull_landmarks(ms_t, tc, max_reproj, min_obs)
    ms_j, n_j = JS.cull_landmarks(jax_map, jc, max_reproj, min_obs)
    assert int(n_t) == int(n_j)
    _same_tables(ms_t, ms_j)
    killed = alive0 & ~to_np(ms_t.lm_alive)
    assert killed[:4].all()                     # observed once
    assert 4 < killed.sum() < alive0.sum()      # and some by their errors


def test_cull_landmarks_gate_and_reference_case(jax_map):
    """A False gate kills nothing; and the case of tests/test_stages.py: of
    10 landmarks seen by two keyframes, the displaced one and the one
    observed once are culled."""
    jc, tc = cameras()
    ms_t = convert.mapstate_from_numpy(jax_map)
    ms_t, n = TS.cull_landmarks(ms_t, tc, 5.0, 2, gate=torch.tensor(False))
    assert int(n) == 0
    _same_tables(ms_t, jax_map)

    rng = np.random.default_rng(0)
    X = rng.uniform([-1, -1, 3.0], [1, 1, 5.0], (10, 3)).astype(np.float32)
    ms = JMS.empty_map(4, 128, 32)
    for fid, (w, tt) in enumerate((([0, 0, 0], [0, 0, 0]), ([0, 0.02, 0], [0.2, 0, 0]))):
        pose = jse3.Pose(jse3.so3_exp(jnp.asarray(w, jnp.float32)),
                         jnp.asarray(tt, jnp.float32))
        pc = np.asarray(jse3.se3_apply(pose, jnp.asarray(X)))
        px = np.zeros((32, 2), np.float32)
        px[:10] = np.stack([jc.fx * pc[:, 0] / pc[:, 2] + jc.cx,
                            jc.fy * pc[:, 1] / pc[:, 2] + jc.cy], -1)
        links = np.full(32, JMS.FREE, np.int32)
        links[:10] = np.arange(10)
        if fid == 1:
            links[1] = JMS.FREE
        ms, _ = JMS.insert_keyframe(ms, jnp.asarray(fid), pose, px,
                                    np.zeros((32, 32), np.uint8),
                                    np.arange(32) < 10, links, np.zeros(32, np.float32))
    pos = np.zeros((ms.lm_physical, 3), np.float32)
    pos[:10] = X
    pos[0] += 0.5
    ms = ms._replace(lm_pos=jnp.asarray(pos.T),
                     lm_alive=jnp.asarray(np.arange(ms.lm_physical) < 10),
                     next_lm=jnp.asarray(10, jnp.int32))
    ms_t, n_t = TS.cull_landmarks(convert.mapstate_from_numpy(ms), tc, 5.0, 2)
    ms_j, n_j = JS.cull_landmarks(ms, jc, 5.0, 2)
    assert int(n_t) == int(n_j) == 2
    alive = to_np(ms_t.lm_alive)
    assert not alive[0] and not alive[1] and alive[2:10].all()
    _same_tables(ms_t, ms_j)


CULL_KW = dict(min_keyframes_for_culling=3, kf_min_shared_observations=2,
               landmark_max_reproj_error=5.0, min_landmark_observations=2)


@pytest.mark.parametrize("case", ["exceeded", "very_redundant", "none_eligible",
                                  "too_few_keyframes"])
def test_cull_keyframes_same_slot(jax_map, case):
    """The first eligible keyframe in ascending frame id goes, in both; the
    last keyframe (slot 7), the init keyframe (slot 0) and the current frame
    never do."""
    jc, tc = cameras()
    kw = dict(CULL_KW, max_keyframes=4, kf_redundant_ratio=0.5)
    if case == "very_redundant":      # not over max_keyframes: needs ratio > 0.95
        kw.update(max_keyframes=0, kf_redundant_ratio=0.5, kf_min_shared_observations=1,
                  min_landmark_observations=1)
    elif case == "none_eligible":
        kw.update(kf_redundant_ratio=1.5)
    elif case == "too_few_keyframes":
        kw.update(min_keyframes_for_culling=7)
    cur = 3      # the current frame id: keyframe slot 1 is skipped
    ms_j = JS.cull_keyframes_device(jax_map, jc, jnp.asarray(7), jnp.asarray(0),
                                    jnp.asarray(cur), **kw)
    ms_t, slot, n_culled = TS.cull_keyframes_device(
        convert.mapstate_from_numpy(jax_map), tc, 7, 0, cur, **kw)
    _same_tables(ms_t, ms_j)
    gone = np.flatnonzero((np.asarray(jax_map.kf_id) >= 0) & (np.asarray(ms_j.kf_id) < 0))
    if case in ("exceeded", "very_redundant"):
        assert gone.tolist() == [slot] and slot == 2
    else:
        assert slot == -1 and gone.size == 0 and int(n_culled) == 0


KW = dict(kf_capacity=8, lm_capacity=16384)
SCAN_OPTS = {
    "default": dict(enable_culling=True),
    "keyframes_removed": dict(enable_culling=True, min_landmark_observations=1,
                              kf_min_shared_observations=1, max_keyframes=4),
}


@pytest.mark.parametrize("which", list(SCAN_OPTS))
def test_culling_scan_band(which):
    grays, depths, gt = sequence(16, 7)
    jc, tc = cameras()
    st_j, oj = jax_run(jc, grays, depths, JOpts(**SCAN_OPTS[which]), **KW)
    jax.block_until_ready(oj)
    stats = {}
    st_t, ot = TSP.run_scan_pipeline(tc, grays, depths,
                                     TrackingOptions(**SCAN_OPTS[which]),
                                     device="cpu", stats=stats, **KW)
    tr_j, tr_t = np.asarray(oj.tracked), to_np(ot.tracked)
    assert abs(int(tr_t.sum()) - int(tr_j.sum())) <= 2, (tr_j, tr_t)
    same_kf = (np.asarray(oj.n_keyframes) == to_np(ot.n_keyframes)).mean()
    same_lm = (np.asarray(oj.n_landmarks) == to_np(ot.n_landmarks)).mean()
    assert same_kf >= 0.8 and same_lm >= 0.8, (same_kf, same_lm)
    assert stats["lm_culled"] > 0
    # one read per keyframe event for the keyframe culling's decision
    assert stats["host_syncs"] >= 16 + 1 + 2 * stats["kf_events"], stats
    if which == "default":
        # the map collapses and is rebuilt: not every frame tracks, in both
        assert tr_j.sum() < 16 and tr_t.sum() < 16
        assert stats["kf_culled"] == 0
    else:
        assert tr_j.all() and tr_t.all()
        assert stats["kf_culled"] >= 2
        ate_j, _ = ate_of_run(np.asarray(oj.pose), tr_j, gt)
        ate_t, _ = ate_of_run(to_np(ot.pose), tr_t, gt)
        assert ate_j < 0.01 and abs(ate_t - ate_j) <= 1e-3, (ate_j, ate_t)
        np.testing.assert_array_equal(np.sort(to_np(st_t.ms.kf_id)),
                                      np.sort(np.asarray(st_j.ms.kf_id)))
