"""Map state and landmark creation of the port against the JAX package.

The ring insert (with eviction), the contiguous allocator (with overflow),
compaction and the BA window give exactly the JAX package's tables after the
same sequence of operations. On two rendered keyframes of the synthetic
sequence (seed 7, frames 0 and 4, ground-truth poses, depth removed from a
third of the features so that triangulation has work), depth backprojection
and two-view triangulation give the same links on >= 0.99 of the features
and the same landmark positions within 1e-3 m."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from visionx_slam_tpu.models import orb_jax as OJ
from visionx_slam_tpu.ops import se3 as jse3
from visionx_slam_tpu.tracking import mapstate as JMS
from visionx_slam_tpu.tracking import stages as JS

from visionx_slam_torch import convert
from visionx_slam_torch.data import synthetic
from visionx_slam_torch.ops import se3 as tse3
from visionx_slam_torch.tracking import mapstate as TMS
from visionx_slam_torch.tracking import stages as TS

from torch_parity import cameras, sequence, t, to_np

K, L, N = 6, 64, 16


def _same_tables(ms_t, ms_j):
    got = convert.mapstate_to_numpy(ms_t)
    for f in JMS.MapState._fields:
        np.testing.assert_array_equal(got[f], np.asarray(getattr(ms_j, f)), err_msg=f)


def _frame(rng, links=None):
    px = rng.uniform(0, 640, (N, 2)).astype(np.float32)
    desc = rng.integers(0, 256, (N, 32)).astype(np.uint8)
    valid = rng.random(N) > 0.2
    feat_lm = np.full(N, -1, np.int32) if links is None else links
    depth = rng.uniform(0.5, 5, N).astype(np.float32)
    q = np.asarray(jse3.so3_exp(rng.normal(0, 0.1, 3).astype(np.float32)))
    tt = rng.normal(0, 1, 3).astype(np.float32)
    return (q, tt), px, desc, valid, feat_lm, depth


def test_ring_allocator_compaction_and_window_match_exactly():
    rng = np.random.default_rng(0)
    ms_j = JMS.empty_map(K, L, N)
    ms_t = TMS.empty_map(K, L, N)
    _same_tables(ms_t, ms_j)
    for i in range(K + 4):             # wraps the ring, evicting 4 keyframes
        # landmarks first, then a keyframe linking some of them
        want = rng.random(N) < 0.6
        pos = rng.normal(0, 2, (N, 3)).astype(np.float32)
        ms_j, s_j = JMS.allocate_landmarks(ms_j, want, pos, obs_init=i % 3)
        ms_t, s_t = TMS.allocate_landmarks(ms_t, t(want), t(pos), obs_init=i % 3)
        np.testing.assert_array_equal(to_np(s_t), np.asarray(s_j))
        links = np.where(rng.random(N) < 0.5, np.asarray(s_j), -1).astype(np.int32)
        (q, tt), px, desc, valid, feat_lm, depth = _frame(rng, links)
        fresh = i % 4 == 3
        if fresh:
            feat_lm = np.full(N, -1, np.int32)
        ms_j, slot_j = JMS.insert_keyframe(
            ms_j, jnp.asarray(10 * i), jse3.Pose(q, tt), px, desc, valid, feat_lm,
            depth, fresh_links=fresh)
        ms_t, slot_t = TMS.insert_keyframe(
            ms_t, 10 * i, tse3.Pose(t(q), t(tt)), t(px), t(desc), t(valid),
            t(feat_lm), t(depth), fresh_links=fresh)
        assert slot_t == int(slot_j)
        _same_tables(ms_t, ms_j)
        if i in (6, 8):
            ms_j = JMS.compact_landmarks(ms_j)
            ms_t = TMS.compact_landmarks(ms_t)
            _same_tables(ms_t, ms_j)
        for W in (1, 3, 5, 8):
            sl_j, v_j = JMS.window_slots(ms_j, W)
            sl_t, v_t = TMS.window_slots(ms_t, W)
            np.testing.assert_array_equal(to_np(sl_t), np.asarray(sl_j))
            np.testing.assert_array_equal(to_np(v_t), np.asarray(v_j))
    assert int(ms_j.lm_dropped) > 0     # the allocator overflowed at L = 64
    pj, pt = JMS.map_pose(ms_j, 3), TMS.map_pose(ms_t, 3)
    np.testing.assert_array_equal(to_np(pt.q), np.asarray(pj.q))
    assert int(TMS.n_keyframes(ms_t)) == K
    assert int(TMS.n_landmarks(ms_t)) == int(JMS.n_landmarks(ms_j))


@pytest.fixture(scope="module")
def two_keyframes():
    """Extracted frames 0 and 4 of the synthetic sequence with their
    ground-truth T_cw; a third of the features lose their depth."""
    grays, depths, _ = sequence(8, 7)
    rng = np.random.default_rng(1)
    out = []
    for i in (0, 4):
        px, _, desc, valid = (np.asarray(a) for a in OJ.orb_extract(grays[i], use_pallas=0))
        d = np.asarray(JS.sample_depth_image(depths[i], px, valid))
        d = np.where(rng.random(d.shape) < 0.33, 0.0, d).astype(np.float32)
        R_wc, t_wc = synthetic.trajectory_pose(i, 8)
        R = R_wc.T.astype(np.float32)
        q = np.asarray(jse3.matrix_to_quat(R))
        tt = (-R_wc.T @ t_wc).astype(np.float32)
        out.append(((q, tt), px, desc, valid, d))
    return out


def _kf_map(two_keyframes):
    ms = JMS.empty_map(8, 4096, 1024)
    for i, ((q, tt), px, desc, valid, d) in enumerate(two_keyframes):
        ms, _ = JMS.insert_keyframe(
            ms, jnp.asarray(4 * i), jse3.Pose(q, tt), px, desc, valid,
            jnp.full((1024,), -1, jnp.int32), d, fresh_links=True)
    return ms


def _links_and_positions(ms_t, ms_j):
    links_t, links_j = to_np(ms_t.kf_feat_lm), np.asarray(ms_j.kf_feat_lm)
    agree = (links_t == links_j).mean()
    assert agree >= 0.99, agree
    both = (links_t == links_j) & (links_j >= 0)
    lm = links_j[both]
    pos_t, pos_j = to_np(ms_t.lm_pos)[:, lm], np.asarray(ms_j.lm_pos)[:, lm]
    assert np.abs(pos_t - pos_j).max() <= 1e-3
    return both


def test_depth_landmarks_and_triangulate_pair_match(two_keyframes):
    jc, tc = cameras()
    ms_j = _kf_map(two_keyframes)
    ms_t = convert.mapstate_from_numpy(ms_j)
    for slot in (0, 1):
        pose = JMS.map_pose(ms_j, slot)
        ms_j = JS.depth_landmarks(ms_j, jc, slot, pose)
        ms_t = TS.depth_landmarks(ms_t, tc, slot, convert.pose_from_numpy(pose))
    n_depth = int(ms_j.next_lm)
    assert int(ms_t.next_lm) == n_depth
    _links_and_positions(ms_t, ms_j)
    ms_j = JS.triangulate_pair(ms_j, jc, 0, 1, 1.0, 5.0)
    ms_t = TS.triangulate_pair(ms_t, tc, 0, 1, 1.0, 5.0)
    n_tri = int(ms_j.next_lm) - n_depth
    assert n_tri > 20, n_tri           # triangulation had real work
    assert abs(int(ms_t.next_lm) - int(ms_j.next_lm)) <= max(2, 0.01 * n_tri)
    both = _links_and_positions(ms_t, ms_j)
    # the triangulated landmarks are linked from both keyframes
    assert (to_np(ms_t.lm_obs)[: int(ms_t.next_lm)] >= 1).all()
    assert both.sum() > n_depth


def test_triangulable_count_matches(two_keyframes):
    jc, tc = cameras()
    ((qa, ta), pxa, da, va, _), ((qb, tb), pxb, db, vb, _) = two_keyframes
    from visionx_slam_tpu.models import matching as JM

    m = JM.knn2_ratio_match(da, va, db, vb)
    idx, valid = np.asarray(m.idx), np.asarray(m.valid)
    # relative pose of b w.r.t. a, a at the identity
    Ra = np.asarray(jse3.quat_to_matrix(qa))
    Rb = np.asarray(jse3.quat_to_matrix(qb))
    R = Rb @ Ra.T
    tt = (tb - R @ ta).astype(np.float32)
    q = np.asarray(jse3.matrix_to_quat(R.astype(np.float32)))
    n_j = int(JS.triangulable_count(jc, pxa, pxb[idx], valid, jse3.Pose(q, tt), 1.0, 5.0))
    n_t = int(TS.triangulable_count(tc, t(pxa), t(pxb[idx]), t(valid),
                                    tse3.Pose(t(q), t(tt)), 1.0, 5.0))
    assert n_j > 20
    assert abs(n_t - n_j) <= max(1, 0.01 * n_j), (n_t, n_j)


def test_map_pose_is_a_copy():
    ms = TMS.empty_map(4, 32, 8)
    p = TMS.map_pose(ms, 0)
    ms.kf_q[0] = torch.tensor([0.0, 1.0, 0.0, 0.0])
    assert float(p.q[0]) == 1.0
