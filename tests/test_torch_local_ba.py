"""Windowed local BA and the scan's keyframe event of the port against the
JAX package.

``local_ba`` on a noisy five-keyframe window built by the JAX package and
converted (the window of tests/test_local_ba.py), with ``early_exit`` on
and off: equal iteration counts, final cost within 1e-4 relative, window
poses and landmark positions within 1e-4.

``create_keyframe`` from a converted JAX ``ScanState``: the JAX scan run
over frames 0-6 of the synthetic sequence (seed 7), then the keyframe event
of frame 7 with the JAX package's own observations and match, with the
default options and with ``link_tracked_landmarks`` (the monocular option
that makes the new keyframe inherit its matches' landmarks). The depth
images have a hole (the left 200 columns), so that triangulation and local
BA have work. No randomness runs on this branch, so: links and
observation counts exact; window poses within 1e-4; landmark positions
(and the cache's copies of them) within 1e-4 relative (with the inherited links a
few BA-refined points several metres away differ by up to 9e-5 of their
magnitude)."""

import numpy as np
import pytest
from scipy.spatial.transform import Rotation

import jax.numpy as jnp

from visionx_slam_tpu.models import local_ba as JBA
from visionx_slam_tpu.models import matching as JM
from visionx_slam_tpu.ops import se3 as jse3
from visionx_slam_tpu.tracking import mapstate as JMS
from visionx_slam_tpu.tracking import scan_pipeline as JSP
from visionx_slam_tpu.utils.config import TrackingOptions as JOpts

from visionx_slam_torch import convert
from visionx_slam_torch.models import local_ba as TBA
from visionx_slam_torch.tracking import scan_pipeline as TSP
from visionx_slam_torch.utils.config import TrackingOptions

from torch_parity import cameras, sequence, to_np


def _window(seed, n_kf=5, n_lm=100, N=128):
    """A noisy window: ground-truth landmarks seen by every keyframe (each
    observed n_kf times), perturbed poses and points."""
    rng = np.random.default_rng(seed)
    jc, _ = cameras()
    f, cx, cy = float(jc.fx), float(jc.cx), float(jc.cy)
    X = rng.uniform([-2, -1.5, 3.0], [2, 1.5, 7.0], size=(n_lm, 3))
    ms = JMS.empty_map(8, 256, N)
    for k in range(n_kf):
        R = Rotation.from_rotvec(rng.normal(scale=0.03, size=3)).as_matrix()
        tt = np.array([0.1 * k, 0.0, 0.0]) + rng.normal(scale=0.02, size=3)
        pc = X @ R.T + tt
        px = np.zeros((N, 2), np.float32)
        px[:n_lm] = (np.stack([f * pc[:, 0] / pc[:, 2] + cx, f * pc[:, 1] / pc[:, 2] + cy], -1)
                     + rng.normal(scale=0.3, size=(n_lm, 2)))
        links = np.full(N, -1, np.int32)
        links[:n_lm] = np.arange(n_lm)
        Rp = Rotation.from_rotvec(rng.normal(scale=0.004, size=3)).as_matrix() @ R
        q = Rotation.from_matrix(Rp).as_quat()
        pose = jse3.Pose(jnp.asarray([q[3], q[0], q[1], q[2]], jnp.float32),
                         jnp.asarray(tt + rng.normal(scale=0.004, size=3), jnp.float32))
        ms, _ = JMS.insert_keyframe(
            ms, jnp.asarray(k), pose, jnp.asarray(px), jnp.zeros((N, 32), jnp.uint8),
            jnp.asarray(np.arange(N) < n_lm), jnp.asarray(links), jnp.zeros(N, jnp.float32))
    pos = np.zeros((3, ms.lm_physical), np.float32)
    pos[:, :n_lm] = (X + rng.normal(scale=0.01, size=X.shape)).T
    alive = np.zeros(ms.lm_physical, bool)
    alive[:n_lm] = True
    return ms._replace(lm_pos=jnp.asarray(pos), lm_alive=jnp.asarray(alive),
                       next_lm=jnp.asarray(n_lm, jnp.int32))


@pytest.mark.parametrize("early_exit", [True, False])
@pytest.mark.parametrize("seed, rel_tol", [(0, 1e-3), (1, 1e-6)])
def test_local_ba_matches(early_exit, seed, rel_tol):
    jc, tc = cameras()
    ms_j = _window(seed)
    ms_t = convert.mapstate_from_numpy(ms_j)
    kw = dict(window_size=5, max_iterations=5, rel_tol=rel_tol, early_exit=early_exit)
    out_j, st_j = JBA.local_ba(ms_j, jc, JBA.BAOptions(**kw))
    out_t, st_t = TBA.local_ba(ms_t, tc, TBA.BAOptions(**kw))
    assert int(st_t.iterations) == int(st_j.iterations) > 0
    assert int(st_t.total_obs) == int(st_j.total_obs)
    c_t, c_j = float(st_t.final_cost), float(st_j.final_cost)
    assert abs(c_t - c_j) <= 1e-4 * abs(c_j), (c_t, c_j)
    np.testing.assert_allclose(to_np(out_t.kf_q), np.asarray(out_j.kf_q), atol=1e-4)
    np.testing.assert_allclose(to_np(out_t.kf_t), np.asarray(out_j.kf_t), atol=1e-4)
    np.testing.assert_allclose(to_np(out_t.lm_pos), np.asarray(out_j.lm_pos), atol=1e-4)


def test_local_ba_disabled_window_is_a_no_op():
    """One keyframe: nothing moves and no iteration runs (both variants)."""
    jc, tc = cameras()
    ms_j = _window(2, n_kf=1)
    for early_exit in (True, False):
        ms_t = convert.mapstate_from_numpy(ms_j)
        out_t, st_t = TBA.local_ba(ms_t, tc, TBA.BAOptions(early_exit=early_exit))
        _, st_j = JBA.local_ba(ms_j, jc, JBA.BAOptions(early_exit=early_exit))
        assert int(st_t.iterations) == int(st_j.iterations) == 0
        assert int(st_t.total_obs) == int(st_j.total_obs)
        # the masked iterations re-normalize the quaternions (float32 noise)
        np.testing.assert_allclose(to_np(out_t.kf_q), np.asarray(ms_j.kf_q), atol=1e-7)
        np.testing.assert_array_equal(to_np(out_t.lm_pos), np.asarray(ms_j.lm_pos))


def _closure(fn, name):
    return dict(zip(fn.__code__.co_freevars,
                    (c.cell_contents for c in fn.__closure__)))[name]


@pytest.fixture(scope="module", params=[False, True], ids=["default", "link_tracked"])
def kf_event(request):
    """The JAX scan state after frames 0-6 and the inputs of frame 7."""
    grays, depths, _ = sequence(8, 7)
    depths = depths.copy()
    depths[:, :, :200] = 0.0
    jc, _ = cameras()
    opts = JOpts(link_tracked_landmarks=request.param)
    kw = dict(n_features_cap=1024, kf_capacity=8, lm_capacity=16384)
    st, out = JSP.run_scan_pipeline(jc, grays[:7], depths[:7], opts, **kw)
    assert np.asarray(out.tracked).all()
    obs, _, _, bits, pop = JSP.extract_sequence(
        jnp.asarray(grays), jnp.asarray(depths), {"n_slots": 1024})
    obs7 = JSP.FrameObs(*(x[7] for x in obs))
    match = JM.knn2_from_bits(st.kf_bits, st.kf_pop, st.kf_fvalid, bits[7], pop[7],
                              obs7.valid)
    # the pose this frame's tracking would hand over: the prior tier's
    m = JM.reference_distance_filter(match)
    sol = JSP.pnp_prior(jc, st.kf_lm_pts, obs7.px[m.idx], m.valid & st.kf_lm_valid,
                        st.cur_pose, opts.max_reproj_error, refine_iters=2)
    st = st._replace(cur_pose=sol.pose)
    step = JSP.build_scan_step(jc, opts, (640, 480), **kw)
    create = _closure(step, "create_keyframe")
    st_after = create(st, obs7, jnp.int32(7), match)
    return st, obs7, match, st_after, kw, request.param


def test_create_keyframe_from_a_converted_jax_state(kf_event):
    st_j, obs_j, match_j, after_j, kw, link = kf_event
    _, tc = cameras()
    st_t = convert.scanstate_from_numpy(st_j)
    step = TSP.build_scan_step(tc, TrackingOptions(link_tracked_landmarks=link),
                               (640, 480), **kw)
    after_t = step.create_keyframe(st_t, convert.frameobs_from_numpy(obs_j), 7,
                                   convert.match_from_numpy(match_j))
    ms_t, ms_j = after_t.ms, after_j.ms
    assert step.counters.kf_events == 1
    assert int(step.counters.ba_iterations) > 0          # BA had work
    assert after_t.last_kf_slot == int(after_j.last_kf_slot)
    assert after_t.kf_cursor == int(ms_j.next_kf)
    for f in ("kf_feat_lm", "kf_id", "lm_alive", "lm_obs", "next_lm", "next_kf"):
        np.testing.assert_array_equal(to_np(getattr(ms_t, f)),
                                      np.asarray(getattr(ms_j, f)), err_msg=f)
    alive = np.asarray(ms_j.lm_alive)
    # BA-refined points metres away: 1e-4 relative (or absolute near 0)
    np.testing.assert_allclose(to_np(ms_t.lm_pos)[:, alive],
                               np.asarray(ms_j.lm_pos)[:, alive], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(to_np(ms_t.kf_q), np.asarray(ms_j.kf_q), atol=1e-4)
    np.testing.assert_allclose(to_np(ms_t.kf_t), np.asarray(ms_j.kf_t), atol=1e-4)
    np.testing.assert_allclose(to_np(after_t.cur_pose.t), np.asarray(after_j.cur_pose.t),
                               atol=1e-4)
    np.testing.assert_array_equal(to_np(after_t.kf_lm_valid), np.asarray(after_j.kf_lm_valid))
    np.testing.assert_allclose(to_np(after_t.kf_lm_pts), np.asarray(after_j.kf_lm_pts),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(to_np(after_t.kf_bits.float()),
                                  np.asarray(after_j.kf_bits, np.float32))
