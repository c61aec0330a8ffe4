"""The multi-device module of the port (``visionx_slam_torch/parallel/
batch.py``) against the JAX package's ``parallel/batch.py``, and against
itself across ranks.

- ``make_correlated_fleet`` (D=2, N=64): the port's tensors equal the JAX
  fleet's bit for bit (the same numpy draws).
- ``slam_step`` on that fleet, fed the JAX step's own minimal sets (16
  hypotheses, ``max_iterations=2``; JAX runs ``jax.vmap(slam_step)`` on one
  CPU device as tests/test_multichip.py does): poses within 1e-4, inlier
  and match counts equal, the new keyframe's slot, ids, links and the
  landmark counts equal, landmark positions within 1e-4, ``ba_cost``
  within 1e-3 relative or 1e-8 px^2 (it is float32 rounding on exact
  projections). The correlated fleet is well conditioned, so the DLT
  hypotheses are not float32 noise (F7).
- ``stack_*``/``unstack_*`` are inverse; the world of one and the lane
  split of a ``Mesh``. The two-rank runs are in tests/test_torch_ranks.py.
"""

import numpy as np
import pytest
import torch

import jax

from visionx_slam_tpu.models import estimation as JE
from visionx_slam_tpu.models import matching as JM
from visionx_slam_tpu.models.local_ba import BAOptions as JBAOptions
from visionx_slam_tpu.ops.camera import make_camera as jax_camera
from visionx_slam_tpu.parallel import batch as JB
from visionx_slam_tpu.tracking import mapstate as JMS
from visionx_slam_tpu.tracking import stages as JS

from visionx_slam_torch import convert
from visionx_slam_torch.models.local_ba import BAOptions
from visionx_slam_torch.ops.camera import make_camera
from visionx_slam_torch.parallel import batch as TB
from visionx_slam_torch.tracking.stages import FrameObs

from torch_parity import t, to_np

CAM = (100.0, 100.0, 32.0, 24.0)   # the dry run's camera
D, N, H = 2, 64, 16


@pytest.fixture(scope="module")
def fleets():
    jc, tc = jax_camera(*CAM), make_camera(*CAM)
    jf = JB.make_correlated_fleet(jc, D, N, seed=0)
    tf = TB.make_correlated_fleet(tc, D, N, seed=0, device="cpu")
    return jc, tc, jf, tf


def _lane(tree, b):
    return jax.tree.map(lambda x: x[b], tree)


def test_correlated_fleet_equals_jax(fleets):
    _, _, (jms, jobs, jfid, _, jgts), (tms, tobs, tfid, gens, tgts) = fleets
    for f in tms._fields:
        np.testing.assert_array_equal(to_np(getattr(tms, f)),
                                      np.asarray(getattr(jms, f)), err_msg=f)
    for f in FrameObs._fields:
        np.testing.assert_array_equal(to_np(getattr(tobs, f)),
                                      np.asarray(getattr(jobs, f)), err_msg=f)
    np.testing.assert_array_equal(to_np(tfid), np.asarray(jfid))
    for (Rj, tj), (Rt, tt) in zip(jgts, tgts):
        np.testing.assert_array_equal(Rt, Rj)
        np.testing.assert_array_equal(tt, tj)
    assert len(gens) == D and int(tms.next_lm[0]) == N


def test_slam_step_matches_jax(fleets):
    jc, tc, (jms, jobs, jfid, jkeys, _), _ = fleets
    jopts = JBAOptions(max_iterations=2)
    ms_j, pose_j, st_j = jax.jit(jax.vmap(
        lambda ms, obs, fid, key: JB.slam_step(ms, obs, fid, jc, key, H, jopts)
    ))(jms, jobs, jfid, jkeys)

    def jax_sets(ms, obs, key):   # the sets JAX's pnp_ransac draws
        slots, svalid = JMS.window_slots(ms, 1)
        slot = slots[0]
        m = JM.match_frames(ms.kf_desc[slot], ms.kf_fvalid[slot] & svalid[0],
                            obs.desc, obs.valid)
        _, _, valid = JS.pnp_correspondences(ms, slot, obs, m)
        return JE.sample_minimal_sets(key, valid, H, 6)

    for b in range(D):
        ms_t = convert.mapstate_from_numpy(_lane(jms, b))
        obs_t = convert.frameobs_from_numpy(_lane(jobs, b))
        idx = t(np.asarray(jax_sets(_lane(jms, b), _lane(jobs, b), jkeys[b])))
        ms2, pose, st = TB.slam_step(ms_t, obs_t, int(jfid[b]), tc, None, H,
                                     BAOptions(max_iterations=2), sample_idx=idx)
        np.testing.assert_allclose(to_np(pose), np.asarray(pose_j[b]), atol=1e-4)
        assert int(st["inliers"]) == int(st_j["inliers"][b]) > N // 2
        assert int(st["matches"]) == int(st_j["matches"][b]) > N // 2
        # the observations are exact projections: the cost is float32
        # rounding, ~2e-10 px^2 (measured gap 3.1e-11), so an absolute floor
        np.testing.assert_allclose(float(st["ba_cost"]), float(st_j["ba_cost"][b]),
                                   rtol=1e-3, atol=1e-8)
        lane_j = _lane(ms_j, b)
        for f in ("kf_id", "kf_feat_lm", "kf_fvalid", "lm_alive", "lm_obs",
                  "next_kf", "next_lm"):
            np.testing.assert_array_equal(to_np(getattr(ms2, f)),
                                          np.asarray(getattr(lane_j, f)), err_msg=f)
        np.testing.assert_allclose(to_np(ms2.lm_pos), np.asarray(lane_j.lm_pos),
                                   atol=1e-4)
        np.testing.assert_allclose(to_np(ms2.kf_t), np.asarray(lane_j.kf_t), atol=1e-4)


def test_stack_and_unstack_are_inverse(fleets):
    *_, (tms, tobs, _, _, _) = fleets
    lanes = TB.unstack_states(tms)
    assert len(lanes) == D and lanes[0].kf_q.shape == tms.kf_q.shape[1:]
    back = TB.stack_states(lanes)
    assert all(torch.equal(a, b) for a, b in zip(back, tms))
    assert all(torch.equal(a, b) for a, b in
               zip(TB.stack_obs(TB.unstack_obs(tobs)), tobs))


def test_mesh_of_one_and_lanes():
    mesh = TB.make_mesh(device="cpu")
    assert "world of one" in repr(mesh) and mesh.world_size == 1
    assert mesh.lanes(4) == slice(0, 4)
    x = torch.arange(3)
    assert mesh.all_sum(x) is x
    with pytest.raises(ValueError):
        TB.make_mesh(2, device="cpu")
    with pytest.raises(ValueError):
        TB.Mesh(None, 1, 2, torch.device("cpu")).lanes(3)
    assert TB.Mesh(None, 1, 2, torch.device("cpu")).lanes(4) == slice(2, 4)
