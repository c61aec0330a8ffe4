"""se3, camera and linalg of the port against the JAX package on random
float32 batches (atol 1e-5)."""

import numpy as np
import pytest

from visionx_slam_tpu.ops import camera as jcam
from visionx_slam_tpu.ops import linalg as jla
from visionx_slam_tpu.ops import se3 as jse3

from visionx_slam_torch.ops import camera as tcam
from visionx_slam_torch.ops import linalg as tla
from visionx_slam_torch.ops import se3 as tse3

from torch_parity import cameras, t, to_np

ATOL = 1e-5


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _unit_q(rng, n):
    q = _rand(rng, n, 4)
    return (q / np.linalg.norm(q, axis=-1, keepdims=True)).astype(np.float32)


def _close(a, b, atol=ATOL):
    np.testing.assert_allclose(to_np(a), np.asarray(b), rtol=0, atol=atol)


@pytest.fixture
def rng():
    return np.random.default_rng(11)


def test_quaternion_primitives(rng):
    a, b = _unit_q(rng, 64), _unit_q(rng, 64)
    _close(tse3.quat_mul(t(a), t(b)), jse3.quat_mul(a, b))
    _close(tse3.quat_to_matrix(t(a)), jse3.quat_to_matrix(a))
    R = np.asarray(jse3.quat_to_matrix(a))
    _close(tse3.matrix_to_quat(t(R)), jse3.matrix_to_quat(R))
    w = _rand(rng, 64, 3)
    _close(tse3.so3_hat(t(w)), jse3.so3_hat(w))
    q0 = tse3.identity_pose((5,))
    _close(q0.q, jse3.identity_pose((5,)).q)
    _close(q0.t, jse3.identity_pose((5,)).t)


@pytest.mark.parametrize("scale", [1e-6, 0.3, 2.0])
def test_se3_exp_compose_inverse_apply(rng, scale):
    xi = _rand(rng, 64, 6, scale=scale)
    Pt, Pj = tse3.se3_exp(t(xi)), jse3.se3_exp(xi)
    _close(Pt.q, Pj.q)
    _close(Pt.t, Pj.t)
    qb, tb = _unit_q(rng, 64), _rand(rng, 64, 3)
    Ct = tse3.se3_compose(Pt, tse3.Pose(t(qb), t(tb)))
    Cj = jse3.se3_compose(Pj, jse3.Pose(qb, tb))
    _close(Ct.q, Cj.q)
    _close(Ct.t, Cj.t)
    It, Ij = tse3.se3_inverse(Ct), jse3.se3_inverse(Cj)
    _close(It.q, Ij.q)
    _close(It.t, Ij.t)
    p = _rand(rng, 64, 7, 3)
    Pb = jse3.Pose(np.asarray(Cj.q)[:, None], np.asarray(Cj.t)[:, None])
    _close(tse3.se3_apply(tse3.Pose(Ct.q[:, None], Ct.t[:, None]), t(p)),
           jse3.se3_apply(Pb, p))
    _close(tse3.se3_matrix(Ct), jse3.se3_matrix(Cj))


def test_camera(rng):
    jc, tc = cameras()
    px = (rng.uniform(0, 640, (50, 2))).astype(np.float32)
    d = rng.uniform(0.2, 5.0, 50).astype(np.float32)
    _close(tcam.backproject(tc, t(px), t(d)), jcam.backproject(jc, px, d))
    q, tt = _unit_q(rng, 1)[0], _rand(rng, 3, scale=0.1)
    pw = np.concatenate([_rand(rng, 40, 2), rng.uniform(-1, 4, (40, 1))],
                        -1).astype(np.float32)
    uv_t, ok_t, pc_t = tcam.project_pinhole(tc, tse3.Pose(t(q), t(tt)), t(pw))
    uv_j, ok_j, pc_j = jcam.project_pinhole(jc, jse3.Pose(q, tt), pw)
    np.testing.assert_array_equal(to_np(ok_t), np.asarray(ok_j))
    _close(pc_t, pc_j)
    _close(uv_t, uv_j)


def test_linalg(rng):
    A3 = _rand(rng, 64, 3, 3) + 3 * np.eye(3, dtype=np.float32)
    _close(tla.inv3x3(t(A3)), jla.inv3x3(A3))
    G = _rand(rng, 64, 6, 6)
    H = (G @ np.swapaxes(G, 1, 2) + np.eye(6, dtype=np.float32)).astype(np.float32)
    b = _rand(rng, 64, 6)
    _close(tla.chol_solve6x6(t(H), t(b)), jla.chol_solve6x6(H, b), atol=1e-4)
    x = np.asarray(jla.chol_solve6x6(H, b))
    np.testing.assert_allclose(np.einsum("bij,bj->bi", H, x), b, atol=1e-3)
