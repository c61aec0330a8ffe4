"""se3, camera and linalg of the port against the JAX package on random
float32 batches (atol 1e-5); the deterministic segment sum of the solvers
against ``index_add_`` on the CPU, bit for bit, and against
``jax.ops.segment_sum`` (the JAX package's sorted sums) within 1e-5."""

import numpy as np
import pytest
import torch

from visionx_slam_tpu.ops import camera as jcam
from visionx_slam_tpu.ops import linalg as jla
from visionx_slam_tpu.ops import se3 as jse3

from visionx_slam_torch.ops import camera as tcam
from visionx_slam_torch.ops.index import segment_sum, segments
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


@pytest.mark.parametrize("scale", [1e-6, 0.3, 2.0])
def test_se3_log_and_jacobian_inverse(rng, scale):
    xi = _rand(rng, 64, 6, scale=scale)
    w = xi[:, 3:]
    _close(tse3._so3_left_jacobian_inv(t(w)), jse3._so3_left_jacobian_inv(w))
    q = np.asarray(jse3.so3_exp(w))
    _close(tse3.so3_log(t(q)), jse3.so3_log(q))
    _close(tse3.so3_log(t(-q)), jse3.so3_log(-q))        # either sign of q
    P = jse3.se3_exp(xi)
    Pq, Pt = np.asarray(P.q), np.asarray(P.t)
    _close(tse3.se3_log(tse3.Pose(t(Pq), t(Pt))), jse3.se3_log(jse3.Pose(Pq, Pt)))
    # log inverts exp away from the half turn
    if scale < 1.0:
        _close(tse3.se3_log(tse3.se3_exp(t(xi))), xi, atol=1e-4)


@pytest.mark.parametrize("fn", ["se3_from_matrix", "se3_from_Rt", "se3_retract_left"])
def test_se3_constructors(rng, fn):
    q, tt = _unit_q(rng, 32), _rand(rng, 32, 3)
    if fn == "se3_retract_left":
        dx = _rand(rng, 32, 6, scale=0.05)
        Pt = tse3.se3_retract_left(tse3.Pose(t(q), t(tt)), t(dx))
        Pj = jse3.se3_retract_left(jse3.Pose(q, tt), dx)
    else:
        M = np.asarray(jse3.se3_matrix(jse3.Pose(q, tt)))
        if fn == "se3_from_matrix":
            Pt, Pj = tse3.se3_from_matrix(t(M)), jse3.se3_from_matrix(M)
        else:
            R, tr = M[:, :3, :3], M[:, :3, 3]
            Pt, Pj = tse3.se3_from_Rt(t(R), t(tr)), jse3.se3_from_Rt(R, tr)
    _close(Pt.q, Pj.q)
    _close(Pt.t, Pj.t)


def test_intrinsic_matrix_and_project_distorted(rng):
    from visionx_slam_tpu.ops.camera import make_camera as jax_camera

    from visionx_slam_torch.ops.camera import make_camera

    args = (517.3, 516.5, 318.6, 255.3, 0.2624, -0.9531, -0.0054, 0.0026)
    jc, tc = jax_camera(*args), make_camera(*args)
    _close(tcam.intrinsic_matrix(tc), jcam.intrinsic_matrix(jc), atol=0)
    pc = np.concatenate([_rand(rng, 50, 2, scale=0.4),
                         rng.uniform(0.5, 4.0, (50, 1))], -1).astype(np.float32)
    _close(tcam.project_distorted(tc, t(pc)), jcam.project_distorted(jc, pc),
           atol=1e-3)                                  # pixels, float32


@pytest.mark.parametrize("fn", ["inv2x2", "solve4x4", "chol3x3"])
def test_small_linalg(rng, fn):
    n = {"inv2x2": 2, "solve4x4": 4, "chol3x3": 3}[fn]
    G = _rand(rng, 64, n, n)
    A = (G @ np.swapaxes(G, 1, 2) + np.eye(n, dtype=np.float32)).astype(np.float32)
    if fn == "solve4x4":
        b = _rand(rng, 64, 4)
        _close(tla.solve4x4(t(A), t(b)), jla.solve4x4(A, b), atol=1e-4)
        np.testing.assert_allclose(
            np.einsum("bij,bj->bi", A, to_np(tla.solve4x4(t(A), t(b)))), b, atol=1e-3)
    elif fn == "inv2x2":
        _close(tla.inv2x2(t(A)), jla.inv2x2(A))
        Z = np.zeros((1, 2, 2), np.float32)             # singular: finite
        _close(tla.inv2x2(t(Z)), jla.inv2x2(Z))
    else:
        L = tla.chol3x3(t(A))
        _close(L, jla.chol3x3(A))
        _close(L @ L.transpose(1, 2), A, atol=1e-4)


def test_pnp_correspondences(rng):
    """Row i pairs keyframe feature i's landmark with its match's pixel;
    dead, non-finite and far landmarks and unmatched rows are invalid."""
    from visionx_slam_tpu.models.matching import MatchResult as JMatch
    from visionx_slam_tpu.tracking import mapstate as jmsl
    from visionx_slam_tpu.tracking import stages as jstages

    from visionx_slam_torch import convert
    from visionx_slam_torch.tracking import stages as tstages

    K, N, L = 4, 32, 96
    ms = jmsl.empty_map(K, L, N)
    links = rng.integers(-2, L, (K, N)).astype(np.int32)
    pos = _rand(rng, 3, L + N, scale=2.0)
    pos[:, 3], pos[0, 7] = np.nan, 5000.0
    ms = ms._replace(kf_feat_lm=links, lm_pos=pos, lm_alive=rng.random(L + N) < 0.8)
    obs_px = rng.uniform(0, 640, (N, 2)).astype(np.float32)
    idx = rng.integers(0, N, N).astype(np.int32)
    mvalid = rng.random(N) < 0.7
    zeros = np.zeros(N, np.float32)
    jobs = jstages.FrameObs(obs_px, zeros, np.zeros((N, 32), np.uint8), mvalid, zeros)
    pj, xj, vj = jstages.pnp_correspondences(ms, np.int32(2), jobs, JMatch(idx, zeros, mvalid))
    tms = convert.mapstate_from_numpy(ms)
    pt, xt, vt = tstages.pnp_correspondences(
        tms, 2, convert.frameobs_from_numpy(jobs),
        convert.match_from_numpy(JMatch(idx, zeros, mvalid)))
    np.testing.assert_array_equal(to_np(vt), np.asarray(vj))
    assert 0 < int(to_np(vt).sum()) < int(mvalid.sum())
    _close(xt, xj, atol=0)
    np.testing.assert_array_equal(to_np(pt)[to_np(vt)], np.asarray(pj)[np.asarray(vj)])


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


@pytest.mark.parametrize("cols", [(), (12,), (3, 3)])
def test_segment_sum_equals_index_add(rng, cols):
    """Random rows into 500 segments (about a third empty), some rows to
    the spare id 500: with the spare as one more segment the sum equals
    ``index_add_`` into 501 rows bit for bit, without it its first 500;
    integers too; an empty segment sums to 0."""
    import jax

    R, L = 4000, 500
    ids = rng.integers(0, 350, R) * 10 // 7          # gaps: empty segments
    ids[rng.random(R) < 0.2] = L                      # the spare row
    x = _rand(rng, R, *cols, scale=100.0)
    ref = torch.zeros((L + 1, *cols)).index_add_(0, t(ids), t(x))
    assert torch.equal(segment_sum(t(x), segments(t(ids), L + 1)), ref)
    segs = segments(t(ids), L)
    out = segment_sum(t(x), segs)
    assert torch.equal(out, ref[:L])
    assert int((segs.lengths == 0).sum()) > 100
    assert not out[segs.lengths == 0].any()
    jx = jax.ops.segment_sum(x, ids, num_segments=L + 1)[:L]
    np.testing.assert_allclose(to_np(out), np.asarray(jx), rtol=1e-5, atol=1e-3)
    n = t(rng.integers(-3, 4, (R, *cols)).astype(np.int32))
    ref_n = torch.zeros((L, *cols), dtype=torch.int32).index_add_(
        0, t(np.minimum(ids, L - 1)), torch.where(
            t(ids < L).reshape(-1, *[1] * len(cols)), n, 0))
    assert torch.equal(segment_sum(n, segs), ref_n)
