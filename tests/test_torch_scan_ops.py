"""The scan's small ops of the port against the JAX package on numpy inputs
made from a seed: closed-form linear algebra (relative 1e-5 on random SPD
batches), bit-plane knn2 matching (integer-exact), the motion-prior PnP
tier (pose within 1e-4, equal inliers), nullspaces and DLT triangulation
(1e-4 relative) and the init feature-distribution gate (exact)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from visionx_slam_tpu.models import estimation as JE
from visionx_slam_tpu.models import matching as JM
from visionx_slam_tpu.ops import linalg as JL
from visionx_slam_tpu.ops import se3 as jse3
from visionx_slam_tpu.tracking import stages as JS

from visionx_slam_torch.models import estimation as TE
from visionx_slam_torch.models import matching as TM
from visionx_slam_torch.ops import linalg as TL
from visionx_slam_torch.ops import se3 as tse3
from visionx_slam_torch.tracking import stages as TS

from torch_parity import cameras, t, to_np


def _spd(rng, n, d):
    A = rng.standard_normal((n, d, d)).astype(np.float32)
    return (A @ np.swapaxes(A, 1, 2) + 0.5 * np.eye(d, dtype=np.float32)).astype(np.float32)


def _rel(a, b, tol):
    a, b = to_np(a).astype(np.float64), np.asarray(b, np.float64)
    err = np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)
    assert err <= tol, err


@pytest.mark.parametrize("fn, d", [("det3x3", 3), ("solve3x3", 3),
                                   ("chol_solve4x4", 4), ("solve6x6_spd", 6),
                                   ("chol_solve6x6", 6)])
def test_linalg_matches_on_spd_batches(fn, d):
    rng = np.random.default_rng(d)
    A = _spd(rng, 256, d)
    b = rng.standard_normal((256, d)).astype(np.float32)
    if fn == "det3x3":
        _rel(TL.det3x3(t(A)), JL.det3x3(A), 1e-5)
        return
    x_t = getattr(TL, fn)(t(A), t(b))
    x_j = getattr(JL, fn)(A, b)
    for k in range(256):   # per system: relative to its own solution
        _rel(x_t[k], np.asarray(x_j)[k], 1e-5)


@pytest.fixture(scope="module")
def descs():
    """Two descriptor sets that share half their rows (bit-flipped copies),
    with some invalid slots."""
    rng = np.random.default_rng(5)
    a = rng.integers(0, 256, (300, 32), dtype=np.uint8)
    b = rng.integers(0, 256, (280, 32), dtype=np.uint8)
    flip = (rng.random((150, 32, 8)) < 0.05)
    b[:150] = a[:150] ^ np.packbits(flip, axis=-1, bitorder="little")[..., 0]
    va = rng.random(300) > 0.1
    vb = rng.random(280) > 0.1
    return a, va, b, vb


def test_unpack_with_pop_and_knn2_are_integer_exact(descs):
    a, va, b, vb = descs
    bits_a, pop_a = TM.unpack_with_pop(t(a))
    bits_j, pop_j = JM.unpack_with_pop(a)
    np.testing.assert_array_equal(to_np(bits_a.float()), np.asarray(bits_j, np.float32))
    np.testing.assert_array_equal(to_np(pop_a), np.asarray(pop_j))
    bits_b, pop_b = TM.unpack_with_pop(t(b))
    r_t = TM.knn2_from_bits(bits_a, pop_a, t(va), bits_b, pop_b, t(vb))
    r_j = JM.knn2_from_bits(bits_j, pop_j, va, *JM.unpack_with_pop(b), vb)
    r_r = TM.knn2_ratio_match(t(a), t(va), t(b), t(vb))
    r_jr = JM.knn2_ratio_match(a, va, b, vb)
    for mine, ref in [(r_t, r_j), (r_r, r_jr), (r_t, r_jr)]:
        np.testing.assert_array_equal(to_np(mine.valid), np.asarray(ref.valid))
        v = np.asarray(ref.valid)
        np.testing.assert_array_equal(to_np(mine.idx)[v], np.asarray(ref.idx)[v])
        np.testing.assert_array_equal(to_np(mine.dist)[v], np.asarray(ref.dist)[v])
    assert np.asarray(r_j.valid).sum() > 100


def _pnp_problem(seed, n=400, outlier_frac=0.2):
    rng = np.random.default_rng(seed)
    jc, _ = cameras()
    fx, cx, cy = float(jc.fx), float(jc.cx), float(jc.cy)
    pc = np.stack([rng.uniform(-1.5, 1.5, n), rng.uniform(-1, 1, n),
                   rng.uniform(1, 5, n)], -1)
    q = np.asarray(jse3.so3_exp(rng.normal(0, 0.05, 3).astype(np.float32)))
    tt = rng.normal(0, 0.1, 3).astype(np.float32)
    R = np.asarray(jse3.quat_to_matrix(q))
    pw = (pc - tt) @ R
    px = np.stack([fx * pc[:, 0] / pc[:, 2] + cx, fx * pc[:, 1] / pc[:, 2] + cy], -1)
    px = px + rng.normal(0, 0.5, px.shape)
    out = rng.random(n) < outlier_frac
    px[out] = rng.uniform([0, 0], [640, 480], (out.sum(), 2))
    valid = rng.random(n) > 0.05
    # the prior: the true pose, perturbed as a frame-to-frame motion
    q0 = np.asarray(jse3.quat_normalize(q + rng.normal(0, 0.005, 4).astype(np.float32)))
    t0 = (tt + rng.normal(0, 0.02, 3)).astype(np.float32)
    f32 = lambda x: np.asarray(x, np.float32)
    return f32(pw), f32(px), valid, f32(q0), f32(t0), tt


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pnp_prior_matches(seed):
    jc, tc = cameras()
    pw, px, valid, q0, t0, tt = _pnp_problem(seed)
    sj = JE.pnp_prior(jc, pw, px, valid, jse3.Pose(q0, t0), 2.0)
    st = TE.pnp_prior(tc, t(pw), t(px), t(valid), tse3.Pose(t(q0), t(t0)), 2.0)
    np.testing.assert_allclose(to_np(st.pose.q), np.asarray(sj.pose.q), atol=1e-4)
    np.testing.assert_allclose(to_np(st.pose.t), np.asarray(sj.pose.t), atol=1e-4)
    assert int(st.n_inliers) == int(sj.n_inliers)
    np.testing.assert_array_equal(to_np(st.inlier_mask), np.asarray(sj.inlier_mask))
    assert bool(st.ok) == bool(sj.ok)
    assert np.abs(to_np(st.pose.t) - tt).max() < 0.02


@pytest.mark.parametrize("d", [4, 9])
def test_smallest_eigvec_matches(d):
    """d = 4: the closed-form route; d = 9: the eigh route. Compared up to
    the eigenvector's sign."""
    rng = np.random.default_rng(d)
    A = rng.standard_normal((64, d + 3, d)).astype(np.float32)
    A[:, -1] = A[:, :-1].sum(1) * 0.3          # keep a clear smallest mode
    M = (np.swapaxes(A, 1, 2) @ A).astype(np.float32)
    v_t = to_np(TE._smallest_eigvec(t(M)))
    v_j = np.asarray(jax.vmap(JE._smallest_eigvec)(M))
    sign = np.sign((v_t * v_j).sum(-1, keepdims=True))
    np.testing.assert_allclose(v_t * sign, v_j, atol=1e-4)


def test_triangulate_dlt_and_projection_matrix_match():
    jc, tc = cameras()
    rng = np.random.default_rng(9)
    n = 500
    X = rng.uniform([-2, -1.5, 2], [2, 1.5, 6], (n, 3)).astype(np.float32)
    qb = np.asarray(jse3.so3_exp(np.float32([0.01, -0.03, 0.02])))
    tb = np.float32([-0.15, 0.02, 0.01])
    pa = jse3.identity_pose()
    pb = jse3.Pose(jnp.asarray(qb), jnp.asarray(tb))
    P1, P2 = JE.projection_matrix(jc, pa), JE.projection_matrix(jc, pb)
    P1t = TE.projection_matrix(tc, tse3.identity_pose())
    P2t = TE.projection_matrix(tc, tse3.Pose(t(qb), t(tb)))
    np.testing.assert_allclose(to_np(P2t), np.asarray(P2), rtol=1e-6, atol=1e-4)

    def proj(P):
        h = np.concatenate([X, np.ones((n, 1), np.float32)], 1) @ np.asarray(P).T
        return (h[:, :2] / h[:, 2:] + rng.normal(0, 0.3, (n, 2))).astype(np.float32)

    uv1, uv2 = proj(P1), proj(P2)
    Xj = np.asarray(JE.triangulate_dlt(P1, P2, uv1, uv2))
    Xt = to_np(TE.triangulate_dlt(P1t, P2t, t(uv1), t(uv2)))
    err = np.linalg.norm(Xt - Xj, axis=-1) / np.linalg.norm(Xj, axis=-1)
    assert err.max() <= 1e-4, err.max()


def test_feature_distribution_gate_matches():
    rng = np.random.default_rng(4)
    for k in range(20):
        n = 64
        spread = rng.uniform(0.1, 1.0)
        px = (rng.uniform(0, 1, (n, 2)) * spread * [640, 480]).astype(np.float32)
        valid = rng.random(n) > 0.3
        j = bool(JS.feature_distribution_ok(px, valid, 640, 480))
        assert bool(TS.feature_distribution_ok(t(px), t(valid), 640, 480)) == j
