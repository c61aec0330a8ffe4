"""Essential-matrix RANSAC of the port against the JAX package.

Fed the JAX package's own minimal sets, on well-conditioned two-view
geometry (random points 2-6 m away, a 0.3 m baseline, 0.3 px noise, 30%
outliers): 11 of 12 seeds agree to 1e-6 rad; the test holds at least 11 of
12 to rotation <= 1e-3 rad, translation direction <= 1e-2 rad and inlier
masks agreeing on >= 0.99, and every seed to twice that (a seed may take
another LO winner one inlier apart).

On frame pairs of the synthetic sequence (seed 7; consecutive pairs with
1.3-1.4 cm baselines, 4-stride pairs with ~5 cm) that agreement does not
exist even between two runs of the same math: the 8-point normal matrix
A^T A is solved by a float32 ``eigh``, and there its null vector is noise
(median deviation 0.03, 90th percentile 0.5 from the float64 SVD null
vector, for JAX and torch alike), so each hypothesis differs between the two
LAPACK builds and so does the winner. There the test holds the port to the
JAX package's accuracy against the ground truth: median rotation and
translation-direction errors over 16 (pair, key) runs no worse than JAX's
by a stated factor. Measured on the CPU: rotation medians 4.04e-3 rad (JAX)
and 5.21e-3 rad (port), translation-direction medians 0.349 and 0.420 rad,
a ratio of 1.29 and 1.20; the bounds are 1.4x and 1.3x.

The depth scale (1e-4 relative, odd and even inlier counts),
``jnp.nanmedian``'s even-count mean, the Gauss-Newton polish (its Jacobian
in closed form where the JAX package takes ``jax.jacfwd``)
and the sign-gated scoring helpers are held to the JAX functions too.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from visionx_slam_tpu.models import estimation as JE
from visionx_slam_tpu.models import matching as JM
from visionx_slam_tpu.models import orb_jax as OJ
from visionx_slam_tpu.ops import se3 as jse3

from visionx_slam_torch.data import synthetic
from visionx_slam_torch.models import estimation as TE

from torch_parity import cameras, sequence, t, to_np

PAIRS = [(0, 1), (3, 4), (0, 4), (2, 6)]


def _angle(Ra, Rb):
    """Rotation angle between two (float32) rotations, in float64."""
    from scipy.spatial.transform import Rotation

    U, _, Vt = np.linalg.svd(np.asarray(Ra, np.float64).T @ np.asarray(Rb, np.float64))
    return float(np.linalg.norm(Rotation.from_matrix(U @ Vt).as_rotvec()))


def _dir_angle(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    c = a @ b / (np.linalg.norm(a) * np.linalg.norm(b))
    return float(np.arccos(np.clip(c, -1.0, 1.0)))


def _two_view(seed, n=400):
    rng = np.random.default_rng(seed)
    jc, _ = cameras()
    X = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n),
                  rng.uniform(2, 6, n)], -1)
    R = np.asarray(jse3.quat_to_matrix(jse3.so3_exp(
        rng.normal(0, 0.05, 3).astype(np.float32))), np.float64)
    tv = rng.normal(0, 1, 3)
    tv[2] *= 0.3
    tv = tv / np.linalg.norm(tv) * 0.3
    f, cx, cy = float(jc.fx), float(jc.cx), float(jc.cy)

    def px(P):
        return np.stack([f * P[:, 0] / P[:, 2] + cx, f * P[:, 1] / P[:, 2] + cy], -1)

    pa = px(X) + rng.normal(0, 0.3, (n, 2))
    pb = px(X @ R.T + tv) + rng.normal(0, 0.3, (n, 2))
    out = rng.random(n) < 0.3
    pb[out] = rng.uniform([0, 0], [640, 480], (out.sum(), 2))
    return pa.astype(np.float32), pb.astype(np.float32), rng.random(n) > 0.05


def _both(pa, pb, valid, key):
    jc, tc = cameras()
    samples = np.asarray(JE.sample_minimal_sets(key, valid, 256, 8))
    rj = JE.essential_ransac(jc, pa, pb, valid, key)
    rt = TE.essential_ransac(tc, t(pa), t(pb), t(valid), None, sample_idx=t(samples))
    return rj, rt


def test_essential_ransac_matches_with_injected_samples():
    close = 0
    for seed in range(12):
        pa, pb, valid = _two_view(seed)
        rj, rt = _both(pa, pb, valid, jax.random.PRNGKey(seed))
        assert bool(rt.ok) and bool(rj.ok)
        rot = _angle(to_np(rt.R), np.asarray(rj.R))
        tdir = _dir_angle(to_np(rt.t), np.asarray(rj.t))
        agree = (to_np(rt.inlier_mask) == np.asarray(rj.inlier_mask)).mean()
        assert rot <= 2e-3 and tdir <= 2e-2 and agree >= 0.99, (seed, rot, tdir, agree)
        close += rot <= 1e-3 and tdir <= 1e-2
    assert close >= 11, close


@pytest.fixture(scope="module")
def feats():
    grays, depths, _ = sequence(8, 7)
    out = []
    for i in range(8):
        px, _, desc, valid = (np.asarray(a) for a in OJ.orb_extract(grays[i], use_pallas=0))
        d = depths[i][np.clip(np.round(px[:, 1]).astype(int), 0, 479),
                      np.clip(np.round(px[:, 0]).astype(int), 0, 639)]
        out.append((px, desc, valid, np.where(valid, d, 0.0).astype(np.float32)))
    return out


def test_essential_ransac_on_sequence_pairs_is_as_accurate_as_jax(feats):
    err = {"jax": [], "port": []}
    for a, b in PAIRS:
        Ra, ta = synthetic.trajectory_pose(a, 8)
        Rb, tb = synthetic.trajectory_pose(b, 8)
        R_rel, t_rel = Rb.T @ Ra, Rb.T @ (ta - tb)
        (pa, da, va, _), (pb, db, vb, _) = feats[a], feats[b]
        m = JM.match_frames(da, va, db, vb)
        idx, valid = np.asarray(m.idx), np.asarray(m.valid)
        for k in range(4):
            rj, rt = _both(pa, pb[idx], valid, jax.random.PRNGKey(100 + k))
            for name, R, tv in [("jax", np.asarray(rj.R), np.asarray(rj.t)),
                                ("port", to_np(rt.R), to_np(rt.t))]:
                err[name].append((_angle(R, R_rel), _dir_angle(tv, t_rel)))
    med = {k: np.median(np.asarray(v), axis=0) for k, v in err.items()}
    assert med["port"][0] <= 1.4 * med["jax"][0], med
    assert med["port"][1] <= 1.3 * med["jax"][1], med


def test_scale_on_a_sequence_pair_matches(feats):
    """The depth scale of one result, computed by both."""
    jc, tc = cameras()
    (pa, da, va, dep_a), (pb, db, vb, _) = feats[0], feats[4]
    m = JM.match_frames(da, va, db, vb)
    idx, valid = np.asarray(m.idx), np.asarray(m.valid)
    rj = JE.essential_ransac(jc, pa, pb[idx], valid, jax.random.PRNGKey(100))
    rt = TE.EssentialResult(*(t(np.asarray(x)) for x in rj))
    sj = float(JE.essential_scale_from_depth(jc, rj, pa, pb[idx], dep_a))
    st = float(TE.essential_scale_from_depth(tc, rt, t(pa), t(pb[idx]), t(dep_a)))
    assert abs(st - sj) <= 1e-4 * abs(sj), (st, sj)


@pytest.mark.parametrize("n", [1, 2, 7, 10, 11, 64])
def test_nanmedian_matches_jnp_including_even_counts(n):
    rng = np.random.default_rng(n)
    x = rng.standard_normal(80).astype(np.float32)
    x[n:] = np.nan
    rng.shuffle(x)
    np.testing.assert_allclose(float(TE.nanmedian(t(x))), float(jnp.nanmedian(x)),
                               rtol=1e-7)
    assert np.isnan(float(TE.nanmedian(t(np.full(5, np.nan, np.float32)))))


@pytest.mark.parametrize("n_good", [10, 11, 40])
def test_scale_from_depth_matches(n_good):
    """A known relative pose, exact correspondences, measured depth at
    the true baseline 0.4 (unit-norm t: scale 0.4) with noise; ``n_good`` inliers (odd and even counts)."""
    jc, tc = cameras()
    rng = np.random.default_rng(n_good)
    n = 60
    pc = np.stack([rng.uniform(-1, 1, n), rng.uniform(-0.7, 0.7, n),
                   rng.uniform(1.5, 4, n)], -1)
    R = np.asarray(jse3.quat_to_matrix(jse3.so3_exp(np.float32([0.01, 0.02, -0.01]))))
    tdir = np.float32([0.6, -0.1, 0.1])
    tdir /= np.linalg.norm(tdir)
    pc2 = pc @ R.T + tdir * 0.4
    f, cx, cy = float(jc.fx), float(jc.cx), float(jc.cy)
    pxa = np.stack([f * pc[:, 0] / pc[:, 2] + cx, f * pc[:, 1] / pc[:, 2] + cy], -1)
    pxb = np.stack([f * pc2[:, 0] / pc2[:, 2] + cx, f * pc2[:, 1] / pc2[:, 2] + cy], -1)
    depth = (pc[:, 2] * (1 + rng.normal(0, 0.01, n))).astype(np.float32)
    mask = np.zeros(n, bool)
    mask[:n_good] = True
    f32 = lambda a: np.asarray(a, np.float32)
    rj = JE.EssentialResult(f32(R), f32(tdir), np.zeros((3, 3), np.float32),
                            mask, np.int32(n_good), True)
    rt = TE.EssentialResult(t(f32(R)), t(f32(tdir)), torch.zeros(3, 3), t(mask),
                            torch.tensor(n_good), torch.tensor(True))
    sj = float(JE.essential_scale_from_depth(jc, rj, f32(pxa), f32(pxb), depth))
    st = float(TE.essential_scale_from_depth(tc, rt, t(f32(pxa)), t(f32(pxb)), t(depth)))
    assert abs(sj - 0.4) < 0.02   # the measured scale, not the fallback
    assert abs(st - sj) <= 1e-4 * sj, (st, sj)


@pytest.mark.parametrize("seed", [0, 1])
def test_refine_essential_pose_matches(seed):
    """The Gauss-Newton polish from a perturbed start."""
    jc, tc = cameras()
    pa, pb, valid = _two_view(seed)
    r = JE.essential_ransac(jc, pa, pb, valid, jax.random.PRNGKey(seed))
    R0 = np.asarray(jse3.quat_to_matrix(jse3.so3_exp(np.float32([0.002, -0.001, 0.003])))
                    ) @ np.asarray(r.R)
    t0 = np.asarray(r.t) + np.float32([0.05, -0.03, 0.02])
    t0 = (t0 / np.linalg.norm(t0)).astype(np.float32)
    x1, x2 = JE._normalize_px(jc, pa), JE._normalize_px(jc, pb)
    h1 = np.concatenate([x1, np.ones_like(x1[:, :1])], -1).astype(np.float32)
    h2 = np.concatenate([x2, np.ones_like(x2[:, :1])], -1).astype(np.float32)
    w = np.asarray(r.inlier_mask, np.float32)
    Rj, tj = JE._refine_essential_pose(R0.astype(np.float32), t0, h1, h2, w, iters=5)
    Rt, tt = TE._refine_essential_pose(t(R0.astype(np.float32)), t(t0), t(h1), t(h2),
                                       t(w), iters=5)
    np.testing.assert_allclose(to_np(Rt), np.asarray(Rj), atol=1e-4)
    np.testing.assert_allclose(to_np(tt), np.asarray(tj), atol=1e-4)


def test_scoring_helpers_match():
    rng = np.random.default_rng(2)
    h1 = np.concatenate([rng.normal(0, 0.3, (50, 2)), np.ones((50, 1))], 1).astype(np.float32)
    h2 = (h1 + rng.normal(0, 0.01, h1.shape) * [1, 1, 0]).astype(np.float32)
    E = rng.standard_normal((4, 3, 3)).astype(np.float32)
    d_t = to_np(TE._sampson_sq(t(E), t(h1), t(h2)))
    d_j = np.asarray(jax.vmap(lambda e: JE._sampson_sq(e, h1, h2))(E))
    np.testing.assert_allclose(d_t, d_j, rtol=1e-4, atol=1e-7)
    R = np.asarray(jse3.quat_to_matrix(jse3.so3_exp(np.float32([0.1, -0.2, 0.05]))))
    tv = np.float32([0.3, 0.1, -0.9])
    z_t = TE._two_ray_depths(t(R), t(tv), t(h1), t(h2))
    z_j = JE._two_ray_depths(R, tv, h1, h2)
    for a, b in zip(z_t, z_j):
        np.testing.assert_allclose(to_np(a), np.asarray(b), rtol=1e-3, atol=1e-4)
