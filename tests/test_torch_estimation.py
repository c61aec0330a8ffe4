"""PnP RANSAC of the port against the JAX package. ``_kabsch3`` and
``_pose_gn_refine`` agree to atol 1e-4; ``pnp_ransac``, fed the JAX
package's own minimal sets for the same key, lands within 1e-3 rad and
1e-3 m of the JAX pose with an inlier count within 1%, with depth (3-point
Procrustes) and without (6-point DLT, ``_dlt_pnp``: 1e-4 against JAX on
exact and noisy samples).

The monocular estimators: ``essential_ransac`` batched over problems with
the PROSAC bias and two-tier scoring, fed the JAX package's minimal sets,
held per problem to the JAX call as ``tests/test_torch_essential.py``
holds the single-problem one (by count: at least 11 of 12 problems within
1e-3 rad and 1e-2 rad of translation direction with inlier masks agreeing
on >= 0.99, every one within twice that: one problem's masks differ on 5
of 400 points at the gate); ``nanmedian`` along a dimension
(even counts, all-NaN rows) equals ``jnp.nanmedian``; the sampler's bias
and caller-drawn uniforms.
"""

import numpy as np
import pytest
import torch

import jax

from visionx_slam_tpu.models import estimation as JE
from visionx_slam_tpu.ops import se3 as jse3

from visionx_slam_torch.models import estimation as TE
from visionx_slam_torch.ops import se3 as tse3

from torch_parity import cameras, t, to_np


def _problem(seed, n=240, outlier_frac=0.3, noise_px=0.5):
    """World points, a true T_cw, observed pixels (noise + outliers), and
    current-frame depth (noisy)."""
    rng = np.random.default_rng(seed)
    jc, _ = cameras()
    fx, cx, cy = float(jc.fx), float(jc.cx), float(jc.cy)
    pc = np.stack([rng.uniform(-1.5, 1.5, n), rng.uniform(-1.0, 1.0, n),
                   rng.uniform(1.0, 5.0, n)], -1)
    w = rng.normal(0, 0.1, 3)
    q = np.asarray(jse3.so3_exp(w.astype(np.float32)))
    tt = rng.normal(0, 0.2, 3).astype(np.float32)
    R = np.asarray(jse3.quat_to_matrix(q))
    pw = (pc - tt) @ R                       # R^T (pc - t)
    px = np.stack([fx * pc[:, 0] / pc[:, 2] + cx, fx * pc[:, 1] / pc[:, 2] + cy], -1)
    px = px + rng.normal(0, noise_px, px.shape)
    out = rng.random(n) < outlier_frac
    px[out] = rng.uniform([0, 0], [640, 480], (out.sum(), 2))
    depth = pc[:, 2] * (1 + rng.normal(0, 0.005, n))
    valid = rng.random(n) > 0.05
    f32 = lambda a: np.asarray(a, np.float32)
    return f32(pw), f32(px), valid, f32(depth), f32(q), f32(tt)


def test_kabsch3_matches():
    rng = np.random.default_rng(2)
    P = rng.normal(size=(50, 3, 3)).astype(np.float32)
    Q = rng.normal(size=(50, 3, 3)).astype(np.float32)
    Rt, tt = TE._kabsch3(t(P), t(Q))
    Rj, tj = jax.vmap(JE._kabsch3)(P, Q)
    np.testing.assert_allclose(to_np(Rt), np.asarray(Rj), atol=1e-4)
    np.testing.assert_allclose(to_np(tt), np.asarray(tj), atol=1e-4)


@pytest.mark.parametrize("robust", [False, True])
def test_pose_gn_refine_matches(robust):
    jc, tc = cameras()
    pw, px, valid, _, q, tt = _problem(3, outlier_frac=0.1 if robust else 0.0)
    rng = np.random.default_rng(4)
    q0 = np.asarray(jse3.quat_normalize(q + rng.normal(0, 0.01, 4).astype(np.float32)))
    t0 = (tt + rng.normal(0, 0.02, 3)).astype(np.float32)
    w = valid.astype(np.float32)
    kw = dict(iters=4, robust=robust, huber_delta=4.0, gate_px=20.0)
    pj = JE._pose_gn_refine(jc, jse3.Pose(q0, t0), pw, px, w, **kw)
    pt = TE._pose_gn_refine(tc, tse3.Pose(t(q0), t(t0)), t(pw), t(px), t(w), **kw)
    np.testing.assert_allclose(to_np(pt.q), np.asarray(pj.q), atol=1e-4)
    np.testing.assert_allclose(to_np(pt.t), np.asarray(pj.t), atol=1e-4)


@pytest.mark.parametrize("seed, n_hyp, prior", [(7, 16, True), (8, 16, False),
                                                (9, 8, True)])
def test_pnp_ransac_matches_with_injected_samples(seed, n_hyp, prior):
    jc, tc = cameras()
    problems = [_problem(seed + 100 * k) for k in range(3)]
    pw, px, valid, depth, q, tt = (np.stack(a) for a in zip(*problems))
    keys = [jax.random.PRNGKey(seed + k) for k in range(3)]
    idx, pj = [], []
    for k in range(3):
        good = (depth[k] > 0.1) & (depth[k] < 10.0) & valid[k]
        idx.append(np.asarray(JE.sample_minimal_sets(keys[k], good, n_hyp, 3)))
        init = jse3.identity_pose() if prior else None
        pj.append(JE.pnp_ransac(jc, pw[k], px[k], valid[k], keys[k], 2.0,
                                n_hypotheses=n_hyp, refine_iters=4,
                                init_pose=init, depth_curr=depth[k]))
    init_t = tse3.identity_pose((3,)) if prior else None
    sol = TE.pnp_ransac(tc, t(pw), t(px), t(valid), None, 2.0,
                        n_hypotheses=n_hyp, refine_iters=4, init_pose=init_t,
                        depth_curr=t(depth), sample_idx=t(np.stack(idx)))
    for k in range(3):
        Rt = to_np(tse3.quat_to_matrix(sol.pose.q[k]))
        Rj = np.asarray(jse3.quat_to_matrix(pj[k].pose.q))
        ang = np.arccos(np.clip((np.trace(Rt.T @ Rj) - 1) / 2, -1, 1))
        assert ang < 1e-3, ang
        assert np.abs(to_np(sol.pose.t[k]) - np.asarray(pj[k].pose.t)).max() < 1e-3
        n_t, n_j = int(sol.n_inliers[k]), int(pj[k].n_inliers)
        assert abs(n_t - n_j) <= max(1, 0.01 * n_j), (n_t, n_j)
        assert bool(sol.ok[k]) == bool(pj[k].ok)
        # and it found the true pose
        assert np.abs(to_np(sol.pose.t[k]) - tt[k]).max() < 0.05


def test_sampling_draws_distinct_valid_indices():
    valid = torch.rand(4, 200, generator=torch.Generator().manual_seed(0)) > 0.5
    gen = torch.Generator().manual_seed(1)
    idx = TE.sample_minimal_sets(gen, valid, 64, 3)
    assert idx.shape == (4, 64, 3)
    assert torch.gather(valid[:, None].expand(-1, 64, -1), 2, idx).all()
    s = idx.sort(-1).values
    assert (s[..., 1:] != s[..., :-1]).all()


def _mono_problem(seed, n=240, outlier_frac=0.3, noise_px=0.5):
    pw, px, valid, _, q, tt = _problem(seed, n, outlier_frac, noise_px)
    return pw, px, valid, q, tt


@pytest.mark.parametrize("noise_px", [0.0, 0.5])
def test_dlt_pnp_matches(noise_px):
    """40 random 6-point samples. The 12x12 normal matrix squares the
    conditioning, so a float32 null vector is accurate only on
    well-spread samples, in both packages alike (measured on exact
    samples: median rotation error 6.9e-6 JAX, 6.1e-6 port, worst 0.036
    and 0.038; float64 1.4e-5 worst): the two agree within 1e-3 in
    rotation and 1e-2 m in translation on at least 36 of 40 samples, and
    the port's median error against the truth is within 1.5x JAX's (exact)
    or 10% (0.5 px noise)."""
    jc, tc = cameras()
    rng = np.random.default_rng(5)
    Xs, xs, Rs = [], [], []
    for k in range(40):
        pw, px, _, q, _ = _mono_problem(50 + k, outlier_frac=0.0, noise_px=noise_px)
        sel = rng.choice(len(pw), 6, replace=False)
        Xs.append(pw[sel])
        xs.append(np.asarray(JE._normalize_px(jc, px[sel])))
        Rs.append(np.asarray(jse3.quat_to_matrix(q)))
    X, x, R_true = np.stack(Xs), np.stack(xs).astype(np.float32), np.stack(Rs)
    Rj, tj = (np.asarray(a) for a in jax.vmap(JE._dlt_pnp)(X, x))
    Rt, tt = (to_np(a) for a in TE._dlt_pnp(t(X), t(x)))
    d_rot = np.abs(Rt - Rj).max((1, 2))
    d_t = np.abs(tt - tj).max(1)
    assert (d_rot <= 1e-3).sum() >= 36, np.sort(d_rot)
    assert (d_t <= 1e-2).sum() >= 36, np.sort(d_t)
    err_j = np.median(np.abs(Rj - R_true).max((1, 2)))
    err_t = np.median(np.abs(Rt - R_true).max((1, 2)))
    assert err_t <= (1.5 if noise_px == 0.0 else 1.1) * err_j, (err_t, err_j)


@pytest.mark.parametrize("seed, n_hyp, prior", [(17, 16, True), (18, 16, False)])
def test_pnp_ransac_without_depth_matches_with_injected_samples(seed, n_hyp, prior):
    jc, tc = cameras()
    problems = [_mono_problem(seed + 100 * k) for k in range(3)]
    pw, px, valid, q, tt = (np.stack(a) for a in zip(*problems))
    idx, pj = [], []
    for k in range(3):
        key = jax.random.PRNGKey(seed + k)
        idx.append(np.asarray(JE.sample_minimal_sets(key, valid[k], n_hyp, 6)))
        init = jse3.identity_pose() if prior else None
        pj.append(JE.pnp_ransac(jc, pw[k], px[k], valid[k], key, 2.0,
                                n_hypotheses=n_hyp, refine_iters=4,
                                init_pose=init))
    init_t = tse3.identity_pose((3,)) if prior else None
    sol = TE.pnp_ransac(tc, t(pw), t(px), t(valid), None, 2.0,
                        n_hypotheses=n_hyp, refine_iters=4, init_pose=init_t,
                        sample_idx=t(np.stack(idx)))
    for k in range(3):
        Rt = to_np(tse3.quat_to_matrix(sol.pose.q[k]))
        Rj = np.asarray(jse3.quat_to_matrix(pj[k].pose.q))
        ang = np.arccos(np.clip((np.trace(Rt.T @ Rj) - 1) / 2, -1, 1))
        assert ang < 1e-3, ang
        assert np.abs(to_np(sol.pose.t[k]) - np.asarray(pj[k].pose.t)).max() < 1e-3
        n_t, n_j = int(sol.n_inliers[k]), int(pj[k].n_inliers)
        assert abs(n_t - n_j) <= max(1, 0.01 * n_j), (n_t, n_j)
        assert bool(sol.ok[k]) == bool(pj[k].ok)
        assert np.abs(to_np(sol.pose.t[k]) - tt[k]).max() < 0.05


def test_batched_essential_two_tier_prosac_matches_jax():
    from test_torch_essential import _angle, _dir_angle, _two_view

    jc, tc = cameras()
    # 16 LO starts: with 2, three problems take another LO winner one or
    # two inliers apart (the bias and two-tier selection agree regardless)
    H, top_k, starts = 64, 32, 16
    pa, pb, valid, logw, idx, rj = [], [], [], [], [], []
    for seed in range(12):
        a, b, v = _two_view(seed)
        w = -np.random.default_rng(seed).uniform(0, 64, len(v)).astype(np.float32) / 64.0
        key = jax.random.PRNGKey(seed)
        idx.append(np.asarray(JE.sample_minimal_sets(key, v, H, 8, log_weights=w)))
        rj.append(JE.essential_ransac(jc, a, b, v, key, n_hypotheses=H,
                                      lo_starts=starts, score_top_k=top_k,
                                      sample_logw=w))
        pa.append(a), pb.append(b), valid.append(v), logw.append(w)
    rt = TE.essential_ransac(tc, t(np.stack(pa)), t(np.stack(pb)),
                             t(np.stack(valid)), None, n_hypotheses=H,
                             lo_starts=starts, score_top_k=top_k,
                             sample_logw=t(np.stack(logw)),
                             sample_idx=t(np.stack(idx)))
    assert rt.R.shape == (12, 3, 3) and rt.inlier_mask.shape == (12, 240 + 160)
    close = 0
    for k in range(12):
        assert bool(rt.ok[k]) and bool(rj[k].ok)
        rot = _angle(to_np(rt.R[k]), np.asarray(rj[k].R))
        tdir = _dir_angle(to_np(rt.t[k]), np.asarray(rj[k].t))
        agree = (to_np(rt.inlier_mask[k]) == np.asarray(rj[k].inlier_mask)).mean()
        assert rot <= 2e-3 and tdir <= 2e-2 and agree >= 0.98, (k, rot, tdir, agree)
        close += rot <= 1e-3 and tdir <= 1e-2 and agree >= 0.99
    assert close >= 11, close


def test_nanmedian_along_a_dimension_matches_jnp():
    import jax.numpy as jnp

    rng = np.random.default_rng(3)
    x = rng.standard_normal((9, 40)).astype(np.float32)
    for r, n in enumerate([0, 1, 2, 5, 8, 11, 20, 39, 40]):
        x[r, rng.permutation(40)[n:]] = np.nan
    want = np.asarray(jnp.nanmedian(x, axis=1))
    got = to_np(TE.nanmedian(t(x), dim=1))
    np.testing.assert_allclose(got, want, rtol=1e-7, equal_nan=True)
    assert np.isnan(got[0])
    np.testing.assert_allclose(to_np(TE.nanmedian(t(x.T), dim=0)), want,
                               rtol=1e-7, equal_nan=True)


def test_sampling_bias_and_caller_uniforms():
    valid = torch.ones(2, 300, dtype=torch.bool)
    # the caller's uniforms reproduce the generator's own draw
    u = torch.rand(2, 32, 300, generator=torch.Generator().manual_seed(4))
    a = TE.sample_minimal_sets(torch.Generator().manual_seed(4), valid, 32, 8)
    b = TE.sample_minimal_sets(None, valid, 32, 8, noise=u)
    assert torch.equal(a, b)
    # a strong bias draws from the favoured tenth almost only
    logw = torch.where(torch.arange(300) < 30, 0.0, -8.0).expand(2, 300)
    idx = TE.sample_minimal_sets(None, valid, 32, 8, log_weights=logw, noise=u)
    assert (idx < 30).float().mean() > 0.9


def test_sampson_jacobian_equals_forward_mode():
    """The polish's closed-form Jacobian against ``torch.func.jacfwd`` of
    the residual as the JAX package writes it, batched over problems."""
    from torch.func import jacfwd

    gen = torch.Generator().manual_seed(0)
    P, N = 3, 60
    R = tse3.quat_to_matrix(tse3.so3_exp(0.3 * torch.randn(P, 3, generator=gen)))
    tv = TE._unit(torch.randn(P, 3, generator=gen), 1e-12)
    h1 = torch.cat([0.3 * torch.randn(P, N, 2, generator=gen), torch.ones(P, N, 1)], -1)
    h2 = h1 + 0.01 * torch.randn(P, N, 3, generator=gen) * torch.tensor([1.0, 1.0, 0.0])
    for k in range(P):
        a = torch.tensor([1.0, 0.0, 0.0])
        b1 = TE._unit(torch.linalg.cross(tv[k], a), 1e-12)
        b2 = torch.linalg.cross(tv[k], b1)

        def res(p, k=k, b1=b1, b2=b2):
            E = (tse3.so3_hat(TE._unit(tv[k] + p[3] * b1 + p[4] * b2, 1e-12))
                 @ tse3.quat_to_matrix(tse3.so3_exp(p[:3])) @ R[k])
            Ex1, Etx2 = h1[k] @ E.T, h2[k] @ E
            den = Ex1[:, 0] ** 2 + Ex1[:, 1] ** 2 + Etx2[:, 0] ** 2 + Etx2[:, 1] ** 2
            return (h2[k] * Ex1).sum(-1) / torch.sqrt(torch.clamp(den, min=1e-18))

        p0 = torch.zeros(5)
        r, J = TE._sampson_and_jacobian(R[k], tv[k], b1, b2, h1[k], h2[k])
        torch.testing.assert_close(r, res(p0), atol=1e-6, rtol=1e-5)
        torch.testing.assert_close(J, jacfwd(res)(p0), atol=1e-5, rtol=1e-4)
