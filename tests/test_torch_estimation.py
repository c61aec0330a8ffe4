"""RGB-D PnP RANSAC of the port against the JAX package. ``_kabsch3`` and
``_pose_gn_refine`` agree to atol 1e-4; ``pnp_ransac``, fed the JAX
package's own minimal sets for the same key, lands within 1e-3 rad and
1e-3 m of the JAX pose with an inlier count within 1%."""

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
