"""The port's pairwise Schur solver ``pair_ba`` against the JAX package's, on
the map of tests/test_pair_ba.py (8 keyframes of 128 features viewing one
cloud, identical descriptors per point so consecutive keyframes link, poses
and landmarks perturbed after the build), built by the JAX package's
``build_keyframe_map`` and carried across with ``convert.py``. On that map
("dense") every feature has depth, creates its own landmark and adopts
none, so no landmark is optimized; the second map ("holes") drops the depth
of every other feature, alternating between keyframes, so that half the
features adopt the previous keyframe's landmark and the landmark system,
the link gathers and the back-substitution all do work.

Tolerances: the link gathers ``_push_to_creator`` / ``_pull_from_creator``
are exact; ``_sym3_inv`` / ``_sym3_apply`` 1e-6 relative; after 4
Gauss-Newton iterations of 20 CG steps the keyframe poses agree with JAX's
within 1e-4 and the landmarks within 1e-4 of their magnitude (the per-keyframe
sums over features add in another order); against the port's ``global_ba``
the test of the JAX pair holds (poses 2e-3, landmarks 5e-3, both lower the
reprojection error below 0.7 of the start); the gauge keyframe stays within
1e-7; an empty map is left as it is; two runs give equal bits (no atomics).
A landmark flung out of float32's range (what a weakly conditioned two-view
landmark can become after a step) is gated out of both solvers' cost: the
reported ``final_cost`` stays finite.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from visionx_slam_tpu.models import global_ba as JG
from visionx_slam_tpu.models import pair_ba as JP
from visionx_slam_tpu.ops.camera import make_camera as jax_camera
from visionx_slam_tpu.ops.se3 import Pose as JPose, se3_apply as jse3_apply
from visionx_slam_tpu.tracking import mapstate as jmsl
from visionx_slam_tpu.tracking.offline_pipeline import build_keyframe_map as jbuild
from visionx_slam_tpu.utils.config import TrackingOptions as JOpts

from visionx_slam_torch import convert
from visionx_slam_torch.models import global_ba as TG
from visionx_slam_torch.models import pair_ba as TP
from visionx_slam_torch.ops.camera import make_camera
from visionx_slam_torch.tracking import mapstate as tmsl
from visionx_slam_torch.tracking import offline_pipeline as TOP
from visionx_slam_torch.utils.config import TrackingOptions

from torch_parity import t, to_np

JCAM = jax_camera(320.0, 320.0, 160.0, 120.0)
TCAM = make_camera(320.0, 320.0, 160.0, 120.0)
K, N = 8, 128


def _kf_arrays(rng, holes=False):
    """The keyframe observations of tests/test_pair_ba.py::_make_map;
    ``holes``: feature n of keyframe k has depth only when n + k is even."""
    pts = rng.uniform([-2, -1.5, 2.0], [2, 1.5, 5.0], (N, 3)).astype(np.float32)
    kf_t, kf_px, kf_depth, kf_valid = [], [], [], []
    for k in range(K):
        tk = np.array([0.1 * k, 0.02 * k, -0.05 * k], np.float32)
        pc = np.asarray(jse3_apply(JPose(jnp.array([1.0, 0, 0, 0]), jnp.asarray(tk)),
                                   jnp.asarray(pts)))
        u = 320.0 * pc[:, 0] / pc[:, 2] + 160.0
        v = 320.0 * pc[:, 1] / pc[:, 2] + 120.0
        kf_t.append(tk)
        kf_px.append(np.stack([u, v], -1))
        kf_depth.append(pc[:, 2])
        kf_valid.append((pc[:, 2] > 0.3) & (u > 5) & (u < 315) & (v > 5) & (v < 235))
    desc = rng.integers(0, 256, (N, 32)).astype(np.uint8)
    kf_q = np.zeros((K, 4), np.float32)
    kf_q[:, 0] = 1.0
    kf_depth = np.stack(kf_depth).astype(np.float32)
    if holes:
        kf_depth[(np.arange(N)[None, :] + np.arange(K)[:, None]) % 2 == 1] = 0.0
    return dict(kf_q=kf_q, kf_t=np.array(kf_t, np.float32),
                kf_id=np.arange(K, dtype=np.int32),
                kf_px=np.stack(kf_px).astype(np.float32),
                kf_desc=np.broadcast_to(desc, (K, N, 32)).copy(),
                kf_fvalid=np.stack(kf_valid),
                kf_depth=kf_depth)


@pytest.fixture(scope="module", params=["dense", "holes"])
def maps(request):
    """(JAX map, JAX links, port map, port links): the map built by the JAX
    package, perturbed with numpy noise, and carried across."""
    rng = np.random.default_rng(7)
    a = _kf_arrays(rng, request.param == "holes")
    ms, links = jbuild(JCAM, JOpts(), *(jnp.asarray(a[k]) for k in (
        "kf_q", "kf_t", "kf_id", "kf_px", "kf_desc", "kf_fvalid", "kf_depth")),
        lm_capacity=K * N)
    n_adopt = int((np.asarray(links.adopter) >= 0).sum())
    assert n_adopt > 200 if request.param == "holes" else n_adopt == 0
    noise = 0.01
    ms = ms._replace(
        kf_t=ms.kf_t.at[1:].add(jnp.asarray(
            rng.normal(0, noise, (K - 1, 3)).astype(np.float32))),
        lm_pos=ms.lm_pos + jnp.asarray(
            rng.normal(0, 0.3 * noise, ms.lm_pos.shape).astype(np.float32)))
    return ms, links, convert.mapstate_from_numpy(ms), convert.pairlinks_from_numpy(links)


@pytest.mark.parametrize("holes", [False, True])
def test_port_map_build_gives_the_same_links(holes):
    """``models/pair_ba.py`` re-exports the map's ``PairLinks``, and the
    port's ``build_keyframe_map`` returns the tables the JAX package's returns."""
    assert TP.PairLinks is tmsl.PairLinks
    a = _kf_arrays(np.random.default_rng(7), holes)
    _, jl = jbuild(JCAM, JOpts(), *(jnp.asarray(a[k]) for k in (
        "kf_q", "kf_t", "kf_id", "kf_px", "kf_desc", "kf_fvalid", "kf_depth")),
        lm_capacity=K * N)
    _, tl = TOP.build_keyframe_map(
        TCAM, TrackingOptions(), t(a["kf_q"]), t(a["kf_t"]), t(a["kf_id"]),
        t(a["kf_px"]), t(a["kf_desc"]), t(a["kf_fvalid"]), t(a["kf_depth"]), K * N)
    for f in TP.PairLinks._fields:
        np.testing.assert_array_equal(to_np(getattr(tl, f)),
                                      np.asarray(getattr(jl, f)), err_msg=f)


@pytest.mark.parametrize("lead", [(), (3,), (2, 3)])
def test_push_and_pull_exact(maps, lead):
    _, jl, _, tl = maps
    x = np.random.default_rng(3).normal(size=lead + (K, N)).astype(np.float32)
    np.testing.assert_array_equal(
        to_np(TP._push_to_creator(t(x), tl.adopter)),
        np.asarray(JP._push_to_creator(jnp.asarray(x), jl.adopter)))
    np.testing.assert_array_equal(
        to_np(TP._pull_from_creator(t(x), tl.creator)),
        np.asarray(JP._pull_from_creator(jnp.asarray(x), jl.creator)))


def test_sym3_inverse_and_apply():
    rng = np.random.default_rng(5)
    B = rng.normal(size=(50, 3, 3)).astype(np.float32)
    A = B @ B.transpose(0, 2, 1) + 0.1 * np.eye(3, dtype=np.float32)
    A[0] = 0.0                                   # singular: the inverse is 0
    comps = np.stack([A[:, i, j] for i, j in zip(TP._SYM_I, TP._SYM_J)])
    v = rng.normal(size=(3, 50)).astype(np.float32)
    inv_t = TP._sym3_inv(t(comps), 0.0)
    inv_j = JP._sym3_inv(tuple(jnp.asarray(c) for c in comps), 0.0)
    np.testing.assert_allclose(to_np(inv_t), np.stack([np.asarray(c) for c in inv_j]),
                               rtol=1e-6, atol=1e-7)
    assert not to_np(inv_t)[:, 0].any()
    app_j = JP._sym3_apply(inv_j, tuple(jnp.asarray(c) for c in v))
    np.testing.assert_allclose(to_np(TP._sym3_apply(inv_t, t(v))),
                               np.stack([np.asarray(c) for c in app_j]),
                               rtol=1e-5, atol=1e-6)


def test_pair_ba_matches_jax(maps):
    jms, jl, tms, tl = maps
    j2, jstats = JP.pair_ba(jms, JCAM, jl, JG.GlobalBAOptions(
        max_iterations=4, cg_iterations=20))
    t2, tstats = TP.pair_ba(tms, TCAM, tl, TG.GlobalBAOptions(
        max_iterations=4, cg_iterations=20))
    assert int(tstats.iterations) == int(jstats.iterations)
    assert int(tstats.total_obs) == int(jstats.total_obs)
    np.testing.assert_allclose(float(tstats.final_cost), float(jstats.final_cost),
                               rtol=1e-3)
    np.testing.assert_allclose(to_np(t2.kf_t), np.asarray(j2.kf_t), atol=1e-4)
    np.testing.assert_allclose(to_np(t2.kf_q), np.asarray(j2.kf_q), atol=1e-4)
    alive = np.asarray(jms.lm_alive)
    np.testing.assert_allclose(to_np(t2.lm_pos)[:, alive],
                               np.asarray(j2.lm_pos)[:, alive], rtol=1e-4, atol=1e-4)
    # the solve moved the map, and only its poses and landmark positions
    assert np.abs(to_np(t2.kf_t) - to_np(tms.kf_t)).max() > 1e-3
    for f in ("kf_feat_lm", "lm_alive", "lm_obs", "kf_id"):
        assert torch.equal(getattr(t2, f), getattr(tms, f)), f


def test_pair_ba_matches_global_ba(maps):
    _, _, tms, tl = maps
    opts = TG.GlobalBAOptions(max_iterations=4, cg_iterations=20)
    err0, _ = TG.map_reproj_error(tms, TCAM)
    g2, _ = TG.global_ba(tms, TCAM, opts)
    p2, _ = TP.pair_ba(tms, TCAM, tl, opts)
    errg, _ = TG.map_reproj_error(g2, TCAM)
    errp, _ = TG.map_reproj_error(p2, TCAM)
    assert float(errg) < 0.7 * float(err0) and float(errp) < 0.7 * float(err0)
    np.testing.assert_allclose(to_np(p2.kf_t), to_np(g2.kf_t), atol=2e-3)
    np.testing.assert_allclose(to_np(p2.kf_q), to_np(g2.kf_q), atol=2e-3)
    alive = to_np(tms.lm_alive)
    np.testing.assert_allclose(to_np(p2.lm_pos)[:, alive],
                               to_np(g2.lm_pos)[:, alive], atol=5e-3)


def test_pair_ba_gauge_fixed_and_repeats(maps):
    _, _, tms, tl = maps
    opts = TG.GlobalBAOptions(max_iterations=3, cg_iterations=15)
    before = {f: getattr(tms, f).clone() for f in ("kf_q", "kf_t", "lm_pos")}
    p2, _ = TP.pair_ba(tms, TCAM, tl, opts)
    np.testing.assert_allclose(to_np(p2.kf_t[0]), to_np(tms.kf_t[0]), atol=1e-7)
    np.testing.assert_allclose(to_np(p2.kf_q[0]), to_np(tms.kf_q[0]), atol=1e-7)
    for f, x in before.items():                  # the input map is untouched
        assert torch.equal(getattr(tms, f), x), f
    p3, _ = TP.pair_ba(tms, TCAM, tl, opts)      # gathers only: equal bits
    for f in ("kf_q", "kf_t", "lm_pos"):
        assert torch.equal(getattr(p2, f), getattr(p3, f)), f


def test_pair_ba_noop_on_empty():
    ms = tmsl.empty_map(kf_capacity=K, n_features=N, lm_capacity=K * N)
    links = TP.PairLinks(
        created=torch.zeros((K, N), dtype=torch.bool),
        adopter=torch.full((K, N), -1, dtype=torch.int32),
        creator=torch.full((K, N), -1, dtype=torch.int32),
        order=torch.arange(K * N), sidx=torch.full((K * N,), K * N + N))
    ms2, stats = TP.pair_ba(ms, TCAM, links, TG.GlobalBAOptions(max_iterations=2))
    assert int(stats.iterations) == 0
    assert torch.equal(ms2.kf_t, ms.kf_t) and torch.equal(ms2.lm_pos, ms.lm_pos)
    jms = jmsl.empty_map(kf_capacity=K, n_features=N, lm_capacity=K * N)
    assert to_np(ms2.lm_pos).shape == np.asarray(jms.lm_pos).shape


@pytest.mark.parametrize("solver", ["pair_ba", "global_ba"])
def test_final_cost_finite_with_a_flung_landmark(maps, solver):
    """One observed landmark at 3e38: its projection is NaN, it is no
    observation, and the masked cost sum must not turn 0 x NaN into NaN."""
    _, _, tms, tl = maps
    seen = torch.bincount(tms.kf_feat_lm[tms.kf_feat_lm >= 0].long(),
                          minlength=tms.lm_physical)
    lm = int(torch.argmax(seen))
    assert int(seen[lm]) >= 1 and bool(tms.lm_alive[lm])
    pos = tms.lm_pos.clone()
    pos[:, lm] = 3e38
    ms = tms._replace(lm_pos=pos)
    opts = TG.GlobalBAOptions(max_iterations=2, cg_iterations=8)
    if solver == "pair_ba":
        _, stats = TP.pair_ba(ms, TCAM, tl, opts)
    else:
        _, stats = TG.global_ba(ms, TCAM, opts)
    assert int(stats.total_obs) > 0
    assert bool(torch.isfinite(stats.final_cost)), float(stats.final_cost)
