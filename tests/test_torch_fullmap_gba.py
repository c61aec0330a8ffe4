"""The keyframe archive and the full-map global BA of the port (BASELINE
config 4), in the shape of tests/test_fullmap_gba.py: a 12-slot keyframe
ring on a 48-frame sequence (640x480, seed 19; 40% of the depth pixels
dropped at random, so that features without depth adopt the previous
keyframe's landmarks and the union solve has two-view landmarks to
refine). The ring wraps, the archive holds every keyframe the scan made
(more than the ring), the union map has them all alive in ascending id
order, and ``pair_ba`` over it does not raise the mean reprojection error
(1e-3 px slack, the JAX test's). The chunked, harvesting run's first two
chunks equal the plain scan of those 24 frames bit for bit.

Against the JAX package on the same ring map: ``System._harvest_keyframes``
and ``_archive_union_map`` give the port's archive and union map (integer
tables equal, landmark positions within 1e-4 m), and one Gauss-Newton
iteration of ``pair_ba`` on the two union maps agrees in keyframe poses
within 1e-5 (2e-6 measured). A second iteration does not: at this camera
speed the two-view landmarks' depth direction is so weak that the step
amplifies float32 rounding (the per-keyframe sums add in another order) to
5 mm in the poses, more than the step itself moves them (3.5 mm), in both
packages alike, and either package's second step may fling a few such
landmarks away (seen in the JAX package at 48 frames: mean error 0.15 ->
1.03 px, the port's 0.116 px); there the two solves are held to the same
cost entering the second iteration within 1e-3 relative, and the port's
solve to a lower mean reprojection error than it started from. When
the archive did not outgrow the ring, ``run_global_ba`` solves the ring map
with ``global_ba``.
"""

import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from visionx_slam_tpu.models import global_ba as JG
from visionx_slam_tpu.models import pair_ba as JP
from visionx_slam_tpu.system.system import System
from visionx_slam_tpu.tracking import mapstate as JMS
from visionx_slam_tpu.utils.config import TrackingOptions as JOpts

from visionx_slam_torch import convert
from visionx_slam_torch.models import global_ba as TG
from visionx_slam_torch.models import pair_ba as TP
from visionx_slam_torch.system import system as TSYS
from visionx_slam_torch.tracking import scan_pipeline as TSP
from visionx_slam_torch.utils.config import TrackingOptions

from torch_parity import cameras, sequence, to_np

KF_CAP, T = 12, 48
KW = dict(kf_capacity=KF_CAP, lm_capacity=1 << 15)


def _inputs():
    grays, depths, _ = sequence(T, 19)
    keep = np.random.default_rng(2).random(depths.shape) > 0.4
    return grays, (depths * keep).astype(np.float32)


@pytest.fixture(scope="module")
def archived_run():
    grays, depths = _inputs()
    _, tc = cameras()
    stats = {}
    st, out, archive, _ = TSYS.run_scan_archived(
        tc, grays, depths, TrackingOptions(), run_gba=False, device="cpu",
        stats=stats, **KW)
    return st, out, archive, stats


def test_gba_covers_all_archived_keyframes(archived_run):
    st, out, archive, stats = archived_run
    _, tc = cameras()
    assert stats["chunk"] == KF_CAP and stats["chunks"] == T // KF_CAP
    n_arch = len(archive)
    assert n_arch > KF_CAP, n_arch                 # the ring wrapped
    # every keyframe the scan made: its events and the init pair's first frame
    assert n_arch == int(out.is_keyframe.sum()) + 1
    ring_ids = to_np(st.ms.kf_id)
    ms2, gba = TSYS.run_global_ba(st.ms, tc, TrackingOptions(), archive,
                                  iterations=4, device="cpu")
    assert gba["archived_keyframes"] == n_arch
    kf_ids = to_np(ms2.kf_id)
    assert ms2.kf_capacity == 32 and int((kf_ids >= 0).sum()) == n_arch
    assert kf_ids[:n_arch].tolist() == sorted(archive) == gba["keyframe_ids"]
    assert gba["keyframe_poses"].shape == (n_arch, 4, 4)
    assert np.isfinite(gba["keyframe_poses"]).all()
    assert gba["mean_reproj_after_px"] <= gba["mean_reproj_before_px"] + 1e-3, gba
    assert gba["total_obs"] > 0 and gba["iterations"] >= 1
    # two-view landmarks exist, so the solve moved the keyframes
    assert int((ms2.lm_obs >= 2).sum()) > 100
    np.testing.assert_array_equal(to_np(st.ms.kf_id), ring_ids)   # ring map kept


def test_chunked_harvesting_run_equals_plain_scan(archived_run):
    _, out, archive, _ = archived_run
    grays, depths = _inputs()
    _, tc = cameras()
    n = 2 * KF_CAP
    st, plain = TSP.run_scan_pipeline(tc, grays[:n], depths[:n], TrackingOptions(),
                                      device="cpu", **KW)
    for f in TSP.FrameOut._fields:
        assert torch.equal(getattr(out, f)[:n], getattr(plain, f)), f
    # the archive holds the keyframes of that ring as they were harvested
    for slot, fid in enumerate(to_np(st.ms.kf_id)):
        if fid >= 0:
            np.testing.assert_array_equal(archive[int(fid)]["desc"],
                                          to_np(st.ms.kf_desc[slot]))


def test_archive_and_union_map_match_jax(archived_run):
    st, _, archive, _ = archived_run
    jc, tc = cameras()
    ms_j = JMS.MapState(**{k: jnp.asarray(v)
                           for k, v in convert.mapstate_to_numpy(st.ms).items()})
    stub = types.SimpleNamespace(
        _archive={}, cam=jc, cfg=types.SimpleNamespace(tracking=JOpts()))
    System._harvest_keyframes(stub, ms_j)
    ring = TSYS.harvest_keyframes({}, st.ms)
    assert sorted(ring) == sorted(stub._archive) and len(ring) == KF_CAP
    for fid, kf in ring.items():
        for key, val in kf.items():
            np.testing.assert_array_equal(val, stub._archive[fid][key], err_msg=key)
            assert val.dtype == stub._archive[fid][key].dtype, key
    # the JAX package's build_keyframe_map on the port's whole archive
    stub._archive = archive
    uj, lj = System._archive_union_map(stub)
    ut, lt = TSYS.archive_union_map(archive, tc, TrackingOptions(), device="cpu")
    assert ut.lm_physical == uj.lm_physical == (1 << 17) + 1024
    for f in JMS.MapState._fields:
        a, b = to_np(getattr(ut, f)), np.asarray(getattr(uj, f))
        if f == "lm_pos":
            np.testing.assert_allclose(a, b, atol=1e-4, err_msg=f)
        elif f not in ("kf_q", "kf_t"):
            np.testing.assert_array_equal(a, b, err_msg=f)
    for f in TP.PairLinks._fields:
        np.testing.assert_array_equal(to_np(getattr(lt, f)), np.asarray(getattr(lj, f)),
                                      err_msg=f)
    assert int((to_np(lt.adopter) >= 0).sum()) > 1000
    opts = dict(max_iterations=1, cg_iterations=12)
    j2, js = JP.pair_ba(uj, jc, lj, JG.GlobalBAOptions(**opts))
    t2, ts = TP.pair_ba(ut, tc, lt, TG.GlobalBAOptions(**opts))
    assert int(ts.total_obs) == int(js.total_obs) > 0
    np.testing.assert_allclose(to_np(t2.kf_t), np.asarray(j2.kf_t), atol=1e-5)
    np.testing.assert_allclose(to_np(t2.kf_q), np.asarray(j2.kf_q), atol=1e-5)
    assert float((t2.kf_t - ut.kf_t).abs().max()) > 5e-4      # the step moved them
    opts = dict(max_iterations=2, cg_iterations=12)
    j2, js = JP.pair_ba(uj, jc, lj, JG.GlobalBAOptions(**opts))
    t2, ts = TP.pair_ba(ut, tc, lt, TG.GlobalBAOptions(**opts))
    np.testing.assert_allclose(float(ts.final_cost), float(js.final_cost), rtol=1e-3)
    err0 = float(TG.map_reproj_error(ut, tc)[0])
    err_t = float(TG.map_reproj_error(t2, tc)[0])
    assert err_t < 0.9 * err0, (err0, err_t)


def test_ring_map_is_solved_by_global_ba():
    """16 frames in the default 64-slot ring: nothing was evicted, so the
    solve is ``global_ba`` on the ring map itself."""
    grays, depths = _inputs()
    _, tc = cameras()
    st, out, archive, gba = TSYS.run_scan_archived(
        tc, grays[:16], depths[:16], TrackingOptions(), lm_capacity=1 << 15,
        gba_iterations=2, device="cpu")
    assert "archived_keyframes" not in gba
    assert len(archive) == int(out.is_keyframe.sum()) + 1 == len(gba["keyframe_ids"])
    assert st.ms.kf_capacity == 64
    assert gba["mean_reproj_after_px"] <= gba["mean_reproj_before_px"] + 1e-3, gba
    assert gba["total_obs"] > 0
