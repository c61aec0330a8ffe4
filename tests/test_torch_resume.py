"""Snapshots and scan resume of the port against the JAX package.

The map after the port's scan of frames 0-14 of a 30-frame sequence
(640x480, seed 23, an 8-slot ring) is the shared input. The snapshot npz
has one layout in both packages: a file written by the JAX package's
``System.save_snapshot`` loads in the port, the port's loads in
``System.load_snapshot_full``, every field with equal bits, shape and
dtype. ``resume_state`` gives the JAX package's state on that map: the
same slots and ids, and equal tensors (the descriptor bit planes are int8
there and bf16 here, both 0/1). Resuming at frame 15 from the snapshot and
scanning frames 15-29 keeps tracking from its first frame and stays within
10 mm of the uninterrupted run's positions (the JAX package's bound for its
own resume, tests/test_parity_resume.py; measured here: 0). An empty
snapshot resumes in INIT.
"""

import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from visionx_slam_tpu.system.system import System
from visionx_slam_tpu.tracking import mapstate as JMS
from visionx_slam_tpu.tracking import scan_pipeline as JSP

from visionx_slam_torch import convert
from visionx_slam_torch.system import system as TSYS
from visionx_slam_torch.tracking import mapstate as TMS
from visionx_slam_torch.tracking import scan_pipeline as TSP
from visionx_slam_torch.utils.config import TrackingOptions

from torch_parity import cameras, sequence, to_np

KW = dict(kf_capacity=8, lm_capacity=16384)
T, CUT = 30, 15


@pytest.fixture(scope="module")
def first_half():
    grays, depths, _ = sequence(T, 23)
    _, tc = cameras()
    st, out = TSP.run_scan_pipeline(tc, grays[:CUT], depths[:CUT], TrackingOptions(),
                                    device="cpu", **KW)
    assert bool(out.tracked.all())
    return st


def _jax_map(ms_t):
    return JMS.MapState(**{k: jnp.asarray(v)
                           for k, v in convert.mapstate_to_numpy(ms_t).items()})


def _jax_writes(ms_j, path, next_frame_id):
    """The JAX package's own writer, on a stand-in for its System."""
    stub = types.SimpleNamespace(tracker=types.SimpleNamespace(ms=ms_j), _frame0=0,
                                 results=[None] * next_frame_id)
    System.save_snapshot(stub, path)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_snapshot_crosses_packages(first_half, tmp_path, writer):
    path = str(tmp_path / "map_snapshot.npz")
    ms_t = first_half.ms
    if writer == "jax":
        _jax_writes(_jax_map(ms_t), path, CUT)
    else:
        TSYS.save_snapshot(path, ms_t, CUT)
    got_t, meta_t = TSYS.load_snapshot_full(path, device="cpu")
    got_j, meta_j = System.load_snapshot_full(path)
    assert meta_t == meta_j == {"next_frame_id": CUT}
    ref = JMS.empty_map(KW["kf_capacity"], KW["lm_capacity"], 1024)
    for f in TMS.MapState._fields:
        a, b = to_np(getattr(got_t, f)), np.asarray(getattr(got_j, f))
        np.testing.assert_array_equal(a, to_np(getattr(ms_t, f)), err_msg=f)
        np.testing.assert_array_equal(b, a, err_msg=f)
        want = np.asarray(getattr(ref, f))
        assert a.dtype == b.dtype == want.dtype and a.shape == want.shape, f
    assert torch.equal(TSYS.load_snapshot(path, device="cpu").kf_id, ms_t.kf_id)
    z = np.load(path)
    assert sorted(z.files) == sorted(("_meta_next_frame_id",) + TMS.MapState._fields)
    assert z["_meta_next_frame_id"].dtype == np.int64


def _assert_state_equal(st_t, st_j):
    for f in ("tstate", "init_kf_slot", "last_kf_slot", "last_kf_id",
              "last_inliers", "init_frame_id"):
        assert getattr(st_t, f) == int(getattr(st_j, f)), f
    assert st_t.have_init == bool(st_j.have_init)
    assert st_t.last_parallax == float(st_j.last_parallax)
    assert st_t.kf_cursor == int(st_j.ms.next_kf)
    for name in ("last_obs", "init_obs", "last_pose", "cur_pose"):
        for a, b in zip(getattr(st_t, name), getattr(st_j, name)):
            np.testing.assert_array_equal(to_np(a), np.asarray(b), err_msg=name)
    for f in ("kf_bits", "kf_pop", "kf_fvalid", "kf_lm_pts", "kf_lm_valid", "kf_px2"):
        np.testing.assert_array_equal(to_np(getattr(st_t, f).float()),
                                      np.asarray(getattr(st_j, f)).astype(np.float32),
                                      err_msg=f)


def test_resume_state_matches_jax(first_half):
    ms_t = convert.mapstate_from_numpy(convert.mapstate_to_numpy(first_half.ms))
    st_t = TSP.resume_state(ms_t)
    st_j = JSP.resume_state(_jax_map(ms_t))
    assert st_t.tstate == TSP.GOOD and st_t.last_kf_slot == first_half.last_kf_slot
    assert st_t.last_kf_id == first_half.last_kf_id
    _assert_state_equal(st_t, st_j)
    # the state holds the map itself, and copies of what it took from it
    assert st_t.ms is ms_t
    assert st_t.cur_pose.q.data_ptr() != st_t.last_pose.q.data_ptr()
    before = st_t.last_obs.px.clone()
    ms_t.kf_px.zero_()
    ms_t.kf_q.zero_()
    assert torch.equal(st_t.last_obs.px, before) and float(st_t.cur_pose.q.abs().sum()) > 0


def test_empty_snapshot_resumes_in_init(tmp_path):
    path = str(tmp_path / "empty.npz")
    TSYS.save_snapshot(path, TMS.empty_map(4, 256, 64), 0)
    ms_t, meta = TSYS.load_snapshot_full(path, device="cpu")
    st_t = TSP.resume_state(ms_t)
    assert meta["next_frame_id"] == 0
    assert st_t.tstate == TSP.INIT and st_t.last_kf_slot == -1 and st_t.init_kf_slot == -1
    assert not bool(st_t.kf_fvalid.any()) and not bool(st_t.kf_lm_valid.any())
    st_j = JSP.resume_state(JMS.empty_map(4, 256, 64))
    _assert_state_equal(st_t, st_j)


def test_resume_matches_uninterrupted_run(first_half, tmp_path):
    grays, depths, _ = sequence(T, 23)
    _, tc = cameras()
    _, full = TSP.run_scan_pipeline(tc, grays, depths, TrackingOptions(),
                                    device="cpu", **KW)
    path = str(tmp_path / "map_snapshot.npz")
    TSYS.save_snapshot(path, first_half.ms, CUT)
    st, out, archive, gba = TSYS.run_scan_archived(
        tc, grays[CUT:], depths[CUT:], TrackingOptions(), run_gba=False,
        resume_from=path, device="cpu", **KW)
    assert gba is None
    tracked = to_np(out.tracked)
    assert tracked[0] and tracked.sum() >= 13, tracked      # tracks at once
    both = tracked & to_np(full.tracked[CUT:])
    gap = (out.pose[:, :3, 3] - full.pose[CUT:, :3, 3]).abs()[torch.from_numpy(both)].max()
    assert float(gap) < 0.01, float(gap)
    # frame ids went on at the snapshot's: the new keyframes carry them
    new_ids = [f for f in archive if f >= CUT]
    assert new_ids and max(archive) < T and int(st.ms.kf_id.max()) == max(archive)
