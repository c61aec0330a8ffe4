"""The port's online scan against the JAX package's on 16 frames of 640x480
(seed 7), with a 4-slot keyframe ring (the ring wraps) and a 7168-landmark
table (compaction fires and reaps the evicted keyframes' landmarks). The
JAX local BA needs a ring at least as large as its window, so both run with
``ba_window_size=4``. RANSAC draws cannot be shared, so the parity is a band:
both track >= 14/16 frames, keyframe decisions agree on >= 0.9 of the
frames, both ATEs are under 2 cm and within 5 mm of each other, and the
landmark counts are within 10%.

Also: a run streamed in 8-frame chunks equals one run bit for bit (each
frame seeds its own generators), the garbage-frame recovery case of
tests/test_scan_pipeline.py holds for the port, a steady tracked frame
costs one device read, and the
batched scan over two 16-frame sequences (the run above, and its frames in
reverse order) gives outputs laid out [T, B, ...] whose lane b equals the
single run of sequence b bit for bit."""

import numpy as np
import pytest
import torch

import jax

from visionx_slam_tpu.tracking.scan_pipeline import run_scan_pipeline as jax_run
from visionx_slam_tpu.utils.config import TrackingOptions as JOpts

from visionx_slam_torch.eval.trajectory import ate_of_run
from visionx_slam_torch.ops import detect
from visionx_slam_torch.tracking import scan_pipeline as TSP
from visionx_slam_torch.utils.config import TrackingOptions

from torch_parity import cameras, sequence, to_np

KW = dict(kf_capacity=4, lm_capacity=7168)


@pytest.fixture(scope="module")
def runs():
    grays, depths, gt = sequence(16, 7)
    jc, tc = cameras()
    st_j, oj = jax_run(jc, grays, depths, JOpts(ba_window_size=4), **KW)
    jax.block_until_ready(oj)
    stats = {}
    before = detect.launches
    st_t, ot = TSP.run_scan_pipeline(tc, grays, depths,
                                     TrackingOptions(ba_window_size=4),
                                     device="cpu", stats=stats, **KW)
    assert detect.launches == before     # CPU tensors take K1's plain version
    return st_j, oj, st_t, ot, stats, gt


def test_scan_matches_jax_band(runs):
    st_j, oj, st_t, ot, stats, gt = runs
    tr_j, tr_t = np.asarray(oj.tracked), to_np(ot.tracked)
    assert tr_j.sum() >= 14 and tr_t.sum() >= 14, (tr_j, tr_t)
    kf_j, kf_t = np.asarray(oj.is_keyframe), to_np(ot.is_keyframe)
    assert (kf_j == kf_t).mean() >= 0.9, (kf_j, kf_t)
    ate_j, _ = ate_of_run(np.asarray(oj.pose), tr_j, gt)
    ate_t, _ = ate_of_run(to_np(ot.pose), tr_t, gt)
    assert ate_j < 0.02 and ate_t < 0.02, (ate_j, ate_t)
    assert abs(ate_j - ate_t) <= 0.005, (ate_j, ate_t)
    n_j, n_t = int(oj.n_landmarks[-1]), int(ot.n_landmarks[-1])
    assert abs(n_t - n_j) <= 0.1 * n_j, (n_j, n_t)
    # the ring wrapped and compaction ran, in both
    assert kf_t.sum() + 1 > KW["kf_capacity"] and kf_j.sum() + 1 > KW["kf_capacity"]
    assert stats["compactions"] >= 1
    assert int(st_j.ms.next_lm) < 1000 * (kf_j.sum() + 1)   # JAX reaped too
    assert int(st_t.ms.next_lm) < 1000 * (kf_t.sum() + 1)


def test_scan_outputs_are_consistent(runs):
    _, _, st_t, ot, stats, _ = runs
    T = 16
    assert ot.pose.shape == (T, 4, 4) and np.isfinite(to_np(ot.pose)).all()
    assert ot.state.dtype == torch.int32 and ot.tracked.dtype == torch.bool
    assert stats["frames"] == T and stats["kf_events"] == int(ot.is_keyframe.sum()) - 1
    # one read per frame (one more for the image statistics) when tracking
    # is steady (no PnP escalation, no essential fallback), and the local
    # BA convergence read of each keyframe event (its window has no
    # eligible landmark on this input: one read)
    assert stats["host_syncs"] == T + 1 + stats["kf_events"], stats
    assert st_t.kf_cursor == int(st_t.ms.next_kf)
    ms = st_t.ms
    feat_lm = to_np(ms.kf_feat_lm)
    alive = to_np(ms.lm_alive)
    linked = feat_lm[feat_lm >= 0]
    assert alive[linked].all()
    assert (to_np(ms.lm_obs)[: int(ms.next_lm)] >= 0).all()


def test_streamed_chunks_equal_one_run(runs):
    _, _, _, ot, _, _ = runs
    grays, depths, _ = sequence(16, 7)
    _, tc = cameras()
    opts = TrackingOptions(ba_window_size=4)
    st, outs = None, []
    for s in (0, 8):
        st, o = TSP.run_scan_pipeline(tc, grays[s:s + 8], depths[s:s + 8], opts,
                                      st0=st, frame0=s, device="cpu", **KW)
        outs.append(o)
    for f in TSP.FrameOut._fields:
        got = torch.cat([getattr(o, f) for o in outs])
        assert torch.equal(got, getattr(ot, f)), f


def test_scan_recovers_from_garbage_frames():
    """tests/test_scan_pipeline.py's failure injection on the port: three
    black frames in a 25-frame sequence (seed 11)."""
    grays, depths, _ = sequence(25, 11)
    g = grays.copy()
    g[10:13] = 0
    _, tc = cameras()
    _, out = TSP.run_scan_pipeline(tc, g, depths, TrackingOptions(), device="cpu")
    tracked = to_np(out.tracked)
    states = to_np(out.state)
    assert not tracked[11]
    assert (states[10:14] != TSP.GOOD).any(), states
    assert tracked[-3:].any(), states
    assert states[-1] == TSP.GOOD, states


def test_batched_scan_lanes_equal_single_runs(runs):
    _, _, st0, o0, _, _ = runs
    grays, depths, _ = sequence(16, 7)
    _, tc = cameras()
    opts = TrackingOptions(ba_window_size=4)
    g2 = np.stack([grays, grays[::-1]])
    d2 = np.stack([depths, depths[::-1]])
    stats = {}
    stb, ob = TSP.run_scan_pipeline_batched(tc, g2, d2, opts, device="cpu",
                                            stats=stats, **KW)
    st1, o1 = TSP.run_scan_pipeline(tc, g2[1], d2[1], opts, device="cpu", **KW)
    assert ob.pose.shape == (16, 2, 4, 4) and ob.tracked.shape == (16, 2)
    for f in TSP.FrameOut._fields:
        for b, single in enumerate((o0, o1)):
            assert torch.equal(getattr(ob, f)[:, b], getattr(single, f)), (f, b)
    # final states stacked over B: tensors gain a lane axis, host values a tuple
    assert stb.ms.kf_id.shape == (2, KW["kf_capacity"])
    assert stb.tstate == (st0.tstate, st1.tstate)
    assert stb.kf_cursor == (st0.kf_cursor, st1.kf_cursor)
    for b, single in enumerate((st0, st1)):
        for f in TSP.MapState._fields:
            assert torch.equal(getattr(stb.ms, f)[b], getattr(single.ms, f)), (f, b)
        assert torch.equal(stb.cur_pose.t[b], single.cur_pose.t)
    assert len(stats["lanes"]) == 2
    assert stats["frames"] == 32 and stats["kf_events"] == sum(
        s["kf_events"] for s in stats["lanes"])


def test_batched_scan_culls_in_every_lane():
    """Two 12-frame sequences (seed 7: frames 0-11 and 12-23), an 8-slot
    ring, culling on with options that keep the landmarks and remove
    keyframes: each lane equals ``run_scan_pipeline`` of its sequence bit for
    bit, every frame tracks, and the lanes' culling counters add up."""
    grays, depths, _ = sequence(24, 7)
    g2 = np.stack([grays[:12], grays[12:]])
    d2 = np.stack([depths[:12], depths[12:]])
    _, tc = cameras()
    opts = TrackingOptions(enable_culling=True, min_landmark_observations=1,
                           kf_min_shared_observations=1, max_keyframes=3)
    kw = dict(kf_capacity=8, lm_capacity=16384)
    stats = {}
    stb, ob = TSP.run_scan_pipeline_batched(tc, g2, d2, opts, device="cpu",
                                            stats=stats, **kw)
    for b in range(2):
        s1 = {}
        st1, o1 = TSP.run_scan_pipeline(tc, g2[b], d2[b], opts, device="cpu",
                                        stats=s1, **kw)
        for f in TSP.FrameOut._fields:
            assert torch.equal(getattr(ob, f)[:, b], getattr(o1, f)), (f, b)
        for f in TSP.MapState._fields:
            assert torch.equal(getattr(stb.ms, f)[b], getattr(st1.ms, f)), (f, b)
        for k in ("kf_events", "kf_culled", "lm_culled"):
            assert stats["lanes"][b][k] == s1[k], (k, b)
        # the single run also reads the extraction's image statistics
        assert stats["lanes"][b]["host_syncs"] == s1["host_syncs"] - 1
    assert bool(ob.tracked.all())
    assert stats["kf_culled"] > 0 and stats["lm_culled"] > 0
    assert stats["kf_culled"] == sum(s["kf_culled"] for s in stats["lanes"])


def test_batched_scan_defaults_to_the_card():
    import inspect

    sig = inspect.signature(TSP.run_scan_pipeline_batched)
    assert sig.parameters["device"].default == "cuda"
