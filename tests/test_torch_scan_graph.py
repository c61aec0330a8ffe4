"""The scan's steady tracked frame as one function (``scan_pipeline.
track_segment``: the keyframe match, ``pnp_prior`` and the flags of the
frame's one read), run eagerly for CPU tensors and captured once as a CUDA
graph (``TrackGraph``) and replayed for CUDA ones.

On the CPU: over 16 seeded frames at a reprojection threshold of 0.5 px
(so that most frames escalate to the full PnP RANSAC and some do not), the
segment and the tracked branch give exactly what the branch computed before
the segment was factored out (``_before``: its match, the motion-prior
PnP, the values of its read, the escalation); a CPU run captures nothing;
``System`` adds the two new counts to ``timings`` as the scan counts them.

On the card (marker ``cuda``): over the small feeds of the two disk cells
(``tests/test_torch_system_disk.py``'s and ``_holes.py``'s: 24 frames 8
apart, an 8-slot ring), ``System``'s per-frame results with the replay are
bit-equal to the eager function's on the card across keyframe events, and
so are the trajectory files; the replays count the frames that took the
GOOD branch and add two K2 launches each; two ``ScanStream.feed`` calls and
a one-frame feed capture once."""

import os

import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (one torch thread per test process)
from slambench import feeds, run
from visionx_slam_torch.data import synthetic
from visionx_slam_torch.models import estimation, matching
from visionx_slam_torch.models.estimation import pnp_prior, pnp_ransac
from visionx_slam_torch.ops.camera import make_camera
from visionx_slam_torch.ops.se3 import Pose
from visionx_slam_torch.system.system import SCAN_COUNTS, ScanStream, System
from visionx_slam_torch.tracking import scan_pipeline as SP
from visionx_slam_torch.tracking import stages as ST
from visionx_slam_torch.utils.config import SystemConfig, TrackingOptions

from torch_parity import sequence

KW = dict(kf_capacity=4, lm_capacity=7168)
NEW_COUNTS = {"#track_graph": "track_graph",
              "#track_graph_captures": "track_graph_captures"}


def _ok(sol) -> torch.Tensor:
    return (sol.ok & torch.isfinite(sol.pose.q).all(-1)
            & torch.isfinite(sol.pose.t).all(-1))


def _before(cam, opts, st, obs, bits, pop, frame_id):
    """The tracked branch's PnP as the scan ran it before ``track_segment``
    existed: (raw match, filtered match, pixels, pair mask, the prior's
    solution, the read's values, the solution after any escalation,
    escalated)."""
    thr = opts.max_reproj_error
    m_raw = matching.knn2_from_bits(st.kf_bits, st.kf_pop, st.kf_fvalid,
                                    bits, pop, obs.valid)
    m = matching.reference_distance_filter(m_raw)
    pts2d = obs.px[m.idx]
    pvalid = m.valid & st.kf_lm_valid
    prior = pnp_prior(cam, st.kf_lm_pts, pts2d, pvalid, st.cur_pose, thr,
                      refine_iters=min(2, opts.pnp_refine_iters))
    vals = torch.cat([v.reshape(-1).to(torch.float64) for v in (
        m.valid.sum(), pvalid.sum(), prior.n_inliers, _ok(prior),
        ST.parallax_px(st.kf_px2, obs.px, m), st.ms.next_lm)]).tolist()
    sol = prior
    escalated = int(vals[2]) < max(2 * opts.min_inliers, (3 * int(vals[1])) // 10)
    if escalated:
        depth_curr = obs.depth[m.idx] if opts.pnp_use_depth else None
        sol = pnp_ransac(
            cam, st.kf_lm_pts[None], pts2d[None], pvalid[None],
            SP.frame_generator(frame_id, 0, obs.px.device), thr,
            n_hypotheses=max(64, opts.pnp_hypotheses),
            refine_iters=max(6, opts.pnp_refine_iters),
            init_pose=Pose(st.cur_pose.q[None], st.cur_pose.t[None]),
            depth_curr=None if depth_curr is None else depth_curr[None])
        sol = type(sol)(Pose(sol.pose.q[0], sol.pose.t[0]), sol.inlier_mask[0],
                        sol.n_inliers[0], sol.ok[0])
    return m_raw, m, pts2d, pvalid, prior, vals, sol, escalated


def _equal(a, b) -> bool:
    """Tensors, or tuples of them, equal bit for bit."""
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and torch.equal(a, b)
    return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))


@pytest.fixture(scope="module")
def cpu_frames():
    """Per steady tracked frame of a 16-frame CPU scan: (the branch's
    results, the segment it ran, ``_before``'s results)."""
    grays, depths, _ = sequence(16, 7)
    cam = make_camera(synthetic.FX, synthetic.FY, synthetic.CX, synthetic.CY)
    opts = TrackingOptions(ba_window_size=4, max_reproj_error=0.5)
    T, H, W = grays.shape
    step = SP.build_scan_step(cam, opts, (W, H), n_features_cap=1024, **KW)
    obs, mean, std, bits, pop = SP.extract_sequence(
        torch.as_tensor(grays), torch.as_tensor(depths), {"n_slots": 1024})
    mean, std = mean.tolist(), std.tolist()
    st = SP.initial_state(1024, device="cpu", **KW)
    segs, frames = [], []
    real = SP.track_segment

    def spy(*args):
        segs.append(real(*args))
        return segs[-1]

    SP.track_segment = spy
    try:
        for i in range(T):
            o = SP._frame_obs(obs, i)
            if st.tstate == SP.GOOD:
                ref = _before(cam, opts, st, o, bits[i], pop[i], i)
                got = step.track_branch(st, o, bits[i], pop[i], i)
                frames.append((got, segs[-1], ref))
            st, _ = step(st, (i, o, bits[i], pop[i], mean[i], std[i]))
    finally:
        SP.track_segment = real
    return frames, step.counters


def test_the_segment_is_the_branch_before_it(cpu_frames):
    frames, _ = cpu_frames
    assert len(frames) >= 12
    for got, seg, (m_raw, m, pts2d, pvalid, prior, vals, _, _) in frames:
        assert _equal(seg.m_raw, m_raw) and _equal(seg.m, m)
        assert _equal(seg.pts2d, pts2d) and _equal(seg.pvalid, pvalid)
        assert _equal(seg.sol, prior)
        assert seg.flags.dtype == torch.float64 and seg.flags.tolist() == vals


def test_the_branch_is_what_it_was_with_and_without_escalation(cpu_frames):
    frames, ctr = cpu_frames
    escalated = [ref[-1] for _, _, ref in frames]
    assert 0 < sum(escalated) < len(frames), escalated
    for (st, n_matches, inliers, parallax, ok, m_raw, next_lm), _, ref in frames:
        _, _, _, _, _, vals, sol, _ = ref
        assert (n_matches, parallax, next_lm) == (int(vals[0]), vals[4], int(vals[5]))
        assert ok and inliers == int(sol.n_inliers)
        assert _equal(m_raw, ref[0])
        assert _equal(st.cur_pose, sol.pose) and st.last_inliers == inliers
    # eager on the CPU: nothing replayed, nothing captured
    assert ctr.track_graph == ctr.track_graph_captures == 0


def test_a_cpu_system_captures_nothing_and_reports_the_counts(tmp_path,
                                                             monkeypatch):
    graphs: dict = {}
    monkeypatch.setattr(SP, "_TRACK_GRAPHS", graphs)
    synthetic.generate_sequence(str(tmp_path / "seq"), n_frames=8, seed=5)
    timings: dict = {}
    cfg = SystemConfig(dataset_dir=str(tmp_path / "seq"),
                       sequence="rgbd_dataset_freiburg3_synthetic",
                       output_dir=str(tmp_path / "out"), pipeline="scan",
                       kf_capacity=4, loader="python", device="cpu")
    summary = System(cfg, timings=timings).run()
    stats = summary["scan_stats"]
    assert summary["n_tracked"] == 8 and not graphs
    assert set(NEW_COUNTS.items()) <= set(SCAN_COUNTS.items())
    for key, name in NEW_COUNTS.items():
        assert timings[key] == stats[name] == summary["stage_timings"][key] == 0


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def _small_spec(cell: str) -> dict:
    """The small feed of the cell's CPU test: 24 frames 8 apart, an 8-slot
    ring, one pass; the hole-free cell's with the hole model at 15%."""
    spec = run.load_cell(cell)
    if cell == "rgbd.system_disk":
        spec["config"] = dict(spec["config"], depth_holes=dict(
            spec["config"]["depth_holes"], share=0.15))
    spec["traffic"] = dict(spec["traffic"], frames=24, frame_stride=8,
                           min_passes=1, system={"kf_capacity": 8})
    return spec


def _pass(feed):
    """One ``System`` pass of the feed: (its summary, its per-frame
    results, trajectory.txt's bytes, K2 launches)."""
    kept = []
    before = estimation.gn_launches
    summary, out = feed.one_pass(before=kept.append)
    with open(os.path.join(out, "trajectory.txt"), "rb") as f:
        traj = f.read()
    return summary, kept[0].results, traj, estimation.gn_launches - before


@pytest.fixture(scope="module", params=["rgbd.system_disk",
                                        "rgbd.system_disk_holes"])
def card_passes(request):
    """(replayed pass, eager pass, the K2 launches of each replay) of the
    cell's small feed on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    spec = _small_spec(request.param)
    feed = feeds.load("system_disk")(spec["config"], spec["traffic"],
                                     2**31 + 91, "cuda")
    feed.write()
    feed.one_pass()        # the warm pass: the capture, K2's build
    per_replay = []
    run_graph = SP.TrackGraph.run

    def counted(self, args):
        n = estimation.gn_launches
        out = run_graph(self, args)
        per_replay.append(estimation.gn_launches - n)
        return out

    mp = pytest.MonkeyPatch()
    mp.setattr(SP.TrackGraph, "run", counted)
    try:
        replayed = _pass(feed)
    finally:
        mp.undo()
    mp.setattr(SP, "_track_graph", lambda *a: None)
    try:
        eager = _pass(feed)
    finally:
        mp.undo()
    return replayed, eager, per_replay


@pytest.mark.cuda
def test_the_replay_equals_the_eager_segment_on_the_card(card_passes):
    (s_g, res_g, traj_g, _), (s_e, res_e, traj_e, _), _ = card_passes
    assert len(res_g) == len(res_e) == 24
    assert s_g["scan_stats"]["kf_events"] >= 4     # the cache is refreshed
    for a, b in zip(res_g, res_e):
        assert (a.state, a.n_matches, a.n_inliers, a.parallax, a.is_keyframe) == (
            b.state, b.n_matches, b.n_inliers, b.parallax, b.is_keyframe)
        assert (a.pose_T_cw is None) == (b.pose_T_cw is None)
        if a.pose_T_cw is not None:
            np.testing.assert_array_equal(a.pose_T_cw, b.pose_T_cw)
    assert traj_g == traj_e


@pytest.mark.cuda
def test_the_replays_count_the_good_frames_and_two_k2_launches(card_passes):
    (s_g, res_g, _, k2_g), (s_e, _, _, k2_e), per_replay = card_passes
    good = sum(prev.state == "TRACKING_GOOD" for prev in res_g[:-1])
    stats = s_g["scan_stats"]
    assert stats["track_graph"] == good == len(per_replay) > 0
    assert stats["track_graph_captures"] == 0     # captured in the warm pass
    assert s_e["scan_stats"]["track_graph"] == 0
    assert set(per_replay) == {2} and k2_g == k2_e
    for key, name in NEW_COUNTS.items():
        assert s_g["stage_timings"][key] == stats[name]


@pytest.mark.cuda
def test_chunks_and_a_one_frame_feed_capture_once(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    graphs: dict = {}
    monkeypatch.setattr(SP, "_TRACK_GRAPHS", graphs)
    spec = _small_spec("rgbd.system_disk")
    feed = feeds.load("system_disk")(spec["config"], spec["traffic"],
                                     2**31 + 92, "cuda")
    scan = ScanStream(feed.cam, feed.opts, kf_capacity=8, device="cuda")
    for lo, hi in ((0, 8), (8, 16), (16, 17)):
        scan.feed(feed.g[lo:hi], feed.d[lo:hi])
    stats = scan.stats()
    assert stats["track_graph_captures"] == 1 and len(graphs) == 1
    assert stats["track_graph"] >= 14
    graph = next(iter(graphs.values()))
    assert graph.k2_launches == 2 and graph.pool_bytes > 0
