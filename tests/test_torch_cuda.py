"""The port on a CUDA device against the same port on the CPU (skipped
without a card; run on the GPU host with ``--noconftest``, see README).
No jax here: the GPU host has none. The ORB atlas (bit for bit), the
offline pipeline (one lane, two folded lanes, monocular), global BA, the
pairwise solver ``pair_ba`` (also: equal bits between two runs), the scan
with map culling, and the online scan: with depth holes (triangulation, local BA and compaction
run), through a blackout (reset and re-initialization), and with the
monocular option set (essential init, inherited landmarks).

On CUDA the solvers' float sums add in a fixed order
(``ops.index.segment_sum``), so ``global_ba`` repeats bit for bit on the
card; but GEMMs reduce in another order than on the CPU, hence tolerances
of float32 rounding amplified by one GN step between the devices, not
equality."""

import numpy as np
import pytest
import torch

from visionx_slam_torch.data import synthetic
from visionx_slam_torch.eval.trajectory import ate_of_run
from visionx_slam_torch.models.global_ba import (
    GlobalBAOptions,
    global_ba,
    map_reproj_error,
)
from visionx_slam_torch.models.orb_torch import build_atlas, orb_extract
from visionx_slam_torch.ops import detect
from visionx_slam_torch.ops.camera import make_camera
from visionx_slam_torch.ops.se3 import matrix_to_quat, quat_mul, so3_exp
from visionx_slam_torch.tracking.offline_pipeline import (
    build_keyframe_map,
    build_offline_pipeline,
    run_offline_pipeline,
    run_offline_pipeline_batched,
)
from visionx_slam_torch.tracking.scan_pipeline import GOOD, run_scan_pipeline
from visionx_slam_torch.tracking.stages import sample_depth_image
from visionx_slam_torch.utils.config import TrackingOptions

from torch_parity import sequence, t

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def both_runs(cuda):
    grays, depths, gt = sequence(16, 7)
    cam = make_camera(synthetic.FX, synthetic.FY, synthetic.CX, synthetic.CY)
    run = build_offline_pipeline(TrackingOptions(), kf_capacity=16)
    out = {}
    for dev in ("cpu", cuda):
        ms, links, aux = run.pre(cam, t(grays).to(dev), t(depths).to(dev))
        ms_r = run.refine(cam, ms)
        out[str(dev)] = (ms, ms_r, run.post(cam, ms_r, aux)[1])
    return cam, gt, out


def test_pipeline_on_cuda_matches_cpu_band(both_runs):
    cam, gt, out = both_runs
    (_, _, o_c), (_, _, o_g) = out["cpu"], out["cuda"]
    tr_c, tr_g = o_c.tracked.numpy(), o_g.tracked.cpu().numpy()
    assert tr_c.sum() >= 15 and tr_g.sum() >= 15
    # the two devices draw different RANSAC samples
    assert (o_c.is_keyframe.numpy() == o_g.is_keyframe.cpu().numpy()).mean() >= 0.9
    ate_c, _ = ate_of_run(o_c.pose.numpy(), tr_c, gt)
    ate_g, _ = ate_of_run(o_g.pose.cpu().numpy(), tr_g, gt)
    assert ate_g < 0.02 and abs(ate_g - ate_c) <= 0.005, (ate_c, ate_g)


def _noisy_map():
    """A keyframe map with multi-view links, built by the port on the CPU:
    keyframes of a fast 16-frame sequence, ground-truth poses plus noise,
    40% of feature depths dropped (as tests/test_torch_global_ba.py)."""
    loop, frames = 60, [0, 3, 6, 9, 12, 15]
    grays, depths, _ = sequence(16, 7, loop)
    rng = np.random.default_rng(0)
    px, _, desc, valid = orb_extract(t(grays[frames]))
    dep = sample_depth_image(t(depths[frames]), px, valid)
    dep = torch.where(t(rng.random(dep.shape) < 0.4), 0.0, dep)
    qs, ts = [], []
    for f in frames:
        R_wc, t_wc = synthetic.trajectory_pose(f, 16, loop)
        q = matrix_to_quat(t(R_wc.T.astype(np.float32)))
        qs.append(quat_mul(so3_exp(t(rng.normal(0, 2e-3, 3).astype(np.float32))), q))
        ts.append(t((-R_wc.T @ t_wc + rng.normal(0, 5e-3, 3)).astype(np.float32)))
    cam = make_camera(synthetic.FX, synthetic.FY, synthetic.CX, synthetic.CY)
    ids = torch.tensor(frames, dtype=torch.int32)
    N = px.shape[1]
    ms, links = build_keyframe_map(cam, TrackingOptions(), torch.stack(qs),
                                   torch.stack(ts), ids, px, desc, valid, dep,
                                   len(frames) * N)
    assert int((links.adopter >= 0).sum()) > 200
    return cam, ms, links


def test_global_ba_on_cuda_matches_cpu(cuda):
    """Two GN passes from the same CPU-built map on both devices."""
    cam, ms, _ = _noisy_map()
    opts = GlobalBAOptions(max_iterations=2, cg_iterations=8)
    r_c, s_c = global_ba(ms, cam, opts)
    r_g, s_g = global_ba(type(ms)(*(x.to(cuda) for x in ms)), cam, opts)
    assert (r_c.kf_t - ms.kf_t).abs().max() > 1e-3       # the solve moved
    np.testing.assert_allclose(float(s_g.final_cost), float(s_c.final_cost),
                               rtol=1e-4)
    np.testing.assert_allclose(r_g.kf_q.cpu().numpy(), r_c.kf_q.numpy(), atol=1e-4)
    np.testing.assert_allclose(r_g.kf_t.cpu().numpy(), r_c.kf_t.numpy(), atol=1e-4)
    np.testing.assert_allclose(float(map_reproj_error(r_g, cam)[0]),
                               float(map_reproj_error(r_c, cam)[0]), rtol=1e-3)


def test_global_ba_repeats_bit_for_bit_on_cuda(cuda):
    """Two solves of the same map on the card give the same bits (the
    landmark and gauge-group sums are segment sums in a fixed order)."""
    cam, ms, _ = _noisy_map()
    opts = GlobalBAOptions(max_iterations=2, cg_iterations=8)
    on = type(ms)(*(x.to(cuda) for x in ms))
    r1, s1 = global_ba(on, cam, opts)
    r2, s2 = global_ba(on, cam, opts)
    for f in ("kf_q", "kf_t", "lm_pos"):
        assert torch.equal(getattr(r1, f), getattr(r2, f)), f
    assert torch.equal(s1.final_cost, s2.final_cost)
    grp = torch.arange(ms.kf_capacity, device=cuda) % 2
    g1, _ = global_ba(on, cam, opts, gauge_group=grp)
    g2, _ = global_ba(on, cam, opts, gauge_group=grp)
    assert torch.equal(g1.lm_pos, g2.lm_pos) and torch.equal(g1.kf_t, g2.kf_t)


def test_pair_ba_on_cuda_matches_cpu_and_repeats(cuda):
    """Two GN passes of the pairwise solver from the same CPU-built map on
    both devices; on the card it has no atomics, so two runs give equal
    bits."""
    from visionx_slam_torch.models.pair_ba import pair_ba

    cam, ms, links = _noisy_map()
    opts = GlobalBAOptions(max_iterations=2, cg_iterations=8)
    r_c, s_c = pair_ba(ms, cam, links, opts)
    on = lambda nt: type(nt)(*(x.to(cuda) for x in nt))
    r_g, s_g = pair_ba(on(ms), cam, on(links), opts)
    assert (r_c.kf_t - ms.kf_t).abs().max() > 1e-3       # the solve moved
    assert int(s_g.total_obs) == int(s_c.total_obs) > 0
    np.testing.assert_allclose(float(s_g.final_cost), float(s_c.final_cost),
                               rtol=1e-4)
    np.testing.assert_allclose(r_g.kf_q.cpu().numpy(), r_c.kf_q.numpy(), atol=1e-4)
    np.testing.assert_allclose(r_g.kf_t.cpu().numpy(), r_c.kf_t.numpy(), atol=1e-4)
    np.testing.assert_allclose(float(map_reproj_error(r_g, cam)[0]),
                               float(map_reproj_error(r_c, cam)[0]), rtol=1e-3)
    r_g2, _ = pair_ba(on(ms), cam, on(links), opts)
    for f in ("kf_q", "kf_t", "lm_pos"):
        assert torch.equal(getattr(r_g, f), getattr(r_g2, f)), f


def test_culling_scan_on_cuda_matches_cpu_band(cuda):
    """The scan with map culling on 24 frames, with options that keep the
    landmarks and make keyframes redundant (keyframes are removed at every
    event): the card against the CPU port. The devices draw different
    RANSAC samples, so a band: every frame tracks on both, ATE within 2 mm,
    the same number of keyframes removed within 1, the same landmark count
    within 5%."""
    grays, depths, gt = sequence(24, 7)
    cam = make_camera(synthetic.FX, synthetic.FY, synthetic.CX, synthetic.CY)
    opts = TrackingOptions(enable_culling=True, min_landmark_observations=1,
                           kf_min_shared_observations=1, max_keyframes=4)
    res = {}
    for dev in ("cpu", cuda):
        stats = {}
        before = detect.launches
        _, out = run_scan_pipeline(cam, grays, depths, opts, kf_capacity=8,
                                   lm_capacity=16384, device=dev, stats=stats)
        assert (detect.launches > before) == (dev != "cpu")
        ate, n = ate_of_run(out.pose.cpu().numpy(), out.tracked.cpu().numpy(), gt)
        res[str(dev)] = (ate, n, stats, int(out.n_landmarks[-1]))
    (a_c, n_c, s_c, l_c), (a_g, n_g, s_g, l_g) = res["cpu"], res["cuda"]
    assert n_c == n_g == 24
    assert a_g < 0.01 and abs(a_g - a_c) <= 2e-3, (a_c, a_g)
    assert s_g["kf_culled"] >= 2 and abs(s_g["kf_culled"] - s_c["kf_culled"]) <= 1
    assert s_g["lm_culled"] > 0 and abs(l_g - l_c) <= 0.05 * l_c, (l_c, l_g)


def test_atlas_on_cuda_equals_cpu_bit_for_bit(cuda):
    """The default bf16 pyramid sums in float64, exactly, so the card's
    build equals the CPU's."""
    grays, _, _ = sequence(4, 7)
    a_c, m_c = build_atlas(t(grays))
    a_g, m_g = build_atlas(t(grays).to(cuda))
    assert torch.equal(a_g.cpu().view(torch.int16), a_c.view(torch.int16))
    assert torch.equal(m_g.cpu(), m_c)


def test_k1_launches_once_per_extract_chunk(cuda):
    grays, depths, _ = sequence(16, 7)
    cam = make_camera(synthetic.FX, synthetic.FY, synthetic.CX, synthetic.CY)
    run = build_offline_pipeline(TrackingOptions(), kf_capacity=8, extract_chunk=5)
    before = detect.launches
    run.pre(cam, t(grays[:12]).to(cuda), t(depths[:12]).to(cuda))
    assert detect.launches - before == 3     # chunks of 5, 5 and 2 frames


def _scan(dev, grays, depths, opts, **kw):
    cam = make_camera(synthetic.FX, synthetic.FY, synthetic.CX, synthetic.CY)
    stats = {}
    _, out = run_scan_pipeline(cam, grays, depths, opts, device=dev, stats=stats, **kw)
    return out, stats


def test_scan_on_cuda_matches_cpu_band(cuda):
    """16 frames with a depth hole (the left 200 columns), a 4-slot ring and
    a 6144-landmark table: both devices triangulate, run local BA and
    compact; RANSAC draws differ between devices, so a band."""
    grays, depths, gt = sequence(16, 7)
    depths = depths.copy()
    depths[:, :, :200] = 0.0
    opts = TrackingOptions(ba_window_size=4)
    kw = dict(kf_capacity=4, lm_capacity=6144)
    o_c, s_c = _scan("cpu", grays, depths, opts, **kw)
    before = detect.launches
    o_g, s_g = _scan(cuda, grays, depths, opts, **kw)
    assert detect.launches - before == 2          # two extract chunks of 8
    tr_c, tr_g = o_c.tracked.numpy(), o_g.tracked.cpu().numpy()
    assert tr_c.sum() >= 14 and tr_g.sum() >= 14
    assert (o_c.is_keyframe.numpy() == o_g.is_keyframe.cpu().numpy()).mean() >= 0.9
    ate_c, _ = ate_of_run(o_c.pose.numpy(), tr_c, gt)
    ate_g, _ = ate_of_run(o_g.pose.cpu().numpy(), tr_g, gt)
    assert ate_g < 0.02 and abs(ate_g - ate_c) <= 0.005, (ate_c, ate_g)
    n_c, n_g = int(o_c.n_landmarks[-1]), int(o_g.n_landmarks[-1])
    assert abs(n_g - n_c) <= 0.1 * n_c, (n_c, n_g)
    assert s_g["compactions"] >= 1 and s_g["ba_iterations"] > 0, s_g


def test_scan_recovers_from_garbage_frames_on_cuda(cuda):
    grays, depths, _ = sequence(25, 11)
    g = grays.copy()
    g[10:13] = 0
    out, _ = _scan(cuda, g, depths, TrackingOptions())
    tracked, states = out.tracked.cpu().numpy(), out.state.cpu().numpy()
    assert not tracked[11] and (states[10:14] != GOOD).any(), states
    assert tracked[-3:].any() and states[-1] == GOOD, states


def test_scan_with_monocular_options_runs_on_cuda(cuda):
    """No depth, every 4th frame, the bench's monocular option set: the
    essential-matrix init with the triangulation viability gate and
    keyframes inheriting their matches' landmarks."""
    grays, depths, _ = sequence(64, 7)
    g = grays[::4]
    d = np.zeros_like(depths[::4])
    opts = TrackingOptions(link_tracked_landmarks=True, min_init_landmarks=25)
    out, stats = _scan(cuda, g, d, opts, kf_capacity=8, lm_capacity=16384)
    assert np.isfinite(out.pose.cpu().numpy()).all()
    # the frame that initializes depends on the RANSAC draws, which differ
    # between devices; the map it starts holds two-view landmarks, so
    # local BA has work
    assert bool(out.tracked.any()) and int(out.is_keyframe.sum()) >= 1, stats
    assert stats["ba_iterations"] > 0, stats


def test_folded_lanes_on_cuda(cuda):
    """Two folded lanes (the sequence and its reverse) on the card: K1 runs
    once per 8 folded frames, lane 0 equals a single card run of its
    frames bit for bit (the solvers' sums add in a fixed order), and both
    lanes lie in a band around the CPU run."""
    grays, depths, gt = sequence(16, 7)
    cam = make_camera(synthetic.FX, synthetic.FY, synthetic.CX, synthetic.CY)
    g2 = np.stack([grays, grays[::-1].copy()])
    d2 = np.stack([depths, depths[::-1].copy()])
    kw = dict(kf_capacity=16)
    before = detect.launches
    _, ob = run_offline_pipeline_batched(cam, g2, d2, TrackingOptions(),
                                         device=cuda, **kw)
    assert detect.launches - before == 4
    _, o1 = run_offline_pipeline(cam, grays, depths, TrackingOptions(),
                                 device=cuda, **kw)
    _, oc = run_offline_pipeline_batched(cam, g2, d2, TrackingOptions(),
                                         device="cpu", **kw)
    for b, gt_b in ((0, gt), (1, gt[::-1])):
        tr = ob.tracked[b].cpu().numpy()
        assert tr.sum() >= 15
        ate, _ = ate_of_run(ob.pose[b].cpu().numpy(), tr, gt_b)
        ate_c, _ = ate_of_run(oc.pose[b].numpy(), oc.tracked[b].numpy(), gt_b)
        assert ate < 0.02 and abs(ate - ate_c) <= 0.005, (b, ate, ate_c)
    assert torch.equal(ob.tracked[0], o1.tracked)
    assert torch.equal(ob.pose[0], o1.pose)


def test_mono_offline_on_cuda(cuda):
    """The monocular offline pipeline with the bench's budget on the card
    (batched essential RANSAC, scale chain, DLT re-track) against the CPU
    run: both draws are noise-bound (tests/test_torch_mono.py), so loose
    bounds."""
    grays, _, gt = sequence(24, 11, 48)
    zero = np.zeros(grays.shape, np.float32)
    cam = make_camera(synthetic.FX, synthetic.FY, synthetic.CX, synthetic.CY)
    kw = dict(kf_capacity=16, mono_pair_hypotheses=64, mono_lo_starts=2,
              mono_sample_bias=64.0, mono_score_top_k=32, monocular=True)
    before = detect.launches
    ms, og = run_offline_pipeline(cam, grays, zero, TrackingOptions(),
                                  device=cuda, **kw)
    assert detect.launches - before == 3
    _, oc = run_offline_pipeline(cam, grays, zero, TrackingOptions(),
                                 device="cpu", **kw)
    assert np.isfinite(og.pose.cpu().numpy()).all()
    assert int(og.n_landmarks) > 0 and int(og.n_keyframes) >= 3
    tr_g, tr_c = og.tracked.cpu().numpy(), oc.tracked.numpy()
    assert tr_g.sum() >= 20 and tr_c.sum() >= 20, (tr_g, tr_c)
    ate_g, _ = ate_of_run(og.pose.cpu().numpy(), tr_g, gt, with_scale=True)
    ate_c, _ = ate_of_run(oc.pose.numpy(), tr_c, gt, with_scale=True)
    assert ate_g < 0.3 and ate_c < 0.3, (ate_g, ate_c)
