"""Kernel K3 (``csrc/local_ba.cu``), a whole ``local_ba`` call in one
launch, and its plain version ``_local_ba_plain``.

On the CPU (tier-1): K3's view of the map (its int64 layout) and what the
wrapper refuses; that a CPU call runs the plain version, never launches K3,
and records K3's analytic work (``utils/flops.py``: ``k3_ops``,
``k3_bytes``) in place of its plain ops. The plain version itself is held to
the JAX package by ``tests/test_torch_local_ba.py``.

On the card (marker ``cuda``; no jax in this file): K3 against the plain
version on windows taken from a real scan (the synthetic sequence with no
depth in the left 200 columns, so that triangulated landmarks with two
views give the point pass work): the first window (fewer than five
keyframes), a full one, a disabled one (no eligible landmark, and one with a
single keyframe: a no-op), one that converges at its first iteration, one
with dead landmarks, the padding bucket (the last landmark row, which
features without a landmark read, set far off and to NaN), and the masked
variant (``early_exit`` off). Iterations and the observation count agree
exactly; the final cost within ``TOL_COST`` relative; window poses within
``TOL_Q`` and ``TOL_T``; landmark positions within ``TOL_P`` metres; every
other table bit for bit. K3 adds its sums in another order than the plain
version (the pose pass's 6x6 normal equations by chunks and a shuffle tree
where the plain version runs cuBLAS' batched GEMM; its per-feature blocks
with the compiler's fused multiply-adds), so the two agree to float32
rounding carried through at most five alternating iterations: the pose
tolerances are those of K2's (``tests/test_torch_gn_kernel.py``), and a
landmark seen by two keyframes a few centimetres apart is a poorly
conditioned 3x3 system that amplifies that rounding along its ray, hence
``TOL_P`` (the largest readings on an H100, ``chip_smoke.check_lba``'s
windows: 2.8e-7 on the poses, 7.0e-6 m on the positions). Two runs of K3
are bit-equal, and a ``System`` scan pass on CUDA makes one K3 launch a
keyframe event and no plain call. K3 takes every size the plain version
takes up to its wrapper's limits: a window of 5 x 4,096 features (sort keys
past shared memory, in the workspace) and one of 40 keyframes (more than a
warp's worth of window slots) agree with the plain version as above.
"""

import numpy as np
import pytest
import torch

from visionx_slam_torch.data import synthetic
from visionx_slam_torch.models import local_ba as LBA
from visionx_slam_torch.ops.camera import make_camera
from visionx_slam_torch.tracking import mapstate as msl
from visionx_slam_torch.tracking import scan_pipeline as SP
from visionx_slam_torch.utils import flops
from visionx_slam_torch.utils.config import TrackingOptions

from torch_parity import sequence

CAM = make_camera(synthetic.FX, synthetic.FY, synthetic.CX, synthetic.CY)
BA = SP.tracking_ba_options(TrackingOptions())
TOL_Q = 1e-5
TOL_T = 1e-5
TOL_P = 1e-4
TOL_COST = 1e-4
HOLE_COLS = 200


def _map(K=8, L=64, N=16, device="cpu"):
    return msl.empty_map(K, L, N, device)


# ---------------------------------------------------------------------------
# CPU: K3's layout and checks, the plain version's dispatch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("K, window, opts, want", [
    # the scan's options: early exit on
    (8, 5, BA, [8, 16, 80, 5, 5, 20, 2, 1]),
    # the module default: the masked loop
    (8, 5, LBA.BAOptions(), [8, 16, 80, 5, 5, 20, 2, 0]),
    # a window wider than the ring takes every slot
    (3, 3, LBA.BAOptions(window_size=9, max_iterations=2), [3, 16, 80, 3, 2, 20, 2, 0]),
    # no iteration
    (8, 1, LBA.BAOptions(window_size=1, max_iterations=0), [8, 16, 80, 1, 0, 20, 2, 0]),
])
def test_k3_layout(K, window, opts, want):
    ms = _map(K=K)
    W = min(max(1, opts.window_size), K)
    assert W == window
    assert LBA._k3_layout(ms, opts, W) == want


@pytest.mark.parametrize("edit", ["float64_pose", "int64_links", "px_shape",
                                  "strided_positions", "window", "rows"])
def test_k3_layout_refuses(edit, monkeypatch):
    ms, W = _map(K=40), 5
    if edit == "float64_pose":
        ms = ms._replace(kf_q=ms.kf_q.double())
    elif edit == "int64_links":
        ms = ms._replace(kf_feat_lm=ms.kf_feat_lm.long())
    elif edit == "px_shape":
        ms = ms._replace(kf_px=torch.zeros(40, 3, 16))
    elif edit == "strided_positions":   # K3 writes the table in place
        ms = ms._replace(lm_pos=ms.lm_pos.T.contiguous().T)
    elif edit == "window":
        ms, W = _map(K=LBA._K3_MAX_WINDOW + 8), LBA._K3_MAX_WINDOW + 1
    else:                                # 5 x 4096 features past the limit
        monkeypatch.setattr(LBA, "_K3_MAX_ROWS", 5 * 4096 - 1)
        ms = _map(K=8, N=4096)
    with pytest.raises(ValueError):
        LBA._k3_layout(ms, BA, W)


def _window_map(K=6, n_kf=3, L=96, N=48, step=0.05):
    """A map with ``n_kf`` keyframes ``step`` metres apart observing shared
    landmarks, from a fixed seed: enough for the plain version to iterate
    (the default a small one)."""
    rng = np.random.default_rng(3)
    ms = msl.empty_map(K, L, N)
    pts = np.stack([rng.uniform(-1, 1, L), rng.uniform(-1, 1, L),
                    rng.uniform(2, 4, L)], -1)
    ms.lm_pos[:, :L] = torch.tensor(pts.T, dtype=torch.float32)
    ms.lm_alive[:L] = True
    for k in range(n_kf):
        t = np.array([step * k, 0.0, 0.0])
        lm = rng.choice(L, N, replace=False)
        pc = pts[lm] + t
        px = np.stack([CAM.fx * pc[:, 0] / pc[:, 2] + CAM.cx,
                       CAM.fy * pc[:, 1] / pc[:, 2] + CAM.cy], -1)
        px = px + rng.normal(0, 0.5, px.shape)
        ms.kf_id[k] = k
        ms.kf_t[k] = torch.tensor(t + rng.normal(0, 0.005, 3), dtype=torch.float32)
        ms.kf_px[k] = torch.tensor(px.T, dtype=torch.float32)
        ms.kf_fvalid[k] = True
        ms.kf_feat_lm[k] = torch.tensor(lm, dtype=torch.int32)
        ms.lm_obs.index_add_(0, torch.tensor(lm), torch.ones(N, dtype=torch.int32))
    return ms


def _clone(ms):
    return type(ms)(*(x.clone() for x in ms))


def test_cpu_local_ba_runs_the_plain_version_and_records_k3_work():
    """A CPU call never launches K3, gives what ``_local_ba_plain`` gives
    bit for bit, and counts K3's analytic work once (its plain ops not at
    all)."""
    ms = _window_map()
    opts = BA._replace(min_pose_observations=10)
    before = LBA.lba_launches
    a, sa = LBA.local_ba(_clone(ms), CAM, opts)
    b, sb = LBA._local_ba_plain(_clone(ms), CAM, opts)
    assert LBA.lba_launches == before
    assert int(sa.iterations) > 0 and sa.host_reads > 0
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert torch.equal(sa.final_cost, sb.final_cost)
    got = flops.op_cost(LBA.local_ba, _clone(ms), CAM, opts)
    W = min(opts.window_size, ms.kf_capacity)
    assert got == {"flops": float(flops.k3_ops(W, ms.n_features, opts.max_iterations)),
                   "bytes": float(flops.k3_bytes(ms.kf_capacity, W, ms.n_features))}


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    LBA.build_lba_kernel()
    return torch.device("cuda")


@pytest.fixture(scope="module")
def windows(cuda):
    """The maps the scan hands to local BA over 48 frames of the hole
    sequence, each copied as it was before the call."""
    grays, depths, _ = sequence(48, 7)
    d = torch.as_tensor(depths).clone()
    d[:, :, :HOLE_COLS] = 0.0
    seen = []
    real = SP.local_ba

    def spy(ms, cam, opts):
        seen.append(_clone(ms))
        return real(ms, cam, opts)

    SP.local_ba = spy
    try:
        SP.run_scan_pipeline(CAM, torch.as_tensor(grays).to(cuda), d.to(cuda),
                             TrackingOptions(), device="cuda")
    finally:
        SP.local_ba = real
    assert len(seen) >= 6
    return seen


def _alive(ms):
    return int(msl.kf_alive(ms).sum())


def _case(windows, name):
    """(map, options) of a named case."""
    first = windows[0]
    full = next(ms for ms in windows if _alive(ms) >= 8)
    opts = BA
    if name == "first":
        assert 2 <= _alive(first) < BA.window_size
        return _clone(first), opts
    ms = _clone(full)
    Lp = ms.lm_physical
    if name == "disabled":            # no eligible landmark
        opts = BA._replace(min_point_observations=10 ** 6)
    elif name == "one_keyframe":      # a single valid keyframe
        keep = int(torch.argmax(ms.kf_id))
        ms.kf_id[torch.arange(ms.kf_capacity, device=ms.kf_id.device) != keep] = -1
    elif name == "converge_first":    # |last - cost| < 2 last at once
        opts = BA._replace(rel_tol=2.0)
    elif name == "dead":              # every other landmark of the table dies
        ms.lm_alive[::2] = False
    elif name == "padding_far":
        ms.lm_pos[:, Lp - 1] = torch.tensor([1e3, -1e3, 3.0])
    elif name == "padding_nan":       # poisons every pose's step, no point's
        ms.lm_pos[:, Lp - 1] = float("nan")
    elif name == "masked":
        opts = BA._replace(early_exit=False)
    else:
        assert name == "full"
    return ms, opts


CASES = ["first", "full", "disabled", "one_keyframe", "converge_first", "dead",
         "padding_far", "padding_nan", "masked"]


def _both(ms, opts):
    before = LBA.lba_launches
    k, sk = LBA.local_ba(_clone(ms), CAM, opts)
    assert LBA.lba_launches == before + 1 and sk.host_reads == 0
    p, sp = LBA._local_ba_plain(_clone(ms), CAM, opts)
    return (k, sk), (p, sp)


@pytest.mark.cuda
@pytest.mark.parametrize("name", CASES)
def test_k3_matches_plain(windows, name):
    ms, opts = _case(windows, name)
    (k, sk), (p, sp) = _both(ms, opts)
    assert int(sk.iterations) == int(sp.iterations)
    assert int(sk.total_obs) == int(sp.total_obs)
    ck, cp = float(sk.final_cost), float(sp.final_cost)
    assert (np.isnan(ck) and np.isnan(cp)) or abs(ck - cp) <= TOL_COST * abs(cp), (ck, cp)
    np.testing.assert_allclose(k.kf_q.cpu(), p.kf_q.cpu(), atol=TOL_Q, rtol=0)
    np.testing.assert_allclose(k.kf_t.cpu(), p.kf_t.cpu(), atol=TOL_T, rtol=0)
    np.testing.assert_allclose(k.lm_pos.cpu(), p.lm_pos.cpu(), atol=TOL_P, rtol=0,
                               equal_nan=True)
    for f in ms._fields:
        if f not in ("kf_q", "kf_t", "lm_pos"):
            assert torch.equal(getattr(k, f), getattr(p, f)), f
    if name in ("disabled", "one_keyframe"):   # a no-op
        assert int(sk.iterations) == 0
        for x, y in zip(k, ms):
            assert torch.equal(x, y)
    elif name == "converge_first":
        assert int(sk.iterations) == 1
    else:
        assert int(sk.iterations) >= 1
    pad = ms.lm_physical - 1
    if name == "padding_far":   # the padding row keeps its value
        assert torch.equal(k.lm_pos[:, pad], ms.lm_pos[:, pad])
    elif name == "padding_nan":   # no pose moved, the landmarks did
        assert bool(torch.isnan(k.lm_pos[:, pad]).all())
        assert torch.equal(k.kf_t, ms.kf_t)
        assert not torch.equal(k.lm_pos[:, :pad], ms.lm_pos[:, :pad])


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["rows", "window"])
def test_k3_matches_plain_at_any_size(cuda, shape):
    """Sizes past the shared-memory sort: 5 keyframes x 4,096 features
    (20,480 sort keys, in the workspace), and a window of 40 keyframes; no
    convergence test (``rel_tol`` 0), so both run every iteration."""
    # baselines of 0.3 and 0.03 m a keyframe: the plain version in float32
    # and in float64 differ by at most 6.1e-6 and 1.1e-6 m on the positions
    if shape == "rows":
        ms, W = _window_map(K=8, n_kf=5, L=6000, N=4096, step=0.3), 5
    else:
        ms, W = _window_map(K=48, n_kf=40, L=200, N=64, step=0.03), 40
    ms = type(ms)(*(x.to(cuda) for x in ms))
    opts = BA._replace(window_size=W, rel_tol=0.0)
    (k, sk), (p, sp) = _both(ms, opts)
    assert int(sk.iterations) == int(sp.iterations) == opts.max_iterations
    assert int(sk.total_obs) == int(sp.total_obs) > 0
    ck, cp = float(sk.final_cost), float(sp.final_cost)
    assert abs(ck - cp) <= TOL_COST * abs(cp), (ck, cp)
    np.testing.assert_allclose(k.kf_q.cpu(), p.kf_q.cpu(), atol=TOL_Q, rtol=0)
    np.testing.assert_allclose(k.kf_t.cpu(), p.kf_t.cpu(), atol=TOL_T, rtol=0)
    np.testing.assert_allclose(k.lm_pos.cpu(), p.lm_pos.cpu(), atol=TOL_P, rtol=0)
    assert not torch.equal(k.lm_pos, ms.lm_pos)
    for f in ms._fields:
        if f not in ("kf_q", "kf_t", "lm_pos"):
            assert torch.equal(getattr(k, f), getattr(p, f)), f


@pytest.mark.cuda
def test_k3_repeats_bit_for_bit(windows):
    ms, opts = _case(windows, "full")
    a, sa = LBA.local_ba(_clone(ms), CAM, opts)
    b, sb = LBA.local_ba(_clone(ms), CAM, opts)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    for x, y in zip(sa[:3], sb[:3]):
        assert torch.equal(x.view(torch.int32), y.view(torch.int32))


@pytest.mark.cuda
def test_system_scan_launches_k3_once_an_event(cuda, tmp_path, monkeypatch):
    """A ``System`` scan pass on CUDA: one K3 launch a keyframe event
    (``lba_kernel`` equals the events) and no plain call on the card."""
    from visionx_slam_torch.system.system import System
    from visionx_slam_torch.utils.config import SystemConfig

    plain_devices = []
    real = LBA._local_ba_plain

    def spy(ms, *a, **k):
        plain_devices.append(ms.kf_q.device.type)
        return real(ms, *a, **k)

    monkeypatch.setattr(LBA, "_local_ba_plain", spy)
    synthetic.generate_sequence(str(tmp_path / "seq"), n_frames=40, seed=5)
    before = LBA.lba_launches
    summary = System(SystemConfig(
        dataset_dir=str(tmp_path / "seq"), output_dir=str(tmp_path / "out"),
        sequence="rgbd_dataset_freiburg3_synthetic", pipeline="scan",
        kf_capacity=8, loader="python", device="cuda")).run()
    stats = summary["scan_stats"]
    assert stats["kf_events"] > 0
    assert stats["lba_kernel"] == stats["kf_events"] == LBA.lba_launches - before
    assert plain_devices == []
