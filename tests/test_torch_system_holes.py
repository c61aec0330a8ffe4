"""The benchmark cell ``rgbd.system_disk_holes`` at a size the CPU holds:
fr1/desk as the Kinect records it, with the configuration's hole model in
every depth file (15% of each in 16-pixel squares) and the port's tracking
against the local map (``TrackingOptions.track_local_map``), through
``System --pipeline scan --run_global_ba``, judged by the reference from
the files ``System`` wrote against the cell's own limits. 24 frames taken 8
apart with an 8-slot ring and one pass a window: the ring evicts, keyframe
events triangulate landmarks for the features in holes, local BA iterates
on them, and ``pair_ba`` refines the union map's two-view landmarks with
the port's disparity row.

Also: ``System``'s counts of what the keyframe events did equal the scan's
own; the cell's readers read them and the spans; faults planted in the
written files fail the judge; the local-map match on seeded features; with
the option off (its default, and the hole-free cell's) the scan never runs
the local-map step. On the card (marker ``cuda``): kernels K3 and K4
against their plain versions on a window and a pair taken from a hole run
of the cell."""

import json
import os
import shutil

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import torch_parity  # noqa: F401  (one torch thread per test process)
from slambench import feeds, run, small
from slambench.reference import files
from visionx_slam_torch.models import local_ba as LBA
from visionx_slam_torch.ops.camera import make_camera
from visionx_slam_torch.ops.se3 import Pose, matrix_to_quat, quat_to_matrix
from visionx_slam_torch.tracking import local_map as LM
from visionx_slam_torch.tracking import mapstate as msl
from visionx_slam_torch.tracking import scan_pipeline as SP
from visionx_slam_torch.tracking import stages as ST
from visionx_slam_torch.utils.config import TrackingOptions

CELL = "rgbd.system_disk_holes"
SEED = 2**31 + 91
COUNTS = {"#kf_events": "kf_events", "#lba_iterations": "ba_iterations",
          "#tri_landmarks": "tri_landmarks",
          "#localmap_matches": "localmap_matches"}
READERS = ("scan_ms.holes", "kf_ms.holes", "lba_ms.holes", "gba_ms.holes",
           "lba_iters.holes", "localmap_ms.holes", "k3_roofline.holes",
           "k4_roofline.holes")


def small_spec() -> dict:
    spec = run.load_cell(CELL)
    spec["traffic"] = dict(spec["traffic"], frames=24, frame_stride=8,
                           min_passes=1, system={"kf_capacity": 8})
    return spec


def _feed_class(made: list):
    """The cell's feed, keeping itself and every pass's summary, with
    ``System``'s clock kept in the feed's ``timings`` on every pass."""
    base = feeds.load("system_disk")

    class Kept(base):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.summaries = []
            made.append(self)

        def one_pass(self, timings=None, before=None):
            s, out = super().one_pass(self.timings, before)
            self.summaries.append(s)
            return s, out

    return Kept


@pytest.fixture(scope="module")
def cell():
    """(the harness's result, the feed it ran, the limits) of one small
    run on the CPU."""
    spec = small_spec()
    made = []
    load, kept = feeds.load, _feed_class(made)
    feeds.load = lambda kind: kept
    try:
        out = small.run(spec, SEED, 0.1)
    finally:
        feeds.load = load
    return out, made[0], spec["limits"]


def test_a_small_run_is_correct_and_every_stage_does_work(cell):
    out, feed, limits = cell
    assert out["correct"] is True, out["checks"]
    assert set(out["checks"]) == set(limits) and out["failed"] == 0
    assert out["checks"]["gba_obs_depth_p99_mm"]["value"] < 7.0
    summary, path = feed.outs[-1]
    stats, g = summary["scan_stats"], summary["global_ba"]
    assert summary["n_tracked"] == 24 and g["archived_keyframes"] > 8
    # local BA iterated, triangulation made landmarks, the local map matched
    assert stats["ba_iterations"] > 0 and stats["tri_landmarks"] > 0
    assert stats["localmap_matches"] > 0
    # the union map holds two-view landmarks, which the solve moved
    m = files.read_map(os.path.join(path, "map_snapshot.npz"))
    lm = m["kf_feat_lm"][(m["kf_id"] >= 0)[:, None] & m["kf_fvalid"]]
    assert (np.bincount(lm[lm >= 0]) == 2).sum() > 100
    assert g["mean_reproj_after_px"] != g["mean_reproj_before_px"]


def test_the_counts_are_the_scans_own(cell):
    """``System`` adds the scan's counters into ``timings`` once a run and
    into the run's ``stage_timings``."""
    _, feed, _ = cell
    assert len(feed.summaries) == 2            # the warm pass and the window's
    for key, name in COUNTS.items():
        runs = [s["scan_stats"][name] for s in feed.summaries]
        assert feed.timings[key] == sum(runs), key
        assert [s["stage_timings"][key] for s in feed.summaries] == runs, key
    assert feed.timings["#kf_events"] > 0
    assert all(s["scan_stats"]["lba_kernel"] == 0     # no K3 on the CPU
               for s in feed.summaries)


@pytest.mark.parametrize("metric", READERS)
def test_the_cells_readers(cell, metric):
    """Each reader reads its span or counts from ``timings``; the kernels'
    shares give None where the run traced no device (here the CPU); every
    reader gives None without its keys."""
    _, feed, _ = cell
    frames = 24 * len(feed.summaries)
    ctx = dict(timings=dict(feed.timings), frames=frames, trace=None,
               traced_frames=0, atlas=(1896, 640), window_frames=frames)
    got = run.reader(metric)(ctx)
    t = feed.timings
    want = {"scan_ms.holes": 1e3 * t.get("scan", 0) / frames,
            "kf_ms.holes": 1e3 * t.get("scan/kf", 0) / frames,
            "lba_ms.holes": 1e3 * t.get("scan/lba", 0) / frames,
            "gba_ms.holes": 1e3 * t.get("gba", 0) / frames,
            "localmap_ms.holes": 1e3 * t.get("scan/localmap", 0) / frames,
            "lba_iters.holes": t["#lba_iterations"] / t["#kf_events"]}
    if metric in want:
        assert got == pytest.approx(want[metric], rel=1e-12) and got > 0
    else:
        assert got is None
    empty = dict(ctx, timings={})
    assert run.reader(metric)(empty) is None


class _Event:
    def __init__(self, name, start_us, end_us, device_type):
        self.name, self.device_type = name, device_type
        self.time_range = type("R", (), dict(start=start_us, end=end_us))


def test_the_kernel_shares_read_the_trace():
    """``k3_roofline.holes`` and ``k4_roofline.holes`` find the harness's
    finished trace up the call stack and hold the traced kernels' time
    against ``slambench/kernels.py``'s bound of a call: K3's at the mean
    iterations of the untraced passes' calls."""
    from torch.autograd import DeviceType

    from slambench import kernels, yardstick
    from slambench.trace import Trace

    cuda, cpu = DeviceType.CUDA, DeviceType.CPU
    tr = Trace(torch.device("cpu"))
    tr.done = True
    events = [_Event("void local_ba_kernel<true>(Args)", 0, 160, cuda),
              _Event("void local_ba_kernel<true>(Args)", 500, 660, cuda),
              _Event("void triangulate_kernel<true>(Args)", 700, 712, cuda),
              _Event("local_ba_kernel", 0, 1000, cpu)]     # the host's, not counted
    tr.prof = type("P", (), dict(events=lambda self: events))()
    ctx = dict(timings={"#kf_events": 10, "#lba_iterations": 25}, frames=1,
               trace=None, traced_frames=1, atlas=(1896, 640), window_frames=1)
    k3 = run.reader("k3_roofline.holes")(ctx)
    k4 = run.reader("k4_roofline.holes")(ctx)
    bound3 = yardstick.bound_ms(kernels.k3_bytes(64, 5, 1024),
                                kernels.k3_ops(5, 1024, 2.5))
    bound4 = yardstick.bound_ms(kernels.k4_bytes(1024), kernels.k4_ops(1024))
    assert k3 == pytest.approx(100 * 2 * bound3 / 1e3 / 320e-6, rel=1e-12)
    assert k4 == pytest.approx(100 * bound4 / 1e3 / 12e-6, rel=1e-12)
    assert 0 < k3 < 100 and 0 < k4 < 100
    # the copies are the program's arithmetic
    from visionx_slam_torch.utils import flops
    assert kernels.k3_bytes(64, 5, 1024) == flops.k3_bytes(64, 5, 1024)
    assert kernels.k3_ops(5, 1024, 3) == flops.k3_ops(5, 1024, 3)
    assert kernels.k4_bytes(1024) == flops.k4_bytes(1024)
    assert kernels.k4_ops(1024) == flops.k4_ops(1024)
    # no trace up the stack, or no count of the events: nothing to read
    del tr
    assert run.reader("k3_roofline.holes")(ctx) is None
    assert run.reader("k4_roofline.holes")(ctx) is None


def _judged(feed, plant) -> dict:
    """The reference's numbers with ``plant(dir)`` applied to a copy of the
    last pass's output directory."""
    summary, path = feed.outs[-1]
    broken = path + "_broken"
    shutil.rmtree(broken, ignore_errors=True)
    shutil.copytree(path, broken)
    plant(broken)
    outs = feed.outs
    feed.outs = [(summary, broken)]
    try:
        return feed.judge()
    finally:
        feed.outs = outs


def _move_landmarks(d):
    """2% of the live landmarks 1 m further along the ray from the first
    keyframe that observes each."""
    p = os.path.join(d, "map_snapshot.npz")
    with np.load(p) as z:
        arrs = {k: z[k] for k in z.files}
    m = {k: arrs[k] for k in files.MAP_FIELDS}
    used = m["kf_id"] >= 0
    lm = m["kf_feat_lm"][used]
    seen = np.unique(lm[(lm >= 0) & m["kf_fvalid"][used]])
    seen = seen[m["lm_alive"][seen]]
    pick = np.random.default_rng(0).choice(seen, max(1, len(seen) // 50),
                                           replace=False)
    R = files.quat_to_R(m["kf_q"][used].astype(np.float64))
    centre = -np.einsum("kji,kj->ki", R, m["kf_t"][used].astype(np.float64))
    pos = arrs["lm_pos"].astype(np.float64)
    for lid in pick:
        k = np.argwhere(lm == lid)[0, 0]
        ray = pos[:, lid] - centre[k]
        pos[:, lid] += ray / np.linalg.norm(ray)
    arrs["lm_pos"] = pos.astype(arrs["lm_pos"].dtype)
    np.savez_compressed(p, **arrs)


def _edit_rows(name, edit):
    def plant(d):
        p = os.path.join(d, name)
        lines = open(p).read().splitlines()
        rows = [i for i, line in enumerate(lines) if not line.startswith("#")]
        edit(lines, rows)
        with open(p, "w") as f:
            f.write("\n".join(lines) + "\n")
    return plant


def _shift(lines, rows):
    i = rows[len(rows) // 2]
    v = lines[i].split()
    v[1] = f"{float(v[1]) + 1.0:.6f}"
    lines[i] = " ".join(v)


FAULTS = {
    "landmarks_moved_1m": (_move_landmarks, "gba_obs_depth_p99_mm"),
    "keyframe_moved_1m": (_edit_rows("trajectory_keyframes_gba.txt", _shift),
                          "gba_ate_mm"),
    "row_dropped": (_edit_rows("trajectory.txt",
                               lambda lines, rows: lines.pop(rows[5])),
                    "lost_frames"),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_fault_in_the_files_fails_its_limit(cell, fault):
    _, feed, limits = cell
    plant, key = FAULTS[fault]
    assert feed.judge()[key] <= limits[key]["limit"]
    nums = _judged(feed, plant)
    assert nums[key] > limits[key]["limit"], (key, nums[key])


def test_the_configurations_differ_in_the_holes_and_the_fix_alone():
    """The hole-free cell runs the reference's tracking (``TrackingOptions()``,
    the local map off), and the hole cell's configuration is the hole-free
    one with the holes in, the cut taken out of ``reduced``, and the fix."""
    with_holes, without = (run.load_cell(c)["config"]
                           for c in (CELL, "rgbd.system_disk"))
    assert TrackingOptions(**without["tracking_options"]) == TrackingOptions()
    assert TrackingOptions().track_local_map is False
    assert TrackingOptions(**with_holes["tracking_options"]) == TrackingOptions(
        track_local_map=True)
    assert without["depth_holes"]["share"] == 0.0
    assert with_holes["depth_holes"] == {"share": 0.15, "blob_px": 16}
    assert set(without["reduced"]) - set(with_holes["reduced"]) == {"depth_holes"}
    same = {"name", "source", "depth_holes", "tracking_options", "reduced",
            "assumed"}
    assert {k: v for k, v in with_holes.items() if k not in same} == {
        k: v for k, v in without.items() if k not in same}


# ---------------------------------------------------------------------------
# the local-map step on seeded features
# ---------------------------------------------------------------------------

CAM = make_camera(500.0, 500.0, 320.0, 240.0)
IMG = (640, 480)


def _seeded(N=32, K=8, L=256, seed=4):
    """A map whose slots 2..5 hold keyframes with N features each, every
    feature linked to its own landmark in front of the camera, and a frame
    at the identity that sees the landmarks of slots 2 and 3 at their
    projections (the features of slot 2 with their descriptors, those of
    slot 3 with 60 of their bits flipped) and slot 5's landmarks too (its
    keyframe's own, which the local map leaves to the keyframe PnP)."""
    rng = np.random.default_rng(seed)
    ms = msl.empty_map(K, L, N)
    pose = Pose(torch.tensor([1.0, 0, 0, 0]), torch.zeros(3))
    pts = np.stack([rng.uniform(-1, 1, 4 * N), rng.uniform(-0.8, 0.8, 4 * N),
                    rng.uniform(2, 4, 4 * N)], -1).astype(np.float32)
    ms.lm_pos[:, :4 * N] = torch.from_numpy(pts.T)
    ms.lm_alive[:4 * N] = True
    desc = rng.integers(0, 256, (4, N, 32), dtype=np.uint8)
    for k in range(4):
        slot = 2 + k
        ms.kf_id[slot] = k
        ms.kf_fvalid[slot] = True
        ms.kf_feat_lm[slot] = torch.arange(k * N, (k + 1) * N, dtype=torch.int32)
        ms.kf_desc[slot] = torch.from_numpy(desc[k])
    uv = torch.from_numpy(pts[:, :2] / pts[:, 2:]) * 500.0 + torch.tensor([320.0, 240.0])
    flipped = desc[1].copy()
    flipped[:, :8] ^= 0xFF          # 64 bits flipped: past MAX_HAMMING
    frame_desc = np.concatenate([desc[0], flipped, desc[3]])
    px = torch.cat([uv[:N], uv[N:2 * N], uv[3 * N:]]).float()
    return ms, pose, px, torch.from_numpy(frame_desc), N


def test_the_local_map_match_on_seeded_features():
    ms, pose, px, desc, N = _seeded()
    bits, pop = SP.matching.unpack_with_pop(desc)
    valid = torch.ones(len(px), dtype=torch.bool)
    used = torch.zeros(len(px), dtype=torch.bool)
    used[5] = True                     # taken by the keyframe PnP
    taken = torch.zeros(ms.lm_physical, dtype=torch.bool)
    taken[3 * N:4 * N] = True          # the keyframe's own landmarks
    taken[7] = True
    X, uv, acc = LM.search(ms, CAM, pose, px, valid, bits, pop, 2, 4, used,
                           taken, IMG)
    rows = torch.arange(4 * N)
    # slot 2: each landmark at its own feature, but for feature 5 (used) and
    # landmark 7 (the keyframe's); slot 3: too far in Hamming distance;
    # slot 4: nothing in the frame; slot 5: the keyframe's, taken
    assert torch.equal(acc, (rows < N) & (rows != 5) & (rows != 7))
    j = torch.where(acc)[0]
    assert torch.equal(uv[j], px[j])
    assert torch.equal(X[j], ms.lm_pos[:, j].T)


def test_the_local_map_refines_a_perturbed_pose():
    """From a pose 1 cm and 0.3 degrees off, the union of the keyframe
    PnP's inliers (none here) and the local map's matches brings it back."""
    ms, truth, px, desc, N = _seeded(N=64)
    bits, pop = SP.matching.unpack_with_pop(desc)
    a = np.radians(0.3)
    R = torch.tensor([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0],
                      [0, 0, 1]], dtype=torch.float32)
    off = Pose(matrix_to_quat(R), torch.tensor([0.01, -0.005, 0.0]))
    n = len(px)
    none = torch.zeros(n, dtype=torch.bool)
    pose, got = LM.track_local_map(
        ms, CAM, off, px, torch.ones(n, dtype=torch.bool), bits, pop,
        torch.zeros(n, 3), torch.zeros(n, 2), none, torch.zeros(n, dtype=torch.long),
        torch.full((n,), -1, dtype=torch.int32), 2, 3, IMG, 2.0)
    assert int(got) >= N // 2
    assert float(torch.linalg.norm(pose.t - truth.t)) < 1e-4
    assert torch.allclose(quat_to_matrix(pose.q), torch.eye(3), atol=1e-5)


class _HostReads(TorchDispatchMode):
    """The operations that read the device on a CUDA stream, seen on the
    CPU: a scalar read, a tensor from host data, a boolean mask as an
    index, ``nonzero``."""

    READS = {torch.ops.aten._local_scalar_dense.default,
             torch.ops.aten.lift_fresh.default, torch.ops.aten.nonzero.default,
             torch.ops.aten.masked_select.default}

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in self.READS:
            self.n += 1
        elif func in (torch.ops.aten.index.Tensor, torch.ops.aten.index_put_.default):
            self.n += any(i is not None and i.dtype == torch.bool for i in args[1])
        return func(*args, **(kwargs or {}))


def test_the_local_map_reads_nothing_from_the_device():
    ms, pose, px, desc, N = _seeded()
    bits, pop = SP.matching.unpack_with_pop(desc)
    n = len(px)
    # slots 7, 0, 1, 2, 3 of the ring: its end, then its start
    args = (ms, CAM, pose, px, torch.ones(n, dtype=torch.bool), bits, pop,
            torch.zeros(n, 3), px, torch.zeros(n, dtype=torch.bool),
            torch.arange(n), torch.full((n,), -1, dtype=torch.int32), 7, 5,
            IMG, 2.0)
    with _HostReads() as mode:
        _, got = LM.track_local_map(*args)
    assert mode.n == 0
    assert int(got) == N


def test_the_scan_runs_the_local_map_only_when_asked(cell, monkeypatch):
    """With the option at its default the step never calls the local-map
    step (the reference's tracking, bit for bit as the JAX parity tests
    hold it); with it on, every frame tracked by PnP past the first
    keyframe does."""
    _, feed, _ = cell
    g = torch.as_tensor(feed.g[:6])
    d = torch.from_numpy(np.where(feed._holes(feed.d[:6].shape), 0.0,
                                  feed.d[:6]).astype(np.float32))
    calls = []
    real = LM.track_local_map

    def spy(*a, **k):
        calls.append(a[12])            # the first slot of the window
        return real(*a, **k)

    monkeypatch.setattr(LM, "track_local_map", spy)
    runs = {}
    for on in (False, True):
        stats = {}
        _, out = SP.run_scan_pipeline(
            feed.cam, g, d, TrackingOptions(track_local_map=on), device="cpu",
            kf_capacity=8, stats=stats)
        runs[on] = (len(calls), stats, out)
        calls.clear()
    n_off, s_off, _ = runs[False]
    n_on, s_on, out_on = runs[True]
    assert n_off == 0 and s_off["localmap_matches"] == 0
    # every frame after the initial pair tracked by PnP, none before
    assert 0 < n_on <= int(out_on.tracked.sum()) - 2
    assert s_on["localmap_matches"] > 0


# ---------------------------------------------------------------------------
# on the card: K3 and K4 on a window and a pair of the hole run
# ---------------------------------------------------------------------------

TOL_Q = 1e-5
TOL_T = 1e-5
TOL_P = 1e-4


def _clone(ms):
    return type(ms)(*(x.clone() for x in ms))


@pytest.fixture(scope="module")
def hole_run():
    """(camera, the maps handed to local BA, the (map, slots, match)
    handed to triangulation) over the small cell's pass on the card, each
    map copied as it was before the call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    LBA.build_lba_kernel()
    ST.build_tri_kernel()
    spec = small_spec()
    feed = feeds.load("system_disk")(spec["config"], spec["traffic"], SEED,
                                     "cuda")
    windows, pairs, cams = [], [], []
    real_lba, real_tri = SP.local_ba, ST.triangulate_pair

    def spy_lba(ms, cam, opts):
        windows.append((_clone(ms), opts))
        cams.append(cam)
        return real_lba(ms, cam, opts)

    def spy_tri(ms, cam, a, b, angle, gate, res=None):
        pairs.append((_clone(ms), a, b, type(res)(*(x.clone() for x in res)),
                      angle, gate))
        return real_tri(ms, cam, a, b, angle, gate, res=res)

    SP.local_ba, ST.triangulate_pair = spy_lba, spy_tri
    try:
        feed.write()
        feed.one_pass()
    finally:
        SP.local_ba, ST.triangulate_pair = real_lba, real_tri
    return cams[0], windows, pairs


@pytest.mark.cuda
def test_k3_matches_plain_on_a_hole_window(hole_run):
    cam, windows, _ = hole_run
    # the window whose plain solve iterates most
    its = [int(LBA._local_ba_plain(_clone(ms), cam, o)[1].iterations)
           for ms, o in windows]
    ms, opts = windows[int(np.argmax(its))]
    assert max(its) >= 1
    k, sk = LBA.local_ba(_clone(ms), cam, opts)
    p, sp = LBA._local_ba_plain(_clone(ms), cam, opts)
    assert int(sk.iterations) == int(sp.iterations) == max(its)
    assert int(sk.total_obs) == int(sp.total_obs)
    np.testing.assert_allclose(k.kf_q.cpu(), p.kf_q.cpu(), atol=TOL_Q, rtol=0)
    np.testing.assert_allclose(k.kf_t.cpu(), p.kf_t.cpu(), atol=TOL_T, rtol=0)
    np.testing.assert_allclose(k.lm_pos.cpu(), p.lm_pos.cpu(), atol=TOL_P,
                               rtol=0, equal_nan=True)
    for f in ms._fields:
        if f not in ("kf_q", "kf_t", "lm_pos"):
            assert torch.equal(getattr(k, f), getattr(p, f)), f


@pytest.mark.cuda
def test_k4_matches_plain_on_a_hole_pair(hole_run):
    cam, _, pairs = hole_run
    made = [int(ST._triangulate_pair_plain(_clone(ms), cam, a, b, an, g, r).next_lm)
            - int(ms.next_lm) for ms, a, b, r, an, g in pairs]
    ms, a, b, res, angle, gate = pairs[int(np.argmax(made))]
    assert max(made) > 0
    k = ST.triangulate_pair(_clone(ms), cam, a, b, angle, gate, res=res)
    p = ST._triangulate_pair_plain(_clone(ms), cam, a, b, angle, gate, res)
    for f in ms._fields:
        if f != "lm_pos":
            assert torch.equal(getattr(k, f), getattr(p, f)), f
    new = p.lm_alive & ~ms.lm_alive
    assert int(new.sum()) == max(made)
    assert torch.equal(k.lm_pos[:, ~new], p.lm_pos[:, ~new])
    # within 1e-4 of each new point's distance (at least 1 m) from camera a
    c = -ST.quat_rotate(torch.cat([ms.kf_q[a, :1], -ms.kf_q[a, 1:]]), ms.kf_t[a])
    scale = torch.linalg.norm(p.lm_pos[:, new].T - c, dim=-1).clamp(min=1.0)
    err = torch.abs(k.lm_pos[:, new] - p.lm_pos[:, new]).max(0).values / scale
    assert float(err.max()) <= TOL_P
