"""Kernel K4 (``csrc/triangulate.cu``), a whole ``triangulate_pair`` call
after the match in one launch, and its plain version
``_triangulate_pair_plain``.

On the CPU (tier-1): K4's view of the map (its int64 layout) and what the
wrapper refuses; that a CPU call runs the plain version, never launches K4,
and records K4's analytic work (``utils/flops.py``: ``k4_ops``,
``k4_bytes``) in place of its plain ops. The plain version itself is held to
the JAX package by ``tests/test_torch_mapstate.py``.

On the card (marker ``cuda``; no jax in this file): K4 against the plain
version on the keyframe pairs a real scan triangulates (the synthetic
sequence with no depth in the left 200 columns, so that features there get
their landmarks from this stage), on the richest pair with room left for
half of its landmarks (the winners past the capacity are dropped and
counted), on a keyframe against itself, and on a
pair whose matches all point at a few train features with equal distances
(the dedupe's ties). Every link, alive flag, observation count and cursor
agrees exactly; the new landmarks' positions within ``TOL_P`` metres
relative to their distance from the first camera. K4 computes each point
with the plain version's formulas but not its rounding (the compiler fuses
multiply-adds; torch's norms and A^T A add in their own order), and a
two-view DLT point on a short baseline amplifies that rounding along its
ray (the largest reading on an H100, ``chip_smoke.check_tri``'s pair:
3.1e-5). Two runs of K4 are bit-equal, and the scan on CUDA triangulates every
keyframe pair through K4 and never through the plain version. Past 8,192
features K4 keeps its per-feature words in the workspace: a pair of 9,000
features agrees with the plain version as above.
"""

import numpy as np
import pytest
import torch

from visionx_slam_torch.data import synthetic
from visionx_slam_torch.models import matching
from visionx_slam_torch.ops.camera import make_camera
from visionx_slam_torch.ops.se3 import Pose
from visionx_slam_torch.tracking import mapstate as msl
from visionx_slam_torch.tracking import scan_pipeline as SP
from visionx_slam_torch.tracking import stages as ST
from visionx_slam_torch.utils import flops
from visionx_slam_torch.utils.config import TrackingOptions

from torch_parity import sequence

CAM = make_camera(synthetic.FX, synthetic.FY, synthetic.CX, synthetic.CY)
TOL_P = 1e-4
HOLE_COLS = 200


def _clone(ms):
    return type(ms)(*(x.clone() for x in ms))


def _pair_map(n_pts=40, N=64, L=256, seed=3):
    """Two keyframes 0.3 m apart seeing ``n_pts`` points with equal
    descriptors, no landmarks yet, and their knn2 match."""
    rng = np.random.default_rng(seed)
    X = rng.uniform([-1.5, -1, 3.0], [1.5, 1, 6.0], size=(n_pts, 3))
    ms = msl.empty_map(4, L, N)
    desc = torch.tensor(rng.integers(0, 256, (N, 32)), dtype=torch.uint8)
    valid = torch.zeros(N, dtype=torch.bool)
    valid[:n_pts] = True
    for k, tx in enumerate((0.0, -0.3)):
        pc = X + np.array([tx, 0.0, 0.0])
        px = np.zeros((N, 2))
        px[:n_pts] = np.stack([CAM.fx * pc[:, 0] / pc[:, 2] + CAM.cx,
                               CAM.fy * pc[:, 1] / pc[:, 2] + CAM.cy], -1)
        px[:n_pts] += rng.normal(0, 0.3, (n_pts, 2))
        pose = Pose(torch.tensor([1.0, 0, 0, 0]), torch.tensor([tx, 0.0, 0.0]))
        ms, _ = msl.insert_keyframe(
            ms, k, pose, torch.tensor(px, dtype=torch.float32), desc, valid,
            torch.full((N,), msl.FREE, dtype=torch.int32), torch.zeros(N),
            fresh_links=True, slot=k)
    res = matching.knn2_ratio_match(ms.kf_desc[0], ms.kf_fvalid[0],
                                    ms.kf_desc[1], ms.kf_fvalid[1])
    return ms, res


# ---------------------------------------------------------------------------
# CPU: K4's layout and checks, the plain version's dispatch
# ---------------------------------------------------------------------------

def test_k4_layout():
    ms, res = _pair_map()
    assert ST._k4_layout(ms, 0, 1, res) == [64, 320, 256, 0, 1]
    assert ST._k4_layout(ms, 3, 2, res) == [64, 320, 256, 3, 2]
    # a keyframe against itself (the stage inventory's event on a fresh map)
    assert ST._k4_layout(ms, 1, 1, res) == [64, 320, 256, 1, 1]


@pytest.mark.parametrize("edit", ["float64_positions", "int64_links",
                                  "strided_pixels", "slot_range",
                                  "match_shape", "features"])
def test_k4_layout_refuses(edit, monkeypatch):
    ms, res = _pair_map()
    a, b = 0, 1
    if edit == "float64_positions":
        ms = ms._replace(lm_pos=ms.lm_pos.double())
    elif edit == "int64_links":
        ms = ms._replace(kf_feat_lm=ms.kf_feat_lm.long())
    elif edit == "strided_pixels":   # K4 reads the table in place
        ms = ms._replace(kf_px=ms.kf_px.transpose(1, 2).contiguous().transpose(1, 2))
    elif edit == "slot_range":
        b = 4
    elif edit == "match_shape":
        res = res._replace(idx=res.idx[:10])
    else:                               # 8193 features past the limit
        monkeypatch.setattr(ST, "_K4_MAX_FEATURES", 8192)
        ms = msl.empty_map(2, 16, 8193)
        res = matching.MatchResult(torch.zeros(8193, dtype=torch.long),
                                   torch.zeros(8193), torch.zeros(8193, dtype=torch.bool))
    with pytest.raises(ValueError):
        ST._k4_layout(ms, a, b, res)


def test_cpu_triangulate_runs_the_plain_version_and_records_k4_work():
    """A CPU call never launches K4, gives what ``_triangulate_pair_plain``
    gives bit for bit, and counts K4's analytic work once."""
    ms, res = _pair_map()
    before = ST.tri_launches
    a = ST.triangulate_pair(_clone(ms), CAM, 0, 1, 1.0, 5.0, res=res)
    b = ST._triangulate_pair_plain(_clone(ms), CAM, 0, 1, 1.0, 5.0, res)
    assert ST.tri_launches == before
    assert int(a.next_lm) > 20
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    got = flops.op_cost(ST.triangulate_pair, _clone(ms), CAM, 0, 1, 1.0, 5.0,
                        res=res)
    assert got == {"flops": float(flops.k4_ops(64)), "bytes": float(flops.k4_bytes(64))}


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    ST.build_tri_kernel()
    return torch.device("cuda")


@pytest.fixture(scope="module")
def pairs(cuda):
    """The (map, slot a, slot b, match, angle, gate) of every
    ``triangulate_pair`` call of a 48-frame hole scan, the map copied as it
    was before the call."""
    grays, depths, _ = sequence(48, 7)
    d = torch.as_tensor(depths).clone()
    d[:, :, :HOLE_COLS] = 0.0
    seen = []
    real = ST.triangulate_pair

    def spy(ms, cam, a, b, angle, gate, res=None):
        if res is not None:
            seen.append((_clone(ms), a, b, type(res)(*(x.clone() for x in res)),
                         angle, gate))
        return real(ms, cam, a, b, angle, gate, res=res)

    ST.triangulate_pair = spy
    try:
        SP.run_scan_pipeline(CAM, torch.as_tensor(grays).to(cuda), d.to(cuda),
                             TrackingOptions(), device="cuda")
    finally:
        ST.triangulate_pair = real
    assert len(seen) >= 6
    return seen


def _both(ms, a, b, res, angle, gate):
    before = ST.tri_launches
    k = ST.triangulate_pair(_clone(ms), CAM, a, b, angle, gate, res=res)
    assert ST.tri_launches == before + 1
    p = ST._triangulate_pair_plain(_clone(ms), CAM, a, b, angle, gate, res)
    return k, p


def _assert_same(k, p, ms, a):
    for f in ms._fields:
        if f != "lm_pos":
            assert torch.equal(getattr(k, f), getattr(p, f)), f
    new = k.lm_alive & ~ms.lm_alive
    old = ~new
    assert torch.equal(k.lm_pos[:, old], p.lm_pos[:, old])
    # relative to the point's distance from keyframe a's camera centre
    c = -ST.quat_rotate(torch.cat([ms.kf_q[a, :1], -ms.kf_q[a, 1:]]), ms.kf_t[a])
    scale = torch.linalg.norm(p.lm_pos[:, new].T - c, dim=-1).clamp(min=1.0)
    err = torch.abs(k.lm_pos[:, new] - p.lm_pos[:, new]).max(0).values / scale
    worst = float(err.max()) if err.numel() else 0.0
    assert worst <= TOL_P, worst


def _made(pair) -> int:
    ms, a, b, res, angle, gate = pair
    p = ST._triangulate_pair_plain(_clone(ms), CAM, a, b, angle, gate, res)
    return int(p.next_lm) - int(ms.next_lm)


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["first", "middle", "last", "full_table"])
def test_k4_matches_plain(pairs, which):
    if which == "full_table":   # the richest pair, with room for half of it
        i = max(range(len(pairs)), key=lambda j: _made(pairs[j]))
        want = _made(pairs[i])
        room = want // 2
        assert want >= 2
    else:
        i = {"first": 0, "middle": len(pairs) // 2}.get(which, -1)
    ms, a, b, res, angle, gate = pairs[i]
    ms = _clone(ms)
    if which == "full_table":
        ms.next_lm.fill_(ms.lm_capacity - room)
    k, p = _both(ms, a, b, res, angle, gate)
    _assert_same(k, p, ms, a)
    made = int(p.next_lm) - int(ms.next_lm)
    if which == "full_table":
        assert made == room
        assert int(p.lm_dropped) - int(ms.lm_dropped) == want - room
    else:
        assert made > 0


@pytest.mark.cuda
def test_k4_dedupes_ties(cuda):
    """Every query matched to one of four train features at one distance:
    per train feature the lowest query row wins."""
    ms, res = _pair_map(n_pts=40)
    ms = type(ms)(*(x.to(cuda) for x in ms))
    n = ms.n_features
    idx = (torch.arange(n, device=cuda) % 4).long()
    res = matching.MatchResult(idx, torch.full((n,), 7.0, device=cuda),
                               res.valid.to(cuda))
    k, p = _both(ms, 0, 1, res, 1.0, 5.0)
    _assert_same(k, p, ms, 0)


@pytest.mark.cuda
def test_k4_one_slot_on_both_sides(cuda):
    """A keyframe triangulated against itself (the stage inventory's event
    on a fresh map) is taken, and the angle gate leaves its tables as the
    plain version does."""
    ms, res = _pair_map(n_pts=40)
    ms = type(ms)(*(x.to(cuda) for x in ms))
    res = type(res)(*(x.to(cuda) for x in res))
    k, p = _both(ms, 1, 1, res, 1.0, 5.0)
    _assert_same(k, p, ms, 1)
    assert int(k.next_lm) == int(ms.next_lm)


@pytest.mark.cuda
def test_k4_matches_plain_past_shared_memory(cuda):
    """9,000 features a keyframe (past the 8,192 that shared memory holds),
    4,000 of them points seen from both keyframes, each matched to its own
    train feature."""
    ms, _ = _pair_map(n_pts=4000, N=9000, L=12000)
    ms = type(ms)(*(x.to(cuda) for x in ms))
    n = ms.n_features
    res = matching.MatchResult(torch.arange(n, device=cuda),
                               torch.zeros(n, device=cuda),
                               ms.kf_fvalid[0].clone())
    k, p = _both(ms, 0, 1, res, 1.0, 5.0)
    _assert_same(k, p, ms, 0)
    assert int(p.next_lm) > 3000


@pytest.mark.cuda
def test_k4_repeats_bit_for_bit(pairs):
    ms, a, b, res, angle, gate = pairs[-1]
    x = ST.triangulate_pair(_clone(ms), CAM, a, b, angle, gate, res=res)
    y = ST.triangulate_pair(_clone(ms), CAM, a, b, angle, gate, res=res)
    for u, v in zip(x, y):
        assert torch.equal(u, v)


@pytest.mark.cuda
def test_scan_triangulates_through_k4_only(cuda, monkeypatch):
    """Each keyframe event of a CUDA scan (and its initial pair) is one K4
    launch; the plain version never runs on the card."""
    plain_devices, calls = [], []
    real_plain, real = ST._triangulate_pair_plain, ST.triangulate_pair

    def spy_plain(ms, *a, **k):
        plain_devices.append(ms.kf_q.device.type)
        return real_plain(ms, *a, **k)

    def spy(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(ST, "_triangulate_pair_plain", spy_plain)
    monkeypatch.setattr(ST, "triangulate_pair", spy)
    grays, depths, _ = sequence(48, 7)
    stats = {}
    before = ST.tri_launches
    SP.run_scan_pipeline(CAM, torch.as_tensor(grays).to(cuda),
                         torch.as_tensor(depths).to(cuda), TrackingOptions(),
                         device="cuda", stats=stats)
    assert stats["kf_events"] > 0 and len(calls) >= stats["kf_events"] + 1
    assert ST.tri_launches - before == len(calls)
    assert plain_devices == []
