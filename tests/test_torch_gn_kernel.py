"""Kernel K2 (``csrc/pose_gn.cu``), every step of a ``_pose_gn_refine``
call in one launch, and its plain version ``_pose_gn_refine_plain``.

On the CPU (tier-1): the plain version against an independent float64
NumPy Gauss-Newton (rotation matrices, ``np.linalg.solve`` and a Rodrigues
exponential in place of the port's quaternion formulas and unrolled
Cholesky), over the shapes its callers use, robust and not, 1-10 steps,
zero weights, points behind the camera and a NaN pose; K2's view of its
inputs (broadcast batch dims merged, strides) and what the wrapper
refuses; the analytic work it records; and that a CPU call never launches.
Tolerance against float64: 2e-6 on quaternions and 2e-6 m on translations,
float32 rounding of a few hundred points' sums carried through the steps
(over four seeds of every case the largest reading is 2.0e-7).

On the card (marker ``cuda``; no jax in this file): K2 against the plain
version over the main path's shapes and the edge cases, bit-equal between
two runs, and an offline pass on CUDA that launches K2 and runs no plain
step. K2 adds its sums in another order than the plain version's GEMM,
so poses agree to float32 rounding amplified by the steps: ``TOL_Q`` and
``TOL_T`` (absolute, unit quaternion and metres at 1-5 m depth; the largest
reading on an H100 is 5.2e-7). The polish's 3-point systems amplify that
rounding by their condition: ``TOL_POLISH`` (largest reading 5.0e-5).
"""

import numpy as np
import pytest
import torch

from visionx_slam_torch.data import synthetic
from visionx_slam_torch.models import estimation as TE
from visionx_slam_torch.ops.camera import make_camera
from visionx_slam_torch.ops.se3 import Pose
from visionx_slam_torch.utils import flops

from torch_parity import t

CAM = make_camera(synthetic.FX, synthetic.FY, synthetic.CX, synthetic.CY)
TOL64 = 2e-6
TOL_Q = 1e-5
TOL_T = 1e-5
TOL_POLISH = 1e-4


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------

def _rot(q):
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])


def _axis_quat(v):
    th = np.linalg.norm(v)
    if th < 1e-15:
        return np.array([1.0, 0.0, 0.0, 0.0])
    return np.concatenate([[np.cos(th / 2)], np.sin(th / 2) * v / th])


def _problems(seed, batch, n, outliers=0.0, behind=0.0):
    """Float32 inputs over ``batch``: world points, pixels of a true pose
    (0.5 px noise, ``outliers`` share replaced at random, ``behind`` share
    moved behind the camera), 0/1 weights (5% off), and a start pose near
    the truth."""
    rng = np.random.default_rng(seed)
    B = int(np.prod(batch))
    X, px, w, q0, t0 = [], [], [], [], []
    for _ in range(B):
        pc = np.stack([rng.uniform(-1.5, 1.5, n), rng.uniform(-1.0, 1.0, n),
                       rng.uniform(1.0, 5.0, n)], -1)
        back = rng.random(n) < behind
        pc[back, 2] = -pc[back, 2]
        q = _axis_quat(rng.normal(0, 0.2, 3))
        tt = rng.normal(0, 0.3, 3)
        R = _rot(q)
        X.append((pc - tt) @ R)
        z = np.where(np.abs(pc[:, 2]) > 1e-3, pc[:, 2], 1.0)
        p = np.stack([CAM.fx * pc[:, 0] / z + CAM.cx,
                      CAM.fy * pc[:, 1] / z + CAM.cy], -1)
        p = p + rng.normal(0, 0.5, p.shape)
        out = rng.random(n) < outliers
        p[out] = rng.uniform([0, 0], [640, 480], (out.sum(), 2))
        px.append(p)
        w.append((rng.random(n) > 0.05).astype(np.float64))
        qs = _qmul(_axis_quat(rng.normal(0, 0.005, 3)), q)
        q0.append(qs / np.linalg.norm(qs))
        t0.append(tt + rng.normal(0, 0.01, 3))
    f32 = lambda a, tail: np.asarray(a, np.float32).reshape(*batch, *tail)
    return (f32(q0, (4,)), f32(t0, (3,)), f32(X, (n, 3)), f32(px, (n, 2)),
            f32(w, (n,)))


# ---------------------------------------------------------------------------
# the float64 NumPy reference
# ---------------------------------------------------------------------------

def _qmul(a, b):
    aw, ax, ay, az = a
    bw, bx, by, bz = b
    return np.array([aw * bw - ax * bx - ay * by - az * bz,
                     aw * bx + ax * bw + ay * bz - az * by,
                     aw * by - ax * bz + ay * bw + az * bx,
                     aw * bz + ax * by - ay * bx + az * bw])


def _hat(v):
    return np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]])


def _gn64(q, tt, X, px, w, iters, robust, huber, gate):
    """One problem, float64: J = d(projection)/d(left perturbation), normal
    equations damped by 1e-6, a dense solve, exp(dx) * T."""
    q, tt, X, px, w = (np.asarray(a, np.float64) for a in (q, tt, X, px, w))
    for _ in range(iters):
        pc = X @ _rot(q).T + tt
        front = pc[:, 2] > 1e-6
        z = np.where(front, pc[:, 2], 1e-6)
        r = px - np.stack([CAM.fx * pc[:, 0] / z + CAM.cx,
                           CAM.fy * pc[:, 1] / z + CAM.cy], -1)
        ww = w * front
        if robust:
            en = np.linalg.norm(r, axis=-1)
            ww = ww * np.where(en <= huber, 1.0, huber / np.maximum(en, 1e-9))
            ww = ww * (en <= gate)
        H = 1e-6 * np.eye(6)
        b = np.zeros(6)
        for i in range(len(X)):
            jp = np.array([[CAM.fx / z[i], 0, -CAM.fx * pc[i, 0] / z[i] ** 2],
                           [0, CAM.fy / z[i], -CAM.fy * pc[i, 1] / z[i] ** 2]])
            J = jp @ np.hstack([np.eye(3), -_hat(pc[i])])
            H += ww[i] * J.T @ J
            b += ww[i] * J.T @ r[i]
        try:
            dx = np.linalg.solve(H, b)
        except np.linalg.LinAlgError:
            dx = np.full(6, np.nan)
        if not np.isfinite(dx).all():
            dx = np.zeros(6)
        om = dx[3:]
        th = np.linalg.norm(om)
        K = _hat(om)
        if th < 1e-12:
            V = np.eye(3)
        else:
            V = (np.eye(3) + (1 - np.cos(th)) / th ** 2 * K
                 + (th - np.sin(th)) / th ** 3 * K @ K)
        qe = _axis_quat(om)
        q = _qmul(qe, q)
        q = q / np.linalg.norm(q)
        q = q if q[0] >= 0 else -q
        tt = _rot(qe) @ tt + V @ dx[:3]
    return q, tt


def _reference(q, tt, X, px, w, **kw):
    batch = np.broadcast_shapes(q.shape[:-1], tt.shape[:-1], X.shape[:-2],
                                px.shape[:-2], w.shape[:-1])
    bq = np.broadcast_to(q, (*batch, 4)).reshape(-1, 4)
    bt = np.broadcast_to(tt, (*batch, 3)).reshape(-1, 3)
    n = X.shape[-2]
    bX = np.broadcast_to(X, (*batch, n, 3)).reshape(-1, n, 3)
    bp = np.broadcast_to(px, (*batch, n, 2)).reshape(-1, n, 2)
    bw = np.broadcast_to(w, (*batch, n)).reshape(-1, n)
    out = [_gn64(*a, **kw) for a in zip(bq, bt, bX, bp, bw)]
    return (np.stack([o[0] for o in out]).reshape(*batch, 4),
            np.stack([o[1] for o in out]).reshape(*batch, 3))


# name -> (batch of the poses, point count, iters, robust, input edits)
CASES = {
    "prior": ((6,), 200, 4, True, None),
    "refine": ((6,), 200, 2, False, None),
    "unbatched": ((), 150, 6, False, None),
    "broadcast": ((3, 4), 120, 2, False, "broadcast"),
    "n37": ((5,), 37, 10, True, None),
    "zero_weights": ((4,), 64, 3, False, "zero"),
    "behind": ((4,), 160, 5, True, "behind"),
    "nan_pose": ((3,), 64, 2, False, "nan"),
}


def _hypotheses(seed, P, H, n):
    """[P,1,n] point sets under [P,H] start poses: each problem's
    hypotheses are perturbations of its one start pose, with their own 0/1
    weights."""
    q0, t0, X, px, w = _problems(seed, (P,), n)
    rng = np.random.default_rng(seed + 1000)
    qh = np.stack([[_qmul(_axis_quat(rng.normal(0, 0.002, 3)), q) for _ in range(H)]
                   for q in q0.astype(np.float64)])
    qh = qh / np.linalg.norm(qh, axis=-1, keepdims=True)
    th = t0[:, None] + rng.normal(0, 0.005, (P, H, 3))
    wh = (rng.random((P, H, n)) > 0.3).astype(np.float32)
    return (qh.astype(np.float32), th.astype(np.float32), X[:, None],
            px[:, None], wh)


def _case(name, seed=0, iters=None):
    batch, n, it, robust, edit = CASES[name]
    if edit == "broadcast":   # one point set per problem, poses per hypothesis
        q0, t0, X, px, w = _hypotheses(seed, *batch, n)
    else:
        q0, t0, X, px, w = _problems(seed, batch, n,
                                     outliers=0.1 if robust else 0,
                                     behind=0.2 if edit == "behind" else 0)
    if edit == "zero":
        w = np.zeros_like(w)
    elif edit == "nan":
        q0 = q0.copy()
        q0[1] = np.nan
    kw = dict(iters=it if iters is None else iters, robust=robust,
              huber_delta=4.0, gate_px=20.0)
    return (q0, t0, X, px, w), kw


def _assert_poses(a, b, tol_q, tol_t):
    np.testing.assert_allclose(a[0], b[0], atol=tol_q, rtol=0, equal_nan=True)
    np.testing.assert_allclose(a[1], b[1], atol=tol_t, rtol=0, equal_nan=True)


# ---------------------------------------------------------------------------
# CPU: the plain version, K2's layout and checks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_matches_float64(name):
    (q0, t0, X, px, w), kw = _case(name)
    before = TE.gn_launches
    pose = TE._pose_gn_refine(CAM, Pose(t(q0), t(t0)), t(X), t(px), t(w), **kw)
    assert TE.gn_launches == before
    ref = _reference(q0, t0, X, px, w, iters=kw["iters"], robust=kw["robust"],
                     huber=kw["huber_delta"], gate=kw["gate_px"])
    _assert_poses((pose.q.numpy(), pose.t.numpy()), ref, TOL64, TOL64)
    if name == "nan_pose":
        assert np.isnan(pose.q[1].numpy()).all() and np.isfinite(pose.q[0].numpy()).all()
    if name == "zero_weights":   # no step moves: the pose comes back normalized
        _assert_poses((pose.q.numpy(), pose.t.numpy()), (q0, t0), 1e-6, 1e-6)


@pytest.mark.parametrize("iters", [1, 3, 7, 10])
def test_plain_matches_float64_over_steps(iters):
    (q0, t0, X, px, w), kw = _case("prior", seed=iters, iters=iters)
    pose = TE._pose_gn_refine(CAM, Pose(t(q0), t(t0)), t(X), t(px), t(w), **kw)
    ref = _reference(q0, t0, X, px, w, iters=iters, robust=True, huber=4.0,
                     gate=20.0)
    _assert_poses((pose.q.numpy(), pose.t.numpy()), ref, TOL64, TOL64)


def _layout(qb, tb, Xs, ps, ws):
    z = lambda *s: torch.zeros(s)
    ins = (z(*qb), z(*tb), z(*Xs), z(*ps), z(*ws))
    batch = TE._batch_shape(qb[:-1], tb[:-1], Xs[:-2], ps[:-2], ws[:-1])
    assert batch == torch.broadcast_shapes(qb[:-1], tb[:-1], Xs[:-2], ps[:-2],
                                           ws[:-1])
    return TE._k2_layout(batch, ins)


CONTIGUOUS = [1, 1, 3, 1, 2, 1, 1]   # q, t, X (points, coords), px (same), w


@pytest.mark.parametrize("shapes, sizes, strides", [
    # pnp_ransac's polish: [P,1,N] points under [P,H] hypotheses
    (((32, 16, 4), (32, 16, 3), (32, 1, 1024, 3), (32, 1, 1024, 2),
      (32, 16, 1024)), [32, 16],
     [[64, 48, 3072, 2048, 16384], [4, 3, 0, 0, 1024]]),
    # the motion prior and the final refine: [P] problems
    (((32, 4), (32, 3), (32, 1024, 3), (32, 1024, 2), (32, 1024)), [32],
     [[4, 3, 3072, 2048, 1024]]),
    # pnp_prior on the scan: one problem, no batch dims
    (((4,), (3,), (700, 3), (700, 2), (700,)), [], []),
    # size-1 dims drop, contiguous neighbours merge
    (((2, 1, 3, 4), (2, 1, 3, 3), (2, 1, 3, 5, 3), (2, 1, 3, 5, 2),
      (2, 1, 3, 5)), [6], [[4, 3, 15, 10, 5]]),
    # a pose shared by every problem
    (((1, 4), (3,), (7, 9, 3), (7, 9, 2), (7, 9)), [7],
     [[0, 0, 27, 18, 9]]),
])
def test_k2_layout(shapes, sizes, strides):
    assert _layout(*shapes) == (sizes, strides, CONTIGUOUS)


def test_k2_layout_reads_strides_in_place():
    """The re-track's points are stored coordinate-major ([3,P,N] viewed as
    [P,N,3]) and a slice of pixels steps over columns: K2 reads both
    through their strides, with no copy."""
    X = torch.zeros(3, 32, 1024).permute(1, 2, 0)
    px = torch.zeros(32, 1024, 4)[..., 1:3]
    q, tt, w = torch.zeros(32, 4), torch.zeros(32, 3), torch.zeros(32, 1024)
    got = TE._k2_layout(torch.Size([32]), (q, tt, X, px, w))
    assert got == ([32], [[4, 3, 1024, 4096, 1024]],
                   [1, 1, 1, 32768, 4, 1, 1])


@pytest.mark.parametrize("edit", ["float64", "width", "count", "dims"])
def test_k2_layout_refuses(edit):
    q, tt, X, px, w = (torch.zeros(s) for s in ((5, 4), (5, 3), (5, 8, 3),
                                                  (5, 8, 2), (5, 8)))
    batch = torch.Size([5])
    if edit == "float64":
        X = X.double()
    elif edit == "width":
        px = torch.zeros(5, 8, 3)
    elif edit == "count":
        w = torch.zeros(5, 7)
    else:   # five dims none of which merge
        shape = (2, 3, 2, 3, 2)
        q = torch.zeros(*shape, 4)
        tt = torch.zeros(*shape, 3)
        X = torch.zeros(*shape, 8, 3).transpose(0, 1).contiguous().transpose(0, 1)
        px = torch.zeros(1, 8, 2)
        w = torch.zeros(*shape, 8).transpose(2, 3).contiguous().transpose(2, 3)
        batch = torch.Size(shape)
    with pytest.raises(ValueError):
        TE._k2_layout(batch, (q, tt, X, px, w))


@pytest.mark.parametrize("robust", [False, True])
def test_gn_records_k2_work(robust):
    """A call counts K2's analytic work once, its plain ops not at all."""
    (q0, t0, X, px, w), _ = _case("broadcast")
    args = (CAM, Pose(t(q0), t(t0)), t(X), t(px), t(w))
    got = flops.op_cost(TE._pose_gn_refine, *args, iters=3, robust=robust,
                        huber_delta=4.0, gate_px=20.0)
    n_in = q0.size + t0.size + X.size + px.size + w.size
    assert got == {"flops": float(flops.k2_ops(12, 120, 3, robust)),
                   "bytes": float(flops.k2_bytes(12, n_in))}


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    TE.build_gn_kernel()
    return torch.device("cuda")


def _both(args, kw, dev):
    """(K2's pose, the plain version's) on the card."""
    q0, t0, X, px, w = (t(a).to(dev) for a in args)
    before = TE.gn_launches
    k = TE._pose_gn_refine(CAM, Pose(q0, t0), X, px, w, **kw)
    assert TE.gn_launches == before + 1
    p = TE._pose_gn_refine_plain(CAM, Pose(q0, t0), X, px, w, **kw)
    return ((k.q.cpu().numpy(), k.t.cpu().numpy()),
            (p.q.cpu().numpy(), p.t.cpu().numpy()))


def _polish_case():
    """pnp_ransac's polish at the pairs stage's shapes: [32,1,1024] points
    under [32,16] poses, each hypothesis weighted on its own 3 points."""
    q0, t0, X, px, _ = _hypotheses(1, 32, 16, 1024)
    rng = np.random.default_rng(2)
    w = np.zeros((32, 16, 1024), np.float32)
    for i in range(32):
        for h in range(16):
            w[i, h, rng.choice(1024, 3, replace=False)] = 1.0
    return (q0, t0, X, px, w), dict(iters=2)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CASES) + ["n300", "n1500", "n3000"])
def test_k2_matches_plain(cuda, name):
    if name.startswith("n") and name[1:].isdigit():
        n = int(name[1:])   # 2, 8 points a thread, and read each step
        args = _problems(3, (8,), n, outliers=0.1)
        kw = dict(iters=4, robust=True, huber_delta=4.0, gate_px=20.0)
    else:
        args, kw = _case(name)
    k, p = _both(args, kw, cuda)
    _assert_poses(k, p, TOL_Q, TOL_T)


@pytest.mark.cuda
def test_k2_matches_plain_polish(cuda):
    """The polish's 3-point steps: a few samples are so poorly conditioned
    that float32 rounding alone moves the plain version's pose by metres
    (against its own float64 run on the card). There no sum order is more
    right than another, so K2 is held to the plain version, within
    ``TOL_POLISH``, on the hypotheses where the plain version's float32 and
    float64 runs agree within ``TOL_Q`` and ``TOL_T``, and those must be at
    least 90% of them (93.8% on an H100)."""
    args, kw = _polish_case()
    k, p = _both(args, kw, cuda)
    d = [t(a).double().to(cuda) for a in args]
    p64 = TE._pose_gn_refine_plain(CAM, Pose(d[0], d[1]), *d[2:], **kw)
    p64 = (p64.q.cpu().numpy(), p64.t.cpu().numpy())
    stable = ((np.abs(p[0] - p64[0]).max(-1) <= TOL_Q)
              & (np.abs(p[1] - p64[1]).max(-1) <= TOL_T))
    assert stable.mean() >= 0.9, stable.mean()
    _assert_poses((k[0][stable], k[1][stable]), (p[0][stable], p[1][stable]),
                  TOL_POLISH, TOL_POLISH)


@pytest.mark.cuda
@pytest.mark.parametrize("iters", range(1, 11))
def test_k2_matches_plain_over_steps(cuda, iters):
    for robust in (False, True):
        args, kw = _case("prior", seed=iters, iters=iters)
        kw["robust"] = robust
        k, p = _both(args, kw, cuda)
        _assert_poses(k, p, TOL_Q, TOL_T)


@pytest.mark.cuda
def test_k2_repeats_bit_for_bit(cuda):
    args, kw = _polish_case()
    q0, t0, X, px, w = (t(a).to(cuda) for a in args)
    bits = lambda p: torch.cat([p.q, p.t], -1).view(torch.int32)  # NaNs too
    a = TE._pose_gn_refine(CAM, Pose(q0, t0), X, px, w, **kw)
    b = TE._pose_gn_refine(CAM, Pose(q0, t0), X, px, w, **kw)
    assert torch.equal(bits(a), bits(b))


@pytest.mark.cuda
def test_k2_reads_strided_inputs(cuda):
    """Coordinate-major points and pixels (the re-track's layout) give what
    contiguous copies of them give, bit for bit."""
    (q0, t0, X, px, w), kw = _case("prior")
    q0, t0, X, px, w = (t(a).to(cuda) for a in (q0, t0, X, px, w))
    Xs = X.permute(2, 0, 1).contiguous().permute(1, 2, 0)
    ps = px.permute(2, 0, 1).contiguous().permute(1, 2, 0)
    assert Xs.stride(-1) != 1 and ps.stride(-1) != 1
    a = TE._pose_gn_refine(CAM, Pose(q0, t0), Xs, ps, w, **kw)
    b = TE._pose_gn_refine(CAM, Pose(q0, t0), X, px, w, **kw)
    assert torch.equal(a.q, b.q) and torch.equal(a.t, b.t)


@pytest.mark.cuda
def test_k2_refuses_on_the_card(cuda):
    (q0, t0, X, px, w), kw = _case("refine")
    q0, t0, X, px, w = (t(a).to(cuda) for a in (q0, t0, X, px, w))
    with pytest.raises(ValueError):
        TE._pose_gn_refine(CAM, Pose(q0, t0), X.double(), px, w, **kw)
    with pytest.raises(ValueError):
        TE._pose_gn_refine(CAM, Pose(q0, t0), X, px[:, :-1], w, **kw)


@pytest.mark.cuda
def test_offline_pass_launches_k2_only(cuda, monkeypatch):
    """A pass of the offline pipeline on CUDA goes through K2: its launch
    count rises and no plain step runs on a CUDA tensor."""
    from visionx_slam_torch.tracking.offline_pipeline import run_offline_pipeline
    from visionx_slam_torch.utils.config import TrackingOptions

    from torch_parity import sequence

    plain_devices = []
    real = TE._pose_gn_refine_plain

    def spy(cam, pose, X, *a, **k):
        plain_devices.append(X.device.type)
        return real(cam, pose, X, *a, **k)

    monkeypatch.setattr(TE, "_pose_gn_refine_plain", spy)
    grays, depths, _ = sequence(16, 7)
    before = TE.gn_launches
    _, out = run_offline_pipeline(CAM, t(grays).to(cuda), t(depths).to(cuda),
                                  TrackingOptions(), device="cuda",
                                  kf_capacity=16)
    assert TE.gn_launches > before
    assert "cuda" not in plain_devices
    assert bool(out.tracked.all())
