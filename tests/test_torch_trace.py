"""The offline pipeline's stage clock (``utils/logging.StageClock``) on 16
frames of 640x480 (the shape of ``test_torch_offline.py``): no clock is
active without ``timings`` and the clock does not change what a run
computes; with ``timings`` every consecutive stage that matches and
estimates gets its ``match``/``ransac``/``gn`` sub-spans, written in time
order before the stage's own key; ``#host_syncs`` equals a count of the
operations that make a CUDA stream wait for the host, taken here by
wrapping them."""

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from visionx_slam_torch.data import synthetic
from visionx_slam_torch.ops.camera import make_camera
from visionx_slam_torch.tracking import offline_pipeline as op
from visionx_slam_torch.utils import logging as vlog
from visionx_slam_torch.utils.config import TrackingOptions

from torch_parity import sequence

STAGES = ("extract", "pairs", "map", "refine", "retrack")
SPANS = ("match", "ransac", "gn")
aten = torch.ops.aten


class _Ordered(dict):
    """A ``timings`` dict that records the order of its writes."""

    def __init__(self):
        super().__init__()
        self.writes = []

    def __setitem__(self, key, value):
        self.writes.append(key)
        super().__setitem__(key, value)


class _SyncOps(TorchDispatchMode):
    """Counts the operations that wait for the device on a CUDA stream,
    seen on the CPU: a scalar read, a tensor made from host data (a numpy
    array or a Python scalar, copied to the device there), a boolean mask
    as an index (its size is read), a linear-algebra status check (a
    batched ``svd`` waits twice under CUDA's sync debug mode on an H100).
    The reads that leave no operation on the CPU (``.cpu()``,
    ``.tolist()``) are counted by wrapping them."""

    CHECKED = {aten._local_scalar_dense.default: 1, aten.lift_fresh.default: 1,
               aten._linalg_check_errors.default: 1,
               aten._linalg_eigh.default: 1, aten._linalg_svd.default: 2,
               aten.nonzero.default: 1, aten.masked_select.default: 1}

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in self.CHECKED:
            self.n += self.CHECKED[func]
        elif func in (aten.index.Tensor, aten.index_put_.default,
                      aten.index_put.default):
            self.n += any(i is not None and i.dtype == torch.bool
                          for i in args[1])
        return func(*args, **(kwargs or {}))


@pytest.fixture(scope="module")
def runs():
    # tensors already, as on the card: a numpy input is copied in before
    # the pass starts
    grays, depths = (torch.from_numpy(x) for x in sequence(16, 7)[:2])
    cam = make_camera(synthetic.FX, synthetic.FY, synthetic.CX, synthetic.CY)
    run = lambda timings: op.run_offline_pipeline(
        cam, grays, depths, TrackingOptions(), device="cpu", kf_capacity=16,
        timings=timings)
    seen, policy = [], op._keyframe_policy

    def spy(*a, **kw):
        seen.append(vlog._active)
        return policy(*a, **kw)

    mp = pytest.MonkeyPatch()
    mp.setattr(op, "_keyframe_policy", spy)
    try:
        plain = run(None)
        timings, ops = _Ordered(), _SyncOps()
        reads = [0]
        for name in ("cpu", "tolist"):
            orig = getattr(torch.Tensor, name)

            def counted(self, *a, _orig=orig, **kw):
                reads[0] += 1
                return _orig(self, *a, **kw)

            mp.setattr(torch.Tensor, name, counted)
        with ops:
            timed = run(timings)
    finally:
        mp.undo()
    return plain, timed, timings, seen, ops.n + reads[0]


def test_untimed_run_has_no_clock_and_equals_the_timed_run(runs):
    (ms0, out0), (ms1, out1), _, seen, _ = runs
    assert seen[0] is None
    assert seen[1] is not None and vlog._active is None
    for a, b in zip(out0, out1):
        assert torch.equal(a, b)
    for a, b in zip(ms0, ms1):
        assert torch.equal(a, b)


def test_sub_spans_tile_their_stages(runs):
    timings = runs[2]
    assert {k for k in timings if "/" not in k} == {*STAGES, vlog.HOST_SYNCS}
    for stage in ("pairs", "map", "retrack"):
        subs = [timings[f"{stage}/{s}"] for s in SPANS]
        assert min(subs) >= 0.0
        assert sum(subs) <= timings[stage]
    for key in timings:
        if "/" in key:
            stage, name = key.split("/")
            assert stage in STAGES and name in SPANS, key


def test_keys_are_written_in_time_order(runs):
    writes = runs[2].writes
    first = {}
    for i, key in enumerate(writes):
        first.setdefault(key, i)
    for i, key in enumerate(writes):
        if "/" in key:
            assert i < first[key.split("/")[0]], key
    assert writes[-1] == vlog.HOST_SYNCS
    assert writes.index(vlog.HOST_SYNCS) > first["retrack"]
    assert writes.count(vlog.HOST_SYNCS) == 1


def test_host_syncs_equal_the_wrapped_count(runs):
    timings, counted = runs[2], runs[4]
    assert counted > 0
    assert timings[vlog.HOST_SYNCS] == counted
