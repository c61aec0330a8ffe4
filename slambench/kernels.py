"""The benchmark's frozen arithmetic of kernels K3 (a whole ``local_ba``
call) and K4 (a whole ``triangulate_pair`` call after its match), and their
device time in the traced part of a run.

``k3_bytes``, ``k3_ops``, ``k4_bytes`` and ``k4_ops`` are copies of the
port's ``utils/flops.py``, so that a change to the program cannot move the
yardstick; ``yardstick.bound_ms`` turns them into the least time on one
H100. The device time is the profiler's: the traced events whose name holds
the kernel's (``K3_KERNEL``, ``K4_KERNEL``), found on the harness's
``trace.Trace`` of the run, which ``trace.Trace.read`` sums for K1 alone."""

from __future__ import annotations

import sys

from . import yardstick

# the names of the kernels' CUDA functions (both are template instances)
K3_KERNEL = "local_ba_kernel"
K4_KERNEL = "triangulate_kernel"

# the scan's keyframe features (``ScanStream``'s ``n_features_cap``) and
# its local BA window (``TrackingOptions.ba_window_size``), as the port
# sets them by default
SCAN_FEATURES = 1024
BA_WINDOW = 5

# K3 per window feature and iteration: the pose pass, the point pass and
# the 3x3 solve; per window keyframe and iteration the 6x6 solve
K3_POSE_OPS_PER_ROW = 18 + 15 + 20 + 127
K3_POINT_OPS_PER_ROW = 33 + 38 + 72
K3_SOLVE6_OPS = 400
K3_SOLVE3_OPS = 50

# K4 per query feature: rays and angle, projection matrices, the DLT and
# its normal matrix, the 3x3 start, two 4x4 Cholesky steps, the two
# reprojections, the gates and the dedupe
K4_OPS_PER_QUERY = 60 + 10 + 50 + 112 + 45 + 130 + 70 + 15


def k3_bytes(n_slots: int, window: int, n_features: int) -> int:
    """Least traffic of K3, every window feature's landmark its own: the
    slots' ids, each feature's link, validity and pixels, each window pose
    read and written, each landmark read and written, the three stats."""
    rows = window * n_features
    return 4 * n_slots + (13 + 29) * rows + 56 * window + 12


def k3_ops(window: int, n_features: int, iters: float) -> float:
    rows = window * n_features
    per_iter = (rows * (K3_POSE_OPS_PER_ROW + K3_POINT_OPS_PER_ROW
                        + K3_SOLVE3_OPS) + window * K3_SOLVE6_OPS)
    return max(iters, 0) * per_iter


def k4_bytes(n_features: int) -> int:
    """Least traffic of K4, every query feature creating a landmark: both
    keyframes' pixels and links, the match, the poses, each new landmark's
    row and links, the cursors."""
    return (16 + 8 + 13 + 17 + 8) * n_features + 56 + 16


def k4_ops(n_features: int) -> int:
    return n_features * K4_OPS_PER_QUERY


def _trace():
    """The harness's finished ``Trace`` of this run, from the frames of
    the call stack that reads the metrics (``run.run_cell``); None where
    there is none."""
    from .trace import Trace

    f = sys._getframe(1)
    while f is not None:
        for v in f.f_locals.values():
            if isinstance(v, Trace) and v.done and v.prof is not None:
                return v
        f = f.f_back
    return None


def kernel_time(name: str):
    """(launches, device seconds) of the traced device operations whose
    name holds ``name``; None where the run has no trace or no launch."""
    from torch.autograd import DeviceType

    tr = _trace()
    if tr is None:
        return None
    times = [(e.time_range.end - e.time_range.start) / 1e6
             for e in tr.prof.events()
             if e.device_type == DeviceType.CUDA and name in e.name]
    return (len(times), sum(times)) if times and sum(times) > 0 else None


def share(n_bytes: float, n_ops: float, launches: int, seconds: float) -> float:
    """The share (%) of the kernel's bound: ``launches`` calls each of
    ``n_bytes`` and ``n_ops`` over their device ``seconds``."""
    return 100.0 * launches * yardstick.bound_ms(n_bytes, n_ops) / 1e3 / seconds


def k3_roofline(ctx: dict, kf_capacity: int):
    """K3's share of its bound over the traced part: each traced launch at
    the mean iterations of a local BA call over the untraced passes
    (``#lba_iterations`` over ``#kf_events``, the program's counters)."""
    t = ctx["timings"]
    if not t.get("#kf_events") or "#lba_iterations" not in t:
        return None
    got = kernel_time(K3_KERNEL)
    if got is None:
        return None
    iters = t["#lba_iterations"] / t["#kf_events"]
    return share(k3_bytes(kf_capacity, BA_WINDOW, SCAN_FEATURES),
                 k3_ops(BA_WINDOW, SCAN_FEATURES, iters), *got)


def k4_roofline(ctx: dict):
    """K4's share of its bound over the traced part."""
    got = kernel_time(K4_KERNEL)
    if got is None:
        return None
    return share(k4_bytes(SCAN_FEATURES), k4_ops(SCAN_FEATURES), *got)
