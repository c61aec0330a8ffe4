"""FLOP and byte accounting and MFU for the SLAM pipelines (counterpart of
``visionx_slam_tpu/utils/flops.py``, with its names and API).

The JAX package takes a stage's cost from XLA's cost analysis of the
stage's compiled program. PyTorch has no compiled program to ask, so
``op_cost`` runs the stage once and counts the aten ops it executes, under
a ``TorchDispatchMode``:

- the matmul family (``mm``, ``bmm``, ``addmm``, ``baddbmm``, convolutions;
  ``matmul`` reaches the mode as one of them) takes its FLOPs from the
  formulas ``torch.utils.flop_counter`` registers;
- view and alias ops cost nothing; copies (``copy_``, ``_to_copy``,
  ``clone``) and fills move bytes only; allocations cost nothing;
- a reduction (aten's ``reduction`` tag) counts 1 FLOP per input element,
  every other op 1 per output element;
- bytes are, per op, the sizes of its distinct input tensors plus its
  outputs: the traffic of the eager kernels one by one. XLA counts after
  fusion, so these bytes are expected to be above the JAX package's.

The hand-written kernels are launched through ``ctypes``, which no dispatch
mode sees; their wrappers record their analytic work with ``unit`` around
both the launch and the plain version, so a stage counts the same work on
the CPU and on the card. Work done in host numpy (the offline pipeline's
greedy loop-pair selection, for one) is not device work and is not counted.

Loop trip counts are what the run executes: a stage is run standalone at
its shapes and multiplied by its per-frame execution count, as in the JAX
package. The stage inventories run the port's functions on zero-filled
inputs of the bench shapes; the counts follow the shapes, not the content
(no stage branches on it).

The peaks are public dense rates. The port computes in float32 with TF32
off, so a share of the bf16 peak understates how busy the card is.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass

import numpy as np
import torch
from torch.utils import flop_counter
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

# public per-device peaks by device-name prefix (first match wins): the H100
# SXM5's dense rates from NVIDIA's data sheet, and the JAX package's row for
# a CPU
DEVICE_PEAKS = {
    "NVIDIA H100": dict(flops_bf16=989e12, flops_int8=1979e12, hbm_Bps=3.35e12),
    "cpu": dict(flops_bf16=1e11, flops_int8=1e11, hbm_Bps=1e10),
}
# float32 outside the tensor cores, the H100 data sheet's rate
F32_OPS_PER_S = 67e12

# arithmetic and compares per output pixel of kernels K1 and K1b, halo not
# counted: FAST 34 (two thresholds, 32 compares), Sobel rows 4, gradients and
# products 9, the three 7x7 box sums 36, Harris 7, NMS 9 (8 max, 1 compare);
# K1's blur 26
K1B_OPS_PER_PIXEL = 34 + 4 + 9 + 36 + 7 + 9
K1_OPS_PER_PIXEL = K1B_OPS_PER_PIXEL + 26


def device_peaks(device=None) -> dict:
    """The peaks of ``device`` (default: the current CUDA device) and its
    name under ``device_kind``; None peaks for a device not in the table."""
    dev = torch.device(device if device is not None else "cuda")
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev.type
    for prefix, peaks in DEVICE_PEAKS.items():
        if kind.lower().startswith(prefix.lower()):
            return dict(peaks, device_kind=kind)
    return dict(flops_bf16=None, flops_int8=None, hbm_Bps=None,
                device_kind=kind)


def k1_bytes(shape) -> int:
    """Least traffic of K1: bf16 image read, int8 mask (shared by the batch)
    read, f32 score and bf16 blur written."""
    B, H, W = shape
    return B * H * W * (2 + 4 + 2) + H * W


def k1b_bytes(shape) -> int:
    """Least traffic of K1b on a float32 image: read 4 B, write 4 B."""
    return int(np.prod(shape)) * 8


def k1_ops(shape) -> int:
    return int(np.prod(shape)) * K1_OPS_PER_PIXEL


def k1b_ops(shape) -> int:
    return int(np.prod(shape)) * K1B_OPS_PER_PIXEL


# arithmetic of kernel K2 (pose Gauss-Newton), per point and step: the
# rotation and translation 33, projection, residuals and weight 13 (the
# robust weight 10 more), the Jacobian 17, the weighted rows and the 27 sums
# 120; per problem and step, the 6x6 Cholesky solve, se3_exp and the
# composition, about 400
K2_OPS_PER_POINT = 33 + 13 + 17 + 120
K2_ROBUST_OPS_PER_POINT = 10
K2_SOLVE_OPS = 400


def k2_bytes(n_problems: int, in_elems: int) -> int:
    """Least traffic of K2: every float32 element of its inputs read once
    (an input that broadcasts over the problems counts once) and each
    problem's pose (7 floats) written."""
    return 4 * (in_elems + 7 * n_problems)


def k2_ops(n_problems: int, n_points: int, iters: int, robust: bool) -> int:
    per_point = K2_OPS_PER_POINT + (K2_ROBUST_OPS_PER_POINT if robust else 0)
    return max(iters, 0) * n_problems * (n_points * per_point + K2_SOLVE_OPS)


# arithmetic of kernel K3 (a local BA call), per window feature and
# iteration: the pose pass (the rotation and translation 18, projection,
# residual and weight 15, the Jacobian's two rows 20, the weighted rows and
# the 27 sums, cost and count 127) and the point pass (the same view 33, the
# Jacobian times R 38, the 3x3 and 3x1 blocks 72); per window keyframe and
# iteration the 6x6 Cholesky solve, se3_exp and the composition, about 400;
# per landmark and iteration the adjugate 3x3 solve, about 50. The sort that
# builds the buckets is integer work and is not counted.
K3_POSE_OPS_PER_ROW = 18 + 15 + 20 + 127
K3_POINT_OPS_PER_ROW = 33 + 38 + 72
K3_SOLVE6_OPS = 400
K3_SOLVE3_OPS = 50


def k3_bytes(n_slots: int, window: int, n_features: int) -> int:
    """Least traffic of K3, with every window feature's landmark counted as
    its own (at most ``window`` x ``n_features`` landmarks): the slots' ids;
    each feature's link, validity and pixels (13 B); each window pose read
    and written (56 B); each landmark's position, flag and count read and
    its position written (29 B); the three stats."""
    rows = window * n_features
    return 4 * n_slots + (13 + 29) * rows + 56 * window + 12


def k3_ops(window: int, n_features: int, iters: int) -> int:
    rows = window * n_features
    per_iter = (rows * (K3_POSE_OPS_PER_ROW + K3_POINT_OPS_PER_ROW
                        + K3_SOLVE3_OPS) + window * K3_SOLVE6_OPS)
    return max(iters, 0) * per_iter


# arithmetic of kernel K4 (a triangulate_pair call), per query feature: the
# two unit viewing rays and their angle 60, the two projection matrices'
# share 10, the DLT rows and their normalisation 50, A^T A 112, the 3x3
# start 45, two shifted 4x4 Cholesky solves and normalisations 130, the two
# reprojections 70, the gates and the dedupe 15
K4_OPS_PER_QUERY = 60 + 10 + 50 + 112 + 45 + 130 + 70 + 15


def k4_bytes(n_features: int) -> int:
    """Least traffic of K4, with every query feature creating a landmark (at
    most ``n_features``): both keyframes' pixels (16 B a feature) and links
    read (8 B), the match read (13 B), the poses (56 B), each created
    landmark's row written (17 B) and its two links (8 B), the cursors."""
    return (16 + 8 + 13 + 17 + 8) * n_features + 56 + 16


def k4_ops(n_features: int) -> int:
    return n_features * K4_OPS_PER_QUERY


def bound_ms(n_bytes: int, n_ops: int = 0) -> float:
    """The least time of a kernel on an H100: the larger of its bytes over
    the memory rate and its float32 operations over the float32 rate."""
    hbm = DEVICE_PEAKS["NVIDIA H100"]["hbm_Bps"]
    return max(n_bytes / hbm, n_ops / F32_OPS_PER_S) * 1e3


# ---------------------------------------------------------------------------
# counting executed ops
# ---------------------------------------------------------------------------

_BYTES_ONLY = {"copy_", "_to_copy", "clone", "fill_", "zero_", "full", "zeros",
               "ones", "full_like", "zeros_like", "ones_like", "new_full",
               "new_zeros", "new_ones", "scalar_tensor", "lift_fresh_copy",
               "_reshape_copy"}
_FREE = {"empty", "empty_like", "empty_strided", "new_empty",
         "new_empty_strided", "detach", "alias", "lift_fresh", "_unsafe_view"}


def _is_view(func) -> bool:
    returns = func._schema.returns
    return bool(returns) and all(
        r.alias_info is not None and not r.alias_info.is_write for r in returns)


def _tensors(tree) -> list:
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class _OpCounter(TorchDispatchMode):
    """FLOPs and bytes of the aten ops run under it (module docstring)."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.suspended = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        # under inference_mode a composite op (matmul, reshape, to, ...)
        # reaches the mode whole: count the ops it decomposes into
        with self:
            out = func.decompose(*args, **kwargs)
        if out is not NotImplemented:
            return out
        out = func(*args, **kwargs)
        if not self.suspended:
            self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        name = func._overloadpacket.__name__
        if name in _FREE or _is_view(func):
            return
        ins = {id(t): t for t in _tensors((args, kwargs))}
        outs = _tensors(out)
        self.bytes += sum(map(_nbytes, ins.values())) + sum(map(_nbytes, outs))
        if name in _BYTES_ONLY:
            return
        formula = flop_counter.flop_registry.get(func._overloadpacket)
        if formula is not None:
            self.flops += formula(*args, **kwargs, out_val=out)
        elif torch.Tag.reduction in func.tags:
            self.flops += sum(t.numel() for t in ins.values())
        else:
            self.flops += sum(t.numel() for t in outs)


_counters: list[_OpCounter] = []   # the active counters, innermost last


@contextlib.contextmanager
def unit(name: str, flops: float, n_bytes: float):
    """Count the work inside as ``flops`` and ``n_bytes``, whatever runs
    there: adds them to the active counter (if any) and suspends its op
    counting. A hand-written kernel's wrapper puts its launch and its plain
    version inside, so either counts the kernel's analytic work once. A
    unit inside another unit adds nothing. ``name`` says whose work it is."""
    c = _counters[-1] if _counters else None
    if c is None or c.suspended:
        yield
        return
    c.flops += flops
    c.bytes += n_bytes
    c.suspended += 1
    try:
        yield
    finally:
        c.suspended -= 1


def op_cost(fn, *args, **kwargs) -> dict:
    """{'flops', 'bytes'} of one call ``fn(*args, **kwargs)``, counted over
    the ops it executes (module docstring), under ``inference_mode``."""
    counter = _OpCounter()
    _counters.append(counter)
    try:
        with torch.inference_mode(), counter:
            fn(*args, **kwargs)
    finally:
        _counters.pop()
    return {"flops": float(counter.flops), "bytes": float(counter.bytes)}


# ---------------------------------------------------------------------------
# stage inventories
# ---------------------------------------------------------------------------

@dataclass
class StageCost:
    name: str
    flops_per_exec: float
    bytes_per_exec: float
    execs_per_frame: float   # amortized execution count per frame

    @property
    def flops_per_frame(self) -> float:
        return self.flops_per_exec * self.execs_per_frame

    @property
    def bytes_per_frame(self) -> float:
        return self.bytes_per_exec * self.execs_per_frame


class _Inventory:
    """Zero-filled stage inputs of one shape on one device, and the list
    of stage costs counted on them."""

    def __init__(self, img_hw, n_features: int, orb_kwargs, device):
        self.dev = torch.device(device if device is not None else "cuda")
        H, W = img_hw
        N = self.N = n_features
        self.orb_kw = dict(orb_kwargs or {})
        self.orb_kw.setdefault("n_slots", N)
        z = lambda *s, dtype=torch.float32: torch.zeros(s, dtype=dtype,
                                                        device=self.dev)
        self.g8 = z(8, H, W, dtype=torch.uint8)
        self.desc = z(N, 32, dtype=torch.uint8)
        self.vmask = torch.ones((N,), dtype=torch.bool, device=self.dev)
        self.px = z(N, 2)
        self.pts3 = z(N, 3)
        self.costs: list[StageCost] = []

    def add(self, name, fn, args, execs) -> None:
        """Count one call ``fn(*args())`` after a warm-up call (which fills
        the stage's cached tables); ``args`` makes fresh inputs, since some
        stages update their map in place."""
        fn(*args())
        c = op_cost(fn, *args())
        self.costs.append(StageCost(name, c["flops"], c["bytes"], execs))

    def extract(self) -> None:
        """One extraction of a chunk of 8 frames (K1 once)."""
        from ..models.orb_torch import orb_extract

        self.add("extract", lambda g: orb_extract(g, **self.orb_kw),
                 lambda: (self.g8,), 1.0 / 8.0)


def scan_stage_costs(
    cam,
    opts,
    img_hw: tuple[int, int],
    *,
    n_features: int = 1024,
    kf_capacity: int = 64,
    lm_capacity: int = 1 << 17,
    orb_kwargs: dict | None = None,
    events_per_frame: float = 1.0 / 3.0,
    ba_iters_avg: float = 3.0,
    device=None,
) -> list[StageCost]:
    """Per-stage cost inventory of the ONLINE scan (BASELINE config 1), on
    ``device`` (default: the card).

    ``events_per_frame``: measured keyframe-event rate of the run
    (sum(is_keyframe)/T); ``ba_iters_avg``: average local-BA GN iterations
    actually applied (one iteration is counted and multiplied).
    """
    # the stages are imported here: ops.detect (under them) imports this
    # module for ``unit``
    from ..models import matching
    from ..models.estimation import pnp_prior
    from ..models.local_ba import BAOptions, local_ba
    from ..ops.se3 import identity_pose
    from ..tracking import mapstate as msl
    from ..tracking import stages
    from ..tracking.mapstate import FREE
    from ..tracking.scan_pipeline import initial_state

    inv = _Inventory(img_hw, n_features, orb_kwargs, device)
    dev, N, vmask = inv.dev, inv.N, inv.vmask
    ident = identity_pose(device=dev)

    def fresh_map():   # the stages update the map in place
        return initial_state(N, kf_capacity, lm_capacity, dev).ms

    inv.extract()
    # the matcher: one knn2 GEMM per frame (the event re-uses the raw match)
    inv.add("match",
            lambda a, b: matching.knn2_ratio_match(a, vmask, b, vmask),
            lambda: (inv.desc, inv.desc), 1.0)
    # PnP, the steady-state prior tier
    inv.add("pnp_prior",
            lambda p3, p2: pnp_prior(cam, p3, p2, vmask, ident,
                                     opts.max_reproj_error, refine_iters=2),
            lambda: (inv.pts3, inv.px), 1.0)

    # the keyframe event: insert + depth landmarks + triangulation
    def event_fn(ms, pxq, d, dsc):
        links = torch.full((N,), FREE, dtype=torch.int32, device=dev)
        ms, slot = msl.insert_keyframe(ms, 3, ident, pxq, dsc, vmask, links, d,
                                       fresh_links=True)
        ms = stages.depth_landmarks(ms, cam, slot, ident)
        return stages.triangulate_pair(ms, cam, 0, slot,
                                       opts.triangulation_min_angle_deg,
                                       opts.triangulation_max_reproj_error)

    inv.add("kf_event(insert+depth_lm+tri)", event_fn,
            lambda: (fresh_map(), inv.px, torch.ones((N,), device=dev), inv.desc),
            events_per_frame)
    # local BA: one GN iteration, x the measured average iterations
    ba_opts = BAOptions(
        window_size=opts.ba_window_size, max_iterations=1,
        min_pose_observations=opts.ba_min_pose_observations,
        min_point_observations=opts.ba_min_point_observations,
        huber_delta=opts.ba_huber_delta,
        max_reproj_error=opts.ba_max_reproj_error,
        rel_tol=opts.ba_rel_tol, early_exit=False,
    )
    if opts.enable_local_ba:
        inv.add("local_ba(per GN iter)", lambda m: local_ba(m, cam, ba_opts),
                lambda: (fresh_map(),), events_per_frame * ba_iters_avg)
    return inv.costs


def offline_stage_costs(
    cam,
    opts,
    img_hw: tuple[int, int],
    *,
    n_features: int = 1024,
    kf_capacity: int = 128,
    orb_kwargs: dict | None = None,
    keyframes_per_frame: float = 1.0 / 3.0,
    gba_calls_per_frame: float = 1.0 / 240.0,
    device=None,
) -> list[StageCost]:
    """Stage cost inventory of the OFFLINE pipeline (the bench headline), on
    ``device`` (default: the card).

    LOWER BOUND, as in the JAX package: the global-BA solve and the map
    build are left out (``kf_capacity`` and ``gba_calls_per_frame`` are
    the JAX signature's and count nothing); the PnP stages are counted as
    the JAX inventory calls them, without depth (DLT hypotheses)."""
    from ..models import matching
    from ..models.estimation import pnp_ransac
    from ..ops.se3 import identity_pose

    inv = _Inventory(img_hw, n_features, orb_kwargs, device)
    dev, vmask = inv.dev, inv.vmask
    ident = identity_pose((1,), device=dev)

    def pnp(n_hypotheses, refine_iters):
        def fn(p3, p2):
            gen = torch.Generator(device=dev)
            gen.manual_seed(0)
            return pnp_ransac(cam, p3[None], p2[None], vmask[None], gen,
                              opts.max_reproj_error, n_hypotheses=n_hypotheses,
                              refine_iters=refine_iters, init_pose=ident)
        return fn

    inv.extract()
    # matcher GEMMs: consecutive pair + keyframe chain (amortized) +
    # re-track = ~2.3 matches a frame
    inv.add("match",
            lambda a, b: matching.match_frames(a, vmask, b, vmask),
            lambda: (inv.desc, inv.desc), 2.0 + keyframes_per_frame)
    # pair-stage PnP (16 hypotheses, refine 2) + re-track PnP (8, refine 3)
    inv.add("pnp_pair", pnp(16, 2), lambda: (inv.pts3, inv.px), 1.0)
    inv.add("pnp_retrack", pnp(8, 3), lambda: (inv.pts3, inv.px), 1.0)
    return inv.costs


def summarize(costs: list[StageCost], t_per_frame_s: float,
              peaks: dict | None = None) -> dict:
    """Aggregate a stage inventory against a measured per-frame time."""
    peaks = peaks or device_peaks()
    flops = sum(c.flops_per_frame for c in costs)
    byts = sum(c.bytes_per_frame for c in costs)
    out = {
        "flops_per_frame": flops,
        "bytes_per_frame": byts,
        "achieved_gflops": flops / t_per_frame_s / 1e9,
        "achieved_gbs": byts / t_per_frame_s / 1e9,
        "arithmetic_intensity": flops / max(byts, 1.0),
        "device_kind": peaks.get("device_kind"),
    }
    if peaks.get("flops_bf16"):
        out["mfu_vs_bf16_peak"] = flops / t_per_frame_s / peaks["flops_bf16"]
        out["bw_util_vs_hbm_peak"] = byts / t_per_frame_s / peaks["hbm_Bps"]
        # roofline: time lower bounds from compute and bandwidth
        t_compute = flops / peaks["flops_bf16"]
        t_bw = byts / peaks["hbm_Bps"]
        out["roofline_bound"] = "compute" if t_compute > t_bw else "bandwidth"
        out["roofline_floor_us_per_frame"] = max(t_compute, t_bw) * 1e6
    return out
