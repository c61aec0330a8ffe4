"""The port's ``utils/flops.py`` against the JAX package's: ``summarize``
key for key and value for value, the stage inventories' names, order and
per-frame execution counts, and the op counter itself: a float32 matmul is
exactly 2·M·N·K FLOPs and (MK + KN + MN)·4 bytes, a view costs nothing,
the matcher's count at N=1024 lands near XLA's cost analysis of the JAX
matcher, and kernel K1's analytic work is counted once (its plain version's
ops not at all) inside ``orb_extract``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visionx_slam_tpu.models import matching as JM
from visionx_slam_tpu.utils import flops as JF
from visionx_slam_tpu.utils.config import TrackingOptions as JOpts

from visionx_slam_torch.models import matching as TM
from visionx_slam_torch.models import orb_torch as OT
from visionx_slam_torch.ops import detect
from visionx_slam_torch.utils import flops as TF
from visionx_slam_torch.utils.config import TrackingOptions

from torch_parity import cameras, sequence

STAGES = [("extract", 16.4e9, 1.8e9, 0.125), ("match", 5.46e8, 6.7e7, 1.0),
          ("pnp_prior", 1.9e6, 6.7e6, 1.0), ("local_ba(per GN iter)", 3.7e6, 0, 1.0)]


@pytest.mark.parametrize("kind", ["NVIDIA H100", "cpu", "unknown"])
def test_summarize_equals_jax(kind):
    """The same stage list and peaks through both ``summarize``s: the H100
    row (the JAX table has none), the CPU row (equal in both tables), and a
    device without peaks."""
    if kind == "unknown":
        peaks = dict(flops_bf16=None, flops_int8=None, hbm_Bps=None)
    else:
        peaks = TF.DEVICE_PEAKS[kind]
    if kind == "cpu":
        assert peaks == JF.DEVICE_PEAKS["cpu"]
    peaks = dict(peaks, device_kind=kind)
    t = TF.summarize([TF.StageCost(*s) for s in STAGES], 2.75e-3, peaks)
    j = JF.summarize([JF.StageCost(*s) for s in STAGES], 2.75e-3, peaks)
    assert list(t) == list(j)
    assert t == j


def test_cpu_peaks_equal_jax():
    assert TF.device_peaks("cpu") == JF.device_peaks()


@pytest.mark.parametrize("which, kw", [
    ("scan", dict(events_per_frame=0.25, ba_iters_avg=2.0)),
    ("scan_no_ba", dict(events_per_frame=0.5)),
    ("offline", dict(keyframes_per_frame=0.5))])
def test_inventories_list_the_jax_stages(which, kw, monkeypatch):
    """Names, order and execs_per_frame equal the JAX inventory's at a small
    image (XLA's costs are not asked for: they do not set these); the port's
    counts are positive and finite."""
    monkeypatch.setattr(JF, "xla_cost", lambda fn, *a, **k: {"flops": 0.0,
                                                            "bytes": 0.0})
    jc, tc = cameras()
    shape = dict(n_features=256)
    if which == "offline":
        j = JF.offline_stage_costs(jc, JOpts(), (240, 320), **shape, **kw)
        t = TF.offline_stage_costs(tc, TrackingOptions(), (240, 320), **shape,
                                   device="cpu", **kw)
    else:
        ba = which == "scan"
        shape.update(kf_capacity=4, lm_capacity=4096)
        j = JF.scan_stage_costs(jc, JOpts(enable_local_ba=ba), (240, 320),
                                **shape, **kw)
        t = TF.scan_stage_costs(tc, TrackingOptions(enable_local_ba=ba),
                                (240, 320), **shape, device="cpu", **kw)
    assert [(c.name, c.execs_per_frame) for c in t] == \
        [(c.name, c.execs_per_frame) for c in j]
    for c in t:
        assert 0 < c.flops_per_exec < 1e12 and 0 < c.bytes_per_exec < 1e12, c


def test_op_cost_of_a_matmul_and_a_view():
    M, K, N = 48, 40, 24
    a, b = torch.randn(M, K), torch.randn(K, N)
    assert TF.op_cost(lambda: a @ b) == {"flops": 2.0 * M * N * K,
                                          "bytes": (M * K + K * N + M * N) * 4.0}
    assert TF.op_cost(lambda: a.view(K, M).T[1:].unsqueeze(0)) == {
        "flops": 0.0, "bytes": 0.0}
    # counting changes no result
    out = {}
    TF.op_cost(lambda: out.setdefault("ab", a @ b))
    assert torch.equal(out["ab"], a @ b)


def test_match_flops_near_xla():
    """The port's matcher at N=1024 against XLA's cost analysis of the JAX
    ``match_frames`` on the CPU (576.8 MFLOP): both are the [N,256]x[256,N]
    GEMM (536.9 MFLOP) and a few passes over the [N,N] distances."""
    n = 1024
    desc = np.zeros((n, 32), np.uint8)
    valid = np.ones((n,), bool)
    j = JF.xla_cost(lambda a, b: JM.match_frames(a, jnp.asarray(valid), b,
                                                 jnp.asarray(valid)),
                    jnp.asarray(desc), jnp.asarray(desc))
    d, v = torch.from_numpy(desc), torch.from_numpy(valid)
    t = TF.op_cost(TM.match_frames, d, v, d, v)
    assert 2 * n * n * 256 < t["flops"]
    assert 0.8 <= t["flops"] / j["flops"] <= 1.25, (t, j)


def test_kernel_units_count_the_analytic_work_on_the_cpu():
    """On a CPU tensor the wrappers run the plain versions; the count is
    the kernels' analytic work, exactly, and none of the plain ops."""
    rng = np.random.default_rng(0)
    img = torch.from_numpy((rng.random((2, 64, 96)) * 255).astype(np.float32))
    mask = torch.ones((64, 96), dtype=torch.int8)
    assert TF.op_cost(detect.fast_harris_blur, img.to(torch.bfloat16), mask) == {
        "flops": float(TF.k1_ops(img.shape)), "bytes": float(TF.k1_bytes(img.shape))}
    assert TF.op_cost(detect.fast_harris_score, img) == {
        "flops": float(TF.k1b_ops(img.shape)), "bytes": float(TF.k1b_bytes(img.shape))}
    # the plain version alone is counted op by op, far above the bound
    plain = TF.op_cost(detect.fast_harris_blur_reference, img.to(torch.bfloat16), mask)
    assert plain["bytes"] > 10 * TF.k1_bytes(img.shape)


def test_extract_count_holds_k1_once(monkeypatch):
    """``orb_extract`` over 8 bench frames ([8,1896,640] atlas) counts K1's
    78,873,600 bytes once: its count less the count with K1's outputs handed
    in (no K1 at all) is exactly K1's analytic work."""
    grays, _, _ = sequence(8, 5)
    g = torch.from_numpy(grays)
    atlas, mask = OT.build_atlas(g)
    assert tuple(atlas.shape) == (8, 1896, 640)
    assert TF.k1_bytes(atlas.shape) == 78_873_600
    k1_out = detect.fast_harris_blur_reference(atlas, mask, 20.0)
    with_k1 = TF.op_cost(OT.orb_extract, g)
    monkeypatch.setattr(OT, "fast_harris_blur", lambda *a: k1_out)
    without = TF.op_cost(OT.orb_extract, g)
    assert with_k1["bytes"] - without["bytes"] == TF.k1_bytes(atlas.shape)
    assert with_k1["flops"] - without["flops"] == TF.k1_ops(atlas.shape)
