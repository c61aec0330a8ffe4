"""The port's monocular offline pipeline with the loop closure on, on the
JAX package's two-loop fixture (tests/test_offline_mono.py ``looped_seq``:
48 frames of 640x480, scene seed 13, twice round a 24-frame loop) with
``kf_capacity`` 16 and that test's mono budget, held to the invariants of
tests/test_offline_mono.py::test_mono_loop_closure_engages_and_bounded for
``mono_loop_pairs=12`` and for ``mono_loop_merge=True``: the loop closure
engages (the poses differ from the run without it), tracks at least 95% of
the frames, and its scale-aligned ATE is at most max(2 x the run without
it, 0.05 m); it verifies revisiting frames with factors within [1/4, 4],
and the merge verifies pairs and merges links into a consistent map (live
links point at live landmarks, ``lm_obs`` counts them). A JAX pipeline run
of this length does not fit the file's time on the CPU: the stages are
held to the JAX package by tests/test_torch_mono_loop.py.

``lm_capacity`` below the map's need (200 rows for the map of the first 8
frames) caps the table and counts the dropped landmarks. The frames go through ``torch_parity.OrbMemo``, which
extracts each frame once for all the runs of the file.
"""

import numpy as np
import pytest
import torch

from visionx_slam_torch.eval.trajectory import ate_of_run
from visionx_slam_torch.tracking import offline_pipeline as TOP
from visionx_slam_torch.utils.config import TrackingOptions

from torch_parity import OrbMemo, cameras, sequence, to_np

MONO_KW = dict(monocular=True, kf_capacity=16, mono_pair_hypotheses=64,
               mono_lo_starts=2, mono_sample_bias=64.0, mono_score_top_k=32)
CONFIGS = {"off": {}, "scale": dict(mono_loop_pairs=12),
           "merge": dict(mono_loop_pairs=12, mono_loop_merge=True)}
CAP = 200


@pytest.fixture(scope="module")
def runs():
    grays, _, gt = sequence(48, 13, 24)
    zero = np.zeros(grays.shape, np.float32)
    _, tc = cameras()
    out = {}
    with OrbMemo(TOP):
        for name, kw in CONFIGS.items():
            stats, timings = {}, {}
            ms, o = TOP.run_offline_pipeline(tc, grays, zero, TrackingOptions(),
                                             device="cpu", stats=stats,
                                             timings=timings, **MONO_KW, **kw)
            ate, n_tr = ate_of_run(to_np(o.pose), to_np(o.tracked), gt, with_scale=True)
            out[name] = dict(ms=ms, out=o, ate=ate, tracked=n_tr, stats=stats,
                             timings=timings)
        # the first 8 frames into a table of CAP rows
        out["capped"] = TOP.run_offline_pipeline(
            tc, grays[:8], zero[:8], TrackingOptions(), device="cpu",
            **dict(MONO_KW, kf_capacity=8), lm_capacity=CAP)
    return out


@pytest.mark.parametrize("name", ["scale", "merge"])
def test_loop_closure_engages_and_is_bounded(runs, name):
    r, off = runs[name], runs["off"]
    assert not torch.equal(r["out"].pose, off["out"].pose)
    assert r["tracked"] >= 0.95 * 48, r["tracked"]
    assert r["ate"] <= max(2 * off["ate"], 0.05), (r["ate"], off["ate"])
    st = r["stats"]
    assert st["loop_verified_frames"] > 0
    assert 0.25 <= st["loop_factor_min"] <= st["loop_factor_max"] <= 4.0, st
    assert "loop_scale" in r["timings"]
    assert ("refine_wide" in r["timings"]) == (name == "merge")


def test_loop_merge_leaves_a_consistent_map(runs):
    r = runs["merge"]
    ms, st = r["ms"], r["stats"]
    assert st["loop_pairs_verified"] > 0 and st["loop_links_merged"] > 0, st
    flm = to_np(ms.kf_feat_lm)
    live = flm[(flm >= 0) & to_np(ms.kf_fvalid) & (to_np(ms.kf_id) >= 0)[:, None]]
    assert to_np(ms.lm_alive)[live].all()
    np.testing.assert_array_equal(to_np(ms.lm_obs),
                                  np.bincount(live, minlength=ms.lm_obs.shape[0]))



def test_lm_capacity_caps_the_table(runs):
    full = runs["merge"]["ms"]
    assert full.lm_pos.shape[1] == 16 * 1024 + 1024 and int(full.lm_dropped) == 0
    ms, out = runs["capped"]
    # every live keyframe feature with a depth in the gate wants a landmark
    dep = to_np(ms.kf_depth)
    want = (to_np(ms.kf_fvalid) & (to_np(ms.kf_id) >= 0)[:, None]
            & (dep >= 0.1) & (dep <= 10.0)).sum()
    assert ms.lm_pos.shape[1] == CAP + 1024 and int(ms.next_lm) == CAP
    assert int(ms.lm_dropped) == want - CAP > 0
    assert int(out.n_landmarks) == CAP and np.isfinite(to_np(out.pose)).all()

