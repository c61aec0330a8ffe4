"""The port's long-sequence stress (``visionx_slam_torch/tools/long_stress.py``)
against the JAX package's scan on a short periodic loop: the bench loop
(scene seed 5) at a stride of 12, 20 frames, tiled twice, with a
4-slot keyframe ring (it wraps) and a 7168-landmark table (it compacts).
The JAX local BA needs a ring at least as large as its window, so both run
with ``ba_window_size=4``. RANSAC draws cannot be shared, so the single runs
agree in a band: tracked within 1 frame, ATE within 5 mm (the band of
tests/test_torch_scan.py), ``lm_dropped`` equal, keyframe events within
10%.

The split at frame 20 (not a multiple of the 8-frame extraction chunk)
equals the single run bit for bit on the CPU, in the port and in the JAX
package run as ``tools/long_stress.py`` runs it (the first call's final
state carried as ``st0``, ``frame0`` the split). A landmark table too small
for the map drops landmarks: the gate fails, and the tool exits 1.

ORB runs once per distinct frame (``torch_parity.OrbMemo``: a frame's
features do not depend on its chunk), so the tiles and the split cost no
second extraction."""

import functools
import json

import numpy as np
import pytest
import torch

import jax

from visionx_slam_tpu.tracking.scan_pipeline import run_scan_pipeline as jax_run
from visionx_slam_tpu.utils.config import TrackingOptions as JOpts

from visionx_slam_torch.eval.trajectory import ate_of_run
from visionx_slam_torch.ops import detect
from visionx_slam_torch.tools import long_stress
from visionx_slam_torch.tracking import scan_pipeline as TSP
from visionx_slam_torch.utils.config import TrackingOptions

from torch_parity import OrbMemo, cameras, sequence

N, REPS = 20, 2
SPLIT = 20
KW = dict(kf_capacity=4, lm_capacity=7168)


def _loop():
    # equal to make_sequence(240, seed=5)[::240 // N]
    return sequence(N, 5, frames_per_loop=N)


@pytest.fixture(scope="module")
def runs():
    grays, depths, gt = _loop()
    jc, tc = cameras()
    g2, d2 = np.tile(grays, (REPS, 1, 1)), np.tile(depths, (REPS, 1, 1))
    st_j, oj = jax_run(jc, g2, d2, JOpts(ba_window_size=4), **KW)
    jax.block_until_ready(oj)
    # JAX's split, as its tool runs it
    st1, o1 = jax_run(jc, g2[:SPLIT], d2[:SPLIT], JOpts(ba_window_size=4), **KW)
    p1 = np.asarray(o1.pose)
    _, o2 = jax_run(jc, g2[SPLIT:], d2[SPLIT:], JOpts(ba_window_size=4),
                    st0=st1, frame0=SPLIT, **KW)
    jax_split = np.concatenate([p1, np.asarray(o2.pose)])
    before = detect.launches
    with OrbMemo(TSP):
        r = long_stress.stress(tc, grays, depths, gt, REPS, SPLIT,
                               TrackingOptions(ba_window_size=4), "cpu", **KW)
    assert detect.launches == before     # CPU tensors take K1's plain version
    return st_j, oj, jax_split, r, np.tile(gt, (REPS, 1))


def test_stress_matches_jax_band(runs):
    st_j, oj, _, r, gt = runs
    tr_j = np.asarray(oj.tracked)
    ate_j, n_j = ate_of_run(np.asarray(oj.pose), tr_j, gt)
    assert r["frames"] == N * REPS
    assert abs(r["tracked"] - n_j) <= 1, (r["tracked"], n_j)
    assert abs(r["ate_m"] - ate_j) <= 0.005, (r["ate_m"], ate_j)
    # and within half of JAX's own ATE, so the band binds at this size
    assert abs(r["ate_m"] - ate_j) <= max(0.001, 0.5 * ate_j), (r["ate_m"], ate_j)
    assert r["lm_dropped"] == int(st_j.ms.lm_dropped) == 0
    ev_j = int(np.asarray(oj.is_keyframe).sum())
    assert abs(r["keyframe_events"] - ev_j) <= 0.1 * ev_j, (r["keyframe_events"], ev_j)
    # the ring wrapped and the table compacted
    assert r["keyframe_events"] > KW["kf_capacity"] and r["compactions"] >= 1
    assert r["map_keyframes"] == r["keyframes_final"] == KW["kf_capacity"]
    assert r["landmarks_peak"] <= KW["lm_capacity"]
    assert r["ok"]


def test_split_equals_single_run_in_both_packages(runs):
    _, oj, jax_split, r, _ = runs
    assert SPLIT % 8 != 0
    assert np.array_equal(jax_split, np.asarray(oj.pose))
    s = r["split"]
    assert s["at"] == SPLIT and s["bit_equal"] and s["max_pose_diff"] == 0.0
    assert s["lm_dropped"] == 0 and s["k1_launches"] == [0, 0]


def test_gate_and_exit_code_on_dropped_landmarks(monkeypatch, capsys):
    """A table of 1,500 landmarks cannot hold the init pair's: the
    allocator drops landmarks, the gate fails, the tool exits 1 (8 frames,
    no split)."""
    grays, depths, gt = (x[:8] for x in _loop())
    monkeypatch.setattr(long_stress, "LOOP_FRAMES", 8)
    monkeypatch.setattr(long_stress.synthetic, "make_sequence",
                        lambda n, seed: (grays, depths, gt))
    monkeypatch.setattr(long_stress, "stress", functools.partial(
        long_stress.stress, kf_capacity=4, lm_capacity=1500))
    assert long_stress.main(["--frames", "8", "--device", "cpu", "--json"]) == 1
    out = capsys.readouterr().out
    assert "STRESS FAIL" in out
    r = json.loads(out.strip().splitlines()[-1])
    assert r["lm_dropped"] > 0 and not r["ok"]
    assert r["frames"] == 8 and "split" not in r


def test_stress_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is here: the tool runs on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        long_stress.main(["--frames", "8"])
