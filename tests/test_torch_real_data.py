"""The port's real-data harness (``visionx_slam_torch/tools/real_data_check.py``)
against the JAX package's (``tools/real_data_check.py``).

- Three rows of the sensor-degradation matrix (clean, depth holes, all
  combined) on the bench sequence's first 16 frames: the degraded arrays
  equal the JAX package's bit for bit, and the port's scan on them is
  within 1 tracked frame and 5 mm of ATE of the JAX scan on the same arrays
  (RANSAC draws cannot be shared; the band of tests/test_torch_scan.py).
- ``in_band`` decides as the JAX tool does: its own matrix function runs
  on hand-made rows (its scan, sequence loader and ATE replaced by stubs
  that return them), and its exit code and per-row verdicts are compared.
- ``--dataset_dir`` on a 20-frame synthetic TUM directory on the CPU
  prints the ``REAL DATA:`` line with the loader and exits 0.
- Both modes raise where there is no card unless ``--device cpu`` is given.
"""

import importlib.util
import os
import types

import numpy as np
import pytest
import torch

import jax

from visionx_slam_tpu.data import degrade as jax_degrade
from visionx_slam_tpu.tracking import scan_pipeline as jax_scan
from visionx_slam_tpu.utils.config import TrackingOptions as JOpts

from visionx_slam_torch.data import synthetic
from visionx_slam_torch.eval.trajectory import ate_of_run
from visionx_slam_torch.tools import real_data_check as rdc
from visionx_slam_torch.utils.config import TrackingOptions

from torch_parity import cameras, sequence

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROWS = ("clean", "depth_holes", "all_combined")
T = 16


def _jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_real_data_check", os.path.join(ROOT, "tools", "real_data_check.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def rows():
    # the bench sequence's first T frames
    grays, depths, gt = sequence(T, 5)
    jc, tc = cameras()
    inputs = {name: (g, d) for name, g, d in rdc.degraded_inputs(grays, depths)}
    out = {}
    for name in ROWS:
        g, d = inputs[name]
        _, oj = jax_scan.run_scan_pipeline(jc, g, d, JOpts())
        jax.block_until_ready(oj)
        ate_j, n_j = ate_of_run(np.asarray(oj.pose), np.asarray(oj.tracked), gt)
        out[name] = (rdc.scan_row(tc, name, g, d, gt, TrackingOptions(), "cpu"),
                     ate_j, n_j)
    return inputs, out, (grays, depths)


def test_degraded_inputs_equal_jax_in_its_order(rows):
    inputs, _, (grays, depths) = rows
    want = ["clean", *jax_degrade.DEGRADATIONS, "all_combined"]
    assert list(inputs) == want
    for name, fn in jax_degrade.DEGRADATIONS.items():
        g, d = fn(grays, depths, np.random.default_rng(7))
        assert np.array_equal(inputs[name][0], g) and np.array_equal(inputs[name][1], d)
    g, d = jax_degrade.degrade_all(grays, depths, np.random.default_rng(7))
    assert np.array_equal(inputs["all_combined"][0], g)
    assert np.array_equal(inputs["all_combined"][1], d)


@pytest.mark.parametrize("name", ROWS)
def test_degraded_row_matches_jax(rows, name):
    row, ate_j, n_j = rows[1][name]
    assert row["name"] == name and row["frames"] == T
    assert abs(row["tracked"] - n_j) <= 1, (row["tracked"], n_j)
    assert abs(row["ate_m"] - ate_j) <= 0.005, (row["ate_m"], ate_j)
    # and within half of JAX's own ATE, so the band binds at this size
    assert abs(row["ate_m"] - ate_j) <= max(0.001, 0.5 * ate_j), (row["ate_m"], ate_j)
    assert row["tracked_share"] == row["tracked"] / T
    assert row["k1_launches"] == 0          # CPU tensors take K1's plain version


# (ATE in m or None under 3 tracked frames, tracked share) per row, in the
# matrix's order: clean, the five models, all combined
BAND_CASES = {
    "all in band": [(0.004, 1.0)] + [(0.006, 1.0)] * 5 + [(0.019, 0.95)],
    "at the 20 mm floor": [(0.004, 1.0)] + [(0.020, 1.0)] * 6,
    "above the floor": [(0.004, 1.0)] + [(0.006, 1.0)] * 4 + [(0.021, 1.0)] * 2,
    "clean outside the ATE band is exempt, and widens it": (
        [(0.040, 1.0)] + [(0.100, 1.0)] * 5 + [(0.119, 1.0)]),
    "3 x a wide clean": [(0.040, 1.0)] + [(0.100, 1.0)] * 5 + [(0.121, 1.0)],
    "clean under 0.90 tracked": [(0.004, 0.85)] + [(0.006, 1.0)] * 6,
    "a row under 0.90 tracked": [(0.004, 1.0)] + [(0.006, 0.875)] + [(0.006, 1.0)] * 5,
    "a row with no ATE": [(0.004, 1.0)] + [(None, 0.1)] + [(0.006, 1.0)] * 5,
    "clean with no ATE": [(None, 0.1)] + [(0.006, 1.0)] * 6,
}


@pytest.mark.parametrize("case", BAND_CASES)
def test_in_band_equals_jax_rule(case, monkeypatch, capsys):
    made = BAND_CASES[case]
    names = ["clean", *jax_degrade.DEGRADATIONS, "all_combined"]
    tool = _jax_tool()
    import bench

    calls = iter(made)

    def fake_scan(cam, g, d, opts):
        ate, share = next(calls)
        tracked = np.arange(40) < round(share * 40)
        return None, types.SimpleNamespace(tracked=tracked, ate=ate)

    small = np.zeros((2, 16, 16), np.uint8), np.ones((2, 16, 16), np.float32)
    monkeypatch.setattr(bench, "_load_sequence",
                        lambda n: (None, None, None, *small, np.zeros((2, 3))))
    monkeypatch.setattr(bench, "_ate_from_outs", lambda outs, gts: (outs.ate, 0))
    monkeypatch.setattr(jax_scan, "run_scan_pipeline", fake_scan)
    rc_jax = tool.run_degradation_matrix(types.SimpleNamespace(frames=2))
    jax_verdicts = [line.rstrip(" |").rsplit("| ", 1)[-1] == "yes"
                    for line in capsys.readouterr().out.splitlines()
                    if line.startswith("| ") and not line.startswith("| degradation")]

    ours = [{"name": n, "ate_m": np.nan if a is None else a,
             "tracked_share": float(np.mean(np.arange(40) < round(s * 40)))}
            for n, (a, s) in zip(names, made)]
    ok, band = rdc.in_band(ours)
    assert (0 if ok else 1) == rc_jax, case
    verdicts = [line.rstrip(" |").rsplit("| ", 1)[-1] == "yes"
                for line in rdc.table(ours, band).splitlines()[2:9]]
    assert verdicts == jax_verdicts and len(verdicts) == 7, case


def test_dataset_dir_mode_on_synthetic_tum(tmp_path, capsys):
    seq = "rgbd_dataset_freiburg3_synthetic"
    synthetic.generate_sequence(str(tmp_path), sequence=seq, n_frames=20, seed=5)
    rc = rdc.main(["--dataset_dir", str(tmp_path), "--sequence", seq,
                   "--output_dir", str(tmp_path / "out"), "--frames", "20",
                   "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0
    line = next(x for x in out.splitlines() if x.startswith("REAL DATA: "))
    assert "tracked 20/20" in line, line
    assert line.rsplit("loader ", 1)[-1] in ("native", "python"), line
    assert os.path.exists(tmp_path / "out" / "trajectory.txt")


@pytest.mark.parametrize("argv", [[], ["--dataset_dir", "missing"]])
def test_real_data_check_needs_a_card_unless_asked_for_the_cpu(argv):
    if torch.cuda.is_available():
        pytest.skip("a card is here: the tool runs on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rdc.main(argv)
