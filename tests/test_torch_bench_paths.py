"""The port's bench entry in this process: ``--batch 2 --frames 8`` (two
sequences as folded lanes) and ``--pipeline scan --frames 8`` (with the
scan's stage counts and MFU block) on the CPU; each ends in a compact JSON
line after the whole result. The frames go through
``torch_parity.OrbMemo``, which extracts each frame once for all the runs."""

import json
import math

from visionx_slam_torch import bench as TB
from visionx_slam_torch.tracking import offline_pipeline as TOP
from visionx_slam_torch.tracking import scan_pipeline as TSP

from torch_parity import OrbMemo


def _run(argv, capsys):
    assert TB.main(argv + ["--device", "cpu", "--runs", "2"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines[-1]) <= TB.SUMMARY_MAX_CHARS
    return json.loads(lines[-2]), json.loads(lines[-1])


def test_batched_offline_lanes(capsys):
    with OrbMemo(TOP):
        full, summary = _run(["--batch", "2", "--frames", "8"], capsys)
    d = full["detail"]
    assert d["batch"] == summary["batch"] == 2 and d["frames_per_seq"] == 8
    assert d["n_runs"] == 2 and d["tracked_frac"] >= 0.9
    assert summary["ate_rmse_m_mean"] < 0.02
    assert summary["value"] == d["fps_median"] > 0


def test_scan_headline_with_its_stage_counts(capsys):
    with OrbMemo(TSP):
        full, summary = _run(["--pipeline", "scan", "--frames", "8"], capsys)
    d = full["detail"]
    assert d["pipeline"] == "scan" and d["n_frames"] == 8 and d["n_runs"] == 2
    assert d["n_tracked"] >= 7 and d["ate_rmse_m"] < 0.02
    assert "configs" not in d
    roof = d["roofline"]
    assert roof["device_kind"] == "cpu" and roof["flops_per_frame"] > 5e8
    for k in ("mfu_vs_bf16_peak", "bw_util_vs_hbm_peak",
              "roofline_floor_us_per_frame"):
        assert math.isfinite(roof[k]) and roof[k] > 0
    assert summary["mfu"] == d["mfu"] == roof["mfu_vs_bf16_peak"]
