"""A later change adds a cell with files of its own: a configuration, a
traffic mix with a feed of a new kind, its limits and a new end-to-end
metric, plus entries in BENCHMARK.json; no existing file of the benchmark
is edited."""

import json
import shutil
from pathlib import Path

import torch

from slambench import run, small

ROOT = Path(__file__).resolve().parents[1]

FEED = """from .offline import Offline


class Reversed(Offline):
    \"\"\"The offline pass over the frames in reverse order.\"\"\"

    def __init__(self, cfg, traffic, seed, device):
        super().__init__(cfg, traffic, seed, device)
        self.ids, self.g, self.d = self.ids[::-1].copy(), self.g.flip(0), self.d.flip(0)


FEED = Reversed
"""

METRIC = """def read(ctx):
    return ctx["wall_s"] / ctx["frames"]
"""


def test_a_cell_from_new_files(tmp_path, monkeypatch):
    shutil.copytree(ROOT / "slambench", tmp_path / "slambench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    new = tmp_path / "slambench"
    before = {p: p.read_bytes() for p in new.rglob("*") if p.is_file()}
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((new / "configs/tum_rgbd_fr2_desk.json").read_text())
    cfg.update(name="tum_rgbd_fr2_desk_96", offline=dict(kf_capacity=96))
    (new / "configs/tum_rgbd_fr2_desk_96.json").write_text(json.dumps(cfg))
    (new / "traffic/offline_reversed.json").write_text(json.dumps(
        {"feed": "offline_reversed", "start": 60}))
    (new / "feeds/offline_reversed.py").write_text(FEED)
    (new / "metrics/pass_s_per_frame.py").write_text(METRIC)
    (new / "limits/rgbd.reversed.json").write_text(
        (new / "limits/rgbd.offline.json").read_text())
    base = next(c for c in bench["configs"] if c["name"] == "tum_rgbd_fr2_desk")
    bench["configs"].append(dict(base, name=cfg["name"],
                                 file="slambench/configs/tum_rgbd_fr2_desk_96.json"))
    bench["workloads"].append({"name": "rgbd.reversed", "config": cfg["name"],
                               "traffic": "offline_reversed", "chips": 1,
                               "why": "a test cell"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "rgbd.offline" in m.get("workloads", ()):
            m["workloads"].append("rgbd.reversed")
    bench["end_to_end"].append({"name": "pass_s_per_frame", "unit": "s",
                                "better": "lower", "bound": 0.25,
                                "source": "host_clock",
                                "workloads": ["rgbd.reversed"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    # the copy's package, as a checkout of it would import it
    monkeypatch.syspath_prepend(str(tmp_path))
    for name in [m for m in list(__import__("sys").modules) if m.split(".")[0] == "slambench"]:
        monkeypatch.delitem(__import__("sys").modules, name)
    from slambench import run as run2, small as small2

    spec = run2.load_cell("rgbd.reversed", tmp_path)
    assert spec["config"]["offline"]["kf_capacity"] == 96
    assert spec["traffic"]["start"] == 60
    assert [m["name"] for m in spec["end_to_end"]] == [
        "map_fps", "setup_s", "pass_s_per_frame"]
    assert {m["name"] for m in spec["per_layer"]} == {
        m["name"] for m in run.load_cell("rgbd.offline")["per_layer"]}
    spec["traffic"].update(small.SMALL["offline"])
    torch.set_num_threads(2)
    out = small2.run(spec, 2**31 + 9, 0.5)
    assert out["correct"] is True, out["checks"]
    assert set(out["metrics"]) == {"map_fps", "setup_s", "pass_s_per_frame"}
    assert out["metrics"]["pass_s_per_frame"]["value"] > 0
    traced = small2.run(spec, 2**31 + 9, 0.5, trace=True)
    assert traced["device"]["window_s"] > 0
    after = {p: p.read_bytes() for p in before}
    assert after == before
