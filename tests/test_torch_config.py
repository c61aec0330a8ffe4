"""The port's configuration and command line against the JAX package's:
both ``.cfg`` files and a command line parse to equal values (exactly; the
port has two more fields, ``device`` and ``TrackingOptions.track_local_map``,
a widening the reference lacks, off by default), the command line wins over
the file, and an unknown key warns."""

import dataclasses
import logging
import os

import pytest

from visionx_slam_tpu.cli import main as jmain
from visionx_slam_tpu.utils import config as jconfig

from visionx_slam_torch.cli import main as tmain
from visionx_slam_torch.utils import config as tconfig

CONFIG_DIR = os.path.join(os.path.dirname(__file__), "..", "config")
# the port's own fields: SystemConfig's and TrackingOptions'
PORT_ONLY = {"device", "track_local_map"}


def _same(t_cfg, j_cfg, device="cuda"):
    d = tconfig.config_to_dict(t_cfg)
    assert d.pop("device") == device
    assert d.pop("track_local_map") is False
    assert d == jconfig.config_to_dict(j_cfg)


def test_defaults_fields_and_order():
    t_names = [f.name for f in dataclasses.fields(tconfig.SystemConfig)]
    j_names = [f.name for f in dataclasses.fields(jconfig.SystemConfig)]
    assert [n for n in t_names if n != "device"] == j_names
    assert ([f.name for f in dataclasses.fields(tconfig.TrackingOptions)
             if f.name not in PORT_ONLY]
            == [f.name for f in dataclasses.fields(jconfig.TrackingOptions)])
    _same(tconfig.SystemConfig(), jconfig.SystemConfig())


@pytest.mark.parametrize("name", ["default.cfg", "reference_strict.cfg"])
def test_config_files_parse_equal(name):
    path = os.path.join(CONFIG_DIR, name)
    kv_t, kv_j = tconfig.parse_config_file(path), jconfig.parse_config_file(path)
    assert kv_t == kv_j and kv_t
    t_cfg = tconfig.apply_config_if_default(tconfig.SystemConfig(), kv_t, set())
    j_cfg = jconfig.apply_config_if_default(jconfig.SystemConfig(), kv_j, set())
    _same(t_cfg, j_cfg)
    # the same through the command line's --config
    _same(tmain.parse_config(["--config", path]),
          jmain.parse_config(["--config", path]))


def test_cli_argv_parses_equal_and_wins_over_the_file(tmp_path):
    cfg_file = tmp_path / "run.cfg"
    cfg_file.write_text("min_matches = 33   # comment\nmax_frames=7\n"
                        "enable_culling=yes\npipeline=scan\n")
    argv = ["--config", str(cfg_file), "--dataset_dir", "D", "--sequence", "S",
            "--max_frames", "20", "--min_parallax", "2.5", "--run_global_ba",
            "true", "--enable_local_ba", "false"]
    t_cfg = tmain.parse_config(argv + ["--device", "cpu"])
    _same(t_cfg, jmain.parse_config(argv), device="cpu")
    assert t_cfg.max_frames == 20                 # the command line wins
    assert t_cfg.tracking.min_matches == 33       # the file fills the rest
    assert t_cfg.tracking.enable_culling is True and t_cfg.pipeline == "scan"
    assert t_cfg.run_global_ba is True and t_cfg.tracking.enable_local_ba is False
    # the flag surfaces are the same apart from the port's own fields
    flags = lambda p: {a.dest for a in p._actions} - {"help"}
    assert flags(tmain.build_parser()) - PORT_ONLY == flags(jmain.build_parser())


def test_unknown_key_and_bad_value_warn(tmp_path, caplog):
    cfg_file = tmp_path / "bad.cfg"
    cfg_file.write_text("no_such_key=1\nmin_matches=many\nmin_inliers=9\n")
    with caplog.at_level(logging.WARNING, logger="vxs.config"):
        cfg = tmain.parse_config(["--config", str(cfg_file)])
    text = caplog.text
    assert "Unknown config key: no_such_key" in text
    assert "Bad value for min_matches" in text
    assert cfg.tracking.min_inliers == 9 and cfg.tracking.min_matches == 20
    assert tconfig.parse_config_file(str(tmp_path / "missing.cfg")) == {}
