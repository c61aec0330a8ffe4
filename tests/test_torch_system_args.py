"""``System --pipeline offline`` calls ``run_offline_pipeline`` as the JAX
package's ``System`` does: the same positional inputs and the same keyword
set with the same values, apart from the port's ``device`` (and the port's
own tracking option ``track_local_map``, off). A spy takes the
pipeline's place in each package and raises, so no pipeline runs: each side
only reads the 6 frames written to disk."""

from dataclasses import asdict

import numpy as np
import pytest

from visionx_slam_tpu.system import system as jsystem
from visionx_slam_tpu.tracking import offline_pipeline as jop
from visionx_slam_tpu.utils.config import SystemConfig as JaxSystemConfig

from visionx_slam_torch.data import synthetic
from visionx_slam_torch.system import system as tsystem
from visionx_slam_torch.utils.config import SystemConfig

import torch_parity  # noqa: F401  (one torch thread per test process)

SEQ = "rgbd_dataset_freiburg3_synthetic"
T = 6


class _Called(Exception):
    pass


def _spy(calls: list):
    def spy(*args, **kwargs):
        calls.append((args, kwargs))
        raise _Called
    return spy


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("seq"))
    synthetic.generate_sequence(root, n_frames=T, seed=5)
    return root


@pytest.mark.parametrize("flags", [
    {},
    {"monocular": True, "n_features": 500, "orb_resize_f32": True},
])
def test_offline_pipeline_gets_the_jax_systems_arguments(root, tmp_path,
                                                         monkeypatch, flags):
    jax_calls, port_calls = [], []
    # the JAX System imports the pipeline inside _run_offline, from its module
    monkeypatch.setattr(jop, "run_offline_pipeline", _spy(jax_calls))
    monkeypatch.setattr(tsystem, "run_offline_pipeline", _spy(port_calls))
    common = dict(dataset_dir=root, sequence=SEQ, pipeline="offline",
                  loader="python", **flags)
    with pytest.raises(_Called):
        jsystem.System(JaxSystemConfig(output_dir=str(tmp_path / "jax"),
                                       **common)).run()
    with pytest.raises(_Called):
        tsystem.System(SystemConfig(output_dir=str(tmp_path / "port"),
                                    device="cpu", **common)).run()
    (jargs, jkw), = jax_calls
    (pargs, pkw), = port_calls
    assert pkw.pop("device").type == "cpu"
    assert set(pkw) == set(jkw)
    for key in jkw:
        assert pkw[key] == jkw[key], key
    assert len(pargs) == len(jargs) == 4
    np.testing.assert_array_equal(
        [float(v) for v in pargs[0]], [float(v) for v in jargs[0]])   # camera
    for p, j in zip(pargs[1:3], jargs[1:3]):                          # frames
        assert p.shape == j.shape == (T, 480, 640)
        np.testing.assert_array_equal(p, j)
    opts = asdict(pargs[3])
    assert opts.pop("track_local_map") is False                       # options
    assert opts == asdict(jargs[3])
