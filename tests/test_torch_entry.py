"""The port's entry points (``visionx_slam_torch/entry.py``) against the
JAX package's ``__graft_entry__.py``.

- ``entry``'s example inputs equal the JAX entry's (numpy, seed 0).
- Its forward on the CPU: the ORB features of the 480x640 frame against
  JAX's ``orb_extract`` as the JAX forward runs it on the CPU (the XLA
  path, ``use_pallas`` off). That path differs from K1's plain version
  under the border mask and at rounding ties (tests/test_torch_orb.py), so
  the features are held as that file holds them: the same number of valid
  slots, keypoints at the same pixels (overlap >= 0.95 on this noise
  image) with descriptor bits agreeing >= 0.99. The pose is finite; on
  random landmarks its value means nothing, so it is not compared.
- ``python -m visionx_slam_torch.entry multichip 2 --device cpu``: the dry
  run on two ``gloo`` ranks passes its checks on every rank.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

from visionx_slam_tpu.models import orb_jax as OJ

from visionx_slam_torch import entry as TE
from visionx_slam_torch.models.orb_torch import orb_extract

from torch_parity import SINGLE_THREAD_ENV, to_np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def port_entry():
    return TE.entry("cpu")


def test_entry_inputs_equal_the_jax_entrys(port_entry):
    import __graft_entry__ as G

    _, args_j = G.entry()
    _, args_t = port_entry
    for a_t, a_j in zip(args_t[:4], args_j[:4]):
        assert to_np(a_t).dtype == np.asarray(a_j).dtype
        np.testing.assert_array_equal(to_np(a_t), np.asarray(a_j))


def _by_position(px, desc, valid):
    keys = np.round(px[valid] * 64).astype(np.int64)
    return {tuple(k): d for k, d in zip(keys, desc[valid])}


def test_entry_forward_matches_the_jax_features(port_entry):
    fn, args = port_entry
    pose, n_inl, n_valid = fn(*args)
    assert bool(torch.isfinite(pose.q).all() and torch.isfinite(pose.t).all())
    assert n_inl.shape == (1,) and int(n_inl[0]) >= 0

    gray = to_np(args[0])
    px_j, _, desc_j, valid_j = (np.asarray(a) for a in jax.jit(
        lambda g: OJ.orb_extract(g, use_pallas=0))(gray))
    px_t, _, desc_t, valid_t = (to_np(a[0]) for a in orb_extract(args[0][None]))
    assert int(n_valid) == int(valid_t.sum()) == int(valid_j.sum()) > 0
    ref = _by_position(px_j, desc_j, valid_j)
    mine = _by_position(px_t, desc_t, valid_t)
    shared = [k for k in mine if k in ref]
    assert len(shared) >= 0.95 * len(mine), len(shared) / len(mine)
    bits = np.unpackbits(np.stack([mine[k] for k in shared])
                         ^ np.stack([ref[k] for k in shared]))
    assert 1.0 - bits.mean() >= 0.99


def test_entry_command_line(capsys):
    assert TE.main(["--device", "cpu"]) == 0
    assert "entry ok" in capsys.readouterr().out
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit):
            TE.main([])


def test_dryrun_multichip_on_two_gloo_ranks():
    res = subprocess.run(
        [sys.executable, "-m", "visionx_slam_torch.entry", "multichip", "2",
         "--device", "cpu"], cwd=ROOT, env={**os.environ, **SINGLE_THREAD_ENV},
        capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    for rank in range(2):
        assert f"dryrun_multichip ok: Mesh(rank {rank} of 2, backend=gloo" in res.stdout
    assert "tracked=16/16" in res.stdout
