"""The import guard: what the command loads for each cell holds no module
whose top-level name (compared whole: the port's name begins with the JAX
package's) is ``jax``, ``jaxlib``, ``flax`` or ``visionx_slam_tpu``, with
those blocked from import; and the reference loads nothing of the
program."""

import json
import os
import subprocess
import sys
from pathlib import Path

from slambench import run

ROOT = Path(__file__).resolve().parents[1]
CELLS = run.cells()

BLOCK = """
import sys
BLOCKED = {"jax", "jaxlib", "flax", "visionx_slam_tpu"}
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked: {name}")
sys.meta_path.insert(0, Block())
"""


def _run(code: str) -> dict:
    env = dict(os.environ, OMP_NUM_THREADS="2")
    res = subprocess.run([sys.executable, "-c", BLOCK + code], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


def test_no_cell_loads_jax_or_the_jax_package():
    code = f"""
import json, time, torch
torch.set_num_threads(2)
from slambench import run, small
for cell in {CELLS!r}:
    for trace in (False, True):
        run.run_cell(small.spec(cell), 2**31 + 3, 0.1, trace, "cpu", time.time())
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""
    names = set(_run(code))
    assert not names & {"jax", "jaxlib", "flax", "visionx_slam_tpu"}
    assert "visionx_slam_torch" in names


def test_the_reference_loads_nothing_of_the_program():
    code = """
import json
import numpy as np
from slambench.data import scene
from slambench.reference import judge
pose = np.tile(np.eye(4), (5, 1, 1))
cap = scene.Capture.from_config(json.load(open("slambench/configs/tum_rgbd_fr1.json")))
judge.trajectory(pose, cap.trajectory(range(5))[1], False)
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""
    names = set(_run(code))
    assert "visionx_slam_torch" not in names
    assert not names & {"jax", "jaxlib", "flax", "visionx_slam_tpu"}
