"""The import guard of the benchmark cell ``rgbd.system_disk``: a run of the
cell through the harness, untraced and traced, at a size the CPU holds (4
frames taken 48 apart, an 8-slot ring, one global-BA iteration, one pass a
window), in a process where ``jax``, ``jaxlib``, ``flax`` and
``visionx_slam_tpu`` are blocked from import, loads none of them and loads
the port."""

import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
BLOCKED = {"jax", "jaxlib", "flax", "visionx_slam_tpu"}


def test_the_cell_loads_no_jax_nor_the_jax_package():
    code = f"""
import sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in {BLOCKED!r}:
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
import json, time, torch
torch.set_num_threads(1)
from slambench import run
spec = run.load_cell("rgbd.system_disk")
spec["traffic"] = dict(spec["traffic"], frames=4, frame_stride=48, min_passes=1,
                       system={{"kf_capacity": 8, "global_ba_iterations": 1}})
for trace in (False, True):
    out, _ = run.run_cell(spec, 2**31 + 3, 0.1, trace, "cpu", time.time())
    assert out["correct"], out["checks"]
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    names = set(json.loads(res.stdout.strip().splitlines()[-1]))
    assert not names & BLOCKED
    assert "visionx_slam_torch" in names
