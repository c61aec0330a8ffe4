"""The benchmark's sequence on the CPU: its scene is the port's
``data/synthetic.py::make_scene``, its images are the port's
``render_frame`` at the same poses through the configuration's camera, and
its loop moves at the configuration's mean speeds.

The images are compared exactly at every pixel whose float64 decisions lie
clear of a rounding tie: the texture cell (a floor of the texture
coordinate), the 1/5000 m depth step (a floor of depth x 5000) and the
nearer of two planes. Both renderers compute those decisions in float64,
but in other orders (the port's ``dirs @ R.T`` is a BLAS product), so a
pixel whose decision value lies within 1e-9 of its boundary may fall either
way; such a pixel is allowed to differ and every other pixel is not. The
test also requires such pixels to be rare.
"""

import json
from pathlib import Path

import numpy as np
import pytest

from slambench.data import scene
from visionx_slam_torch.data import synthetic

ROOT = Path(__file__).resolve().parents[1]
CFG = json.loads((ROOT / "slambench/configs/tum_rgbd_fr1.json").read_text())
CAP = scene.Capture.from_config(CFG)
FRAMES = [0, 37, 120, 239, 701]
TIE = 1e-9


@pytest.mark.parametrize("seed", [5, 2**31 + 17])
def test_render_equals_the_ports_renderer(seed):
    planes = scene.make_scene(seed)
    port = synthetic.make_scene(seed % (1 << 64))
    for a, b in zip(planes, port):
        assert all(np.array_equal(getattr(a, f), getattr(b, f)) for f in
                   ("point", "normal", "u_axis", "v_axis", "texture"))
    R, t = CAP.trajectory(FRAMES)
    gray, depth, margin = CAP.render(planes, R, t, "cpu", margins=True)
    c = CFG["camera"]
    intr = {k: float(c[k]) for k in ("fx", "fy", "cx", "cy")}
    ties = 0
    for k in range(len(FRAMES)):
        g, d = synthetic.render_frame(port, R[k], t[k], intr)
        d16 = np.clip(d * c["depth_scale"], 0, 65535).astype(np.uint16)
        dq = d16.astype(np.float32) / c["depth_scale"]
        differ = (gray[k].numpy() != g) | (depth[k].numpy() != dq)
        at_tie = margin[k].numpy() < TIE
        assert not (differ & ~at_tie).any()
        ties += int(at_tie.sum())
    assert ties < 1e-4 * len(FRAMES) * CAP.height * CAP.width


def test_the_loop_moves_at_the_configurations_mean_speeds():
    """TUM's mean speeds, frame to frame at the camera's rate over a loop,
    and the loop closes on itself."""
    R, t = CAP.trajectory(np.arange(CAP.loop_frames + 1))
    speed = np.linalg.norm(np.diff(t, axis=0), axis=1).mean() * CAP.rate_hz
    turn = np.rad2deg(scene.step_angles(R).mean() * CAP.rate_hz)
    assert speed == pytest.approx(CFG["motion"]["mean_speed_m_per_s"], rel=1e-12)
    assert turn == pytest.approx(CFG["motion"]["mean_angular_speed_deg_per_s"],
                                 rel=1e-12)
    assert np.allclose(R[0], R[-1], atol=1e-15) and np.allclose(t[0], t[-1], atol=1e-15)


def test_lane_seeds_differ_and_repeat():
    a, b = scene.lane_seeds(2**31 + 5, 8), scene.lane_seeds(2**31 + 5, 8)
    assert a == b and len(set(a)) == 8
    assert not np.array_equal(scene.make_scene(a[0])[0].texture,
                              scene.make_scene(a[1])[0].texture)
