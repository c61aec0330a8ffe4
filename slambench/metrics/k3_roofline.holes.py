"""Kernel K3's share (%) of its H100 bound over the traced part of a System pass (the last scan chunk's keyframe events): the profiler's `local_ba_kernel` time against `slambench/kernels.py`'s bytes and operations of a call at the window's 5 x 1024 features, the ring's slots and the mean iterations of a call over the untraced passes."""

import json
from pathlib import Path

from slambench import kernels

CONFIG = Path(__file__).resolve().parents[1] / "configs" / "tum_rgbd_fr1_desk_holes.json"


def read(ctx):
    slots = json.loads(CONFIG.read_text())["system"]["kf_capacity"]
    return kernels.k3_roofline(ctx, slots)
