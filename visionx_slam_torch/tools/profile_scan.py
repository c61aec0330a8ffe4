"""Per-stage profile of the ONLINE scan (BASELINE config 1) on one card
(counterpart of ``tools/profile_scan.py``, and of
``tools/ablate_scan_stages.py``, whose limits 0, 1 and 2 it also times).

Times the scan at each ``stage_limit`` (0: extraction only; 1: + the
tracking branch; 3: + the matcher against the keyframe cache; 4: + the
prior-tier PnP; 2: the full pipeline) and option ablations (local BA off,
local BA at one iteration, a landmark table of 1 << 16), to attribute the
serial per-frame chain. Each is the median of N warm runs by the host clock
around a synchronize, on the bench input staged on the card.

Run from the repository root on a machine with an NVIDIA GPU::

    python3 -m visionx_slam_torch.tools.profile_scan [--frames 240]
        [--runs 3] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import sys

import torch

from ..bench import timed
from ..data import synthetic
from ..ops.camera import make_camera
from ..tracking import scan_pipeline as sp
from ..utils.config import TrackingOptions


def profile(frames: int = 240, runs: int = 3, device="cuda") -> dict:
    """{label: seconds per frame} of the scan's stage limits and ablations."""
    dev = torch.device(device)
    T = frames
    grays, depths, _ = synthetic.make_sequence(T, seed=5)
    cam = make_camera(synthetic.FX, synthetic.FY, synthetic.CX, synthetic.CY)
    gd = torch.as_tensor(grays).to(dev)
    dd = torch.as_tensor(depths).to(dev)
    out = {}

    def measure(label, opts, stage_limit=2, **kw):
        def go():
            sp.run_scan_pipeline(cam, gd, dd, opts, stage_limit=stage_limit,
                                 device=dev, **kw)
        go()
        t = statistics.median(timed(go, dev)[0] for _ in range(runs))
        out[label] = t / T
        print(f"{label:44s} {t / T * 1e3:7.3f} ms/frame  ({T / t:7.1f} fps)",
              flush=True)

    base = TrackingOptions()
    measure("extract only", base, stage_limit=0)
    measure("extract + track (match+PnP)", base, stage_limit=1)
    measure("extract + match (keyframe cache)", base, stage_limit=3)
    measure("extract + match + prior PnP", base, stage_limit=4)
    measure("full, local BA OFF", dataclasses.replace(base, enable_local_ba=False))
    measure("full, BA 1 iter", dataclasses.replace(base, ba_iterations=1))
    measure("full (config 1 default)", base)
    measure("full, lm_capacity=1<<16", base, lm_capacity=1 << 16)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--frames", type=int, default=240)
    p.add_argument("--runs", type=int, default=3)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    print(json.dumps(profile(args.frames, args.runs, args.device)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
