"""Per-stage profile of the OFFLINE pipeline on one card (counterpart of
``tools/profile_stages.py``).

Times the extraction's sub-stages over the whole sequence in 8-frame
chunks by ``orb_extract(profile_stage=...)`` (0: the dense passes, 1: +
the per-level selection, 2: + patches and orientation, 3: the full
extraction), then the pipeline's stages alone (``run.pre``: extraction,
pairs, compose, keyframes, map build; ``run.refine``: global BA;
``run.post``: re-anchor and re-track) and the full pipeline. Each is the
median of N warm runs by the host clock around a synchronize, on the bench
input staged on the card. ``--use_kernel 0`` times the extraction with
K1's plain version in place of K1.

Run from the repository root on a machine with an NVIDIA GPU::

    python3 -m visionx_slam_torch.tools.profile_stages [--frames 240]
        [--runs 3] [--use_kernel -1|0|1] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys

import torch

from ..bench import timed
from ..data import synthetic
from ..models.orb_torch import orb_extract
from ..ops.camera import make_camera
from ..tracking import offline_pipeline as op
from ..utils.config import TrackingOptions


def profile(frames: int = 240, runs: int = 3, use_kernel: int = -1,
            device="cuda") -> dict:
    """{stage: seconds per frame} of the extraction sub-stages and the
    offline pipeline's stages."""
    dev = torch.device(device)
    T = frames
    grays, depths, _ = synthetic.make_sequence(T, seed=5)
    cam = make_camera(synthetic.FX, synthetic.FY, synthetic.CX, synthetic.CY)
    gd = torch.as_tensor(grays).to(dev)
    dd = torch.as_tensor(depths).to(dev)
    run = op.build_offline_pipeline(TrackingOptions())
    out = {}

    def measure(label, fn):
        res = fn()
        t = statistics.median(timed(fn, dev)[0] for _ in range(runs))
        out[label] = t / T
        print(f"{label:24s} {t / T * 1e3:7.3f} ms/frame   ({T / t:7.1f} fps)",
              flush=True)
        return res

    for stage, name in ((0, "detect dense only"), (1, "detect+topk"),
                        (2, "+patch+orient"), (3, "full extract")):
        measure(name, lambda: [orb_extract(gd[i:i + 8], profile_stage=stage,
                                         use_kernel=use_kernel)
                             for i in range(0, T, 8)])

    ms, links, aux = measure("run_pre total", lambda: run.pre(cam, gd, dd))
    ms2 = measure("run_refine (GBA)", lambda: run.refine(cam, ms))
    measure("run_post (re-track)", lambda: run.post(cam, ms2, aux))
    measure("FULL pipeline", lambda: run(cam, gd, dd))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--frames", type=int, default=240)
    p.add_argument("--runs", type=int, default=3)
    p.add_argument("--use_kernel", type=int, default=-1, choices=[-1, 0, 1])
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    print(json.dumps(profile(args.frames, args.runs, args.use_kernel,
                             args.device)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
