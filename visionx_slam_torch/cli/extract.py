"""Feature-extraction debug CLI (the reference's mono_demo, apps/mono_demo.cpp,
minus the HighGUI window): extract ORB on one image, dump keypoints to a
text file and an overlay PNG.

Usage:
    python -m visionx_slam_torch.cli.extract --image img.png \
        [--extractor jax|opencv] [--device cuda|cpu] [--out_prefix out/features]
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def entrypoint(argv=None) -> int:
    p = argparse.ArgumentParser("vxs-torch-extract")
    p.add_argument("--image", required=True)
    p.add_argument("--extractor", default="jax", choices=["jax", "torch", "opencv"],
                   help="'jax' and 'torch' both name the on-device ORB")
    p.add_argument("--device", default="cuda")
    p.add_argument("--n_features", type=int, default=1000)
    p.add_argument("--out_prefix", default="features")
    args = p.parse_args(argv)

    from ..data import tum

    try:
        gray = tum.load_rgb_gray(args.image)
    except (OSError, ValueError) as e:
        print(f"cannot read image: {args.image} ({e})", file=sys.stderr)
        return 1

    if args.extractor == "opencv":
        from ..models.orb import OpenCVExtractor

        ext = OpenCVExtractor(n_features=args.n_features)
    else:
        from ..models.orb_torch import TorchOrbExtractor

        ext = TorchOrbExtractor(n_features=args.n_features, device=args.device)

    px, resp, desc, valid = ext.extract(gray)
    n = int(valid.sum())
    print(f"extracted {n} keypoints")

    os.makedirs(os.path.dirname(args.out_prefix) or ".", exist_ok=True)
    with open(args.out_prefix + ".txt", "w") as f:
        f.write("# x y response desc_hex\n")
        for i in np.nonzero(valid)[0]:
            f.write(
                f"{px[i,0]:.2f} {px[i,1]:.2f} {resp[i]:.4f} "
                f"{bytes(desc[i]).hex()}\n"
            )

    from ..eval.overlay import draw_feature_overlay, write_png

    overlay = draw_feature_overlay(gray, np.asarray(px), np.asarray(valid))
    write_png(args.out_prefix + ".png", overlay)
    print(f"wrote {args.out_prefix}.txt and {args.out_prefix}.png")
    return 0


if __name__ == "__main__":
    sys.exit(entrypoint())
