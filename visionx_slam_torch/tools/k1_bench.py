"""Kernels K1 and K1b on one CUDA device: build, exact comparison with their
plain versions, timing, and the f32->bf16 conversions left in their SASS.

Run from the repository root on a machine with an NVIDIA GPU::

    python3 -m visionx_slam_torch.tools.k1_bench [--source FILE.cu ...]
        [--pipeline] [--reps N]

For each source (default: the package's ``csrc/fast_harris_blur.cu``) it
builds the library with nvcc, prints ptxas' report (registers, shared
memory, spills) and the count of ``F2F``/``F2FP`` instructions in each
kernel's SASS (``cuobjdump -sass``), and holds K1 and K1b bit for bit
against their plain versions at ``exact_cases``. Then it times K1 and K1b
by CUDA events at the 8-frame atlas [8,1896,640], the sources in turns
(a, b, ..., b, a). A source without the K1b entry point is timed as the
K1b wrapper before its redesign ran it: a cast to bf16, an all-ones mask,
then K1. With ``--pipeline`` it also times the offline pipeline's stages
on the 240-frame bench input for each source, in the same turns. Raises
(exit code 1) if an output differs from its plain version.
"""

from __future__ import annotations

import argparse
import json
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from ..ops import cuda_build, detect
from ..utils import flops

# shapes the tiling must get right besides the atlas: odd W; H below one
# row band and W not a multiple of 8; one row past a band
EDGE_SHAPES = ((3, 77, 131), (2, 20, 37), (1, 130, 640))


def edge_inputs(shape, seed: int):
    """(bf16 image, int8 mask with ~10% zeros, float32 image) of ``shape``,
    made with numpy from ``seed``; the float32 image is not bf16-exact."""
    rng = np.random.default_rng(seed)
    img32 = torch.from_numpy((rng.random(shape) * 255).astype(np.float32))
    mask = torch.from_numpy((rng.random(shape[1:]) > 0.1).astype(np.int8))
    return img32.to(torch.bfloat16), mask, img32


def exact_cases(atlas: torch.Tensor, mask: torch.Tensor):
    """K1 cases (name, bf16 image, mask) and K1b cases (name, float image):
    the rendered atlas and the edge shapes, plus a 2-D image for K1b."""
    k1 = [("atlas", atlas, mask)]
    k1b = [("atlas f32", atlas.float())]
    for i, shape in enumerate(EDGE_SHAPES):
        img16, m, img32 = (x.to(atlas.device) for x in edge_inputs(shape, i))
        k1.append((str(shape), img16, m))
        k1b.append((str(shape) + " f32", img32))
    k1b.append((str(tuple(k1b[1][1].shape[1:])) + " 2-D", k1b[1][1][0]))
    return k1, k1b


def n_differ(a: torch.Tensor, b: torch.Tensor) -> int:
    """Elements whose bits differ (f32 as int32, bf16 as int16)."""
    view = torch.int32 if a.dtype == torch.float32 else torch.int16
    return int((a.view(view) != b.view(view)).sum())


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    d = (a.float() - b.float()).abs()
    return float(d.max()) if d.numel() else 0.0


def k1b_by_k1(img: torch.Tensor) -> torch.Tensor:
    """K1b as the wrapper ran it before the score-only kernel existed."""
    x = (img[None] if img.dim() == 2 else img).to(torch.bfloat16).contiguous()
    s, _ = detect.fast_harris_blur(x, torch.ones(x.shape[1:], dtype=torch.int8,
                                                 device=x.device))
    return s[0] if img.dim() == 2 else s


def k1b_fn(source: Path):
    lib = cuda_build.build(source)
    return detect.fast_harris_score if hasattr(lib, "vxs_fast_harris_score") \
        else k1b_by_k1


def _corners_agree(s_k, s_p, inside, what: str) -> torch.Tensor:
    """The Pallas test's tolerances: corner-mask agreement > 0.99 inside the
    mask, scores at common corners within rtol 2e-2, atol 20. Returns the
    common corners."""
    c_k, c_p = s_k > 0.5 * detect.NEG, s_p > 0.5 * detect.NEG
    agree = (c_k == c_p)[inside].float().mean().item()
    if not agree > 0.99:
        raise RuntimeError(f"{what}: corner-mask agreement {agree:.4f}")
    both = c_k & c_p
    torch.testing.assert_close(s_k[both], s_p[both], rtol=2e-2, atol=20.0)
    return both


def check_k1(cases) -> float:
    """K1 against its plain version at each (name, bf16 image, mask) case:
    bit for bit (score as int32, blur as int16) and to the Pallas test's
    tolerances (blur rtol 2e-2, atol 2). Raises on a difference; returns
    the largest absolute error."""
    max_err = 0.0
    for name, img, m in cases:
        s_k, b_k = detect.fast_harris_blur(img, m)
        s_p, b_p = detect.fast_harris_blur_reference(img, m)
        torch.cuda.synchronize()
        both = _corners_agree(s_k, s_p, m.bool().expand_as(s_k), f"K1 {name}")
        torch.testing.assert_close(b_k.float(), b_p.float(), rtol=2e-2, atol=2.0)
        max_err = max(max_err, max_abs_err(s_k[both], s_p[both]),
                      max_abs_err(b_k, b_p))
        ds, db = n_differ(s_k, s_p), n_differ(b_k, b_p)
        print(f"  K1 {name}: {ds} score and {db} blur elements differ, "
              f"{int(both.sum())} corners", flush=True)
        if ds or db:
            raise RuntimeError(f"K1 differs from its plain version at {name}")
    return max_err


def check_k1b(cases, k1b=detect.fast_harris_score) -> float:
    """K1b (``k1b``) against its plain version at each (name, float image)
    case, bit for bit and to K1's score tolerances; the wrapper must launch
    once per call. Raises on a difference; returns the largest absolute
    error."""
    max_err = 0.0
    for name, img in cases:
        before = detect.score_launches
        s_k = k1b(img)
        if k1b is detect.fast_harris_score and detect.score_launches != before + 1:
            raise RuntimeError("K1b did not launch exactly once")
        s_p = detect.fast_harris_score_reference(img)
        torch.cuda.synchronize()
        both = _corners_agree(s_k, s_p, torch.ones_like(s_k, dtype=torch.bool),
                              f"K1b {name}")
        max_err = max(max_err, max_abs_err(s_k[both], s_p[both]))
        ds = n_differ(s_k, s_p)
        print(f"  K1b {name}: {ds} score elements differ, {int(both.sum())} "
              f"corners", flush=True)
        if ds:
            raise RuntimeError(f"K1b differs from its plain version at {name}")
    return max_err


def time_ms(fn, reps: int) -> float:
    """Mean time of one call by CUDA events over ``reps`` calls, warm."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def sass_counts(source: Path) -> dict:
    """{kernel: {"F2F": n, "F2FP": n, "instructions": n, "mix": {opcode: n}}}
    from cuobjdump, the mix holding the 12 most frequent opcodes."""
    so = next(cuda_build.BUILD_DIR.glob(f"{source.stem}_*.so"), None)
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if so is None:
        return {}
    res = subprocess.run([tool, "-sass", str(so)], capture_output=True,
                         text=True, timeout=120)
    ops: dict = {}
    name = None
    for line in res.stdout.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            ops[name] = {}
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if name is None or m is None:
            continue
        op = m.group(1)
        ops[name][op] = ops[name].get(op, 0) + 1
    counts = {}
    for name, mix in ops.items():
        counts[name] = {
            "F2F": sum(n for op, n in mix.items() if op.split(".")[0] == "F2F"),
            "F2FP": sum(n for op, n in mix.items() if op.split(".")[0] == "F2FP"),
            "instructions": sum(mix.values()),
            "mix": dict(sorted(mix.items(), key=lambda kv: -kv[1])[:12])}
    return counts


def use_source(source: Path) -> None:
    """Point the wrappers at the library built from ``source``."""
    detect._SOURCE = source


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--source", type=Path, action="append")
    ap.add_argument("--pipeline", action="store_true")
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k1_bench: no CUDA device", file=sys.stderr)
        return 2
    from ..data import synthetic
    from ..models.orb_torch import build_atlas

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"card: {card}", flush=True)
    sources = [s.resolve() for s in (args.source or [detect._SOURCE])]
    grays, depths, gt_t = synthetic.make_sequence(240 if args.pipeline else 8,
                                                  seed=5)
    atlas, mask = build_atlas(torch.as_tensor(grays[:8]).cuda())
    k1_cases, k1b_cases = exact_cases(atlas, mask)
    for src in sources:
        use_source(src)
        t0 = time.perf_counter()
        cuda_build.build(src)
        print(f"== {src.name}: built in {time.perf_counter() - t0:.2f} s",
              flush=True)
        log = next(cuda_build.BUILD_DIR.glob(f"{src.stem}_*.ptxas.txt"), None)
        if log is not None:
            for line in log.read_text().splitlines():
                if "registers" in line or "spill" in line or "Compiling" in line:
                    print("  ptxas " + line.strip().split("ptxas info    : ")[-1])
        print("  sass " + json.dumps(sass_counts(src)), flush=True)
        check_k1(k1_cases)
        check_k1b(k1b_cases, k1b_fn(src))
    x32 = atlas.float()
    order = sources + sources[::-1]
    times: dict = {s.name: {"k1": [], "k1b": []} for s in sources}
    for src in order:
        use_source(src)
        k1b = k1b_fn(src)
        times[src.name]["k1"].append(
            time_ms(lambda: detect.fast_harris_blur(atlas, mask), args.reps))
        times[src.name]["k1b"].append(time_ms(lambda: k1b(x32), args.reps))
    b1, b1b = flops.k1_bytes(atlas.shape), flops.k1b_bytes(atlas.shape)
    o1, o1b = flops.k1_ops(atlas.shape), flops.k1b_ops(atlas.shape)
    bound1, bound1b = flops.bound_ms(b1, o1), flops.bound_ms(b1b, o1b)
    print(f"bound at {tuple(atlas.shape)}: K1 {b1} B -> {flops.bound_ms(b1):.4f} ms "
          f"(ops {flops.bound_ms(0, o1):.4f} ms), K1b {b1b} B -> "
          f"{flops.bound_ms(b1b):.4f} ms (ops {flops.bound_ms(0, o1b):.4f} ms)",
          flush=True)
    for name, t in times.items():
        k1, k1b = np.mean(t["k1"]), np.mean(t["k1b"])
        print(f"time {name}: K1 {t['k1']} ms (mean {k1:.4f}, "
              f"{bound1 / k1:.3f} of bound), K1b {t['k1b']} ms (mean "
              f"{k1b:.4f}, {bound1b / k1b:.3f} of bound) ({card})",
              flush=True)
    if args.pipeline:
        from ..ops.camera import make_camera
        from ..tracking.offline_pipeline import run_offline_pipeline
        from ..utils.config import TrackingOptions

        cam = make_camera(synthetic.FX, synthetic.FY, synthetic.CX, synthetic.CY)
        g, d = torch.as_tensor(grays).cuda(), torch.as_tensor(depths).cuda()
        for src in sources:
            use_source(src)
            run_offline_pipeline(cam, g, d, TrackingOptions(), device="cuda")
        for src in order:
            use_source(src)
            stages: dict = {}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run_offline_pipeline(cam, g, d, TrackingOptions(), device="cuda",
                                 timings=stages)
            torch.cuda.synchronize()
            print(f"pipeline {src.name}: {time.perf_counter() - t0:.4f} s, "
                  f"stages {json.dumps(stages)} ({card})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
