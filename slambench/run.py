"""Run one benchmark cell once and print its result line.

    python3 slambench/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``, ``slambench/``
and the program ``visionx_slam_torch/``, on a machine with an NVIDIA GPU.
The cell is one of BENCHMARK.json's workloads, or of
``slambench/held.json`` (cells held out of the benchmark, in its form). It
names a configuration (``slambench/configs/<config>.json``) and a traffic
mix (``slambench/traffic/<traffic>.json``); its limits on the numbers that
decide ``correct`` are ``slambench/limits/<cell>.json``; the traffic file's
``feed`` names the feed (``slambench/feeds/<feed>.py``) that drives the
program, and each metric, end-to-end or per-layer, is read by
``slambench/metrics/<metric>.py``.

Set-up (``setup_s``: process start to the window's start) renders the
cell's frames on the device, builds or loads kernel K1 and warms up with
one pass of the cell's own shapes. The window then runs for ``--seconds``.
With ``--trace 0`` the result holds the cell's end-to-end metrics; with
``--trace 1`` a part of the window runs under ``torch.profiler`` and the
result holds the per-layer metrics. After the window the plain reference
judges the outputs; each number compared is printed beside its limit, as
the last lines on standard error and under ``checks`` in the result. The
last line on standard output is the result, one JSON object.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent
FORBIDDEN = {"jax", "jaxlib", "flax", "visionx_slam_tpu"}


def process_start() -> float:
    """The wall-clock time this process started (Linux: from /proc)."""
    try:
        ticks = os.sysconf("SC_CLK_TCK")
        start = int(Path("/proc/self/stat").read_text().rsplit(")", 1)[1]
                    .split()[19]) / ticks
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        return time.time() - (uptime - start)
    except (OSError, ValueError, IndexError):
        return time.time()


def _entries(root: Path) -> dict:
    """BENCHMARK.json's workloads and metrics followed by those of the
    cells held out of it (``slambench/held.json``, in the same form)."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    held = json.loads((root / "slambench" / "held.json").read_text())
    return {k: bench[k] + held.get(k, [])
            for k in ("workloads", "end_to_end", "per_layer")}


def cells(root: Path = ROOT) -> list[str]:
    """The names of the benchmark's cells, then of the held ones."""
    return [w["name"] for w in _entries(root)["workloads"]]


def load_cell(name: str, root: Path = ROOT) -> dict:
    """The cell ``name`` of BENCHMARK.json (or of ``held.json``) with its
    configuration, traffic, limits and the metrics it reports."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    entries = _entries(root)
    cell = next((w for w in entries["workloads"] if w["name"] == name), None)
    if cell is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    here = root / "slambench"
    read = lambda *p: json.loads((here.joinpath(*p)).read_text())
    e2e = [m for m in entries["end_to_end"]
           if name in m.get("workloads", [name])]
    moved = {m["name"] for m in e2e}
    per_layer = [m for m in entries["per_layer"] if name in m.get(
        "workloads", [name] if m["moves"] in moved else [])]
    return dict(cell=cell, config=read("configs", cell["config"] + ".json"),
                traffic=read("traffic", cell["traffic"] + ".json"),
                limits=read("limits", name + ".json"), end_to_end=e2e,
                per_layer=per_layer, run_seconds=bench["run_seconds"])


def reader(metric: str, here: Path = HERE):
    """The ``read(ctx)`` of ``metrics/<metric>.py``: an end-to-end metric's
    reader reads the window's result (``frames``, ``wall_s``, the live
    frames' ``latency_s``) and ``setup_s``; a per-layer metric's reads
    ``layer_context``."""
    path = here / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "slambench_metric_" + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def layer_context(feed, res: dict, traced: dict | None) -> dict:
    """What the per-layer readers read: the stage seconds and frames of
    the untraced part, the trace's numbers, the live frames' latencies and
    keyframe flags outside the traced range, the scan's counters."""
    from . import yardstick

    cam = feed.cfg["camera"]
    ctx = dict(frames=res.get("timed_frames", res["frames"]),
               timings=dict(feed.timings), trace=traced,
               traced_frames=res.get("traced_frames", 0),
               atlas=(yardstick.atlas_rows(cam["height"], cam["width"]),
                      cam["width"]), window_frames=res["frames"])
    if "latency_s" in res:
        lo, hi = feed.traced
        keep = [i for i in range(res["frames"]) if not lo <= i < hi]
        ctx.update(latency_ms=[1e3 * feed.latency[i] for i in keep],
                   is_keyframe=[bool(feed.is_kf[i]) for i in keep],
                   counters=feed.stream.stats())
    return ctx


def run_cell(spec: dict, seed: int, seconds: float, trace: bool, device,
             t_start: float) -> tuple[dict, list[str]]:
    """Set up, measure and judge one run of a cell on ``device``; returns
    (the result object, the limit lines)."""
    import torch

    from . import feeds
    from .trace import Trace

    dev = torch.device(device)
    if dev.type == "cuda":
        from visionx_slam_torch.ops import detect

        detect.build_kernel()
    feed = feeds.load(spec["traffic"]["feed"])(
        spec["config"], spec["traffic"], seed, dev)
    tr = None
    if trace:
        tr = feed.trace = Trace(dev)
        tr.warm()
    feed.warm()
    feeds.sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    setup_s = time.time() - t_start
    res = feed.window(seconds)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    metrics: dict = {}
    device_info = dict(platform="gpu" if dev.type == "cuda" else dev.type,
                       kind=torch.cuda.get_device_name(dev)
                       if dev.type == "cuda" else dev.type,
                       count=1, memory_peak_bytes=int(peak))
    traced = None
    if tr is not None and tr.done:
        label = None
        if hasattr(feed, "is_kf"):
            label = lambda i: ("keyframe frame" if feed.is_kf[i]
                               else "plain frame")
        traced = tr.read(label)
        device_info.update(busy_s=traced["busy_s"], window_s=traced["window_s"])
    if trace:
        ctx = layer_context(feed, res, traced)
        for m in spec["per_layer"]:
            v = reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = dict(value=v, unit=m["unit"])
    else:
        ctx = dict(res, setup_s=setup_s)
        for m in spec["end_to_end"]:
            metrics[m["name"]] = dict(value=reader(m["name"])(ctx),
                                      unit=m["unit"])
    numbers = feed.judge()
    checks = {k: dict(value=numbers[k], limit=lim["limit"])
              for k, lim in spec["limits"].items()}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    out = dict(correct=correct, attempted=res["frames"], failed=res["lost"],
               metrics=metrics, device=device_info)
    if traced is not None:
        out["breakdown"] = traced["breakdown"]
    out["checks"] = checks
    lines = [f"{k} {c['value']!r} limit {c['limit']!r}"
             for k, c in checks.items()]
    return out, lines


def main(argv=None) -> int:
    t_start = process_start()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # every build and kernel cache at a fixed path inside the checkout
    cache = ROOT / ".slambench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    spec = load_cell(args.workload)

    import torch

    torch.set_num_threads(1)        # one process, one host thread of load
    chips = spec["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"slambench: needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    out, lines = run_cell(spec, args.seed, args.seconds, bool(args.trace),
                          "cuda:0", t_start)
    found = sorted(FORBIDDEN & {m.split(".")[0] for m in sys.modules})
    if found:
        print(f"slambench: the run loaded {', '.join(found)}", file=sys.stderr)
        return 3
    print("\n".join(lines), file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    sys.path.remove(str(HERE)) if str(HERE) in sys.path else None
    from slambench.run import main as _main

    raise SystemExit(_main())
