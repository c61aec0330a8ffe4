"""Arithmetic the per-layer metric readers (``metrics/<name>.py``) share.
A reader takes the harness's context (``run.layer_context``) and returns a
number, or None where the run has nothing for it to read."""

from __future__ import annotations

from . import yardstick


def stage_ms(ctx: dict, stage: str):
    """Milliseconds a frame of an offline stage, over the untraced passes."""
    if stage not in ctx["timings"] or not ctx["frames"]:
        return None
    return 1e3 * ctx["timings"][stage] / ctx["frames"]


def k1_roofline(ctx: dict):
    """K1's share (%) of its bound over the traced part: every frame the
    traced work ran through K1 once, at the atlas of the frame (rows x
    width), and each launch read the border mask once."""
    tr = ctx["trace"]
    if not tr or not tr["k1_launches"] or not tr["k1_s"]:
        return None
    rows, width = ctx["atlas"]
    pixels = ctx["traced_frames"] * rows * width
    n_bytes = pixels * (2 + 4 + 2) + tr["k1_launches"] * rows * width
    n_ops = pixels * yardstick.K1_OPS_PER_PIXEL
    return 100.0 * yardstick.bound_ms(n_bytes, n_ops) / 1e3 / tr["k1_s"]


def device_idle(ctx: dict):
    """Share (%) of the traced wall time in which no device operation ran."""
    tr = ctx["trace"]
    if not tr or not tr["device_ops"] or not tr["window_s"]:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])


def launches_per_frame(ctx: dict):
    tr = ctx["trace"]
    if not tr or not tr["device_ops"] or not ctx["traced_frames"]:
        return None
    return tr["device_ops"] / ctx["traced_frames"]


def frame_ms(ctx: dict, keyframe: bool):
    """Mean latency (ms) of the live frames with or without a keyframe
    event, outside the traced range."""
    lat = [t for t, k in zip(ctx.get("latency_ms", ()), ctx.get(
        "is_keyframe", ())) if k == keyframe]
    return sum(lat) / len(lat) if lat else None
