"""Readers of the program's sub-spans and host-sync count: the keys the
offline pipeline's stage clock writes into ``timings`` beside the stage
seconds, ``"<stage>/<span>"`` (host seconds of the ``match``, ``ransac``
and ``gn`` parts of a stage, no synchronize) and ``"#host_syncs"`` (the
places a pass waited for the device). A program without them gives
None."""

from __future__ import annotations


def span_ms(ctx: dict, span: str):
    """Milliseconds a frame of the sub-span ``span``, summed over every
    stage that has it, over the untraced passes."""
    t = ctx["timings"]
    keys = [k for k in t if k.endswith("/" + span)]
    if not keys or not ctx["frames"]:
        return None
    return 1e3 * sum(t[k] for k in keys) / ctx["frames"]


def syncs_per_frame(ctx: dict):
    """Host waits for the device a frame, over the untraced passes."""
    n = ctx["timings"].get("#host_syncs")
    if n is None or not ctx["frames"]:
        return None
    return n / ctx["frames"]
