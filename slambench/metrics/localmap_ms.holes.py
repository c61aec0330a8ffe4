"""Tracking against the local map in the scan of a System pass over depth files with holes (the projection of the window keyframes' landmarks and their match to each tracked frame's features; the pose refinement after it is in `scan/gn`), milliseconds a frame on the host: System's stage clock's `scan/localmap` spans over the untraced passes. None where the program has no such span."""


def read(ctx):
    t = ctx["timings"].get("scan/localmap")
    if t is None or not ctx["frames"]:
        return None
    return 1e3 * t / ctx["frames"]
