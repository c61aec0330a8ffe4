"""Tracking against the local map in the host Tracker (the projection of the window keyframes' landmarks and their match to each tracked frame's features; the pose refinement after it is in `track/gn`), milliseconds a frame on the host: System's stage clock's `track/localmap` spans over the untraced passes. None where the program has no such span."""


def read(ctx):
    t = ctx["timings"].get("track/localmap")
    if t is None or not ctx["frames"]:
        return None
    return 1e3 * t / ctx["frames"]
